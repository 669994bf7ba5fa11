"""Plain-PyTorch CSR SpMM — the aggregation of the port's main path.

Port of `spmm_segsum` and `spmm_segsum_scan` (`maxk_tpu/ops/spmm_xla.py:
21-76`): y = A @ x by gathering source rows, scaling them by the edge
values and adding them into their destination rows with `index_add_`.
The reference computes this outside any Pallas kernel, so it stays plain
PyTorch here; a hand-written CSR SpMM kernel is later work.

The edges are taken in chunks of `EDGE_CHUNK`, the role of
`spmm_segsum_scan`: the one-shot form builds an (E, D) intermediate, about
81 GB at full reddit (79M live edges × 256 × 4 B). The product is taken in
x's dtype and the sum in f32 (f64 for f64 x), rounded once to x's dtype.
On a CUDA device `index_add_` adds with atomics, so the order of the sum,
and its last bits, change from run to run.
"""

from __future__ import annotations

import torch

from maxk_tpu_torch.sparse.csr import CSRGraph

# 2M edges: at D=256 one chunk's gathered rows are 2 GB in f32 (1 GB in
# bf16, plus its 2 GB f32 copy), next to a (V, D) f32 accumulator
EDGE_CHUNK = 1 << 21


def spmm_segsum(g: CSRGraph, x: torch.Tensor, edge_chunk: int = EDGE_CHUNK) -> torch.Tensor:
    """Exact CSR SpMM: y = A @ x, accumulated in f32, edges in chunks."""
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    rows = g.row_ids()
    acc = torch.zeros((g.num_nodes, x.shape[1]), dtype=acc_dtype, device=x.device)
    for s in range(0, g.nnz, edge_chunk):
        e = min(s + edge_chunk, g.nnz)
        part = x.index_select(0, g.indices[s:e])
        part.mul_(g.values[s:e, None].to(x.dtype))
        acc.index_add_(0, rows[s:e], part.to(acc_dtype))
    return acc.to(x.dtype)
