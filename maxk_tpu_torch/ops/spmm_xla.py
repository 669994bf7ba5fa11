"""Plain-PyTorch SpMMs: the CSR segment sum of the port's main path, the
edge-tile SpMMs and the dense oracle.

Port of `maxk_tpu/ops/spmm_xla.py`, which computes all of these outside
any Pallas kernel, so they stay plain PyTorch here.

`spmm_segsum` (the reference's `spmm_segsum` and `spmm_segsum_scan`):
y = A @ x by gathering source rows, scaling them by the edge values and
adding them into their destination rows with `index_add_`. The edges are
taken in chunks of `EDGE_CHUNK`: the one-shot form builds an (E, D)
intermediate, about 81 GB at full reddit (79M live edges × 256 × 4 B). The
product is taken in x's dtype and the sum in f32 (f64 for f64 x), rounded
once to x's dtype. On a CUDA device `index_add_` adds with atomics, so the
order of the sum, and its last bits, change from run to run. It is the
plain version of the CSR kernels (`ops/spmm_csr.py`), which the SEGSUM
path runs on a card, and the oracle of the other SpMMs.

`spmm_tiles_xla` and `spmm_tiles_scan` run over the edge-tile tables of
`sparse/meta.py`: per tile, the (T, D) gathered rows contracted against the
(T, R) one-hot of local rows weighted by the edge values, then the tiles'
(R, D) partials added into their row blocks. The edge values are cast to
x's dtype first and both operands of the contraction to f32, the role of
`preferred_element_type=float32` (a bf16·bf16 product is exact in f32);
f32 products need TF32 off, PyTorch's default for matmuls.
`spmm_dense` is the brute-force oracle for tiny graphs.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from maxk_tpu_torch.sparse.csr import CSRGraph
from maxk_tpu_torch.sparse.meta import EdgeTiles

# 2M edges: at D=256 one chunk's gathered rows are 2 GB in f32 (1 GB in
# bf16, plus its 2 GB f32 copy), next to a (V, D) f32 accumulator
EDGE_CHUNK = 1 << 21


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def spmm_segsum(g: CSRGraph, x: torch.Tensor, edge_chunk: int = EDGE_CHUNK) -> torch.Tensor:
    """Exact CSR SpMM: y = A @ x, accumulated in f32, edges in chunks."""
    acc_dtype = _acc_dtype(x)
    rows = g.row_ids()
    acc = torch.zeros((g.num_nodes, x.shape[1]), dtype=acc_dtype, device=x.device)
    for s in range(0, g.nnz, edge_chunk):
        e = min(s + edge_chunk, g.nnz)
        part = x.index_select(0, g.indices[s:e])
        part.mul_(g.values[s:e, None].to(x.dtype))
        acc.index_add_(0, rows[s:e], part.to(acc_dtype))
    return acc.to(x.dtype)


def _tile_partials(x: torch.Tensor, cols, vals, lrow, r: int) -> torch.Tensor:
    """(n, R, D) partials of n tiles in x's accumulation dtype: the gathered
    (n, T, D) rows contracted against the (n, T, R) one-hot of local rows
    that carries the edge weights (R ≪ D, so weighting the one-hot moves
    fewer bytes than weighting the rows). With R = 1 a tile is one row and
    the contraction is a weighted sum of its rows."""
    acc = _acc_dtype(x)
    n, t = cols.shape
    gathered = x.index_select(0, cols.reshape(-1)).reshape(n, t, -1).to(acc)
    w = vals.to(x.dtype)
    if r == 1:
        return torch.bmm(w.to(acc)[:, None, :], gathered)
    onehot = F.one_hot(lrow.long(), r).to(x.dtype) * w[..., None]
    return torch.bmm(onehot.to(acc).transpose(1, 2), gathered)


def spmm_tiles_xla(tiles: EdgeTiles, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x over the edge-tile tables in one shot: every tile's (T, D)
    gathered rows at once, an (NT, T, D) intermediate, so small and medium
    graphs only (≈88 GB in f32 at full reddit); the tiles' partials added
    into their blocks with `index_add_`."""
    r, nb = tiles.row_block, tiles.num_row_blocks
    partial = _tile_partials(x, tiles.cols, tiles.vals, tiles.localrow, r)
    out = torch.zeros((nb, r, x.shape[1]), dtype=partial.dtype, device=x.device)
    out.index_add_(0, tiles.block.long(), partial)
    return out.reshape(nb * r, -1)[: tiles.num_nodes].to(x.dtype)


def spmm_tiles_scan(
    tiles: EdgeTiles,
    x: torch.Tensor,
    chunk: int = 256,
    accumulate: str = "matmul",
    acc0: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """y = A @ x over the edge-tile tables, `chunk` tiles at a time, so the
    gathered intermediate is (chunk, T, D) (64 MiB at 256 tiles of 256
    edges, D = 256, f32). The accumulator is f32 whatever x's dtype.

    Adding a chunk's (chunk, R, D) partials into the (NB, R, D) output:
      - "matmul": the tiles are block-sorted, so a chunk's tiles fall in a
        window of at most `window` consecutive blocks from its first tile's
        block; a (window, chunk) one-hot matmul reduces them into the window
        and one slice add puts it back. The accumulator is padded to
        NB + window blocks so the window never runs off its end.
      - "scatter": `index_add_` of the partials at their blocks.

    `acc0` ((num_nodes, D)) seeds the accumulator: a caller that adds the
    result to a partial sum passes it here. A seeded call returns f32, as
    it is mid-accumulation; otherwise the result is in x's dtype.

    `window` (matmul): right iff every aligned chunk of tiles spans fewer
    blocks (`sparse/meta.max_block_span`); None takes `chunk`, which holds
    whenever every block has a tile. The last chunk may be short: the
    reference pads it with inert tiles (value 0), which add nothing."""
    r, nb, nt = tiles.row_block, tiles.num_row_blocks, tiles.num_tiles
    d = x.shape[1]
    acc_dtype = _acc_dtype(x)
    w = chunk if window is None else max(window, 1)
    rows = nb if accumulate == "scatter" else nb + w
    acc = torch.zeros((rows * r, d), dtype=acc_dtype, device=x.device)
    if acc0 is not None:
        acc[: acc0.shape[0]] = acc0
    acc = acc.reshape(rows, r, d)
    block = tiles.block.long()
    # each chunk's first block, read to the host once for the window slices
    firsts = [] if accumulate == "scatter" else block[::chunk].tolist()
    slots = torch.arange(w, device=x.device)[:, None]
    for c, s in enumerate(range(0, nt, chunk)):
        e = min(s + chunk, nt)
        part = _tile_partials(x, tiles.cols[s:e], tiles.vals[s:e], tiles.localrow[s:e], r)
        if accumulate == "scatter":
            acc.index_add_(0, block[s:e], part)
            continue
        b0 = firsts[c]
        seg = (block[s:e][None, :] - b0 == slots).to(acc_dtype)  # (w, n)
        acc[b0:b0 + w] += (seg @ part.reshape(e - s, r * d)).reshape(w, r, d)
    out = acc.reshape(rows * r, d)[: tiles.num_nodes]
    return out if acc0 is not None else out.to(x.dtype)


def spmm_dense(g: CSRGraph, x: torch.Tensor) -> torch.Tensor:
    """A @ x through the densified (V, V) A, in x's dtype: the brute-force
    oracle for tiny test graphs."""
    v = g.num_nodes
    a = torch.zeros((v, v), dtype=x.dtype, device=x.device)
    a.index_put_((g.row_ids().long(), g.indices.long()), g.values.to(x.dtype), accumulate=True)
    return a @ x
