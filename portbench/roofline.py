"""The card's published peaks and the read-once bound arithmetic, frozen here.

Copied from `maxk_tpu_torch/bench/micro.py` (`HBM_BYTES_PER_S`, `PEAK_FLOPS`,
`bound`) and from the CSR bytes of `maxk_tpu_torch/bench/ablate_csr.csr_bytes`
with K9's features and output of `chip_smoke.phase_csr_kernels`, so that a
later change to the program cannot move the yardstick; K10's and K11's bytes
are the same read-once count over what each kernel takes and gives. The peaks are the
H100 SXM's data-sheet rates at its 700 W limit (dense, no sparsity).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
# float32 on the CUDA cores (TF32 off); bfloat16 on the tensor cores
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def bound_seconds(nbytes: float, flops: float = 0.0, dtype: str = "float32") -> float:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of `dtype`."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def csr_bytes(num_nodes: int, live_edges: int, index_bytes: int = 4, value_bytes: int = 4) -> int:
    """A CSR read once: its row pointers, and each live edge's column and
    weight. The kernels' own tables (segments, work order) are not counted."""
    return (num_nodes + 1) * index_bytes + live_edges * (index_bytes + value_bytes)


def k9_bytes(num_nodes: int, live_edges: int, dim: int, itemsize: int = 4) -> int:
    """K9 (`spmm_csr`, y = A @ x) read once: the CSR, x read and y written
    once."""
    return csr_bytes(num_nodes, live_edges) + 2 * num_nodes * dim * itemsize


def k10_bytes(num_nodes: int, live_edges: int, dim: int, k: int, itemsize: int = 4) -> int:
    """K10 (`spgemm_cbsr`, y = A @ densify(CBSR), with its merge pass) read
    once: the CSR, each node's merged row (k values and k int16 selectors)
    and y written once."""
    return (csr_bytes(num_nodes, live_edges) + num_nodes * k * (itemsize + 2)
            + num_nodes * dim * itemsize)


def k11_bytes(num_nodes: int, live_edges: int, dim: int, k: int, itemsize: int = 4) -> int:
    """K11 (`sspmm_cbsr`, dvals = (Aᵀ @ g) sampled at the selectors) read
    once: Aᵀ's CSR, g (V × D) and the int32 selectors (V × k) read, dvals
    (V × k) written once."""
    return (csr_bytes(num_nodes, live_edges) + num_nodes * dim * itemsize
            + num_nodes * k * (4 + itemsize))
