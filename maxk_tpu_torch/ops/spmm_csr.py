"""The segsum path's CSR aggregation: the SpMM over dense features and the
paper's CBSR pair of maxk_spgemm, as hand-written CUDA kernels.

None of these is a Pallas kernel in the reference, which computes them in
XLA; they are the port's kernels of its `spmm_segsum` path
(`csrc/spmm_csr.cu`):

  K9  spmm_csr(csr, x)               y = A @ x, the function of
      `spmm_segsum` (`maxk_tpu/ops/spmm_xla.py:21`)
  K10 spgemm_cbsr(csr, vals, sel, D) y = A @ densify(vals, sel, D), the
      function of densify + that SpMM, `maxk_spgemm`'s forward
      (`maxk_tpu/ops/spgemm.py:157`)
  K11 sspmm_cbsr(csc, g, sel)        dvals = sample(Aᵀ @ g, sel) over the
      CSR of Aᵀ, `maxk_spgemm`'s backward (`maxk_tpu/ops/spgemm.py:224`)

Each product is taken in the features' dtype (the values' for K10, the
cotangent's for K11), the sum in f32, rounded once to that dtype; a
selector outside [0, D) adds nothing (K10) or gives 0 (K11). The kernels
take f32 and bf16 features; the plain versions (`spmm_csr_plain`,
`spgemm_cbsr_plain`, `sspmm_cbsr_plain`) compute the same in plain
PyTorch through `spmm_segsum`, `densify_plain` and `sample_plain`, in any
dtype.

The kernels walk the CSR's segment table (`sparse/csr.row_segments`, the
one the graph carries, else one built for the call): segments of at most
`SEG_EDGES` edges of a row, each summed in CSR order, and a second pass
adds the f32 partial sums of a row of several segments in segment order.
So every launch gives the same bits, and a row of one segment the plain
version's bits on the CPU; a longer row differs from it by the f32 sum's
grouping. All three run on a persistent grid that takes the segments in
the table's work order from zeroed counters their wrappers hand them (K9
and K11 one a column slice of the features, K10 one); K10 keeps the
merged rows of the table's hub columns in shared memory (none where the
table has no hub table), K11 gives a segment a lane group sized to k.
K10's merged selectors are int16: it takes dim < 32768 and raises
above.
The CSR's column indices must lie inside the features' rows: they are not
checked.

`spmm_csr`, `spgemm_cbsr` and `sspmm_cbsr` launch the kernel for CUDA
tensors (or raise) and run the plain version for CPU tensors.
"""

from __future__ import annotations

import functools

import torch

from maxk_tpu_torch.ops import _native
from maxk_tpu_torch.ops.cbsr_cuda import _check_sel, _on_cpu, densify_plain, sample_plain
from maxk_tpu_torch.ops.spmm_xla import spmm_segsum
from maxk_tpu_torch.sparse.csr import CSRGraph, RowSegments, row_segments

KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def spmm_csr_plain(csr: CSRGraph, x: torch.Tensor) -> torch.Tensor:
    return spmm_segsum(csr, x)


def spgemm_cbsr_plain(csr: CSRGraph, vals: torch.Tensor, sel: torch.Tensor,
                      dim: int) -> torch.Tensor:
    return spmm_segsum(csr, densify_plain(vals, sel, dim))


def sspmm_cbsr_plain(csc: CSRGraph, g: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    return sample_plain(spmm_segsum(csc, g), sel)


def _segments(name: str, csr: CSRGraph, t: torch.Tensor) -> RowSegments:
    """Check the CSR's arrays against the features `t`; return its segment
    table (built for this call where the CSR carries none)."""
    dev = t.get_device()
    for arr, dtype in ((csr.indptr, torch.int32), (csr.indices, torch.int32),
                       (csr.values, torch.float32)):
        _native.check(name, arr, (dtype,), ndim=1)
        if arr.get_device() != dev:
            raise ValueError(f"{name}: the CSR lies on {arr.device}, the features on {t.device}")
    if csr.segments is not None:
        segs = csr.segments
    else:
        segs = row_segments(csr, hubs=name == "spgemm_cbsr")
    if segs.row.get_device() != dev:
        raise ValueError(f"{name}: the segment table lies on {segs.row.device}, the features "
                         f"on {t.device}")
    if segs.num_segments >= 2**31 or segs.num_parts >= 2**31:
        raise ValueError(f"{name}: {segs.num_segments} segments exceed the int32 range")
    return segs


def _launch(name: str, entry: str, csr: CSRGraph, segs: RowSegments, t: torch.Tensor,
            tensors, width: int, *ints, counters: int = 0, hubs: bool = False,
            work: bool = False) -> None:
    """Launch `entry` on the CSR, its segment table (with its work order
    where `counters`, as the `work` table where `work`, and its hub table
    where `hubs`), `tensors` (data pointers), an f32 partial buffer of
    `width` columns for the rows of several segments and `counters` zeroed
    work counters, then the table's sizes (and the counters' count, the hub
    table's length) and `ints`."""
    arrays = [csr.indptr, csr.indices, csr.values, segs.row, segs.begin, segs.part,
              segs.multi_row, segs.multi_part0, segs.multi_nseg]
    arrays += [segs.work if work else segs.order] if counters else []
    arrays += [segs.hub_rows, segs.hub_slot] if hubs else []
    part = torch.empty((segs.num_parts, width), dtype=torch.float32, device=t.device)
    work = [torch.zeros(counters, dtype=torch.int32, device=t.device)] if counters else []
    _native.launch(
        name, entry, t, *(a.data_ptr() for a in (*arrays, *tensors, part, *work)),
        segs.num_segments, segs.multi_row.shape[0], segs.seg_edges,
        *((counters,) if counters else ()), *((segs.hub_rows.shape[0],) if hubs else ()), *ints)


def kernel_layout(itemsize: int, k: int, dim: int) -> dict:
    """K9's column slice, the hub rows K10 holds in shared memory and K11's
    column slice (`csr_kernels_layout` in the kernels' source), for
    features of `itemsize` bytes, k CBSR slots and dim columns."""
    import ctypes

    out = [ctypes.c_int(0) for _ in range(3)]
    err = _native.library().csr_kernels_layout(itemsize, k, dim, *map(ctypes.byref, out))
    if err != 0:
        raise ValueError(f"csr_kernels_layout({itemsize}, {k}, {dim}): CUDA error {err}")
    return dict(zip(("slice_cols", "k10_cache_rows", "k11_slice_cols"), (o.value for o in out)))


@functools.lru_cache(maxsize=None)
def _slice_cols(itemsize: int) -> int:
    return kernel_layout(itemsize, 1, 1)["slice_cols"]


@functools.lru_cache(maxsize=None)
def _k11_slice_cols(itemsize: int) -> int:
    return kernel_layout(itemsize, 1, 1)["k11_slice_cols"]


# K11 walks g in column slices (`kernel_layout`'s k11_slice_cols, 512 bytes
# a row) where each of g's rows is gathered K11_SLICE_MIN_DEGREE times or
# more on average (E/V) and a row's k selectors touch it sparsely
# (k <= K11_SLICE_MAX_K): then a slice's rows stay in L2 between their
# gathers, where whole rows would not (bench/ablate_csr.py on the H100, f32,
# reddit x1.0 (E/V 339), k = 32: 6.84 ms sliced, 8.14 whole; R-MAT with
# E/V 120: 10% faster sliced, E/V 45: even). Where rows are gathered seldom
# L2 cannot help, and the walk a slice costs more (R-MAT, E/V 6-15: 1.2-1.8x
# slower sliced); at k = 64 the selectors touch most of a row (even at
# reddit, slower on the R-MAT graphs).
K11_SLICE_MIN_DEGREE = 64
K11_SLICE_MAX_K = 32


def k11_slice(itemsize: int, k: int, dim: int, nodes: int, edges: int) -> int:
    """The columns of g a K11 walk of the edges covers: a slice, or all of
    them (see `K11_SLICE_MIN_DEGREE`)."""
    if k > K11_SLICE_MAX_K or edges < K11_SLICE_MIN_DEGREE * max(nodes, 1):
        return dim
    return min(dim, _k11_slice_cols(itemsize))


def _suffix(t: torch.Tensor) -> str:
    return "f32" if t.dtype == torch.float32 else "bf16"


def spmm_csr_cuda(csr: CSRGraph, x: torch.Tensor) -> torch.Tensor:
    """K9 on the card. Counts its launches in `telemetry.launches["spmm_csr"]`."""
    _native.check("spmm_csr", x, KERNEL_DTYPES)
    segs = _segments("spmm_csr", csr, x)
    d = x.shape[1]
    out = x.new_empty((csr.num_nodes, d))
    if csr.num_nodes == 0 or d == 0:
        return out
    _launch("spmm_csr", f"spmm_csr_{_suffix(x)}", csr, segs, x, (x, out), d, d,
            counters=-(-d // _slice_cols(x.element_size())))
    return out


def spgemm_cbsr_cuda(csr: CSRGraph, vals: torch.Tensor, sel: torch.Tensor,
                     dim: int) -> torch.Tensor:
    """K10 on the card: (n, k) values and selectors of the CBSR over the
    CSR's n columns. Counts its launches in `telemetry.launches["spgemm_cbsr"]`."""
    _native.check("spgemm_cbsr", vals, KERNEL_DTYPES)
    k = _check_sel("spgemm_cbsr", sel, vals)
    if k != vals.shape[1] or k < 1 or dim < 1:
        raise ValueError(f"spgemm_cbsr: values {tuple(vals.shape)}, selector "
                         f"{tuple(sel.shape)}, dim={dim}: need k >= 1 slots each and dim >= 1")
    if dim > 32767:
        raise ValueError(f"spgemm_cbsr: dim={dim}: the merged selectors are int16, dim < 32768")
    segs = _segments("spgemm_cbsr", csr, vals)
    out = vals.new_empty((csr.num_nodes, dim))
    if csr.num_nodes == 0:
        return out
    # the merge pass's CBSR: values and int16 selectors
    merged = (torch.empty_like(vals), torch.empty(sel.shape, dtype=torch.int16, device=sel.device))
    _launch("spgemm_cbsr", f"spgemm_cbsr_{_suffix(vals)}", csr, segs, vals,
            (vals, sel, *merged, out), dim, k, dim, vals.shape[0], counters=1, hubs=True)
    return out


def sspmm_cbsr_cuda(csc: CSRGraph, g: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """K11 on the card: the (rows of csc, k) sampled Aᵀ @ g. Counts its
    launches in `telemetry.launches["sspmm_cbsr"]`."""
    _native.check("sspmm_cbsr", g, KERNEL_DTYPES)
    _native.check("sspmm_cbsr", sel, (torch.int32,))
    rows, k = sel.shape
    if rows != csc.num_nodes or sel.get_device() != g.get_device():
        raise ValueError(f"sspmm_cbsr: selector {tuple(sel.shape)} on {sel.device} does not "
                         f"match {csc.num_nodes} rows of Aᵀ on {g.device}")
    segs = _segments("sspmm_cbsr", csc, g)
    out = g.new_empty((rows, k))
    if rows == 0 or k == 0:
        return out
    d = g.shape[1]
    cols = k11_slice(g.element_size(), k, d, csc.num_nodes, csc.nnz)
    _launch("sspmm_cbsr", f"sspmm_cbsr_{_suffix(g)}", csc, segs, g, (g, sel, out), k,
            segs.long_segments, k, d, cols, counters=-(-d // cols), work=True)
    return out


def spmm_csr(csr: CSRGraph, x: torch.Tensor) -> torch.Tensor:
    if x.is_cuda:
        return spmm_csr_cuda(csr, x)
    _on_cpu("spmm_csr", x)
    return spmm_csr_plain(csr, x)


def spgemm_cbsr(csr: CSRGraph, vals: torch.Tensor, sel: torch.Tensor, dim: int) -> torch.Tensor:
    if vals.is_cuda:
        return spgemm_cbsr_cuda(csr, vals, sel, dim)
    _on_cpu("spgemm_cbsr", vals)
    return spgemm_cbsr_plain(csr, vals, sel, dim)


def sspmm_cbsr(csc: CSRGraph, g: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    if g.is_cuda:
        return sspmm_cbsr_cuda(csc, g, sel)
    _on_cpu("sspmm_cbsr", g)
    return sspmm_cbsr_plain(csc, g, sel)
