"""Core aggregation ops with their backward rules.

Port of `maxk_tpu/ops/spgemm.py`, as autograd Functions:

  spmm:        forward  Y = A @ x,  backward  dx = Aᵀ @ g
  maxk_spgemm: forward  Y = A @ densify(CBSR)
               backward dvals[v, l] = (Aᵀ @ g)[v, sel[v, l]]

Normalization is folded into the edge values, so the backward is exactly
Aᵀ. maxk_spgemm keeps only the (V, k) selector between forward and
backward; where it densifies and samples, those are the CUDA kernels of
`ops/cbsr_cuda.py` on CUDA tensors. `compute_dtype` casts the values
before densify and the cotangent before the Aᵀ SpMM; the SpMM still sums
in f32, and the output is cast back to the values' dtype.

On a `parallel.shard.ShardedGraph` (one rank's row blocks) the same ops
run the row-partitioned scheme of `spgemm.py:51-81,156-189`: spmm
all_gathers x and aggregates the local block, its backward reduce-
scatters the (Vp, D) partials of the transposed block; maxk_spgemm
all_gathers the compressed CBSR (values cast to `compute_dtype` first),
densifies and aggregates the local block, and its backward samples the
reduce-scattered cotangent at the local selectors.

The SpMM is the CSR kernel `spmm_csr` (K9, `ops/spmm_csr.py`; the plain
`spmm_segsum` on the CPU) under SEGSUM, and under AUTO on a graph without
a strip schedule; there maxk_spgemm runs the paper's pair on one device,
`spgemm_cbsr` (K10, densify and SpMM in one kernel) forward and
`sspmm_cbsr` (K11, the Aᵀ SpMM sampled at the selectors) backward, and
its sharded forward runs K10 over the rank's block after the CBSR
all_gather (its backward keeps the Aᵀ block, the reduce-scatter and K3).
Under TILES_XLA and TILES_SCAN it runs over the graph's
edge-tile tables (`build_graph(build_tiles=True)`, `build_sharded_graph(
build_tiles=True)`), which must exist. A rank's block always takes
`spmm_tiles_scan`, as in the reference. Under HYBRID and HYBRID_INT8 (and
AUTO on a graph with a schedule) it is `spmm_hybrid` over the graph's
strip schedule (`build_graph(hybrid=True)`; an explicit hybrid mode on a
graph without one raises `ValueError`), whose Aᵀ is the same schedule;
maxk_spgemm then folds the pre-scale into the (V, k) values before the
densify (`spgemm.py:196-211`). A sharded graph with a schedule
(`build_sharded_graph(hybrid=True)`) all_gathers the features, dense or
compressed, and runs `spmm_hybrid_sharded` both ways, whatever the mode,
as the reference's does (`spgemm.py:51-69,172-182`).
"""

from __future__ import annotations

from typing import Optional

import torch

from maxk_tpu_torch.ops.cbsr_cuda import densify, sample
from maxk_tpu_torch.ops.dispatch import HYBRID_MODES, KernelMode, missing_hybrid, resolve_mode
from maxk_tpu_torch.ops.spmm_csr import spgemm_cbsr, spmm_csr, sspmm_cbsr
from maxk_tpu_torch.ops.spmm_hybrid import spmm_hybrid, spmm_hybrid_sharded
from maxk_tpu_torch.ops.spmm_xla import spmm_tiles_scan, spmm_tiles_xla
from maxk_tpu_torch.parallel.collectives import all_gather_rows, reduce_scatter_rows
from maxk_tpu_torch.parallel.shard import ShardedGraph
from maxk_tpu_torch.sparse.cbsr import CBSR


def _local_spmm(csr, tiles, x: torch.Tensor, mode: str, sharded: bool = False) -> torch.Tensor:
    """A @ x for one operand: `csr`, or its tile tables `tiles` under the
    tile modes (the scan on a rank's block, `sharded`)."""
    resolved = resolve_mode(mode, tiles is not None)
    if resolved == KernelMode.SEGSUM:
        return spmm_csr(csr, x)
    if resolved in HYBRID_MODES:  # a rank's block without a strip schedule
        raise missing_hybrid(resolved)
    if tiles is None:
        raise ValueError(f"kernel_mode={mode!r} needs edge-tile tables: build the graph with "
                         "build_tiles=True")
    if resolved == KernelMode.TILES_XLA and not sharded:
        return spmm_tiles_xla(tiles, x)
    return spmm_tiles_scan(tiles, x)


def _hybrid_mode(graph, mode: str):
    """The resolved hybrid mode of a one-device graph, or None for the
    other SpMMs; raises for a hybrid mode on a graph without a schedule."""
    resolved = resolve_mode(mode, graph.tiles is not None, graph.hybrid is not None)
    if resolved not in HYBRID_MODES:
        return None
    if graph.hybrid is None:
        raise missing_hybrid(resolved)
    return resolved


def _segsum(graph, mode: str) -> bool:
    """Whether a one-device graph's SpMM under `mode` is the CSR segment sum."""
    return (_hybrid_mode(graph, mode) is None
            and resolve_mode(mode, graph.tiles is not None) == KernelMode.SEGSUM)


def _spmm_impl(graph, x: torch.Tensor, mode: str, transpose: bool) -> torch.Tensor:
    if isinstance(graph, ShardedGraph):
        resolve_mode(mode)  # pallas raises before any collective
        if graph.hybrid is not None:
            return spmm_hybrid_sharded(graph.hybrid, all_gather_rows(x, graph.mesh), graph.mesh,
                                       transpose=transpose)
        if transpose:  # (Vp, D) partials → summed local rows
            z = _local_spmm(graph.bwd, graph.bwd_tiles, x, mode, sharded=True)
            return reduce_scatter_rows(z, graph.mesh)
        return _local_spmm(graph.fwd, graph.fwd_tiles, all_gather_rows(x, graph.mesh), mode,
                           sharded=True)
    hybrid = _hybrid_mode(graph, mode)
    if hybrid is not None:
        return spmm_hybrid(graph.hybrid, x, transpose=transpose,
                           feat_int8=hybrid == KernelMode.HYBRID_INT8)
    if transpose:
        return _local_spmm(graph.csc, graph.tiles_t, x, mode)
    return _local_spmm(graph.csr, graph.tiles, x, mode)


class _SpMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, graph, mode):
        ctx.graph, ctx.mode = graph, mode
        return _spmm_impl(graph, x, mode, transpose=False)

    @staticmethod
    def backward(ctx, g):
        return _spmm_impl(ctx.graph, g.contiguous(), ctx.mode, transpose=True), None, None


def spmm(graph, x: torch.Tensor, mode: str = "auto") -> torch.Tensor:
    """y = A @ x (edge weights already carry any normalization). `graph` is
    a `Graph`, or a `ShardedGraph` with x this rank's rows."""
    return _SpMM.apply(x, graph, KernelMode(mode).value)


class _MaxKSpGEMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, sel, graph, dim, mode, compute_dtype):
        ctx.save_for_backward(sel)
        ctx.graph, ctx.mode, ctx.compute_dtype = graph, mode, compute_dtype
        ctx.vals_dtype = vals.dtype
        if compute_dtype is not None:
            # densify only places values: casting first gives the same
            # numbers without a (V, dim) tensor in the wider dtype (and,
            # sharded, gathers fewer bytes)
            vals = vals.to(compute_dtype)
        resolve_mode(mode)  # pallas raises before any collective
        if isinstance(graph, ShardedGraph):
            # gather the compressed features, not (Vp, dim) dense rows;
            # x is then whole, so the local block needs no second gather
            vals, sel = all_gather_rows(vals, graph.mesh), all_gather_rows(sel, graph.mesh)
            h = graph.hybrid
            if h is not None:  # the pre-scale folded into the values, as below
                x = densify(vals * h.pre[:, None].to(vals.dtype), sel, dim)
                y = spmm_hybrid_sharded(h, x, graph.mesh, pre_applied=True)
            elif resolve_mode(mode, graph.fwd_tiles is not None) == KernelMode.SEGSUM:
                y = spgemm_cbsr(graph.fwd, vals, sel, dim)
            else:
                y = _local_spmm(graph.fwd, graph.fwd_tiles, densify(vals, sel, dim), mode,
                                sharded=True)
            return y.to(ctx.vals_dtype)
        hybrid = _hybrid_mode(graph, mode)
        if hybrid is not None:
            # the pre-scale folded into the (V, k) values: the same product
            # (unselected entries are 0 either way), one (V, dim) tensor fewer
            h = graph.hybrid
            x = densify(vals * h.pre[:, None].to(vals.dtype), sel, dim)
            y = spmm_hybrid(h, x, pre_applied=True, feat_int8=hybrid == KernelMode.HYBRID_INT8)
        elif _segsum(graph, mode):
            y = spgemm_cbsr(graph.csr, vals, sel, dim)
        else:
            y = _spmm_impl(graph, densify(vals, sel, dim), mode, transpose=False)
        return y.to(ctx.vals_dtype)

    @staticmethod
    def backward(ctx, g):
        (sel,) = ctx.saved_tensors
        if ctx.compute_dtype is not None:
            g = g.to(ctx.compute_dtype)
        graph = ctx.graph
        if not isinstance(graph, ShardedGraph) and _segsum(graph, ctx.mode):
            dvals = sspmm_cbsr(graph.csc, g.contiguous(), sel)
        else:
            dvals = sample(_spmm_impl(graph, g.contiguous(), ctx.mode, transpose=True), sel)
        dvals = dvals.to(ctx.vals_dtype)
        return dvals, None, None, None, None, None


def maxk_spgemm(
    graph,
    cbsr: CBSR,
    dim: int,
    mode: str = "auto",
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Y = A @ densify(CBSR), gradient sampled at the CBSR coordinates.

    `dim` is the dense feature width; `compute_dtype=torch.bfloat16`
    halves the SpMM's gather traffic, with f32 accumulation."""
    return _MaxKSpGEMM.apply(
        cbsr.values.contiguous(), cbsr.selector.contiguous(), graph, dim,
        KernelMode(mode).value, compute_dtype,
    )
