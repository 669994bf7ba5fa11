"""Core aggregation ops with their backward rules.

Port of `maxk_tpu/ops/spgemm.py` (the segsum branches), as autograd
Functions:

  spmm:        forward  Y = A @ x,  backward  dx = Aᵀ @ g
  maxk_spgemm: forward  Y = A @ densify(CBSR)
               backward dvals[v, l] = (Aᵀ @ g)[v, sel[v, l]]

Normalization is folded into the edge values, so the backward is exactly
Aᵀ. maxk_spgemm keeps only the (V, k) selector between forward and
backward; densify and sample are the CUDA kernels of `ops/cbsr_cuda.py`
on CUDA tensors. `compute_dtype` casts the values before densify and the
cotangent before the Aᵀ SpMM; the SpMM still sums in f32, and the output
is cast back to the values' dtype.

On a `parallel.shard.ShardedGraph` (one rank's row blocks) the same ops
run the row-partitioned scheme of `spgemm.py:51-81,156-189`: spmm
all_gathers x and aggregates the local block, its backward reduce-
scatters the (Vp, D) partials of the transposed block; maxk_spgemm
all_gathers the compressed CBSR (values cast to `compute_dtype` first),
densifies and aggregates the local block, and its backward samples the
reduce-scattered cotangent at the local selectors.
"""

from __future__ import annotations

from typing import Optional

import torch

from maxk_tpu_torch.ops.cbsr_cuda import densify, sample
from maxk_tpu_torch.ops.dispatch import KernelMode, resolve_mode
from maxk_tpu_torch.ops.spmm_xla import spmm_segsum
from maxk_tpu_torch.parallel.collectives import all_gather_rows, reduce_scatter_rows
from maxk_tpu_torch.parallel.shard import ShardedGraph
from maxk_tpu_torch.sparse.cbsr import CBSR


def _spmm_impl(graph, x: torch.Tensor, mode: str, transpose: bool) -> torch.Tensor:
    resolve_mode(mode)  # SEGSUM is the only SpMM ported; others raise
    if isinstance(graph, ShardedGraph):
        if transpose:  # (Vp, D) partials → summed local rows
            return reduce_scatter_rows(spmm_segsum(graph.bwd, x), graph.mesh)
        return spmm_segsum(graph.fwd, all_gather_rows(x, graph.mesh))
    return spmm_segsum(graph.csc if transpose else graph.csr, x)


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
        resolve_mode(mode)
        if isinstance(graph, ShardedGraph):
            # gather the compressed features, not (Vp, dim) dense rows;
            # x is then whole, so the local block needs no second gather
            x = densify(all_gather_rows(vals, graph.mesh), all_gather_rows(sel, graph.mesh), dim)
            return spmm_segsum(graph.fwd, x).to(ctx.vals_dtype)
        return spmm_segsum(graph.csr, densify(vals, sel, dim)).to(ctx.vals_dtype)

    @staticmethod
    def backward(ctx, g):
        (sel,) = ctx.saved_tensors
        if ctx.compute_dtype is not None:
            g = g.to(ctx.compute_dtype)
        z = _spmm_impl(ctx.graph, g.contiguous(), ctx.mode, transpose=True)
        dvals = sample(z, sel).to(ctx.vals_dtype)
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
