"""Graph convolution layers over the port's aggregation ops.

Port of `maxk_tpu/models/layers.py`: `MaxKSAGEConv`, `MaxKGraphConv`,
`MaxKGINConv` and `_AggMixin._aggregate`. Degree normalization lives in
the graph's edge values (`build_graph(norm=...)`: "right" for SAGE's mean,
"both" for GCN, "none" for GIN's sum). Each conv takes an optional CBSR,
which the models pass where `takes_cbsr` says; the aggregation then runs
the compact `maxk_spgemm`: on a sharded graph it all_gathers V·k values
instead of V·D features, on one device it runs the paper's pair, K10
forward and K11 backward, which gather k values an edge instead of D.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from maxk_tpu_torch.ops.spgemm import is_segsum, maxk_spgemm, spmm
from maxk_tpu_torch.parallel.shard import ShardedGraph
from maxk_tpu_torch.sparse.cbsr import CBSR, cbsr_sample

# flax's lecun_normal: truncated normal on [-2σ, 2σ], σ rescaled so the
# truncated distribution has variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


def dense(
    in_dim: int, out_dim: int, bias: bool = True,
    generator: Optional[torch.Generator] = None,
) -> nn.Linear:
    """A CPU `nn.Linear` initialised as flax's `Dense`: lecun-normal kernel
    drawn from `generator`, zero bias. Never touches the global RNG."""
    lin = nn.Linear(in_dim, out_dim, bias=bias, device="meta").to_empty(device="cpu")
    std = (1.0 / in_dim) ** 0.5 / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(lin.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
        if lin.bias is not None:
            lin.bias.zero_()
    return lin


def takes_cbsr(conv: nn.Module, graph, dtype: torch.dtype) -> bool:
    """Whether the MaxK activation before `conv` comes as a CBSR, which the
    conv aggregates through `maxk_spgemm`: always on a `ShardedGraph`; on
    one device where the conv aggregates its input (not `lin_before_mp`),
    in f32 (`compute_dtype` None or float32 over `dtype` features), on a
    graph whose mode resolves to the CSR segment sum. Elsewhere the mask
    and `spmm`: the tile and hybrid SpMMs densify anyway, and K10's bf16
    is slower than K9's."""
    if isinstance(graph, ShardedGraph):
        return True
    return (not getattr(conv, "lin_before_mp", False)
            and (conv.compute_dtype or dtype) == torch.float32
            and is_segsum(graph, conv.kernel_mode))


def aggregate(graph, x: torch.Tensor, kernel_mode: str, compute_dtype,
              cbsr: Optional[CBSR] = None) -> torch.Tensor:
    """A @ x, in `compute_dtype` when given, returned in x's dtype.

    With a CBSR (`takes_cbsr`), the compact path: the values are sampled
    again from x, so that what happened to x after densify (the model's
    dropout) reaches the aggregation; with no dropout they are the CBSR's
    values (x == densify(cbsr))."""
    if cbsr is not None:
        cbsr = CBSR(values=cbsr_sample(x, cbsr.selector), selector=cbsr.selector)
        return maxk_spgemm(graph, cbsr, dim=x.shape[-1], mode=kernel_mode,
                           compute_dtype=compute_dtype)
    if compute_dtype is not None:
        return spmm(graph, x.to(compute_dtype), mode=kernel_mode).to(x.dtype)
    return spmm(graph, x, mode=kernel_mode)


class MaxKSAGEConv(nn.Module):
    """GraphSAGE conv, mean aggregator: `fc_self(x) + fc_neigh(A @ x)`.

    When the layer shrinks the width, `fc_neigh` runs before the
    aggregation (`lin_before_mp`, reference `layers.py:83-89`)."""

    def __init__(
        self, in_dim: int, out_dim: int, kernel_mode: str = "auto",
        compute_dtype=None, use_bias: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.kernel_mode = kernel_mode
        self.compute_dtype = compute_dtype
        self.lin_before_mp = in_dim > out_dim
        self.fc_self = dense(in_dim, out_dim, use_bias, generator)
        self.fc_neigh = dense(in_dim, out_dim, False, generator)

    def forward(self, graph, x: torch.Tensor, cbsr: Optional[CBSR] = None) -> torch.Tensor:
        if self.lin_before_mp:
            # shrinking first narrows the SpMM but breaks the CBSR sparsity
            h_neigh = spmm(graph, self.fc_neigh(x), mode=self.kernel_mode)
        else:
            h_neigh = self.fc_neigh(
                aggregate(graph, x, self.kernel_mode, self.compute_dtype, cbsr)
            )
        return self.fc_self(x) + h_neigh


class MaxKGraphConv(nn.Module):
    """GCN conv, `weight(A @ x)` over the symmetric norm D^-1/2 A D^-1/2;
    `weight` first when it shrinks the width (reference `layers.py:93-108`)."""

    def __init__(
        self, in_dim: int, out_dim: int, kernel_mode: str = "auto",
        compute_dtype=None, generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.kernel_mode = kernel_mode
        self.compute_dtype = compute_dtype
        self.lin_before_mp = in_dim > out_dim
        self.weight = dense(in_dim, out_dim, True, generator)

    def forward(self, graph, x: torch.Tensor, cbsr: Optional[CBSR] = None) -> torch.Tensor:
        if self.lin_before_mp:
            return spmm(graph, self.weight(x), mode=self.kernel_mode)
        return self.weight(aggregate(graph, x, self.kernel_mode, self.compute_dtype, cbsr))


class MaxKGINConv(nn.Module):
    """GIN conv, `apply_func((1+eps)·x + A @ x)` over the raw sum, with a
    learnable `eps` (initially 0) and the 2-layer MLP
    `apply_func_1(relu(apply_func_0(·)))`, hidden width `out_dim`
    (reference `layers.py:111-140` at its defaults)."""

    def __init__(
        self, in_dim: int, out_dim: int, kernel_mode: str = "auto",
        compute_dtype=None, generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.kernel_mode = kernel_mode
        self.compute_dtype = compute_dtype
        self.eps = nn.Parameter(torch.zeros((), dtype=torch.float32))
        self.apply_func_0 = dense(in_dim, out_dim, True, generator)
        self.apply_func_1 = dense(out_dim, out_dim, True, generator)

    def forward(self, graph, x: torch.Tensor, cbsr: Optional[CBSR] = None) -> torch.Tensor:
        agg = aggregate(graph, x, self.kernel_mode, self.compute_dtype, cbsr)
        h = (1.0 + self.eps) * x + agg
        return self.apply_func_1(torch.relu(self.apply_func_0(h)))
