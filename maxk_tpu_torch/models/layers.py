"""Graph convolution layers over the port's aggregation ops.

Port of `maxk_tpu/models/layers.py` (single device): `MaxKSAGEConv` and
the dense branch of `_AggMixin._aggregate`. Degree normalization lives in
the graph's edge values (`build_graph(norm="right")` for SAGE's mean).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from maxk_tpu_torch.ops.spgemm import spmm
from maxk_tpu_torch.sparse.graph import Graph

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


def aggregate(graph: Graph, x: torch.Tensor, kernel_mode: str, compute_dtype) -> torch.Tensor:
    """A @ x, in `compute_dtype` when given, returned in x's dtype."""
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

    def forward(self, graph: Graph, x: torch.Tensor) -> torch.Tensor:
        if self.lin_before_mp:
            h_neigh = spmm(graph, self.fc_neigh(x), mode=self.kernel_mode)
        else:
            h_neigh = self.fc_neigh(
                aggregate(graph, x, self.kernel_mode, self.compute_dtype)
            )
        return self.fc_self(x) + h_neigh
