"""MaxK-SAGE: `lin_in → L×[MaxK → dropout → SAGEConv(mean)] → lin_out`.

Port of `MaxKSAGE` and the single-device branch of `_GNNBase._nonlinear`
(`maxk_tpu/models/models.py:43-88`). On one device the MaxK activation is
the mask kernel (`ops/topk_cuda.maxk_mask_fast`), and each layer
aggregates the masked dense features with `spmm`. GCN, GIN and GNNRes are
not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from maxk_tpu_torch.models.layers import MaxKSAGEConv, dense
from maxk_tpu_torch.ops.topk_cuda import maxk_mask_fast
from maxk_tpu_torch.sparse.graph import Graph


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's Dropout: keep with probability 1-rate, scale kept by 1/(1-rate).
    The mask is drawn from `generator`, which must live on x's device."""
    if rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class MaxKSAGE(nn.Module):
    """Parameters are created on the CPU from `generator`; move the model
    with `.to(device)`. Attribute names follow the flax modules (`lin_in`,
    `conv{i}.fc_self`, `conv{i}.fc_neigh`, `ln{i}`, `lin_out`)."""

    def __init__(
        self,
        in_dim: int,
        hidden_dim: int = 256,
        num_layers: int = 3,
        out_dim: int = 41,
        maxk: int = 32,
        nonlinear: str = "maxk",
        dropout: float = 0.5,
        norm: bool = False,
        kernel_mode: str = "auto",
        compute_dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.num_layers = num_layers
        self.maxk = maxk
        self.nonlinear = nonlinear
        self.dropout = dropout
        self.norm = norm
        self.lin_in = dense(in_dim, hidden_dim, True, generator)
        for i in range(num_layers):
            self.add_module(
                f"conv{i}",
                MaxKSAGEConv(
                    hidden_dim, hidden_dim, kernel_mode=kernel_mode,
                    compute_dtype=compute_dtype, generator=generator,
                ),
            )
            if norm:
                # flax LayerNorm's epsilon
                self.add_module(f"ln{i}", nn.LayerNorm(hidden_dim, eps=1e-6))
        self.lin_out = dense(hidden_dim, out_dim, True, generator)

    def _nonlinear(self, x: torch.Tensor) -> torch.Tensor:
        if self.nonlinear == "maxk":
            return maxk_mask_fast(x, self.maxk)
        return torch.relu(x)

    def forward(
        self, graph: Graph, x: torch.Tensor, train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        x = self.lin_in(x)
        for i in range(self.num_layers):
            x = self._nonlinear(x)
            if train:
                x = dropout(x, self.dropout, generator)
            x = getattr(self, f"conv{i}")(graph, x)
            if self.norm:
                x = getattr(self, f"ln{i}")(x)
        return self.lin_out(x)


_NOT_PORTED = ("gcn", "gin", "gnn_res")


def build_model(
    model: str,
    in_dim: int,
    out_dim: int,
    hidden_dim: int = 256,
    num_layers: int = 3,
    maxk: int = 32,
    nonlinear: str = "maxk",
    dropout: float = 0.5,
    norm: bool = False,
    kernel_mode: str = "auto",
    compute_dtype=None,
    generator: Optional[torch.Generator] = None,
):
    """Returns (module, graph_norm_mode). The module is on the CPU."""
    if model in _NOT_PORTED:
        raise NotImplementedError(
            f"--model {model} is not ported yet: ROADMAP A7 (GCN, GIN, GNNRes)"
        )
    if model != "sage":
        raise KeyError(model)
    module = MaxKSAGE(
        in_dim, hidden_dim=hidden_dim, num_layers=num_layers, out_dim=out_dim,
        maxk=maxk, nonlinear=nonlinear, dropout=dropout, norm=norm,
        kernel_mode=kernel_mode, compute_dtype=compute_dtype, generator=generator,
    )
    return module, "right"
