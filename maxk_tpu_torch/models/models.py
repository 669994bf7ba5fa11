"""GNN models: `lin_in → L×[nonlinear → dropout → conv (→ LayerNorm)] → lin_out`.

Port of `MaxKSAGE`, `MaxKGCN`, `MaxKGIN`, the ReLU aliases `SAGE`, `GCN`
and `GIN`, `GNNRes` and `_GNNBase._nonlinear`
(`maxk_tpu/models/models.py:43-171`). The
nonlinearity is "maxk" or "relu". With maxk on one device the activation
is the mask kernel (`ops/topk_cuda.maxk_mask_fast`) and each layer
aggregates the masked dense features with `spmm`. On a `ShardedGraph`
it is the top-k → CBSR kernel (`maxk_cbsr_fast`) and its densify: the
layer gets both, and aggregates through the compact `maxk_spgemm`, whose
all_gather moves V·k values instead of V·D features. GNNRes is the
residual GCN with flax's BatchNorm and no MaxK.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from maxk_tpu_torch.models.layers import MaxKGINConv, MaxKGraphConv, MaxKSAGEConv, dense
from maxk_tpu_torch.ops.topk_cuda import maxk_cbsr_fast, maxk_mask_fast
from maxk_tpu_torch.parallel.shard import ShardedGraph
from maxk_tpu_torch.sparse.cbsr import cbsr_densify


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


class _GNNBase(nn.Module):
    """The shared stack; subclasses name their conv. Parameters are created
    on the CPU from `generator`; move the model with `.to(device)`.
    Attribute names follow the flax modules (`lin_in`, `conv{i}.*`,
    `ln{i}`, `lin_out`)."""

    conv_cls = None
    default_nonlinear = "maxk"

    def __init__(
        self,
        in_dim: int,
        hidden_dim: int = 256,
        num_layers: int = 3,
        out_dim: int = 41,
        maxk: int = 32,
        nonlinear: Optional[str] = None,
        dropout: float = 0.5,
        norm: bool = False,
        kernel_mode: str = "auto",
        compute_dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.num_layers = num_layers
        self.maxk = maxk
        self.nonlinear = nonlinear or self.default_nonlinear
        self.dropout = dropout
        self.norm = norm
        self.lin_in = dense(in_dim, hidden_dim, True, generator)
        for i in range(num_layers):
            self.add_module(
                f"conv{i}",
                self.conv_cls(
                    hidden_dim, hidden_dim, kernel_mode=kernel_mode,
                    compute_dtype=compute_dtype, generator=generator,
                ),
            )
            if norm:
                # flax LayerNorm's epsilon
                self.add_module(f"ln{i}", nn.LayerNorm(hidden_dim, eps=1e-6))
        self.lin_out = dense(hidden_dim, out_dim, True, generator)

    def _nonlinear(self, x: torch.Tensor, graph):
        """(activated dense, CBSR or None). Sharded, the CBSR is what the
        compact aggregation gathers and densify(CBSR) ≡ x ⊙ mask; on one
        device the mask kernel skips the compaction."""
        if self.nonlinear != "maxk":
            return torch.relu(x), None
        if isinstance(graph, ShardedGraph):
            cbsr = maxk_cbsr_fast(x, self.maxk)
            return cbsr_densify(cbsr, x.shape[-1]).to(x.dtype), cbsr
        return maxk_mask_fast(x, self.maxk), None

    def forward(
        self, graph, x: torch.Tensor, train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        x = self.lin_in(x)
        for i in range(self.num_layers):
            x, cbsr = self._nonlinear(x, graph)
            if train:
                x = dropout(x, self.dropout, generator)
            x = getattr(self, f"conv{i}")(graph, x, cbsr)
            if self.norm:
                x = getattr(self, f"ln{i}")(x)
        return self.lin_out(x)


class MaxKSAGE(_GNNBase):
    """`lin_in → L×[MaxK → dropout → SAGEConv(mean)] → lin_out`."""

    conv_cls = MaxKSAGEConv


class MaxKGCN(_GNNBase):
    """`lin_in → L×[MaxK → dropout → GraphConv (+LayerNorm)] → lin_out`."""

    conv_cls = MaxKGraphConv


class MaxKGIN(_GNNBase):
    """GIN stack with `(1+eps)x + sum_agg` convs."""

    conv_cls = MaxKGINConv


class SAGE(MaxKSAGE):
    """The ReLU baseline arm of SAGE: same architecture, no CBSR path."""

    default_nonlinear = "relu"


class GCN(MaxKGCN):
    """The ReLU baseline arm of GCN: same architecture, no CBSR path."""

    default_nonlinear = "relu"


class GIN(MaxKGIN):
    """The ReLU baseline arm of GIN."""

    default_nonlinear = "relu"


class BatchNorm(nn.Module):
    """flax's `nn.BatchNorm` over the node axis, at its defaults: momentum
    0.99, epsilon 1e-5, the biased batch variance E[x²] − E[x]² (clamped
    at 0) both to normalize and in the running average. `weight` and
    `bias` are flax's `scale` and `bias`; the buffers `mean` and `var` are
    its `batch_stats`. The mode is the `train` argument, not
    `module.training`: batch statistics (and a running-average update)
    when training, the running ones otherwise."""

    def __init__(self, dim: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if train:
            mean = x.mean(0)
            var = (x.square().mean(0) - mean.square()).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class GNNRes(_GNNBase):
    """Residual GCN with BatchNorm: `lin_in → L×[GraphConv → BatchNorm →
    dropout → relu(h) + x] → lin_out`, over the norm "both", with no MaxK
    (`maxk_tpu/models/models.py:146-163`)."""

    conv_cls = MaxKGraphConv

    def __init__(self, in_dim: int, hidden_dim: int = 256, num_layers: int = 3, **kwargs):
        kwargs["norm"] = False  # the stack's LayerNorm is not part of GNNRes
        super().__init__(in_dim, hidden_dim=hidden_dim, num_layers=num_layers, **kwargs)
        for i in range(num_layers):
            self.add_module(f"bn{i}", BatchNorm(hidden_dim))

    def forward(
        self, graph, x: torch.Tensor, train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        x = self.lin_in(x)
        for i in range(self.num_layers):
            h = getattr(self, f"conv{i}")(graph, x)
            h = getattr(self, f"bn{i}")(h, train)
            if train:
                h = dropout(h, self.dropout, generator)
            x = torch.relu(h) + x
        return self.lin_out(x)


_MODEL_NORMS = {
    "sage": (MaxKSAGE, "right"),
    "gcn": (MaxKGCN, "both"),
    "gin": (MaxKGIN, "none"),
    "gnn_res": (GNNRes, "both"),
}


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
    cls, gnorm = _MODEL_NORMS[model]
    module = cls(
        in_dim, hidden_dim=hidden_dim, num_layers=num_layers, out_dim=out_dim,
        maxk=maxk, nonlinear=nonlinear, dropout=dropout, norm=norm,
        kernel_mode=kernel_mode, compute_dtype=compute_dtype, generator=generator,
    )
    return module, gnorm
