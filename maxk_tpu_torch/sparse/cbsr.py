"""CBSR — Compressed Balanced Sparse Row feature format.

Port of `maxk_tpu/sparse/cbsr.py`: a `(V, k)` value matrix plus a `(V, k)`
int32 column-selector matrix, the output of the MaxK nonlinearity in
compact form. `cbsr_densify` and `cbsr_sample` are differentiable and run
the CUDA kernels of `ops/cbsr_cuda.py` on CUDA tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from maxk_tpu_torch.ops.cbsr_cuda import Densify, Sample
from maxk_tpu_torch.ops.topk_cuda import order_keys


@dataclass(frozen=True)
class CBSR:
    """values: (V, k) float; selector: (V, k) int32 in [0, D)."""

    values: torch.Tensor
    selector: torch.Tensor

    @property
    def k(self) -> int:
        return self.values.shape[-1]

    @property
    def num_rows(self) -> int:
        return self.values.shape[0]


def maxk_cbsr(x: torch.Tensor, k: int) -> CBSR:
    """Top-k per row → CBSR, values in descending order, ties to the lowest
    column (`lax.top_k`'s order). Differentiable in the values."""
    sel = order_keys(x).sort(dim=-1, descending=True, stable=True).indices[..., :k]
    return CBSR(values=torch.gather(x, -1, sel), selector=sel.to(torch.int32))


def maxk_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain MaxK: keep every value >= the row's k-th largest (more than k
    on ties — the fast path `ops.topk_cuda.maxk_mask_fast` keeps exactly k)."""
    kth = torch.topk(x, k, dim=-1).values[..., -1:]
    return torch.where(x >= kth, x, torch.zeros_like(x))


def cbsr_densify(cbsr: CBSR, dim: int) -> torch.Tensor:
    """CBSR → dense (V, dim); the backward samples at the selectors."""
    return Densify.apply(cbsr.values.contiguous(), cbsr.selector.contiguous(), dim)


def cbsr_sample(z: torch.Tensor, selector: torch.Tensor) -> torch.Tensor:
    """out[v, l] = z[v, sel[v, l]]; the backward densifies."""
    return Sample.apply(z.contiguous(), selector.contiguous())
