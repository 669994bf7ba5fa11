"""The MaxK nonlinearity: keep the k largest values of each row.

Port of the mask half of `maxk_tpu/ops/topk_pallas.py`. The TPU kernel
`_mask_kernel` (`topk_pallas.py:99`, launcher `_mask_pallas_raw` :114-138)
becomes the CUDA kernel `csrc/maxk_mask.cu`; `maxk_mask_plain` is the same
function in plain PyTorch. Both order values by the same order-preserving
integer key and break ties toward the lowest column, so each row keeps
exactly k values and the two agree bit for bit. (A value sort or
`torch.topk` on the values would not: they treat -0.0 and +0.0 as equal
and promise no order among ties.)

`maxk_mask` runs the kernel for a CUDA tensor and the plain version for a
CPU tensor; `maxk_mask_fast` is the differentiable activation, whose
backward is `g ⊙ take`.
"""

from __future__ import annotations

import torch

from maxk_tpu_torch.ops import _native

KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def order_keys(x: torch.Tensor) -> torch.Tensor:
    """int32 keys whose order is x's order as f32, with -0.0 < +0.0.

    The signed twin of the TPU kernel's uint32 key
    (`bits | 0x80000000` for x >= +0, `~bits` below): the two differ by
    the top bit only, so they order alike."""
    bits = x.to(torch.float32).view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def maxk_mask_plain(x: torch.Tensor, k: int):
    """(y, take): y = x where take and +0.0 elsewhere, in x's dtype; take
    a uint8 0/1 mask with exactly k ones per row (ties to the lowest
    columns)."""
    keys = order_keys(x)
    thr = keys.topk(k, dim=-1).values[..., -1:]  # the k-th largest key
    gt = keys > thr
    eq = keys == thr
    n_gt = gt.sum(-1, keepdim=True)
    eq_i = eq.to(torch.int32)
    eq_before = torch.cumsum(eq_i, dim=-1) - eq_i
    take = gt | (eq & (eq_before < k - n_gt))
    y = torch.where(take, x, torch.zeros((), dtype=x.dtype, device=x.device))
    return y, take.to(torch.uint8)


def maxk_mask_cuda(x: torch.Tensor, k: int):
    """The CUDA kernel: one warp per row. D must be a multiple of 32, at
    most 1024. Counts its launches in `maxk_mask_cuda.launches`."""
    _native.check("maxk_mask", x, KERNEL_DTYPES)
    v, d = x.shape
    if d % 32 or not 32 <= d <= 1024:
        raise ValueError(f"maxk_mask: D={d} must be a multiple of 32 in [32, 1024]")
    if not 1 <= k <= d:
        raise ValueError(f"maxk_mask: k={k} must be in [1, {d}]")
    y = torch.empty_like(x)
    take = torch.empty((v, d), dtype=torch.uint8, device=x.device)
    if v == 0:
        return y, take
    name = "maxk_mask_f32" if x.dtype == torch.float32 else "maxk_mask_bf16"
    _native.launch(name, x.data_ptr(), y.data_ptr(), take.data_ptr(), v, d, k)
    maxk_mask_cuda.launches += 1
    return y, take


maxk_mask_cuda.launches = 0


def maxk_mask(x: torch.Tensor, k: int):
    """(y, take) by the kernel for a CUDA tensor, the plain version for a
    CPU tensor."""
    if x.is_cuda:
        return maxk_mask_cuda(x, k)
    if x.device.type != "cpu":
        raise ValueError(f"maxk_mask: no implementation for device {x.device}")
    return maxk_mask_plain(x, k)


class MaxKMask(torch.autograd.Function):
    """y = x ⊙ topk_mask(x); the backward is g ⊙ take (role of
    `maxk_mask_pallas`'s custom VJP, `topk_pallas.py:141-163`)."""

    @staticmethod
    def forward(ctx, x, k):
        y, take = maxk_mask(x, k)
        ctx.save_for_backward(take)
        return y

    @staticmethod
    def backward(ctx, g):
        (take,) = ctx.saved_tensors
        return g * take.to(g.dtype), None


def maxk_mask_fast(x: torch.Tensor, k: int) -> torch.Tensor:
    """The MaxK activation of every layer: exactly k survivors per row."""
    return MaxKMask.apply(x.contiguous(), k)
