"""The MaxK nonlinearity: keep the k largest values of each row.

Port of `maxk_tpu/ops/topk_pallas.py`. Two TPU kernels become CUDA
kernels, each with the same function in plain PyTorch beside it:

  _mask_kernel (`topk_pallas.py:99`, launcher `_mask_pallas_raw` :114-138)
      → `csrc/maxk_mask.cu`, `maxk_mask_plain`: y = x ⊙ take;
  _topk_kernel (`topk_pallas.py:79`, launcher `_topk_pallas_raw` :184-207)
      → `csrc/topk_cbsr.cu`, `topk_cbsr_plain`: the (V, k) CBSR pair.

All of them order values by the same order-preserving integer key and
break ties toward the lowest column, so each row keeps exactly k values
and kernel and plain version agree bit for bit. (A value sort or
`torch.topk` on the values would not: they treat -0.0 and +0.0 as equal
and promise no order among ties.)

`maxk_mask` and `topk_cbsr` run the kernel for a CUDA tensor and the plain
version for a CPU tensor. `maxk_mask_fast` is the differentiable
activation of the single-device path, whose backward is `g ⊙ take`;
`maxk_cbsr_fast` the differentiable CBSR of the sharded path, whose
backward densifies the value cotangent.
"""

from __future__ import annotations

import torch

from maxk_tpu_torch.ops import _native
from maxk_tpu_torch.ops.cbsr_cuda import densify

KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def order_keys(x: torch.Tensor) -> torch.Tensor:
    """int32 keys whose order is x's order as f32, with -0.0 < +0.0.

    The signed twin of the TPU kernel's uint32 key
    (`bits | 0x80000000` for x >= +0, `~bits` below): the two differ by
    the top bit only, so they order alike."""
    bits = x.to(torch.float32).view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def _take_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean top-k mask, exactly k per row (ties to the lowest columns)."""
    keys = order_keys(x)
    thr = keys.topk(k, dim=-1).values[..., -1:]  # the k-th largest key
    gt = keys > thr
    eq = keys == thr
    n_gt = gt.sum(-1, keepdim=True)
    eq_i = eq.to(torch.int32)
    eq_before = torch.cumsum(eq_i, dim=-1) - eq_i
    return gt | (eq & (eq_before < k - n_gt))


def maxk_mask_plain(x: torch.Tensor, k: int):
    """(y, take): y = x where take and +0.0 elsewhere, in x's dtype; take
    a uint8 0/1 mask with exactly k ones per row (ties to the lowest
    columns)."""
    take = _take_plain(x, k)
    y = torch.where(take, x, torch.zeros((), dtype=x.dtype, device=x.device))
    return y, take.to(torch.uint8)


def maxk_mask_cuda(x: torch.Tensor, k: int):
    """The CUDA kernel: one warp per row. D must be a multiple of 32, at
    most 1024. Counts its launches in `telemetry.launches["maxk_mask"]`."""
    _native.check("maxk_mask", x, KERNEL_DTYPES)
    v, d = x.shape
    if d % 32 or not 32 <= d <= 1024:
        raise ValueError(f"maxk_mask: D={d} must be a multiple of 32 in [32, 1024]")
    if not 1 <= k <= d:
        raise ValueError(f"maxk_mask: k={k} must be in [1, {d}]")
    y = torch.empty_like(x)
    take = x.new_empty((v, d), dtype=torch.uint8)
    if v == 0:
        return y, take
    name = "maxk_mask_f32" if x.dtype == torch.float32 else "maxk_mask_bf16"
    _native.launch("maxk_mask", name, x, x.data_ptr(), y.data_ptr(), take.data_ptr(), v, d, k)
    return y, take


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


def topk_cbsr_plain(x: torch.Tensor, k: int):
    """(vals, sel): the k taken values of each row as f32 and their columns
    as int32, in ascending column order; the taken set is
    `maxk_mask_plain`'s. A selected -0.0 is written as +0.0, as the TPU
    kernel's masked row sums give it."""
    v = x.shape[0]
    sel = _take_plain(x, k).nonzero()[:, 1].view(v, k)  # row-major: columns ascend
    vals = torch.gather(x.to(torch.float32), 1, sel)
    vals = torch.where(vals == 0, torch.zeros((), dtype=vals.dtype, device=x.device), vals)
    return vals, sel.to(torch.int32)


def topk_cbsr_cuda(x: torch.Tensor, k: int):
    """The CUDA kernel: one warp per row. D must be a multiple of 32, at
    most 1024. Counts its launches in `telemetry.launches["topk_cbsr"]`."""
    _native.check("topk_cbsr", x, KERNEL_DTYPES)
    v, d = x.shape
    if d % 32 or not 32 <= d <= 1024:
        raise ValueError(f"topk_cbsr: D={d} must be a multiple of 32 in [32, 1024]")
    if not 1 <= k <= d:
        raise ValueError(f"topk_cbsr: k={k} must be in [1, {d}]")
    vals = x.new_empty((v, k), dtype=torch.float32)
    sel = x.new_empty((v, k), dtype=torch.int32)
    if v == 0:
        return vals, sel
    name = "topk_cbsr_f32" if x.dtype == torch.float32 else "topk_cbsr_bf16"
    _native.launch("topk_cbsr", name, x, x.data_ptr(), vals.data_ptr(), sel.data_ptr(), v, d, k)
    return vals, sel


def topk_cbsr(x: torch.Tensor, k: int):
    """(vals, sel) by the kernel for a CUDA tensor, the plain version for a
    CPU tensor."""
    if x.is_cuda:
        return topk_cbsr_cuda(x, k)
    if x.device.type != "cpu":
        raise ValueError(f"topk_cbsr: no implementation for device {x.device}")
    return topk_cbsr_plain(x, k)


class TopKCBSR(torch.autograd.Function):
    """(vals, sel) = topk_cbsr(x); the backward densifies the value
    cotangent into x's dtype (role of `topk_cbsr_pallas`'s custom VJP,
    `topk_pallas.py:210-233`): kernel K2 on a CUDA tensor."""

    @staticmethod
    def forward(ctx, x, k):
        vals, sel = topk_cbsr(x, k)
        ctx.mark_non_differentiable(sel)
        ctx.save_for_backward(sel)
        ctx.x_dtype, ctx.dim = x.dtype, x.shape[1]
        return vals, sel

    @staticmethod
    def backward(ctx, g_vals, _g_sel):
        (sel,) = ctx.saved_tensors
        return densify(g_vals.to(ctx.x_dtype).contiguous(), sel, ctx.dim), None


def maxk_cbsr_fast(x: torch.Tensor, k: int):
    """The MaxK activation of the sharded path as a CBSR (f32 values,
    int32 selectors in ascending column order), differentiable in x."""
    from maxk_tpu_torch.sparse.cbsr import CBSR

    vals, sel = TopKCBSR.apply(x.contiguous(), k)
    return CBSR(values=vals, selector=sel)
