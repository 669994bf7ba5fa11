"""CBSR expansion (densify) and sampling: maxk_spgemm's forward and backward.

Port of `maxk_tpu/ops/cbsr_pallas.py`. The TPU kernels `_densify_kernel`
(`cbsr_pallas.py:42`) and `_sample_kernel` (:52) become the CUDA kernels
in `csrc/cbsr.cu`; `densify_plain` and `sample_plain` are the same
functions in plain PyTorch.

  densify: out[r, sel[r,l]] += vals[r,l]   (V,k) → (V,D); duplicates add,
           a selector outside [0, D) adds nothing
  sample:  out[r, l] = z[r, sel[r,l]]      (V,D) → (V,k); outside [0, D) → 0

Each is the other's backward (`Densify`, `Sample`), as in
`cbsr_pallas.py:107-143`. The wrappers `densify` and `sample` run the
kernel for CUDA tensors and the plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from maxk_tpu_torch.ops import _native

KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def densify_plain(vals: torch.Tensor, sel: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum in f32 (f64 for f64 values), rounded once to the values' dtype."""
    valid = (sel >= 0) & (sel < dim)
    idx = torch.where(valid, sel, 0).to(torch.int64)
    src = torch.where(valid, vals.to(_acc_dtype(vals.dtype)), 0)
    out = torch.zeros(
        (vals.shape[0], dim), dtype=src.dtype, device=vals.device
    )
    return out.scatter_add_(1, idx, src).to(vals.dtype)


def sample_plain(z: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    valid = (sel >= 0) & (sel < z.shape[1])
    idx = torch.where(valid, sel, 0).to(torch.int64)
    return torch.where(valid, torch.gather(z, 1, idx), torch.zeros((), dtype=z.dtype))


def _check_sel(name: str, sel: torch.Tensor, t: torch.Tensor) -> int:
    """Check the selectors of the (rows, ·) tensor `t`; return their k."""
    _native.check(name, sel, (torch.int32,))
    rows = t.shape[0]
    if sel.shape[0] != rows or sel.get_device() != t.get_device():
        raise ValueError(
            f"{name}: selector {tuple(sel.shape)} on {sel.device} does not "
            f"match {rows} rows on {t.device}"
        )
    return sel.shape[1]


def densify_cuda(vals: torch.Tensor, sel: torch.Tensor, dim: int) -> torch.Tensor:
    """The CUDA densify kernel. Counts its launches in `telemetry.launches["cbsr_densify"]`."""
    _native.check("cbsr_densify", vals, KERNEL_DTYPES)
    v, k = vals.shape
    if _check_sel("cbsr_densify", sel, vals) != k:
        raise ValueError(f"cbsr_densify: values {tuple(vals.shape)} vs selector {tuple(sel.shape)}")
    if not 1 <= k <= 4096 or dim < 1:
        raise ValueError(f"cbsr_densify: k={k} must be in [1, 4096], dim={dim} >= 1")
    out = vals.new_empty((v, dim))
    if v == 0:
        return out
    name = "cbsr_densify_f32" if vals.dtype == torch.float32 else "cbsr_densify_bf16"
    _native.launch("cbsr_densify", name, vals, vals.data_ptr(), sel.data_ptr(), out.data_ptr(), v, k,
                   dim)
    return out


def sample_cuda(z: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """The CUDA sample kernel. Counts its launches in `telemetry.launches["cbsr_sample"]`."""
    _native.check("cbsr_sample", z, KERNEL_DTYPES)
    v, d = z.shape
    k = _check_sel("cbsr_sample", sel, z)
    out = z.new_empty((v, k))
    if v == 0 or k == 0:
        return out
    name = "cbsr_sample_f32" if z.dtype == torch.float32 else "cbsr_sample_bf16"
    _native.launch("cbsr_sample", name, z, z.data_ptr(), sel.data_ptr(), out.data_ptr(), v, k, d)
    return out


def _on_cpu(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cpu":
        raise ValueError(f"{name}: no implementation for device {t.device}")


def densify(vals: torch.Tensor, sel: torch.Tensor, dim: int) -> torch.Tensor:
    if vals.is_cuda:
        return densify_cuda(vals, sel, dim)
    _on_cpu("cbsr_densify", vals)
    return densify_plain(vals, sel, dim)


def sample(z: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    if z.is_cuda:
        return sample_cuda(z, sel)
    _on_cpu("cbsr_sample", z)
    return sample_plain(z, sel)


class Densify(torch.autograd.Function):
    """densify with sample as its backward."""

    @staticmethod
    def forward(ctx, vals, sel, dim):
        ctx.save_for_backward(sel)
        return densify(vals, sel, dim)

    @staticmethod
    def backward(ctx, g):
        (sel,) = ctx.saved_tensors
        return sample(g.contiguous(), sel), None, None


class Sample(torch.autograd.Function):
    """sample with densify as its backward."""

    @staticmethod
    def forward(ctx, z, sel):
        ctx.save_for_backward(sel)
        ctx.dim = z.shape[1]
        return sample(z, sel)

    @staticmethod
    def backward(ctx, g):
        (sel,) = ctx.saved_tensors
        return densify(g.contiguous(), sel, ctx.dim), None
