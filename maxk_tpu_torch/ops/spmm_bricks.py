"""Brick SpMM: Y = A @ X over a `BrickSchedule` (`sparse/bricks.py`).

Port of `maxk_tpu/ops/spmm_bricks.py`. The TPU kernel `_brick_kernel`
(`spmm_bricks.py:37`, launched by `_spmm_bricks_raw` :106-156) becomes the
CUDA kernel in `csrc/spmm_bricks.cu`; `spmm_bricks_plain` is the same
function in plain PyTorch. Both walk the schedule's subtiles with the
kernel's semantics: `first` starts a brick, each slot adds its value at
(lr, lc), `end` adds brick @ X[window] into the brick's output rows. The
plain version is not a CSR SpMM, so that a fault in the schedule shows in
both. A slot outside the brick, or a flush outside its supergroup or
panel, adds nothing; X rows past V read as zero.

Precision, as `spmm_bricks.py:115-120,96`: f32 x runs full f32 products;
bf16 x rounds the brick to bf16 before its product, with f32
accumulation. The output is x's dtype, cut to `num_nodes` rows.

The kernel does work that scales with the live slots, not the TPU
kernel's dense flush per brick: a block keeps an f32 Y tile of WB rows ×
DC columns (DC = 128, halved while the tile exceeds 64 KB: 32 at WB =
512) in shared memory, beside the warps' item rings and, for bf16, two
bitmaps of WB × WIN bits per warp; the kernel's source reports the bytes
(`spmm_bricks_smem_bytes`). The wrapper refuses a schedule that needs more
shared memory than a block has, WB above 512 or
WIN above 128 (lr and lc pack into 7 + N bits), slot counts that are not
a multiple of 4 and schedule arrays that are not 16-byte aligned (the
kernel reads 4 slots at once).

`spmm_bricks` runs the kernel for CUDA tensors and the plain version for
CPU tensors. No training path dispatches here (`kernel_mode="pallas"`
raises, as in the reference); `bench/probe_bricks.py` drives it.
"""

from __future__ import annotations

import ctypes

import torch

from maxk_tpu_torch.ops import _native
from maxk_tpu_torch.sparse.bricks import BrickSchedule

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# flushes per batched product in the plain version: bounds its (n, WIN, D)
# window copies
_FLUSH_BATCH = 4096


def _check_x(name: str, sched: BrickSchedule, x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[0] != sched.num_cols:
        raise ValueError(
            f"{name}: x {tuple(x.shape)} must be (num_cols={sched.num_cols}, D)"
        )


def spmm_bricks_plain(sched: BrickSchedule, x: torch.Tensor) -> torch.Tensor:
    _check_x("spmm_bricks_plain", sched, x)
    dev, d = x.device, x.shape[1]
    wb, win, ch, t = sched.wb, sched.win, sched.ch, sched.slots
    acc = torch.promote_types(x.dtype, torch.float32)
    meta = sched.meta.reshape(-1).to(torch.int64)
    n_sub = meta.numel()
    sub_chunk = torch.arange(n_sub, device=dev) // ch
    cs = sched.chunk_sgroup.to(torch.int64)
    first = (meta >> 9) & 1
    end = (meta >> 10) & 1
    # a supergroup's first subtile starts from a zero brick, as a block of
    # the kernel does
    sg_start = torch.zeros_like(first)
    sg_start[::ch][torch.cat([cs.new_ones(1, dtype=torch.bool), cs[1:] != cs[:-1]])] = 1
    inst = torch.cumsum(first | sg_start, 0) - 1  # the brick each subtile adds to
    flush_at = torch.nonzero(end).squeeze(1)  # subtile of each flush
    nf = flush_at.numel()
    y = torch.zeros((sched.num_sgroups * sched.sg, d), dtype=acc, device=dev)
    if nf:
        # a subtile feeds the next flush, if that flush closes its brick
        seg = torch.cumsum(end, 0) - end
        segc = seg.clamp(max=nf - 1)
        live = (inst >= 0) & (seg < nf) & (inst[flush_at[segc]] == inst)
        idx = sched.idx.reshape(n_sub, t).to(torch.int64)
        lr, lc = idx >> 7, idx & 0x7F
        ok = live[:, None] & (lr < wb) & (lc < win)
        flat = (segc[:, None] * wb + lr) * win + lc
        bricks = torch.zeros(nf * wb * win, dtype=torch.float32, device=dev)
        bricks.index_add_(0, flat[ok], sched.val.reshape(n_sub, t)[ok])
        bricks = bricks.view(nf, wb, win)
        # a brick that ends twice flushes all it holds each time
        fi = inst[flush_at]
        rank = torch.arange(nf, device=dev) - torch.searchsorted(fi, fi)
        for r in range(1, int(rank.max()) + 1):
            at = torch.nonzero(rank == r).squeeze(1)
            bricks[at] += bricks[at - 1]

        m = meta[flush_at]
        rb, w = (m >> 6) & 7, m & 0x3F
        chunk = sub_chunk[flush_at]
        keep = (rb * wb < sched.sg) & (w * win < sched.panel)
        x0 = sched.chunk_panel.to(torch.int64)[chunk] * sched.panel + w * win
        y0 = cs[chunk] * sched.sg + rb * wb
        xp = torch.cat([x, x.new_zeros((sched.num_panels * sched.panel - x.shape[0], d))])
        win_ar = torch.arange(win, device=dev)
        rows_ar = torch.arange(wb, device=dev)
        for f0 in range(0, nf, _FLUSH_BATCH):
            sl = slice(f0, f0 + _FLUSH_BATCH)
            k = keep[sl]
            b = bricks[sl][k]
            if x.dtype == torch.bfloat16:
                b = b.to(torch.bfloat16)
            xw = xp[x0[sl][k, None] + win_ar]  # (n, WIN, D)
            out = torch.bmm(b.to(acc), xw.to(acc))
            y.index_add_(0, (y0[sl][k, None] + rows_ar).reshape(-1), out.reshape(-1, d))
    return y[: sched.num_nodes].to(x.dtype)


def _check_schedule(sched: BrickSchedule, device) -> None:
    for name, dtype in (("chunk_panel", torch.int32), ("chunk_sgroup", torch.int32),
                        ("meta", torch.int32), ("idx", torch.int32), ("val", torch.float32)):
        a = getattr(sched, name)
        if a.dtype != dtype or a.device != device or not a.is_contiguous():
            raise ValueError(
                f"spmm_bricks: schedule {name} must be contiguous {dtype} on {device}, "
                f"got {a.dtype} on {a.device}"
            )


def _smem_bytes(wb: int, win: int, dtype: torch.dtype) -> tuple[int, int]:
    """The shared memory a block of the kernel needs for wb × win bricks in
    `dtype`, and the most a block may have, as the kernel's source gives
    them (`spmm_bricks_smem_bytes`)."""
    need, limit = ctypes.c_int(0), ctypes.c_int(0)
    _native.library().spmm_bricks_smem_bytes(wb, win, int(dtype == torch.bfloat16),
                                             ctypes.byref(need), ctypes.byref(limit))
    return need.value, limit.value


def spmm_bricks_cuda(sched: BrickSchedule, x: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel. Counts its launches in `spmm_bricks_cuda.launches`."""
    _native.check("spmm_bricks", x, KERNEL_DTYPES)
    _check_x("spmm_bricks", sched, x)
    _check_schedule(sched, x.device)
    v, d = x.shape
    if not (1 <= sched.wb <= 512 and 1 <= sched.win <= 128):
        raise ValueError(f"spmm_bricks: wb={sched.wb} must be in [1, 512], win={sched.win} "
                         "in [1, 128]")
    if sched.slots % 4 or any(getattr(sched, a).data_ptr() % 16 for a in ("idx", "val")):
        raise ValueError(f"spmm_bricks: {sched.slots} slots a subtile must be a multiple of 4 "
                         "and idx, val 16-byte aligned")
    smem, limit = _smem_bytes(sched.wb, sched.win, x.dtype)
    if smem > limit:
        raise ValueError(
            f"spmm_bricks: wb={sched.wb}, win={sched.win} in {x.dtype} need {smem} B of "
            f"shared memory, more than {limit}"
        )
    y = torch.empty((sched.num_nodes, d), dtype=x.dtype, device=x.device)
    if sched.num_nodes == 0 or d == 0:
        return y
    name = "spmm_bricks_f32" if x.dtype == torch.float32 else "spmm_bricks_bf16"
    _native.launch(
        name, sched.chunk_panel.data_ptr(), sched.chunk_sgroup.data_ptr(),
        sched.meta.data_ptr(), sched.idx.data_ptr(), sched.val.data_ptr(), x.data_ptr(),
        y.data_ptr(), sched.num_chunks, sched.ch, sched.slots, sched.num_sgroups, sched.sg,
        sched.panel, sched.wb, sched.win, sched.num_nodes, v, d,
    )
    spmm_bricks_cuda.launches += 1
    return y


spmm_bricks_cuda.launches = 0


def spmm_bricks(sched: BrickSchedule, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ x, f32 accumulation, in x's dtype: the kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if x.is_cuda:
        return spmm_bricks_cuda(sched, x)
    if x.device.type != "cpu":
        raise ValueError(f"spmm_bricks: no implementation for device {x.device}")
    return spmm_bricks_plain(sched, x)
