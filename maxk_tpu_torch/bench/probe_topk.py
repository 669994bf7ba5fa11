"""Probe of the MaxK activation kernels on the card. Port of
`maxk_tpu/bench/probe_topk.py`.

    python -m maxk_tpu_torch.bench.probe_topk [--v 262144 --d 256 --k 32 --device cuda]

Validates, on the first 4096 rows, K4 (`topk_cbsr`) and K1 (`maxk_mask`)
against `torch.topk` densified, then times `torch.topk`, K4, K1 and K1's
forward + backward. The reference's Mosaic lane-gather probe
(`take_along_axis` in a kernel) is K8 here (`take_along_rows`): it is
checked on 256 rows at the indices 0..k-1, as the reference's probe, and on
all rows at random indices, and timed at both. A failed check exits
non-zero. Returns the times in seconds by name.
"""

from __future__ import annotations

import argparse
import sys

import torch


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> dict:
    from maxk_tpu_torch.bench.micro import rand, randint, timeit
    from maxk_tpu_torch.ops.cbsr_cuda import densify_plain
    from maxk_tpu_torch.ops.gather_cuda import take_along_rows
    from maxk_tpu_torch.ops.topk_cuda import maxk_mask, maxk_mask_fast, topk_cbsr
    from maxk_tpu_torch.train.loop import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--v", type=int, default=262144)
    p.add_argument("--d", type=int, default=256)
    p.add_argument("--k", type=int, default=32)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    v, d, k = args.v, args.d, args.k
    log(f"device={device} shape=({v},{d}) k={k}")
    x = rand((v, d), seed=0, device=device)

    # validate on a slice
    xs = x[:4096]
    vals, sel = topk_cbsr(xs, k)
    y_mask, take = maxk_mask(xs, k)
    tv, ti = torch.topk(xs, k)
    ref_dense = densify_plain(tv, ti.to(torch.int32), d)
    d1 = float((densify_plain(vals, sel, d) - ref_dense).abs().max())
    d2 = float((y_mask - ref_dense).abs().max())
    ksum = float((take.sum(1, dtype=torch.int32) - k).abs().max())
    log(f"validate: cbsr max_abs={d1:.2e} mask max_abs={d2:.2e} mask-k-exact={ksum:.1e}")
    if d1 > 1e-5 or d2 > 1e-5 or ksum > 0:
        raise SystemExit("probe_topk: VALIDATION FAILED")

    # K8, the lane-gather probe: indices 0..k-1 on 256 rows, and random ones
    rb = min(256, v)
    x_rb = x[:rb].contiguous()
    idx_rb = torch.arange(k, device=device, dtype=torch.int32).repeat(rb, 1)
    idx_all = randint((v, k), d, seed=2, device=device)
    ok_rb = torch.equal(take_along_rows(x_rb, idx_rb), x_rb[:, :k])
    ok_all = torch.equal(take_along_rows(x, idx_all), torch.gather(x, 1, idx_all.long()))
    log(f"K8 take_along_rows: ({rb},{d}) at 0..{k - 1} exact={ok_rb}; "
        f"({v},{d}) at random indices exact={ok_all}")
    if not (ok_rb and ok_all):
        raise SystemExit("probe_topk: K8 VALIDATION FAILED")

    def mask_fwd_bwd(xx):
        xr = xx.detach().requires_grad_(True)
        (maxk_mask_fast(xr, k) ** 2).sum().backward()
        return xr.grad

    t = {
        "torch_topk": timeit(lambda xx: torch.topk(xx, k).values, x),
        "topk_cbsr": timeit(lambda xx: topk_cbsr(xx, k)[0], x),
        "maxk_mask": timeit(lambda xx: maxk_mask(xx, k)[0], x),
        "mask_fwd_bwd": timeit(mask_fwd_bwd, x),
        "take_along_rows_256": timeit(take_along_rows, x_rb, idx_rb),
        "take_along_rows_all": timeit(take_along_rows, x, idx_all),
    }
    for name, s in t.items():
        log(f"{name + ':':22s}{s*1e3:.4f} ms")
    return t


if __name__ == "__main__":
    main()
