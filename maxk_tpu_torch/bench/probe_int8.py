"""int8 strip probe on the card. Port of `maxk_tpu/bench/probe_int8.py`.

    python -m maxk_tpu_torch.bench.probe_int8 [--v 233088 --s 16384 --d 256 --k 32]
    python -m maxk_tpu_torch.bench.probe_int8 --device cpu --v 2048 --s 256 --d 64

At strip-like shapes (a 0/1 strip at reddit's ≈2% density, features from
seed 123), the hub contraction Wᵀ @ x (`ops/spmm_hybrid`'s first product):

  A. the product rates: bf16 × bf16 → f32 (`torch.mm(out_dtype=float32)` on
     a card, as the op) against int8 × int8 → int32 (`torch._int_mm`), both
     operands row-major; the bf16 rate is the H100 constant of
     `sparse/hybrid.H100_MATMUL_FLOPS`
  B. the int8 strip against bf16 features, as the op takes it: converted a
     row chunk at a time into one bf16 buffer, then the product
  C. the per-column int8 quantization error of masked MaxK features (k of D
     kept per row), the lossy part of `feat_int8`
  D. `feat_int8`'s strip arm end to end: quantize, int8 product, rescale

by `micro.timeit` (CUDA events on a card). One JSON line on stdout.
"""

from __future__ import annotations

import argparse
import json
import sys


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> dict:
    import torch

    from maxk_tpu_torch.bench.micro import timeit
    from maxk_tpu_torch.ops import spmm_hybrid as sh
    from maxk_tpu_torch.sparse.cbsr import maxk_mask
    from maxk_tpu_torch.train.loop import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--v", type=int, default=233088)
    p.add_argument("--s", type=int, default=16384)
    p.add_argument("--d", type=int, default=256)
    p.add_argument("--k", type=int, default=32)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    v, s, d = args.v, args.s, args.d
    gen = torch.Generator(device=device).manual_seed(123)
    res = {"shapes": {"V": v, "S": s, "D": d},
           "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}

    w8 = (torch.rand((v, s), generator=gen, device=device) < 0.02).to(torch.int8)
    x16 = torch.randn((v, d), generator=gen, device=device).to(torch.bfloat16)
    x8 = torch.clamp(torch.round(x16.float() * 42.0), -127, 127).to(torch.int8)
    flops = 2.0 * v * s * d

    def ms(fn):
        return 1e3 * timeit(fn, iters=8)

    w16 = w8.to(torch.bfloat16)
    t16 = ms(lambda: sh._mm_f32(w16.t(), x16))
    res.update(bf16_ms=t16, bf16_tflops=flops / t16 / 1e9)
    log(f"A. bf16 Wᵀ @ x: {t16:.3f} ms  {res['bf16_tflops']:.1f} TFLOP/s")
    del w16
    x8t = x8.t().contiguous()
    t8 = ms(lambda: torch._int_mm(x8t, w8))  # (xᵀ W)ᵀ: row-major operands
    res.update(int8_ms=t8, int8_tops=flops / t8 / 1e9, int8_speedup=t16 / t8)
    log(f"A. int8 Wᵀ @ x: {t8:.3f} ms  {res['int8_tops']:.1f} TOP/s ({t16 / t8:.2f}x bf16)")

    tmix = ms(lambda: sh._strip_arms(w8, x16, x16[:s], 0)[0])
    res["int8strip_bf16x_ms"] = tmix
    log(f"B. int8 strip, converted by {sh.ROW_CHUNK}-row chunks, x bf16 (Wᵀ @ x): "
        f"{tmix:.3f} ms ({t16 / tmix:.2f}x the bf16 product)")

    xm = maxk_mask(x16.float(), args.k)
    xq, scale = sh._quant_cols(xm)
    err = (xq.float() * scale - xm).abs()
    res.update(quant_abs_err_max=float(err.max()), quant_abs_err_mean=float(err.mean()),
               signal_abs_mean=float(xm.abs().mean()))
    log(f"C. per-column int8 quantization: max_err {res['quant_abs_err_max']:.4g} "
        f"mean_err {res['quant_abs_err_mean']:.4g} signal_mean {res['signal_abs_mean']:.4g}")
    del xm, xq, err

    def strip_int8():
        q, sc = sh._quant_cols(x16)
        return torch._int_mm(q.t().contiguous(), w8).t().float() * sc

    te2e = ms(strip_int8)
    res.update(int8_e2e_ms=te2e, int8_e2e_speedup=t16 / te2e)
    log(f"D. int8 end to end (quantize, product, rescale): {te2e:.3f} ms "
        f"({t16 / te2e:.2f}x the bf16 product)")
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
