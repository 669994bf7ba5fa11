"""Microbenchmarks of the gather and scatter primitives under the SpMM.

Port of `maxk_tpu/bench/micro.py`:

  A. plain row gather from device memory (`index_select`)
  B. K6: gather from a slab held in L2 (`csrc/gather.cu`)
  C. K7: row gather from device memory, a thread per 16-byte chunk (`csrc/gather.cu`)
  D. gather as a one-hot matrix product (bf16)
  E. `torch.topk` against a full sort (the MaxK selection's role)
  F. segment-sum scatter rate (`index_add_`, the backward's role)

    python -m maxk_tpu_torch.bench.micro [--device cuda]

Inputs are made on the device from seeds. `timeit` times on the card by
CUDA events, and on the host clock when the work runs on the CPU.
Not ported: the reference's tunnel round-trip correction
(`roundtrip_latency`), its queued-call budget (`_QUEUED_OUT_BYTES`) and
the four Mosaic lowerings of K6 (one kernel here computes that function).
"""

from __future__ import annotations

import argparse
import time

import torch

from maxk_tpu_torch.ops.gather_cuda import dma_gather, slab_gather

# the H100 SXM's published rates (NVIDIA's data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # CUDA cores; bf16 tensor cores


def bound(nbytes: float, flops: float = 0.0, dtype: str = "float32") -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of `dtype`."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def in_row_gather_bound(sel: torch.Tensor, dim: int, isz: int) -> dict:
    """The bound of out[r, j] = z[r, sel[r, j]] on (V, k) int32 selectors
    into a (V, dim) table of `isz`-byte elements: selectors read and (V, k)
    written once, plus the distinct elements the selectors touch
    (`bound_ms`); or plus the distinct 32-byte sectors they touch, the unit
    a cache moves (`sector_bound_ms`), or the distinct 64-byte granules
    (`granule_bound_ms`). A row starts on a sector (granule) where dim·isz
    is a multiple of 32 (64). Counted on the selectors' device."""
    v, k = sel.shape
    flat = sel.long() + dim * torch.arange(v, device=sel.device)[:, None]
    fixed = v * k * (4 + isz)

    def distinct(unit: int) -> int:
        return int((flat * isz // unit).unique().numel())

    return {**bound(fixed + distinct(isz) * isz),
            "sector_bound_ms": bound(fixed + distinct(32) * 32)["bound_ms"],
            "granule_bound_ms": bound(fixed + distinct(64) * 64)["bound_ms"]}


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)


def timeit(fn, *args, iters: int = 16, warmup: int = 2) -> float:
    """Seconds per call of `fn(*args)`, the mean of `iters` calls after
    `warmup` calls: by CUDA events when its inputs or outputs lie on a
    card, else by the host clock."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    if any(t.is_cuda for t in _tensors((args, out))):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters


def _gen(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def rand(shape, dtype=torch.float32, seed=0, device="cuda"):
    return torch.randn(shape, generator=_gen(device, seed), device=device).to(dtype)


def randint(shape, hi, seed=1, device="cuda"):
    return torch.randint(0, hi, shape, generator=_gen(device, seed), device=device,
                         dtype=torch.int32)


def _name(dtype) -> str:
    return str(dtype).split(".")[-1]


def bench_plain_gather(v=262144, d=256, e=4_000_000, dtype=torch.float32, device="cuda"):
    x = rand((v, d), dtype, device=device)
    idx = randint((e,), v, device=device)
    # a reduction keeps the gathered rows live, as the reference's .max(0)
    t = timeit(lambda x, i: x.index_select(0, i).amax(0), x, idx)
    print(f"A. plain gather (V={v}, D={d}, E={e}, {_name(dtype)}): {t*1e3:.4f} ms  "
          f"{e/t/1e9:.3f} Grow/s  {e*d*x.element_size()/t/1e9:.1f} GB/s", flush=True)
    return t


def bench_slab_gather(s=2048, d=256, n=1 << 20, dtype=torch.float32, device="cuda"):
    """K6: rows of an (s, d) slab by n random indices."""
    slab = rand((s, d), dtype, device=device)
    idx = randint((n,), s, device=device)
    t = timeit(slab_gather, slab, idx)
    print(f"B. K6 L2 slab gather (S={s}, D={d}, N={n}, {_name(dtype)}): "
          f"{t*1e3:.4f} ms  {n/t/1e9:.3f} Grow/s  {n*d*slab.element_size()/t/1e9:.1f} GB/s",
          flush=True)
    return t


def bench_dma_gather(v=262144, d=256, n=1 << 18, dtype=torch.float32, device="cuda"):
    """K7: n random rows of a (v, d) table in device memory."""
    x = rand((v, d), dtype, device=device)
    idx = randint((n,), v, device=device)
    t = timeit(dma_gather, x, idx)
    print(f"C. K7 row gather (V={v}, D={d}, N={n}, {_name(dtype)}): "
          f"{t*1e3:.4f} ms  {n/t/1e9:.3f} Grow/s  {n*d*x.element_size()/t/1e9:.1f} GB/s",
          flush=True)
    return t


def bench_onehot_gather(s=512, d=256, n=1 << 20, dtype=torch.bfloat16, device="cuda",
                        block=1 << 16):
    """Gather as (one-hot of the indices) @ slab, `block` indices a product."""
    slab = rand((s, d), dtype, device=device)
    idx = randint((n,), s, device=device)
    cols = torch.arange(s, device=device, dtype=torch.int32)

    def f(idx, slab):
        parts = [
            ((idx[i:i + block, None] == cols).to(dtype) @ slab).amax(0)
            for i in range(0, n, block)
        ]
        return torch.stack(parts).amax(0)

    t = timeit(f, idx, slab)
    print(f"D. one-hot matmul gather (S={s}, D={d}, N={n}, {_name(dtype)}): {t*1e3:.4f} ms  "
          f"{n/t/1e9:.3f} Grow/s", flush=True)
    return t


def bench_topk(v=262144, d=256, k=32, device="cuda"):
    x = rand((v, d), device=device)
    t = timeit(lambda x: torch.topk(x, k).values.amax(0), x)
    print(f"E. torch.topk (V={v}, D={d}, k={k}): {t*1e3:.4f} ms  {v/t/1e6:.1f} Mrow/s",
          flush=True)
    t_sort = timeit(lambda x: torch.sort(x, dim=-1).values.amax(0), x)
    print(f"   full sort baseline: {t_sort*1e3:.4f} ms", flush=True)
    return t


def bench_segment_sum(v=262144, d=256, e=4_000_000, device="cuda"):
    data = rand((e, d), device=device)
    seg = randint((e,), v, device=device).sort().values
    t = timeit(
        lambda x, s: torch.zeros((v, d), device=device).index_add_(0, s, x).amax(0), data, seg
    )
    print(f"F. segment sum, index_add_ (E={e}, D={d}): {t*1e3:.4f} ms  "
          f"{e/t/1e9:.3f} Grow/s", flush=True)
    return t


def main(argv=None) -> dict:
    """Run A-F at the reference's sizes; seconds per call by name."""
    from maxk_tpu_torch.train.loop import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    device = resolve_device(p.parse_args(argv).device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {device} ({name})", flush=True)
    bf16 = torch.bfloat16
    return {
        "plain_gather_f32": bench_plain_gather(device=device),
        "plain_gather_bf16": bench_plain_gather(dtype=bf16, device=device),
        "slab_gather_s2048_f32": bench_slab_gather(device=device),
        "slab_gather_s2048_bf16": bench_slab_gather(dtype=bf16, device=device),
        "slab_gather_s8192_f32": bench_slab_gather(s=8192, device=device),
        "dma_gather_f32": bench_dma_gather(device=device),
        "onehot_gather_s512": bench_onehot_gather(device=device),
        "onehot_gather_s2048": bench_onehot_gather(s=2048, device=device),
        "topk": bench_topk(device=device),
        "segment_sum": bench_segment_sum(device=device),
    }


if __name__ == "__main__":
    main()
