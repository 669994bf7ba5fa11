"""Probe of the brick SpMM (K5) on the card. Port of `maxk_tpu/bench/probe_bricks.py`.

    python -m maxk_tpu_torch.bench.probe_bricks [--v 32768 --e 1000000 --dim 256
                                                 --dtype float32 --device cuda]

Builds the default brick schedule of an R-MAT graph (the port's host
`rmat_graph(v, e, seed=123)`; the reference draws its instance on the
device), runs `spmm_bricks`, and validates it against `spmm_segsum` with
the reference's criterion: relative to max|ref|, mean error <= 1e-4 and
max error <= 1e-5 (float32) or 2e-2 (bfloat16); a failure exits non-zero.
Then times the kernel, its plain version, `spmm_segsum` and the library
call `torch.sparse.mm` on a CSR tensor with values in the features' dtype
(where the library has no kernel for that dtype, its error is returned in
place of the time). The kernel's line gives the rate of the product's
2·nnz·D operations and its time as a share of the function's bound (the
CSR and X read once, Y written once, at the H100's published rates); the
schedule line gives the heaviest kernel block's share of the live slots.
Returns the numbers by name. `probe(g, sched, ...)` does the same on a
graph and schedule already built. `--tiles` adds the edge-tile arm
(`probe_tiles`): `spmm_tiles_scan` over the tables of
`build_edge_tiles_device`, held against `spmm_segsum` and timed beside the
brick kernel.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def heaviest_block_share(sched) -> float:
    """The largest share of the live slots that one block of the kernel
    (a supergroup × row brick; its column slices each read the same slots)
    takes."""
    n_sub = sched.meta.numel()
    rb = (sched.meta.reshape(-1).long() >> 6) & 7
    block = sched.chunk_sgroup.long().repeat_interleave(sched.ch) * 8 + rb
    live = (sched.val.reshape(n_sub, -1) != 0).sum(1)
    per_block = torch.zeros(sched.num_sgroups * 8, dtype=live.dtype, device=live.device)
    per_block.index_add_(0, block, live)
    return float(per_block.max()) / max(float(live.sum()), 1.0)


def function_bound(v: int, nnz: int, dim: int, dtype: str) -> dict:
    """The least time the card could take for Y = A @ X (`micro.bound`):
    the CSR (row pointers, column indices, f32 values) and X read once, Y
    written once, 2·nnz·D operations at the dtype's peak."""
    from maxk_tpu_torch.bench.micro import bound

    isz = 4 if dtype == "float32" else 2
    return bound((v + 1) * 4 + nnz * 8 + 2 * v * dim * isz, 2 * nnz * dim, dtype)


def probe(g, sched, dim: int = 256, dtype: str = "float32", validate: bool = True) -> dict:
    """Validate and time K5 on `sched`, the brick schedule of `g`, at D = `dim`.
    Both lie on the device the probe runs on."""
    from maxk_tpu_torch.bench.micro import rand, timeit
    from maxk_tpu_torch.ops.spmm_bricks import spmm_bricks, spmm_bricks_plain
    from maxk_tpu_torch.ops.spmm_xla import spmm_segsum
    from maxk_tpu_torch.sparse.bricks import bricks_stats

    v, device = g.num_nodes, g.indptr.device
    st = bricks_stats(sched)
    share = heaviest_block_share(sched)
    log(f"schedule: {st}; heaviest block {share:.4f} of the live slots "
        "(flush_tflop: the reference's dense flush count)")
    dt = getattr(torch, dtype)
    x = rand((v, dim), dt, seed=0, device=device)
    y = spmm_bricks(sched, x)
    out = {"stats": st, "dtype": dtype, "heaviest_block_share": share}
    if validate:
        ref = spmm_segsum(g, x.float())
        err = (y.float() - ref).abs()
        scale = max(float(ref.abs().max()), 1e-6)
        mx, mn = float(err.max()), float(err.mean())
        del ref, err
        max_tol = 1e-5 if dtype == "float32" else 2e-2
        log(f"validate: max_abs={mx:.3e} mean_abs={mn:.3e} ref_scale={scale:.3e}"
            f"  (max_rel {mx/scale:.2e}, mean_rel {mn/scale:.2e}; bounds {max_tol:g}, 1e-4)")
        out.update(max_abs=mx, mean_abs=mn, ref_scale=scale, max_rel_tol=max_tol)
        if mn / scale > 1e-4 or mx / scale > max_tol:
            raise SystemExit("probe_bricks: VALIDATION FAILED")

    live = g.nnz
    flop = 2 * live * dim  # the product's operations
    b = function_bound(v, live, dim, dtype)
    t = timeit(spmm_bricks, sched, x)
    log(f"bricks: {t*1e3:.4f} ms  {live/t/1e9:.3f} Gnnz/s  ({flop/1e9:.3f} GFLOP of 2·nnz·D "
        f"-> {flop/t/1e12:.3f} TFLOP/s; bound {b['bound_ms']:.4f} ms by {b['bound_by']}, "
        f"{b['bound_ms']/(t*1e3):.4f} of it)")
    t_seg = timeit(spmm_segsum, g, x)
    log(f"spmm_segsum: {t_seg*1e3:.4f} ms  {live/t_seg/1e9:.3f} Gnnz/s")
    t_plain = timeit(spmm_bricks_plain, sched, x, iters=4)
    log(f"plain version: {t_plain*1e3:.4f} ms")
    out.update(bricks_s=t, segsum_s=t_seg, plain_s=t_plain, library_s=None,
               product_tflop_per_s=flop / t / 1e12, bound_share=b["bound_ms"] / (t * 1e3), **b)
    a = torch.sparse_csr_tensor(g.indptr.long(), g.indices.long(), g.values.to(dt), (v, v),
                                check_invariants=True)
    try:
        t_lib = timeit(torch.sparse.mm, a, x)
    except NotImplementedError as e:  # the library's gap, not the kernel's
        out["library_error"] = str(e)
        log(f"torch.sparse.mm (CSR, {dtype}): {e}")
    else:
        log(f"torch.sparse.mm (CSR, {dtype}): {t_lib*1e3:.4f} ms  {live/t_lib/1e9:.3f} Gnnz/s")
        out["library_s"] = t_lib
    return out


def probe_tiles(g, dim: int = 256, dtype: str = "float32", bricks_s: float = 0.0) -> dict:
    """`spmm_tiles_scan` over the edge tiles of `g` built on its device, on
    the probe's features: its error against `spmm_segsum` relative to
    max|ref|, the tables' build time on the host clock, and its time
    beside the brick kernel's `bricks_s`."""
    from maxk_tpu_torch.bench.micro import rand, timeit
    from maxk_tpu_torch.ops.spmm_xla import spmm_segsum, spmm_tiles_scan
    from maxk_tpu_torch.sparse.meta import build_edge_tiles_device

    t0 = time.perf_counter()
    tiles = build_edge_tiles_device(g)
    if g.indptr.is_cuda:
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    x = rand((g.num_nodes, dim), getattr(torch, dtype), seed=0, device=g.indptr.device)
    ref = spmm_segsum(g, x.float())
    err = float((spmm_tiles_scan(tiles, x).float() - ref).abs().max()) / max(
        float(ref.abs().max()), 1e-6)
    del ref
    tt = timeit(spmm_tiles_scan, tiles, x)
    log(f"tiles_scan: {tt*1e3:.4f} ms  {g.nnz/tt/1e9:.3f} Gnnz/s  "
        f"({tt/bricks_s:.1f}x the bricks' time; {tiles.num_tiles} tiles built in {build_s:.3f} s, "
        f"max_rel vs segsum {err:.2e})")
    return {"tiles_scan_s": tt, "tiles_build_s": build_s, "tiles_num": tiles.num_tiles,
            "tiles_max_rel": err}


def main(argv=None) -> dict:
    from maxk_tpu_torch.data.synthetic import rmat_graph
    from maxk_tpu_torch.sparse.bricks import build_bricks
    from maxk_tpu_torch.train.loop import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--v", type=int, default=32768)
    p.add_argument("--e", type=int, default=1_000_000)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--validate", action="store_true", default=True)
    p.add_argument("--no-validate", dest="validate", action="store_false")
    p.add_argument("--tiles", action="store_true", help="add the edge-tile arm (tiles_scan)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    t0 = time.perf_counter()
    g = rmat_graph(args.v, args.e, seed=123)
    log(f"graph: V={args.v} E={g.nnz} ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    sched = build_bricks(g)
    log(f"schedule: {time.perf_counter() - t0:.1f} s")
    g = g.to(device)
    out = probe(g, sched.to(device), args.dim, args.dtype, args.validate)
    if args.tiles:
        out.update(probe_tiles(g, args.dim, args.dtype, out["bricks_s"]))
    return out


if __name__ == "__main__":
    main()
