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
place of the time).
Returns the numbers by name. `probe(g, sched, ...)` does the same on a
graph and schedule already built. `--tiles` (the edge-tile arm) is not
ported: ROADMAP A12.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def probe(g, sched, dim: int = 256, dtype: str = "float32", validate: bool = True) -> dict:
    """Validate and time K5 on `sched`, the brick schedule of `g`, at D = `dim`.
    Both lie on the device the probe runs on."""
    from maxk_tpu_torch.bench.micro import rand, timeit
    from maxk_tpu_torch.ops.spmm_bricks import spmm_bricks, spmm_bricks_plain
    from maxk_tpu_torch.ops.spmm_xla import spmm_segsum
    from maxk_tpu_torch.sparse.bricks import bricks_stats

    v, device = g.num_nodes, g.indptr.device
    st = bricks_stats(sched)
    log(f"schedule: {st}")
    dt = getattr(torch, dtype)
    x = rand((v, dim), dt, seed=0, device=device)
    y = spmm_bricks(sched, x)
    out = {"stats": st, "dtype": dtype}
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
    flop = st["flush_tflop"] * 1e12 * dim / 256
    t = timeit(spmm_bricks, sched, x)
    log(f"bricks: {t*1e3:.4f} ms  {live/t/1e9:.3f} Gnnz/s  (flush {flop/1e12:.3f} TFLOP "
        f"-> {flop/t/1e12:.2f} TFLOP/s)")
    t_seg = timeit(spmm_segsum, g, x)
    log(f"spmm_segsum: {t_seg*1e3:.4f} ms  {live/t_seg/1e9:.3f} Gnnz/s")
    t_plain = timeit(spmm_bricks_plain, sched, x, iters=4)
    log(f"plain version: {t_plain*1e3:.4f} ms")
    out.update(bricks_s=t, segsum_s=t_seg, plain_s=t_plain, library_s=None)
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
    p.add_argument("--tiles", action="store_true", help="edge-tile arm (not ported)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.tiles:
        raise NotImplementedError("probe_bricks --tiles: the edge-tile SpMM is not ported yet "
                                  "(ROADMAP A12)")
    device = resolve_device(args.device)

    t0 = time.perf_counter()
    g = rmat_graph(args.v, args.e, seed=123)
    log(f"graph: V={args.v} E={g.nnz} ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    sched = build_bricks(g)
    log(f"schedule: {time.perf_counter() - t0:.1f} s")
    return probe(g.to(device), sched.to(device), args.dim, args.dtype, args.validate)


if __name__ == "__main__":
    main()
