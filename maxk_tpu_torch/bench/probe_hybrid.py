"""Probe of the symmetric-strip hybrid SpMM on the card. Port of
`maxk_tpu/bench/probe_hybrid.py`.

    python -m maxk_tpu_torch.bench.probe_hybrid [--scale 1.0 --s 16384 --dtype int8
        --tail_tile 32 --tail_chunk 1024 --tail_band_cols 0 --feat_int8 --tiles]
    python -m maxk_tpu_torch.bench.probe_hybrid --device cpu --scale 0.003 --s 256

Builds the schedule of the dataset's synthetic graph (host R-MAT, seed 123,
as `load_dataset`) on the device: the degree permutation, the strip and
the tail tables, timed. Validates `spmm_hybrid` against `spmm_tiles_scan`
over the normalized permuted graph's tables (max relative error within
1e-4 for an f32 strip, 2e-2 otherwise, mean within 1e-3); `--feat_int8`
validates the lossy int8-feature arm within its quantization bound
(`int8_error_bound`). Then times, by `micro.timeit` (CUDA events on a
card): the forward, the transposed op, `--feat_int8`'s forward,
`--tiles`' `spmm_tiles_scan` over the whole graph, the tail arm alone at
each of `--tail_chunks` (with the chunk's window, then the exact one), and the
two strip products (the int8 strip converted a row chunk at a time, as the
op does). Prints one JSON line on stdout, the rest on stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


DTYPES = ("float32", "bfloat16", "int8")


def main(argv=None) -> dict:
    import torch

    from maxk_tpu_torch.bench.micro import timeit
    from maxk_tpu_torch.data.datasets import DATASETS
    from maxk_tpu_torch.data.synthetic import rmat_graph
    from maxk_tpu_torch.ops import spmm_hybrid as sh
    from maxk_tpu_torch.ops.spmm_xla import spmm_tiles_scan
    from maxk_tpu_torch.sparse import hybrid as hyb
    from maxk_tpu_torch.sparse.csr import with_norm
    from maxk_tpu_torch.sparse.meta import build_edge_tiles_device, max_block_span
    from maxk_tpu_torch.train.loop import resolve_device, synchronize

    p = argparse.ArgumentParser()
    p.add_argument("--graph", default="reddit")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--s", type=int, default=hyb.STRIP_COLS)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--dtype", default="bfloat16", choices=DTYPES)
    p.add_argument("--norm", default="right")
    p.add_argument("--validate", action="store_true", default=True)
    p.add_argument("--no-validate", dest="validate", action="store_false")
    p.add_argument("--tiles", action="store_true", help="also time tiles_scan over the graph")
    p.add_argument("--tail_tile", type=int, default=0, help="0: the strip dtype's default")
    p.add_argument("--tail_row_block", type=int, default=8)
    p.add_argument("--tail_chunk", type=int, default=hyb.TAIL_CHUNK)
    p.add_argument("--tail_chunks", type=int, nargs="+", default=[256, 1024, 4096],
                   help="tail-arm chunk sweep")
    p.add_argument("--tail_band_cols", type=int, default=0)
    p.add_argument("--feat_int8", action="store_true",
                   help="also validate and time the lossy int8-feature arm (int8 strip)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    out = {"graph": args.graph, "scale": args.scale, "dim": args.dim, "dtype": args.dtype,
           "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}

    spec = DATASETS[args.graph]
    v = max(int(spec.num_nodes * args.scale), 256)
    e = max(int(spec.num_edges * args.scale), 1024)
    t0 = time.perf_counter()
    g = rmat_graph(v, e, seed=123).to(device)
    live = int(g.indptr[-1])
    log(f"graph: V={v} E={g.nnz} live={live} ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    pg = hyb.permute_csr(g, hyb.degree_perm(g))
    synchronize(device)
    out["permute_s"] = time.perf_counter() - t0
    del g
    t0 = time.perf_counter()
    h = hyb.build_hybrid(pg, s_cols=args.s, norm=args.norm,
                         strip_dtype=getattr(torch, args.dtype), row_block=args.tail_row_block,
                         edge_tile=args.tail_tile or None, tail_chunk=args.tail_chunk,
                         tail_band_cols=args.tail_band_cols)
    synchronize(device)
    out["build_s"] = time.perf_counter() - t0
    tables = h.tail_bands or (h.tail_tiles,)
    slots = sum(t.num_tiles * t.edge_tile for t in tables)
    tail_live = sum(int((t.vals != 0).sum()) for t in tables)
    out.update(s_cols=h.s_cols, strip_bytes=h.strip.numel() * h.strip.element_size(),
               tail_tiles=sum(t.num_tiles for t in tables), tail_slots=slots,
               tail_live=tail_live, tail_share=tail_live / live, tail_window=h.tail_window,
               tail_chunk=h.tail_chunk, tail_bands=len(h.tail_bands))
    log(f"hybrid build ({out['build_s']:.1f} s): strip {tuple(h.strip.shape)} {h.strip.dtype} "
        f"({out['strip_bytes'] / 1e9:.2f} GB), tail {out['tail_tiles']} tiles, "
        f"{slots / 1e6:.1f}M slots, {tail_live / 1e6:.2f}M live = {100 * tail_live / live:.1f}% "
        f"of E, window {h.tail_window}/{h.tail_chunk}")

    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((v, args.dim), generator=gen, device=device)
    tiles = None
    if args.validate or args.tiles:
        tiles = build_edge_tiles_device(with_norm(pg, args.norm))
    if args.validate:
        ref = spmm_tiles_scan(tiles, x)
        scale = float(ref.abs().max())

        def errs(y):
            d = (y.float() - ref).abs()
            return float(d.max()) / scale, float(d.mean()) / scale

        out["max_rel"], out["mean_rel"] = errs(sh.spmm_hybrid(h, x))
        log(f"validate vs tiles_scan: max_rel {out['max_rel']:.2e}, mean_rel "
            f"{out['mean_rel']:.2e}")
        tol = 1e-4 if args.dtype == "float32" else 2e-2
        if out["mean_rel"] > 1e-3 or out["max_rel"] > tol:
            raise RuntimeError(f"spmm_hybrid differs from tiles_scan: {out}")
        if args.feat_int8:
            yq, ye = sh.spmm_hybrid(h, x, feat_int8=True), sh.spmm_hybrid(h, x)
            out["int8_max_abs"] = float((yq - ye).abs().max())
            out["int8_bound"] = sh.int8_error_bound(h, x)
            log(f"feat_int8 vs exact: max_abs {out['int8_max_abs']:.3e}, bound "
                f"{out['int8_bound']:.3e}")
            if out["int8_max_abs"] > out["int8_bound"] + 1e-5 * float(ye.abs().max()):
                raise RuntimeError(f"feat_int8 beyond its quantization bound: {out}")
            del yq, ye
        del ref

    def ms(fn, *a):
        return 1e3 * timeit(fn, *a, iters=4)

    if args.tiles:
        out["tiles_scan_ms"] = ms(lambda: spmm_tiles_scan(tiles, x))
        log(f"tiles_scan: {out['tiles_scan_ms']:.2f} ms")
    del tiles
    out["fwd_ms"] = ms(lambda: sh.spmm_hybrid(h, x))
    out["fwd_t_ms"] = ms(lambda: sh.spmm_hybrid(h, x, transpose=True))
    log(f"hybrid fwd: {out['fwd_ms']:.2f} ms ({live / out['fwd_ms'] / 1e6:.3f} Gnnz/s), "
        f"transpose {out['fwd_t_ms']:.2f} ms")
    if args.feat_int8:
        out["fwd_int8_ms"] = ms(lambda: sh.spmm_hybrid(h, x, feat_int8=True))
        log(f"hybrid fwd (feat_int8, lossy): {out['fwd_int8_ms']:.2f} ms")

    if not h.tail_bands:
        out["tail_ms"] = {}
        for chunk in args.tail_chunks:
            win = max_block_span(h.tail_tiles.block, chunk)
            for name, w in (("chunk", chunk), ("exact", win)):  # as the reference, both
                t = ms(lambda c=chunk, w_=w: spmm_tiles_scan(h.tail_tiles, x, chunk=c, window=w_))
                out["tail_ms"][f"chunk{chunk}_{name}_window{w}"] = t
                log(f"  tail arm alone (chunk {chunk}, {name} window {w}): {t:.2f} ms")

    s = h.s_cols
    xc = x.to(sh._strip_operand(h.strip))
    out["strip_arms_ms"] = ms(lambda: sh._strip_arms(h.strip, xc, xc[:s], 0))
    log(f"  strip products (Wᵀ @ x and W[S:] @ xh, {sh.ROW_CHUNK}-row chunks): "
        f"{out['strip_arms_ms']:.2f} ms")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
