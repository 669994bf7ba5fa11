"""Kernel benchmark suite, on the card. Port of `maxk_tpu/bench/kernel_bench.py`.

    python -m maxk_tpu_torch.bench.kernel_bench                 # default suite
    python -m maxk_tpu_torch.bench.kernel_bench --graphs reddit flickr --k 16 32
    python -m maxk_tpu_torch.bench.kernel_bench --validate      # oracle check
    python -m maxk_tpu_torch.bench.kernel_bench --dir DIR       # real binaries
    python -m maxk_tpu_torch.bench.kernel_bench --device cpu --scale 0.002 ...

Every graph × k ∈ {16, 32, 64}, as the reference protocol
(`kernels/main.cu`): the dense baseline in f32 and bf16 (the cuSPARSE
role), then per k the production masked arm (K1, then the SpMM on the
masked bf16 features, forward and forward + backward) and the CBSR arm
(`maxk_spgemm`, forward and forward + backward). Prints the reference's
text lines (`n graph dim k kernel ms`) on stdout and returns the records,
also written to `--json_out`; each record carries the same keys as the
reference's, `cbsr_val_dtype` included. `--validate` holds `maxk_spgemm`
against the plain path (plain densify + segment-sum SpMM) per k.

Graphs: `--dir` loads `<name>.indptr/.indices` binaries; otherwise the
port's host R-MAT at the dataset's size × `--scale` (the reference draws
its instance on the device). `auto` resolves per graph as the training
loop's AUTO (`sparse/hybrid.auto_hybrid`, with the strip dtype given): the
strip hybrid on a card where it pays, else segsum; `--mode
tiles_xla|tiles_scan` runs the edge-tile SpMMs over tables built on the
device; `--mode hybrid|hybrid_int8` the strip hybrid over the degree-
permuted graph, the strip built after the baseline arms (`--strip_dtype
auto|bfloat16|int8`, auto: int8 where exact; width by `auto_strip_cols` at
the card's rates; `--tail_band_cols`, -1: `auto_tail_band_cols`). The
baseline (library) arm is `tiles_scan` on a card, as the reference's is
off the CPU, unless the mode is segsum, and segsum on the CPU. A hybrid
record adds `strip_dtype`, `strip_cols`, `tail_band_cols` and `feat_int8`
(true under hybrid_int8); its validation takes `hybrid_int8`'s lossy
bound (`ops/spmm_hybrid.int8_error_bound`) on top of the exact tolerance,
and says so in `validation`. `--dispatch_check` also times the forward of
the arm AUTO did not pick (segsum against the hybrid), once per graph.

The yardstick: every record also carries `t_cusparse_ms` and
`t_cusparse_bf16_ms`, one `torch.sparse.mm` on a CSR tensor of the same
normalized graph against the same `x_dense` (cuSPARSE on a card, the role
of the reference suite's `kernels/spmm_cusparse.cu`), and
`speedup_vs_cusparse = t_cusparse_ms / t_fwd_ms`. No model path runs it.
The CPU has no bf16 CSR product: there `t_cusparse_bf16_ms` is null and
`cusparse_bf16_note` says why; on a card a failure raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import warnings

import numpy as np
import torch

# default synthetic suite: the 5 training graphs at benchmark scale
DEFAULT_GRAPHS = ["flickr", "yelp", "reddit", "ogbn-proteins", "ogbn-products"]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_suite(args):
    """(name, raw CSR on the CPU) for each graph of the suite."""
    from maxk_tpu_torch.data.datasets import DATASETS
    from maxk_tpu_torch.data.io import list_graph_binaries, load_graph_binary
    from maxk_tpu_torch.data.synthetic import rmat_graph

    if args.dir:
        for prefix in list_graph_binaries(args.dir):
            yield prefix.rsplit("/", 1)[-1], load_graph_binary(prefix)
        return
    for name in args.graphs:
        if name.startswith("rmat_"):
            # rmat_v<nodes>_d<avg_degree>, scaled like the named datasets
            parts = dict((p[0], int(p[1:])) for p in name.split("_")[1:])
            nodes = parts.get("v", 262144)
            v = max(int(nodes * args.scale), 64)
            e = max(int(nodes * parts.get("d", 50) * args.scale), 256)
        else:
            spec = DATASETS[name]
            v = max(int(spec.num_nodes * args.scale), 64)
            e = max(int(spec.num_edges * args.scale), 256)
        yield name, rmat_graph(v, e, seed=123)


def validate_graph(graph, cbsr, dim, mode, tol=1e-3, compute_dtype=None):
    """`maxk_spgemm` against the plain path (`densify_plain`, then the
    segment-sum SpMM), with the reference's error forensics
    (`direct_kernel_interface.py:221-372`); ok when the mean error < tol.
    Under `hybrid_int8` (lossy) tol grows by the quantization bound
    (`int8_error_bound`), never the exact tolerance alone."""
    from maxk_tpu_torch.ops.cbsr_cuda import densify_plain
    from maxk_tpu_torch.ops.dispatch import KernelMode, resolve_mode
    from maxk_tpu_torch.ops.spgemm import maxk_spgemm
    from maxk_tpu_torch.ops.spmm_hybrid import int8_error_bound
    from maxk_tpu_torch.ops.spmm_xla import spmm_segsum

    with torch.no_grad():
        y = maxk_spgemm(graph, cbsr, dim=dim, mode=mode, compute_dtype=compute_dtype)
        v, d = y.shape
        vals = cbsr.values
        # above 2 GB of (V, dim) f32 the oracle's features drop to
        # compute_dtype (its sum stays f32), as the reference's does
        if compute_dtype is not None and v * d * 4 > (2 << 30):
            vals = vals.to(compute_dtype)
        ref = spmm_segsum(graph.csr, densify_plain(vals, cbsr.selector, dim))
        err = (y.float() - ref.float()).abs()
        del y, ref
        max_err, mean_err = float(err.max()), float(err.mean())
        detail = {
            "max_err": max_err,
            "mean_err": mean_err,
            "argmax": [int(i) for i in np.unravel_index(int(err.argmax()), (v, d))],
            "n_gt_0.1": int((err > 0.1).sum()),
            "n_gt_0.5": int((err > 0.5).sum()),
        }
        if resolve_mode(mode) == KernelMode.HYBRID_INT8:
            h = graph.hybrid
            x = densify_plain(cbsr.values.to(compute_dtype or cbsr.values.dtype)
                              * h.pre[:, None].to(compute_dtype or cbsr.values.dtype),
                              cbsr.selector, dim)
            detail["lossy_bound"] = int8_error_bound(h, x, pre_applied=True)
            tol = detail["tol"] = tol + detail["lossy_bound"]
    return mean_err < tol, detail


def cusparse_arm(csr, x: torch.Tensor) -> dict:
    """`torch.sparse.mm` on a CSR tensor of `csr` (built once a dtype,
    outside the timing) against `x` in f32 and in bf16: seconds a call by
    `micro.timeit`, or None for bf16 where the CPU lacks the product, with
    the reason under "note"."""
    from maxk_tpu_torch.bench.micro import timeit

    nnz, v = int(csr.indptr[-1]), csr.num_nodes
    crow, col = csr.indptr.long(), csr.indices[:nnz].long()
    out = {"f32": None, "bf16": None, "note": None}
    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        with warnings.catch_warnings():  # "sparse CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            a = torch.sparse_csr_tensor(crow, col, csr.values[:nnz].to(dtype), (v, v))
        xd = x.to(dtype)
        try:
            out[tag] = timeit(torch.sparse.mm, a, xd, iters=4)
        except (RuntimeError, NotImplementedError) as e:
            if x.is_cuda or dtype != torch.bfloat16:
                raise
            out["note"] = f"no bf16 CSR product on the CPU: {type(e).__name__}: {str(e)[:160]}"
        del a, xd
    return out


def _vdot_f32(a, b):
    return torch.vdot(a.float().flatten(), b.float().flatten())


STRIP_DTYPES = {"bfloat16": torch.bfloat16, "int8": torch.int8}


def main(argv=None):
    from maxk_tpu_torch.bench.bench import schedule_record
    from maxk_tpu_torch.bench.micro import timeit
    from maxk_tpu_torch.ops.dispatch import HYBRID_MODES, TILE_MODES, KernelMode, resolve_mode
    from maxk_tpu_torch.ops.spgemm import maxk_spgemm, spmm
    from maxk_tpu_torch.ops.topk_cuda import maxk_mask_fast
    from maxk_tpu_torch.sparse import hybrid as hyb
    from maxk_tpu_torch.sparse.cbsr import CBSR
    from maxk_tpu_torch.sparse.csr import with_norm, with_segments
    from maxk_tpu_torch.sparse.graph import Graph
    from maxk_tpu_torch.sparse.meta import build_edge_tiles_device
    from maxk_tpu_torch.train.loop import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--graphs", nargs="+", default=DEFAULT_GRAPHS)
    p.add_argument("--dir", default="", help="directory of .indptr binaries")
    p.add_argument("--k", nargs="+", type=int, default=[16, 32, 64])
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--scale", type=float, default=0.02)
    p.add_argument("--mode", default="auto")
    p.add_argument("--validate", action="store_true")
    p.add_argument("--json_out", default="")
    p.add_argument(
        "--io_itemsize", type=int, default=4,
        help="2 runs the masked and CBSR arms' (V, dim) IO in bf16",
    )
    p.add_argument("--strip_dtype", default="auto", choices=["auto", *STRIP_DTYPES],
                   help="hybrid strip dtype; auto: int8 where exact, else bfloat16")
    p.add_argument("--tail_band_cols", type=int, default=-1,
                   help="hybrid tail column-band width; 0: one band, -1: the default rule")
    p.add_argument("--dispatch_check", action="store_true",
                   help="also time the forward of the arm AUTO did not pick, once per graph")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    resolve_mode(args.mode)  # pallas raises before any graph is made
    bf16 = torch.bfloat16

    def rand(shape, seed, dtype=torch.float32):
        gen = torch.Generator(device=device).manual_seed(seed)
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    results = []

    def dump():
        if args.json_out:
            with open(args.json_out, "w") as f:
                json.dump(results, f, indent=1)

    for n, (name, g) in enumerate(load_suite(args)):
        g = g.to(device)
        strip_dtype = (hyb.auto_strip_dtype(g) if args.strip_dtype == "auto"
                       else STRIP_DTYPES[args.strip_dtype])
        mode = resolve_mode(args.mode, has_hybrid=hyb.auto_hybrid(
            g, args.dim, args.io_itemsize, device, strip_dtype)).value
        hybrid = mode in HYBRID_MODES
        permuted = (hybrid or args.dispatch_check) and hyb.check_hybrid_ok(g)
        if permuted:
            # the degree-permuted graph; its strip is built after the
            # baseline arms, whose tile tables it need not sit beside
            g = hyb.permute_csr(g, hyb.degree_perm(g))
        elif hybrid:
            raise ValueError(f"--mode {mode}: {name} is not undirected, so it has no strip "
                             "schedule")
        g_raw = g
        g = with_segments(with_norm(g, "right"))  # the CSR kernels' table, built once
        # the library arm: plain PyTorch over the tile schedule on a card, as
        # the reference's cuSPARSE role (`kernels/main.cu`) off the CPU
        base_mode = "segsum" if mode == "segsum" or device.type == "cpu" else "tiles_scan"
        # the backward arms run A, not Aᵀ, as the reference suite's do
        # (`kernel_bench.py:271`): the same work, and no transpose to build
        tiled = mode in TILE_MODES or base_mode == "tiles_scan"
        tiles = build_edge_tiles_device(g) if tiled else None
        graph = Graph(csr=g, csc=g, tiles=tiles, tiles_t=tiles)
        v = g.num_nodes
        e_real = int((g.values != 0).sum())
        x_dense = rand((v, args.dim), 123)
        t_base = timeit(lambda x: spmm(graph, x, mode=base_mode), x_dense, iters=4)
        print(f"{n} {name} {args.dim} - cusparse_role {t_base*1e3:.4f}", flush=True)
        t_base16 = timeit(lambda x: spmm(graph, x.to(bf16), mode=base_mode), x_dense, iters=4)
        print(f"{n} {name} {args.dim} - cusparse_role_bf16 {t_base16*1e3:.4f}", flush=True)
        cus = cusparse_arm(g, x_dense)
        t_cus16 = None if cus["bf16"] is None else cus["bf16"] * 1e3
        print(f"{n} {name} {args.dim} - cusparse {cus['f32']*1e3:.4f}", flush=True)
        print(f"{n} {name} {args.dim} - cusparse_bf16 "
              f"{'nan' if t_cus16 is None else f'{t_cus16:.4f}'}", flush=True)
        del x_dense

        def build_schedule():
            s_cols = hyb.auto_strip_cols(
                v, e_live=e_real, dim=args.dim, io_itemsize=args.io_itemsize,
                strip_itemsize=torch.empty((), dtype=strip_dtype).element_size(),
                rates=hyb.card_rates(device))
            band = (hyb.auto_tail_band_cols(v, s_cols) if args.tail_band_cols < 0
                    else args.tail_band_cols)
            return hyb.build_hybrid(g_raw, s_cols=s_cols, norm="right", strip_dtype=strip_dtype,
                                    tail_band_cols=band), band

        if hybrid:
            del graph, tiles
            h, band = build_schedule()
            graph = Graph(csr=g, csc=g, hybrid=h)
        # (V, dim) IO in bf16 once an f32 pair no longer fits beside the
        # graph, or on request (the reference's rule)
        io_dtype = bf16 if args.io_itemsize == 2 or v * args.dim * 4 > (2 << 30) else torch.float32
        for k in args.k:
            # production arm: densify(topk(x)) ≡ x ⊙ mask on one device, so
            # the layer's SpMM runs on the masked bf16 features; the mask
            # (K1) is timed on its own
            x_k = rand((v, args.dim), 300 + k, io_dtype)
            t_mask = timeit(lambda x: maxk_mask_fast(x, k), x_k, iters=4)
            print(f"{n} {name} {args.dim} {k} maxk_mask {t_mask*1e3:.4f}", flush=True)
            xm = maxk_mask_fast(x_k, k).to(bf16)
            del x_k
            t_fwd = timeit(lambda x: spmm(graph, x, mode=mode), xm, iters=4)
            print(f"{n} {name} {args.dim} {k} maxk_fwd {t_fwd*1e3:.4f}", flush=True)
            ct16 = rand((v, args.dim), 200 + k, bf16)

            def masked_fwd_bwd(x):
                xr = x.detach().requires_grad_(True)
                loss = _vdot_f32(spmm(graph, xr, mode=mode), ct16)
                loss.backward()
                return loss, xr.grad

            t_fb = timeit(masked_fwd_bwd, xm, iters=4)
            print(f"{n} {name} {args.dim} {k} maxk_fwd_bwd {t_fb*1e3:.4f}", flush=True)
            del xm, ct16

            # CBSR arm (the sharded path's input; backward to the compact
            # (V, k) gradient); output and cotangent in the values' dtype
            vals = rand((v, k), k, io_dtype)
            gen = torch.Generator(device=device).manual_seed(100 + k)
            sel = torch.randint(0, args.dim, (v, k), generator=gen, device=device,
                                dtype=torch.int32)
            cbsr = CBSR(values=vals, selector=sel)
            t_fwd_cbsr = timeit(
                lambda: maxk_spgemm(graph, cbsr, dim=args.dim, mode=mode, compute_dtype=bf16),
                iters=4,
            )
            print(f"{n} {name} {args.dim} {k} maxk_fwd_cbsr {t_fwd_cbsr*1e3:.4f}", flush=True)
            ct = rand((v, args.dim), 200 + k, io_dtype)

            def cbsr_fwd_bwd():
                va = vals.detach().requires_grad_(True)
                y = maxk_spgemm(graph, CBSR(va, sel), dim=args.dim, mode=mode,
                                compute_dtype=bf16)
                loss = _vdot_f32(y, ct)
                loss.backward()
                return loss, va.grad

            t_fb_cbsr = timeit(cbsr_fwd_bwd, iters=4)
            print(f"{n} {name} {args.dim} {k} maxk_fwd_bwd_cbsr {t_fb_cbsr*1e3:.4f}",
                  flush=True)
            del ct
            rec = {
                "graph": name,
                "V": v,
                "E": e_real,
                "k": k,
                "mode": mode,
                "base_mode": base_mode,
                "maxk_input": "masked_dense",
                "t_mask_ms": t_mask * 1e3,
                "t_fwd_ms": t_fwd * 1e3,
                "t_fwd_bwd_ms": t_fb * 1e3,
                "t_fwd_cbsr_ms": t_fwd_cbsr * 1e3,
                "t_fwd_bwd_cbsr_ms": t_fb_cbsr * 1e3,
                "t_baseline_ms": t_base * 1e3,
                "t_baseline_bf16_ms": t_base16 * 1e3,
                "fwd_gnnz_s": e_real / t_fwd / 1e9,
                "speedup_vs_baseline": t_base / t_fwd,
                # the yardstick: torch.sparse.mm (cuSPARSE on a card)
                "t_cusparse_ms": cus["f32"] * 1e3,
                "t_cusparse_bf16_ms": t_cus16,
                "speedup_vs_cusparse": cus["f32"] / t_fwd,
                # the compact (V, k) gradient of the CBSR backward against the
                # masked path's (V, dim) bf16 one, each at its real dtype
                "bwd_grad_bytes_cbsr": v * k * vals.element_size(),
                "bwd_grad_bytes_masked": v * args.dim * 2,
                "cbsr_val_dtype": str(io_dtype).split(".")[-1],
                "mask_dtype": str(io_dtype).split(".")[-1],
            }
            if cus["note"]:
                rec["cusparse_bf16_note"] = cus["note"]
            if hybrid:  # the schedule built, and whether its features were int8
                sched = schedule_record(h)
                rec.update(strip_dtype=sched["strip_dtype"], strip_cols=h.s_cols,
                           tail_band_cols=band, tail_live=sched["tail_live"],
                           tail_tiles=sched["tail_tiles"],
                           feat_int8=mode == KernelMode.HYBRID_INT8.value)
            # the timing record is kept before validation, and again with it
            results.append(rec)
            dump()
            if args.validate:
                ok, detail = validate_graph(graph, cbsr, args.dim, mode, compute_dtype=bf16)
                rec["valid"] = ok
                rec["validation"] = detail
                log(f"  validate k={k}: ok={ok} {detail}")
                dump()
            del vals, sel, cbsr
        if args.dispatch_check and mode in ("hybrid", "segsum") and permuted:
            # the arm AUTO did not pick, at the smallest k: the production
            # forward is the SpMM on masked bf16 features either way
            alt = "segsum" if hybrid else "hybrid"
            alt_graph = graph if hybrid else Graph(csr=g, csc=g, hybrid=build_schedule()[0])
            kf = min(args.k)
            xm = maxk_mask_fast(rand((v, args.dim), 999), kf).to(bf16)
            t_alt = timeit(lambda x: spmm(alt_graph, x, mode=alt), xm, iters=4)
            t_pick = next(r["t_fwd_ms"] for r in results if r["graph"] == name and r["k"] == kf)
            results.append({"kind": "dispatch_check", "graph": name, "V": v, "E": e_real,
                            "picked": mode, "alt": alt, "t_fwd_picked_ms": t_pick,
                            "t_fwd_alt_ms": t_alt * 1e3,
                            "picked_faster": bool(t_pick <= t_alt * 1e3)})
            log(f"  dispatch_check: picked={mode} {t_pick:.2f} ms vs {alt} {t_alt*1e3:.2f} ms")
            dump()
            del alt_graph, xm
    if args.json_out:
        log(f"wrote {args.json_out} ({len(results)} records)")
    return results


if __name__ == "__main__":
    main()
