"""Three schedules of one SpMM — port of `maxk_tpu/bench/three_arms.py`.

The reference benchmarks three independent schedules of the same SpMM:
its warp4 kernel, cuSPARSE and GNNAdvisor's neighbour groups
(`kernels/spmm_gnna.cu:20-176`, `README.md:136`). This framework's three:

  tiles_scan  the blocked-gather edge-tile schedule (library role)
  hybrid      the symmetric-strip decomposition (AUTO's SpMM on a card)
  bricks      the block-dense brick kernel K5 (`ops/spmm_bricks`, the
              GNNAdvisor role), its schedule built on the host
              (`sparse/bricks.build_bricks`)

Each runs on the same bf16 input and is validated against the segment-sum
SpMM (mean error under 1e-3 of max|ref|). A fourth column, `cusparse_ms`,
times `torch.sparse.mm` on a CSR tensor of the same graph: the yardstick,
not validated. Graphs are the port's host `rmat_graph` (`"generator"`),
degree-permuted; the hybrid's strip takes AUTO's dtype and width at the
card's rates.

    python -m maxk_tpu_torch.bench.three_arms --out THREE_ARMS.json
    python -m maxk_tpu_torch.bench.three_arms --device cpu --graphs flickr --scale 0.005

Prints one JSON document: per graph each arm's forward ms, its error and
validity, and geomean speedups over tiles_scan per degree class.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

GENERATOR = "host rmat_graph"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> list:
    from maxk_tpu_torch.bench.kernel_bench import cusparse_arm
    from maxk_tpu_torch.bench.micro import timeit
    from maxk_tpu_torch.data.datasets import DATASETS
    from maxk_tpu_torch.data.synthetic import rmat_graph
    from maxk_tpu_torch.ops.spmm_bricks import spmm_bricks
    from maxk_tpu_torch.ops.spmm_hybrid import spmm_hybrid
    from maxk_tpu_torch.ops.spmm_xla import spmm_segsum, spmm_tiles_scan
    from maxk_tpu_torch.sparse import hybrid as hyb
    from maxk_tpu_torch.sparse.bricks import build_bricks
    from maxk_tpu_torch.sparse.csr import with_norm
    from maxk_tpu_torch.sparse.meta import build_edge_tiles_device
    from maxk_tpu_torch.train.loop import resolve_device

    p = argparse.ArgumentParser()
    # the claim's shape (`README.md:136`): graphs on both sides of average
    # degree 50 — reddit above, proteins and flickr below
    p.add_argument("--graphs", nargs="+", default=["reddit", "ogbn-proteins", "flickr"])
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--out", default="")
    p.add_argument("--arms", nargs="+", default=["tiles_scan", "hybrid", "bricks"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    results = []

    def assemble():
        # per-degree-class geomean speedups of each schedule over tiles_scan
        classes = {"avg_deg_ge_50": [], "avg_deg_lt_50": []}
        for r in results:
            if "tiles_scan_ms" in r:
                classes["avg_deg_ge_50" if r["E"] / max(r["V"], 1) >= 50
                        else "avg_deg_lt_50"].append(r)
        summary = {}
        for cls, rows in classes.items():
            if not rows:
                continue
            ent = {"n_graphs": len(rows)}
            for arm in ("hybrid", "bricks", "cusparse"):
                sp = [r["tiles_scan_ms"] / r[f"{arm}_ms"] for r in rows
                      if r.get(f"{arm}_ms") and r.get(f"{arm}_valid", arm == "cusparse")]
                if sp:
                    ent[f"{arm}_geomean_speedup"] = math.exp(sum(map(math.log, sp)) / len(sp))
                    ent[f"{arm}_n"] = len(sp)
            summary[cls] = ent
        return {
            "protocol": {
                "scale": args.scale, "dim": args.dim, "generator": GENERATOR,
                "device": torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu",
                "note": "independent schedules of the same SpMM on the same bf16 input, each "
                        "validated against the segment-sum SpMM; cusparse_ms is "
                        "torch.sparse.mm on a CSR tensor, the yardstick, not validated",
            },
            "results": results,
            "geomean_by_degree_class": summary,
        }

    def persist():
        if args.out:
            with open(args.out, "w") as f:
                json.dump(assemble(), f, indent=1)

    def rel_err(y, ref):
        d = (y.float() - ref.float()).abs()
        sc = max(float(ref.float().abs().max()), 1e-6)
        return float(d.max()) / sc, float(d.mean()) / sc

    for name in args.graphs:
        spec = DATASETS[name]
        v = max(int(spec.num_nodes * args.scale), 256)
        e = max(int(spec.num_edges * args.scale), 1024)
        g = rmat_graph(v, e, seed=123).to(device)
        live = int(g.indptr[-1])
        log(f"=== {name} x{args.scale}: V={v} live={live}")
        g = hyb.permute_csr(g, hyb.degree_perm(g))
        gen = torch.Generator(device=device).manual_seed(0)
        x = torch.randn((v, args.dim), generator=gen, device=device).to(torch.bfloat16)
        rec = {"graph": name, "V": v, "E": live, "dim": args.dim}
        gn = with_norm(g, "none")
        y_ref = spmm_segsum(gn, x)

        def arm(label, fn, *fargs):
            y = fn(*fargs)
            mx, mn = rel_err(y, y_ref)
            rec[f"{label}_valid"] = mn < 1e-3
            rec[f"{label}_rel_err"] = {"max": mx, "mean": mn}
            del y
            t = timeit(fn, *fargs, iters=4)
            rec[f"{label}_ms"] = t * 1e3
            log(f"{label}: {t*1e3:.2f} ms (rel err mean {mn:.2e})")

        # arm 1: tiles_scan (library role)
        if "tiles_scan" in args.arms:
            tiles = build_edge_tiles_device(gn)
            arm("tiles_scan", spmm_tiles_scan, tiles, x)
            del tiles

        # arm 2: hybrid, AUTO's strip dtype (int8 where exact) and width
        strip_dtype = hyb.auto_strip_dtype(g)
        s_cols = hyb.auto_strip_cols(
            v, e_live=live, dim=args.dim,
            strip_itemsize=torch.empty((), dtype=strip_dtype).element_size(),
            rates=hyb.card_rates(device))
        if "hybrid" in args.arms and s_cols >= 256:
            t0 = time.perf_counter()
            h = hyb.build_hybrid(g, s_cols=s_cols, norm="none", strip_dtype=strip_dtype)
            log(f"hybrid build {time.perf_counter()-t0:.1f}s (s={h.s_cols} {strip_dtype})")
            rec["hybrid_strip"] = {"s_cols": h.s_cols, "dtype": str(strip_dtype).split(".")[-1]}
            arm("hybrid", spmm_hybrid, h, x)
            del h

        # arm 3: bricks (K5), the schedule built on the host
        if "bricks" in args.arms:
            t0 = time.perf_counter()
            sched = build_bricks(gn).to(device)
            rec["bricks_build_s"] = time.perf_counter() - t0
            log(f"bricks build {rec['bricks_build_s']:.1f}s")
            arm("bricks", spmm_bricks, sched, x)
            del sched

        # the yardstick: torch.sparse.mm (cuSPARSE on a card), bf16 where
        # the device has the product
        cus = cusparse_arm(gn, x)
        t_cus = cus["bf16"] if cus["bf16"] is not None else cus["f32"]
        rec["cusparse_ms"] = t_cus * 1e3
        rec["cusparse_dtype"] = "bfloat16" if cus["bf16"] is not None else "float32"
        if cus["note"]:
            rec["cusparse_note"] = cus["note"]
        log(f"cusparse ({rec['cusparse_dtype']}): {t_cus*1e3:.2f} ms")
        results.append(rec)
        persist()  # per graph: a failure costs the current graph only
        del g, gn, x, y_ref

    doc = assemble()
    persist()
    if args.out:
        log(f"wrote {args.out}")
    print(json.dumps(doc, indent=1))
    return results


if __name__ == "__main__":
    main()
