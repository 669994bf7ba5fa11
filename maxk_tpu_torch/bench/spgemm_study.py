"""SpGEMM-pruning study — port of `maxk_tpu/bench/spgemm_study.py`.

The reference's study (`spgemm_comparison_test_2.cu:348-409`,
`spgemm_compare_baseline_2.cu:193-259`) measures the output-sparse
product adjacency × pruned features at feature sparsity ∈ {0.5, 0.25,
0.125, 0.0625}, dim 256, across strategies, with per-phase times and
GFLOPS by `flop = Σ_(i,j)∈A 2·nnz(X[j,:]) = 2·E·k`. The output-sparse
format is row-wise top-k CBSR, what a fused MaxK layer consumes (k =
s·dim); the "symbolic" phase is the top-k (K4, `maxk_cbsr_fast`), the
"numeric" one the values. Strategies:

  segsum_topk  the chunked segment-sum SpMM, then prune (library role)
  dense_topk   densify (K2) → `--mode` SpMM on bf16 → prune
  cbsr_fused   `maxk_spgemm` under `--mode` (compressed in, K2 inside)
  hybrid_topk  `maxk_spgemm` under the strip hybrid → prune

The graph is the port's host `rmat_graph` (`"generator"` in the output),
degree-permuted once (`hybrid.degree_perm` / `permute_csr`) so every arm
sees the same problem. The hybrid arm is validated against segsum (mean
error under 1e-3 of max|y|); a failure exits 1.

    python -m maxk_tpu_torch.bench.spgemm_study [--graph reddit --scale 0.02]
    python -m maxk_tpu_torch.bench.spgemm_study --device cpu --graph flickr \\
        --scale 0.002 --mode segsum

Prints one JSON document on stdout: per sparsity the arms' phase times,
total and GFLOPS, and the best arm.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

SPARSITIES = [0.5, 0.25, 0.125, 0.0625]
GENERATOR = "host rmat_graph"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> list:
    from maxk_tpu_torch.bench.micro import timeit
    from maxk_tpu_torch.data.datasets import DATASETS
    from maxk_tpu_torch.data.synthetic import rmat_graph
    from maxk_tpu_torch.ops.dispatch import TILE_MODES, resolve_mode
    from maxk_tpu_torch.ops.spgemm import maxk_spgemm, spmm
    from maxk_tpu_torch.ops.topk_cuda import maxk_cbsr_fast
    from maxk_tpu_torch.sparse import hybrid as hyb
    from maxk_tpu_torch.sparse.cbsr import CBSR, cbsr_densify
    from maxk_tpu_torch.sparse.csr import with_norm, with_segments
    from maxk_tpu_torch.sparse.graph import Graph
    from maxk_tpu_torch.sparse.meta import build_edge_tiles_device
    from maxk_tpu_torch.train.loop import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--graph", default="reddit")
    p.add_argument("--scale", type=float, default=0.02)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--mode", default="tiles_scan",
                   help="SpMM mode of the dense_topk and cbsr_fused arms")
    p.add_argument("--validate", action="store_true", default=True)
    p.add_argument("--no-validate", dest="validate", action="store_false")
    p.add_argument("--json_out", default="", help="persist results after every sparsity")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    resolve_mode(args.mode)

    spec = DATASETS[args.graph]
    v = max(int(spec.num_nodes * args.scale), 64)
    e_target = max(int(spec.num_edges * args.scale), 256)
    graw = rmat_graph(v, e_target, seed=123).to(device)
    # degree-permute once so every arm sees the same (permuted) problem
    graw = hyb.permute_csr(graw, hyb.degree_perm(graw))
    e_live0 = int(graw.indptr[-1])
    hybrid = hyb.build_hybrid(
        graw, s_cols=hyb.auto_strip_cols(v, e_live=e_live0, dim=args.dim,
                                         rates=hyb.card_rates(device)), norm="none")
    g = with_segments(with_norm(graw, "none"))  # the CSR kernels' table, built once
    e_real = int((g.values != 0).sum())
    tiles = build_edge_tiles_device(g) if args.mode in TILE_MODES else None
    graph = Graph(csr=g, csc=g, tiles=tiles, tiles_t=tiles)
    hgraph = Graph(csr=g, csc=g, hybrid=hybrid)
    log(f"{args.graph} x{args.scale}: V={v} E(live)={e_real} dim={args.dim} "
        f"strip S={hybrid.s_cols}")

    dim, bf16 = args.dim, torch.bfloat16
    head = {"graph": args.graph, "V": v, "E": e_real, "generator": GENERATOR}
    results = []
    for sp in SPARSITIES:
        k = max(int(dim * sp), 1)
        gen = torch.Generator(device=device).manual_seed(1000 + k)
        vals = torch.randn((v, k), generator=gen, device=device)
        sel = torch.randint(0, dim, (v, k), generator=gen, device=device, dtype=torch.int32)
        cbsr = CBSR(values=vals, selector=sel)
        flops = 2.0 * e_real * k  # the reference's accounting (input sparsity)
        x_dense = cbsr_densify(cbsr, dim)

        def prune(y):
            c = maxk_cbsr_fast(y, k)
            return c.values, c.selector

        arms = {}
        # segsum_topk (library arm): the edge-chunked segment sum, then prune
        t_num = timeit(lambda x: spmm(graph, x, mode="segsum"), x_dense, iters=4)
        y_ref = spmm(graph, x_dense, mode="segsum")
        t_sym = timeit(prune, y_ref, iters=4)
        arms["segsum_topk"] = {"numeric_ms": t_num * 1e3, "symbolic_ms": t_sym * 1e3}

        # dense_topk: densify, the --mode SpMM on bf16, prune
        t_d = timeit(lambda: cbsr_densify(cbsr, dim), iters=4)
        t_num = timeit(lambda x: spmm(graph, x.to(bf16), mode=args.mode), x_dense, iters=4)
        arms["dense_topk"] = {"densify_ms": t_d * 1e3, "numeric_ms": t_num * 1e3,
                              "symbolic_ms": t_sym * 1e3}

        # cbsr_fused: compressed in, densify inside maxk_spgemm
        t_num = timeit(lambda: maxk_spgemm(graph, cbsr, dim=dim, mode=args.mode,
                                           compute_dtype=bf16), iters=4)
        arms["cbsr_fused"] = {"numeric_ms": t_num * 1e3, "symbolic_ms": t_sym * 1e3}

        # hybrid_topk: the degree-sorted strip schedule
        t_num = timeit(lambda: maxk_spgemm(hgraph, cbsr, dim=dim, mode="hybrid",
                                           compute_dtype=bf16), iters=4)
        arms["hybrid_topk"] = {"numeric_ms": t_num * 1e3, "symbolic_ms": t_sym * 1e3}

        rec = {"sparsity": sp, "k": k, "flop": flops}
        if args.validate:
            y_h = maxk_spgemm(hgraph, cbsr, dim=dim, mode="hybrid")
            err = float((y_h - y_ref).abs().mean())
            scale_ = max(float(y_ref.abs().max()), 1e-6)
            rec["hybrid_mean_rel_err"] = err / scale_
            if not err / scale_ < 1e-3:
                log(f"  VALIDATION FAILED sparsity={sp}: mean_rel {err/scale_:.2e}")
                sys.exit(1)
            del y_h
        for name, ph in arms.items():
            total = sum(ph.values())
            rec[name] = {**ph, "total_ms": total, "gflops": flops / total / 1e6}
        results.append(rec)
        log(f"  s={sp} (k={k}): " + " | ".join(
            f"{n} {sum(ph.values()):.2f}ms" for n, ph in arms.items()))
        if args.json_out:
            with open(args.json_out, "w") as f:
                json.dump({**head, "results": results}, f, indent=1)
        del vals, sel, cbsr, x_dense, y_ref

    best = {rec["sparsity"]: min((a for a in rec if isinstance(rec[a], dict)),
                                 key=lambda a: rec[a]["total_ms"]) for rec in results}
    print(json.dumps({**head, "results": results, "best_arm": best}))
    return results


if __name__ == "__main__":
    main()
