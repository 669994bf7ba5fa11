"""Strong scaling of the sharded train step — port of `maxk_tpu/bench/scaling.py`.

The reference is single-GPU by design; row-partitioned training is this
framework's own. This script times the sharded train step
(`parallel/train`) over n ∈ {1, 2, 4, 8} ranks spawned by
`parallel/mesh.run_ranks`, one per card (NCCL), capped at the card count,
or gloo ranks with `--device cpu` (ranks share the host's cores there, so
CPU numbers show relative scaling only). Arms: `maxk` and `relu` on
`--kernel_mode`, `maxk_hybrid` and `relu_hybrid` on the strip hybrid. The
maxk arms all_gather the compressed (V, k) CBSR, the relu arms dense (V, D)
rows; each record carries the measured step time, the receive bytes of the
step (`ByteCounter`), the analytic per-layer gather bytes and, for maxk at
n > 1, the halo-exchange alternative (`parallel/shard.halo_stats`).

`analytic_ms` is the reference's roofline (`analytic_v5e_ms`) with the
card's rates: gather and matmul rates from `sparse/hybrid.card_rates`, and
the link rate measured once a run by an all-gather of `LINK_BYTES` a rank
at the run's largest n > 1 (`link_bytes_s` in the protocol). As in the
reference, only `maxk_hybrid` is charged the strip products and hub
reduce; `relu_hybrid` is charged the gather model.

All arms of one n run in one spawn. Results persist after every n in
`--json_out`, and a rerun resumes from it.

    python -m maxk_tpu_torch.bench.scaling [--dataset flickr --scale 0.2]
    python -m maxk_tpu_torch.bench.scaling --device cpu --devices 1 2 --scale 0.005 \\
        --hidden_dim 32 --maxk 8 --iters 2 --repeats 1 --warmup 1

Prints one JSON document: per (arm, n) step ms, bytes, analytic ms and
scaling efficiencies.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ARMS = {  # label: (nonlinearity, kernel mode; None = --kernel_mode)
    "maxk": ("maxk", None),
    "maxk_hybrid": ("maxk", "hybrid"),
    "relu": ("relu", None),
    "relu_hybrid": ("relu", "hybrid"),
}
LINK_BYTES = 64 << 20  # bytes a rank hands to the timed all-gather


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def analytic_ms(arm, n, v, e, d, k, nl, s_cols=0, tail_e=0, rates=None, link_bytes_s=None):
    """Per-step ms the roofline predicts for one arm on n ranks: per layer
    the local aggregation (gather rate × edges, or the strip products at
    the matmul rate plus the tail's edges) forward and backward, and the
    collectives' receive bytes (`parallel/audit.model_recv_bytes_fwd_bwd`)
    over `link_bytes_s`. `rates`: a `sparse/hybrid.Rates`."""
    from maxk_tpu_torch.parallel.audit import model_recv_bytes_fwd_bwd

    if arm == "maxk_hybrid":
        strip_flops = 2 * (v / n) * s_cols * d * 2
        agg = strip_flops / rates.matmul_flops + (tail_e / n) * rates.gather_sec_per_edge
        coll_bytes = model_recv_bytes_fwd_bwd("maxk_hybrid", n, v, d, k=k, s_cols=s_cols)
    else:
        agg = (e / n) * rates.gather_sec_per_edge
        coll_bytes = model_recv_bytes_fwd_bwd(arm, n, v, d, k=k)
    coll = coll_bytes / link_bytes_s if coll_bytes else 0.0
    return nl * (2 * agg + coll) * 1e3


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def allgather_seconds(mesh, nbytes: int = LINK_BYTES, iters: int = 10) -> float:
    """Seconds of one all-gather (`collectives.all_gather_rows`) of `nbytes`
    a rank on this mesh, the mean of `iters` after a warm-up."""
    from maxk_tpu_torch.parallel.collectives import all_gather_rows

    x = torch.ones((nbytes // 1024, 256), dtype=torch.float32, device=mesh.device)
    all_gather_rows(x, mesh)
    _sync(mesh.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        all_gather_rows(x, mesh)
    _sync(mesh.device)
    return (time.perf_counter() - t0) / iters


def scaling_rank(mesh, arms, run: dict, link: bool) -> dict:
    """One rank of one n: each arm of `arms` set up, warmed up and timed
    (best of `repeats` windows of `iters` steps); with `link` the all-gather
    timed first. Returns rank-local numbers (rank 0's are recorded)."""
    from maxk_tpu_torch.data.datasets import load_dataset
    from maxk_tpu_torch.parallel.train import make_sharded_train_step, sharded_setup
    from maxk_tpu_torch.train.config import TrainConfig

    out = {"link_s": allgather_seconds(mesh) if link else None, "arms": {}}
    data = load_dataset(run["dataset"], scale=run["scale"], seed=123)
    for arm in arms:
        nonlinear, kmode = ARMS[arm]
        cfg = TrainConfig(dataset=run["dataset"], model=run["model"], epochs=1,
                          hidden_dim=run["hidden_dim"], hidden_layers=run["hidden_layers"],
                          nonlinear=nonlinear, maxk=run["maxk"], dropout=0.0,
                          kernel_mode=kmode or run["kernel_mode"], data_scale=run["scale"],
                          seed=97, device=mesh.device.type)
        state = sharded_setup(cfg, data, mesh)
        step = make_sharded_train_step(state.model, state.optimizer, data.multilabel, mesh)
        sa = (state.graph, state.feats, state.labels, state.masks[0], state.generator)
        for _ in range(run["warmup"]):
            loss, _ = step(*sa)
        step_bytes = mesh.bytes.total_recv()
        _sync(mesh.device)
        ms = float("inf")
        for _ in range(run["repeats"]):
            t0 = time.perf_counter()
            for _ in range(run["iters"]):
                loss, _ = step(*sa)
            _sync(mesh.device)
            ms = min(ms, (time.perf_counter() - t0) / run["iters"] * 1e3)
        loss = float(loss)
        assert np.isfinite(loss), loss
        h = state.graph.hybrid
        out["arms"][arm] = {"step_ms": ms, "loss": loss, "recv_bytes_per_step": step_bytes,
                            "s_cols": h.s_cols if h is not None else 0,
                            "vp": state.graph.padded_nodes}
        del state, step, sa
    return out


def tail_edges(csr, s_cols: int) -> int:
    """Edges outside the hub strip after the degree sort (rows and columns
    both ≥ S): the roofline's tail."""
    v = csr.num_nodes
    indptr = csr.indptr.numpy().astype(np.int64)
    deg = np.diff(indptr)
    rank = np.empty(v, dtype=np.int64)
    rank[np.argsort(-deg, kind="stable")] = np.arange(v)
    rows = rank[np.repeat(np.arange(v), deg)]
    cols = rank[csr.indices.numpy()[: indptr[-1]].astype(np.int64)]
    return int(((rows >= s_cols) & (cols >= s_cols)).sum())


def main(argv=None) -> list:
    from maxk_tpu_torch.data.datasets import load_dataset
    from maxk_tpu_torch.parallel.mesh import run_ranks
    from maxk_tpu_torch.parallel.shard import halo_stats
    from maxk_tpu_torch.sparse.hybrid import card_rates
    from maxk_tpu_torch.train.loop import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="flickr")
    p.add_argument("--scale", type=float, default=0.2)
    p.add_argument("--model", default="sage")
    p.add_argument("--maxk", type=int, default=32)
    p.add_argument("--hidden_dim", type=int, default=256)
    p.add_argument("--hidden_layers", type=int, default=3)
    p.add_argument("--devices", nargs="+", type=int, default=[1, 2, 4, 8])
    # steady state: best of `repeats` windows of `iters` steps after warm-up
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--kernel_mode", default="tiles_scan")
    p.add_argument("--device", default="cuda", help="cuda: NCCL ranks; cpu: gloo ranks")
    p.add_argument("--timeout", type=float, default=3600, help="seconds per spawn")
    p.add_argument("--json_out", default="", help="persist records after every n")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    have = torch.cuda.device_count() if device.type == "cuda" else max(args.devices)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"

    data = load_dataset(args.dataset, scale=args.scale, seed=123)
    v, e = data.csr.num_nodes, int(data.csr.indptr[-1])
    d, k, nl = args.hidden_dim, args.maxk, args.hidden_layers
    log(f"{args.dataset} x{args.scale}: V={v} E={e} {args.model} {nl}x{d} k={k} "
        f"on {name}, up to {have} ranks")

    results, prev_link = [], None
    if args.json_out and os.path.exists(args.json_out):
        with open(args.json_out) as f:
            prev = json.load(f)
        if isinstance(prev, dict):
            results, prev_link = prev["results"], prev.get("protocol", {}).get("link")
        else:
            results = prev
        log(f"resuming: {len(results)} completed configs in {args.json_out}")
    done = {(r["arm"], r["n"]) for r in results}
    run = dict(dataset=args.dataset, scale=args.scale, model=args.model, maxk=k,
               hidden_dim=d, hidden_layers=nl, kernel_mode=args.kernel_mode,
               iters=args.iters, repeats=args.repeats, warmup=args.warmup)
    ns = sorted(n for n in args.devices if n <= have)
    for n in sorted(set(args.devices) - set(ns)):
        log(f"skip n={n}: only {have} devices")
    link_n = max((n for n in ns if n > 1), default=None)
    link = prev_link
    for n in ns:
        todo = [a for a in ARMS if (a, n) not in done]
        if not todo:
            continue
        out = run_ranks(scaling_rank, n, (todo, run, n == link_n), device_type=device.type,
                        timeout=args.timeout)[0]
        if out["link_s"] is not None:
            link = {"n": n, "bytes_per_rank": LINK_BYTES, "seconds": out["link_s"],
                    "bytes_s": (n - 1) * LINK_BYTES / out["link_s"]}
            log(f"all-gather at n={n}: {link['bytes_s']/1e9:.2f} GB/s received a rank")
        for arm, a in out["arms"].items():
            rec = {"arm": arm, "n": n, "step_ms": round(a["step_ms"], 2),
                   "recv_bytes_per_step": a["recv_bytes_per_step"],
                   "fwd_allgather_bytes_per_layer": v * (k * 8) if arm.startswith("maxk")
                   else v * (d * 4)}
            if a["s_cols"]:
                rec["s_cols"] = a["s_cols"]
                rec["fwd_hub_psum_bytes_per_layer"] = a["s_cols"] * d * 4
                if arm == "maxk_hybrid":
                    rec["tail_edges"] = tail_edges(data.csr, a["s_cols"])
            if arm == "maxk" and n > 1:
                rec["halo_alt_recv_bytes_per_device"] = halo_stats(
                    data.csr, n, k=k, s_cols=0)["halo_recv_bytes_per_device_max"]
            results.append(rec)
            log(f"  {arm} n={n}: {a['step_ms']:.2f} ms/step loss={a['loss']:.4f}")
        if args.json_out:
            with open(args.json_out, "w") as f:
                json.dump(results, f, indent=1)

    rates = card_rates(device)
    for r in results:
        r["analytic_step_ms"] = None if link is None and r["n"] > 1 else round(analytic_ms(
            r["arm"], r["n"], v, e, d, k, nl, s_cols=r.get("s_cols", 0),
            tail_e=r.get("tail_edges", 0), rates=rates,
            link_bytes_s=link["bytes_s"] if link else None), 3)
    # strong scaling against n = 1 of the same arm: base/(n·ms) for one
    # card a rank; base/ms where ranks share one pool of cores (CPU)
    for r in results:
        base = next((b for b in results if b["arm"] == r["arm"] and b["n"] == 1), None)
        if base:
            r["efficiency_chips"] = round(base["step_ms"] / (r["step_ms"] * r["n"]), 3)
            r["efficiency_shared"] = round(base["step_ms"] / r["step_ms"], 3)
            if base["analytic_step_ms"] and r["analytic_step_ms"]:
                r["efficiency_chips_analytic"] = round(
                    base["analytic_step_ms"] / (r["analytic_step_ms"] * r["n"]), 3)
    doc = {
        "protocol": {
            "dataset": args.dataset, "scale": args.scale, "V": v, "E": e,
            "model": args.model, "hidden_dim": d, "layers": nl, "k": k,
            "device": name, "backend": "nccl" if device.type == "cuda" else "gloo",
            "iters": args.iters, "kernel_mode": args.kernel_mode,
            "rates": {"gather_sec_per_edge": rates.gather_sec_per_edge,
                      "matmul_flops": rates.matmul_flops},
            "link": link,
            "note": "gloo ranks share the host's cores: relative scaling only"
                    if device.type == "cpu" else "one card a rank",
        },
        "results": results,
        "compressed_collective_ratio": round((k * 8) / (d * 4), 4),
    }
    print(json.dumps(doc))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(doc, f, indent=1)
    return results


if __name__ == "__main__":
    main()
