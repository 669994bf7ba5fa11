"""k against accuracy and epoch time — port of `maxk_tpu/bench/ksweep.py`.

The reference's training tables report, per dataset × model, the speed
and the accuracy delta of MaxK (k over {2..128}) against the ReLU
baseline (`README.md:160-174`, the `plotgnn.py:26-39` figure). This script
runs that protocol on DC-SBM synthetic datasets with the per-dataset
feature SNR, learning rate and homophily of `train.golden.ACC_PROTOCOL`,
so the relu control arm sits in a band that discriminates.

Three arms per (dataset, model): `relu` on the production kernel
(`--kernel_mode`), `relu_lib` on `--lib_mode` (default `tiles_scan`, the
reference's library role) and `maxk_k*`. On an H100 `tiles_scan` is the
slow arm (1.33–1.63× segsum's SpMM, PERF.md), so a speedup against
`relu_lib` is an upper bound.

Results persist after every arm in `--json_out` with the core protocol;
a rerun resumes from it, re-running only arms that are missing or were
measured at a superseded (feat_snr, lr, p_intra), and refuses (exit 2) a
file measured under another core protocol. The core protocol holds no
device key, so a resume from the JAX package's file is judged on the
arguments alone.

    python -m maxk_tpu_torch.bench.ksweep --datasets flickr reddit \\
        --models sage gcn --scale 0.1 --epochs 300 --json_out KSWEEP.json
    python -m maxk_tpu_torch.bench.ksweep --device cpu --datasets flickr --k 4 \\
        --scale 0.005 --epochs 3 --hidden_dim 16 --hidden_layers 2

Prints one JSON document: per (dataset, model, arm) best val/test
accuracy and mean epoch time (with the card's name under `device`), and
per MaxK arm the accuracy delta and speedups against both relu arms.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def summarize(results, datasets, models) -> list:
    """Per (dataset, model, MaxK arm): accuracy delta and speedup (%) against
    the relu arm, and against relu_lib where it exists."""
    summary = []
    for ds in datasets:
        for model in models:
            rows = [r for r in results if r["dataset"] == ds and r["model"] == model]
            relu = next((r for r in rows if r["arm"] == "relu"), None)
            lib = next((r for r in rows if r["arm"] == "relu_lib"), None)
            if relu is None:
                continue  # partial resume: no reference arm yet
            for r in rows:
                if r["arm"] in ("relu", "relu_lib"):
                    continue
                row = {
                    "dataset": ds, "model": model, "arm": r["arm"],
                    "acc_delta": round(r["best_test"] - relu["best_test"], 4),
                    "speedup_pct": round(
                        100.0 * (relu["epoch_ms"] - r["epoch_ms"])
                        / max(relu["epoch_ms"], 1e-9), 1),
                }
                if lib is not None:
                    row["speedup_vs_lib_pct"] = round(
                        100.0 * (lib["epoch_ms"] - r["epoch_ms"])
                        / max(lib["epoch_ms"], 1e-9), 1)
                summary.append(row)
    return summary


def main(argv=None) -> list:
    p = argparse.ArgumentParser()
    p.add_argument("--datasets", nargs="+", default=["flickr", "reddit"])
    p.add_argument("--models", nargs="+", default=["sage"])
    p.add_argument("--k", nargs="+", type=int, default=[2, 4, 8, 16, 32, 64, 96, 128])
    p.add_argument("--scale", type=float, default=0.05)
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--hidden_dim", type=int, default=256)
    p.add_argument("--hidden_layers", type=int, default=3)
    p.add_argument("--feat_snr", type=float, default=0.0,
                   help="0 = per-dataset calibrated value (train.golden.ACC_PROTOCOL)")
    p.add_argument("--lr", type=float, default=0.0,
                   help="0 = per-dataset calibrated value (train.golden.ACC_PROTOCOL)")
    p.add_argument("--graph_kind", default="sbm",
                   help="synthetic generator: sbm (homophilous DC-SBM) or rmat")
    p.add_argument("--kernel_mode", default="auto")
    p.add_argument("--lib_mode", default="tiles_scan",
                   help="kernel mode of the relu_lib baseline arm (the library role)")
    p.add_argument("--compute_dtype", default="")
    p.add_argument("--seed", type=int, default=97)
    p.add_argument("--json_out", default="", help="persist results after every arm")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from maxk_tpu_torch.train.loop import resolve_device

    device = resolve_device(args.device)
    device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"

    # fields that make two runs' records comparable; the dataset and model
    # lists are left out, since adding one does not invalidate measured arms
    core_protocol = {
        "scale": args.scale, "epochs": args.epochs,
        "hidden_dim": args.hidden_dim, "hidden_layers": args.hidden_layers,
        "seed": args.seed, "graph_kind": args.graph_kind,
        "kernel_mode": args.kernel_mode, "lib_mode": args.lib_mode,
        "compute_dtype": args.compute_dtype,
    }

    results = []
    if args.json_out and os.path.exists(args.json_out):
        with open(args.json_out) as f:
            prev = json.load(f)
        # a partial or finished run persists a dict with its core protocol;
        # a bare list is a legacy partial whose protocol cannot be checked
        if isinstance(prev, dict):
            results = prev["results"]
            prev_core = prev.get("core_protocol")
            if prev_core is not None and prev_core != core_protocol:
                diff = {
                    k2: (prev_core.get(k2), core_protocol.get(k2))
                    for k2 in set(prev_core) | set(core_protocol)
                    if prev_core.get(k2) != core_protocol.get(k2)
                }
                log(f"REFUSING resume: {args.json_out} was measured "
                    f"under a different core protocol: {diff}. "
                    f"Move it aside or rerun with matching args.")
                sys.exit(2)
        else:
            results = prev
            log("legacy bare-list resume: core protocol unverifiable — records assumed "
                "in-protocol")
        log(f"resuming: {len(results)} completed arms in {args.json_out}")

    from maxk_tpu_torch.data.datasets import load_dataset
    from maxk_tpu_torch.train.config import TrainConfig
    from maxk_tpu_torch.train.golden import ACC_PROTOCOL
    from maxk_tpu_torch.train.loop import train

    for ds in args.datasets:
        proto = ACC_PROTOCOL.get(ds, {})
        snr = args.feat_snr or proto.get("feat_snr", 0.15)
        lr = args.lr or proto.get("lr", 0.001)
        p_intra = proto.get("p_intra", 0.8)
        # an arm is skipped only if its record matches the current resolved
        # (snr, lr, p_intra): recalibrating a dataset re-runs its arms
        stale = [
            r for r in results if r["dataset"] == ds
            and not (
                abs(r.get("feat_snr", snr) - snr) < 1e-12
                and abs(r.get("lr", lr) - lr) < 1e-12
                and abs(r.get("p_intra", p_intra) - p_intra) < 1e-12
            )
        ]
        if stale:
            log(f"{ds}: {len(stale)} records measured at a superseded "
                f"(feat_snr, lr, p_intra) — dropped for re-run at ({snr}, {lr}, {p_intra})")
            results = [r for r in results if r not in stale]
        done = {(r["dataset"], r["model"], r["arm"]) for r in results}
        data = None
        for model in args.models:
            arms = [
                ("relu", args.hidden_dim, "relu", args.kernel_mode),
                ("relu", args.hidden_dim, "relu_lib", args.lib_mode),
            ] + [
                ("maxk", k, f"maxk_k{k}", args.kernel_mode)
                for k in args.k if k <= args.hidden_dim
            ]
            for nonlinear, k, arm, kmode in arms:
                if (ds, model, arm) in done:
                    continue
                if data is None:
                    data = load_dataset(ds, scale=args.scale, seed=123, feat_snr=snr,
                                        graph_kind=args.graph_kind, sbm_p_intra=p_intra)
                    log(f"{ds} x{args.scale} ({args.graph_kind}): "
                        f"V={data.csr.num_nodes} E={data.csr.nnz} "
                        f"snr={snr} lr={lr} p_intra={p_intra}")
                cfg = TrainConfig(
                    dataset=ds, model=model, epochs=args.epochs, lr=lr,
                    hidden_dim=args.hidden_dim, hidden_layers=args.hidden_layers,
                    nonlinear=nonlinear, maxk=k, seed=args.seed, data_scale=args.scale,
                    kernel_mode=kmode, compute_dtype=args.compute_dtype, feat_snr=snr,
                    device=args.device,
                )
                cfg.validate()
                state = train(cfg, data, logger=None, writer=None)
                ms = float(np.mean(state.epoch_times) * 1e3) if state.epoch_times else 0.0
                rec = {
                    "dataset": ds, "model": model, "arm": arm,
                    "best_val": round(state.best_val, 4),
                    "best_test": round(state.best_test, 4),
                    "epoch_ms": round(ms, 2),
                    # epoch_ms compares only on one device; accuracies anywhere
                    "device": device_name,
                    "feat_snr": snr, "lr": lr, "p_intra": p_intra,
                }
                results.append(rec)
                done.add((ds, model, arm))
                log(f"  {model}/{arm}: val {rec['best_val']} "
                    f"test {rec['best_test']} {ms:.1f} ms/ep")
                if args.json_out:
                    with open(args.json_out, "w") as f:
                        json.dump({"core_protocol": core_protocol, "results": results}, f,
                                  indent=1)

    doc = {
        "core_protocol": core_protocol,
        "protocol": {
            "feat_snr": args.feat_snr or "per-dataset (ACC_PROTOCOL)",
            "lr": args.lr or "per-dataset (ACC_PROTOCOL)",
            "graph_kind": args.graph_kind, "scale": args.scale,
            "epochs": args.epochs, "hidden_dim": args.hidden_dim,
            "hidden_layers": args.hidden_layers, "seed": args.seed,
            "datasets": args.datasets, "models": args.models,
            "device": device_name,
            "relu_lib": f"relu on --lib_mode {args.lib_mode}: on an H100 tiles_scan is "
                        "1.33-1.63x segsum's SpMM (PERF.md), so speedup_vs_lib_pct is an "
                        "upper bound",
        },
        "results": results,
        "vs_relu": summarize(results, args.datasets, args.models),
    }
    print(json.dumps(doc))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(doc, f, indent=1)
    return results


if __name__ == "__main__":
    main()
