"""Figures from the campaign scripts' JSON — port of `maxk_tpu/bench/plots.py`.

The role of the reference's plot scripts (`plotgnn.py`, `plot_gnn2.py`,
`gnnaia_plot*.py`), which embed measured tables; here each figure renders
from a script's JSON, with matplotlib's Agg backend (no display). Where a
record carries the cuSPARSE yardstick (`speedup_vs_cusparse`,
`cusparse_ms`), the figure shows it beside the library arm.

    python -m maxk_tpu_torch.bench.plots --kernel kernel_bench.json --out figs/
"""

from __future__ import annotations

import argparse
import json
import os


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, out_dir, name):
    path = os.path.join(out_dir, name)
    fig.savefig(path, dpi=120)
    _plt().close(fig)
    return path


def plot_kernel_bench(records, out_dir):
    """Per graph and k: speedup over the library arm, over cuSPARSE where
    recorded, and forward Gnnz/s."""
    plt = _plt()
    records = [r for r in records if "k" in r]
    graphs = sorted({r["graph"] for r in records})
    ks = sorted({r["k"] for r in records})
    panels = [("speedup_vs_baseline", "speedup vs library arm")]
    if any(r.get("speedup_vs_cusparse") for r in records):
        panels.append(("speedup_vs_cusparse", "speedup vs cuSPARSE (torch.sparse.mm)"))
    panels.append(("fwd_gnnz_s", "fwd Gnnz/s"))
    fig, axes = plt.subplots(1, len(panels), figsize=(5.5 * len(panels), 4))
    width = 0.8 / max(len(ks), 1)
    for i, k in enumerate(ks):
        for ax, (field, _) in zip(axes, panels):
            xs, ys = [], []
            for gi, g in enumerate(graphs):
                rec = next((r for r in records if r["graph"] == g and r["k"] == k), None)
                if rec and rec.get(field) is not None:
                    xs.append(gi + i * width)
                    ys.append(rec[field])
            ax.bar(xs, ys, width=width, label=f"k={k}")
    for ax, (field, title) in zip(axes, panels):
        ax.set_xticks(range(len(graphs)))
        ax.set_xticklabels(graphs, rotation=20)
        ax.set_title(title)
        ax.legend()
        ax.axhline(1.0 if field.startswith("speedup") else 0, color="k", lw=0.5)
    fig.tight_layout()
    return _save(fig, out_dir, "kernel_bench.png")


def plot_degree_sweep(data, out_dir):
    """Speedup against average degree, coloured by the dispatched arm, with
    the reference's avg-deg-50 boundary; hollow markers: over cuSPARSE."""
    plt = _plt()
    records = data["results"] if isinstance(data, dict) else data
    records = [r for r in records if "k" in r]
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for mode, marker in (("hybrid", "o"), ("tiles_scan", "s"), ("segsum", "^")):
        rows = [r for r in records if r["mode"] == mode]
        if not rows:
            continue
        deg = [r["E"] / max(r["V"], 1) for r in rows]
        pts = ax.scatter(deg, [r["speedup_vs_baseline"] for r in rows], marker=marker,
                         label=f"dispatched: {mode} (vs library)", alpha=0.8)
        cus = [(dg, r["speedup_vs_cusparse"]) for dg, r in zip(deg, rows)
               if r.get("speedup_vs_cusparse")]
        if cus:
            ax.scatter([c[0] for c in cus], [c[1] for c in cus], marker=marker,
                       facecolors="none", edgecolors=pts.get_facecolor()[0],
                       label=f"dispatched: {mode} (vs cuSPARSE)")
    ax.axvline(50, color="k", lw=0.8, ls="--", label="avg deg = 50")
    ax.axhline(1.0, color="k", lw=0.5)
    ax.set_xscale("log")
    ax.set_xlabel("average degree (E/V)")
    ax.set_ylabel("forward speedup")
    ax.set_title("degree-axis sweep (24-graph-suite analog)")
    ax.legend(fontsize=7)
    fig.tight_layout()
    return _save(fig, out_dir, "degree_sweep.png")


def plot_ksweep(data, out_dir):
    """k against accuracy and epoch time, the relu arms as reference lines
    (the figure `plotgnn.py:26-39` hard-codes)."""
    plt = _plt()
    rows = data["results"]
    pairs = sorted({(r["dataset"], r["model"]) for r in rows})
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    for ds, model in pairs:
        sub = [r for r in rows if r["dataset"] == ds and r["model"] == model]
        relu = next((r for r in sub if r["arm"] == "relu"), None)
        relu_lib = next((r for r in sub if r["arm"] == "relu_lib"), None)
        ks = sorted(int(r["arm"].split("maxk_k")[1]) for r in sub
                    if r["arm"].startswith("maxk_k"))
        acc = [next(r["best_test"] for r in sub if r["arm"] == f"maxk_k{k}") for k in ks]
        ms = [next(r["epoch_ms"] for r in sub if r["arm"] == f"maxk_k{k}") for k in ks]
        (ln,) = axes[0].plot(ks, acc, "o-", label=f"{ds}/{model}")
        axes[1].plot(ks, ms, "o-", color=ln.get_color(), label=f"{ds}/{model}")
        if relu:
            axes[0].axhline(relu["best_test"], color=ln.get_color(), ls="--", lw=0.8)
            axes[1].axhline(relu["epoch_ms"], color=ln.get_color(), ls="--", lw=0.8)
        if relu_lib:
            axes[1].axhline(relu_lib["epoch_ms"], color=ln.get_color(), ls=":", lw=1.2)
    for ax, yl in zip(axes, ["best test accuracy", "epoch ms"]):
        ax.set_xscale("log", base=2)
        ax.set_xlabel("k")
        ax.set_ylabel(yl + " (dashed = relu, dotted = relu_lib)")
        ax.legend(fontsize=8)
    fig.tight_layout()
    return _save(fig, out_dir, "ksweep.png")


def plot_scaling(data, out_dir):
    """Sharded step time against rank count, per arm."""
    plt = _plt()
    rows = data["results"]
    fig, ax = plt.subplots(figsize=(6, 4))
    for arm in sorted({r["arm"] for r in rows}):
        sub = sorted((r["n"], r["step_ms"]) for r in rows if r["arm"] == arm)
        ax.plot([n for n, _ in sub], [m for _, m in sub], "o-", label=arm)
    ax.set_xlabel("ranks")
    ax.set_ylabel("step ms")
    ax.set_xscale("log", base=2)
    proto = data.get("protocol", {})
    ax.set_title(f"sharded step scaling ({proto.get('device', proto.get('platform', ''))})")
    ax.legend()
    fig.tight_layout()
    return _save(fig, out_dir, "scaling.png")


def plot_spgemm_study(data, out_dir):
    """Phase-stacked strategy times per sparsity (a study dict or a list of
    them), the role of the reference's AIA study figures."""
    plt = _plt()
    studies = data if isinstance(data, list) else [data]
    fig, axes = plt.subplots(1, len(studies), figsize=(5.5 * len(studies), 4), squeeze=False)
    phases = ["densify_ms", "numeric_ms", "symbolic_ms"]
    for ax, study in zip(axes[0], studies):
        recs = study["results"]
        arms = sorted(a for a in recs[0] if isinstance(recs[0][a], dict))
        if not arms:
            # flat format: arm times as top-level `<arm>_ms` floats
            arms = sorted(a[:-3] for a in recs[0]
                          if a.endswith("_ms") and isinstance(recs[0][a], float))
            recs = [{**r, **{a: {"numeric_ms": r[f"{a}_ms"]} for a in arms}} for r in recs]
        width = 0.8 / len(arms)
        for i, arm in enumerate(arms):
            xs = [j + i * width for j in range(len(recs))]
            bottom = [0.0] * len(recs)
            for ph in phases:
                hs = [r[arm].get(ph, 0.0) for r in recs]
                if not any(hs):
                    continue
                ax.bar(xs, hs, width=width, bottom=bottom,
                       label=f"{arm}:{ph[:-3]}" if ph != "numeric_ms" else arm)
                bottom = [b + h for b, h in zip(bottom, hs)]
        ax.set_xticks(range(len(recs)))
        ax.set_xticklabels([f"s={r['sparsity']}" for r in recs])
        ax.set_ylabel("ms (stacked phases)")
        ax.set_title(f"{study['graph']} V={study['V']} E={study['E']}")
        ax.legend(fontsize=6)
    fig.tight_layout()
    return _save(fig, out_dir, "spgemm_study.png")


def plot_three_arms(data, out_dir):
    """Forward ms of the schedules per graph on the same bf16 input, with
    the cuSPARSE yardstick where recorded."""
    plt = _plt()
    records = data["results"] if isinstance(data, dict) else data
    arms = ["hybrid", "tiles_scan", "bricks", "cusparse"]
    graphs = [r["graph"] for r in records]
    fig, ax = plt.subplots(figsize=(6.5, 4))
    width = 0.8 / len(arms)
    for i, arm in enumerate(arms):
        xs, ms = [], []
        for gi, r in enumerate(records):
            if f"{arm}_ms" in r:
                xs.append(gi + i * width)
                ms.append(r[f"{arm}_ms"])
        if xs:
            ax.bar(xs, ms, width=width, label=arm if arm != "cusparse" else "cuSPARSE (yardstick)")
    ax.set_xticks(range(len(graphs)))
    ax.set_xticklabels(graphs, rotation=20)
    ax.set_ylabel("fwd ms (same bf16 input)")
    ax.set_title("independent SpMM schedules")
    ax.legend()
    fig.tight_layout()
    return _save(fig, out_dir, "three_arms.png")


def plot_training_curves(scalars_jsonl, out_dir, tag="val_acc"):
    """One scalar of a run's `scalars.jsonl` against the epoch."""
    plt = _plt()
    steps, vals = [], []
    with open(scalars_jsonl) as f:
        for line in f:
            rec = json.loads(line)
            if rec["tag"] == tag:
                steps.append(rec["step"])
                vals.append(rec["value"])
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(steps, vals)
    ax.set_xlabel("epoch")
    ax.set_ylabel(tag)
    fig.tight_layout()
    return _save(fig, out_dir, f"train_{tag}.png")


def main(argv=None) -> list:
    p = argparse.ArgumentParser()
    p.add_argument("--kernel", default="")
    p.add_argument("--degree", default="")
    p.add_argument("--ksweep", default="")
    p.add_argument("--scaling", default="")
    p.add_argument("--study", default="")
    p.add_argument("--three_arms", default="")
    p.add_argument("--scalars", default="")
    p.add_argument("--out", default="figs")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    def load(path):
        with open(path) as f:
            return json.load(f)

    paths = []
    if args.kernel:
        data = load(args.kernel)
        # assembled suites wrap the record list in {results: ...}
        paths.append(plot_kernel_bench(data["results"] if isinstance(data, dict) else data,
                                       args.out))
    for arg, fn in ((args.degree, plot_degree_sweep), (args.ksweep, plot_ksweep),
                    (args.scaling, plot_scaling), (args.study, plot_spgemm_study),
                    (args.three_arms, plot_three_arms)):
        if arg:
            paths.append(fn(load(arg), args.out))
    if args.scalars:
        paths.append(plot_training_curves(args.scalars, args.out))
    for path in paths:
        print(path)
    return paths


if __name__ == "__main__":
    main()
