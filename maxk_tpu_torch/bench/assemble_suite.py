"""Merge per-graph kernel_bench JSON outputs into one suite artifact.

Port of `maxk_tpu/bench/assemble_suite.py`. The suite runs one graph per
process (`kernel_bench --graphs G --json_out DIR/G.json`), so a failed
graph loses only itself; this stitches the survivors into one artifact
with a consistency audit and per-k geomean speedups split at average
degree 50 (the reference's claim boundary, its `README.md:136`).

Beside the reference's geomeans over the library arm (`t_baseline_ms`,
`tiles_scan` on a card), each summary row carries the geomeans over the
cuSPARSE yardstick (`t_cusparse_ms`, `t_cusparse_bf16_ms`: one
`torch.sparse.mm`); the bf16 one is null where any of its records has no
bf16 time (the CPU has no bf16 CSR product).

    python -m maxk_tpu_torch.bench.assemble_suite --dir DIR --out SUITE.json
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os


def _geomean(xs):
    return math.exp(sum(math.log(x) for x in xs) / len(xs))


def audit(records) -> list:
    """Recompute every derived field and check the timing invariants; one
    entry per violation (a unit bug in a patched record, a forward + backward
    faster than its forward)."""
    out = []
    for r in records:
        derived = r["E"] / (r["t_fwd_ms"] * 1e-3) / 1e9
        if abs(derived - r["fwd_gnnz_s"]) > 1e-6 * max(derived, 1e-12):
            out.append({"graph": r["graph"], "k": r["k"], "field": "fwd_gnnz_s",
                        "recorded": r["fwd_gnnz_s"], "recomputed": derived})
        speedups = [("speedup_vs_baseline", "t_baseline_ms")]
        if r.get("t_cusparse_ms") is not None:  # records from before the yardstick lack it
            speedups.append(("speedup_vs_cusparse", "t_cusparse_ms"))
        for field, base in speedups:
            sp = r[base] / r["t_fwd_ms"]
            if abs(sp - r[field]) > 1e-6 * sp:
                out.append({"graph": r["graph"], "k": r["k"], "field": field,
                            "recorded": r[field], "recomputed": sp})
        for fb, fw in (("t_fwd_bwd_ms", "t_fwd_ms"), ("t_fwd_bwd_cbsr_ms", "t_fwd_cbsr_ms")):
            if fb in r and fw in r and r[fb] < r[fw]:
                out.append({"graph": r["graph"], "k": r["k"], "field": fb,
                            "issue": f"{fb} < {fw} (forward cannot be free)",
                            "fwd_bwd_ms": r[fb], "fwd_ms": r[fw]})
    return out


def summarize(records) -> dict:
    """Geomean speedups per k, split at average degree 50: over the library
    arm in f32 and bf16 (the reference's keys), and over the cuSPARSE
    yardstick in f32 and bf16 (null where a record lacks the time)."""
    summary = {}
    for k in sorted({r["k"] for r in records}):
        for hi in (True, False):
            rows = [r for r in records if r["k"] == k and (r["E"] / max(r["V"], 1) > 50) == hi]
            if not rows:
                continue
            row = {
                "n_graphs": len(rows),
                "geomean_speedup_f32_baseline": round(
                    _geomean([r["speedup_vs_baseline"] for r in rows]), 3),
                "geomean_speedup_bf16_baseline": round(
                    _geomean([r["t_baseline_bf16_ms"] / r["t_fwd_ms"] for r in rows]), 3),
            }
            for tag, field in (("f32", "t_cusparse_ms"), ("bf16", "t_cusparse_bf16_ms")):
                times = [r.get(field) for r in rows]
                row[f"geomean_speedup_{tag}_cusparse"] = None if None in times else round(
                    _geomean([t / r["t_fwd_ms"] for t, r in zip(times, rows)]), 3)
            summary[f"k={k} avg_deg{'>' if hi else '<='}50"] = row
    return summary


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--note", default="")
    args = p.parse_args(argv)

    records = []
    for path in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
        with open(path) as f:
            records.extend(json.load(f))
    # auxiliary per-graph records (dispatch_check) summarize separately
    checks = [r for r in records if r.get("kind") == "dispatch_check"]
    records = [r for r in records if "k" in r]
    inconsistencies = audit(records)

    out = {
        "protocol": {
            "dim_origin": 256,
            "timing": "micro.timeit: 2 warm-up + 4 timed calls, CUDA events on a card",
            "baseline": {
                "geomean_speedup_*_baseline": "t_baseline*_ms: the library arm "
                "(tiles_scan on a card, segsum on the CPU; cusparse_role)",
                "geomean_speedup_*_cusparse": "t_cusparse*_ms: torch.sparse.mm on a CSR "
                "tensor of the same graph (cuSPARSE on a card), the yardstick",
            },
            "validated": all(r.get("valid", False) for r in records),
            "dispatch_checks": len(checks),
            "dispatch_picked_faster_everywhere": all(
                c["picked_faster"] for c in checks
            ) if checks else None,
            "note": args.note,
        },
        "consistency": {
            "ok": not inconsistencies,
            "checks": ["fwd_gnnz_s == E/t_fwd", "speedup == t_base/t_fwd",
                       "t_fwd_bwd >= t_fwd (both arms)"],
            "checks_cusparse": ["speedup_vs_cusparse == t_cusparse/t_fwd"],
            "violations": inconsistencies,
        },
        "summary": summarize(records),
        "results": records,
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}: {len(records)} records, "
          f"validated={out['protocol']['validated']}, "
          f"consistent={not inconsistencies}")
    return out


if __name__ == "__main__":
    main()
