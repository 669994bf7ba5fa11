"""Merge per-graph SpGEMM-study JSON outputs into one artifact.

Port of `maxk_tpu/bench/assemble_study.py`. The study runs one graph per
process (`spgemm_study --graph G --json_out DIR/G.json`); this stitches
the survivors into one artifact with a per-(graph, sparsity) winner table,
the role of the reference study's cross-strategy rows
(`spgemm_comparison_test_2.cu:348-409`).

    python -m maxk_tpu_torch.bench.assemble_study --dir DIR --out STUDY.json
"""

from __future__ import annotations

import argparse
import glob
import json
import os

ARMS = ("segsum_topk", "dense_topk", "cbsr_fused", "hybrid_topk")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--note", default="")
    args = p.parse_args(argv)

    graphs = []
    for path in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
        with open(path) as f:
            try:
                graphs.append(json.load(f))
            except json.JSONDecodeError:
                print(f"skip unparsable {path}")

    winners = []
    for g in graphs:
        for row in g["results"]:
            present = [a for a in ARMS if a in row]
            best = min(present, key=lambda a: row[a]["total_ms"])
            lib = row.get("segsum_topk", {}).get("total_ms")
            winners.append({
                "graph": g["graph"],
                "sparsity": row["sparsity"],
                "k": row["k"],
                "best_arm": best,
                "best_ms": round(row[best]["total_ms"], 3),
                "speedup_vs_library": (
                    round(lib / row[best]["total_ms"], 3) if lib else None
                ),
            })

    out = {
        "protocol": {
            "sparsities": [0.5, 0.25, 0.125, 0.0625],
            "dim": 256,
            "output_format": "row-wise top-k CBSR (output-sparse)",
            "phases": "symbolic (top-k threshold) / numeric (values)",
            "note": args.note,
        },
        "winners": winners,
        "graphs": graphs,
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}: {len(graphs)} graphs, {len(winners)} winner rows")
    return out


if __name__ == "__main__":
    main()
