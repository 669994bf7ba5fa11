"""Degree-axis kernel sweep — port of `maxk_tpu/bench/degree_sweep.py`.

The reference benchmarks 24 graphs across the degree spectrum
(`kernels/main.cu:196-218`) and conditions its headline speedups on
average degree > 50 (`README.md:136`). This script sweeps the same V ×
degree grid of R-MAT graphs (`rmat_v<V>_d<deg>`,
`kernel_bench.load_suite`) on both sides of that boundary, with
`--dispatch_check`, so every graph records whether AUTO's
`hybrid_profitable` picked the faster arm, and `--validate`, so every
timing is held against the plain path.

Each graph runs `python -m maxk_tpu_torch.bench.kernel_bench` in its own
subprocess under `--timeout`: a graph that fails costs its own timeout,
not the sweep, and is listed under `failed`. Per-graph JSONs accumulate in
`--dir` (a graph whose file exists is skipped); the artifact is assembled
by `assemble_suite` with the degree-50 split and the cuSPARSE yardstick.
The graphs are the port's host `rmat_graph` (recorded as `generator`);
the reference draws on the device, zeroing duplicate edges instead of
removing them, so its instances differ.

    python -m maxk_tpu_torch.bench.degree_sweep --out DEGREE_SWEEP.json
    python -m maxk_tpu_torch.bench.degree_sweep --device cpu --scale 0.002 ...
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

# V × avg-degree grid: crosses the avg-deg-50 dispatch boundary at two
# node scales (reddit-scale 256K and 1M); degrees 5..400
DEFAULT_GRAPHS = [
    "rmat_v262144_d5",
    "rmat_v262144_d15",
    "rmat_v262144_d50",
    "rmat_v262144_d150",
    "rmat_v262144_d400",
    "rmat_v1048576_d15",
    "rmat_v1048576_d50",
    "rmat_v1048576_d120",
]
GENERATOR = "host rmat_graph"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> dict:
    from maxk_tpu_torch.bench import assemble_suite
    from maxk_tpu_torch.train.loop import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--graphs", nargs="+", default=DEFAULT_GRAPHS)
    p.add_argument("--k", nargs="+", default=["8", "64"])
    p.add_argument("--dir", default="degree_sweep")
    p.add_argument("--out", default="DEGREE_SWEEP.json")
    p.add_argument("--timeout", type=int, default=2400, help="per graph")
    p.add_argument("--mode", default="auto")
    p.add_argument("--no_validate", action="store_true")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--device", default="cuda", help="forwarded to kernel_bench")
    args = p.parse_args(argv)
    resolve_device(args.device)  # no card: raise here, not in every child

    os.makedirs(args.dir, exist_ok=True)
    # the children import this package from where this one was found
    root = str(Path(__file__).resolve().parents[2])
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [root] + [q for q in os.environ.get("PYTHONPATH", "").split(os.pathsep) if q])}
    failed = []
    for g in args.graphs:
        out = os.path.join(args.dir, f"{g}.json")
        if os.path.exists(out):
            log(f"skip {g}: {out} exists")
            continue
        cmd = [
            sys.executable, "-m", "maxk_tpu_torch.bench.kernel_bench",
            "--graphs", g, "--k", *args.k,
            "--scale", str(args.scale), "--mode", args.mode,
            "--dispatch_check", "--json_out", out, "--device", args.device,
        ]
        if not args.no_validate:
            cmd.append("--validate")
        log(f"=== {g} (timeout {args.timeout}s)")
        try:
            rc = subprocess.run(cmd, timeout=args.timeout, stdout=sys.stderr,
                                env=env).returncode
        except subprocess.TimeoutExpired:
            rc = -1
        if rc != 0:
            failed.append({"graph": g, "rc": rc})
            log(f"FAILED {g} rc={rc}")
            # keep whatever records the incremental dump persisted

    with open(os.devnull, "w") as quiet:
        stdout, sys.stdout = sys.stdout, quiet
        try:
            doc = assemble_suite.main(["--dir", args.dir, "--out", args.out, "--note",
                                       "degree-axis R-MAT sweep (24-graph-suite analog)"])
        finally:
            sys.stdout = stdout
    doc["protocol"]["generator"] = GENERATOR
    doc["protocol"]["device"] = args.device
    if failed:
        doc["failed"] = failed
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    log(f"wrote {args.out} ({len(failed)} failures)")
    return doc


if __name__ == "__main__":
    main()
