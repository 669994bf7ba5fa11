"""The readings that the limits of `checks.py` are set from, over many seeds.

    python3 -m portbench.calibrate --workload <cell> --seeds <n> [<n> ...] [--out FILE]

For each seed, in one process on the card: the cell's inputs (the graph drawn
once a process, as every run draws the same one); the program's state from
`loop.setup` (one graph build a seed, shared by the variants through
`program.fresh_state`); then the numbers of `checks.gaps` against the float32
reference for
  sound         the program as a benchmark run drives it,
  control_tf32  the reference itself with TF32 on (the next precision down),
  and each fault of `program.FAULTS` that the cell can have, planted in the
  program (`no_exchange` on several cards only).
A cell on several cards runs on as many ranks, one process a card
(`ranks.spawn`), as a benchmark run does; the graph blocks are built once
(`parallel.train.sharded_setup`, first seed) and shared by every seed and
variant through `program.fresh_sharded_state`; rank 0 prints the lines.
Each variant's numbers are judged by
`checks.judge` against the cell's limits as its workload file has them
(`judged`). One JSON line a seed on standard output (and appended to FILE).
The benchmark's runs never run this.

    python3 -m portbench.calibrate --derive FILE [FILE ...]

reads such lines (on any machine) and prints, for each cell and number, the
lower reading (the largest of the sound runs), the upper one (the smallest
that the control gives where that is three times the lower or more, or that
a fault gives where that is ten times the lower or more, three for
`unchanged`) and the limit between them, lower^0.4 · upper^0.6: more room
above the lower than below the upper; then, for each variant, how many of
its readings `checks.judge` finds correct under those limits.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import sys
import time

import torch

from portbench import checks, gen, registry
from portbench.run import dropout_seed


def readings(cell: str, seed: int, device: str = "cuda", sizes=None,
             variants=("sound", "unchanged", "half_batch", "altered_rows"),
             details: bool = False, graph=None) -> dict:
    from portbench import program

    _, traffic, config = registry.cell(cell)
    config = {**config, **(sizes or {})}
    ref = registry.reference(config)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inputs = gen.make_inputs(config, ref.parameters(config), seed, device, graph)
    dseed = dropout_seed(seed)
    steps = traffic["check_steps"]
    cfg = program.train_config(config, traffic, device, dseed)
    data = program.graph_data(config, inputs)
    state, build_s = program.setup_state(cfg, data)
    graph = state.graph
    runs = {}
    for variant in variants:
        st = state if variant == "sound" else program.fresh_state(cfg, data, graph)
        fault = variant if variant in program.FAULTS else None
        runs[variant] = program.Program(st, data, inputs.weights, fault).follow(steps)
        del st
        gc.collect()
    del state, graph, data
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    base = ref.follow(inputs, config, traffic, dseed, steps)
    ref_s = time.perf_counter() - t0
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        runs[CONTROL] = ref.follow(inputs, config, traffic, dseed, steps)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return line(cell, seed, inputs.num_edges, build_s, ref_s, runs, base, traffic["limits"],
                details)


def line(cell, seed, live_edges, build_s, ref_s, runs, base, limits, details=False) -> dict:
    """A seed's line: each variant's numbers against the reference's
    readings `base`, and `checks.judge`'s verdict on them under `limits`."""
    out = {"cell": cell, "seed": seed, "live_edges": live_edges, "build_graph_s": build_s,
           "reference_s": ref_s}
    for name, r in runs.items():
        out[name] = checks.gaps(r, base)
        if details:
            out.setdefault("detail", {})[name] = checks.detail(r, base)
    out["judged"] = {name: checks.judge(out[name], limits)[0] for name in runs}
    out["losses"] = {"reference": base["losses"], "sound": runs["sound"]["losses"]} \
        if "sound" in runs else {"reference": base["losses"]}
    return out


def sharded_readings(mesh, job: dict) -> list:
    """`readings`' lines for each of `job["seeds"]`, on this rank's part of
    a row-partitioned run; rank 0 prints them (and appends them to
    `job["out"]`) as they come and returns them."""
    from portbench import program, ranks

    _, traffic, config = registry.cell(job["cell"])
    config = {**config, **(job["sizes"] or {})}
    ref = registry.reference(config)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, rank, world = mesh.device, mesh.rank, mesh.world_size
    steps = traffic["check_steps"]
    graph = tuple(t.cpu() for t in gen.make_graph(config, dev))  # the device keeps no copy
    built, lines = None, []
    for seed in job["seeds"]:
        inputs = gen.make_inputs(config, ref.parameters(config), seed, dev, graph)
        ranks.same_inputs(inputs, mesh)
        host = ranks.on_host(inputs)
        del inputs
        ranks.release(dev)
        dseed = dropout_seed(seed)
        cfg = program.train_config(config, traffic, dev.type, dseed)
        data = program.host_graph_data(config, host)
        if built is None:
            state, build_s = program.sharded_setup_state(cfg, data, mesh)
            built = state
        else:
            state, build_s = program.fresh_sharded_state(cfg, data, built), 0.0
        runs = {}
        for variant in job["variants"]:
            st = state if variant == "sound" else program.fresh_sharded_state(cfg, data, built)
            fault = variant if variant in program.FAULTS else None
            runs[variant] = program.ShardedProgram(st, data, host.weights, fault).follow(steps)
            del st
            ranks.release(dev)
        # keep the graph blocks alone for the next seeds, as a benchmark run
        # frees the program before its reference
        built = dataclasses.replace(built, model=None, optimizer=None, generator=None,
                                    feats=None, labels=None, masks=())
        del state, data
        ranks.release(dev)
        t0 = time.perf_counter()
        base = ref.follow(host, config, traffic, dseed, steps, rank, world)
        ref_s = time.perf_counter() - t0
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            runs[CONTROL] = ref.follow(host, config, traffic, dseed, steps, rank, world)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        ranks.release(dev)
        if rank == 0:
            out = line(job["cell"], seed, host.num_edges, build_s, ref_s, runs, base,
                       traffic["limits"], job["details"])
            _emit(out, job["out"])
            lines.append(out)
    return lines


def _emit(out: dict, path: str) -> None:
    text = json.dumps(out)
    print(text, flush=True)
    if path:
        with open(path, "a") as f:
            f.write(text + "\n")


CONTROL = "control_tf32"
CALIBRATE_DEADLINE_S = 3300.0
FAULT_FACTOR = {"unchanged": 3.0, "half_batch": 10.0, "altered_rows": 10.0,
                "no_exchange": 10.0}


def derive(lines: list) -> dict:
    """{cell: {number: {lower, upper, upper_from, limit, seeds}}} from
    `readings` lines; a line may hold `sound` alone (a benchmark run's
    `checks`), which counts towards the lower reading."""
    out = {}
    for cell in sorted({r["cell"] for r in lines}):
        rows = [r for r in lines if r["cell"] == cell]
        out[cell] = {}
        for n in checks.NUMBERS:
            lower = max(r["sound"][n] for r in rows)
            cands = {}
            for variant, factor in {CONTROL: 3.0, **FAULT_FACTOR}.items():
                low = min((r[variant][n] for r in rows if variant in r), default=None)
                if low is not None and low >= factor * lower:
                    cands[variant] = low
            entry = {"lower": lower, "seeds": len(rows), "upper": None, "upper_from": None,
                     "limit": None}
            if cands and lower > 0:
                src = min(cands, key=cands.get)
                upper = cands[src]
                exp = math.floor(math.log10(lower**0.4 * upper**0.6)) - 1
                mantissa = math.floor(lower**0.4 * upper**0.6 / 10**exp)
                entry.update(upper=upper, upper_from=src, limit=float(f"{mantissa}e{exp}"))
            out[cell][n] = entry
        limits = {n: e["limit"] for n, e in out[cell].items() if e["limit"] is not None}
        out[cell]["judged"] = {
            variant: {"correct": sum(checks.judge(r[variant], limits)[0] for r in rows
                                     if variant in r),
                      "of": sum(variant in r for r in rows)}
            for variant in ("sound", CONTROL, *FAULT_FACTOR)} if limits else {}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload")
    p.add_argument("--seeds", type=int, nargs="+")
    p.add_argument("--out", default="")
    p.add_argument("--derive", nargs="+", default=[])
    p.add_argument("--variants", nargs="+",
                   help="program runs besides the control (sound first; default: sound and "
                        "every fault the cell can have)")
    p.add_argument("--detail", action="store_true",
                   help="add each step's loss gap and each leaf's gaps (every variant)")
    args = p.parse_args(argv)
    if args.derive:
        lines = [json.loads(x) for f in args.derive for x in open(f) if x.strip()]
        print(json.dumps(derive(lines), indent=1))
        return 0
    if not args.workload or not args.seeds:
        p.error("--workload and --seeds, or --derive")
    entry, _, config = registry.cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < entry["chips"]:
        print(f"calibrate: {args.workload} needs {entry['chips']} CUDA card(s), found {have}",
              file=sys.stderr)
        return 2
    variants = args.variants or variants_of(entry["chips"])
    if entry["chips"] > 1:
        from portbench import ranks

        job = {"cell": args.workload, "seeds": args.seeds, "variants": variants,
               "details": args.detail, "sizes": None, "out": args.out}
        ranks.spawn(sharded_readings, entry["chips"], job, "cuda", deadline_s=CALIBRATE_DEADLINE_S)
        return 0
    graph = gen.make_graph(config, "cuda")
    for seed in args.seeds:
        _emit(readings(args.workload, seed, variants=tuple(variants), details=args.detail,
                       graph=graph), args.out)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


def variants_of(chips: int) -> list:
    """The sound program and every fault that a cell on `chips` cards can have."""
    from portbench import program

    return ["sound"] + [f for f in program.FAULTS if chips > 1 or f not in program.SHARDED_FAULTS]


if __name__ == "__main__":
    sys.exit(main())
