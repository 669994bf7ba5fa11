"""One run of one cell of the benchmark of maxk_tpu_torch.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with a CUDA card. The run makes
the cell's inputs and initial weights on the card from `--seed`
(`portbench/gen.py`), sets up the program (`maxk_tpu_torch.train.loop.setup`,
the weights loaded into its model), drives its first `check_steps` epochs
(which warm up every shape the window uses, and whose readings the check
compares), then runs whole epochs for `--seconds` (`--trace 0`: the
end-to-end metrics) or `trace_epochs` epochs under the profiler (`--trace
1`: the per-layer metrics). After the window it reads the memory peak, frees
the program, runs the plain reference over the same first epochs and judges
the program's readings against it (`portbench/checks.py`). The last lines
on standard error are the numbers compared beside their limits; the last
line on standard output is the result.

A cell whose `chips` in `BENCHMARK.json` is above 1 runs on that many
cards, one process a card, through the program's row-partitioned path
(`portbench/ranks.py`); this process spawns the ranks and prints the result.

It exits 2, printing no result, without enough CUDA cards, and 3 if jax,
jaxlib, flax or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from portbench import checks, gen, registry, trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "maxk_tpu")


class ForbiddenModules(RuntimeError):
    pass


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def dropout_seed(seed: int) -> int:
    """The seed of the dropout generator, apart from the inputs' stream."""
    return (seed * 0x9E3779B97F4A7C15 + 0x632BE59BD9B4E019) % 2**63


def forbidden_modules() -> list:
    """The forbidden top-level names that `sys.modules` holds, compared
    whole (`maxk_tpu_torch` is not `maxk_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def epoch_ms_p95(stamps):
    """The 95th percentile of every epoch's host ms (start to loss read);
    None under two epochs."""
    per_epoch = [1e3 * (st[3] - st[0]) for st in stamps]
    return statistics.quantiles(per_epoch, n=20)[18] if len(per_epoch) >= 2 else None


def power_limit() -> str:
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30)
        return proc.stdout.strip().splitlines()[0] if proc.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def run(cell: str, seed: int, seconds: float, trace_on: bool, device: str = "cuda",
        fault=None, sizes=None, world=None) -> dict:
    """The result of one run. `sizes` overrides configuration sizes and
    `world` the cell's card count (the CPU tests); `fault` plants one of
    `program.FAULTS`."""
    entry, traffic, config = registry.cell(cell)
    world = entry["chips"] if world is None else world
    if world > 1:
        from portbench import ranks

        return ranks.run(cell, world, seed, seconds, trace_on, device, fault, sizes, _START)
    config = {**config, **(sizes or {})}
    ref = registry.reference(config)
    cuda = torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from portbench import program

    inputs = gen.make_inputs(config, ref.parameters(config), seed, device)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    dseed = dropout_seed(seed)
    cfg = program.train_config(config, traffic, device, dseed,
                               "bfloat16" if traffic["compute_dtype"] == "bfloat16" else "")
    data = program.graph_data(config, inputs)
    state, build_s = program.setup_state(cfg, data)
    prog = program.Program(state, data, inputs.weights, fault)
    log(f"portbench: {cell} seed {seed}: V {inputs.num_nodes}, live edges {inputs.num_edges}, "
        f"kernel_mode {cfg.kernel_mode} resolves to {prog.resolved_mode()}, "
        f"build_graph {build_s:.3f} s")
    steps = traffic["check_steps"]
    readings = prog.follow(steps)
    setup_s = time.perf_counter() - _START

    values = {"setup_s": setup_s}
    if trace_on:
        record, stamps, losses = trace.traced(prog, traffic["trace_epochs"], cuda)
    else:
        stamps, losses = [], []
        w0 = time.perf_counter()
        while True:
            loss, _, st = prog.epoch()
            stamps.append(st)
            losses.append(loss)
            if st[3] - w0 >= seconds and len(stamps) >= 2:
                break
        values["epoch_ms"] = 1e3 * (stamps[-1][3] - w0) / len(stamps)
        values["epoch_ms_p95"] = epoch_ms_p95(stamps)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    values["peak_mem_gib"] = peak / 2**30
    bad = forbidden_modules()
    if bad:
        raise ForbiddenModules(f"loaded once the window closed: {bad}")
    del prog, state, data
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ref_readings = ref.follow(inputs, config, traffic, dseed, steps)
    numbers = checks.gaps(readings, ref_readings)
    ok, table = checks.judge(numbers, traffic["limits"])
    for name in sorted(set(numbers) - set(table)):
        log(f"portbench: {name} {numbers[name]} (read, not compared)")
    bad = forbidden_modules()
    if bad:
        raise ForbiddenModules(f"loaded by the check: {bad}")

    metrics = {}
    if trace_on:
        rec = {"stamps": stamps, "trace": record, "config": config, "traffic": traffic,
               "num_nodes": inputs.num_nodes, "live_edges": inputs.num_edges,
               "build_graph_s": build_s, "chips": 1}
        for m in registry.metrics("per_layer", cell):
            value = registry.reader(m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in registry.metrics("end_to_end", cell):
            if values.get(m["name"]) is None:
                raise RuntimeError(f"{cell}: no reading of {m['name']} "
                                   f"({len(stamps)} epochs in the window)")
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": ok, "attempted": len(losses),
              "failed": sum(not math.isfinite(x) for x in losses),
              "metrics": metrics, "device": dev}
    if trace_on:
        dev["busy_s"], dev["window_s"] = record["busy_s"], record["window_s"]
        result["breakdown"] = trace.breakdown(record)
    result["checks"] = {n: {"value": _finite(v["value"]), "limit": v["limit"]}
                        for n, v in table.items()}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    entry = registry.cell(args.workload)[0]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < entry["chips"]:
        log(f"portbench: {args.workload} needs {entry['chips']} CUDA card(s), this machine "
            f"has {have}")
        return 2
    try:
        result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    except ForbiddenModules as e:
        log(f"portbench: {e}")
        return 3
    log(f"portbench: card {power_limit()}")
    for name, v in result["checks"].items():
        log(f"check {name} {v['value']} limit {v['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
