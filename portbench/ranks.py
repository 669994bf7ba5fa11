"""A run of a cell on several cards: one process a card, rank r on `cuda:r`
(NCCL), or CPU ranks (gloo) in the tests.

`run` spawns one rank a card and puts their returns together into the result
that `run.run` gives for one card. Each rank (`rank_run`):

1. makes the inputs from the seed on its device (`gen.make_inputs`: the
   graph from the configuration's `graph.seed`, the rest from the run's
   seed, so every rank holds the same inputs; a fingerprint of them is
   compared over the ranks), keeps host copies, frees the device's, and
   meets the others at a barrier; the memory peak is reset after it;
2. sets up the program's row-partitioned path (`parallel.train.
   sharded_setup`, its `build_sharded_graph` timed as `build_graph_s`),
   loads the harness's weights and drives the check's first epochs;
3. runs the window: whole epochs until rank 0's clock passes `--seconds`.
   Rank 0 decides, and after each epoch tells the others with one
   broadcast of one integer on the device: the harness's own collective,
   not counted by the program's `ByteCounter`, tens of microseconds an
   epoch, inside `epoch_ms`. Ranks that decided apart would hang. With
   `--trace 1` every rank runs the cell's `trace_epochs` under the profiler
   (a fixed count: no broadcast), and rank 0's record gives the per-layer
   metrics;
4. reads its memory peak, frees the program, and runs the plain
   reference's row-partitioned `follow` (`reference/<name>.py`) on the same
   ranks; rank 0 judges the program's readings against it.

The parent waits for every rank under a deadline. A rank that fails, or a
run that outlasts the deadline, ends every rank, and no result is given.
Ranks die with the parent (`PR_SET_PDEATHSIG`). `setup_s` is taken on rank
0 from the parent's start: `time.perf_counter` is the system-wide
`CLOCK_MONOTONIC` on Linux, so the two processes read one clock.
"""

from __future__ import annotations

import ctypes
import gc
import math
import os
import signal
import socket
import sys
import time
import warnings

import torch
import torch.distributed as dist

from portbench import checks, gen, registry, trace

DEADLINE_S = 1100.0  # under the 1200 s that a checkout's first (compiling) run may take
PR_SET_PDEATHSIG = 1
STRIDE = 97  # of the inputs' entries that the fingerprint reads


def log(*parts) -> None:
    """One write a line, so that the ranks' lines do not interleave."""
    sys.stderr.write(" ".join(map(str, parts)) + "\n")
    sys.stderr.flush()


def _die_with_parent() -> None:
    try:
        ctypes.CDLL(None, use_errno=True).prctl(PR_SET_PDEATHSIG, signal.SIGKILL)
    except (OSError, AttributeError):
        pass


def _free_init_method() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def _main(rank, world, device_type, init_method, fn, job, queue, timeout_s):
    _die_with_parent()
    if device_type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    from portbench import program

    mesh = program.init_mesh(rank, world, device_type, init_method, timeout_s)
    try:
        out = fn(mesh, job)
    finally:
        program.destroy_mesh(mesh)
    queue.put((rank, out))


def spawn(fn, world: int, job: dict, device_type: str, deadline_s: float = DEADLINE_S) -> list:
    """`fn(mesh, job)` on `world` spawned ranks; their returns in rank
    order. Raises, every rank ended, where a rank fails or the deadline
    passes."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    init_method = _free_init_method()
    procs = [ctx.Process(target=_main, args=(r, world, device_type, init_method, fn, job, queue,
                                             deadline_s))
             for r in range(world)]
    for p in procs:
        p.start()
    results, end = {}, time.monotonic() + deadline_s
    try:
        while len(results) < world:
            while not queue.empty():  # before any join: a rank blocks in put() until read
                rank, out = queue.get()
                results[rank] = out
            failed = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(f"rank(s) failed (rank, exit code): {failed}")
            if len(results) < world and all(p.exitcode == 0 for p in procs) and queue.empty():
                raise RuntimeError(f"ranks {sorted(set(range(world)) - set(results))} ended "
                                   "without a result")
            if time.monotonic() > end:
                raise TimeoutError(f"{world} ranks outlasted {deadline_s} s")
            time.sleep(0.05)
        for p in procs:
            p.join(60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]


def _fingerprint(inputs) -> torch.Tensor:
    """Integers that differ where two ranks' inputs differ: the edge and node
    counts, and weighted sums of every STRIDE-th column, row pointer, label,
    mask entry and feature."""
    def weighted(t):
        t = t.flatten()[::STRIDE]
        w = torch.arange(t.numel(), device=t.device) % 1021 + 1
        if t.is_floating_point():
            return ((t.double() * w).sum() * 2**20).round().long()
        return (t.long() * w).sum()

    parts = [torch.tensor(inputs.num_edges), torch.tensor(inputs.num_nodes)]
    parts += [weighted(t) for t in (inputs.indices, inputs.indptr, inputs.labels,
                                    *inputs.masks, inputs.features)]
    return torch.stack([t.to(inputs.features.device) for t in parts])


def same_inputs(inputs, mesh) -> None:
    """Raise where the ranks' inputs differ."""
    mine = _fingerprint(inputs)
    every = torch.empty(mesh.world_size * mine.numel(), dtype=mine.dtype, device=mine.device)
    with warnings.catch_warnings():  # newer torch marks it deprecated; older lacks *_single
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(every, mine)
    every = every.view(mesh.world_size, -1)
    if not bool((every == mine).all()):
        raise RuntimeError(f"rank {mesh.rank}: the ranks made different inputs: {every.tolist()}")


def on_host(inputs):
    """`inputs` with its graph and node arrays on the CPU; the weights stay
    on their device."""
    cpu = {f: getattr(inputs, f).cpu() for f in ("indptr", "indices", "features", "labels")}
    return type(inputs)(masks=tuple(m.cpu() for m in inputs.masks), weights=inputs.weights,
                        **cpu)


def release(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def rank_run(mesh, job: dict) -> dict:
    """One rank's part of a run (the module's docstring); rank 0's return
    carries the readings, the check and the metrics."""
    from portbench import program, run

    cell, seed, seconds, trace_on = job["cell"], job["seed"], job["seconds"], job["trace"]
    _, traffic, config = registry.cell(cell)
    config = {**config, **(job["sizes"] or {})}
    ref = registry.reference(config)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, rank = mesh.device, mesh.rank
    cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    inputs = gen.make_inputs(config, ref.parameters(config), seed, dev)
    same_inputs(inputs, mesh)
    host = on_host(inputs)
    del inputs
    release(dev)
    dist.barrier()
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t1 = time.perf_counter()
    dseed = run.dropout_seed(seed)
    cfg = program.train_config(config, traffic, dev.type, dseed)
    data = program.host_graph_data(config, host)
    state, build_s = program.sharded_setup_state(cfg, data, mesh)
    prog = program.ShardedProgram(state, data, host.weights, job["fault"])
    t2 = time.perf_counter()
    if rank == 0:
        log(f"portbench: {cell} seed {seed}: {mesh.world_size} ranks ({mesh.backend}), "
            f"V {host.num_nodes}, live edges {host.num_edges}, Vs {state.graph.shard_nodes}, "
            f"rank 0's edges {state.graph.nnz}, kernel_mode {cfg.kernel_mode} resolves to "
            f"{prog.resolved_mode()}; inputs {t1 - t0:.3f} s, sharded_setup {t2 - t1:.3f} s "
            f"(build_sharded_graph {build_s:.3f} s)")
    steps = traffic["check_steps"]
    readings = prog.follow(steps)
    setup_s = time.perf_counter() - job["start"]
    if rank == 0:
        log(f"portbench: the check's {steps} epochs {time.perf_counter() - t2:.3f} s, "
            f"set-up {setup_s:.3f} s from the parent's start")

    values = {"setup_s": setup_s}
    record = None
    if trace_on:
        record, stamps, losses = trace.traced(prog, traffic["trace_epochs"], cuda)
    else:
        stamps, losses = [], []
        stop = torch.zeros(1, dtype=torch.int32, device=dev)
        w0 = time.perf_counter()
        while True:
            loss, _, st = prog.epoch()
            stamps.append(st)
            losses.append(loss)
            if rank == 0:
                stop.fill_(int(st[3] - w0 >= seconds and len(stamps) >= 2))
            dist.broadcast(stop, 0)
            if int(stop.item()):
                break
        values["epoch_ms"] = 1e3 * (stamps[-1][3] - w0) / len(stamps)
        values["epoch_ms_p95"] = run.epoch_ms_p95(stamps)
    comm = prog.comm_recv[-len(stamps):]
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    bad = run.forbidden_modules()
    if bad:
        raise run.ForbiddenModules(f"rank {rank}: loaded once the window closed: {bad}")
    del prog, state, data
    release(dev)

    t3 = time.perf_counter()
    ref_readings = ref.follow(host, config, traffic, dseed, steps, rank, mesh.world_size)
    log(f"portbench: rank {rank}: memory peak {peak / 2**30:.4f} GiB, {len(stamps)} epochs, "
        f"reference {time.perf_counter() - t3:.3f} s")
    out = {"peak": peak, "busy_s": record and record["busy_s"],
           "window_s": record and record["window_s"]}
    if rank != 0:
        return out
    numbers = checks.gaps(readings, ref_readings)
    ok, table = checks.judge(numbers, traffic["limits"])
    for name in sorted(set(numbers) - set(table)):
        log(f"portbench: {name} {numbers[name]} (read, not compared)")
    out.update(values=values, ok=ok, table=table, losses=losses,
               kind=torch.cuda.get_device_name(dev) if cuda else "cpu")
    if trace_on:
        rec = {"stamps": stamps, "trace": record, "config": config, "traffic": traffic,
               "num_nodes": host.num_nodes, "live_edges": host.num_edges,
               "build_graph_s": build_s, "chips": mesh.world_size, "comm_recv_bytes": comm}
        out["metrics"] = {m["name"]: {"value": v, "unit": m["unit"]}
                          for m in registry.metrics("per_layer", cell)
                          if (v := registry.reader(m["name"]).read(rec)) is not None}
        out["breakdown"] = trace.breakdown(record)
    return out


def run(cell: str, world: int, seed: int, seconds: float, trace_on: bool, device: str,
        fault, sizes, start: float) -> dict:
    """The result of one run of `cell` on `world` ranks (`run.run`'s keys):
    rank 0's readings, check and metrics; `peak_mem_gib` and
    `device.memory_peak_bytes` the fullest rank's peak; `busy_s` and
    `window_s` the mean over the ranks. `start` is the parent's
    `time.perf_counter()` at its start, from which `setup_s` counts."""
    from portbench.run import ForbiddenModules, _finite, forbidden_modules

    device_type = torch.device(device).type
    job = {"cell": cell, "seed": seed, "seconds": seconds, "trace": trace_on, "fault": fault,
           "sizes": sizes, "start": start}
    outs = spawn(rank_run, world, job, device_type)
    bad = forbidden_modules()
    if bad:
        raise ForbiddenModules(f"loaded once the window closed: {bad}")
    first = outs[0]
    peak = max(o["peak"] for o in outs)
    values = {**first["values"], "peak_mem_gib": peak / 2**30}
    if trace_on:
        metrics = first["metrics"]
    else:
        metrics = {}
        for m in registry.metrics("end_to_end", cell):
            if values.get(m["name"]) is None:
                raise RuntimeError(f"{cell}: no reading of {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device_type == "cuda" else "cpu", "kind": first["kind"],
           "count": world, "memory_peak_bytes": peak}
    losses = first["losses"]
    result = {"correct": first["ok"], "attempted": len(losses),
              "failed": sum(not math.isfinite(x) for x in losses), "metrics": metrics,
              "device": dev}
    if trace_on:
        dev["busy_s"] = sum(o["busy_s"] for o in outs) / world
        dev["window_s"] = sum(o["window_s"] for o in outs) / world
        result["breakdown"] = first["breakdown"]
    result["checks"] = {n: {"value": _finite(v["value"]), "limit": v["limit"]}
                        for n, v in first["table"].items()}
    return result
