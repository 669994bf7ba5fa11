"""The process mesh of the row-partitioned path.

Port of `maxk_tpu/parallel/mesh.py`. JAX runs one process over a device
mesh; the port runs one process per device ("rank"), all in one
`torch.distributed` group: gloo for CPU ranks, NCCL for CUDA ranks, rank r
on `cuda:r`. A rank's `Mesh` is its rank, the world size, its device, the
backend and the `ByteCounter` its collectives add to.

`run_ranks` spawns the ranks of one run and collects what each returns.
A CUDA run asks for as many devices as ranks and raises, naming both
counts, when fewer are present: it never falls back to CPU ranks.
"""

from __future__ import annotations

import socket
import time
from dataclasses import dataclass, field
from datetime import timedelta

import torch
import torch.distributed as dist

from maxk_tpu_torch.parallel.collectives import ByteCounter

GRAPH_AXIS = "graph"
# a collective that waits longer than this raises instead of hanging
PG_TIMEOUT = timedelta(seconds=60)


@dataclass
class Mesh:
    rank: int
    world_size: int
    device: torch.device
    backend: str
    bytes: ByteCounter = field(default_factory=ByteCounter)


def check_devices(world_size: int, device_type: str) -> None:
    """Raise unless `world_size` ranks fit on the devices present."""
    if world_size < 1:
        raise ValueError(f"world size must be >= 1, got {world_size}")
    if device_type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < world_size:
            raise RuntimeError(
                f"--mesh_shape {world_size} needs {world_size} CUDA devices, "
                f"found {have}: a CUDA run never falls back to CPU ranks"
            )
    elif device_type != "cpu":
        raise ValueError(f"no mesh for device type {device_type!r} (cpu or cuda)")


def free_tcp_init_method() -> str:
    """A `tcp://127.0.0.1:<port>` rendezvous on a port free right now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def init_mesh(rank: int, world_size: int, device_type: str, init_method: str,
              timeout: timedelta = PG_TIMEOUT) -> Mesh:
    """Join the default process group as `rank`; returns this rank's Mesh."""
    check_devices(world_size, device_type)
    if device_type == "cuda":
        device, backend = torch.device("cuda", rank), "nccl"
        torch.cuda.set_device(device)
    else:
        device, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timeout)
    return Mesh(rank=rank, world_size=world_size, device=device, backend=backend)


def destroy_mesh(mesh: Mesh) -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank, fn, world_size, device_type, init_method, queue, args):
    if device_type == "cpu":
        torch.set_num_threads(1)
    mesh = init_mesh(rank, world_size, device_type, init_method)
    try:
        out = fn(mesh, *args)
    finally:
        destroy_mesh(mesh)
    queue.put((rank, out))


def run_ranks(fn, world_size: int, args=(), device_type: str = "cuda",
              init_method: str | None = None, timeout: float | None = None) -> list:
    """Run `fn(mesh, *args)` on `world_size` spawned ranks; returns their
    results in rank order, one rank per CUDA device unless `device_type`
    is "cpu" (gloo ranks). `fn` must be importable by module path and
    return a picklable value (numpy arrays, not tensors). A rank that
    raises fails the run; with `timeout` (seconds), so does a run that
    outlasts it, and every rank still alive is terminated."""
    import torch.multiprocessing as mp

    check_devices(world_size, device_type)
    init_method = init_method or free_tcp_init_method()
    queue = mp.get_context("spawn").SimpleQueue()
    ctx = mp.start_processes(
        _rank_main, args=(fn, world_size, device_type, init_method, queue, tuple(args)),
        nprocs=world_size, join=False, start_method="spawn",
    )
    deadline = None if timeout is None else time.monotonic() + timeout
    results = {}

    def drain():
        while not queue.empty():
            rank, out = queue.get()
            results[rank] = out

    try:
        while True:
            drain()  # before join: a rank blocks in put() until it is read
            if ctx.join(timeout=0.1):
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{world_size} ranks of {fn.__name__} outlasted {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    drain()
    missing = sorted(set(range(world_size)) - set(results))
    if missing:
        raise RuntimeError(f"ranks {missing} of {fn.__name__} returned no result")
    return [results[r] for r in range(world_size)]
