"""The collectives of the row-partitioned path, and the bytes they move.

They take the role of the collectives inside the JAX ops
(`jax.lax.all_gather`, `psum_scatter`, `psum` in `maxk_tpu/ops/spgemm.py`
and `maxk_tpu/parallel/train.py`) and of `maxk_tpu/parallel/audit.py`:
instead of parsing compiled HLO, every call adds what it moves to the
mesh's `ByteCounter`.

Receive bytes follow the reference's ring model (`maxk_tpu/parallel/audit.py`'s
`recv_bytes_per_device`), per device, n ranks:

  all_gather      (n-1)/n of the gathered (full) array
  reduce_scatter  (n-1) blocks the size of the local result
  all_reduce      2·(n-1)/n of the array

so the counts of one aggregation's forward and backward equal
`maxk_tpu_torch.parallel.audit.model_recv_bytes_fwd_bwd` (the
reference's model, copied). `payload` is the bytes each call hands
to the collective from this rank (nonzero at n = 1 too).
"""

from __future__ import annotations

import warnings
from contextlib import contextmanager

import torch
import torch.distributed as dist

OPS = ("all_gather", "reduce_scatter", "all_reduce")


class ByteCounter:
    """Calls, payload bytes and receive bytes per collective, since the
    last `reset` (the sharded train step resets it at its start)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls = dict.fromkeys(OPS, 0)
        self.payload = dict.fromkeys(OPS, 0)
        self.recv = dict.fromkeys(OPS, 0.0)

    def add(self, op: str, payload: int, recv: float) -> None:
        self.calls[op] += 1
        self.payload[op] += payload
        self.recv[op] += recv

    def total_recv(self) -> float:
        return sum(self.recv.values())

    def summary(self) -> dict:
        return {"calls": dict(self.calls), "payload_bytes": dict(self.payload),
                "recv_bytes": dict(self.recv), "recv_bytes_total": self.total_recv()}


@contextmanager
def _quiet():
    # torch 2.13 marks the *_tensor collectives deprecated in favour of
    # *_single, which older releases (2.11) lack
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        yield


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """(Vs, ...) on every rank → (n·Vs, ...), rank r's rows at r·Vs."""
    n = mesh.world_size
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    with _quiet():
        dist.all_gather_into_tensor(out, x)
    mesh.bytes.add("all_gather", _nbytes(x), _nbytes(out) * (n - 1) / n)
    return out


def reduce_scatter_rows(z: torch.Tensor, mesh) -> torch.Tensor:
    """(n·Vs, ...) partials on every rank → their sum's rows of this rank."""
    n = mesh.world_size
    z = z.contiguous()
    out = torch.empty((z.shape[0] // n,) + tuple(z.shape[1:]), dtype=z.dtype, device=z.device)
    with _quiet():
        dist.reduce_scatter_tensor(out, z)
    mesh.bytes.add("reduce_scatter", _nbytes(z), _nbytes(out) * (n - 1))
    return out


def all_reduce_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of `t` over the ranks, in place; returns `t`."""
    n = mesh.world_size
    dist.all_reduce(t)
    mesh.bytes.add("all_reduce", _nbytes(t), _nbytes(t) * 2 * (n - 1) / n)
    return t


def all_reduce_grads(params, mesh) -> None:
    """Sum every parameter gradient over the ranks, in one collective over
    a flat buffer (the role of `jax.lax.psum(grads)`)."""
    grads = [p.grad for p in params]
    flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), mesh)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
