"""Plain PyTorch reference of MaxK-SAGE full-graph training, row-partitioned
over the ranks of `torch.distributed`'s default group.

The model, loss, optimizer and evaluation of `reference/sage.py` (whose
`parameters`, `model_flops`, `maxk` and `Adam` it takes, loading that file
by path), with the work split as a row-partitioned run splits it and none of
the program's code. Rank r of n holds rows [r·Vs, (r+1)·Vs) of every node
array (Vs = ceil(V/n); the rows past V are zero and in no mask) and of A,
row-normalised from the raw graph as `sage.Graph` normalises it (each edge
of row i weighted 1/deg(i)), as a torch CSR tensor of shape (Vs, Vp) with
global columns, Vp = n·Vs. An aggregation all_gathers the (Vs, H) rows into
(Vp, H) and multiplies the block (`torch.sparse.mm`); its backward
multiplies the block's transpose into (Vp, H) partials and reduce_scatters
their sum. The loss is a rank's cross-entropy over its train rows divided by
the global train count; the gradients are summed over the ranks before
Adam, so every rank holds the same parameters. Dropout masks are drawn on
rank r from a generator on its device seeded with `rank_seed(dropout_seed,
r)`, the rule of the program's row-partitioned path written out again, in
the order and shapes of the one-card reference, over the rank's rows.

`follow` gives the readings of `sage.follow` (losses, first gradient norms,
changes, correct counts), the same on every rank. It imports nothing of the
program. Float32, with TF32 off unless a caller turns it on (the control).
"""

from __future__ import annotations

import contextlib
import importlib.util
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F


def _sibling(name: str):
    path = Path(__file__).with_name(f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_reference_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_sage = _sibling("sage")
parameters = _sage.parameters
model_flops = _sage.model_flops  # over the whole graph, as one card computes it
maxk = _sage.maxk
Adam = _sage.Adam


def rank_seed(seed: int, rank: int) -> int:
    """Rank `rank`'s dropout seed: the first word of numpy's SeedSequence of
    (seed, rank)."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


def shard_nodes(num_nodes: int, world: int) -> int:
    return -(-num_nodes // world)


def rows(a: torch.Tensor, rank: int, world: int, device, fill=0) -> torch.Tensor:
    """Rank `rank`'s Vs rows of the per-node array `a`, on `device`; rows
    past V hold `fill`."""
    v = a.shape[0]
    vs = shard_nodes(v, world)
    lo, hi = min(rank * vs, v), min((rank + 1) * vs, v)
    out = torch.full((vs,) + tuple(a.shape[1:]), fill, dtype=a.dtype, device=device)
    out[:hi - lo] = a[lo:hi].to(device)
    return out


class RowBlock:
    """Rank `rank`'s rows of the row-normalised A, (Vs, Vp), and their
    transpose, (Vp, Vs), as CSR tensors on `device`, from the raw CSR
    `indptr`, `indices` (every value 1)."""

    def __init__(self, indptr: torch.Tensor, indices: torch.Tensor, rank: int, world: int,
                 device):
        v = indptr.shape[0] - 1
        vs = shard_nodes(v, world)
        vp = vs * world
        lo, hi = min(rank * vs, v), min((rank + 1) * vs, v)
        ptr = indptr[lo:hi + 1].long()
        cols = indices[int(ptr[0]):int(ptr[-1])].to(device).long()
        ptr = (ptr - ptr[0]).to(device)
        ptr = torch.cat([ptr, ptr[-1:].expand(vs - (hi - lo))])  # the padded rows: no edges
        deg = torch.diff(ptr)
        row = torch.repeat_interleave(torch.arange(vs, device=device), deg)
        values = (1.0 / deg.clamp_min(1).to(torch.float32))[row]
        self.a = torch.sparse_csr_tensor(ptr, cols, values, (vs, vp), check_invariants=False)
        order = torch.argsort(cols, stable=True)  # by column, rows ascending
        t_ptr = torch.zeros(vp + 1, dtype=torch.int64, device=device)
        t_ptr[1:] = torch.cumsum(torch.bincount(cols, minlength=vp), 0)
        self.at = torch.sparse_csr_tensor(t_ptr, row[order], values[order], (vp, vs),
                                          check_invariants=False)
        self.rows, self.padded = vs, vp


@contextlib.contextmanager
def _quiet():
    # newer torch marks the *_tensor collectives deprecated; older lacks *_single
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        yield


class _Aggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, block):
        ctx.block = block
        full = torch.empty((block.padded, h.shape[1]), dtype=h.dtype, device=h.device)
        with _quiet():
            dist.all_gather_into_tensor(full, h.contiguous())
        return torch.sparse.mm(block.a, full)

    @staticmethod
    def backward(ctx, g):
        block = ctx.block
        part = torch.sparse.mm(block.at, g.contiguous())
        out = torch.empty((block.rows, g.shape[1]), dtype=g.dtype, device=g.device)
        with _quiet():
            dist.reduce_scatter_tensor(out, part)
        return out, None


def forward(p: dict, block: RowBlock, x: torch.Tensor, config: dict, traffic: dict,
            gen: torch.Generator = None) -> torch.Tensor:
    """This rank's logits; dropout where `gen` is given (training). The
    layers of `sage.forward`, each aggregation over the ranks."""
    h = F.linear(x, p["lin_in.weight"], p["lin_in.bias"])
    rate = config["dropout"]
    for i in range(config["hidden_layers"]):
        h = maxk(h, traffic["maxk"]) if traffic["nonlinear"] == "maxk" else torch.relu(h)
        if gen is not None and rate > 0:
            keep = 1.0 - rate
            drop = torch.rand(h.shape, generator=gen, device=h.device) < keep
            h = torch.where(drop, h / keep, torch.zeros((), dtype=h.dtype, device=h.device))
        agg = _Aggregate.apply(h, block)
        h = (F.linear(h, p[f"conv{i}.fc_self.weight"], p[f"conv{i}.fc_self.bias"])
             + F.linear(agg, p[f"conv{i}.fc_neigh.weight"]))
    return F.linear(h, p["lin_out.weight"], p["lin_out.bias"])


def _summed(t: torch.Tensor) -> torch.Tensor:
    dist.all_reduce(t)
    return t


def follow(inputs, config: dict, traffic: dict, dropout_seed: int, steps: int,
           rank: int = 0, world: int = 1) -> dict:
    """The readings of `sage.follow` over the first `steps` epochs from the
    initial weights, computed on the `world` ranks together; this is rank
    `rank`'s call. `inputs` holds the whole raw graph and node arrays (any
    device) and the initial weights on this rank's device."""
    device = next(iter(inputs.weights.values())).device
    block = RowBlock(inputs.indptr, inputs.indices, rank, world, device)
    x = rows(inputs.features, rank, world, device)
    labels = rows(inputs.labels, rank, world, device)
    masks = [rows(m, rank, world, device, fill=False) for m in inputs.masks]
    train = masks[0].to(torch.float32)
    count = _summed(train.sum()).clamp_min(1.0)
    p = {n: w.clone().requires_grad_(True) for n, w in inputs.weights.items()}
    opt = Adam(p, config["lr"])
    gen = torch.Generator(device=device)
    gen.manual_seed(rank_seed(dropout_seed, rank))
    losses, correct, grad_norms = [], [], None
    for step in range(steps):
        logits = forward(p, block, x, config, traffic, gen)
        nll = -torch.gather(torch.log_softmax(logits, -1), 1, labels.long()[:, None])[:, 0]
        loss = (nll * train).sum() / count
        del logits, nll
        local = torch.autograd.grad(loss, list(p.values()))
        flat = _summed(torch.cat([g.reshape(-1) for g in local]))
        grads = dict(zip(p, torch.split(flat, [g.numel() for g in local])))
        grads = {n: g.view_as(p[n]) for n, g in grads.items()}
        losses.append(float(_summed(loss.detach().clone())))
        if step == 0:
            grad_norms = {n: float(g.norm()) for n, g in grads.items()}
        opt.step(p, grads)
        del grads, local, flat, loss
        with torch.no_grad():
            hit = forward(p, block, x, config, traffic).argmax(-1) == labels
            counts = _summed(torch.stack([(hit & m).sum() for m in masks]))
            correct.append([int(c) for c in counts])
    changes = {n: float((p[n].detach() - inputs.weights[n]).norm()) for n in p}
    return {"losses": losses, "grad_norms": grad_norms, "changes": changes, "correct": correct}
