"""Full-graph training loop — port of `maxk_tpu/train/loop.py` (single device).

Full-graph forward, masked cross-entropy (BCE for multilabel), Adam
(with Lookahead under `--enable_lookahead`), a full evaluation on the
train/val/test masks every epoch (ROC-AUC for ogbn-proteins, accuracy or
micro-F1 otherwise), best-val tracking, and the mean epoch time after a
warm-up. GNNRes's BatchNorm keeps its running statistics in buffers that
the train step updates. Step times are taken on the host clock around a
step that ends in a device synchronize.

Under `--kernel_mode hybrid|hybrid_int8` the graph carries the strip
schedule and lives in degree-permuted node space (`sparse/graph.py`):
`permuted_data` permutes the node arrays alike for training and
evaluation, and checkpoints hold the parameters, which do not depend on
the node order. AUTO builds the schedule on a CUDA card where
`hybrid_profitable` says so at the card's rates (`wants_hybrid`).

With a `checkpoint_dir`, `best/` is written on every improvement of the
validation value, `ckpt_<epoch>` every `checkpoint_every` epochs, and a
run with `checkpoint_every > 0` resumes from the latest `ckpt_<epoch>` at
the next epoch (`train/checkpoint.py`). The dropout masks come from one
generator whose state the checkpoint carries, so a resumed run draws the
masks an uninterrupted one would.

`--validate_kernels` (MaxK runs only) holds `maxk_spgemm` under the run's
kernel mode against the plain path before the first step, as the
reference's loop does, and raises when they disagree.

The train step and the evaluation are `telemetry` steps, their phases
spans (`train.forward`: the model and the loss; `train.backward`;
`train.optimizer`: Adam's step; `eval.forward`),
recorded while a profiler session runs or under `--profile_kernels`, which
logs every 10th epoch's device split after the warm-up from them: the
reference's CUDA-event forward / backward split
(`maxk_gnn_integrated.py:119-151`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from maxk_tpu_torch import telemetry
from maxk_tpu_torch.data.datasets import GraphData
from maxk_tpu_torch.models.models import build_model
from maxk_tpu_torch.ops.dispatch import HYBRID_MODES, TILE_MODES, missing_hybrid
from maxk_tpu_torch.sparse.csr import CSRGraph
from maxk_tpu_torch.sparse.graph import Graph, build_graph
from maxk_tpu_torch.sparse.hybrid import auto_hybrid
from maxk_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_best,
    save_checkpoint,
)
from maxk_tpu_torch.train.config import TrainConfig
from maxk_tpu_torch.train.metrics import compute_micro_f1, rocauc
from maxk_tpu_torch.train.optim import Optimizer, build_optimizer


def resolve_device(name: str) -> torch.device:
    """The run's device. A CUDA device that is not there raises: the run
    never carries on on the CPU in its place."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA device is available "
            "(pass --device cpu to run the plain PyTorch path)"
        )
    return device


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optimizer
    graph: Graph
    generator: torch.Generator  # dropout masks, on the run's device
    device: torch.device
    best_val: float = 0.0
    best_test: float = 0.0
    epoch_times: list = field(default_factory=list)
    losses: list = field(default_factory=list)


def per_node_loss(logits, labels, multilabel: bool) -> torch.Tensor:
    """(V,) cross-entropy, or mean BCE over the labels when multilabel."""
    if multilabel:
        return F.binary_cross_entropy_with_logits(logits, labels, reduction="none").mean(-1)
    return F.cross_entropy(logits, labels.long(), reduction="none")


def _loss_fn(logits, labels, mask, multilabel: bool):
    w = mask.to(torch.float32)
    return (per_node_loss(logits, labels, multilabel) * w).sum() / w.sum().clamp_min(1.0)


def model_from_config(cfg: TrainConfig, data: GraphData):
    """(module on the CPU, graph norm) for the run's flags, the parameters
    drawn from `cfg.seed`."""
    return build_model(
        cfg.model,
        in_dim=data.feat_dim,
        out_dim=data.num_classes,
        hidden_dim=cfg.hidden_dim,
        num_layers=cfg.hidden_layers,
        maxk=cfg.maxk,
        nonlinear=cfg.nonlinear,
        dropout=cfg.dropout,
        norm=cfg.norm,
        kernel_mode=cfg.kernel_mode,
        compute_dtype=torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None,
        generator=torch.Generator().manual_seed(cfg.seed),
    )


def optimizer_from_config(cfg: TrainConfig, model: torch.nn.Module) -> Optimizer:
    """The run's optimizer over `model`'s parameters, where they now lie."""
    return build_optimizer(model.parameters(), cfg.lr, cfg.weight_decay, cfg.enable_lookahead,
                           lookahead_k=cfg.w_lookahead)


def wants_hybrid(cfg: TrainConfig, csr: CSRGraph, device: torch.device) -> bool:
    """Whether the run builds the strip schedule: under the hybrid modes,
    and under AUTO on a CUDA card where `hybrid_profitable` says so at the
    card's rates, with the widths the builder will take (the reference's
    rule, `maxk_tpu/train/loop.py:83-96`, on a TPU)."""
    if cfg.kernel_mode in HYBRID_MODES:
        return True
    return cfg.kernel_mode == "auto" and auto_hybrid(
        csr, dim=cfg.hidden_dim, io_itemsize=2 if cfg.compute_dtype == "bfloat16" else 4,
        device=device)


def permuted_data(data: GraphData, perm) -> GraphData:
    """`data` with every per-node array permuted by `perm` (new → old node
    ids, a strip-schedule graph's `perm`); None leaves it unchanged."""
    if perm is None:
        return data
    p = perm
    return replace(data, features=data.features[p], labels=data.labels[p],
                   train_mask=data.train_mask[p], val_mask=data.val_mask[p],
                   test_mask=data.test_mask[p])


def setup(cfg: TrainConfig, data: GraphData) -> TrainState:
    """Model, optimizer, graph and dropout generator on the run's device.
    The edge-tile tables are built under the tile modes alone, the strip
    schedule where `wants_hybrid`; an explicit hybrid mode on a directed
    graph raises."""
    device = resolve_device(cfg.device)
    model, gnorm = model_from_config(cfg, data)
    model.to(device)
    graph = build_graph(data.csr, norm=gnorm, device=device,
                        build_tiles=cfg.kernel_mode in TILE_MODES,
                        row_block=cfg.row_block, edge_tile=cfg.edge_tile,
                        hybrid=wants_hybrid(cfg, data.csr, device), dim=cfg.hidden_dim)
    if cfg.kernel_mode in HYBRID_MODES and graph.hybrid is None:
        raise missing_hybrid(cfg.kernel_mode)
    return TrainState(
        model=model,
        optimizer=optimizer_from_config(cfg, model),
        graph=graph,
        generator=torch.Generator(device=device).manual_seed(cfg.seed),
        device=device,
    )


def make_train_step(model, optimizer, multilabel: bool):
    """step(graph, feats, labels, mask, generator) -> (loss, logits), the
    loss before the update, as the reference's step returns it."""

    def train_step(graph, feats, labels, mask, generator):
        with telemetry.step("train", feats.device):
            # no device work: a span here would put two events where the
            # device waits for the first launch
            optimizer.zero_grad(set_to_none=True)
            with telemetry.span("train.forward"):
                logits = model(graph, feats, train=True, generator=generator)
                loss = _loss_fn(logits, labels, mask, multilabel)
            with telemetry.span("train.backward"):
                loss.backward()
            with telemetry.span("train.optimizer"):
                optimizer.step()
        return loss.detach(), logits.detach()

    return train_step


def dataset_metric(data: GraphData) -> str:
    """The evaluation metric of `data`: "rocauc" for ogbn-proteins (OGB's
    metric for it), "f1" (accuracy or micro-F1) otherwise."""
    return "rocauc" if data.name == "ogbn-proteins" else "f1"


def make_eval_step(model, metric: str = "f1"):
    """eval(graph, feats, labels, masks) -> one metric value per mask."""
    fn = rocauc if metric == "rocauc" else compute_micro_f1

    @torch.no_grad()
    def eval_step(graph, feats, labels, masks):
        with telemetry.step("eval", feats.device):
            with telemetry.span("eval.forward"):
                logits = model(graph, feats, train=False)
            return tuple(fn(logits, labels, m) for m in masks)

    return eval_step


def _device_arrays(data: GraphData, device: torch.device):
    feats = torch.as_tensor(data.features, dtype=torch.float32).to(device)
    labels = torch.as_tensor(data.labels).to(device)
    masks = tuple(
        torch.as_tensor(m).to(device)
        for m in (data.train_mask, data.val_mask, data.test_mask)
    )
    return feats, labels, masks


def evaluate(state: TrainState, data: GraphData, metric: Optional[str] = None):
    """(train, val, test) metric; `metric` None: the dataset's."""
    feats, labels, masks = _device_arrays(permuted_data(data, state.graph.perm), state.device)
    accs = make_eval_step(state.model, metric or dataset_metric(data))(
        state.graph, feats, labels, masks
    )
    return tuple(float(a) for a in accs)


def checkpoint_payload(state: TrainState, epoch: int) -> dict:
    """What a checkpoint holds after `epoch`: the model (BatchNorm buffers
    included), the optimizer (Lookahead included), the epoch, the best
    metrics and the dropout generator's state."""
    return {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "epoch": epoch,
        "best_val": state.best_val,
        "best_test": state.best_test,
        "generator": state.generator.get_state(),
    }


def restore_state(state: TrainState, payload: dict) -> int:
    """Load `payload` (`checkpoint_payload`) into `state`; returns the
    epoch to resume at."""
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.generator.set_state(payload["generator"])
    state.best_val, state.best_test = float(payload["best_val"]), float(payload["best_test"])
    return int(payload["epoch"]) + 1


def step_split(since_ns: int) -> str:
    """The ms of the train step's forward (model and loss), backward and
    optimizer spans recorded since `since_ns`: device time on a card, host
    time on the CPU."""
    ms, clock = dict.fromkeys(("forward", "backward", "optimizer"), 0.0), "host"
    for name, start, end, device_s in telemetry.records(since_ns):
        phase = name.removeprefix("train.")
        if phase in ms:
            ms[phase] += 1e3 * device_s if device_s is not None else (end - start) / 1e6
            clock = "device" if device_s is not None else clock
    return " | ".join(f"{p} {v:.2f} ms" for p, v in ms.items()) + f" ({clock})"


def train(
    cfg: TrainConfig,
    data: GraphData,
    logger=None,
    writer=None,
    warmup_epochs: int = 10,
    checkpoint_dir: str = "",
) -> TrainState:
    """Run the training loop; returns the final state with best-val
    tracking. `checkpoint_dir`: where `best/` and `ckpt_<epoch>` go, and
    with `cfg.checkpoint_every > 0` where the run resumes from."""
    state = setup(cfg, data)
    device = state.device
    log = logger.info if logger else (lambda *_: None)
    start_epoch = 0
    if checkpoint_dir and cfg.checkpoint_every > 0:
        path = latest_checkpoint(checkpoint_dir)
        if path:
            start_epoch = restore_state(state, restore_checkpoint(path))
            log(f"resumed from {path} at epoch {start_epoch}")
    if cfg.validate_kernels and cfg.nonlinear == "maxk":
        # maxk_spgemm under the run's mode against the plain path, on the
        # MaxK CBSR of the features' first hidden_dim columns, zero-padded
        # (`maxk_tpu/train/loop.py:246-262`); a strip-hybrid graph is in
        # permuted node space on both sides, so nothing is un-permuted
        from maxk_tpu_torch.bench.kernel_bench import validate_graph
        from maxk_tpu_torch.sparse.cbsr import maxk_cbsr

        xs = torch.as_tensor(data.features[:, : cfg.hidden_dim], dtype=torch.float32)
        xs = F.pad(xs, (0, cfg.hidden_dim - xs.shape[1])).to(device)
        ok, detail = validate_graph(state.graph, maxk_cbsr(xs, cfg.maxk), cfg.hidden_dim,
                                    cfg.kernel_mode)
        log(f"kernel validation: ok={ok} {detail}")
        if not ok:
            raise RuntimeError(f"kernel validation failed: {detail}")
    train_step = make_train_step(state.model, state.optimizer, data.multilabel)
    eval_step = make_eval_step(state.model, dataset_metric(data))
    feats, labels, masks = _device_arrays(permuted_data(data, state.graph.perm), device)

    with telemetry.enabled(cfg.profile_kernels):
        for epoch in range(start_epoch, cfg.epochs):
            synchronize(device)
            since = time.perf_counter_ns()
            t0 = time.perf_counter()
            loss, _ = train_step(state.graph, feats, labels, masks[0], state.generator)
            synchronize(device)
            dt = time.perf_counter() - t0
            if epoch >= warmup_epochs:
                state.epoch_times.append(dt)
                if cfg.profile_kernels and epoch % 10 == 0:
                    log(f"  profile: {step_split(since)} of {dt*1e3:.2f} ms step")
            tr, va, te = (float(a) for a in eval_step(state.graph, feats, labels, masks))
            loss = float(loss)
            state.losses.append(loss)
            if va > state.best_val:
                state.best_val, state.best_test = va, te
                if checkpoint_dir:
                    save_best(checkpoint_dir, checkpoint_payload(state, epoch))
            if writer is not None:
                writer.add_scalar("loss", loss, epoch)
                writer.add_scalar("train_acc", tr, epoch)
                writer.add_scalar("val_acc", va, epoch)
                writer.add_scalar("test_acc", te, epoch)
            log(
                f"epoch {epoch:05d} | loss {loss:.4f} | train {tr:.4f} "
                f"| val {va:.4f} | test {te:.4f} | {dt*1e3:.1f} ms"
            )
            if (checkpoint_dir and cfg.checkpoint_every > 0
                    and (epoch + 1) % cfg.checkpoint_every == 0):
                save_checkpoint(checkpoint_dir, checkpoint_payload(state, epoch), step=epoch)
    if state.epoch_times:
        log(
            f"avg epoch time (post-warmup): "
            f"{1e3*np.mean(state.epoch_times):.2f} ms"
        )
    log(f"best val {state.best_val:.4f} | best test {state.best_test:.4f}")
    return state
