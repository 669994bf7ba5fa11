"""Full-graph training loop — port of `maxk_tpu/train/loop.py` (single device).

Full-graph forward, masked cross-entropy (BCE for multilabel), Adam, a
full evaluation on the train/val/test masks every epoch, best-val
tracking, and the mean epoch time after a warm-up. Step times are taken
on the host clock around a step that ends in a device synchronize.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from maxk_tpu_torch.data.datasets import GraphData
from maxk_tpu_torch.models.models import build_model
from maxk_tpu_torch.sparse.graph import Graph, build_graph
from maxk_tpu_torch.train.config import TrainConfig
from maxk_tpu_torch.train.metrics import compute_micro_f1
from maxk_tpu_torch.train.optim import build_optimizer


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
    optimizer: torch.optim.Optimizer
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


def setup(cfg: TrainConfig, data: GraphData) -> TrainState:
    device = resolve_device(cfg.device)
    model, gnorm = model_from_config(cfg, data)
    model.to(device)
    graph = build_graph(data.csr, norm=gnorm, device=device)
    return TrainState(
        model=model,
        optimizer=build_optimizer(model.parameters(), cfg.lr, cfg.weight_decay),
        graph=graph,
        generator=torch.Generator(device=device).manual_seed(cfg.seed),
        device=device,
    )


def make_train_step(model, optimizer, multilabel: bool):
    """step(graph, feats, labels, mask, generator) -> (loss, logits), the
    loss before the update, as the reference's step returns it."""

    def train_step(graph, feats, labels, mask, generator):
        optimizer.zero_grad(set_to_none=True)
        logits = model(graph, feats, train=True, generator=generator)
        loss = _loss_fn(logits, labels, mask, multilabel)
        loss.backward()
        optimizer.step()
        return loss.detach(), logits.detach()

    return train_step


def make_eval_step(model):
    @torch.no_grad()
    def eval_step(graph, feats, labels, masks):
        logits = model(graph, feats, train=False)
        return tuple(compute_micro_f1(logits, labels, m) for m in masks)

    return eval_step


def _device_arrays(data: GraphData, device: torch.device):
    feats = torch.as_tensor(data.features, dtype=torch.float32).to(device)
    labels = torch.as_tensor(data.labels).to(device)
    masks = tuple(
        torch.as_tensor(m).to(device)
        for m in (data.train_mask, data.val_mask, data.test_mask)
    )
    return feats, labels, masks


def evaluate(state: TrainState, data: GraphData):
    feats, labels, masks = _device_arrays(data, state.device)
    accs = make_eval_step(state.model)(state.graph, feats, labels, masks)
    return tuple(float(a) for a in accs)


def train(
    cfg: TrainConfig,
    data: GraphData,
    logger=None,
    writer=None,
    warmup_epochs: int = 10,
) -> TrainState:
    """Run the training loop; returns the final state with best-val tracking."""
    state = setup(cfg, data)
    device = state.device
    train_step = make_train_step(state.model, state.optimizer, data.multilabel)
    eval_step = make_eval_step(state.model)
    feats, labels, masks = _device_arrays(data, device)
    log = logger.info if logger else (lambda *_: None)

    for epoch in range(cfg.epochs):
        synchronize(device)
        t0 = time.perf_counter()
        loss, _ = train_step(state.graph, feats, labels, masks[0], state.generator)
        synchronize(device)
        dt = time.perf_counter() - t0
        if epoch >= warmup_epochs:
            state.epoch_times.append(dt)
            if cfg.profile_kernels and epoch % 10 == 0:
                t1 = time.perf_counter()
                with torch.no_grad():
                    state.model(state.graph, feats, train=False)
                synchronize(device)
                log(
                    f"  profile: fwd {1e3*(time.perf_counter()-t1):.2f} ms "
                    f"of {dt*1e3:.2f} ms step"
                )
        tr, va, te = (float(a) for a in eval_step(state.graph, feats, labels, masks))
        loss = float(loss)
        state.losses.append(loss)
        if va > state.best_val:
            state.best_val, state.best_test = va, te
        if writer is not None:
            writer.add_scalar("loss", loss, epoch)
            writer.add_scalar("train_acc", tr, epoch)
            writer.add_scalar("val_acc", va, epoch)
            writer.add_scalar("test_acc", te, epoch)
        log(
            f"epoch {epoch:05d} | loss {loss:.4f} | train {tr:.4f} "
            f"| val {va:.4f} | test {te:.4f} | {dt*1e3:.1f} ms"
        )
    if state.epoch_times:
        log(
            f"avg epoch time (post-warmup): "
            f"{1e3*np.mean(state.epoch_times):.2f} ms"
        )
    log(f"best val {state.best_val:.4f} | best test {state.best_test:.4f}")
    return state
