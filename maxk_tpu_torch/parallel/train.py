"""Sharded (multi-device) training: one rank per device, rows partitioned.

Port of `maxk_tpu/parallel/train.py` and of `run_sharded` in `train.py`.
Every rank holds the same parameters (made from `cfg.seed` on each rank),
its row block of the graph and its rows of the node arrays. The
aggregation collectives live inside the ops (`ops/spgemm.py`); this module
adds the gradient all_reduce that makes the step correct, and the loss and
metric all_reduces that report it (all_gathers for ROC-AUC, whose ranks
are global). Every rank calls every collective in the same order,
evaluation included; only rank 0 logs. GNNRes has no sharded path.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from maxk_tpu_torch.data.datasets import GraphData
from maxk_tpu_torch.ops.dispatch import HYBRID_MODES, TILE_MODES, resolve_mode
from maxk_tpu_torch.parallel.collectives import all_gather_rows, all_reduce_grads, all_reduce_sum
from maxk_tpu_torch.parallel.mesh import Mesh
from maxk_tpu_torch.parallel.shard import ShardedGraph, build_sharded_graph, shard_rows
from maxk_tpu_torch.sparse.hybrid import check_hybrid_ok, degree_perm, permute_csr
from maxk_tpu_torch.train.config import TrainConfig
from maxk_tpu_torch.train.loop import (
    dataset_metric,
    model_from_config,
    optimizer_from_config,
    per_node_loss,
    permuted_data,
    synchronize,
    wants_hybrid,
)
from maxk_tpu_torch.train.metrics import rocauc
from maxk_tpu_torch.train.optim import Optimizer


def local_masked_loss(logits, labels, mask, multilabel: bool, mesh: Mesh) -> torch.Tensor:
    """This rank's loss terms over the GLOBAL mask count.

    The count is all-reduced and carries no gradient. The numerator is
    not: each rank's gradient is the gradient of its own terms, and one
    all_reduce of the gradients after the backward sums them (the
    collectives inside the aggregation ops already route the cross-rank
    cotangents), as in the reference (`parallel/train.py:28-43`)."""
    w = mask.to(torch.float32)
    count = all_reduce_sum(w.sum(), mesh)
    return (per_node_loss(logits, labels, multilabel) * w).sum() / count.clamp_min(1.0)


def check_sharded_model(model: str) -> None:
    """GNNRes has no row-partitioned path: its BatchNorm statistics would
    need a cross-rank reduction, and the reference's sharded step applies
    the parameters alone (`maxk_tpu/parallel/train.py:53-56`), so it has
    none either."""
    if model == "gnn_res":
        raise NotImplementedError(
            "--model gnn_res has no row-partitioned path (--mesh_shape): the "
            "reference's sharded step carries no BatchNorm statistics; ROADMAP A7"
        )


def rank_seed(seed: int, rank: int) -> int:
    """The dropout seed of `rank`: the role of `fold_in(rng, axis_index)`."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


@dataclass
class ShardedState:
    model: torch.nn.Module
    optimizer: Optimizer
    graph: ShardedGraph
    generator: torch.Generator  # this rank's dropout masks, on its device
    mesh: Mesh
    feats: torch.Tensor  # this rank's rows of the Vp-padded node arrays
    labels: torch.Tensor
    masks: tuple  # train, val, test
    best_val: float = 0.0
    best_test: float = 0.0
    epoch_times: list = field(default_factory=list)
    losses: list = field(default_factory=list)
    step_bytes: dict = field(default_factory=dict)  # the last train step's


def sharded_setup(cfg: TrainConfig, data: GraphData, mesh: Mesh) -> ShardedState:
    """Model, optimizer (Lookahead under `--enable_lookahead`), this rank's
    graph blocks and node rows. The blocks' edge-tile tables are built
    under the tile modes alone: AUTO never runs them here, where the
    reference's sharded AUTO does (ROADMAP C). The strip schedule is built
    where the single-device run would build it (`loop.wants_hybrid`),
    `hybrid_int8` included (the sharded hybrid has no int8 features, as in
    the reference), on the degree-permuted graph with the node rows
    permuted alike; an explicit hybrid mode on a directed graph raises,
    AUTO falls back (`maxk_tpu/parallel/train.py:142-195`)."""
    resolve_mode(cfg.kernel_mode)  # pallas raises
    check_sharded_model(cfg.model)
    n, r = mesh.world_size, mesh.rank
    model, gnorm = model_from_config(cfg, data)
    model.to(mesh.device)
    csr, hybrid = data.csr, False
    if wants_hybrid(cfg, csr, mesh.device):
        on_dev = csr.to(mesh.device)
        hybrid = check_hybrid_ok(on_dev)
        if hybrid:
            perm = degree_perm(csr)
            csr, data = permute_csr(on_dev, perm), permuted_data(data, perm)
        elif cfg.kernel_mode in HYBRID_MODES:  # never a silent downgrade of an explicit mode
            raise ValueError(
                f"kernel_mode={cfg.kernel_mode!r} requires a value-symmetric (undirected) "
                "graph; use kernel_mode='auto' for automatic fallback"
            )
        del on_dev
    graph = build_sharded_graph(csr, mesh, norm=gnorm,
                                build_tiles=cfg.kernel_mode in TILE_MODES,
                                row_block=cfg.row_block, edge_tile=cfg.edge_tile,
                                hybrid=hybrid, dim=cfg.hidden_dim)
    vs = graph.shard_nodes

    def rows(a, fill=0):
        return torch.as_tensor(shard_rows(a, n, fill=fill)[r * vs:(r + 1) * vs]).to(mesh.device)

    labels = data.labels.astype(np.float32 if data.multilabel else np.int64)
    return ShardedState(
        model=model,
        optimizer=optimizer_from_config(cfg, model),
        graph=graph,
        generator=torch.Generator(device=mesh.device).manual_seed(rank_seed(cfg.seed, r)),
        mesh=mesh,
        feats=rows(data.features.astype(np.float32)),
        labels=rows(labels),
        masks=tuple(rows(m, fill=False) for m in (data.train_mask, data.val_mask, data.test_mask)),
    )


def make_sharded_train_step(model, optimizer, multilabel: bool, mesh: Mesh):
    """step(graph, feats, labels, mask, generator) -> (global loss, local
    logits), the loss before the update. The mesh's byte counter is reset
    at the start, so after the step it holds the step's traffic."""

    def train_step(graph, feats, labels, mask, generator):
        mesh.bytes.reset()
        optimizer.zero_grad(set_to_none=True)
        logits = model(graph, feats, train=True, generator=generator)
        loss = local_masked_loss(logits, labels, mask, multilabel, mesh)
        loss.backward()
        all_reduce_grads(model.parameters(), mesh)
        optimizer.step()
        return all_reduce_sum(loss.detach().clone(), mesh), logits.detach()

    return train_step


def gathered_rocauc(logits, labels, masks, mesh: Mesh) -> tuple:
    """The single-device `rocauc` of each mask over the all-gathered logits,
    labels and mask rows (its ranks are global, so no count sums). The
    masks travel as uint8: not every backend gathers bool."""
    lg = all_gather_rows(logits, mesh)
    lb = all_gather_rows(labels, mesh)
    return tuple(rocauc(lg, lb, all_gather_rows(m.to(torch.uint8), mesh).bool()) for m in masks)


def make_sharded_eval_step(model, multilabel: bool, mesh: Mesh, metric: str = "f1"):
    """eval(graph, feats, labels, masks) -> one metric value per mask:
    accuracy (micro-F1 when multilabel) from all-reduced counts, or with
    `metric="rocauc"` `gathered_rocauc`."""

    @torch.no_grad()
    def eval_step(graph, feats, labels, masks):
        logits = model(graph, feats, train=False)
        if metric == "rocauc":
            return gathered_rocauc(logits, labels, masks, mesh)
        sums = []
        for m in masks:
            w = m.to(torch.float32)
            if multilabel:
                pred = (logits > 0).to(torch.float32) * w[:, None]
                lab = (labels > 0.5).to(torch.float32) * w[:, None]
                sums.append(torch.stack([
                    (pred * lab).sum(), (pred * (1 - lab)).sum(),
                    ((1 - pred) * lab).sum(),
                ]))
            else:
                correct = (logits.argmax(-1) == labels).to(torch.float32) * w
                sums.append(torch.stack([correct.sum(), w.sum()]))
        tot = all_reduce_sum(torch.stack(sums), mesh)  # one collective for all
        if multilabel:
            tp, fp, fn = tot.unbind(1)
            return tuple((2 * tp / (2 * tp + fp + fn).clamp_min(1.0)).unbind())
        return tuple((tot[:, 0] / tot[:, 1].clamp_min(1.0)).unbind())

    return eval_step


def train_sharded(
    cfg: TrainConfig, data: GraphData, mesh: Mesh, logger=None, writer=None,
    warmup_epochs: int = 10,
) -> ShardedState:
    """The sharded training loop on this rank; every rank calls it."""
    state = sharded_setup(cfg, data, mesh)
    train_step = make_sharded_train_step(state.model, state.optimizer, data.multilabel, mesh)
    eval_step = make_sharded_eval_step(state.model, data.multilabel, mesh, dataset_metric(data))
    log = logger.info if logger else (lambda *_: None)
    # every rank joins this gather: the edge split is the step's balance
    edges = all_gather_rows(torch.tensor([state.graph.nnz], device=mesh.device), mesh).tolist()
    log(f"mesh: {mesh.world_size} ranks, backend {mesh.backend}, "
        f"Vs={state.graph.shard_nodes} rows per rank, edges per rank {edges}")

    for epoch in range(cfg.epochs):
        synchronize(mesh.device)
        t0 = time.perf_counter()
        loss, _ = train_step(state.graph, state.feats, state.labels, state.masks[0],
                             state.generator)
        synchronize(mesh.device)
        dt = time.perf_counter() - t0
        state.step_bytes = mesh.bytes.summary()
        if epoch >= warmup_epochs:
            state.epoch_times.append(dt)
        tr, va, te = (float(a) for a in eval_step(state.graph, state.feats, state.labels,
                                                   state.masks))
        loss = float(loss)
        state.losses.append(loss)
        if va > state.best_val:
            state.best_val, state.best_test = va, te
        if writer is not None:
            writer.add_scalar("loss", loss, epoch)
            writer.add_scalar("val_acc", va, epoch)
        log(
            f"epoch {epoch:05d} | loss {loss:.4f} | train {tr:.4f} "
            f"| val {va:.4f} | test {te:.4f} | {dt*1e3:.1f} ms"
        )
    if state.epoch_times:
        log(f"avg epoch time: {1e3*np.mean(state.epoch_times):.2f} ms")
    log(f"collective bytes of the last step: {state.step_bytes}")
    log(f"best val {state.best_val:.4f} | best test {state.best_test:.4f}")
    return state


def run_rank(mesh: Mesh, cfg: TrainConfig) -> dict:
    """One rank of `python -m maxk_tpu_torch --mesh_shape N`: loads the
    dataset from its seed, trains its row block; rank 0 alone logs."""
    from maxk_tpu_torch.data.datasets import load_dataset
    from maxk_tpu_torch.train.logging import ScalarWriter, experiment_dir, get_logger

    logger = writer = None
    if mesh.rank == 0:
        exp = experiment_dir(cfg)
        logger = get_logger(os.path.join(exp, "train.log"))
        writer = ScalarWriter(exp)
        logger.info(f"config: {cfg}")
    try:
        data = load_dataset(cfg.dataset, scale=cfg.data_scale, seed=123, feat_snr=cfg.feat_snr)
        if logger:
            logger.info(
                f"dataset {cfg.dataset}: V={data.csr.num_nodes} E={data.csr.nnz} "
                f"F={data.feat_dim} C={data.num_classes} multilabel={data.multilabel}"
            )
        state = train_sharded(cfg, data, mesh, logger, writer)
    finally:
        if writer is not None:
            writer.close()
    return {"losses": state.losses, "best_val": state.best_val, "best_test": state.best_test,
            "epoch_times": state.epoch_times, "step_bytes": state.step_bytes}
