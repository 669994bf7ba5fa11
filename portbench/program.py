"""The system under test: maxk_tpu_torch's training loop, driven epoch by epoch.

An epoch is the body of `maxk_tpu_torch.train.loop.train`'s loop: a
synchronize, the train step of `make_train_step` (forward, masked
cross-entropy, backward, Adam), a synchronize, the evaluation of
`make_eval_step` on the train, val and test masks read to the host, then the
loss read to the host. The state comes from `loop.setup` on the harness's
inputs, with the harness's initial weights loaded into the model. On several
ranks (`ShardedProgram`) the epoch is the body of `parallel.train.
train_sharded`'s loop, the same steps from `make_sharded_train_step` and
`make_sharded_eval_step`, over the state of `parallel.train.sharded_setup`.
This is the one module of the benchmark that imports the program.

Faults, planted for the tests and the calibration only (never in a benchmark
run): `unchanged` (the optimizer's step does nothing), `half_batch` (the loss
over the first half of the train mask's nodes, the mean taken over those),
`altered_rows` (every 100th row of each aggregation's output zeroed where it
is produced: the SpMM, K10 and K11, on one card and on a rank's block),
`no_exchange` (several ranks only: the gradient all_reduce between the ranks
left out, so each steps on its own rows' gradient).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from datetime import timedelta

import numpy as np
import torch
from torch.profiler import record_function

from maxk_tpu_torch.data.datasets import GraphData
from maxk_tpu_torch.ops import spgemm
from maxk_tpu_torch.ops.dispatch import resolve_mode
from maxk_tpu_torch.parallel import mesh as pmesh
from maxk_tpu_torch.parallel import train as sharded
from maxk_tpu_torch.parallel.shard import shard_rows
from maxk_tpu_torch.sparse.csr import CSRGraph
from maxk_tpu_torch.train import loop
from maxk_tpu_torch.train.config import TrainConfig

FAULTS = ("unchanged", "half_batch", "altered_rows", "no_exchange")
SHARDED_FAULTS = ("no_exchange",)  # only a run on several ranks has them
ALTERED_EVERY = 100
ALTERED = ("_spmm_impl", "spgemm_cbsr", "sspmm_cbsr")  # the aggregation's producers


def train_config(config: dict, traffic: dict, device: str, dropout_seed: int,
                 compute_dtype: str = "") -> TrainConfig:
    cfg = TrainConfig(
        dataset=config["name"], model=config["model"], hidden_dim=config["hidden_dim"],
        hidden_layers=config["hidden_layers"], nonlinear=traffic["nonlinear"],
        maxk=traffic["maxk"], dropout=config["dropout"], lr=config["lr"],
        weight_decay=config["weight_decay"], kernel_mode=traffic["kernel_mode"],
        compute_dtype=compute_dtype, seed=dropout_seed, device=device,
    )
    cfg.validate()
    return cfg


def graph_data(config: dict, inputs) -> GraphData:
    values = torch.ones(inputs.num_edges, dtype=torch.float32, device=inputs.indices.device)
    train, val, test = inputs.masks
    return GraphData(name=config["name"], csr=CSRGraph(inputs.indptr, inputs.indices, values),
                     features=inputs.features, labels=inputs.labels, train_mask=train,
                     val_mask=val, test_mask=test, num_classes=config["num_classes"],
                     multilabel=config["multilabel"])


@contextlib.contextmanager
def timed_build_graph(seconds: list):
    """Append the host seconds of each `build_graph` call that `loop.setup`
    makes, device work included, to `seconds`."""
    build = loop.build_graph

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        graph = build(*args, **kwargs)
        if graph.csr.device.type == "cuda":
            torch.cuda.synchronize(graph.csr.device)
        seconds.append(time.perf_counter() - t0)
        return graph

    loop.build_graph = timed
    try:
        yield
    finally:
        loop.build_graph = build


@contextlib.contextmanager
def altered_rows():
    """The `altered_rows` fault: every ALTERED_EVERY-th row of each
    aggregation's output zeroed where it is produced: the SpMM
    (`_spmm_impl`; on a rank's block, after the reduce-scatter of K9ᵀ's
    partials), K10 (`spgemm_cbsr`, one card and a rank's block) and K11
    (`sspmm_cbsr`, the MaxK backward on one card)."""
    originals = {name: getattr(spgemm, name) for name in ALTERED}

    def altering(produce):
        def altered(*args, **kwargs):
            y = produce(*args, **kwargs)
            y[::ALTERED_EVERY] = 0
            return y
        return altered

    for name, produce in originals.items():
        setattr(spgemm, name, altering(produce))
    try:
        yield
    finally:
        for name, produce in originals.items():
            setattr(spgemm, name, produce)


@contextlib.contextmanager
def no_exchange():
    """The `no_exchange` fault: the sharded train step's gradient all_reduce
    left out."""
    reduce = sharded.all_reduce_grads
    sharded.all_reduce_grads = lambda params, mesh: None
    try:
        yield
    finally:
        sharded.all_reduce_grads = reduce


def fault_context(fault):
    if fault == "altered_rows":
        return altered_rows()
    if fault == "no_exchange":
        return no_exchange()
    return contextlib.nullcontext()


def setup_state(cfg: TrainConfig, data: GraphData):
    """(`loop.setup`'s state, build_graph's seconds)."""
    seconds = []
    with timed_build_graph(seconds):
        state = loop.setup(cfg, data)
    return state, sum(seconds)


def fresh_state(cfg: TrainConfig, data: GraphData, graph) -> loop.TrainState:
    """A state as `loop.setup` makes it, on a graph it already built.

    It exists only so that the calibration's faulty and control variants
    skip a second `build_graph`, and has to follow `loop.setup`'s model,
    optimizer and generator construction; the benchmark's runs and the
    calibration's sound variant take their state from `loop.setup` itself."""
    device = loop.resolve_device(cfg.device)
    model, _ = loop.model_from_config(cfg, data)
    model.to(device)
    return loop.TrainState(model=model, optimizer=loop.optimizer_from_config(cfg, model),
                           graph=graph, generator=torch.Generator(device=device).manual_seed(cfg.seed),
                           device=device)


class Program:
    """One training run of the program from the harness's initial weights."""

    def __init__(self, state: loop.TrainState, data: GraphData, weights: dict, fault=None):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
        if fault in SHARDED_FAULTS:
            raise ValueError(f"a run on one device has no {fault!r} fault")
        self.state, self.fault, self.device = state, fault, state.device
        state.model.load_state_dict(weights)
        self.initial = weights
        self.train_step = loop.make_train_step(state.model, state.optimizer, data.multilabel)
        self.eval_step = loop.make_eval_step(state.model, loop.dataset_metric(data))
        data = loop.permuted_data(data, state.graph.perm)
        self.feats, self.labels = data.features, data.labels
        self.masks = (data.train_mask, data.val_mask, data.test_mask)
        self.mask_sizes = [int(m.sum()) for m in self.masks]
        self.loss_mask = self.masks[0]
        if fault == "half_batch":
            nodes = torch.nonzero(self.masks[0]).flatten()
            self.loss_mask = torch.zeros_like(self.masks[0])
            self.loss_mask[nodes[: nodes.numel() // 2]] = True
        if fault == "unchanged":
            state.optimizer.step = lambda *args, **kwargs: None

    def resolved_mode(self) -> str:
        g = self.state.graph
        return resolve_mode(self.state.model.conv0.kernel_mode, g.tiles is not None,
                            g.hybrid is not None).value

    def epoch(self, trace: bool = False):
        """(loss, (train, val, test) accuracy, host stamps (start, train
        step done, evaluation read, loss read))."""
        span = record_function if trace else (lambda name: contextlib.nullcontext())
        st = self.state
        with fault_context(self.fault), span("portbench.epoch"):
            t0 = time.perf_counter()
            with span("portbench.train_step"):
                loop.synchronize(self.device)
                loss, _ = self.train_step(st.graph, self.feats, self.labels, self.loss_mask,
                                          st.generator)
                loop.synchronize(self.device)
            t1 = time.perf_counter()
            with span("portbench.eval_step"):
                accs = tuple(float(a) for a in self.eval_step(st.graph, self.feats, self.labels,
                                                              self.masks))
            t2 = time.perf_counter()
            with span("portbench.loss_read"):
                loss = float(loss)
            t3 = time.perf_counter()
        self.after_epoch()
        return loss, accs, (t0, t1, t2, t3)

    def after_epoch(self) -> None:
        """What a run reads of the program after each epoch, outside its
        stamps: nothing on one device."""

    def first_gradient_norms(self) -> dict:
        """Each leaf's gradient norm as the optimizer got it, from Adam's first
        moment after one step (m = (1 - beta1)·g); 0 where it holds none."""
        opt = self.state.optimizer
        beta1 = opt.param_groups[0]["betas"][0]
        out = {}
        for name, p in self.state.model.named_parameters():
            m = opt.state.get(p, {}).get("exp_avg")
            out[name] = 0.0 if m is None else float((m / (1 - beta1)).norm())
        return out

    def follow(self, steps: int) -> dict:
        """The readings `reference.follow` gives, from this run's first
        `steps` epochs."""
        losses, correct, grad_norms = [], [], None
        for step in range(steps):
            loss, accs, _ = self.epoch()
            losses.append(loss)
            correct.append([round(a * n) for a, n in zip(accs, self.mask_sizes)])
            if step == 0:
                grad_norms = self.first_gradient_norms()
        changes = {n: float((p.detach() - self.initial[n]).norm())
                   for n, p in self.state.model.named_parameters()}
        return {"losses": losses, "grad_norms": grad_norms, "changes": changes,
                "correct": correct}


# ---- the row-partitioned path: one process a device, rows partitioned ----

def init_mesh(rank: int, world_size: int, device_type: str, init_method: str,
              timeout_s: float):
    """This rank's `parallel.mesh.Mesh`, its collectives under `timeout_s`
    (the mesh's own default, 60 s, is shorter than a rank's set-up at the
    cells' sizes)."""
    return pmesh.init_mesh(rank, world_size, device_type, init_method,
                           timeout=timedelta(seconds=timeout_s))


def destroy_mesh(mesh) -> None:
    pmesh.destroy_mesh(mesh)


def host_graph_data(config: dict, inputs) -> GraphData:
    """`GraphData` with host arrays, as `load_dataset` gives them and
    `sharded_setup` takes them, from inputs whose tensors lie on the CPU."""
    values = torch.ones(inputs.num_edges, dtype=torch.float32)
    train, val, test = (m.numpy() for m in inputs.masks)
    return GraphData(name=config["name"], csr=CSRGraph(inputs.indptr, inputs.indices, values),
                     features=inputs.features.numpy(), labels=inputs.labels.numpy(),
                     train_mask=train, val_mask=val, test_mask=test,
                     num_classes=config["num_classes"], multilabel=config["multilabel"])


@contextlib.contextmanager
def timed_sharded_build(seconds: list):
    """Append the host seconds of each `build_sharded_graph` call that
    `sharded_setup` makes, device work included, to `seconds`."""
    build = sharded.build_sharded_graph

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        graph = build(*args, **kwargs)
        loop.synchronize(graph.fwd.device)
        seconds.append(time.perf_counter() - t0)
        return graph

    sharded.build_sharded_graph = timed
    try:
        yield
    finally:
        sharded.build_sharded_graph = build


def sharded_setup_state(cfg: TrainConfig, data: GraphData, mesh):
    """(`sharded_setup`'s state on this rank, build_sharded_graph's seconds)."""
    seconds = []
    with timed_sharded_build(seconds):
        state = sharded.sharded_setup(cfg, data, mesh)
    return state, sum(seconds)


def fresh_sharded_state(cfg: TrainConfig, data: GraphData, state):
    """A state as `sharded_setup` makes it for `data`, on the graph blocks
    of `state` (the same graph: only the node arrays differ from seed to
    seed).

    It exists only so that the calibration skips a graph build a seed and
    a variant, and has to follow `sharded_setup`'s model, optimizer,
    generator and node rows; the benchmark's runs take their state from
    `sharded_setup` itself."""
    mesh, graph = state.mesh, state.graph
    if graph.hybrid is not None:
        raise NotImplementedError("a strip schedule permutes the node rows; build it anew")
    n, r, vs = mesh.world_size, mesh.rank, graph.shard_nodes

    def rows(a, fill=0):
        return torch.as_tensor(shard_rows(a, n, fill=fill)[r * vs:(r + 1) * vs]).to(mesh.device)

    model, _ = loop.model_from_config(cfg, data)
    model.to(mesh.device)
    labels = data.labels.astype(np.float32 if data.multilabel else np.int64)
    return dataclasses.replace(
        state, model=model, optimizer=loop.optimizer_from_config(cfg, model),
        generator=torch.Generator(device=mesh.device).manual_seed(sharded.rank_seed(cfg.seed, r)),
        feats=rows(data.features.astype(np.float32)), labels=rows(labels),
        masks=tuple(rows(m, fill=False) for m in (data.train_mask, data.val_mask, data.test_mask)),
        epoch_times=[], losses=[], step_bytes={})


class ShardedProgram(Program):
    """One rank's part of a row-partitioned training run from the harness's
    initial weights. Its readings are the run's: the loss and the accuracies
    are summed over the ranks by the program, the gradients and parameters
    are every rank's alike (rank 0's are read). After each epoch it keeps
    what the mesh's `ByteCounter` received since the train step reset it:
    the epoch's train step and evaluation (`comm_recv`)."""

    def __init__(self, state, data: GraphData, weights: dict, fault=None):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
        self.state, self.fault, self.mesh = state, fault, state.mesh
        self.device = state.mesh.device
        state.model.load_state_dict(weights)
        self.initial = weights
        self.train_step = sharded.make_sharded_train_step(state.model, state.optimizer,
                                                          data.multilabel, state.mesh)
        self.eval_step = sharded.make_sharded_eval_step(state.model, data.multilabel, state.mesh,
                                                        loop.dataset_metric(data))
        self.feats, self.labels, self.masks = state.feats, state.labels, state.masks
        global_masks = (data.train_mask, data.val_mask, data.test_mask)
        self.mask_sizes = [int(np.count_nonzero(m)) for m in global_masks]
        self.loss_mask = self.masks[0]
        if fault == "half_batch":
            nodes = np.flatnonzero(data.train_mask)
            half = np.zeros_like(data.train_mask)
            half[nodes[: nodes.size // 2]] = True
            n, r, vs = self.mesh.world_size, self.mesh.rank, state.graph.shard_nodes
            self.loss_mask = torch.as_tensor(
                shard_rows(half, n, fill=False)[r * vs:(r + 1) * vs]).to(self.device)
        if fault == "unchanged":
            state.optimizer.step = lambda *args, **kwargs: None
        self.comm_recv = []

    def resolved_mode(self) -> str:
        g = self.state.graph
        return resolve_mode(self.state.model.conv0.kernel_mode, g.fwd_tiles is not None,
                            g.hybrid is not None).value

    def after_epoch(self) -> None:
        self.comm_recv.append(self.mesh.bytes.total_recv())
