"""The system under test: maxk_tpu_torch's training loop, driven epoch by epoch.

An epoch is the body of `maxk_tpu_torch.train.loop.train`'s loop: a
synchronize, the train step of `make_train_step` (forward, masked
cross-entropy, backward, Adam), a synchronize, the evaluation of
`make_eval_step` on the train, val and test masks read to the host, then the
loss read to the host. The state comes from `loop.setup` on the harness's
inputs, with the harness's initial weights loaded into the model. This is the
one module of the benchmark that imports the program.

Faults, planted for the tests and the calibration only (never in a benchmark
run): `unchanged` (the optimizer's step does nothing), `half_batch` (the loss
over the first half of the train mask's nodes, the mean taken over those),
`altered_rows` (every 100th row of each aggregation's output zeroed where it
is produced).
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.profiler import record_function

from maxk_tpu_torch.data.datasets import GraphData
from maxk_tpu_torch.ops import spgemm
from maxk_tpu_torch.ops.dispatch import resolve_mode
from maxk_tpu_torch.sparse.csr import CSRGraph
from maxk_tpu_torch.train import loop
from maxk_tpu_torch.train.config import TrainConfig

FAULTS = ("unchanged", "half_batch", "altered_rows")
ALTERED_EVERY = 100


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
    """The `altered_rows` fault: every ALTERED_EVERY-th row of each SpMM's
    output zeroed."""
    impl = spgemm._spmm_impl

    def altered(graph, x, mode, transpose):
        y = impl(graph, x, mode, transpose)
        y[::ALTERED_EVERY] = 0
        return y

    spgemm._spmm_impl = altered
    try:
        yield
    finally:
        spgemm._spmm_impl = impl


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
        self.state, self.fault = state, fault
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
        faulty = altered_rows() if self.fault == "altered_rows" else contextlib.nullcontext()
        with faulty, span("portbench.epoch"):
            t0 = time.perf_counter()
            with span("portbench.train_step"):
                loop.synchronize(st.device)
                loss, _ = self.train_step(st.graph, self.feats, self.labels, self.loss_mask,
                                          st.generator)
                loop.synchronize(st.device)
            t1 = time.perf_counter()
            with span("portbench.eval_step"):
                accs = tuple(float(a) for a in self.eval_step(st.graph, self.feats, self.labels,
                                                              self.masks))
            t2 = time.perf_counter()
            with span("portbench.loss_read"):
                loss = float(loss)
            t3 = time.perf_counter()
        return loss, accs, (t0, t1, t2, t3)

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
