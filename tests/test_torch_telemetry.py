"""The port's recorder (`maxk_tpu_torch.telemetry`): off it keeps nothing,
on (a profiler session or `enabled()`) the train step's three phases nest
in the step, a counter added from another thread is kept, the window
drops what lies outside it, the aggregation's gather bytes follow the path
taken, `build_graph`'s phases fit in its time, `--profile_kernels` logs the
split from the spans, and the benchmark's readers of all this.

This file imports torch, maxk_tpu_torch and portbench's readers only, so
its `cuda` test also runs where jax is not installed:

    python -m pytest --noconftest tests/test_torch_telemetry.py -q
"""

import sys
import threading
import time
import types

import pytest
import torch

from maxk_tpu_torch import telemetry
from maxk_tpu_torch.data.datasets import GraphData
from maxk_tpu_torch.data.synthetic import planted_partition_data, rmat_graph
from maxk_tpu_torch.ops.spgemm import maxk_spgemm, spmm
from maxk_tpu_torch.sparse.cbsr import CBSR
from maxk_tpu_torch.sparse.graph import build_graph
from maxk_tpu_torch.train import loop
from maxk_tpu_torch.train.config import TrainConfig

torch.set_num_threads(1)

LAYERS, HIDDEN = 2, 32
TRAIN_PHASES = ("train.forward", "train.backward", "train.optimizer")
READERS = ("forward_ms", "backward_ms", "optimizer_ms", "step_host_ms", "eval_forward_ms",
           "agg_gather_gb", "build_host_s")


@pytest.fixture(autouse=True)
def fresh_recorder():
    telemetry.clear()
    yield
    telemetry.clear()


def _data(seed=7):
    csr = rmat_graph(200, 1500, seed=seed)
    feats, labels, masks = planted_partition_data(csr, 16, 5, seed=seed)
    return GraphData(name="tiny", csr=csr, features=feats, labels=labels, train_mask=masks[0],
                     val_mask=masks[1], test_mask=masks[2], num_classes=5, multilabel=False)


class Run:
    """A tiny MaxK-SAGE run: the state, its train and eval steps and the
    device arrays, on `device`."""

    def __init__(self, device="cpu", kernel_mode="segsum", **extra):
        self.data = _data()
        self.cfg = TrainConfig(dataset="tiny", hidden_dim=HIDDEN, hidden_layers=LAYERS, maxk=4,
                               dropout=0.5, lr=0.01, kernel_mode=kernel_mode, device=device,
                               **extra)
        self.state = loop.setup(self.cfg, self.data)
        self.train_step = loop.make_train_step(self.state.model, self.state.optimizer, False)
        self.eval_step = loop.make_eval_step(self.state.model)
        self.feats, self.labels, self.masks = loop._device_arrays(self.data, self.state.device)

    def step(self):
        return self.train_step(self.state.graph, self.feats, self.labels, self.masks[0],
                               self.state.generator)

    def epoch(self):
        """One epoch as the benchmark times it: its host stamps (start,
        step done, evaluation read, loss read)."""
        t0 = time.perf_counter()
        loss, _ = self.step()
        loop.synchronize(self.state.device)
        t1 = time.perf_counter()
        tuple(float(a) for a in self.eval_step(self.state.graph, self.feats, self.labels,
                                               self.masks))
        t2 = time.perf_counter()
        float(loss)
        return t0, t1, t2, time.perf_counter()


def test_off_records_nothing_and_makes_no_event(monkeypatch):
    run = Run()

    def no_event(*a, **kw):
        raise AssertionError("a CUDA event was made with the recorder off")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    launches = dict(telemetry.launches)
    assert not telemetry.active()
    run.epoch()
    with telemetry.step("train", torch.device("cuda")), telemetry.span("train.forward"):
        telemetry.count("agg.calls.k9", 1)
    assert [r for r in telemetry.records() if not r[0].startswith("build")] == []
    assert telemetry.counters() == {}
    assert dict(telemetry.launches) == launches
    assert not telemetry.recording()


def test_profiler_session_records_the_three_phases_inside_the_step():
    run = Run()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert telemetry.active()
        run.step()
    assert not telemetry.active() and not telemetry.recording()
    spans = [r for r in telemetry.records() if not r[0].startswith("build")]
    steps = [r for r in spans if r[0] == "train"]
    assert len(steps) == 1
    _, start, end, device_s = steps[0]
    assert device_s is None  # the CPU: host clock only
    inner = [r for r in spans if r[0] != "train"]
    assert sorted(r[0] for r in inner) == sorted(TRAIN_PHASES)
    assert all(start <= s <= e <= end and d is None for _, s, e, d in inner)


class FakeEvent:
    """A stand-in for `torch.cuda.Event` that logs its calls."""

    log = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None

    def record(self, stream=None):
        FakeEvent.log.append(("record", stream))
        self.t = len(FakeEvent.log)

    def synchronize(self):
        FakeEvent.log.append(("synchronize", None))

    def elapsed_time(self, end):
        return 1e3 * (end.t - self.t)  # ms: a second a call in between


def test_on_a_cuda_step_spans_take_events_on_its_stream_resolved_when_read(monkeypatch):
    """A step on a CUDA device keeps host time only; each span records a
    pair of events on the stream current at the step's start, and nothing
    waits for them until a record is read."""
    FakeEvent.log = []
    stream = object()
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)
    with telemetry.enabled(), telemetry.step("train", torch.device("cuda")):
        with telemetry.span("train.forward"):
            pass
        with telemetry.span("train.backward"):
            pass
    assert FakeEvent.log == [("record", stream)] * 4
    got = {name: device_s for name, _, _, device_s in telemetry.records()}
    assert got == {"train": None, "train.forward": 1.0, "train.backward": 1.0}
    assert [e for e, _ in FakeEvent.log].count("synchronize") == 2
    telemetry.records()  # resolved once
    assert [e for e, _ in FakeEvent.log].count("synchronize") == 2


def test_a_counter_from_another_thread_is_kept():
    """Autograd runs a CUDA backward on a device thread, where the
    profiler's flag reads False: the step's decision, not the thread's,
    keeps the count."""
    seen = {}

    def worker():
        seen["active"] = telemetry.active()
        telemetry.count("agg.calls.k9", 3)

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with telemetry.step("train"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    assert seen["active"] is False
    assert telemetry.counters() == {"agg.calls.k9": 3}


def test_the_window_drops_what_lies_outside():
    with telemetry.enabled():
        for name in ("a", "b", "c"):
            with telemetry.step(name):
                telemetry.count("n", 1)
            time.sleep(0.002)
    (_, _, a_end, _), (_, b_start, b_end, _), (_, c_start, _, _) = telemetry.records()
    assert [r[0] for r in telemetry.records(a_end + 1, c_start - 1)] == ["b"]
    assert [r[0] for r in telemetry.records(b_start)] == ["b", "c"]
    assert [r[0] for r in telemetry.records(0, b_end)] == ["a", "b"]
    assert telemetry.counters(a_end + 1, c_start - 1) == {"n": 1}
    assert telemetry.counters() == {"n": 3}


def test_records_stay_bounded(monkeypatch):
    monkeypatch.setattr(telemetry, "_records", type(telemetry._records)(maxlen=8))
    with telemetry.enabled():
        for _ in range(20):
            with telemetry.step("s"), telemetry.span("s.inner"):
                pass
    assert len(telemetry.records()) == 8


def test_enabled_restores_the_setting():
    assert not telemetry.active()
    with pytest.raises(RuntimeError):
        with telemetry.enabled():
            assert telemetry.active()
            raise RuntimeError
    assert not telemetry.active()
    with telemetry.enabled(False):
        assert not telemetry.active()


def _epoch_counters(run):
    """The counters of one epoch of `run` (train step and evaluation). MaxK:
    K10 in both forwards (k f32 values and k int16 selectors an edge), K11
    in the backward (k values); ReLU: K9 over (V, D) f32 rows, three times
    a layer."""
    nnz, k = run.state.graph.nnz, run.cfg.maxk
    if run.cfg.nonlinear == "maxk":
        return {"agg.gather_bytes": nnz * k * (2 * LAYERS * (4 + 2) + LAYERS * 4),
                "agg.calls.k10": 2 * LAYERS, "agg.calls.k11": LAYERS}
    return {"agg.gather_bytes": nnz * HIDDEN * 4 * 3 * LAYERS, "agg.calls.k9": 3 * LAYERS}


@pytest.mark.parametrize("nonlinear", ["maxk", "relu"])
def test_gather_bytes_of_a_sage_epoch(nonlinear):
    """A MaxK SAGE layer aggregates through the CBSR pair, a ReLU one its
    (V, D) f32 features with K9: forward and backward in the train step,
    forward in the evaluation."""
    run = Run(nonlinear=nonlinear)
    with telemetry.enabled():
        run.epoch()
    assert telemetry.counters() == _epoch_counters(run)
    train = [r for r in telemetry.records() if r[0] == "train"]
    assert len(train) == 1


@pytest.mark.parametrize("mode, path", [("segsum", "k9"), ("tiles_xla", "tiles_xla"),
                                        ("tiles_scan", "tiles_scan"), ("hybrid", "hybrid")])
def test_spmm_counts_by_path(mode, path):
    data = _data()
    graph = build_graph(data.csr, norm="right", build_tiles=mode.startswith("tiles"),
                        hybrid=mode == "hybrid", row_block=8, edge_tile=256, dim=HIDDEN)
    x = torch.randn(graph.num_nodes, HIDDEN, requires_grad=True)
    with telemetry.enabled(), telemetry.step("s"):
        spmm(graph, x, mode=mode).sum().backward()
    assert telemetry.counters() == {"agg.gather_bytes": 2 * graph.nnz * HIDDEN * 4,
                                    f"agg.calls.{path}": 2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_maxk_spgemm_counts_k_not_d(dtype):
    """K10 reads each edge's source row of k values and k int16 merged
    selectors; K11 gathers k values an edge."""
    data = _data()
    graph = build_graph(data.csr, norm="right")
    v, k = graph.num_nodes, 4
    vals = torch.randn(v, k, requires_grad=True)
    sel = torch.stack([torch.randperm(HIDDEN)[:k] for _ in range(v)]).int()
    with telemetry.enabled(), telemetry.step("s"):
        maxk_spgemm(graph, CBSR(vals, sel), dim=HIDDEN, mode="segsum",
                    compute_dtype=None if dtype == torch.float32 else dtype).sum().backward()
    item = torch.empty((), dtype=dtype).element_size()
    assert telemetry.counters() == {
        "agg.gather_bytes": graph.nnz * k * (item + 2) + graph.nnz * k * item,
        "agg.calls.k10": 1, "agg.calls.k11": 1}


def test_build_phases_fit_in_build_graph():
    data = _data()
    t0 = time.perf_counter_ns()
    build_graph(data.csr, norm="right", build_tiles=True, row_block=8, edge_tile=256)
    host = time.perf_counter_ns() - t0
    spans = telemetry.records(t0)
    (_, start, end, device_s), = [r for r in spans if r[0] == "build"]
    assert device_s is None and end - start <= host
    phases = {r[0]: r for r in spans if r[0].startswith("build.")}
    assert set(phases) == {"build.norm", "build.transpose", "build.symmetry", "build.segments",
                           "build.tiles"}  # no device: nothing moved
    assert all(start <= s <= e <= end for _, s, e, _ in phases.values())
    assert sum(e - s for _, s, e, _ in phases.values()) <= end - start


def test_profile_kernels_logs_the_split_from_the_spans(monkeypatch):
    """`--profile_kernels` switches the recorder on for the run and logs the
    forward / backward / optimizer split every 10 epochs after the warm-up,
    with no evaluation forward of its own."""
    data = _data()
    cfg = TrainConfig(dataset="tiny", hidden_dim=HIDDEN, hidden_layers=LAYERS, maxk=4,
                      dropout=0.5, lr=0.01, kernel_mode="segsum", device="cpu", epochs=11,
                      profile_kernels=True)
    lines, forwards = [], []
    logger = types.SimpleNamespace(info=lines.append)
    real = loop.build_model

    def counting(*a, **kw):
        model, norm = real(*a, **kw)
        model.register_forward_hook(lambda *_: forwards.append(1))
        return model, norm

    monkeypatch.setattr(loop, "build_model", counting)
    state = loop.train(cfg, data, logger=logger, warmup_epochs=0)
    profiles = [x for x in lines if x.startswith("  profile:")]
    assert len(profiles) == 2  # epochs 0 and 10
    for line in profiles:
        assert all(f"{p} " in line for p in ("forward", "backward", "optimizer"))
        assert line.endswith("ms step") and "(host)" in line
    assert len(forwards) == 2 * cfg.epochs  # a train and an eval forward an epoch
    assert len(state.losses) == cfg.epochs
    assert not telemetry.active()


# --- the benchmark's readers of the spans and counters -----------------------


def _reader(name):
    from portbench import registry

    return registry.reader(name)


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_on_an_empty_record(name, monkeypatch):
    assert _reader(name).read({"stamps": []}) is None
    # a program without the recorder: every reader finds nothing
    monkeypatch.delitem(sys.modules, "maxk_tpu_torch.telemetry")
    assert _reader(name).read({"stamps": [(0.0, 1.0, 2.0, 3.0)]}) is None


def test_readers_on_a_recorded_cpu_run():
    run = Run()
    stamps = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        run.epoch()  # the profiler's warm-up epoch, outside the window
        for _ in range(2):
            stamps.append(run.epoch())
    record = {"stamps": stamps}
    got = {name: _reader(name).read(record) for name in READERS}
    since = int(stamps[0][0] * 1e9)
    spans = [r for r in telemetry.records(since) if r[0] in TRAIN_PHASES]
    assert len(spans) == 2 * 3
    host_ms = sum(e - s for _, s, e, _ in spans) / 1e6 / 2
    assert got["step_host_ms"] == pytest.approx(host_ms)
    assert got["agg_gather_gb"] == pytest.approx(_epoch_counters(run)["agg.gather_bytes"] / 1e9)
    build = [r for r in telemetry.records() if r[0] in ("build.norm", "build.transpose",
                                                          "build.symmetry")]
    assert got["build_host_s"] == pytest.approx(sum(e - s for _, s, e, _ in build) / 1e9)
    # the CPU has no device clock: the device readers stay out
    for name in ("forward_ms", "backward_ms", "optimizer_ms", "eval_forward_ms"):
        assert got[name] is None, name


def test_device_readers_sum_device_time_per_epoch(monkeypatch):
    """The device readers' arithmetic, on a recorder that holds device
    times: the spans of the window summed, over the traced epochs."""
    ms = 1_000_000
    held = [("train.forward", 5 * ms, 6 * ms, 0.004), ("train.backward", 6 * ms, 7 * ms, 0.006),
            ("train.optimizer", 7 * ms, 8 * ms, 0.0005), ("eval.forward", 9 * ms, 10 * ms, 0.003),
            ("train.forward", 15 * ms, 16 * ms, 0.002), ("train.optimizer", 17 * ms, 18 * ms,
                                                        0.0005),
            ("train.forward", 30 * ms, 31 * ms, 9.0)]  # after the window

    def records(since=0, until=None):
        return [r for r in held if r[1] >= since and (until is None or r[2] <= until)]

    fake = types.SimpleNamespace(records=records, counters=lambda since=0, until=None: {})
    monkeypatch.setitem(sys.modules, "maxk_tpu_torch.telemetry", fake)
    record = {"stamps": [(0.004, 0.0085, 0.0105, 0.011), (0.012, 0.0185, 0.019, 0.020)]}
    assert _reader("forward_ms").read(record) == pytest.approx(1e3 * 0.006 / 2)
    assert _reader("backward_ms").read(record) == pytest.approx(1e3 * 0.006 / 2)
    assert _reader("optimizer_ms").read(record) == pytest.approx(1e3 * 0.001 / 2)
    assert _reader("eval_forward_ms").read(record) == pytest.approx(1e3 * 0.003 / 2)
    assert _reader("step_host_ms").read(record) == pytest.approx(5.0 / 2)
    assert _reader("agg_gather_gb").read(record) is None


@pytest.mark.cuda
def test_on_the_card_backward_counts_and_spans_add_up():
    """On a card autograd runs the backward on its device thread: its K11
    calls count all the same, beside the forward's K10; the three phases'
    device times sum to within the step's synchronized host time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    run = Run(device="cuda")
    run.step()  # builds the kernels, warms the shapes
    torch.cuda.synchronize()
    with telemetry.enabled():
        t0 = time.perf_counter_ns()
        run.step()
        torch.cuda.synchronize()
        host_s = (time.perf_counter_ns() - t0) / 1e9
    counters = telemetry.counters()
    assert counters["agg.calls.k10"] == counters["agg.calls.k11"] == LAYERS
    assert "agg.calls.k9" not in counters
    phases = [r for r in telemetry.records(t0) if r[0] in TRAIN_PHASES]
    assert len(phases) == 3 and all(d is not None and d >= 0 for *_, d in phases)
    assert sum(d for *_, d in phases) <= host_s
