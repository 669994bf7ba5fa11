"""The port's one recorder: spans on the host and device clocks, named
counters, and the kernel launch counter.

- `step(name, device)` opens a top-level unit: the train step or the
  evaluation (`train/loop.make_train_step`, `make_eval_step`). On entry it
  decides `active()` once, on the calling thread, and holds the answer in
  module state until the step ends. Everything nested reads that state,
  code on autograd's device thread included: `torch.autograd.
  _profiler_enabled()` is thread-local and reads False there. Off, a step
  costs that one check, and each nested span or counter one read of module
  state: no CUDA event is made and nothing is kept.
- `span(name)` records a phase inside a step: its host start and end
  (`time.perf_counter_ns`, the clock of `time.perf_counter`) and, in a
  step on a CUDA device, a pair of timing events on the stream that was
  current when the step began. The events are resolved when a record is
  read, never inside a span, so a span adds no synchronize. A step itself
  keeps host time only: its events would fall where the device waits for
  the host (before the first launch and after the last), and each event
  costs host time there, the more under a profiler.
- `span(name, device=False)` is a host-clock set-up phase
  (`sparse/graph.build_graph`'s). It records always: a handful a process,
  never on the per-epoch path, and no device synchronize.
- `count(name, n)` adds n to a counter of the running step while it is on.
  The step's record keeps the counts (`ops/spgemm`'s `agg.*`).

`records(since_ns, until_ns)` and `counters(since_ns, until_ns)` read what
lies inside a host-clock window. Memory stays bounded: the last `RECORDS`
records of steps and their spans, and the last `SETUP` set-up records, so
a long profiler session does not grow it.

The spans are not `torch.profiler.record_function` ranges: under the
profiler's CUDA activity each such range also puts a device-side
annotation in the trace, which a reader of the trace would take for device
work.

`launches` counts every kernel launch by its wrapper's name, always on
(`ops/_native.launch`).
"""

from __future__ import annotations

import contextlib
import time
from collections import Counter, deque

import torch

RECORDS = 65536
SETUP = 1024

launches: Counter = Counter()

_forced = False  # `enabled()`: on without a profiler session
_on = False  # the running step's decision
_stream = None  # the running step's CUDA stream, where its spans take device time
_counts: dict = {}  # the running step's counters
_records: deque = deque(maxlen=RECORDS)
_setup: deque = deque(maxlen=SETUP)


class Record:
    """A span: name, host start and end in ns, its timing events (None on
    the CPU and for set-up spans) and, for a step, its counters."""

    __slots__ = ("name", "start_ns", "end_ns", "events", "counts", "_device_s")

    def __init__(self, name, start_ns, end_ns, events=None, counts=None):
        self.name, self.start_ns, self.end_ns = name, start_ns, end_ns
        self.events, self.counts, self._device_s = events, counts, None

    @property
    def device_s(self):
        """Device seconds between the span's events (waits for the end
        event on first read); None without events."""
        if self.events is not None:
            start, end = self.events
            end.synchronize()
            self._device_s = start.elapsed_time(end) / 1e3
            self.events = None
        return self._device_s


_NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "stream", "events", "store", "start_ns")

    def __init__(self, name: str, stream, store: deque):
        self.name, self.stream, self.store = name, stream, store
        self.events = None if stream is None else (torch.cuda.Event(enable_timing=True),
                                                   torch.cuda.Event(enable_timing=True))

    def __enter__(self):
        self.start_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[0].record(self.stream)
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(self.stream)
        self.store.append(Record(self.name, self.start_ns, time.perf_counter_ns(), self.events,
                                 self.counts()))
        return False

    def counts(self):
        return None


class _Step(_Span):
    __slots__ = ("device",)

    def __init__(self, name: str, device):
        super().__init__(name, None, _records)
        self.device = device

    def __enter__(self):
        global _on, _stream, _counts
        _on, _counts = True, {}
        _stream = torch.cuda.current_stream(self.device) if self.device is not None else None
        return super().__enter__()

    def __exit__(self, *exc):
        global _on, _stream
        try:
            return super().__exit__(*exc)
        finally:
            _on, _stream = False, None

    def counts(self):
        return _counts


def active() -> bool:
    """Whether a step begun now would record: a `torch.profiler` session
    records on the calling thread, or `enabled()` is in force."""
    return _forced or torch.autograd._profiler_enabled()


@contextlib.contextmanager
def enabled(on: bool = True):
    """The recorder on for the block without a profiler session, where
    `on` (`--profile_kernels`)."""
    global _forced
    was = _forced
    _forced = was or on
    try:
        yield
    finally:
        _forced = was


def recording() -> bool:
    """Whether a step is running with the recorder on."""
    return _on


def step(name: str, device=None):
    """A top-level unit whose work runs on `device`: its spans take device
    time on a CUDA device, host time only on the CPU (or None). Inside an
    active step it is a span."""
    if _on:
        return span(name)
    if not active():
        return _NULL
    cuda = device is not None and torch.device(device).type == "cuda"
    return _Step(name, torch.device(device) if cuda else None)


def span(name: str, device: bool = True):
    """A phase inside a step, timed on the device where the step is on a
    CUDA device; `device=False`: a host-clock set-up phase, recorded always."""
    if not device:
        return _Span(name, None, _setup)
    if not _on:
        return _NULL
    return _Span(name, _stream, _records)


def count(name: str, n: int) -> None:
    """Add n to the counter `name` of the running step, while on. One
    thread at a time adds: the caller's, or autograd's device thread while
    the caller waits in `backward`."""
    if _on:
        _counts[name] = _counts.get(name, 0) + n


def records(since_ns: int = 0, until_ns=None) -> list:
    """(name, host start ns, host end ns, device seconds or None) of every
    record that starts at or after `since_ns` and ends by `until_ns`
    (None: no end), set-up and step records together, by start."""
    out = [(r.name, r.start_ns, r.end_ns, r.device_s) for r in (*_setup, *_records)
           if r.start_ns >= since_ns and (until_ns is None or r.end_ns <= until_ns)]
    return sorted(out, key=lambda r: r[1])


def counters(since_ns: int = 0, until_ns=None) -> dict:
    """The counters of the steps inside the window, summed by name."""
    total = Counter()
    for r in tuple(_records):
        if r.counts and r.start_ns >= since_ns and (until_ns is None or r.end_ns <= until_ns):
            total.update(r.counts)
    return dict(total)


def clear() -> None:
    """Forget every record (the launch counter stays)."""
    _records.clear()
    _setup.clear()
