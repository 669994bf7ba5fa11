"""The traced run: a few whole epochs under `torch.profiler`, reduced in memory.

Nothing is written to disk. The reduction keeps, from the profiler's events:
the device operations (kernels, copies, sets) by name with their count and
seconds, the device's busy time as the union of their intervals (a corrected
copy of `chip_smoke.device_busy`, which summed durations and kept no gaps),
the traced window (the first epoch span's start to the last one's end; the
operations outside it are left out), each operation's interval in it (so
that a reader can take what one kind of operation did not overlap), and
the idle gaps, each labelled by the harness's span (`portbench.*`) in which
the device went idle.
"""

from __future__ import annotations

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

SPANS = ("portbench.train_step", "portbench.eval_step", "portbench.loss_read")
ANNOTATIONS = ("portbench.", "nccl:")
TOP = 10


def short_name(name: str) -> str:
    """A kernel's name without its argument list and leading `void `; copies
    and sets as the profiler names them."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(", 1)[0].strip() or name


def merge(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def overlap(a, b) -> float:
    """The length that two lists of sorted disjoint intervals share."""
    i = j = 0
    out = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return out


def reduce(events) -> dict:
    """The record of a traced window from the profiler's `events()`."""
    device, spans, epochs = [], [], []
    for e in events:
        t = (e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            # device-side marks of ranges, not operations: the harness's spans, and
            # torch.distributed's `nccl:<collective>` around each NCCL kernel
            if not e.name.startswith(ANNOTATIONS):
                device.append((e.name, *t))
        elif e.name == "portbench.epoch":
            epochs.append(t)
        elif e.name in SPANS:
            spans.append((t[0], t[1], e.name.split(".", 1)[1]))
    if not epochs:
        raise ValueError("the trace holds no portbench.epoch span")
    lo, hi = min(s for s, _ in epochs), max(e for _, e in epochs)
    device = [d for d in device if d[2] > lo and d[1] < hi]
    ops, intervals = {}, []
    for name, start, end in device:
        n = short_name(name)
        count, us = ops.get(n, (0, 0.0))
        ops[n] = (count + 1, us + (end - start))
        intervals.append((n, (max(start, lo) - lo) / 1e6, (min(end, hi) - lo) / 1e6))
    busy = merge((max(s, lo), min(e, hi)) for _, s, e in device)
    gaps, cursor = [], lo
    for start, end in busy + [[hi, hi]]:
        if start > cursor:
            gaps.append((cursor, start))
        cursor = max(cursor, end)

    def label(t):
        for s, e, name in spans:
            if s <= t < e:
                return name
        return "between_spans"

    idle = sorted(((label(s), (e - s) / 1e6) for s, e in gaps), key=lambda g: -g[1])
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "ops": {n: {"count": c, "seconds": us / 1e6} for n, (c, us) in ops.items()},
        "intervals": intervals,
        "idle_gaps": idle,
    }


def traced(program, epochs: int, cuda: bool):
    """(record, each epoch's host stamps, each epoch's loss) of `epochs`
    epochs of `program` under the profiler, CUDA activity included on a
    card. One more epoch runs first under the profiler, outside the traced
    window: the profiler's own start-up (tens of ms) would read as idle."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    stamps, losses = [], []
    with profile(activities=acts) as prof:
        program.epoch()
        for _ in range(epochs):
            loss, _, st = program.epoch(trace=True)
            stamps.append(st)
            losses.append(loss)
    return reduce(prof.events()), stamps, losses


def breakdown(record: dict) -> dict:
    """The result line's `breakdown`: the device operations with the most
    time and the longest idle gaps, at most TOP each, in seconds."""
    ops = sorted(record["ops"].items(), key=lambda kv: -kv[1]["seconds"])[:TOP]
    return {"device_ops": [[n, v["seconds"]] for n, v in ops],
            "idle_gaps": [[n, s] for n, s in record["idle_gaps"][:TOP]]}
