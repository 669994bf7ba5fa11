"""What the readers of the program's own spans and counters share.

The program keeps them in its recorder, the module `maxk_tpu_torch.
telemetry`, which `portbench/program.py` has loaded with the program. A
reader looks the module up among the loaded ones and reads it; it imports
nothing of the program. A program without the recorder gives None, and the
harness leaves the metric out.

The window is the traced epochs' host stamps, first start to last loss
read (`time.perf_counter` seconds, the clock of the recorder's
`perf_counter_ns`): the profiler's warm-up epoch, which `trace.traced` runs
before it, lies outside.
"""

import math
import sys

RECORDER = "maxk_tpu_torch.telemetry"


def recorder():
    return sys.modules.get(RECORDER)


def window_ns(record):
    """(since, until) in ns of the traced epochs, or None without any."""
    stamps = record.get("stamps")
    if not stamps:
        return None
    return math.floor(stamps[0][0] * 1e9), math.ceil(stamps[-1][3] * 1e9)


def span_ms(record, names, clock="device"):
    """The spans named `names` inside the window, in ms a traced epoch:
    their device time (`clock` "device"), or their host time ("host").
    None where none was recorded or, on the device clock, one has no device
    time (the CPU)."""
    rec, window = recorder(), window_ns(record)
    if rec is None or window is None:
        return None
    spans = [r for r in rec.records(*window) if r[0] in names]
    if not spans:
        return None
    if clock == "host":
        return sum(end - start for _, start, end, _ in spans) / 1e6 / len(record["stamps"])
    if any(device_s is None for *_, device_s in spans):
        return None
    return 1e3 * sum(device_s for *_, device_s in spans) / len(record["stamps"])


def counter_per_epoch(record, name):
    """The counter `name` summed over the window's steps, a traced epoch;
    None where it was not counted."""
    rec, window = recorder(), window_ns(record)
    if rec is None or window is None:
        return None
    total = rec.counters(*window).get(name)
    return None if total is None else total / len(record["stamps"])
