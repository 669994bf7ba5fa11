"""build_host_s: host time of `build_graph`'s host round trip in set-up:
the copy to the host and norm fold, the scipy transpose and the |A - Aᵀ|
check (the program's `build.norm`, `build.transpose` and `build.symmetry`
spans inside its last `build` span), in s. Layer: graph build
(`sparse/graph.py`, `sparse/csr.py`)."""

from portbench.metrics._recorder import recorder

PHASES = ("build.norm", "build.transpose", "build.symmetry")


def read(record):
    rec = recorder()
    if rec is None:
        return None
    spans = rec.records()
    builds = [r for r in spans if r[0] == "build"]
    if not builds:
        return None
    _, since, until, _ = builds[-1]
    return sum(end - start for name, start, end, _ in spans
               if name in PHASES and since <= start and end <= until) / 1e9
