"""comm_exposed_ms: the device time of the collectives' NCCL kernels that no
other device operation overlapped, in ms a traced epoch (rank 0's trace):
the union of the `nccl*` kernels' intervals less its overlap with the union
of every other operation's. None where no NCCL kernel ran. Layer:
collectives (`parallel/collectives.py`)."""

from portbench.trace import length, merge, overlap

PREFIX = "nccl"


def read(record):
    intervals = record["trace"].get("intervals") or []
    comm = merge((s, e) for n, s, e in intervals if n.startswith(PREFIX))
    if not comm or not record["stamps"]:
        return None
    other = merge((s, e) for n, s, e in intervals if not n.startswith(PREFIX))
    return 1e3 * (length(comm) - overlap(comm, other)) / len(record["stamps"])
