"""agg_gather_gb: the feature bytes the aggregation calls of a traced epoch
ask to gather (the program's `agg.gather_bytes` counter: each call's walked
edges times a gathered row's bytes, D features for K9, k values and
selectors for K10, k for K11), in GB (1e9 bytes) a traced epoch. Layer:
aggregation (`ops/spgemm.py`)."""

from portbench.metrics._recorder import counter_per_epoch


def read(record):
    n = counter_per_epoch(record, "agg.gather_bytes")
    return None if n is None else n / 1e9
