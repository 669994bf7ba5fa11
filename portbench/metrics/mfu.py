"""mfu: the epoch's model FLOPs (the configuration's reference
`model_flops` over the whole graph: GEMMs and aggregation, forward and
backward, however the program computes them) over the mean traced epoch
time times the peak of the run's cards (the record's `chips` × one card's
float32 peak), in %. Layer: model (`models/models.py`, `models/layers.py`)."""

from portbench import registry
from portbench.roofline import PEAK_FLOPS


def read(record):
    stamps = record["stamps"]
    if not stamps:
        return None
    epoch_s = (stamps[-1][3] - stamps[0][0]) / len(stamps)
    flops = registry.reference(record["config"]).model_flops(
        record["config"], record["traffic"], record["num_nodes"], record["live_edges"])
    dtype = "bfloat16" if record["traffic"].get("compute_dtype") == "bfloat16" else "float32"
    return 100.0 * flops / (epoch_s * record["chips"] * PEAK_FLOPS[dtype])
