"""backward_ms: device time of the train step's `loss.backward()` (the
program's `train.backward` span), ms a traced epoch. Layer: model
(`models/`, the backward rules of `ops/spgemm.py`)."""

from portbench.metrics._recorder import span_ms


def read(record):
    return span_ms(record, ("train.backward",))
