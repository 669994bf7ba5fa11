"""eval_forward_ms: device time of the evaluation's forward (the program's
`eval.forward` span), ms a traced epoch; `eval_ms` less this is the
accuracy reads. Layer: model (`models/models.py`, `models/layers.py`)."""

from portbench.metrics._recorder import span_ms


def read(record):
    return span_ms(record, ("eval.forward",))
