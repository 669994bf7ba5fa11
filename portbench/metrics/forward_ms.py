"""forward_ms: device time of the train step's forward (the model and the
masked loss; the program's `train.forward` span, CUDA events on the step's
stream), ms a traced epoch. Layer: model (`models/models.py`,
`models/layers.py`)."""

from portbench.metrics._recorder import span_ms


def read(record):
    return span_ms(record, ("train.forward",))
