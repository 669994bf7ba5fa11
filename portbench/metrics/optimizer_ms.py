"""optimizer_ms: device time of the train step's Adam step (the program's
`train.optimizer` span), ms a traced epoch. Layer: train loop
(`train/optim.py`)."""

from portbench.metrics._recorder import span_ms


def read(record):
    return span_ms(record, ("train.optimizer",))
