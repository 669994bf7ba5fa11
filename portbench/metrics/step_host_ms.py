"""step_host_ms: host time of the train step's forward, backward and
optimizer spans, ms a traced epoch: how long the host takes to issue the
step. Far under `train_step_ms` where the host leads the device; near it
where something in the step waits for the device. Layer: train loop
(`train/loop.make_train_step`)."""

from portbench.metrics._recorder import span_ms


def read(record):
    return span_ms(record, ("train.forward", "train.backward", "train.optimizer"), clock="host")
