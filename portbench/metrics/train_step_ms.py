"""train_step_ms: the host clock around the train step (forward, loss,
backward, Adam) and the synchronize that ends it, mean over the traced
epochs, in ms. Layer: train loop (`train/loop.py`, `train/optim.py`)."""


def read(record):
    steps = [t1 - t0 for t0, t1, _, _ in record["stamps"]]
    return 1e3 * sum(steps) / len(steps) if steps else None
