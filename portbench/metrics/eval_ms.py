"""eval_ms: the host clock around the evaluation (the eval forward and the
train / val / test accuracy read to the host), mean over the traced epochs,
in ms. Layer: train loop (`train/loop.make_eval_step`, `train/metrics.py`)."""


def read(record):
    evals = [t2 - t1 for _, t1, t2, _ in record["stamps"]]
    return 1e3 * sum(evals) / len(evals) if evals else None
