"""Logging — port of `maxk_tpu/train/logging.py`.

`get_logger` is the file+stream logger; `ScalarWriter` appends JSONL
scalars. Experiment dirs follow `{path}/{dataset}_seed{seed}/{model}_{nonlinear}`.
"""

from __future__ import annotations

import json
import logging
import os
import time


def get_logger(path: str = "", name: str = "maxk_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fh = logging.FileHandler(path)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


def experiment_dir(cfg) -> str:
    d = os.path.join(
        cfg.path, f"{cfg.dataset}_seed{cfg.seed}", f"{cfg.model}_{cfg.nonlinear}"
    )
    os.makedirs(d, exist_ok=True)
    return d


class ScalarWriter:
    """Appends `{"tag", "value", "step", "ts"}` lines to `scalars.jsonl`."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._f = open(os.path.join(logdir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(
            json.dumps(
                {"tag": tag, "value": float(value), "step": int(step), "ts": time.time()}
            )
            + "\n"
        )

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()
