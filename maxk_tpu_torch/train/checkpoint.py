"""Checkpoints and resume. Port of `maxk_tpu/train/checkpoint.py`.

The reference's layout: `<dir>/ckpt_<step>/` for the periodic checkpoints
and `<dir>/best/` for the best validation value so far, each holding one
payload file here (`PAYLOAD`), written with `torch.save` and read with
`torch.load(weights_only=True)`. A payload is a dict of tensors, numbers,
strings and lists; the training loop's (`train.loop.checkpoint_payload`)
holds the model's state_dict (BatchNorm buffers included), the
optimizer's (Lookahead's slow weights included), the epoch, the best
metrics and the dropout generator's state. A file is written under a
temporary name and renamed, so a reader never sees half of one.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import torch

PAYLOAD = "state.pt"


def _write(path: str, payload: Dict[str, Any]) -> str:
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, PAYLOAD + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, PAYLOAD))
    return path


def save_checkpoint(directory: str, payload: Dict[str, Any], step: int,
                    is_best: bool = False) -> str:
    """Write `directory/ckpt_<step>`; with `is_best`, copy it to `best/`."""
    directory = os.path.abspath(directory)
    path = _write(os.path.join(directory, f"ckpt_{step}"), payload)
    if is_best:
        best = os.path.join(directory, "best")
        os.makedirs(best, exist_ok=True)
        shutil.copyfile(os.path.join(path, PAYLOAD), os.path.join(best, PAYLOAD + ".tmp"))
        os.replace(os.path.join(best, PAYLOAD + ".tmp"), os.path.join(best, PAYLOAD))
    return path


def save_best(directory: str, payload: Dict[str, Any]) -> str:
    """Overwrite `directory/best` with `payload` (called on every
    improvement of the validation value)."""
    return _write(os.path.join(os.path.abspath(directory), "best"), payload)


def latest_checkpoint(directory: str) -> Optional[str]:
    """The `ckpt_<step>` directory of `directory` with the largest step, or
    None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        if d.startswith("ckpt_"):
            try:
                steps.append(int(d.split("_", 1)[1]))
            except ValueError:
                pass
    if not steps:
        return None
    return os.path.join(directory, f"ckpt_{max(steps)}")


def restore_checkpoint(path: str) -> Dict[str, Any]:
    """The payload of the checkpoint directory `path`, on the CPU (the
    generator's state must be a CPU tensor; `load_state_dict` moves the
    rest to the parameters' device)."""
    return torch.load(os.path.join(path, PAYLOAD), map_location="cpu", weights_only=True)
