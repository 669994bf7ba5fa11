"""Optimizers — port of `maxk_tpu/train/optim.py` without Lookahead.

`optax.adam` and `torch.optim.Adam` compute the same update (bias
correction, eps outside the square root); `optax.adamw`'s decoupled decay
is `torch.optim.AdamW`'s. Neither amsgrad nor the fused path is used.
"""

from __future__ import annotations

import torch


def build_optimizer(params, lr: float, weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """Adam, or AdamW when `weight_decay > 0`, with optax's defaults
    (b1=0.9, b2=0.999, eps=1e-8)."""
    kw = dict(lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if weight_decay > 0:
        return torch.optim.AdamW(params, weight_decay=weight_decay, **kw)
    return torch.optim.Adam(params, **kw)
