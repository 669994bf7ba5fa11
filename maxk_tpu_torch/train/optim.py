"""Optimizers — port of `maxk_tpu/train/optim.py`: Adam, and Lookahead over it.

`optax.adam` and `torch.optim.Adam` compute the same update (bias
correction, eps outside the square root); `optax.adamw`'s decoupled decay
is `torch.optim.AdamW`'s. Neither amsgrad nor the fused path is used.

`Lookahead` (`--enable_lookahead`, reference `optim.py:24-53`) wraps the
Adam: every k fast steps the slow weights move alpha of the way toward
the fast ones, and the fast weights take the slow values; Adam's moments
carry on. optax applies it as an update, p + (where(sync, slow, p + u) -
p), which on a step without a sync can round differently from Adam's own
p + u by an ulp; the port keeps Adam's p + u, so the two agree within a
tolerance (the tests hold 1e-6 relative after 2k + 1 steps), not bit for
bit.
"""

from __future__ import annotations

from typing import Union

import torch


class Lookahead:
    """Lookahead around an optimizer `base`: k fast steps, then slow ←
    slow + alpha·(fast − slow) and fast ← slow.

    The slow weights start as a copy of the parameters when the wrapper is
    built, with the step count at 0. `state_dict()` carries Adam's state,
    the slow weights and the step count, and `load_state_dict()` restores
    them; k and alpha are the wrapper's settings, as in the reference,
    whose Lookahead state holds the slow weights and the step alone."""

    def __init__(self, base: torch.optim.Optimizer, k: int = 5, alpha: float = 0.5):
        if k < 1:
            raise ValueError(f"lookahead k must be >= 1, got {k}")
        self.base, self.k, self.alpha = base, k, alpha
        self.params = [p for group in base.param_groups for p in group["params"]]
        self.slow = [p.detach().clone() for p in self.params]
        self.step_count = 0

    @property
    def param_groups(self):
        return self.base.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.base.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> None:
        self.base.step()
        self.step_count += 1
        if self.step_count % self.k == 0:
            for p, s in zip(self.params, self.slow):
                s.add_(p - s, alpha=self.alpha)
                p.copy_(s)

    def state_dict(self) -> dict:
        return {"base": self.base.state_dict(), "slow": [s.clone() for s in self.slow],
                "step": self.step_count}

    def load_state_dict(self, state: dict) -> None:
        if len(state["slow"]) != len(self.slow):
            raise ValueError(f"lookahead state has {len(state['slow'])} slow tensors, "
                             f"the optimizer {len(self.slow)}")
        self.base.load_state_dict(state["base"])
        with torch.no_grad():
            for s, saved in zip(self.slow, state["slow"]):
                s.copy_(saved)
        self.step_count = int(state["step"])


Optimizer = Union[torch.optim.Optimizer, Lookahead]


def build_optimizer(
    params,
    lr: float,
    weight_decay: float = 0.0,
    enable_lookahead: bool = False,
    lookahead_k: int = 5,
    lookahead_alpha: float = 0.5,
) -> Optimizer:
    """Adam, or AdamW when `weight_decay > 0`, with optax's defaults
    (b1=0.9, b2=0.999, eps=1e-8); wrapped in `Lookahead` when
    `enable_lookahead`."""
    kw = dict(lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if weight_decay > 0:
        base = torch.optim.AdamW(params, weight_decay=weight_decay, **kw)
    else:
        base = torch.optim.Adam(params, **kw)
    if enable_lookahead:
        return Lookahead(base, lookahead_k, lookahead_alpha)
    return base
