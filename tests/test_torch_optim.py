"""The port's optimizers (maxk_tpu_torch/train/optim.py) against the JAX
package's optax chains on the same parameters and gradients, made with
numpy from a seed: Adam or AdamW, with Lookahead over 2k + 1 steps.

Tolerance, for each tensor: max|got - ref| <= 1e-6 · max|ref| + 2e-5 ·
max|ref - p0|, p0 the parameters before the first step. The first term
covers rounding (optax applies Lookahead as p + (where(sync, slow, p + u)
- p), which the port's p + u need not equal bit for bit); the second the
updates' own difference: optax takes Adam's bias correction 1 - b2^t in
f32, `torch.optim.Adam` in f64, which moves the first update by 6.4e-6
relative. The state_dict round trip is exact."""

import copy
import io

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maxk_tpu.train.optim import build_optimizer as jax_build_optimizer
from maxk_tpu_torch.train.optim import Lookahead, build_optimizer

torch.set_num_threads(1)

SHAPES = [(7, 5), (5,), (3, 2)]


def _close(got, ref, p0):
    got, ref, p0 = (np.asarray(a, np.float64) for a in (got, ref, p0))
    err = np.abs(got - ref).max()
    assert err <= 1e-6 * np.abs(ref).max() + 2e-5 * np.abs(ref - p0).max(), err


def _inputs(seed, steps):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    params[1][:] = 0.0  # a bias that starts at 0
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES] for _ in range(steps)]
    return params, grads


def _torch_run(params, grads, **kw):
    ps = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = build_optimizer(ps, 0.01, **kw)
    for g in grads:
        for p, a in zip(ps, g):
            p.grad = torch.from_numpy(a.copy())
        opt.step()
    return ps, opt


@pytest.mark.parametrize("k", [2, 5])
@pytest.mark.parametrize("weight_decay", [0.0, 5e-4], ids=["adam", "adamw"])
def test_lookahead_matches_optax(k, weight_decay):
    params, grads = _inputs(k, 2 * k + 1)
    tx = jax_build_optimizer(0.01, weight_decay, enable_lookahead=True, lookahead_k=k)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, updates)
    ps, opt = _torch_run(params, grads, weight_decay=weight_decay, enable_lookahead=True,
                         lookahead_k=k)
    assert isinstance(opt, Lookahead)
    assert opt.step_count == int(state[1].step) == 2 * k + 1
    for p, q, p0 in zip(ps, jp, params):
        _close(p.detach(), q, p0)
    for s, q, p0 in zip(opt.slow, state[1].slow, params):
        _close(s, q, p0)


def test_lookahead_syncs_every_k_steps():
    """The slow weights stay at the initial parameters for k - 1 steps; at
    step k they move alpha of the way and the parameters take them."""
    params, grads = _inputs(0, 3)
    ps, opt = _torch_run(params, grads[:2], enable_lookahead=True, lookahead_k=3,
                         lookahead_alpha=0.25)
    for s, p0 in zip(opt.slow, params):
        assert np.array_equal(s.numpy(), p0)
    fast = [p.detach().clone() for p in ps]
    adam_only = [torch.nn.Parameter(f.clone()) for f in fast]
    # the fast step Adam takes at step 3, from the same moments
    base = torch.optim.Adam(adam_only, lr=0.01, betas=(0.9, 0.999), eps=1e-8)
    base.load_state_dict(copy.deepcopy(opt.base.state_dict()))  # its own moments
    for p, a in zip(adam_only, grads[2]):
        p.grad = torch.from_numpy(a.copy())
    base.step()
    for p, a in zip(ps, grads[2]):
        p.grad = torch.from_numpy(a.copy())
    opt.step()
    for p, s, p0, f in zip(ps, opt.slow, params, adam_only):
        want = torch.from_numpy(p0) + 0.25 * (f.detach() - torch.from_numpy(p0))
        torch.testing.assert_close(s, want, rtol=1e-6, atol=1e-7)
        assert torch.equal(p.detach(), s)


def test_lookahead_state_dict_round_trip():
    """state_dict → torch.save → torch.load(weights_only=True) → a fresh
    optimizer on copies of the parameters: both continue bit for bit."""
    params, grads = _inputs(1, 7)
    ps, opt = _torch_run(params, grads[:3], enable_lookahead=True, lookahead_k=2)
    buf = io.BytesIO()
    torch.save(opt.state_dict(), buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    assert saved["step"] == 3 and len(saved["slow"]) == len(SHAPES)
    ps2 = [torch.nn.Parameter(p.detach().clone()) for p in ps]
    opt2 = build_optimizer(ps2, 0.01, enable_lookahead=True, lookahead_k=2)
    opt2.load_state_dict(saved)
    assert opt2.step_count == 3
    for g in grads[3:]:
        for a_ps in (ps, ps2):
            for p, a in zip(a_ps, g):
                p.grad = torch.from_numpy(a.copy())
        opt.step()
        opt2.step()
    for a, b in zip(ps + opt.slow, ps2 + opt2.slow):
        assert torch.equal(a.detach(), b.detach())


def test_build_optimizer_without_lookahead():
    ps = [torch.nn.Parameter(torch.zeros(3))]
    assert type(build_optimizer(ps, 0.01)) is torch.optim.Adam
    assert type(build_optimizer(ps, 0.01, weight_decay=1e-4)) is torch.optim.AdamW
    with pytest.raises(ValueError, match="lookahead k"):
        build_optimizer(ps, 0.01, enable_lookahead=True, lookahead_k=0)
