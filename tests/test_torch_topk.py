"""The port's MaxK mask (ops/topk_cuda.py) against the Pallas `_mask_kernel`,
run in interpret mode: y and take exactly equal, exactly k survivors.

The CUDA kernel runs only on the card: tests/test_torch_cuda.py and
chip_smoke.py compare it with the plain version there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import maxk_tpu.ops.topk_pallas as tp
from maxk_tpu_torch.ops import topk_cuda
from maxk_tpu_torch.ops.topk_cuda import maxk_mask, maxk_mask_fast, maxk_mask_plain

torch.set_num_threads(1)

V = 48


def _rows(d: int, seed: int) -> np.ndarray:
    """Normal rows plus tie rows, a -0.0-among-+0.0 row, a constant row and
    all-negative rows, rounded to bf16-representable values."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((V, d)).astype(np.float32)
    x[:8] = rng.integers(-2, 3, (8, d))
    x[8] = 0.0
    x[8, ::3] = -0.0
    x[9] = 1.5
    x[10:14] = -np.abs(x[10:14]) - 1.0
    return torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()


def _bits(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("k", [1, 8, 32])
def test_plain_matches_pallas(k, d, dtype):
    x = _rows(d, seed=k + d)
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    y_ref, take_ref = tp._mask_pallas_raw(jx, k, True)
    y, take = maxk_mask_plain(torch.from_numpy(x).to(getattr(torch, dtype)), k)
    assert y.dtype == getattr(torch, dtype)
    # bit for bit, signed zeros included
    np.testing.assert_array_equal(_bits(y.to(torch.float32).numpy()), _bits(np.asarray(y_ref, np.float32)))
    np.testing.assert_array_equal(take.numpy(), np.asarray(take_ref, np.float32).astype(np.uint8))
    np.testing.assert_array_equal(take.numpy().sum(1), k)


def test_signed_zero_tie_rule():
    """For [-0., +0., +0., ...] and k=2 the TPU kernel keeps columns {1, 2}:
    -0.0 ranks below +0.0, and ties go to the lowest columns. A value sort
    would keep {0, 1}."""
    x = np.zeros((1, 128), np.float32)
    x[0, 0] = -0.0
    ref = np.asarray(tp._mask_pallas_raw(jnp.asarray(x), 2, True)[1], np.float32)
    _, take = maxk_mask_plain(torch.from_numpy(x), 2)
    assert np.flatnonzero(ref[0]).tolist() == [1, 2]
    assert np.flatnonzero(take.numpy()[0]).tolist() == [1, 2]


def test_wrapper_takes_plain_only_for_cpu():
    x = torch.from_numpy(_rows(128, seed=1))
    y, take = maxk_mask(x, 8)
    y0, take0 = maxk_mask_plain(x, 8)
    assert torch.equal(y, y0) and torch.equal(take, take0)
    with pytest.raises(ValueError, match="no implementation"):
        maxk_mask(torch.empty((4, 32), device="meta"), 2)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        topk_cuda.maxk_mask_cuda(x, 8)


def test_grad_matches_pallas_vjp(monkeypatch):
    """maxk_mask_fast's backward (g ⊙ take) against maxk_mask_pallas's VJP,
    with the Pallas kernel patched to interpret mode."""
    orig = tp._mask_pallas_raw
    monkeypatch.setattr(tp, "_mask_pallas_raw", lambda x, k, interpret=False: orig(x, k, True))
    x = _rows(256, seed=3)
    g = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a: tp.maxk_mask_pallas(a, 8), jnp.asarray(x))
    (gx_ref,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    maxk_mask_fast(xt, 8).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(gx_ref))

