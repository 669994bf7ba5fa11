"""The port's top-k → CBSR (ops/topk_cuda.py, K4) against the Pallas
`_topk_kernel` run in interpret mode: selectors exactly equal and values
equal bit for bit, f32 values and int32 selectors for f32 and bf16 input;
and the `TopKCBSR` backward against `jax.vjp` of `topk_cbsr_pallas`.

The CUDA kernel runs only on the card: tests/test_torch_cuda.py and
chip_smoke.py compare it with the plain version there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import maxk_tpu.ops.topk_pallas as tp
from maxk_tpu_torch.ops import topk_cuda
from maxk_tpu_torch.ops.topk_cuda import maxk_cbsr_fast, maxk_mask_plain, topk_cbsr, topk_cbsr_plain

torch.set_num_threads(1)

V = 48


def _rows(d: int, seed: int) -> np.ndarray:
    """Normal rows plus tie rows, the signed-zero row [5, -0., -1, -2, ...],
    a -0.0-among-+0.0 row, a constant row, all-negative rows and a row
    with +inf, rounded to bf16-representable values."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((V, d)).astype(np.float32)
    x[:8] = rng.integers(-2, 3, (8, d))
    x[8] = -np.arange(d, dtype=np.float32)
    x[8, 0], x[8, 1] = 5.0, -0.0
    x[9] = 0.0
    x[9, ::3] = -0.0
    x[10] = 1.5
    x[11:14] = -np.abs(x[11:14]) - 1.0
    x[14, 3] = np.inf
    return torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,k", [(128, 1), (128, 8), (128, 32), (256, 32)])
def test_plain_matches_pallas(k, d, dtype):
    x = _rows(d, seed=k + d)
    vals_ref, sel_ref = tp._topk_pallas_raw(jnp.asarray(x, dtype=getattr(jnp, dtype)), k, True)
    vals, sel = topk_cbsr_plain(torch.from_numpy(x).to(getattr(torch, dtype)), k)
    assert vals.dtype == torch.float32 and sel.dtype == torch.int32
    np.testing.assert_array_equal(sel.numpy(), np.asarray(sel_ref))
    # bit for bit: a selected -0.0 is +0.0 in both
    np.testing.assert_array_equal(_bits(vals.numpy()), _bits(vals_ref))


def _hi16_tie_rows(d: int, seed: int) -> np.ndarray:
    """f32 rows whose values share their top 16 bits but differ below: a
    whole row (positive and negative), exactly 32 and 33 of a row, and a
    row whose shared top halves straddle the k-th place with ties below
    them too (as chip_smoke's tie rows); then normal rows. Not rounded to
    bf16, so the f32 search's low-half branches see them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((V, d)).astype(np.float32)
    j = np.arange(d, dtype=np.float64)
    x[0] = 1.0 + j * 2.0**-20
    x[1] = -1.0 - j * 2.0**-20
    for r, m in ((2, 32), (3, 33)):
        x[r] = 0.0
        x[r, :m] = 1.0 + j[:m] * 2.0**-20
    x[4] *= 0.1
    x[4, :10] = 5.0
    x[4, 10:40] = 3.0 + (j[:30] % 7) * 2.0**-20
    return x


@pytest.mark.parametrize("k", [8, 32, 33])
def test_plain_matches_pallas_hi16_ties(k):
    """float32 rows sharing their top 16 bits: the plain version against the
    Pallas kernel, selectors equal and values bit for bit."""
    x = _hi16_tie_rows(256, seed=k)
    vals_ref, sel_ref = tp._topk_pallas_raw(jnp.asarray(x), k, True)
    vals, sel = topk_cbsr_plain(torch.from_numpy(x), k)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(sel_ref))
    np.testing.assert_array_equal(_bits(vals.numpy()), _bits(vals_ref))


def test_signed_zero_row():
    """[5, -0.0, -1, -2, ...] with k=2: vals [5, +0.0], sel [0, 1]."""
    x = np.concatenate([[5.0, -0.0], -np.arange(1, 127, dtype=np.float32)])[None].astype(np.float32)
    vals_ref, sel_ref = tp._topk_pallas_raw(jnp.asarray(x), 2, True)
    vals, sel = topk_cbsr_plain(torch.from_numpy(x), 2)
    assert sel.tolist() == np.asarray(sel_ref).tolist() == [[0, 1]]
    assert _bits(vals.numpy()).tolist() == _bits(vals_ref).tolist() == _bits([[5.0, 0.0]]).tolist()


def test_same_taken_set_as_the_mask():
    """densify(topk_cbsr(x)) is maxk_mask(x)'s y, up to the sign of zeros."""
    x = torch.from_numpy(_rows(256, seed=2))
    vals, sel = topk_cbsr_plain(x, 16)
    y, take = maxk_mask_plain(x, 16)
    assert torch.equal(take.nonzero()[:, 1].view(V, 16).to(torch.int32), sel)
    assert torch.equal(torch.gather(y, 1, sel.long()), vals)


def test_wrapper_takes_plain_only_for_cpu():
    x = torch.from_numpy(_rows(128, seed=1))
    vals, sel = topk_cbsr(x, 8)
    vals0, sel0 = topk_cbsr_plain(x, 8)
    assert torch.equal(vals, vals0) and torch.equal(sel, sel0)
    with pytest.raises(ValueError, match="no implementation"):
        topk_cbsr(torch.empty((4, 32), device="meta"), 2)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        topk_cuda.topk_cbsr_cuda(x, 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grad_matches_pallas_vjp(monkeypatch, dtype):
    """TopKCBSR's backward (densify of the value cotangent into x's dtype)
    against topk_cbsr_pallas's VJP, with the Pallas kernel patched to
    interpret mode."""
    orig = tp._topk_pallas_raw
    monkeypatch.setattr(tp, "_topk_pallas_raw", lambda x, k, interpret=False: orig(x, k, True))
    x = _rows(128, seed=3)
    g = np.random.default_rng(4).standard_normal((V, 8)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    (vals_ref, sel_ref), vjp = jax.vjp(lambda a: tp.topk_cbsr_pallas(a, 8), jx)
    (gx_ref,) = vjp((jnp.asarray(g), np.zeros(sel_ref.shape, jax.dtypes.float0)))
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    cbsr = maxk_cbsr_fast(xt, 8)
    np.testing.assert_array_equal(cbsr.selector.numpy(), np.asarray(sel_ref))
    cbsr.values.backward(torch.from_numpy(g))
    assert xt.grad.dtype == xt.dtype
    # the JAX VJP hands back the f32 cotangent even for bf16 x; a torch
    # gradient has x's dtype, so the reference is rounded once to it
    ref = torch.from_numpy(np.array(gx_ref, np.float32)).to(xt.dtype)
    assert torch.equal(xt.grad, ref)
