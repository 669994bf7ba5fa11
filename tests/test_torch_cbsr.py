"""The port's CBSR densify and sample (ops/cbsr_cuda.py, sparse/cbsr.py)
against the Pallas `_densify_kernel` and `_sample_kernel` in interpret mode.

f32 is exact without duplicate selectors and within 1e-6 with them. In
bf16 the Pallas kernel rounds after every add while the port sums in f32
and rounds once, so duplicates may differ by one bf16 ulp. The CUDA kernels
run only on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import maxk_tpu.ops.cbsr_pallas as cp
from maxk_tpu.sparse import cbsr as jcbsr
from maxk_tpu_torch.ops import cbsr_cuda
from maxk_tpu_torch.ops.cbsr_cuda import densify_plain, sample_plain
from maxk_tpu_torch.sparse import cbsr as tcbsr

torch.set_num_threads(1)

V, K, D = 64, 8, 128


def _selectors(seed: int, duplicates: bool, out_of_range: bool) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if duplicates:
        sel = rng.integers(0, D, (V, K))
        sel[:, 1] = sel[:, 0]  # at least one duplicate per row
    else:
        sel = np.stack([rng.choice(D, K, replace=False) for _ in range(V)])
    if out_of_range:
        sel[::4, -1] = D + 3
        sel[1::4, -1] = -1
    return sel.astype(np.int32)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    a = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("out_of_range", [False, True])
@pytest.mark.parametrize("duplicates", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_densify_matches_pallas(dtype, duplicates, out_of_range):
    sel = _selectors(1, duplicates, out_of_range)
    vals = np.random.default_rng(2).standard_normal((V, K)).astype(np.float32)
    vals = torch.from_numpy(vals).to(getattr(torch, dtype))
    ref = np.asarray(
        cp._densify_raw(jnp.asarray(vals.float().numpy(), getattr(jnp, dtype)), jnp.asarray(sel), D, True),
        np.float32,
    )
    got = densify_plain(vals, torch.from_numpy(sel), D)
    assert got.dtype == vals.dtype and got.shape == (V, D)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 if duplicates else 0)
    else:
        assert np.all(np.abs(got - ref) <= _bf16_ulp(ref))


@pytest.mark.parametrize("out_of_range", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sample_matches_pallas(dtype, out_of_range):
    sel = _selectors(3, True, out_of_range)
    z = torch.from_numpy(np.random.default_rng(4).standard_normal((V, D)).astype(np.float32))
    z = z.to(getattr(torch, dtype))
    ref = cp._sample_raw(jnp.asarray(z.float().numpy(), getattr(jnp, dtype)), jnp.asarray(sel), K, True)
    got = sample_plain(z, torch.from_numpy(sel))
    assert got.dtype == z.dtype
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


def test_densify_sample_are_each_others_backward(monkeypatch):
    """Gradients through the port's Densify/Sample against the Pallas
    custom-VJP pair (densify_pallas, sample_pallas) in interpret mode."""
    od, osm = cp._densify_raw, cp._sample_raw
    monkeypatch.setattr(cp, "_densify_raw", lambda *a, **kw: od(*a[:3], True))
    monkeypatch.setattr(cp, "_sample_raw", lambda *a, **kw: osm(*a[:3], True))
    rng = np.random.default_rng(5)
    sel = _selectors(6, True, True)
    vals = rng.standard_normal((V, K)).astype(np.float32)
    z = rng.standard_normal((V, D)).astype(np.float32)
    gd = rng.standard_normal((V, D)).astype(np.float32)
    gs = rng.standard_normal((V, K)).astype(np.float32)

    _, vjp_d = jax.vjp(lambda a: cp.densify_pallas(a, jnp.asarray(sel), D), jnp.asarray(vals))
    _, vjp_s = jax.vjp(lambda a: cp.sample_pallas(a, jnp.asarray(sel)), jnp.asarray(z))
    tv = torch.from_numpy(vals).requires_grad_(True)
    tz = torch.from_numpy(z).requires_grad_(True)
    tcbsr.cbsr_densify(tcbsr.CBSR(tv, torch.from_numpy(sel)), D).backward(torch.from_numpy(gd))
    tcbsr.cbsr_sample(tz, torch.from_numpy(sel)).backward(torch.from_numpy(gs))
    np.testing.assert_array_equal(tv.grad.numpy(), np.asarray(vjp_d(jnp.asarray(gd))[0]))
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(vjp_s(jnp.asarray(gs))[0]), rtol=0, atol=1e-6)


def test_gradcheck_f64():
    sel = torch.from_numpy(_selectors(7, True, True)[:16])
    gen = torch.Generator().manual_seed(0)
    vals = torch.randn((16, K), dtype=torch.float64, generator=gen, requires_grad=True)
    z = torch.randn((16, D), dtype=torch.float64, generator=gen, requires_grad=True)
    assert torch.autograd.gradcheck(lambda a: tcbsr.cbsr_densify(tcbsr.CBSR(a, sel), D), (vals,))
    assert torch.autograd.gradcheck(lambda a: tcbsr.cbsr_sample(a, sel), (z,))


def test_maxk_cbsr_and_maxk_mask_match_reference():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((V, D)).astype(np.float32)
    ref = jcbsr.maxk_cbsr(jnp.asarray(x), K)
    got = tcbsr.maxk_cbsr(torch.from_numpy(x), K)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(ref.values))
    np.testing.assert_array_equal(got.selector.numpy(), np.asarray(ref.selector))
    x[:4] = rng.integers(-1, 2, (4, D))  # ties: >= k-th keeps more than k
    np.testing.assert_array_equal(
        tcbsr.maxk_mask(torch.from_numpy(x), K).numpy(),
        np.asarray(jcbsr.maxk_mask(jnp.asarray(x), K)),
    )


def test_wrappers_take_plain_only_for_cpu():
    sel = torch.from_numpy(_selectors(9, True, False))
    vals = torch.randn(V, K)
    assert torch.equal(cbsr_cuda.densify(vals, sel, D), densify_plain(vals, sel, D))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        cbsr_cuda.densify_cuda(vals, sel, D)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        cbsr_cuda.sample_cuda(torch.randn(V, D), sel)
    with pytest.raises(ValueError, match="no implementation"):
        cbsr_cuda.sample(torch.empty((V, D), device="meta"), sel)

