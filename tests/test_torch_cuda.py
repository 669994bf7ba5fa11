"""The CUDA kernels of maxk_tpu_torch against their plain PyTorch versions,
on the card. Every test here needs a CUDA device and skips without one.

This file imports torch and maxk_tpu_torch only, so it also runs where jax
is not installed (the GPU machine); `tests/conftest.py` imports jax, so run
it there as

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from maxk_tpu_torch.data.synthetic import rmat_graph
from maxk_tpu_torch.ops import cbsr_cuda, topk_cuda
from maxk_tpu_torch.ops.spgemm import maxk_spgemm
from maxk_tpu_torch.sparse.cbsr import CBSR
from maxk_tpu_torch.sparse.graph import build_graph

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rows(v, d, dtype, device, seed=0):
    """Normal rows plus tie rows, signed zeros, a constant row and an
    all-negative row."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((v, d), generator=gen)
    x[:8] = torch.randint(-2, 3, (8, d), generator=gen).float()
    x[8] = 0.0
    x[8, ::3] = -0.0
    x[9] = 1.5
    x[10] = -x[10].abs() - 1.0
    return x.to(dtype).to(device)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v,d,k", [(100, 32, 1), (777, 96, 7), (4097, 256, 32), (300, 1024, 100)])
def test_maxk_mask_kernel_bit_equal(cuda, v, d, k, dtype):
    x = _rows(v, d, dtype, cuda)
    y, take = topk_cuda.maxk_mask_cuda(x, k)
    y0, take0 = topk_cuda.maxk_mask_plain(x, k)
    torch.cuda.synchronize()
    assert torch.equal(_bits(y), _bits(y0)) and torch.equal(take, take0)
    assert bool((take.sum(1) == k).all())


@pytest.mark.cuda
def test_maxk_mask_backward_is_g_take(cuda):
    x = _rows(300, 256, torch.float32, cuda).requires_grad_(True)
    g = torch.randn(300, 256, device=cuda)
    topk_cuda.maxk_mask_fast(x, 32).backward(g)
    _, take = topk_cuda.maxk_mask_plain(x.detach(), 32)
    assert torch.equal(x.grad, g * take)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v,k,d", [(1000, 32, 256), (999, 7, 50), (100, 600, 700), (64, 1, 1)])
def test_densify_and_sample_kernels(cuda, v, k, d, dtype):
    gen = torch.Generator(device=cuda).manual_seed(v + k)
    vals = torch.randn((v, k), generator=gen, device=cuda).to(dtype)
    # duplicates and selectors outside [0, d)
    sel = torch.randint(-3, d + 3, (v, k), generator=gen, device=cuda, dtype=torch.int32)
    z = torch.randn((v, d), generator=gen, device=cuda).to(dtype)
    out = cbsr_cuda.densify_cuda(vals, sel, d)
    ref = cbsr_cuda.densify_plain(vals, sel, d)
    rtol = 1e-6 if dtype == torch.float32 else 2.0**-7
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=1e-6)
    assert torch.equal(_bits(cbsr_cuda.sample_cuda(z, sel)), _bits(cbsr_cuda.sample_plain(z, sel)))


@pytest.mark.cuda
def test_each_launch_counts_once(cuda):
    x = torch.randn(64, 64, device=cuda)
    sel = torch.zeros(64, 4, dtype=torch.int32, device=cuda)
    before = (topk_cuda.maxk_mask_cuda.launches, cbsr_cuda.densify_cuda.launches,
              cbsr_cuda.sample_cuda.launches)
    topk_cuda.maxk_mask(x, 4)
    cbsr_cuda.densify(x[:, :4].contiguous(), sel, 64)
    cbsr_cuda.sample(x, sel)
    topk_cuda.maxk_mask_plain(x, 4)  # the plain version counts nothing
    after = (topk_cuda.maxk_mask_cuda.launches, cbsr_cuda.densify_cuda.launches,
             cbsr_cuda.sample_cuda.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    with pytest.raises(TypeError):
        topk_cuda.maxk_mask(torch.randn(8, 64, device=cuda, dtype=torch.float16), 4)
    with pytest.raises(ValueError, match="multiple of 32"):
        topk_cuda.maxk_mask(torch.randn(8, 48, device=cuda), 4)
    with pytest.raises(ValueError, match="contiguous"):
        topk_cuda.maxk_mask(torch.randn(64, 8, device=cuda).t(), 4)
    with pytest.raises(TypeError):
        cbsr_cuda.densify(torch.randn(8, 4, device=cuda), torch.zeros(8, 4, dtype=torch.int64, device=cuda), 16)


@pytest.mark.cuda
def test_maxk_spgemm_on_card_matches_cpu(cuda):
    """The op on the card (kernels) against the op on the CPU (plain)."""
    cpu_graph = build_graph(rmat_graph(2000, 30000, seed=5), norm="right")
    gpu_graph = build_graph(rmat_graph(2000, 30000, seed=5), norm="right", device=cuda)
    gen = torch.Generator().manual_seed(6)
    vals = torch.randn((2000, 16), generator=gen)
    sel = torch.randint(0, 128, (2000, 16), generator=gen, dtype=torch.int32)
    ct = torch.randn((2000, 128), generator=gen)
    grads = []
    for graph, dev in ((cpu_graph, "cpu"), (gpu_graph, cuda)):
        v = vals.to(dev).detach().requires_grad_(True)
        y = maxk_spgemm(graph, CBSR(v, sel.to(dev)), dim=128)
        y.backward(ct.to(dev))
        grads.append((y.detach().cpu(), v.grad.cpu()))
    torch.testing.assert_close(grads[1][0], grads[0][0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(grads[1][1], grads[0][1], rtol=1e-5, atol=1e-5)
