"""The CUDA kernels of maxk_tpu_torch against their plain PyTorch versions,
on the card. The tests marked `cuda` need a CUDA device and skip without
one; `test_handmade_schedule_plain` checks, on the CPU, the plain version
on the hand-made brick schedule that a `cuda` test feeds the kernel.

This file imports torch and maxk_tpu_torch only, so it also runs where jax
is not installed (the GPU machine); `tests/conftest.py` imports jax, so run
it there as

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from maxk_tpu_torch.data.datasets import load_dataset
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
@pytest.mark.parametrize("v,d,k", [(100, 32, 1), (777, 96, 7), (4097, 256, 32), (300, 1024, 100),
                                   (65, 64, 64), (40, 1024, 1024)])
def test_topk_cbsr_kernel_exact(cuda, v, d, k, dtype):
    """K4 against its plain version: selectors equal, values bit for bit
    (a selected -0.0 is +0.0), k = 1 and k = D included."""
    x = _rows(v, d, dtype, cuda)
    vals, sel = topk_cuda.topk_cbsr_cuda(x, k)
    vals0, sel0 = topk_cuda.topk_cbsr_plain(x, k)
    torch.cuda.synchronize()
    assert vals.dtype == torch.float32 and sel.dtype == torch.int32
    assert torch.equal(sel, sel0) and torch.equal(_bits(vals), _bits(vals0))


@pytest.mark.cuda
def test_topk_cbsr_backward_densifies(cuda):
    x = _rows(300, 256, torch.float32, cuda).requires_grad_(True)
    g = torch.randn(300, 32, device=cuda)
    cbsr = topk_cuda.maxk_cbsr_fast(x, 32)
    cbsr.values.backward(g)
    assert torch.equal(x.grad, cbsr_cuda.densify_plain(g, cbsr.selector, 256))


@pytest.mark.cuda
def test_sharded_sage_world_size_1_matches_single_device(cuda):
    """The sharded path (K4, the CBSR collectives on NCCL, maxk_spgemm) at
    world size 1 against the single-device path (K1, spmm), 3 steps from
    the same parameters. Atomics sum in another order each run, so a
    top-k near-tie may flip: the bound is 1e-3 relative."""
    from maxk_tpu_torch.parallel.mesh import destroy_mesh, free_tcp_init_method, init_mesh
    from maxk_tpu_torch.parallel.train import train_sharded
    from maxk_tpu_torch.train.config import TrainConfig
    from maxk_tpu_torch.train.loop import train

    data = load_dataset("reddit", scale=0.002, seed=123)
    cfg = TrainConfig(dataset="reddit", epochs=3, hidden_dim=64, hidden_layers=2, maxk=8,
                      dropout=0.0, lr=0.01, device="cuda")
    single = train(cfg, data, warmup_epochs=3).losses
    mesh = init_mesh(0, 1, "cuda", free_tcp_init_method())
    try:
        before = topk_cuda.topk_cbsr_cuda.launches
        sharded = train_sharded(cfg, data, mesh, warmup_epochs=3).losses
        assert topk_cuda.topk_cbsr_cuda.launches - before == 2 * 3 * 2  # layers × steps × (train, eval)
    finally:
        destroy_mesh(mesh)
    assert max(abs(a - b) / abs(b) for a, b in zip(sharded, single)) <= 1e-3


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
    counters = (topk_cuda.maxk_mask_cuda, topk_cuda.topk_cbsr_cuda, cbsr_cuda.densify_cuda,
                cbsr_cuda.sample_cuda)
    before = [c.launches for c in counters]
    topk_cuda.maxk_mask(x, 4)
    topk_cuda.topk_cbsr(x, 4)
    cbsr_cuda.densify(x[:, :4].contiguous(), sel, 64)
    cbsr_cuda.sample(x, sel)
    topk_cuda.maxk_mask_plain(x, 4)  # the plain versions count nothing
    topk_cuda.topk_cbsr_plain(x, 4)
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1, 1]


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    with pytest.raises(TypeError):
        topk_cuda.maxk_mask(torch.randn(8, 64, device=cuda, dtype=torch.float16), 4)
    with pytest.raises(ValueError, match="multiple of 32"):
        topk_cuda.maxk_mask(torch.randn(8, 48, device=cuda), 4)
    with pytest.raises(ValueError, match="multiple of 32"):
        topk_cuda.topk_cbsr(torch.randn(8, 48, device=cuda), 4)
    with pytest.raises(ValueError, match=r"k=0 must be in"):
        topk_cuda.topk_cbsr(torch.randn(8, 64, device=cuda), 0)
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


def _brick_graph(v, e, seed, empty_tail=False):
    """CSR with random weights, duplicate edges and, with empty_tail, no edge
    in the upper half of the rows (empty supergroups)."""
    import numpy as np

    from maxk_tpu_torch.sparse.csr import CSRGraph

    rng = np.random.default_rng(seed)
    rows = rng.integers(0, v // 2 if empty_tail else v, e)
    cols = rng.integers(0, v, e)
    order = np.lexsort((cols, rows))
    indptr = np.zeros(v + 1, np.int64)
    np.add.at(indptr[1:], rows, 1)
    return CSRGraph(indptr=torch.from_numpy(np.cumsum(indptr).astype(np.int32)),
                    indices=torch.from_numpy(cols[order].astype(np.int32)),
                    values=torch.from_numpy(rng.standard_normal(e).astype(np.float32)))


def _meta(win, rb, first=0, end=0):
    return win | rb << 6 | first << 9 | end << 10


def _slot(lr, lc):
    return lr << 7 | lc


# the hand-made schedule's slots: (chunk, subtile) -> [(lr, lc, value), ...]
_HANDMADE = {
    # supergroup 0, panel 0: a brick in subtiles 0-2 that ends twice, with
    # (5, 5) in subtiles 0 and 1 (its entry 2^-9 after rounding at the sum,
    # 0 if each slot were rounded to bf16) and two slots outside the brick;
    # then a brick with (0, 7) held twice in one subtile
    (0, 0): [(1, 2, 1.5), (5, 5, 1.0 + 2.0**-9), (1, 9, 7.0), (10, 1, 3.0)],
    (0, 1): [(5, 5, -1.0), (0, 0, 0.75)],
    (0, 2): [(2, 1, -2.25)],
    (0, 3): [(0, 7, 0.5), (0, 7, 0.25), (7, 0, 1.25)],
    # panel 1: a flush outside the panel, a window of X rows past V, and
    # one half past V
    (1, 0): [(0, 0, 9.0)],
    (1, 1): [(3, 3, 4.0)],
    (1, 2): [(4, 2, -0.5), (4, 6, 2.0)],
    # supergroup 1: a first subtile without `first`, a flush outside the
    # supergroup
    (2, 0): [(3, 1, 5.0)],
    (2, 1): [(6, 6, -1.5)],
    (2, 2): [(0, 0, 1.0)],
    (2, 3): [(1, 1, 8.0)],
}
_HANDMADE_META = [
    [_meta(0, 0, first=1), _meta(0, 0, end=1), _meta(0, 0, end=1), _meta(1, 1, 1, 1)],
    [_meta(2, 0, 1, 1), _meta(1, 1, 1, 1), _meta(0, 1, 1, 1), 0],
    [_meta(0, 0), _meta(0, 0, end=1), _meta(0, 1, 1, 1), _meta(0, 3, 1, 1)],
]


def handmade_schedule():
    """A BrickSchedule written slot by slot (SG = PANEL = 16, WB = WIN = 8,
    T = 8, CH = 4; 32 output rows, 20 X rows): a brick that ends twice,
    duplicate slots across two subtiles of one brick and inside one, slots
    outside the brick, flushes outside the panel and the supergroup, X rows
    past V and a supergroup whose first subtile lacks `first`. Its first
    supergroup is also held against the Pallas kernel in interpret mode
    (tests/test_torch_bricks.py)."""
    import numpy as np

    from maxk_tpu_torch.sparse.bricks import schedule_from_numpy

    idx = np.zeros((3, 4, 8), np.int32)
    val = np.zeros((3, 4, 8), np.float32)
    for (c, j), slots in _HANDMADE.items():
        for k, (lr, lc, v) in enumerate(slots):
            idx[c, j, k], val[c, j, k] = _slot(lr, lc), v
    return schedule_from_numpy([0, 1, 0], [0, 0, 1], np.array(_HANDMADE_META)[:, None, :], idx,
                               val, num_nodes=32, num_cols=20, sg=16, panel=16, wb=8, win=8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_handmade_schedule_plain(dtype):
    """The plain version on the hand-made schedule against its entries
    written out: the twice-ended brick flushes all it holds twice, and in
    bf16 the entry (5, 5) is rounded after its two slots are summed."""
    from maxk_tpu_torch.ops.spmm_bricks import spmm_bricks_plain

    x = torch.randn((20, 80), generator=torch.Generator().manual_seed(2)).to(dtype)
    xf = x.float()
    expect = torch.zeros((32, 80))
    for row, a, col in [(1, 3.0, 2), (5, 2 * 2.0**-9, 5), (0, 1.5, 0), (2, -2.25, 1),
                        (8, 0.75, 15), (15, 1.25, 8), (12, -0.5, 18), (19, 5.0, 1),
                        (22, -1.5, 6), (24, 1.0, 0)]:
        expect[row] += a * xf[col]
    y = spmm_bricks_plain(handmade_schedule(), x)
    assert y.dtype == dtype
    rtol = 1e-6 if dtype == torch.float32 else 2.0**-7
    torch.testing.assert_close(y.float(), expect.to(dtype).float(), rtol=rtol, atol=1e-6)


# name: (the schedule, the width D of x)
BRICK_CASES = {
    # default dims; V = 5000 is not a multiple of the 4096-row panel, so the
    # last panel's windows read X rows past V
    "default_x_past_v": (lambda: _build(rmat_graph(5000, 60000, seed=3)), 80),
    "small_empty_supergroups": (lambda: _build(_brick_graph(200, 1500, 4, empty_tail=True),
                                               sg=32, panel=64, wb=16, win=32, t=16, ch=4), 80),
    "full_fields": (lambda: _build(_brick_graph(700, 6000, 5),
                                   sg=64, panel=256, wb=8, win=4, t=8, ch=2), 80),
    "handmade": (handmade_schedule, 80),
    # WB = 256: 64-column slices, two items a warp step; D = 80 leaves a
    # last slice of 16 columns
    "wb256": (lambda: _build(_brick_graph(1200, 20000, 6),
                             sg=1024, panel=512, wb=256, win=64, t=16, ch=4), 80),
    # WB = 512: 32-column slices, four items a warp step, rows that meet
    # within a step and a ring that wraps onto slots just read
    "wb512": (lambda: _build(_brick_graph(1200, 30000, 7),
                             sg=512, panel=256, wb=512, win=128, t=32, ch=2), 80),
    # D % 4 != 0: one column a load in place of 4
    "d78_scalar_loads": (lambda: _build(rmat_graph(5000, 60000, seed=4)), 78),
}


def _build(g, **dims):
    from maxk_tpu_torch.sparse.bricks import build_bricks

    return build_bricks(g, **dims)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BRICK_CASES)
def test_spmm_bricks_kernel_matches_plain(cuda, case, dtype):
    """K5 against its plain version. float32: probe_bricks' criterion
    relative to max|ref| (max error 1e-5, mean error 1e-4). bfloat16: element
    by element, one bf16 ulp (2^-7 of |ref|; both sum in f32, maybe in
    another order, and round once) plus 1e-5 of max|ref| for sums that
    cancel."""
    from maxk_tpu_torch.ops.spmm_bricks import spmm_bricks_cuda, spmm_bricks_plain

    make, d = BRICK_CASES[case]
    sched = make().to(cuda)
    x = torch.randn((sched.num_cols, d), generator=torch.Generator().manual_seed(1))
    x = x.to(dtype).to(cuda)
    before = spmm_bricks_cuda.launches
    y = spmm_bricks_cuda(sched, x)
    ref = spmm_bricks_plain(sched, x)
    torch.cuda.synchronize()
    assert spmm_bricks_cuda.launches - before == 1
    assert y.dtype == dtype and y.shape == ref.shape
    err = (y.float() - ref.float()).abs()
    scale = ref.float().abs().max()
    if dtype == torch.float32:
        assert err.max() <= 1e-5 * scale
        assert err.mean() <= 1e-4 * scale
    else:
        assert (err <= 2.0**-7 * ref.float().abs() + 1e-5 * scale).all()
    if case == "small_empty_supergroups":
        assert not y[100:].any()


@pytest.mark.cuda
def test_spmm_bricks_shared_memory_fits_the_accepted_dims(cuda):
    """The wrapper reads the kernel's shared-memory need from its source;
    at the widest bricks it accepts (WB = 512, WIN = 128) a block fits."""
    from maxk_tpu_torch.ops.spmm_bricks import _smem_bytes

    for dtype in (torch.float32, torch.bfloat16):
        need, limit = _smem_bytes(512, 128, dtype)
        assert 0 < need <= limit
    assert _smem_bytes(512, 128, torch.bfloat16)[0] > _smem_bytes(512, 128, torch.float32)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,d", [(2048, 256), (8192, 256), (16384, 256), (100, 48), (7, 3)])
def test_slab_gather_kernel_exact(cuda, s, d, dtype):
    from maxk_tpu_torch.ops.gather_cuda import gather_rows_plain, slab_gather_cuda

    gen = torch.Generator(device=cuda).manual_seed(s)
    slab = torch.randn((s, d), generator=gen, device=cuda).to(dtype)
    idx = torch.randint(-2, s + 2, (4097,), generator=gen, device=cuda, dtype=torch.int32)
    assert torch.equal(_bits(slab_gather_cuda(slab, idx)), _bits(gather_rows_plain(slab, idx)))


@pytest.mark.cuda
@pytest.mark.parametrize("v,d,dtype", [(1000, 256, torch.float32), (1000, 64, torch.bfloat16),
                                       (50, 4, torch.float32), (3000, 1024, torch.float32)])
def test_dma_gather_kernel_exact(cuda, v, d, dtype):
    from maxk_tpu_torch.ops.gather_cuda import dma_gather_cuda, gather_rows_plain

    gen = torch.Generator(device=cuda).manual_seed(v + d)
    x = torch.randn((v, d), generator=gen, device=cuda).to(dtype)
    # 1000 indices: a ragged last block of 488; some outside the table
    idx = torch.randint(-2, v + 2, (1000,), generator=gen, device=cuda, dtype=torch.int32)
    assert torch.equal(_bits(dma_gather_cuda(x, idx)), _bits(gather_rows_plain(x, idx)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,d,k", [(300, 256, 32), (5, 7, 3), (262144, 256, 32)])
def test_take_along_rows_kernel_exact(cuda, r, d, k, dtype):
    from maxk_tpu_torch.ops.gather_cuda import take_along_rows_cuda, take_along_rows_plain

    gen = torch.Generator(device=cuda).manual_seed(r)
    x = torch.randn((r, d), generator=gen, device=cuda).to(dtype)
    idx = torch.randint(-1, d + 1, (r, k), generator=gen, device=cuda, dtype=torch.int32)
    assert torch.equal(_bits(take_along_rows_cuda(x, idx)), _bits(take_along_rows_plain(x, idx)))


@pytest.mark.cuda
def test_gather_wrappers_count_and_raise(cuda):
    from maxk_tpu_torch.ops import _native
    from maxk_tpu_torch.ops import gather_cuda as gc

    x = torch.randn(64, 64, device=cuda)
    i1 = torch.zeros(10, dtype=torch.int32, device=cuda)
    i2 = torch.zeros(64, 4, dtype=torch.int32, device=cuda)
    counters = (gc.slab_gather_cuda, gc.dma_gather_cuda, gc.take_along_rows_cuda)
    before = [c.launches for c in counters]
    gc.slab_gather(x, i1)
    gc.dma_gather(x, i1)
    gc.take_along_rows(x, i2)
    gc.gather_rows_plain(x, i1)  # the plain versions count nothing
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1]
    with pytest.raises(ValueError, match="16-byte"):
        gc.dma_gather(torch.randn(8, 3, device=cuda), i1)
    # a slab one row larger than the card's L2
    l2 = _native.l2_cache_bytes()
    with pytest.raises(ValueError, match="L2"):
        gc.slab_gather(torch.empty(l2 // 1024 + 1, 256, device=cuda), i1)
    with pytest.raises(TypeError):
        gc.slab_gather(x, i1.long())
