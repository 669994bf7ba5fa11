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
    all-negative row; then rows of f32 keys that share their top 16 bits
    but differ below (all of the row, exactly 32, 33 where D allows; in
    bf16 they round to plain ties), and a row whose shared top halves
    straddle the k-th place with ties below them too."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((v, d), generator=gen)
    x[:8] = torch.randint(-2, 3, (8, d), generator=gen).float()
    x[8] = 0.0
    x[8, ::3] = -0.0
    x[9] = 1.5
    x[10] = -x[10].abs() - 1.0
    j = torch.arange(d, dtype=torch.float64)
    x[11] = (1.0 + j * 2.0**-20).float()
    x[12] = (-1.0 - j * 2.0**-20).float()
    for r, m in ((13, 32), (14, min(33, d))):
        x[r] = 0.0
        x[r, :m] = (1.0 + j[:m] * 2.0**-20).float()
    x[15] = 0.1 * x[15]
    x[15, :10] = 5.0
    x[15, 10:40] = (3.0 + (j[: min(30, d - 10)] % 7) * 2.0**-20).float()
    return x.to(dtype).to(device)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v,d,k", [(100, 32, 1), (777, 96, 7), (4097, 256, 32), (300, 1024, 100),
                                   (128, 1024, 33), (64, 96, 40), (300, 128, 40), (40, 1024, 1024)])
def test_maxk_mask_kernel_bit_equal(cuda, v, d, k, dtype):
    """D = 96 moves element by element (a lane's 3 columns are no 16-byte
    vector), and so does bf16 at D = 128; the rest as vectors."""
    x = _rows(v, d, dtype, cuda)
    y, take = topk_cuda.maxk_mask_cuda(x, k)
    y0, take0 = topk_cuda.maxk_mask_plain(x, k)
    torch.cuda.synchronize()
    assert torch.equal(_bits(y), _bits(y0)) and torch.equal(take, take0)
    assert bool((take.sum(1) == k).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_maxk_mask_kernel_unaligned_rows(cuda, dtype):
    """x one element past a 16-byte boundary: the kernel moves elements
    one by one, and still agrees bit for bit."""
    v, d, k = 300, 256, 32
    flat = torch.empty(v * d + 1, dtype=dtype, device=cuda)
    x = flat[1:].view(v, d)
    x.copy_(_rows(v, d, dtype, cuda))
    assert x.data_ptr() % 16
    y, take = topk_cuda.maxk_mask_cuda(x, k)
    y0, take0 = topk_cuda.maxk_mask_plain(x, k)
    torch.cuda.synchronize()
    assert torch.equal(_bits(y), _bits(y0)) and torch.equal(take, take0)


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
                                   (65, 64, 64), (40, 1024, 1024), (300, 128, 40), (128, 1024, 33),
                                   (64, 1024, 260), (300, 256, 30)])
def test_topk_cbsr_kernel_exact(cuda, v, d, k, dtype):
    """K4 against its plain version: selectors equal, values bit for bit
    (a selected -0.0 is +0.0), on `_rows`' tie rows (more than 32, exactly
    32 and 33 f32 keys sharing the threshold's top 16 bits), k = 1 and k = D
    included. D = 96 and bf16 at D = 128 load element by element; k = 7, 30,
    33, 100 (not multiples of 4) and 260, 1024 (above the staging limit)
    store each pair from registers, the rest through shared memory."""
    x = _rows(v, d, dtype, cuda)
    vals, sel = topk_cuda.topk_cbsr_cuda(x, k)
    vals0, sel0 = topk_cuda.topk_cbsr_plain(x, k)
    torch.cuda.synchronize()
    assert vals.dtype == torch.float32 and sel.dtype == torch.int32
    assert torch.equal(sel, sel0) and torch.equal(_bits(vals), _bits(vals0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_cbsr_kernel_unaligned_rows(cuda, dtype):
    """x one element past a 16-byte boundary: K4 loads element by element,
    and still agrees bit for bit."""
    v, d, k = 300, 256, 32
    flat = torch.empty(v * d + 1, dtype=dtype, device=cuda)
    x = flat[1:].view(v, d)
    x.copy_(_rows(v, d, dtype, cuda))
    assert x.data_ptr() % 16
    vals, sel = topk_cuda.topk_cbsr_cuda(x, k)
    vals0, sel0 = topk_cuda.topk_cbsr_plain(x, k)
    torch.cuda.synchronize()
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [256, 1])
@pytest.mark.parametrize("k", [1, 7, 32, 100, 600])
def test_sample_kernel_exact(cuda, k, d, dtype):
    """K3 against its plain version, bit for bit, on selectors with
    duplicates and outside [0, d), d = 1 included: f32 takes a slot a
    thread, bf16 4 slots a thread spaced by the block, so that rows * k
    ends inside a thread's slots for most k here."""
    v = 1001
    gen = torch.Generator(device=cuda).manual_seed(k + d)
    sel = torch.randint(-3, d + 3, (v, k), generator=gen, device=cuda, dtype=torch.int32)
    z = torch.randn((v, d), generator=gen, device=cuda).to(dtype)
    out = cbsr_cuda.sample_cuda(z, sel)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (v, k)
    assert torch.equal(_bits(out), _bits(cbsr_cuda.sample_plain(z, sel)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sample_kernel_on_topk_cbsr_selectors(cuda, dtype):
    """K3 on K4's output, the training paths' input: distinct selectors,
    ascending within a row."""
    x = _rows(4097, 256, dtype, cuda)
    _, sel = topk_cuda.topk_cbsr_cuda(x, 32)
    z = torch.randn((4097, 256), generator=torch.Generator(device=cuda).manual_seed(9),
                    device=cuda).to(dtype)
    out = cbsr_cuda.sample_cuda(z, sel)
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(cbsr_cuda.sample_plain(z, sel)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sample_kernel_unaligned(cuda, dtype):
    """z and the selectors each one element past a 16-byte boundary: K3
    asks no alignment, and still agrees bit for bit."""
    v, k, d = 500, 32, 256
    gen = torch.Generator(device=cuda).manual_seed(7)
    zf = torch.empty(v * d + 1, dtype=dtype, device=cuda)
    sf = torch.empty(v * k + 1, dtype=torch.int32, device=cuda)
    z, sel = zf[1:].view(v, d), sf[1:].view(v, k)
    z.copy_(torch.randn((v, d), generator=gen, device=cuda).to(dtype))
    sel.copy_(torch.randint(-1, d + 1, (v, k), generator=gen, device=cuda, dtype=torch.int32))
    assert z.data_ptr() % 16 and sel.data_ptr() % 16
    out = cbsr_cuda.sample_cuda(z, sel)
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(cbsr_cuda.sample_plain(z, sel)))


def _sequential_densify(vals, sel, d):
    """out[r, c] = +0.0 + vals[r, l1] + vals[r, l2] + ... over the slots l of
    row r whose selector is c, added one at a time in l order in float32."""
    import numpy as np

    v, k = vals.shape
    out = np.zeros((v, d), np.float32)
    rows = np.arange(v)
    for l in range(k):
        ok = (sel[:, l] >= 0) & (sel[:, l] < d)
        out[rows[ok], sel[ok, l]] += vals[ok, l]  # one slot a row: no index repeats
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,d", [(32, 256), (64, 256), (64, 3000), (64, 50)])
def test_densify_kernel_bit_equal_to_sequential_sum(cuda, k, d, dtype):
    """K2 against a sequential l-order f32 sum rounded once: selectors that
    repeat inside a 32-slot chunk and across chunks, and selectors outside
    [0, d). D = 3000 is walked in two column tiles; D = 50 in bf16 is a row
    of 100 bytes, written one element at a time."""
    import numpy as np

    rng = np.random.default_rng(k + d)
    v = 1000
    sel = rng.integers(-2, d + 2, (v, k)).astype(np.int32)
    sel[:, 5] = sel[:, 7] = sel[:, 3]  # three slots of one chunk
    sel[:, k - 1] = sel[:, 3]  # and one of the last chunk
    sel[:, k - 2] = sel[:, 1]
    vals = torch.from_numpy(rng.standard_normal((v, k)).astype(np.float32)).to(dtype)
    expect = torch.from_numpy(_sequential_densify(vals.float().numpy(), sel, d)).to(dtype)
    out = cbsr_cuda.densify_cuda(vals.to(cuda), torch.from_numpy(sel).to(cuda), d)
    torch.cuda.synchronize()
    assert torch.equal(_bits(out.cpu()), _bits(expect))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_densify_kernel_lone_negative_zero_is_positive(cuda, dtype):
    """A column whose only value is -0.0 gets +0.0 (the zeroed row plus the
    value), as the Pallas kernel and densify_plain give it."""
    vals = torch.randn((64, 8), generator=torch.Generator().manual_seed(3))
    vals[:, 2] = -0.0
    sel = torch.arange(8, dtype=torch.int32).repeat(64, 1) * 7
    out = cbsr_cuda.densify_cuda(vals.to(dtype).to(cuda), sel.to(cuda), 64)
    ref = cbsr_cuda.densify_plain(vals.to(dtype), sel, 64)
    torch.cuda.synchronize()
    assert not _bits(out[:, 14]).any()
    assert torch.equal(_bits(out.cpu()), _bits(ref))


@pytest.mark.cuda
def test_wrappers_launch_on_the_current_stream(cuda):
    """Each wrapper under `torch.cuda.stream(s)`: its input is written on s
    after a sleep, so a kernel that launched on any other stream would read
    the input before it is written."""
    from maxk_tpu_torch.ops import gather_cuda as gc
    from maxk_tpu_torch.ops import spmm_bricks as sb

    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((300, 64), generator=gen, device=cuda)
    sel = torch.randint(-1, 65, (300, 8), generator=gen, device=cuda, dtype=torch.int32)
    idx = torch.randint(0, 300, (500,), generator=gen, device=cuda, dtype=torch.int32)
    sched = BRICK_CASES["full_fields"][0]().to(cuda)
    xb = torch.randn((sched.num_cols, 80), generator=gen, device=cuda)
    cases = {  # name: (kernel, plain version, arguments)
        "maxk_mask": (topk_cuda.maxk_mask_cuda, topk_cuda.maxk_mask_plain, (x, 8)),
        "topk_cbsr": (topk_cuda.topk_cbsr_cuda, topk_cuda.topk_cbsr_plain, (x, 8)),
        "densify": (cbsr_cuda.densify_cuda, cbsr_cuda.densify_plain, (x[:, :8].contiguous(), sel, 64)),
        "sample": (cbsr_cuda.sample_cuda, cbsr_cuda.sample_plain, (x, sel)),
        "spmm_bricks": (sb.spmm_bricks_cuda, sb.spmm_bricks_plain, (sched, xb)),
        "slab_gather": (gc.slab_gather_cuda, gc.gather_rows_plain, (x, idx)),
        "dma_gather": (gc.dma_gather_cuda, gc.gather_rows_plain, (x, idx)),
        "take_along_rows": (gc.take_along_rows_cuda, gc.take_along_rows_plain, (x, sel)),
    }
    s = torch.cuda.Stream()
    for name, (kernel, plain, args) in cases.items():
        late = [torch.zeros_like(a) if isinstance(a, torch.Tensor) else a for a in args]
        torch.cuda.synchronize()
        with torch.cuda.stream(s):
            torch.cuda._sleep(20_000_000)
            for dst, src in zip(late, args):
                if isinstance(src, torch.Tensor):
                    dst.copy_(src)
            got = kernel(*late)
        s.synchronize()
        ref = plain(*args)
        got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
        for a, b in zip(got, ref):
            if name == "spmm_bricks":
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=name)
            else:
                same = torch.equal(_bits(a), _bits(b)) if a.is_floating_point() else torch.equal(a, b)
                assert same, name


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
                                       (50, 4, torch.float32), (3000, 1024, torch.float32),
                                       (700, 256, torch.bfloat16), (300, 8, torch.bfloat16)])
def test_dma_gather_kernel_exact(cuda, v, d, dtype):
    """Rows of 16 B (f32 D = 4, bf16 D = 8) to 4 KB, 512 B at micro's bf16
    width."""
    from maxk_tpu_torch.ops.gather_cuda import dma_gather_cuda, gather_rows_plain

    gen = torch.Generator(device=cuda).manual_seed(v + d)
    x = torch.randn((v, d), generator=gen, device=cuda).to(dtype)
    # 1000 indices, the last block's chunks ragged; some outside the table
    idx = torch.randint(-2, v + 2, (1000,), generator=gen, device=cuda, dtype=torch.int32)
    assert torch.equal(_bits(dma_gather_cuda(x, idx)), _bits(gather_rows_plain(x, idx)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 33, 4099, 1 << 18])
def test_dma_gather_kernel_counts_of_indices(cuda, n):
    """From one index (a part of one block) to micro's 2^18, every tenth
    outside the table."""
    from maxk_tpu_torch.ops.gather_cuda import dma_gather_cuda, gather_rows_plain

    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((5000, 256), generator=gen, device=cuda)
    idx = torch.randint(0, 5000, (n,), generator=gen, device=cuda, dtype=torch.int32)
    idx[::10] = -1 - idx[::10]
    assert torch.equal(_bits(dma_gather_cuda(x, idx)), _bits(gather_rows_plain(x, idx)))


@pytest.mark.cuda
@pytest.mark.parametrize("v,d,dtype", [(40, 16384, torch.float32), (3, 32768, torch.bfloat16),
                                       (70_000, 256, torch.float32)])
def test_dma_gather_kernel_wide_rows_and_large_tables(cuda, v, d, dtype):
    """Rows of 64 KB (4,096 chunks, a block's worth of chunks inside one
    row), and a 68 MB table, larger than L2; every tenth index outside
    it."""
    from maxk_tpu_torch.ops.gather_cuda import dma_gather_cuda, gather_rows_plain

    gen = torch.Generator(device=cuda).manual_seed(v)
    x = torch.randn((v, d), generator=gen, device=cuda).to(dtype)
    idx = torch.randint(0, v, (5001,), generator=gen, device=cuda, dtype=torch.int32)
    idx[::10] = -1 - idx[::10]
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


# the segsum path's CSR kernels: K9-K11 (ops/spmm_csr.py)


def _csr_graph(v=3000, e=60_000, seed=0, lone=False):
    """A directed graph with random weights, on the CPU: rows 0 and 1 of A
    hubs of several segments, rows 10-29 empty, column 2 in every row (a hub
    row of Aᵀ), columns past v - 20 in no row (empty rows of Aᵀ); with
    `lone`, columns v - 40 .. v - 21 in one row each (rows of one edge in
    Aᵀ)."""
    import numpy as np

    from maxk_tpu_torch.sparse.csr import csr_from_coo

    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, v, e), np.zeros(5000, np.int64),
                           np.ones(700, np.int64), np.arange(v)])
    cols = np.concatenate([rng.integers(0, v, e), rng.integers(0, v, 5700), np.full(v, 2)])
    keep = ((rows < 10) | (rows >= 30)) & (cols < v - (40 if lone else 20))
    rows, cols = rows[keep], cols[keep]
    if lone:
        rows = np.concatenate([rows, rng.integers(30, v, 20)])
        cols = np.concatenate([cols, np.arange(v - 40, v - 20)])
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return build_graph(csr_from_coo(rows, cols, v, vals, dedup=False))


def _check_segments(out, ref, csr, abs_ref, dtype):
    """`out` (the kernel's, on the card) against `ref` (the plain version's
    on the CPU), both (rows of csr, ·): bit-equal on rows of one segment
    (the same f32 sum in the same order); on the others within the f32
    sum's regrouping, 2·n·2⁻²⁴·Σ|terms| with n the row's edges (`abs_ref`
    is Σ|terms|), plus one ulp of `dtype` at |ref| for the final rounding."""
    from maxk_tpu_torch.sparse.csr import SEG_EDGES

    out = out.cpu()
    deg = torch.diff(csr.indptr.long())
    one = deg <= SEG_EDGES
    assert bool(one.any()) and bool((~one).any())
    assert torch.equal(_bits(out[one]), _bits(ref[one]))
    _check_close(out, ref, csr, abs_ref, dtype)


def _check_close(out, ref, csr, abs_ref, dtype):
    """Every element of `out` within 2·n·2⁻²⁴·Σ|terms| + one ulp of `dtype`
    at |ref| of `ref` (n the row's edges)."""
    out = out.cpu()
    deg = torch.diff(csr.indptr.long())
    ulp = 2.0**-7 if dtype == torch.bfloat16 else 2.0**-23
    tol = 2.0 * deg[:, None].double() * 2.0**-24 * abs_ref + ulp * ref.double().abs()
    err = (out.double() - ref.double()).abs()
    assert bool((err <= tol).all()), float((err - tol).max())


def _abs_spmm(csr, x_abs):
    """|A| @ |x| in f64 on the CPU: Σ|terms| of each element (×1.01 for the
    terms' own bf16 rounding)."""
    from maxk_tpu_torch.ops.spmm_xla import spmm_segsum
    from maxk_tpu_torch.sparse.csr import CSRGraph

    a = CSRGraph(csr.indptr, csr.indices, csr.values.abs())
    return 1.01 * spmm_segsum(a, x_abs.double())


def _with_hubs(csr, hubs):
    """`csr` carrying a segment table whose hub table holds `hubs` columns
    ("all": every column)."""
    from dataclasses import replace

    from maxk_tpu_torch.sparse.csr import CSRGraph, hub_table, row_segments

    h = csr.num_nodes if hubs == "all" else hubs
    rows, slot = hub_table(csr.indices[: int(csr.indptr[-1])], h)
    return CSRGraph(csr.indptr, csr.indices, csr.values,
                    replace(row_segments(csr), hub_rows=rows, hub_slot=slot))


# K10's hub tables: none, a few columns (cached and uncached sources), every
# column of a graph small enough for its shared memory to hold most of them
HUBS = [(0, 3000), (40, 3000), ("all", 1000)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [256, 50, 300, 8, 200])
@pytest.mark.parametrize("transpose", [False, True])
def test_spmm_csr_kernel(cuda, d, dtype, transpose):
    """K9 over A and Aᵀ against `spmm_segsum` on the CPU. D = 256, 200 and 8
    move 16-byte vectors (D = 300 in f32 too: four 64-column slices and a
    ragged 44; 200 in bf16: a 128-column slice and a ragged 72); D = 50 (and
    bf16 at 300) rows are no multiple of 16 bytes and move element by
    element. Empty rows are zeros; two launches give the same bits."""
    from maxk_tpu_torch.ops import spmm_csr as sc

    g = _csr_graph()
    csr = g.csc if transpose else g.csr
    x = torch.randn((g.num_nodes, d), generator=torch.Generator().manual_seed(d)).to(dtype)
    gc, xc = csr.to(cuda), x.to(cuda)
    out = sc.spmm_csr_cuda(gc, xc)
    again = sc.spmm_csr_cuda(gc, xc)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (g.num_nodes, d)
    assert torch.equal(_bits(out), _bits(again))
    _check_segments(out, sc.spmm_csr_plain(csr, x), csr, _abs_spmm(csr, x.abs()), dtype)
    empty = torch.diff(csr.indptr) == 0
    assert bool(empty.any()) and not _bits(out.cpu()[empty]).any()


@pytest.mark.cuda
def test_spmm_csr_kernel_bf16_products_round_once(cuda):
    """K9 in bf16 on rows of one edge: y = T(+0.0 + T(x * a)) for x and a
    spread over bf16's whole exponent range, normal, subnormal and vanishing
    products and their signs included, equal bit for bit to the f32 product
    rounded to bf16 on the CPU (the product of two bf16 values is exact in f32, so
    `__hmul2_rn`'s one rounding gives the same bits)."""
    import numpy as np

    from maxk_tpu_torch.ops import spmm_csr as sc
    from maxk_tpu_torch.sparse.csr import csr_from_coo, with_segments

    v, d = 4096, 64
    rng = np.random.default_rng(11)
    cols = rng.integers(0, v, v)
    # weights 2^-70..2^10 and features 2^-80..2^5: products from 2^-150 up
    a = (rng.choice([-1.0, 1.0], v) * 2.0 ** rng.uniform(-70, 10, v)).astype(np.float32)
    x = torch.from_numpy(rng.choice([-1.0, 1.0], (v, d)) * 2.0 ** rng.uniform(-80, 5, (v, d)))
    x = x.float().to(torch.bfloat16)
    csr = with_segments(csr_from_coo(np.arange(v), cols, v, a, dedup=False))
    out = sc.spmm_csr_cuda(csr.to(cuda), x.to(cuda)).cpu()
    ab = torch.from_numpy(a).to(torch.bfloat16).float()[:, None]
    prod = (x[torch.from_numpy(cols)].float() * ab).to(torch.bfloat16)
    tiny = prod.float().abs() < torch.finfo(torch.bfloat16).tiny
    assert bool((tiny & (prod != 0)).any()) and bool((tiny & (prod == 0)).any())
    # the sum starts at +0.0, so a -0.0 product leaves +0.0
    ref = (prod.float() + 0.0).to(torch.bfloat16)
    assert torch.equal(_bits(out), _bits(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v,e", [(40, 120), (1 << 18, 1 << 21)])
def test_csr_kernels_grid_sizes(cuda, v, e, dtype):
    """K9 and K10 on a graph of fewer segments than the persistent grid has
    warps, and on one of many more work units than the grid (K10's warps
    then take several segments a take): every row of one segment bit-equal
    to the CPU's, the others within the regrouping."""
    from maxk_tpu_torch.ops import spmm_csr as sc
    from maxk_tpu_torch.ops.spmm_xla import spmm_segsum

    g = rmat_graph(v, e, seed=5)
    csr = _with_hubs(build_graph(g).csr, 64)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert (csr.segments.num_segments < sms * 16) == (v == 40)
    # K10: 4 blocks of 8 warps an SM, at least 16 takes a warp: 2 segments a take
    assert (csr.segments.num_segments >= sms * 4 * 8 * 16 * 2) == (v != 40)
    x = torch.randn((v, 64), generator=torch.Generator().manual_seed(1)).to(dtype)
    gc = csr.to(cuda)
    out = sc.spmm_csr_cuda(gc, x.to(cuda))
    deg = torch.diff(csr.indptr.long())
    one = deg <= csr.segments.seg_edges
    ref = sc.spmm_csr_plain(csr, x)
    assert torch.equal(_bits(out.cpu()[one]), _bits(ref[one]))
    _check_close(out, ref, csr, _abs_spmm(csr, x.abs()), dtype)
    vals, sel = _selectors(v, 32, 64, 3)
    vals = vals.to(dtype)
    dense = torch.from_numpy(_sequential_densify(vals.float().numpy(), sel.numpy(), 64)).to(dtype)
    out = sc.spgemm_cbsr_cuda(gc, vals.to(cuda), sel.to(cuda), 64)
    ref = spmm_segsum(csr, dense)
    assert torch.equal(_bits(out.cpu()[one]), _bits(ref[one]))
    _check_close(out, ref, csr, _abs_spmm(csr, dense.abs()), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmm_csr_kernel_unaligned_features(cuda, dtype):
    """x one element past a 16-byte boundary: the kernel moves elements one
    by one, with the same bits as the vector path."""
    from maxk_tpu_torch.ops import spmm_csr as sc

    g = _csr_graph(seed=1)
    v, d = g.num_nodes, 256
    flat = torch.empty(v * d + 1, dtype=dtype, device=cuda)
    x = flat[1:].view(v, d)
    x.copy_(torch.randn((v, d), generator=torch.Generator(device=cuda).manual_seed(3),
                        device=cuda).to(dtype))
    assert x.data_ptr() % 16
    gc = g.csr.to(cuda)
    out = sc.spmm_csr_cuda(gc, x)
    ref = sc.spmm_csr_cuda(gc, x.clone())
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(ref))


def _selectors(v, k, d, seed):
    """(v, k) selectors repeating inside a 32-slot chunk and across chunks,
    some outside [0, d), and values."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sel = rng.integers(-2, d + 2, (v, k)).astype(np.int32)
    if k > 3:
        sel[:, 1] = sel[:, 0]
        sel[:, k - 1] = sel[:, 2]
    vals = rng.standard_normal((v, k)).astype(np.float32)
    return torch.from_numpy(vals), torch.from_numpy(sel)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,d", [(32, 256), (7, 50), (40, 256), (64, 2000)])
@pytest.mark.parametrize("hubs,v", HUBS)
def test_spgemm_cbsr_kernel(cuda, k, d, dtype, hubs, v):
    """K10 against a sequential slot-order densify (`_sequential_densify`,
    rounded once) and `spmm_segsum` on the CPU, with 0, 40 and all columns
    in the hub table: k = 40, 64 take the two-row path (equal selectors
    across 32-slot chunks), D = 2000 two column tiles."""
    from maxk_tpu_torch.ops import spmm_csr as sc
    from maxk_tpu_torch.ops.spmm_xla import spmm_segsum

    g = _csr_graph(v=v, e=20 * v, seed=2)
    csr = _with_hubs(g.csr, hubs)
    vals, sel = _selectors(v, k, d, k + d)
    vals = vals.to(dtype)
    dense = torch.from_numpy(_sequential_densify(vals.float().numpy(), sel.numpy(), d)).to(dtype)
    gc = csr.to(cuda)
    out = sc.spgemm_cbsr_cuda(gc, vals.to(cuda), sel.to(cuda), d)
    again = sc.spgemm_cbsr_cuda(gc, vals.to(cuda), sel.to(cuda), d)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (v, d)
    assert torch.equal(_bits(out), _bits(again))
    _check_segments(out, spmm_segsum(csr, dense), csr, _abs_spmm(csr, dense.abs()), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,d", [(32, 256), (7, 50), (40, 256), (1, 1), (8, 256), (16, 256),
                                 (64, 256), (96, 300), (160, 256)])
@pytest.mark.parametrize("sliced", [False, True])
def test_sspmm_cbsr_kernel(cuda, k, d, dtype, sliced, monkeypatch):
    """K11 over Aᵀ against `sample_plain(spmm_segsum(Aᵀ, g), sel)` on the CPU,
    in each lane layout: a segment to 8 lanes (k = 1, 7, 8), to 16 (k = 16),
    to the warp (k = 32), 2 and 4 slots a lane (k = 40, 64, 96; their
    segments of 16 edges or more ordered by selector, repeated and
    out-of-range selectors among them) and past 128 slots a second walk of
    the edges (k = 160); g walked over whole rows, and in column slices
    (`sliced`: the rule set to slice at any degree and k). Aᵀ has a row of
    many segments, empty rows, rows of one edge and rows of odd edge counts
    (the bf16 pairs' tail); a selector outside [0, D) gives 0; two launches
    give the same bits."""
    from maxk_tpu_torch.ops import spmm_csr as sc

    if sliced:
        monkeypatch.setattr(sc, "K11_SLICE_MIN_DEGREE", 0)
        monkeypatch.setattr(sc, "K11_SLICE_MAX_K", 1 << 30)

    g = _csr_graph(seed=3, lone=True)
    v = g.num_nodes
    deg = torch.diff(g.csc.indptr.long())
    assert bool((deg == 0).any()) and bool((deg == 1).any()) and int(deg.max()) > 4 * 256
    assert bool((deg % 2 == 1).any())
    _, sel = _selectors(v, k, d, k * d)
    ct = torch.randn((v, d), generator=torch.Generator().manual_seed(k)).to(dtype)
    gc = g.csc.to(cuda)
    out = sc.sspmm_cbsr_cuda(gc, ct.to(cuda), sel.to(cuda))
    again = sc.sspmm_cbsr_cuda(gc, ct.to(cuda), sel.to(cuda))
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (v, k)
    assert torch.equal(_bits(out), _bits(again))
    ref = sc.sspmm_cbsr_plain(g.csc, ct, sel)
    abs_ref = cbsr_cuda.sample_plain(_abs_spmm(g.csc, ct.abs()), sel)
    _check_segments(out, ref, g.csc, abs_ref, dtype)
    bad = (sel < 0) | (sel >= d)
    assert not _bits(out.cpu()[bad]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [7, 32, 64])
def test_sspmm_cbsr_kernel_bf16_pairs_round_once(cuda, k):
    """K11 in bf16 on rows of Aᵀ of 0-3 edges, weights and g spread over
    bf16's exponent range so that products are normal, subnormal and zero:
    T(+0.0 + p0 + p1 + ...) with each p = T(g · T(a)) summed in f32 in edge
    order, bit for bit, so a pair's `__hmul2_rn` and an odd row's lone last
    edge round as one conversion each does."""
    import numpy as np

    from maxk_tpu_torch.ops import spmm_csr as sc
    from maxk_tpu_torch.sparse.csr import CSRGraph, with_segments

    v, d = 4096, 64
    rng = np.random.default_rng(k)
    deg = np.arange(v) % 4
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    cols = rng.integers(0, v, int(indptr[-1])).astype(np.int32)
    a = (rng.choice([-1.0, 1.0], cols.shape[0])
         * 2.0 ** rng.uniform(-70, 10, cols.shape[0])).astype(np.float32)
    g = torch.from_numpy(rng.choice([-1.0, 1.0], (v, d)) * 2.0 ** rng.uniform(-80, 5, (v, d)))
    g = g.float().to(torch.bfloat16)
    sel = torch.from_numpy(np.stack([rng.permutation(d)[:k] for _ in range(v)]).astype(np.int32))
    csc = with_segments(CSRGraph(torch.from_numpy(indptr), torch.from_numpy(cols),
                                 torch.from_numpy(a)))
    out = sc.sspmm_cbsr_cuda(csc.to(cuda), g.to(cuda), sel.to(cuda)).cpu()
    ab = torch.from_numpy(a).to(torch.bfloat16).float()
    prod = (g[torch.from_numpy(cols).long()].float()
            * ab[:, None]).to(torch.bfloat16).float()  # (E, d)
    tiny = prod.abs() < torch.finfo(torch.bfloat16).tiny
    assert bool((tiny & (prod != 0)).any()) and bool((tiny & (prod == 0)).any())
    acc = torch.zeros((v, d))
    for i in range(3):  # the i-th edge of each row, in edge order
        rows = torch.from_numpy(np.nonzero(deg > i)[0])
        acc[rows] = acc[rows] + prod[torch.from_numpy(indptr[:-1]).long()[rows] + i]
    ref = torch.gather(acc, 1, sel.long()).to(torch.bfloat16)
    assert torch.equal(_bits(out), _bits(ref))


@pytest.mark.cuda
def test_sspmm_cbsr_takes_the_work_table_and_zeroed_counters(cuda, monkeypatch):
    """The wrapper hands K11 the table's `work` table and one zeroed int32
    counter a column slice of g (`csr_kernels_layout`'s k11_slice_cols, the
    rule set to slice); the C entry refuses a null counter or fewer
    counters than slices (an invalid value, nothing launched)."""
    from maxk_tpu_torch.ops import _native
    from maxk_tpu_torch.ops import spmm_csr as sc

    gt = _csr_graph(v=200, e=2000, seed=6).csc.to(cuda)
    d = 256
    g = torch.randn((200, d), device=cuda)
    sel = torch.randint(0, d, (200, 32), dtype=torch.int32, device=cuda)
    monkeypatch.setattr(sc, "K11_SLICE_MIN_DEGREE", 0)  # a walk in slices
    slices = -(-d // sc.kernel_layout(4, 32, d)["k11_slice_cols"])
    assert slices > 1 and sc.k11_slice(4, 32, d, 200, gt.nnz) < d
    made, seen = [], {}
    real_zeros, real_launch = torch.zeros, _native.launch

    def zeros(*a, **kw):
        made.append(real_zeros(*a, **kw))
        return made[-1]

    def launch(name, entry, t, *args):
        seen["entry"], seen["args"] = entry, args
        seen["counters"] = [z.clone() for z in made if z.data_ptr() == args[14]]
        return real_launch(name, entry, t, *args)

    monkeypatch.setattr(torch, "zeros", zeros)
    monkeypatch.setattr(_native, "launch", launch)
    ref = sc.sspmm_cbsr_cuda(gt, g, sel)
    monkeypatch.setattr(torch, "zeros", real_zeros)
    monkeypatch.setattr(_native, "launch", real_launch)
    args = seen["args"]
    assert seen["entry"] == "sspmm_cbsr_f32"
    assert args[9] == gt.segments.work.data_ptr()
    (ctr,) = seen["counters"]
    assert ctr.dtype == torch.int32 and ctr.numel() == slices and int(ctr.abs().sum()) == 0
    assert args[15 + 3] == slices  # nseg, nmulti, seg_edges, then the counters' count
    stream = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
    fn = _native._fns["sspmm_cbsr_f32"]
    assert fn(*args[:14], None, *args[15:], stream) != 0
    assert fn(*args[:18], slices - 1, *args[19:], stream) != 0
    torch.cuda.synchronize()
    assert torch.equal(_bits(sc.sspmm_cbsr_cuda(gt, g, sel)), _bits(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [8, 16, 32, 64])
@pytest.mark.parametrize("sliced", [False, True])
def test_sspmm_cbsr_many_long_units(cuda, k, dtype, sliced, monkeypatch):
    """K11 where the long segments (`LONG_EDGES` or more edges) fill more
    units than a persistent grid has warps in any layout (at most 6 blocks
    of 8 warps an SM): walked in slices, its warps take them from the
    slice's counter; over whole rows, a warp each. 28,000 rows of Aᵀ of
    129-131 edges, rows of 600 (three segments), of one edge and empty
    ones. Rows of one
    segment equal the sum of their products in edge order from +0.0 on the
    CPU bit for bit, the others within the regrouping; two launches give the
    same bits."""
    import numpy as np

    from maxk_tpu_torch.ops import spmm_csr as sc
    from maxk_tpu_torch.sparse.csr import CSRGraph, with_segments

    monkeypatch.setattr(sc, "K11_SLICE_MIN_DEGREE", 0 if sliced else 1 << 30)
    monkeypatch.setattr(sc, "K11_SLICE_MAX_K", 1 << 30 if sliced else 0)
    v, d, n_long = 28_672, 300, 28_000
    rng = np.random.default_rng(k)
    deg = np.zeros(v, np.int64)
    deg[:n_long] = 129 + np.arange(n_long) % 3
    deg[n_long:n_long + 16] = 600
    deg[n_long + 16:n_long + 32] = 1
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    cols = rng.integers(0, v, int(indptr[-1])).astype(np.int32)
    a = rng.standard_normal(cols.shape[0]).astype(np.float32)
    csc = with_segments(CSRGraph(torch.from_numpy(indptr), torch.from_numpy(cols),
                                 torch.from_numpy(a)))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    segs_a_unit = 32 // (8 if k <= 8 else 16 if k <= 16 else 32)
    assert csc.segments.long_segments // segs_a_unit >= sms * 6 * 8
    g = torch.randn((v, d), generator=torch.Generator().manual_seed(k)).to(dtype)
    _, sel = _selectors(v, k, d, k + 1)
    gc = csc.to(cuda)
    out = sc.sspmm_cbsr_cuda(gc, g.to(cuda), sel.to(cuda))
    again = sc.sspmm_cbsr_cuda(gc, g.to(cuda), sel.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(again))
    # the f32 sum of T(g · T(a)) over each row's edges in edge order
    ab = torch.from_numpy(a).to(dtype).float()
    gf, sl = g.float(), sel.long()
    ok = (sl >= 0) & (sl < d)
    acc, abs_acc = torch.zeros((v, k)), torch.zeros((v, k), dtype=torch.float64)
    starts, tc = torch.from_numpy(indptr[:-1]).long(), torch.from_numpy(cols).long()
    for i in range(int(deg.max())):
        rows = torch.from_numpy(np.nonzero(deg > i)[0])
        e = starts[rows] + i
        x = gf[tc[e][:, None], sl[rows].clamp(0, d - 1)]
        p = torch.where(ok[rows], (x * ab[e][:, None]).to(dtype).float(), 0.0)
        acc[rows] = acc[rows] + p
        abs_acc[rows] = abs_acc[rows] + p.double().abs()
    _check_segments(out, acc.to(dtype), csc, abs_acc, dtype)


@pytest.mark.cuda
def test_csr_kernels_launch_on_the_current_stream(cuda):
    """K9-K11 under `torch.cuda.stream(s)`, their input written on s after a
    sleep: the same bits as a launch on the default stream."""
    from maxk_tpu_torch.ops import spmm_csr as sc

    g = _csr_graph(seed=4)
    gc, gt = g.csr.to(cuda), g.csc.to(cuda)
    v = g.num_nodes
    vals, sel = _selectors(v, 32, 256, 5)
    vals, sel = vals.to(cuda), sel.to(cuda)
    x = torch.randn((v, 256), generator=torch.Generator(device=cuda).manual_seed(6), device=cuda)
    cases = {"spmm_csr": (sc.spmm_csr_cuda, (gc, x)),
             "spgemm_cbsr": (lambda a, b: sc.spgemm_cbsr_cuda(gc, a, b, 256), (vals, sel)),
             "sspmm_cbsr": (lambda a, b: sc.sspmm_cbsr_cuda(gt, a, b), (x, sel))}
    s = torch.cuda.Stream()
    for name, (kernel, args) in cases.items():
        ref = kernel(*args)
        late = [torch.zeros_like(a) if isinstance(a, torch.Tensor) else a for a in args]
        torch.cuda.synchronize()
        with torch.cuda.stream(s):
            torch.cuda._sleep(20_000_000)
            for dst, src in zip(late, args):
                if isinstance(src, torch.Tensor):
                    dst.copy_(src)
            got = kernel(*late)
        s.synchronize()
        assert torch.equal(_bits(got), _bits(ref)), name


@pytest.mark.cuda
def test_segsum_ops_run_the_csr_kernels(cuda, monkeypatch):
    """On the card `spmm(mode="segsum")` runs K9 for A and Aᵀ and
    `maxk_spgemm(mode="segsum")` K10 forward and K11 backward, one launch
    each a call, and none reaches `index_add_` or the densify and sample
    kernels; the plain versions count nothing."""
    from maxk_tpu_torch.ops import spmm_csr as sc
    from maxk_tpu_torch.ops.spgemm import spmm

    g = _csr_graph(seed=5)
    graph = build_graph(g.csr.to("cpu"), device=cuda)
    v = graph.num_nodes
    counters = (sc.spmm_csr_cuda, sc.spgemm_cbsr_cuda, sc.sspmm_cbsr_cuda,
                cbsr_cuda.densify_cuda, cbsr_cuda.sample_cuda)

    def launched(fn):
        before = [c.launches for c in counters]
        fn()
        torch.cuda.synchronize()
        return [c.launches - b for c, b in zip(counters, before)]

    def no_index_add(*a, **kw):
        raise AssertionError("index_add_ reached on the card")

    x = torch.randn((v, 64), device=cuda, requires_grad=True)
    vals = torch.randn((v, 8), device=cuda, requires_grad=True)
    sel = torch.randint(0, 64, (v, 8), device=cuda, dtype=torch.int32)
    monkeypatch.setattr(torch.Tensor, "index_add_", no_index_add)
    assert launched(lambda: spmm(graph, x, mode="segsum").sum().backward()) == [2, 0, 0, 0, 0]
    assert launched(lambda: maxk_spgemm(graph, CBSR(vals, sel), dim=64, mode="segsum",
                                        compute_dtype=torch.bfloat16).float().sum().backward()
                    ) == [0, 1, 1, 0, 0]
    monkeypatch.undo()
    assert launched(lambda: (sc.spmm_csr_plain(graph.csr, x.detach()),
                             sc.spgemm_cbsr_plain(graph.csr, vals.detach(), sel, 64),
                             sc.sspmm_cbsr_plain(graph.csc, x.detach(), sel))) == [0] * 5


@pytest.mark.cuda
def test_csr_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    from maxk_tpu_torch.ops import spmm_csr as sc

    g = _csr_graph(v=200, e=2000, seed=6)
    gc = g.csr.to(cuda)
    x = torch.randn((200, 32), device=cuda)
    sel = torch.zeros((200, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sc.spmm_csr_cuda(gc, x.cpu())
    with pytest.raises(ValueError, match="CUDA tensor"):
        sc.spmm_csr_cuda(g.csr, x)  # the CSR on the CPU
    with pytest.raises(ValueError, match="contiguous"):
        sc.spmm_csr(gc, torch.randn((32, 200), device=cuda).t())
    for dtype in (torch.float64, torch.float16):
        with pytest.raises(TypeError):
            sc.spmm_csr(gc, x.to(dtype))
    with pytest.raises(TypeError):
        sc.spgemm_cbsr(gc, x[:, :4].contiguous(), sel.long(), 32)
    with pytest.raises(ValueError):
        sc.spgemm_cbsr(gc, x[:, :4].contiguous(), sel[:100], 32)
    with pytest.raises(ValueError, match="int16"):
        sc.spgemm_cbsr(gc, x[:, :4].contiguous(), sel, 32768)
    with pytest.raises(ValueError, match="rows of Aᵀ"):
        sc.sspmm_cbsr(gc, x, sel[:100])
    with pytest.raises(TypeError):
        sc.sspmm_cbsr(gc, x.double(), sel)


@pytest.mark.cuda
def test_spmm_csr_kernel_refuses_fewer_counters_than_slices(cuda, monkeypatch):
    """K9 takes its work from a counter a column slice: handed fewer than
    its slices (a layout twice as wide), it launches nothing and the
    wrapper raises, in place of reading past the counters."""
    from maxk_tpu_torch.ops import spmm_csr as sc

    gc = _csr_graph(v=200, e=2000, seed=6).csr.to(cuda)
    x = torch.randn((200, 256), device=cuda)
    wide = sc._slice_cols(4) * 2
    monkeypatch.setattr(sc, "_slice_cols", lambda itemsize: wide)
    with pytest.raises(RuntimeError, match="CUDA error"):
        sc.spmm_csr_cuda(gc, x)


# the strip hybrid: torch products on the card (no kernel of the port's own)


def _norm_close(got, ref, tol):
    err = (got.float().cpu() - ref.float().cpu()).abs().max()
    assert err <= tol * ref.float().abs().max(), (float(err), float(ref.abs().max()))


@pytest.mark.cuda
def test_mm_f32_from_bf16_on_the_card(cuda):
    """`torch.mm(out_dtype=float32)` of bf16 operands, a transposed view
    included: exact products summed in f32, so within f32 rounding of the
    CPU's widened product."""
    from maxk_tpu_torch.ops.spmm_hybrid import _mm_f32

    gen = torch.Generator().manual_seed(0)
    a = torch.randn((3000, 700), generator=gen).to(torch.bfloat16)
    b = torch.randn((3000, 64), generator=gen).to(torch.bfloat16)
    got = _mm_f32(a.to(cuda).t(), b.to(cuda))
    assert got.dtype == torch.float32
    _norm_close(got, a.float().t() @ b.float(), 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n,row0", [(3000, 0), (13, 256), (1029, 300)])
def test_int8_strip_products_on_the_card(cuda, n, row0):
    """`torch._int_mm` through `_strip_arms_int8`: chunks padded to a
    multiple of 8 rows and more than 16 (13 rows, a 1029-row last chunk),
    hub and non-hub rows; int32 results equal the CPU's exactly."""
    from maxk_tpu_torch.ops.spmm_hybrid import _strip_arms_int8

    gen = torch.Generator().manual_seed(n)
    s, d = 256, 64
    w = (torch.rand((n, s), generator=gen) < 0.1).to(torch.int8)
    xq = torch.randint(-127, 128, (n, d), generator=gen, dtype=torch.int8)
    xqh = torch.randint(-127, 128, (s, d), generator=gen, dtype=torch.int8)
    hub, low = _strip_arms_int8(w, xq, xqh, row0, chunk=1024)
    hub_c, low_c = _strip_arms_int8(w.to(cuda), xq.to(cuda), xqh.to(cuda), row0, chunk=1024)
    assert torch.equal(hub_c.cpu(), hub) and torch.equal(low_c.cpu(), low)


@pytest.mark.cuda
@pytest.mark.parametrize("strip_dtype", [torch.int8, torch.bfloat16])
def test_hybrid_on_the_card_matches_the_cpu(cuda, strip_dtype):
    """The schedule built on the card equals the CPU's; spmm_hybrid (A and
    Aᵀ, int8 features too), spmm's gradient and maxk_spgemm under hybrid
    on the card agree with the CPU's within 1e-5 · max|ref| (the same
    bf16-rounded features, f32 sums in another order)."""
    from maxk_tpu_torch.ops.spgemm import spmm
    from maxk_tpu_torch.ops.spmm_hybrid import spmm_hybrid

    csr = rmat_graph(3000, 60000, seed=5)
    kw = dict(norm="right", hybrid=True, strip_cols=512, strip_dtype=strip_dtype)
    gc, gd = build_graph(csr, **kw), build_graph(csr, device=cuda, **kw)
    hc, hd = gc.hybrid, gd.hybrid
    assert torch.equal(hd.strip.cpu(), hc.strip) and torch.equal(hd.pre.cpu(), hc.pre)
    for f in ("block", "cols", "vals", "localrow"):
        assert torch.equal(getattr(hd.tail_tiles, f).cpu(), getattr(hc.tail_tiles, f))
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((3000, 64), generator=gen)
    for transpose in (False, True):
        _norm_close(spmm_hybrid(hd, x.to(cuda), transpose=transpose),
                    spmm_hybrid(hc, x, transpose=transpose), 1e-5)
    if strip_dtype == torch.int8:
        _norm_close(spmm_hybrid(hd, x.to(cuda), feat_int8=True),
                    spmm_hybrid(hc, x, feat_int8=True), 1e-5)
    xd = x.to(cuda).requires_grad_(True)
    spmm(gd, xd, mode="hybrid").backward(x.to(cuda))
    _norm_close(xd.grad, spmm_hybrid(hc, x, transpose=True), 1e-5)
    vals = torch.randn((3000, 8), generator=gen)
    sel = torch.stack([torch.randperm(64, generator=gen)[:8] for _ in range(3000)]).int()
    _norm_close(maxk_spgemm(gd, CBSR(vals.to(cuda), sel.to(cuda)), dim=64, mode="hybrid"),
                maxk_spgemm(gc, CBSR(vals, sel), dim=64, mode="hybrid"), 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["segsum", "hybrid"])
def test_validate_kernels_on_the_card(cuda, mode, tmp_path):
    """`--validate_kernels` through the CLI's entry on the card: the hook
    holds maxk_spgemm (K2 inside) against the plain path and passes."""
    from maxk_tpu_torch.__main__ import main as cli

    cli(["--dataset", "flickr", "--data_scale", "0.01", "--epochs", "2", "--hidden_dim", "64",
         "--hidden_layers", "2", "--maxk", "8", "--kernel_mode", mode, "--validate_kernels",
         "--path", str(tmp_path)])
    log = (tmp_path / "flickr_seed97" / "sage_maxk" / "train.log").read_text()
    lines = [line for line in log.splitlines() if "kernel validation:" in line]
    assert len(lines) == 1 and "ok=True" in lines[0], lines
