"""The port's strip hybrid (maxk_tpu_torch/sparse/hybrid.py,
ops/spmm_hybrid.py and the hybrid modes of its ops, graph builder and
training loop) against the JAX package's, on the same numpy-made graphs:

- the schedule is bit-equal: the degree permutation, the permuted CSR,
  the strip in f32, bf16 and int8 (the port's first V rows; the
  reference's rows past V are zero), `pre`/`post` for the four norms, the
  tail tables (the reference's first NT rows), the scan window and the
  banded tail;
- the planning rules give the reference's answers under its v5e rates;
- `spmm_hybrid`, forward and transposed, its gradient, `feat_int8`, and
  `maxk_spgemm` under the hybrid modes, against JAX's; the int32 overflow
  check; 3 training steps under `--kernel_mode hybrid`; directed graphs.

Tolerances, normwise (max|got - ref| <= tol · max|ref|): 1e-5 with an f32
strip (the same products summed in another order); 2 bf16 ulps of max|y|,
2·2^-7, with a bf16 or int8 strip (both packages round the features to
bf16 the same way, then sum exact products in f32 in another order, so a
last-bit difference can at most flip one bf16 rounding per term); 1e-6
for `feat_int8` (int8 × int8 → int32 sums are exact in both).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxk_tpu.data.datasets import GraphData as JaxGraphData
from maxk_tpu.data.synthetic import planted_partition_data, rmat_graph as jax_rmat_graph
from maxk_tpu.ops import spgemm as jsp
from maxk_tpu.ops import spmm_hybrid as jops
from maxk_tpu.sparse import csr as jcsr
from maxk_tpu.sparse import hybrid as jh
from maxk_tpu.sparse import meta as jmeta
from maxk_tpu.sparse.cbsr import CBSR as JCBSR
from maxk_tpu.sparse.graph import build_graph as jax_build_graph
from maxk_tpu.train import config as jcfg
from maxk_tpu.train import loop as jloop
from maxk_tpu_torch.data.datasets import GraphData
from maxk_tpu_torch.data.synthetic import rmat_graph
from maxk_tpu_torch.models.convert import import_flax_params
from maxk_tpu_torch.ops import spgemm as tsp
from maxk_tpu_torch.ops import spmm_hybrid as tops
from maxk_tpu_torch.ops.dispatch import KernelMode, resolve_mode
from maxk_tpu_torch.sparse import csr as tcsr
from maxk_tpu_torch.sparse import hybrid as th
from maxk_tpu_torch.sparse.cbsr import CBSR
from maxk_tpu_torch.sparse.graph import build_graph
from maxk_tpu_torch.train import config as tcfg
from maxk_tpu_torch.train import loop as tloop

torch.set_num_threads(1)

GRAPH = (700, 9000, 3)  # rmat_graph(V, E, seed)
S, D, K = 256, 32, 8
TILE_FIELDS = ("block", "cols", "vals", "localrow")
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}
BF16_TOL = 2 * 2.0**-7


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def _tol(dtype):
    return 1e-5 if dtype == "float32" else BF16_TOL


@pytest.fixture(scope="module")
def permuted():
    jg, tg = jax_rmat_graph(*GRAPH), rmat_graph(*GRAPH)
    return jh.permute_csr(jg, jh.degree_perm(jg)), th.permute_csr(tg, th.degree_perm(tg))


@pytest.fixture(scope="module")
def schedules(permuted):
    """(JAX, port) schedules by (strip dtype, norm)."""
    jpc, tpc = permuted
    return {(dt, norm): (jh.build_hybrid(jpc, s_cols=S, norm=norm, strip_dtype=DTYPES[dt][0]),
                         th.build_hybrid(tpc, s_cols=S, norm=norm, strip_dtype=DTYPES[dt][1]))
            for dt in DTYPES for norm in ("right", "both")}


def _x(seed=0, v=GRAPH[0], d=D):
    return np.random.default_rng(seed).standard_normal((v, d)).astype(np.float32)


def _assert_tables(jt, tt):
    """The port's tables are the reference's first NT rows; the rest is padding."""
    nt = tt.num_tiles
    for f in TILE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jt, f))[:nt], getattr(tt, f).numpy(),
                                      err_msg=f)
    assert not np.asarray(jt.vals)[nt:].any()


def test_degree_perm_and_permute_csr_match_jax(permuted):
    jg, tg = jax_rmat_graph(*GRAPH), rmat_graph(*GRAPH)
    np.testing.assert_array_equal(th.degree_perm(tg), jh.degree_perm(jg))
    jpc, tpc = permuted
    for f in ("indptr", "indices", "values"):
        np.testing.assert_array_equal(getattr(tpc, f).numpy(), np.asarray(getattr(jpc, f)))
    assert th.check_hybrid_ok(tpc) and jh.check_hybrid_ok(jpc)


@pytest.mark.parametrize("norm", ["none", "right", "left", "both"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_schedule_is_bit_equal(permuted, dtype, norm):
    jpc, tpc = permuted
    jd, td = DTYPES[dtype]
    j = jh.build_hybrid(jpc, s_cols=S, norm=norm, strip_dtype=jd)
    t = th.build_hybrid(tpc, s_cols=S, norm=norm, strip_dtype=td)
    v = GRAPH[0]
    assert t.strip.dtype == td and t.s_cols == j.s_cols == S and t.num_nodes == v
    js = np.asarray(j.strip.astype(jnp.float32))
    np.testing.assert_array_equal(t.strip.float().numpy(), js[:v])
    assert not js[v:].any()
    np.testing.assert_array_equal(t.pre.numpy(), np.asarray(j.pre))
    np.testing.assert_array_equal(t.post.numpy(), np.asarray(j.post))
    _assert_tables(j.tail_tiles, t.tail_tiles)
    assert t.tail_tiles.edge_tile == j.tail_tiles.cols.shape[1]
    assert th.TAIL_CHUNK == t.tail_chunk
    assert t.tail_window == jmeta.max_block_span(j.tail_tiles.block, t.tail_chunk)
    # the strip's row sums: its whole row under S (W's column), hub columns past it
    w = js[:v].astype(np.float64)
    np.testing.assert_array_equal(t.strip_row_sums[:S].numpy(), np.abs(w).sum(0)[:S])
    np.testing.assert_array_equal(t.strip_row_sums[S:].numpy(), np.abs(w[S:]).sum(1))


def test_banded_tail_is_bit_equal(permuted):
    jpc, tpc = permuted
    j = jh.build_hybrid(jpc, s_cols=128, norm="right", tail_band_cols=128)
    t = th.build_hybrid(tpc, s_cols=128, norm="right", tail_band_cols=128)
    assert len(t.tail_bands) == len(j.tail_bands) > 1
    assert [m[:2] for m in t.tail_band_meta] == [m[:2] for m in j.tail_band_meta]
    for jb, tb, (_, _, win) in zip(j.tail_bands, t.tail_bands, t.tail_band_meta):
        _assert_tables(jb, tb)
        assert win == jmeta.max_block_span(jb.block, t.tail_chunk)
    x = _x(5)
    _close(tops.spmm_hybrid(t, torch.from_numpy(x)),
           jops.spmm_hybrid(j, jnp.asarray(x)), BF16_TOL)


def test_planning_rules_match_jax():
    for v, e, dim, io, item in [(232965, 79_037_673, 256, 4, 1), (232965, 79_037_673, 256, 4, 2),
                                (2_449_029, 123_718_152, 256, 2, 1), (89250, 899_756, 256, 4, 2),
                                (700, 9000, 64, 4, 1), (100, 500, 32, 2, 2)]:
        for e_live in (None, e):
            assert th.auto_strip_cols(v, e_live=e_live, dim=dim, io_itemsize=io,
                                      strip_itemsize=item) == \
                jh.auto_strip_cols(v, e_live=e_live, dim=dim, io_itemsize=io,
                                   strip_itemsize=item)
        assert th.auto_strip_cols(v, s_cols=4096, strip_itemsize=item) == \
            jh.auto_strip_cols(v, s_cols=4096, strip_itemsize=item)
        assert th.hybrid_profitable(v, e, dim, io, item) == \
            jh.hybrid_profitable(v, e, dim, io, item)
        assert th.auto_tail_band_cols(v, S) == jh.auto_tail_band_cols(v, S)
    for span, band in ((600000, 32768), (1000, 128), (200000, 65536)):
        assert th._effective_band(span, band) == jh._effective_band(span, band)
    # the H100's rates plan wider than the v5e's at equal inputs
    h100 = th.Rates(th.H100_GATHER_SEC_PER_EDGE, th.H100_MATMUL_FLOPS, 85e9, 42.5e9)
    assert th.auto_strip_cols(232965, e_live=79_037_673, strip_itemsize=1, rates=h100) == \
        th.STRIP_COLS_INT8
    assert th.auto_strip_cols(2_449_029, e_live=123_718_152, strip_itemsize=1, rates=h100) > \
        jh.auto_strip_cols(2_449_029, e_live=123_718_152, strip_itemsize=1)
    assert th.hybrid_profitable(232965, 79_037_673, strip_itemsize=1, rates=h100)
    assert th.card_rates("cpu") == th.V5E


def test_strip_dtype_rules_match_jax():
    g = rmat_graph(*GRAPH)
    jg = jax_rmat_graph(*GRAPH)
    assert th.strip_int8_exact(g) and jh.strip_int8_exact(jg)
    assert th.auto_strip_dtype(g) == torch.int8
    for vals in (np.where(np.arange(g.nnz) % 3, 1.0, 2.5), np.full(g.nnz, 200.0),
                 np.full(g.nnz, -127.0)):
        tg = tcsr.CSRGraph(g.indptr, g.indices, torch.from_numpy(vals.astype(np.float32)))
        jgv = jcsr.CSRGraph(jg.indptr, jg.indices, jnp.asarray(vals, jnp.float32))
        assert th.strip_int8_exact(tg) == jh.strip_int8_exact(jgv)
        want = torch.int8 if jh.auto_strip_dtype(jgv) == jnp.int8 else torch.bfloat16
        assert th.auto_strip_dtype(tg) == want
    with pytest.raises(ValueError, match="strip_dtype=int8 requires integer strip values"):
        bad = tcsr.CSRGraph(g.indptr, g.indices, torch.full((g.nnz,), 0.5))
        th.build_hybrid(bad, s_cols=128, strip_dtype=torch.int8)


@pytest.mark.parametrize("band", [0, 128])
def test_tail_slot_stats_count_the_built_tables(permuted, band):
    """The port's stats count its own tables; the reference's are the same
    counts rounded to its TILE_PAD multiple (per band)."""
    jpc, tpc = permuted
    for s_cols, dtype in ((128, torch.int8), (256, torch.bfloat16)):
        t = th.build_hybrid(tpc, s_cols=s_cols, strip_dtype=dtype, tail_band_cols=band)
        tile = t.tail_tiles.edge_tile
        got = th.tail_slot_stats(tpc, s_cols, band, edge_tile=tile, presorted=True)
        ref = jh.tail_slot_stats(jpc, s_cols, band, edge_tile=tile, presorted=True)
        tables = t.tail_bands if band else (t.tail_tiles,)
        assert got["tiles"] == sum(tb.num_tiles for tb in tables)
        assert got["tail_live"] == ref["tail_live"] == int((t.tail_tiles.vals != 0).sum())
        rounded = sum(jmeta._round_tiles(tb.num_tiles) for tb in tables)
        assert ref["tiles"] == rounded and got["n_bands"] == ref["n_bands"]
        raw = rmat_graph(*GRAPH)
        assert th.tail_slot_stats(raw, s_cols, band, edge_tile=tile)["tiles"] == got["tiles"]


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_spmm_hybrid_matches_jax(schedules, dtype, transpose):
    for norm in ("right", "both"):
        j, t = schedules[(dtype, norm)]
        x = _x(1)
        y = tops.spmm_hybrid(t, torch.from_numpy(x), transpose=transpose)
        assert y.dtype == torch.float32
        _close(y, jops.spmm_hybrid(j, jnp.asarray(x), transpose=transpose), _tol(dtype))
        xs = x * np.asarray(j.post if transpose else j.pre)[:, None]
        _close(tops.spmm_hybrid(t, torch.from_numpy(xs), transpose=transpose, pre_applied=True),
               jops.spmm_hybrid(j, jnp.asarray(xs), transpose=transpose, pre_applied=True),
               _tol(dtype))


def test_spmm_hybrid_equals_the_normalized_operator():
    """With an f32 strip the op is A @ x, A the right-normalized permuted
    adjacency (the segment sum's), and Aᵀ @ x under `transpose`."""
    g = build_graph(rmat_graph(*GRAPH), norm="right", hybrid=True, strip_cols=S,
                    strip_dtype=torch.float32)
    x = torch.from_numpy(_x(2))
    _close(tsp.spmm(g, x, mode="hybrid"), tsp.spmm(g, x, mode="segsum"), 1e-5)
    _close(tops.spmm_hybrid(g.hybrid, x, transpose=True),
           tsp._spmm_impl(g, x, "segsum", transpose=True), 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_spmm_gradient_is_the_transposed_op(dtype):
    """spmm under `hybrid` differentiates to the transposed hybrid op, bit
    for bit, and to JAX's gradient of its `spmm(mode="hybrid")`."""
    jd, td = DTYPES[dtype]
    jg = jax_build_graph(jax_rmat_graph(*GRAPH), norm="right", build_tiles=False, hybrid=True,
                         strip_cols=S, strip_dtype=jd)
    tg = build_graph(rmat_graph(*GRAPH), norm="right", hybrid=True, strip_cols=S, strip_dtype=td)
    np.testing.assert_array_equal(tg.perm, np.asarray(jg.perm))
    x, ct = _x(3), _x(4)
    xt = torch.from_numpy(x).requires_grad_(True)
    tsp.spmm(tg, xt, mode="hybrid").backward(torch.from_numpy(ct))
    assert torch.equal(xt.grad, tops.spmm_hybrid(tg.hybrid, torch.from_numpy(ct), transpose=True))
    jgrad = jax.grad(lambda a: jnp.vdot(jsp.spmm(jg, a, mode="hybrid"), jnp.asarray(ct)))(
        jnp.asarray(x))
    _close(xt.grad, jgrad, _tol(dtype))


def test_feat_int8_matches_jax(schedules):
    j, t = schedules[("int8", "right")]
    x = _x(6)
    jxq, jscale = jops._quant_cols(jnp.asarray(x, jnp.bfloat16))
    txq, tscale = tops._quant_cols(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
    for transpose in (False, True):
        y = tops.spmm_hybrid(t, torch.from_numpy(x), transpose=transpose, feat_int8=True)
        _close(y, jops.spmm_hybrid(j, jnp.asarray(x), transpose=transpose, feat_int8=True), 1e-6)
        # lossy: within the quantization bound of the exact hybrid
        exact = tops.spmm_hybrid(t, torch.from_numpy(x), transpose=transpose)
        bound = tops.int8_error_bound(t, torch.from_numpy(x), transpose=transpose)
        assert 0 < float((y - exact).abs().max()) <= bound + 1e-5 * float(exact.abs().max())
    jb, tb = schedules[("bfloat16", "right")]
    with pytest.raises(ValueError) as ref:
        jops.spmm_hybrid(jb, jnp.asarray(x), feat_int8=True)
    with pytest.raises(ValueError) as got:
        tops.spmm_hybrid(tb, torch.from_numpy(x), feat_int8=True)
    assert str(got.value) == str(ref.value)


def _star(leaves: int) -> tcsr.CSRGraph:
    """Node 0 joined to `leaves` nodes by edges of value 127, both ways."""
    v = leaves + 1
    rows = np.concatenate([np.zeros(leaves, np.int64), np.arange(1, v)])
    cols = np.concatenate([np.arange(1, v), np.zeros(leaves, np.int64)])
    return tcsr.csr_from_coo(rows, cols, v, np.full(2 * leaves, 127.0, np.float32), dedup=False)


def test_int32_overflow_check():
    """127 x the strip's largest line sum must stay under 2^31: a hub column
    of 133,145 values of 127 (127 · 127 · 133,145 = 2,147,495,705) is
    refused before any product; 133,144 of them pass."""
    for leaves, fires in ((133_144, False), (133_145, True)):
        g = _star(leaves)
        h = th.build_hybrid(th.permute_csr(g, th.degree_perm(g)), s_cols=128,
                            strip_dtype=torch.int8)
        assert h.strip_line_sum == 127.0 * leaves
        if fires:
            with pytest.raises(ValueError, match="int32 sums may overflow"):
                tops.spmm_hybrid(h, torch.zeros((leaves + 1, 8)), feat_int8=True)
        else:
            tops.check_int32_sums(h)


@pytest.mark.parametrize("mode", ["hybrid", "hybrid_int8"])
def test_maxk_spgemm_matches_jax(mode):
    """maxk_spgemm under the hybrid modes: the pre-scale folded into the
    values, densify, the hybrid; its backward the transposed hybrid,
    sampled. Forward and dvals against JAX's."""
    jg = jax_build_graph(jax_rmat_graph(*GRAPH), norm="right", build_tiles=False, hybrid=True,
                         strip_cols=S)
    tg = build_graph(rmat_graph(*GRAPH), norm="right", hybrid=True, strip_cols=S)
    assert tg.hybrid.strip.dtype == torch.int8
    rng = np.random.default_rng(7)
    v = GRAPH[0]
    vals = rng.standard_normal((v, K)).astype(np.float32)
    sel = np.stack([rng.choice(D, K, replace=False) for _ in range(v)]).astype(np.int32)
    ct = _x(8)
    tol = 1e-6 if mode == "hybrid_int8" else BF16_TOL

    def jfn(a):
        return jnp.vdot(jsp.maxk_spgemm(jg, JCBSR(a, jnp.asarray(sel)), dim=D, mode=mode),
                        jnp.asarray(ct))

    jy = jsp.maxk_spgemm(jg, JCBSR(jnp.asarray(vals), jnp.asarray(sel)), dim=D, mode=mode)
    jd = jax.grad(jfn)(jnp.asarray(vals))
    vt = torch.from_numpy(vals).requires_grad_(True)
    y = tsp.maxk_spgemm(tg, CBSR(vt, torch.from_numpy(sel)), dim=D, mode=mode)
    y.backward(torch.from_numpy(ct))
    _close(y.detach(), jy, tol)
    _close(vt.grad, jd, BF16_TOL)


def _data():
    jc = jax_rmat_graph(200, 1500, seed=7)
    feats, labels, masks = planted_partition_data(jc, 32, 5, seed=7)
    common = dict(name="tiny", features=feats, labels=labels, train_mask=masks[0],
                  val_mask=masks[1], test_mask=masks[2], num_classes=5, multilabel=False)
    return JaxGraphData(csr=jc, **common), GraphData(csr=rmat_graph(200, 1500, seed=7), **common)


def test_three_steps_under_hybrid_match_jax():
    """MaxK-SAGE under `--kernel_mode hybrid` from imported parameters,
    dropout 0: the graph, its permutation and the permuted node data equal
    the JAX package's, and the loss of 3 Adam steps agrees within 1e-4
    relative (both aggregate bf16-rounded features; the sums differ in
    order); then train/val/test accuracy within one node's flip."""
    jdata, tdata = _data()
    args = dict(hidden_dim=32, hidden_layers=2, maxk=4, dropout=0.0, lr=0.01,
                kernel_mode="hybrid")
    jstate = jloop.setup(jcfg.TrainConfig(**args), jdata)
    tstate = tloop.setup(tcfg.TrainConfig(device="cpu", **args), tdata)
    jh_, h = jstate.graph.hybrid, tstate.graph.hybrid
    assert h.strip.dtype == torch.int8 and h.s_cols == jh_.s_cols
    np.testing.assert_array_equal(tstate.graph.perm, np.asarray(jstate.graph.perm))
    jp = jloop.permuted_data(jdata, jstate.graph)
    tp = tloop.permuted_data(tdata, tstate.graph.perm)
    for f in ("features", "labels", "train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(tp, f), np.asarray(getattr(jp, f)))
    assert tloop.permuted_data(tdata, None) is tdata
    tstate.model.load_state_dict(
        import_flax_params(jax.tree.map(np.asarray, jstate.variables["params"])), strict=True)
    jstep = jloop.make_train_step(jstate.model, jstate.tx, False)
    tstep = tloop.make_train_step(tstate.model, tstate.optimizer, False)
    feats, labels, masks = tloop._device_arrays(tp, torch.device("cpu"))
    variables, opt_state = jstate.variables, jstate.opt_state
    for _ in range(3):
        variables, opt_state, jloss, _ = jstep(
            variables, opt_state, jstate.rng, jstate.graph, jnp.asarray(jp.features),
            jnp.asarray(jp.labels), jnp.asarray(jp.train_mask))
        tloss, _ = tstep(tstate.graph, feats, labels, masks[0], tstate.generator)
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-4)
    jstate.variables = variables
    np.testing.assert_allclose(tloop.evaluate(tstate, tdata), jloop.evaluate(jstate, jdata),
                               rtol=0, atol=1.5 / 40)


def _directed():
    rows, cols = np.array([0, 1, 2, 2]), np.array([1, 2, 0, 1])
    data = GraphData(name="tiny", csr=tcsr.csr_from_coo(rows, cols, 3),
                     features=np.ones((3, 4), np.float32), labels=np.zeros(3, np.int64),
                     train_mask=np.ones(3, bool), val_mask=np.ones(3, bool),
                     test_mask=np.ones(3, bool), num_classes=2, multilabel=False)
    return data


def test_directed_graphs_refuse_an_explicit_hybrid():
    """A directed graph gets no schedule (the reference's silent fallback in
    build_graph); an explicit hybrid mode then raises, AUTO runs segsum."""
    data = _directed()
    jg = jax_build_graph(jcsr.csr_from_coo(np.array([0, 1, 2, 2]), np.array([1, 2, 0, 1]), 3),
                         hybrid=True, build_tiles=False)
    g = build_graph(data.csr, hybrid=True)
    assert g.hybrid is None and g.perm is None and jg.hybrid is None
    assert not th.check_hybrid_ok(data.csr)
    for mode in ("hybrid", "hybrid_int8"):
        with pytest.raises(ValueError) as ref:
            jsp.spmm(jg, jnp.ones((3, 4)), mode=mode)
        with pytest.raises(ValueError) as got:
            tsp.spmm(g, torch.ones((3, 4)), mode=mode)
        assert str(got.value) == str(ref.value)
        with pytest.raises(ValueError, match="needs a graph built with build_graph"):
            tloop.setup(tcfg.TrainConfig(device="cpu", kernel_mode=mode, hidden_dim=8, maxk=2,
                                         hidden_layers=1), data)
    state = tloop.setup(tcfg.TrainConfig(device="cpu", hidden_dim=8, maxk=2, hidden_layers=1),
                        data)
    assert state.graph.hybrid is None
    assert resolve_mode("auto", False, state.graph.hybrid is not None) == KernelMode.SEGSUM


def test_auto_resolves_to_the_schedule():
    assert resolve_mode("auto", has_tiles=True, has_hybrid=True) == KernelMode.HYBRID
    assert resolve_mode("auto", has_hybrid=False) == KernelMode.SEGSUM
    assert resolve_mode("hybrid_int8") == KernelMode.HYBRID_INT8
    g = build_graph(rmat_graph(*GRAPH), norm="right", hybrid=True, strip_cols=S)
    x = torch.from_numpy(_x(9))
    assert torch.equal(tsp.spmm(g, x), tsp.spmm(g, x, mode="hybrid"))
    # the CPU plans with the reference's rates, so AUTO stays segsum there
    cfg = tcfg.TrainConfig(device="cpu")
    assert not tloop.wants_hybrid(cfg, rmat_graph(*GRAPH), torch.device("cpu"))
    assert tloop.wants_hybrid(tcfg.TrainConfig(device="cpu", kernel_mode="hybrid_int8"),
                              rmat_graph(*GRAPH), torch.device("cpu"))


def test_build_graph_hybrid_defaults_match_jax():
    """build_graph(hybrid=True) with its defaults picks the reference's
    dtype, width and tail tile on the CPU (the reference's rates)."""
    jg = jax_build_graph(jax_rmat_graph(*GRAPH), norm="right", build_tiles=False, hybrid=True,
                         dim=64)
    tg = build_graph(rmat_graph(*GRAPH), norm="right", hybrid=True, dim=64)
    assert tg.hybrid.s_cols == jg.hybrid.s_cols
    assert tg.hybrid.strip.dtype == torch.int8 and jg.hybrid.strip.dtype == jnp.int8
    assert tg.hybrid.tail_tiles.edge_tile == th.TAIL_EDGE_TILE_INT8
    for f in ("indptr", "indices", "values"):
        np.testing.assert_array_equal(getattr(tg.csr, f).numpy(), np.asarray(getattr(jg.csr, f)))
    assert tg.csc is not tg.csr  # right norm is not symmetric
