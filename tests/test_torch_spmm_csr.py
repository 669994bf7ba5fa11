"""The segsum path's CSR aggregation (`ops/spmm_csr.py`, K9-K11) on the CPU:
the plain versions against the JAX package's `spmm_segsum` and
`maxk_spgemm` (forward and VJP, mode segsum), the routing of `spmm` and
`maxk_spgemm` through the wrappers, and the segment table the kernels walk.

The graph (numpy, seeded) is directed with random weights, has empty rows
in A and in Aᵀ, a hub row of A and a hub row of Aᵀ longer than two
segments, and the CBSR selectors repeat within rows.

Tolerances, element by element, n the row's edges (for the forward of
maxk_spgemm the row's edges times k: the densify's duplicate sums too):
in f32 |got - ref| <= 2·n·2⁻²⁴·Σ|terms|, the bound of an f32 sum of n
terms taken in another order; with bf16 features (n + 2)·2⁻⁸·Σ|terms|,
since the reference's one-shot segsum (and its one-hot densify) sums in
bf16, each partial sum rounded by up to 2⁻⁹ of itself, where the port sums
in f32 and rounds once."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxk_tpu.ops import spgemm as jsp
from maxk_tpu.ops.spmm_xla import spmm_segsum as jax_spmm_segsum
from maxk_tpu.sparse.cbsr import CBSR as JCBSR
from maxk_tpu.sparse.csr import csr_from_coo as jax_csr_from_coo
from maxk_tpu.sparse.graph import build_graph as jax_build_graph
from maxk_tpu_torch.ops import spgemm as tsp
from maxk_tpu_torch.ops import spmm_csr as sc
from maxk_tpu_torch.parallel.shard import build_sharded_graph
from maxk_tpu_torch.sparse.cbsr import CBSR
from maxk_tpu_torch.sparse.csr import (HUB_ROWS, LONG_EDGES, SEG_EDGES, csr_from_coo, hub_table,
                                       row_segments)
from maxk_tpu_torch.sparse.graph import build_graph

torch.set_num_threads(1)

V, D, K = 600, 48, 6
HUB_ROW, HUB_COL = 5, 7
EMPTY_ROWS = range(10, 20)  # no edge in A's rows
EMPTY_COLS = range(590, 600)  # no edge in Aᵀ's rows


def _coo(seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, V, 3000)
    cols = rng.integers(0, V, 3000)
    hub = rng.permutation(V)[:560]  # row HUB_ROW: 560 edges, > 2 segments
    rows = np.concatenate([rows, np.full(560, HUB_ROW), np.arange(V)])
    cols = np.concatenate([cols, hub, np.full(V, HUB_COL)])  # column HUB_COL: every row
    keep = ~np.isin(rows, EMPTY_ROWS) & ~np.isin(cols, EMPTY_COLS)
    rows, cols = rows[keep], cols[keep]
    return rows, cols, rng.standard_normal(rows.shape[0]).astype(np.float32)


@pytest.fixture(scope="module")
def graphs():
    rows, cols, vals = _coo()
    jg = jax_build_graph(jax_csr_from_coo(rows, cols, V, vals, dedup=False), build_tiles=False)
    tg = build_graph(csr_from_coo(rows, cols, V, vals, dedup=False))
    assert tg.csc is not tg.csr
    return jg, tg


def _sum_bound(csr, x_abs: np.ndarray, n_terms: np.ndarray, bf16: bool = False) -> np.ndarray:
    """2·n·2⁻²⁴·(|A| @ |x|) per element, n per row; bf16: (n + 2)·2⁻⁸·(...)."""
    a = csr_scipy_abs(csr) @ x_abs
    if bf16:
        return (n_terms[:, None] + 2.0) * 2.0**-8 * a
    return 2.0 * n_terms[:, None] * 2.0**-24 * a


def csr_scipy_abs(csr):
    import scipy.sparse as sp

    v = csr.num_nodes
    return sp.csr_matrix((np.abs(csr.values.numpy()).astype(np.float64), csr.indices.numpy(),
                          csr.indptr.numpy()), shape=(v, v))


def _degrees(csr) -> np.ndarray:
    return np.diff(csr.indptr.numpy()).astype(np.float64)


def _cbsr(rng):
    """(V, K) values and in-range selectors, each row repeating some."""
    sel = rng.integers(0, D, (V, K)).astype(np.int32)
    sel[:, 1] = sel[:, 0]
    sel[::3, K - 1] = sel[::3, 2]
    return rng.standard_normal((V, K)).astype(np.float32), sel


def test_the_graph_has_what_the_kernels_must_handle(graphs):
    _, tg = graphs
    deg, deg_t = _degrees(tg.csr), _degrees(tg.csc)
    assert (deg[list(EMPTY_ROWS)] == 0).all() and (deg_t[list(EMPTY_COLS)] == 0).all()
    assert deg[HUB_ROW] > 2 * SEG_EDGES and deg_t[HUB_COL] > 2 * SEG_EDGES


@pytest.mark.parametrize("transpose", [False, True])
def test_spmm_csr_plain_matches_jax_f32(graphs, transpose):
    jg, tg = graphs
    jcsr, tcsr = (jg.csc, tg.csc) if transpose else (jg.csr, tg.csr)
    x = np.random.default_rng(1).standard_normal((V, D)).astype(np.float32)
    ref = np.asarray(jax_spmm_segsum(jcsr, jnp.asarray(x)))
    got = sc.spmm_csr(tcsr, torch.from_numpy(x))
    assert got.dtype == torch.float32
    bound = _sum_bound(tcsr, np.abs(x).astype(np.float64), _degrees(tcsr))
    assert (np.abs(got.numpy() - ref) <= bound).all()
    assert (got.numpy()[list(EMPTY_COLS if transpose else EMPTY_ROWS)] == 0).all()


def test_spmm_csr_plain_matches_jax_bf16(graphs):
    jg, tg = graphs
    x = np.random.default_rng(2).standard_normal((V, D)).astype(np.float32)
    ref = np.asarray(jax_spmm_segsum(jg.csr, jnp.asarray(x, jnp.bfloat16)), np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = sc.spmm_csr(tg.csr, xb)
    assert got.dtype == torch.bfloat16
    bound = _sum_bound(tg.csr, xb.abs().double().numpy(), _degrees(tg.csr), bf16=True)
    assert (np.abs(got.float().numpy() - ref) <= bound).all()


@pytest.mark.parametrize("bf16", [False, True])
def test_maxk_spgemm_pair_plain_matches_jax(graphs, bf16):
    """K10's plain version against the JAX forward and K11's against its VJP
    (mode segsum), duplicate selectors included."""
    jg, tg = graphs
    rng = np.random.default_rng(3)
    vals, sel = _cbsr(rng)
    g = rng.standard_normal((V, D)).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)

    def f(v):
        return jsp.maxk_spgemm(jg, JCBSR(v, jnp.asarray(sel)), dim=D, mode="segsum",
                               compute_dtype=jdt)

    y_ref, vjp = jax.vjp(f, jnp.asarray(vals))
    (dv_ref,) = vjp(jnp.asarray(g))
    y_ref, dv_ref = np.asarray(y_ref, np.float32), np.asarray(dv_ref, np.float32)
    tv, ts, tg_ = torch.from_numpy(vals), torch.from_numpy(sel), torch.from_numpy(g)
    if bf16:
        tv, tg_ = tv.to(tdt), tg_.to(tdt)
    y = sc.spgemm_cbsr(tg.csr, tv, ts, D).float().numpy()
    dv = sc.sspmm_cbsr(tg.csc, tg_, ts).float().numpy()
    dense_abs = np.zeros((V, D))
    np.add.at(dense_abs, (np.arange(V)[:, None], sel), tv.abs().double().numpy())
    bound = _sum_bound(tg.csr, dense_abs, K * _degrees(tg.csr), bf16)
    assert (np.abs(y - y_ref) <= bound).all()
    z_bound = _sum_bound(tg.csc, tg_.abs().double().numpy(), _degrees(tg.csc), bf16)
    assert (np.abs(dv - dv_ref) <= np.take_along_axis(z_bound, sel, 1)).all()


def test_plain_versions_define_the_pair(graphs):
    """K10 = densify + K9, K11 = K9 over Aᵀ + sample: out-of-range
    selectors add nothing forward and give 0 backward."""
    _, tg = graphs
    rng = np.random.default_rng(4)
    vals, sel = _cbsr(rng)
    sel[::5, 3] = -1
    sel[::7, 4] = D
    tv, ts = torch.from_numpy(vals), torch.from_numpy(sel)
    g = torch.from_numpy(rng.standard_normal((V, D)).astype(np.float32))
    from maxk_tpu_torch.ops.cbsr_cuda import densify_plain, sample_plain

    assert torch.equal(sc.spgemm_cbsr(tg.csr, tv, ts, D),
                       sc.spmm_csr(tg.csr, densify_plain(tv, ts, D)))
    dv = sc.sspmm_cbsr(tg.csc, g, ts)
    assert torch.equal(dv, sample_plain(sc.spmm_csr(tg.csc, g), ts))
    assert (dv[::5, 3] == 0).all() and (dv[::7, 4] == 0).all()


def _counting(monkeypatch):
    calls = {}
    for name in ("spmm_csr_plain", "spgemm_cbsr_plain", "sspmm_cbsr_plain"):
        fn = getattr(sc, name)

        def wrapped(*a, _fn=fn, _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a)

        monkeypatch.setattr(sc, name, wrapped)
    return calls


@pytest.mark.parametrize("mode", ["segsum", "auto"])
def test_segsum_routes_through_the_wrappers(graphs, monkeypatch, mode):
    """On CPU tensors `spmm` runs `spmm_csr`'s plain version for A and Aᵀ, and
    `maxk_spgemm` K10's forward and K11's backward, nothing else."""
    _, tg = graphs
    calls = _counting(monkeypatch)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((V, D)).astype(np.float32)).requires_grad_(True)
    tsp.spmm(tg, x, mode=mode).sum().backward()
    assert calls == {"spmm_csr_plain": 2}
    calls.clear()
    vals, sel = _cbsr(rng)
    tv = torch.from_numpy(vals).requires_grad_(True)
    y = tsp.maxk_spgemm(tg, CBSR(tv, torch.from_numpy(sel)), dim=D, mode=mode,
                        compute_dtype=torch.bfloat16)
    y.float().sum().backward()
    assert calls == {"spgemm_cbsr_plain": 1, "sspmm_cbsr_plain": 1}
    assert y.dtype == torch.float32 and tv.grad.dtype == torch.float32


def test_sharded_segsum_forward_routes_through_k10(graphs, monkeypatch):
    """A rank's block at world size 1 (no collective runs): the forward is
    K10 over the block, the backward K11 over the Aᵀ block at the gathered
    selectors (sampled before the reduce-scatter); both equal one device's."""
    _, tg = graphs
    rows, cols, vals = _coo()
    mesh = types.SimpleNamespace(world_size=1, rank=0, device=torch.device("cpu"))
    sg = build_sharded_graph(csr_from_coo(rows, cols, V, vals, dedup=False), mesh)
    assert sg.fwd.segments is not None and sg.bwd.segments is not None
    calls = _counting(monkeypatch)
    monkeypatch.setattr(tsp, "all_gather_rows", lambda t, mesh: t)
    monkeypatch.setattr(tsp, "reduce_scatter_rows", lambda t, mesh: t)
    rng = np.random.default_rng(6)
    v, s = _cbsr(rng)
    tv = torch.from_numpy(v).requires_grad_(True)
    y = tsp.maxk_spgemm(sg, CBSR(tv, torch.from_numpy(s)), dim=D, mode="segsum")
    y.sum().backward()
    assert calls == {"spgemm_cbsr_plain": 1, "sspmm_cbsr_plain": 1}
    rv = tv.detach().clone().requires_grad_(True)
    ref = tsp.maxk_spgemm(tg, CBSR(rv, torch.from_numpy(s)), dim=D, mode="segsum")
    ref.sum().backward()
    torch.testing.assert_close(y.detach(), ref.detach(), rtol=0, atol=0)
    torch.testing.assert_close(tv.grad, rv.grad, rtol=0, atol=0)


@pytest.mark.parametrize("seg_edges", [1, 3, 64, SEG_EDGES])
@pytest.mark.parametrize("transpose", [False, True])
def test_segment_table_covers_every_edge_once_in_csr_order(graphs, seg_edges, transpose):
    _, tg = graphs
    csr = tg.csc if transpose else tg.csr
    t = row_segments(csr, seg_edges)
    indptr = csr.indptr.long()
    row, begin, part = t.row.long(), t.begin.long(), t.part.long()
    end = torch.minimum(begin + seg_edges, indptr[row + 1])
    assert t.seg_edges == seg_edges and t.row.dtype == torch.int32
    # segments in CSR order, back to back, each non-empty but an empty row's one
    assert torch.equal(begin[1:], end[:-1]) and int(begin[0]) == 0 and int(end[-1]) == csr.nnz
    assert torch.equal(torch.unique_consecutive(row), torch.arange(csr.num_nodes))
    assert bool((row[1:] >= row[:-1]).all())
    deg = torch.diff(indptr)
    assert bool(((end > begin) | (deg[row] == 0)).all())
    assert bool((end - begin <= seg_edges).all())
    edge_rows = torch.repeat_interleave(row, end - begin)
    assert torch.equal(edge_rows, csr.row_ids().long())
    # partial rows: -1 for a row of one segment, else 0..P-1 in table order
    nseg = torch.bincount(row, minlength=csr.num_nodes)
    multi = nseg[row] > 1
    assert bool((part[~multi] == -1).all())
    assert torch.equal(part[multi], torch.arange(t.num_parts))
    mrow = torch.nonzero(nseg > 1).flatten()
    assert torch.equal(t.multi_row.long(), mrow)
    assert torch.equal(t.multi_nseg.long(), nseg[mrow])
    first = torch.searchsorted(row, mrow)
    assert torch.equal(t.multi_part0.long(), part[first])
    assert t.num_parts == int(nseg[mrow].sum())


def test_graphs_carry_their_tables(graphs):
    """build_graph attaches a table to A and Aᵀ (shared when Aᵀ is A), A's
    with its hub table (K10 walks A), Aᵀ's without, and `CSRGraph.to` moves
    it."""
    _, tg = graphs
    for csr in (tg.csr, tg.csc):
        t, ref = csr.segments, row_segments(csr)
        assert t is not None and t.num_parts == ref.num_parts
        assert torch.equal(t.begin, ref.begin) and torch.equal(t.part, ref.part)
    rows, cols, _ = _coo()
    sym = build_graph(csr_from_coo(np.concatenate([rows, cols]), np.concatenate([cols, rows]), V))
    assert sym.csc is sym.csr and sym.csr.segments is not None
    for csr in (tg.csr, sym.csr):
        assert np.array_equal(csr.segments.hub_rows.numpy(), _reference_hubs(csr, HUB_ROWS))
    assert tg.csc.segments.hub_rows.shape == tg.csc.segments.hub_slot.shape == (0,)
    moved = tg.csr.to("cpu")
    assert moved.segments is not None and torch.equal(moved.segments.row, tg.csr.segments.row)


def _live(csr):
    return csr.indices[: int(csr.indptr[-1])]


def _reference_hubs(csr, h):
    """The h most-referenced columns, ties to the lower column, by numpy."""
    live = csr.indices[: int(csr.indptr[-1])].numpy()
    counts = np.bincount(live)
    return np.lexsort((np.arange(counts.shape[0]), -counts))[:h]


@pytest.mark.parametrize("h", [1, 7, 40, HUB_ROWS])
@pytest.mark.parametrize("transpose", [False, True])
def test_hub_table_holds_the_most_referenced_columns(graphs, h, transpose):
    """hub_rows: the h columns with the most references, most first, ties to
    the lower column; hub_slot maps each of them to its slot and every other
    column to -1, over columns 0..largest index."""
    _, tg = graphs
    csr = tg.csc if transpose else tg.csr
    hub_rows, hub_slot = hub_table(_live(csr), h)
    ref = _reference_hubs(csr, h)
    assert hub_rows.dtype == torch.int32 and hub_slot.dtype == torch.int32
    assert np.array_equal(hub_rows.numpy(), ref)
    assert hub_slot.shape[0] == int(_live(csr).max()) + 1
    assert torch.equal(hub_slot[hub_rows.long()], torch.arange(len(ref), dtype=torch.int32))
    rest = torch.ones(hub_slot.shape[0], dtype=torch.bool)
    rest[hub_rows.long()] = False
    assert bool((hub_slot[rest] == -1).all())
    hub = HUB_ROW if transpose else HUB_COL  # in every row of A: the most referenced
    assert int(hub_rows[0]) == hub
    # the segment table's, with `hubs`: the HUB_ROWS-column table
    t = row_segments(csr, hubs=True)
    full_rows, full_slot = hub_table(_live(csr))
    assert torch.equal(t.hub_rows, full_rows) and torch.equal(t.hub_slot, full_slot)


def test_hub_table_ties_go_to_the_lower_column():
    """Columns 9, 3 and 5 twice each, 1 once: the table is 3, 5, 9, 1."""
    csr = csr_from_coo(np.array([0, 1, 2, 3, 4, 5, 6]), np.array([9, 3, 5, 9, 3, 5, 1]), 10,
                       dedup=False)
    hub_rows, hub_slot = hub_table(_live(csr), 4)
    assert hub_rows.tolist() == [3, 5, 9, 1]
    assert hub_slot.tolist() == [-1, 3, -1, 0, -1, 1, -1, -1, -1, 2]


@pytest.mark.parametrize("h", [0, V, 10 * V])
def test_hub_table_empty_or_every_column(graphs, h):
    """H = 0: no hub row, every slot -1; H at or past the column count: every
    column referenced or not up to the largest index, in the table once."""
    _, tg = graphs
    hub_rows, hub_slot = hub_table(_live(tg.csr), h)
    ncols = hub_slot.shape[0]
    if h == 0:
        assert hub_rows.shape == (0,) and bool((hub_slot == -1).all())
    else:
        assert hub_rows.shape == (ncols,)
        assert torch.equal(torch.sort(hub_rows).values, torch.arange(ncols, dtype=torch.int32))
        assert torch.equal(hub_slot[hub_rows.long()], torch.arange(ncols, dtype=torch.int32))
    with pytest.raises(ValueError, match="rows"):
        hub_table(_live(tg.csr), -1)


@pytest.mark.parametrize("seg_edges", [3, SEG_EDGES])
def test_work_order_puts_long_segments_first(graphs, seg_edges):
    """order: a permutation of the segments by length, longest first, equal
    lengths in table order."""
    _, tg = graphs
    t = row_segments(tg.csr, seg_edges)
    indptr = tg.csr.indptr.long()
    begin = t.begin.long()
    length = torch.minimum(begin + seg_edges, indptr[t.row.long() + 1]) - begin
    order = t.order.long()
    assert t.order.dtype == torch.int32
    assert torch.equal(torch.sort(order).values, torch.arange(t.num_segments))
    lo = length[order]
    assert bool((lo[1:] <= lo[:-1]).all())
    same = lo[1:] == lo[:-1]
    assert bool((order[1:][same] > order[:-1][same]).all())


@pytest.mark.parametrize("seg_edges", [3, SEG_EDGES])
def test_work_table_is_the_segments_in_work_order(graphs, seg_edges):
    """work: each segment in work order as (row, first edge, edges, part),
    a contiguous (S, 4) int32 table."""
    _, tg = graphs
    t = row_segments(tg.csr, seg_edges)
    indptr = tg.csr.indptr.long()
    begin = t.begin.long()
    length = torch.minimum(begin + seg_edges, indptr[t.row.long() + 1]) - begin
    o = t.order.long()
    assert t.work.dtype == torch.int32 and t.work.shape == (t.num_segments, 4)
    assert t.work.is_contiguous()
    want = torch.stack([t.row.long()[o], begin[o], length[o], t.part.long()[o]], 1)
    assert torch.equal(t.work.long(), want)
    # the long segments lead the work order
    long = length[o] >= LONG_EDGES
    assert t.long_segments == int(long.sum()) and bool(long[: t.long_segments].all())
    assert (t.long_segments > 0) == (seg_edges >= LONG_EDGES)


def test_moved_table_equals_the_table_of_the_moved_csr(graphs):
    """The table moved with its CSR (`CSRGraph.to`) equals the one built on
    the moved CSR, field by field."""
    _, tg = graphs
    moved = tg.csr.to("cpu")
    built = row_segments(moved, hubs=True)
    for f in ("row", "begin", "part", "multi_row", "multi_part0", "multi_nseg", "order",
              "work", "hub_rows", "hub_slot"):
        assert torch.equal(getattr(moved.segments, f), getattr(built, f)), f
    assert moved.segments.num_parts == built.num_parts
    assert moved.segments.long_segments == built.long_segments


def test_sharded_blocks_carry_hub_tables_over_the_gathered_columns():
    """build_sharded_graph attaches to a rank's forward block (which K10
    walks) a hub table over the block's own columns (the gathered features'
    rows), sized from its largest index, and none to its backward block."""
    rows, cols, vals = _coo()
    mesh = types.SimpleNamespace(world_size=1, rank=0, device=torch.device("cpu"))
    sg = build_sharded_graph(csr_from_coo(rows, cols, V, vals, dedup=False), mesh)
    t = sg.fwd.segments
    assert t.hub_slot.shape[0] == int(_live(sg.fwd).max()) + 1
    assert np.array_equal(t.hub_rows.numpy(), _reference_hubs(sg.fwd, HUB_ROWS))
    assert sg.bwd.segments.hub_rows.shape == sg.bwd.segments.hub_slot.shape == (0,)


def test_wrappers_refuse_other_devices(graphs):
    _, tg = graphs
    x = torch.zeros((V, D), device="meta")
    with pytest.raises(ValueError, match="no implementation for device meta"):
        sc.spmm_csr(tg.csr, x)


def test_k11_slice_rule(monkeypatch):
    """K11 walks g in column slices only where rows are gathered often
    (E/V >= K11_SLICE_MIN_DEGREE) and touched sparsely (k <= K11_SLICE_MAX_K),
    else over whole rows; a slice never exceeds the row."""
    monkeypatch.setattr(sc, "_k11_slice_cols", lambda itemsize: 512 // itemsize)
    v, deg = 1000, sc.K11_SLICE_MIN_DEGREE
    assert sc.k11_slice(4, 32, 256, v, deg * v) == 128
    assert sc.k11_slice(2, 16, 512, v, deg * v) == 256
    assert sc.k11_slice(2, 32, 256, v, deg * v) == 256
    assert sc.k11_slice(4, 32, 100, v, deg * v) == 100
    assert sc.k11_slice(4, 32, 256, v, deg * v - 1) == 256
    assert sc.k11_slice(4, sc.K11_SLICE_MAX_K + 1, 256, v, deg * v) == 256
    assert sc.k11_slice(4, 8, 256, 0, 0) == 256
