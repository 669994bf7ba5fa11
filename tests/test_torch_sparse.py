"""maxk_tpu_torch.sparse against maxk_tpu.sparse: indices exact, values
at 1e-6 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxk_tpu.data.synthetic import rmat_graph as jax_rmat_graph
from maxk_tpu.sparse import csr as jcsr
from maxk_tpu.sparse.graph import build_graph as jax_build_graph
from maxk_tpu_torch.data.synthetic import rmat_graph
from maxk_tpu_torch.sparse import csr as tcsr
from maxk_tpu_torch.sparse.graph import build_graph

torch.set_num_threads(1)


def _assert_csr_close(j, t):
    np.testing.assert_array_equal(np.asarray(j.indptr), t.indptr.numpy())
    np.testing.assert_array_equal(np.asarray(j.indices), t.indices.numpy())
    np.testing.assert_allclose(t.values.numpy(), np.asarray(j.values), rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def graphs():
    return jax_rmat_graph(200, 1500, seed=123), rmat_graph(200, 1500, seed=123)


def test_csr_from_coo_dedups_and_sorts():
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 50, 400)
    cols = rng.integers(0, 50, 400)
    _assert_csr_close(jcsr.csr_from_coo(rows, cols, 50), tcsr.csr_from_coo(rows, cols, 50))
    vals = rng.standard_normal(400).astype(np.float32)
    _assert_csr_close(
        jcsr.csr_from_coo(rows, cols, 50, values=vals, dedup=False),
        tcsr.csr_from_coo(rows, cols, 50, values=vals, dedup=False),
    )


def test_row_ids(graphs):
    j, t = graphs
    np.testing.assert_array_equal(t.row_ids().numpy(), np.asarray(j.row_ids()))
    assert t.row_ids().dtype == torch.int32
    np.testing.assert_array_equal(t.in_degrees().numpy(), np.asarray(j.in_degrees()))


@pytest.mark.parametrize("mode", ["none", "right", "left", "both"])
def test_with_norm(graphs, mode):
    j, t = graphs
    _assert_csr_close(jcsr.with_norm(j, mode), tcsr.with_norm(t, mode))


def test_with_norm_counts_live_edges_only(graphs):
    """Weight-0 entries must not inflate degrees (csr.py:184-195)."""
    j, t = graphs
    vals = np.asarray(j.values).copy()
    vals[::5] = 0.0
    j0 = j.replace(values=jnp.asarray(vals))
    t0 = tcsr.CSRGraph(t.indptr, t.indices, torch.from_numpy(vals))
    for mode in ("right", "left", "both"):
        _assert_csr_close(jcsr.with_norm(j0, mode), tcsr.with_norm(t0, mode))


def test_unknown_norm_raises(graphs):
    with pytest.raises(ValueError, match="unknown norm mode"):
        tcsr.with_norm(graphs[1], "sideways")


@pytest.mark.parametrize("mode", ["none", "right"])
def test_csr_transpose(graphs, mode):
    j, t = graphs
    _assert_csr_close(
        jcsr.csr_transpose(jcsr.with_norm(j, mode)),
        tcsr.csr_transpose(tcsr.with_norm(t, mode)),
    )


def test_add_self_loops():
    rng = np.random.default_rng(2)
    rows, cols = rng.integers(0, 40, 200), rng.integers(0, 40, 200)
    j = jcsr.csr_from_coo(rows, cols, 40)
    t = tcsr.csr_from_coo(rows, cols, 40)
    _assert_csr_close(jcsr.add_self_loops(j), tcsr.add_self_loops(t))


@pytest.mark.parametrize("norm", ["none", "right", "left", "both"])
def test_build_graph_symmetry_detection(graphs, norm):
    j, t = graphs
    jg = jax_build_graph(j, norm=norm, build_tiles=False)
    tg = build_graph(t, norm=norm)
    assert (tg.csc is tg.csr) == (jg.csc is jg.csr)
    assert (tg.csc is tg.csr) == (norm in ("none", "both"))
    _assert_csr_close(jg.csr, tg.csr)
    _assert_csr_close(jg.csc, tg.csc)


def test_build_graph_directed_is_not_symmetric():
    rows = np.array([0, 1, 2, 2])
    cols = np.array([1, 2, 0, 1])
    j = jcsr.csr_from_coo(rows, cols, 3)
    t = tcsr.csr_from_coo(rows, cols, 3)
    jg = jax_build_graph(j, norm="none", build_tiles=False)
    tg = build_graph(t, norm="none")
    assert tg.csc is not tg.csr and jg.csc is not jg.csr
    _assert_csr_close(jg.csc, tg.csc)


def test_build_graph_unported_schedules_raise(graphs):
    """build_graph(hybrid=True) builds the strip schedule in permuted node
    space (`tests/test_torch_hybrid.py` holds it to the JAX package's)."""
    jg = jax_build_graph(graphs[0], norm="right", build_tiles=False, hybrid=True)
    tg = build_graph(graphs[1], norm="right", hybrid=True)
    np.testing.assert_array_equal(tg.perm, np.asarray(jg.perm))
    assert tg.hybrid.s_cols == jg.hybrid.s_cols and tg.hybrid.num_nodes == 200
    _assert_csr_close(jg.csr, tg.csr)


@pytest.mark.parametrize("norm", ["right", "both"])
@pytest.mark.parametrize("device_builder", [False, True])
def test_build_graph_tiles_match_jax(graphs, norm, device_builder):
    """build_graph(build_tiles=True): the tables of A and Aᵀ are the JAX
    package's first NT rows, bit for bit (its tables carry TILE_PAD
    padding); a symmetric graph shares them. Without build_tiles, none."""
    j, t = graphs
    jg = jax_build_graph(j, norm=norm, build_tiles=True, row_block=8, edge_tile=64)
    tg = build_graph(t, norm=norm, build_tiles=True, row_block=8, edge_tile=64,
                     device_builder=device_builder)
    assert (tg.tiles_t is tg.tiles) == (tg.csc is tg.csr) == (norm == "both")
    for jt, tt in ((jg.tiles, tg.tiles), (jg.tiles_t, tg.tiles_t)):
        nt = tt.num_tiles
        assert (tt.row_block, tt.num_row_blocks, tt.num_nodes, tt.edge_tile) == \
            (jt.row_block, jt.num_row_blocks, jt.num_nodes, jt.edge_tile)
        for f in ("block", "cols", "vals", "localrow"):
            np.testing.assert_array_equal(getattr(tt, f).numpy(), np.asarray(getattr(jt, f))[:nt])
    assert build_graph(t, norm=norm).tiles is None


def _isolated_directed():
    """A directed graph over 60 nodes whose edges touch only the first 40."""
    rng = np.random.default_rng(11)
    rows, cols = rng.integers(0, 40, 300), rng.integers(0, 40, 300)
    return jcsr.csr_from_coo(rows, cols, 60), tcsr.csr_from_coo(rows, cols, 60)


A2_CASES = {
    "rmat200": lambda: (jax_rmat_graph(200, 1500, seed=123), rmat_graph(200, 1500, seed=123)),
    "rmat500": lambda: (jax_rmat_graph(500, 4000, seed=1), rmat_graph(500, 4000, seed=1)),
    "rmat64": lambda: (jax_rmat_graph(64, 300, seed=7), rmat_graph(64, 300, seed=7)),
    "isolated": _isolated_directed,
}


@pytest.mark.parametrize("case", list(A2_CASES))
def test_symmetrize_matches_jax(case):
    j, t = A2_CASES[case]()
    js, ts = jcsr.symmetrize(j), tcsr.symmetrize(t)
    _assert_csr_close(js, ts)
    m = tcsr.csr_to_scipy(ts)
    assert (m != m.T).nnz == 0  # undirected


@pytest.mark.parametrize("case", list(A2_CASES))
def test_reorder_rcm_matches_jax(case):
    """The same permutation and the same reordered CSR, exactly; the
    right-normalized values move with their edges."""
    j, t = A2_CASES[case]()
    j, t = jcsr.with_norm(jcsr.symmetrize(j), "right"), tcsr.with_norm(tcsr.symmetrize(t), "right")
    (jg, jperm), (tg, tperm) = jcsr.reorder_rcm(j), tcsr.reorder_rcm(t)
    np.testing.assert_array_equal(tperm, np.asarray(jperm))
    np.testing.assert_array_equal(np.sort(tperm), np.arange(t.num_nodes))
    np.testing.assert_array_equal(np.asarray(jg.indptr), tg.indptr.numpy())
    np.testing.assert_array_equal(np.asarray(jg.indices), tg.indices.numpy())
    np.testing.assert_array_equal(np.asarray(jg.values), tg.values.numpy())
    assert tg.indptr.dtype == torch.int32 and tg.values.dtype == torch.float32
