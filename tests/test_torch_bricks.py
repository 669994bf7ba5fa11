"""The port's brick schedule (sparse/bricks.py) and brick SpMM plain version
(ops/spmm_bricks.py) against the JAX package's.

The schedule arrays must be bit-equal to `maxk_tpu.sparse.bricks.build_bricks`
on the same numpy graph. `spmm_bricks_plain`, on the JAX schedule imported
through `schedule_from_numpy`, is held against the Pallas kernel run in
interpret mode: 1e-5 in f32 (sums in another order), 2^-7 relative in bf16
(the output rounds to bf16 once; the sums may round to neighbouring
values)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxk_tpu.ops.spmm_bricks import spmm_bricks as jax_spmm_bricks
from maxk_tpu.sparse import bricks as jb
from maxk_tpu.sparse.csr import CSRGraph as JCSRGraph
from maxk_tpu_torch.ops.spmm_bricks import spmm_bricks, spmm_bricks_plain
from maxk_tpu_torch.ops.spmm_xla import spmm_segsum
from maxk_tpu_torch.sparse import bricks as tb
from maxk_tpu_torch.sparse.csr import CSRGraph

torch.set_num_threads(1)

# tests/test_bricks.py's dims, and a set whose rb (3 bits) and win (6 bits)
# fields reach their top values
DIMS = {
    "small": dict(sg=32, panel=64, wb=16, win=32, t=16, ch=4),
    "full_fields": dict(sg=64, panel=256, wb=8, win=4, t=8, ch=2),
}
ARRAYS = ("chunk_panel", "chunk_sgroup", "meta", "idx", "val")


def _graph(v=200, e=1500, seed=3, empty_tail=False, duplicates=0):
    """Random (rows, cols, vals) in CSR order; `duplicates` repeats that many
    edges; empty_tail leaves the upper half of the rows empty."""
    rng = np.random.default_rng(seed)
    hi = v // 2 if empty_tail else v
    rows = rng.integers(0, hi, e)
    cols = rng.integers(0, v, e)
    if duplicates:
        pick = rng.integers(0, e, duplicates)
        rows, cols = np.concatenate([rows, rows[pick]]), np.concatenate([cols, cols[pick]])
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    indptr = np.zeros(v + 1, np.int32)
    np.add.at(indptr[1:], rows, 1)
    return np.cumsum(indptr).astype(np.int32), cols.astype(np.int32), vals


def _both(indptr, cols, vals):
    return (
        JCSRGraph(indptr=jnp.asarray(indptr), indices=jnp.asarray(cols), values=jnp.asarray(vals)),
        CSRGraph(indptr=torch.from_numpy(indptr), indices=torch.from_numpy(cols),
                 values=torch.from_numpy(vals)),
    )


def _import(js):
    return tb.schedule_from_numpy(
        *(np.asarray(getattr(js, a)) for a in ARRAYS), num_nodes=js.num_nodes,
        num_cols=js.num_cols, sg=js.sg, panel=js.panel, wb=js.wb, win=js.win,
    )


GRAPHS = {
    "random": dict(),
    "empty_tail": dict(empty_tail=True),
    "duplicates": dict(duplicates=300, seed=5),
    "wide": dict(v=700, e=6000, seed=7),
}


@pytest.mark.parametrize("dims", DIMS)
@pytest.mark.parametrize("graph", GRAPHS)
def test_build_bricks_bit_equal(dims, graph):
    jg, tg = _both(*_graph(**GRAPHS[graph]))
    ref = jb.build_bricks(jg, **DIMS[dims])
    got = tb.build_bricks(tg, **DIMS[dims])
    for a in ARRAYS:
        r, g = np.asarray(getattr(ref, a)), getattr(got, a).numpy()
        assert g.dtype == r.dtype and g.shape == r.shape, a
        assert np.array_equal(g.view(np.int32), r.view(np.int32)), a
    for a in ("num_nodes", "num_cols", "sg", "panel", "wb", "win", "num_chunks", "ch",
              "slots", "num_sgroups", "num_panels"):
        assert getattr(got, a) == getattr(ref, a), a
    assert tb.bricks_stats(got) == jb.bricks_stats(ref)


def test_full_fields_reach_the_top_bits():
    _, tg = _both(*_graph(**GRAPHS["wide"]))
    meta = tb.build_bricks(tg, **DIMS["full_fields"]).meta
    assert int(((meta >> 6) & 7).max()) == 7 and int((meta & 0x3F).max()) == 63


@pytest.mark.parametrize("dims", DIMS)
@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_interpret_kernel(dims, graph, dtype):
    jg, _ = _both(*_graph(**GRAPHS[graph]))
    js = jb.build_bricks(jg, **DIMS[dims])
    x = np.random.default_rng(1).standard_normal((jg.num_nodes, 48)).astype(np.float32)
    ref = np.asarray(jax_spmm_bricks(js, jnp.asarray(x, getattr(jnp, dtype)), interpret=True),
                     np.float32)
    got = spmm_bricks_plain(_import(js), torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and got.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=2.0**-7, atol=1e-6)


def test_plain_against_segment_sum():
    """The plain version on the port's own schedule is the CSR product."""
    _, tg = _both(*_graph(**GRAPHS["duplicates"]))
    x = torch.randn((tg.num_nodes, 32), generator=torch.Generator().manual_seed(2))
    got = spmm_bricks(tb.build_bricks(tg, **DIMS["small"]), x)  # the CPU dispatch
    torch.testing.assert_close(got, spmm_segsum(tg, x), rtol=1e-5, atol=1e-5)


def test_empty_supergroups_come_out_zero():
    _, tg = _both(*_graph(**GRAPHS["empty_tail"]))
    sched = tb.build_bricks(tg, **DIMS["small"])
    y = spmm_bricks_plain(sched, torch.ones((tg.num_nodes, 8)))
    assert torch.equal(y[100:], torch.zeros((100, 8)))


def test_a_brick_that_ends_twice_flushes_all_it_holds():
    """Kernel semantics on a hand-made stream: one brick, `first` in subtile
    0, `end` in subtiles 1 and 2; the second flush adds everything again."""
    ch, t = 3, 8
    meta = np.array([[[1 << 9, 1 << 10, 1 << 10]]], np.int32)  # win 0, rb 0
    idx = np.zeros((1, ch, t), np.int32)
    val = np.zeros((1, ch, t), np.float32)
    idx[0, 0, 0], val[0, 0, 0] = (1 << 7) | 2, 2.0  # A[1, 2] += 2
    idx[0, 2, 0], val[0, 2, 0] = (0 << 7) | 0, 5.0  # A[0, 0] += 5, then flush again
    sched = tb.schedule_from_numpy([0], [0], meta, idx, val, num_nodes=4, num_cols=4,
                                   sg=8, panel=8, wb=8, win=8)
    x = torch.arange(16, dtype=torch.float32).view(4, 4)
    y = spmm_bricks_plain(sched, x)
    expect = torch.zeros((4, 4))
    expect[1] = 2 * 2 * x[2]  # flushed twice
    expect[0] = 5 * x[0]
    assert torch.equal(y, expect)


@pytest.mark.parametrize("bad", [dict(sg=24, wb=16), dict(sg=256, wb=16), dict(panel=128, win=1),
                                 dict(wb=1024, sg=1024), dict(t=12)])
def test_bad_dims_raise(bad):
    dims = dict(DIMS["small"], **bad)
    _, tg = _both(*_graph())
    with pytest.raises(ValueError, match="bricks:"):
        tb.build_bricks(tg, **dims)
