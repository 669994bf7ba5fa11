"""The port's edge-tile tables (maxk_tpu_torch/sparse/meta.py) and its host
library (sparse/_native.py, csrc/meta.cpp) against the JAX package's
`maxk_tpu.sparse.meta`, on graphs made with numpy from a seed: a R-MAT
graph, one with empty rows whose node count is not a multiple of R, and
one with no edges; R ∈ {1, 8}, T ∈ {64, 256}, with and without
`elide_empty`.

Every comparison is exact. The reference pads its tables to a multiple of
512 tiles (`TILE_PAD`); the port's are its first NT rows, and the rows
past NT must be inert: value 0, column 0, local row 0, the last real
tile's block."""

import numpy as np
import pytest
import torch

from maxk_tpu.data.synthetic import rmat_graph as jax_rmat_graph
from maxk_tpu.sparse import csr as jcsr
from maxk_tpu.sparse import meta as jmeta
from maxk_tpu_torch.data.synthetic import rmat_graph
from maxk_tpu_torch.sparse import _native
from maxk_tpu_torch.sparse import csr as tcsr
from maxk_tpu_torch.sparse import meta as tmeta

torch.set_num_threads(1)

FIELDS = ("block", "cols", "vals", "localrow")


def _holey(mod):
    """203 nodes (not a multiple of 8) whose edges leave rows 0-9, 50-90 and
    190-202 empty, weights from a seed."""
    rng = np.random.default_rng(3)
    rows = rng.choice(np.r_[10:50, 91:190], 900)
    cols = rng.integers(0, 203, 900)
    vals = rng.standard_normal(900).astype(np.float32)
    return mod.csr_from_coo(rows, cols, 203, values=vals, dedup=False)


GRAPHS = {
    "rmat": lambda: (jcsr.with_norm(jax_rmat_graph(200, 1500, seed=123), "right"),
                     tcsr.with_norm(rmat_graph(200, 1500, seed=123), "right")),
    "empty_rows": lambda: (_holey(jcsr), _holey(tcsr)),
    "no_edges": lambda: (jcsr.csr_from_coo(np.zeros(0, int), np.zeros(0, int), 37),
                         tcsr.csr_from_coo(np.zeros(0, int), np.zeros(0, int), 37)),
}


def _assert_prefix(got, ref):
    """`got`'s tables are `ref`'s first NT rows; `ref`'s rows past them are
    inert."""
    nt = got.num_tiles
    assert (got.row_block, got.num_row_blocks, got.num_nodes, got.edge_tile) == \
        (ref.row_block, ref.num_row_blocks, ref.num_nodes, ref.edge_tile)
    assert 0 < nt <= ref.num_tiles
    for f in FIELDS:
        full = np.asarray(getattr(ref, f))
        t = getattr(got, f)
        assert t.dtype == (torch.float32 if f == "vals" else torch.int32), f
        np.testing.assert_array_equal(t.numpy(), full[:nt], err_msg=f)
        if f == "block":
            assert (full[nt:] == full[nt - 1]).all()
        else:
            assert not full[nt:].any(), f


@pytest.mark.parametrize("elide", [False, True], ids=["dense", "elide"])
@pytest.mark.parametrize("t", [64, 256])
@pytest.mark.parametrize("r", [1, 8])
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_tables_are_the_reference_prefix(graph, r, t, elide):
    """The C++ builder, the numpy builder and the device builder (here on
    the CPU) all give the reference's tables."""
    jg, tg = GRAPHS[graph]()
    ref = jmeta.build_edge_tiles(jg, r, t, elide_empty=elide)
    host = tmeta.build_edge_tiles(tg, r, t, elide_empty=elide)
    numpy = tmeta.build_edge_tiles_numpy(tg, r, t, elide_empty=elide)
    device = tmeta.build_edge_tiles_device(tg, r, t, elide_empty=elide)
    for got in (host, numpy, device):
        _assert_prefix(got, ref)
    for chunk in (3, 16, 256):
        assert tmeta.max_block_span(host.block, chunk) == jmeta.max_block_span(ref.block, chunk) \
            == jmeta.max_block_span(host.block.numpy(), chunk)
    if not elide:  # every block has a tile
        assert torch.equal(host.block.unique(), torch.arange(host.num_row_blocks, dtype=torch.int32))


def test_native_library_builds_into_csrc_build():
    assert _native.available()
    path = _native.library_path()
    assert path.exists() and path.parent == _native.CSRC / "build"
    assert path.name.startswith("libmaxk_meta_") and path.suffix == ".so"


def test_native_equals_numpy_with_an_inert_tail():
    """Past indptr[-1] the arrays may hold an inert tail (the reference's
    device dedup leaves one): both builders ignore it."""
    g = tcsr.with_norm(rmat_graph(300, 4000, seed=9), "both")
    tail = tcsr.CSRGraph(g.indptr, torch.cat([g.indices, torch.zeros(50, dtype=torch.int32)]),
                         torch.cat([g.values, torch.ones(50)]))
    ref = tmeta.build_edge_tiles(g, 8, 128)
    for got in (tmeta.build_edge_tiles(tail, 8, 128),
                tmeta.build_edge_tiles_numpy(tail, 8, 128)):
        for f in FIELDS:
            assert torch.equal(getattr(got, f), getattr(ref, f)), f


def test_csr_transpose_native_matches_scipy():
    g = tcsr.with_norm(rmat_graph(200, 1500, seed=5), "right")
    ip, ix, vl = _native.csr_transpose_native(g.indptr.numpy(), g.indices.numpy(),
                                              g.values.numpy())
    ref = tcsr.csr_transpose(g)
    np.testing.assert_array_equal(ip, ref.indptr.numpy())
    np.testing.assert_array_equal(ix, ref.indices.numpy())
    np.testing.assert_array_equal(vl, ref.values.numpy())
    with pytest.raises(ValueError, match="outside"):
        _native.csr_transpose_native(np.array([0, 1]), np.array([3], np.int32),
                                     np.array([1.0], np.float32))


def test_edge_tiles_to_and_nbytes():
    tiles = tmeta.build_edge_tiles(rmat_graph(64, 300, seed=1), 8, 64)
    moved = tiles.to("cpu")
    assert moved.nbytes == tiles.num_tiles * (4 + 3 * 64 * 4)
    assert (moved.row_block, moved.num_row_blocks, moved.num_nodes) == (8, 8, 64)
