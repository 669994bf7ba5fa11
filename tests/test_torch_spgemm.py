"""The port's spmm and maxk_spgemm (ops/spgemm.py) against the JAX package's,
forward and gradients (`jax.vjp`), on rmat_graph(200, 1500).

Tolerances are normwise, max|got - ref| <= tol · max|ref|: 1e-5 in f32
(sums in another order), 2e-2 with bf16 compute (the reference's one-shot
segsum sums in bf16, the port in f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxk_tpu.data.synthetic import rmat_graph as jax_rmat_graph
from maxk_tpu.ops import spgemm as jsp
from maxk_tpu.sparse.cbsr import CBSR as JCBSR
from maxk_tpu.sparse.graph import build_graph as jax_build_graph
from maxk_tpu_torch.data.synthetic import rmat_graph
from maxk_tpu_torch.ops import spgemm as tsp
from maxk_tpu_torch.ops.spmm_xla import spmm_segsum
from maxk_tpu_torch.sparse.cbsr import CBSR
from maxk_tpu_torch.sparse.graph import Graph, build_graph
from maxk_tpu_torch.sparse.meta import build_edge_tiles

torch.set_num_threads(1)

D, K = 64, 8


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.fixture(scope="module", params=["right", "both"])
def graphs(request):
    norm = request.param
    return (
        jax_build_graph(jax_rmat_graph(200, 1500, seed=123), norm=norm, build_tiles=False),
        build_graph(rmat_graph(200, 1500, seed=123), norm=norm),
    )


@pytest.mark.parametrize("bf16", [False, True])
def test_spmm_forward_and_grad(graphs, bf16):
    jg, tg = graphs
    rng = np.random.default_rng(1)
    x = rng.standard_normal((jg.num_nodes, D)).astype(np.float32)
    g = rng.standard_normal((jg.num_nodes, D)).astype(np.float32)
    jdt, tdt, tol = (jnp.bfloat16, torch.bfloat16, 2e-2) if bf16 else (jnp.float32, torch.float32, 1e-5)
    y_ref, vjp = jax.vjp(lambda a: jsp.spmm(jg, a, mode="segsum"), jnp.asarray(x, jdt))
    (dx_ref,) = vjp(jnp.asarray(g, jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    y = tsp.spmm(tg, xt)
    y.backward(torch.from_numpy(g).to(tdt))
    assert y.dtype == tdt and xt.grad.dtype == tdt
    _close(y.detach().float(), y_ref, tol)
    _close(xt.grad.float(), dx_ref, tol)


@pytest.mark.parametrize("bf16", [False, True])
def test_maxk_spgemm_forward_and_grad(graphs, bf16):
    jg, tg = graphs
    rng = np.random.default_rng(2)
    x = rng.standard_normal((jg.num_nodes, D)).astype(np.float32)
    g = rng.standard_normal((jg.num_nodes, D)).astype(np.float32)
    sel = np.stack([rng.choice(D, K, replace=False) for _ in range(jg.num_nodes)]).astype(np.int32)
    vals = np.take_along_axis(x, sel, 1)
    jdt, tdt, tol = (jnp.bfloat16, torch.bfloat16, 2e-2) if bf16 else (None, None, 1e-5)

    def f(v):
        return jsp.maxk_spgemm(jg, JCBSR(v, jnp.asarray(sel)), dim=D, mode="segsum", compute_dtype=jdt)

    y_ref, vjp = jax.vjp(f, jnp.asarray(vals))
    (dv_ref,) = vjp(jnp.asarray(g))
    vt = torch.from_numpy(vals).requires_grad_(True)
    y = tsp.maxk_spgemm(tg, CBSR(vt, torch.from_numpy(sel)), dim=D, compute_dtype=tdt)
    y.backward(torch.from_numpy(g))
    assert y.dtype == torch.float32 and vt.grad.dtype == torch.float32
    _close(y.detach(), y_ref, tol)
    _close(vt.grad, dv_ref, tol)


def test_gradcheck_f64(graphs):
    _, tg = graphs
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((tg.num_nodes, 4), dtype=torch.float64, generator=gen, requires_grad=True)
    assert torch.autograd.gradcheck(lambda a: tsp.spmm(tg, a), (x,))
    sel = torch.randint(0, 16, (tg.num_nodes, 3), generator=gen, dtype=torch.int32)
    vals = torch.randn((tg.num_nodes, 3), dtype=torch.float64, generator=gen, requires_grad=True)
    assert torch.autograd.gradcheck(lambda v: tsp.maxk_spgemm(tg, CBSR(v, sel), dim=16), (vals,))


def test_edge_chunks_do_not_change_the_sum(graphs):
    """Chunking is the role of spmm_segsum_scan: it bounds memory only."""
    _, tg = graphs
    x = torch.randn((tg.num_nodes, D), generator=torch.Generator().manual_seed(4))
    ref = spmm_segsum(tg.csr, x.double(), edge_chunk=tg.nnz)
    for chunk in (1, 97, 1 << 10):
        torch.testing.assert_close(spmm_segsum(tg.csr, x.double(), edge_chunk=chunk), ref)


@pytest.mark.parametrize("mode", ["hybrid", "hybrid_int8", "pallas"])
def test_unported_modes_raise(graphs, mode):
    _, tg = graphs
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsp.spmm(tg, torch.zeros((tg.num_nodes, 4)), mode=mode)


@pytest.mark.parametrize("mode", ["tiles_xla", "tiles_scan"])
def test_tile_modes_run_over_the_tables(graphs, mode):
    """The tile modes need the graph's tile tables (a graph built without
    them raises, naming build_tiles); with them, spmm and its gradient equal
    segsum's to 1e-5 normwise (f32 sums in another order)."""
    _, tg = graphs
    with pytest.raises(ValueError, match="build_tiles=True"):
        tsp.spmm(tg, torch.zeros((tg.num_nodes, 4)), mode=mode)
    tiled = Graph(csr=tg.csr, csc=tg.csc, tiles=build_edge_tiles(tg.csr),
                  tiles_t=build_edge_tiles(tg.csc))
    x = torch.randn((tg.num_nodes, D), generator=torch.Generator().manual_seed(5))
    g = torch.randn((tg.num_nodes, D), generator=torch.Generator().manual_seed(6))
    grads = []
    for graph, m in ((tg, "segsum"), (tiled, mode)):
        xr = x.clone().requires_grad_(True)
        y = tsp.spmm(graph, xr, mode=m)
        y.backward(g)
        grads.append((y.detach(), xr.grad))
    _close(grads[1][0], grads[0][0], 1e-5)
    _close(grads[1][1], grads[0][1], 1e-5)
