"""The port's edge-tile SpMMs (maxk_tpu_torch/ops/spmm_xla.py) and the tile
modes of its ops, training loop and row-partitioned path, against the JAX
package's on inputs made with numpy from a seed.

Tolerances are normwise, max|got - ref| <= tol · max|ref|: 1e-5 in f32
(the same products summed in another order); 2^-7 in bf16 against the JAX
tile SpMMs (both take exact bf16 products into f32 sums and round once,
so one bf16 ulp); 2e-2 in bf16 against the segment sum, whose products
round to bf16 before the sum. Losses of training steps: 1e-4 relative, as
`test_torch_train`'s."""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from maxk_tpu.data.synthetic import planted_partition_data, rmat_graph as jax_rmat_graph
from maxk_tpu.data.datasets import GraphData as JaxGraphData
from maxk_tpu.ops import spgemm as jsp
from maxk_tpu.ops import spmm_xla as jx
from maxk_tpu.parallel import shard as jshard
from maxk_tpu.parallel.mesh import GRAPH_AXIS, make_mesh
from maxk_tpu.sparse import csr as jcsr
from maxk_tpu.sparse import meta as jmeta
from maxk_tpu.sparse.cbsr import CBSR as JCBSR
from maxk_tpu.sparse.graph import build_graph as jax_build_graph
from maxk_tpu.train import config as jcfg
from maxk_tpu.train.loop import make_train_step as jax_make_train_step, setup as jax_setup
from maxk_tpu_torch.data.datasets import GraphData
from maxk_tpu_torch.data.synthetic import rmat_graph
from maxk_tpu_torch.models.convert import import_flax_params
from maxk_tpu_torch.ops import spgemm as tsp
from maxk_tpu_torch.ops import spmm_xla as tx
from maxk_tpu_torch.ops.dispatch import KernelMode, resolve_mode
from maxk_tpu_torch.parallel import testing
from maxk_tpu_torch.parallel.mesh import run_ranks
from maxk_tpu_torch.parallel.train import sharded_setup
from maxk_tpu_torch.sparse import csr as tcsr
from maxk_tpu_torch.sparse import meta as tmeta
from maxk_tpu_torch.sparse.cbsr import CBSR
from maxk_tpu_torch.sparse.graph import build_graph
from maxk_tpu_torch.train import config as tcfg
from maxk_tpu_torch.train import loop as tloop

torch.set_num_threads(1)

GRAPH = (200, 1500, 123)
D, K = 32, 8
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.fixture(scope="module", params=[(8, 64), (1, 32)], ids=["R8T64", "R1T32"])
def tables(request):
    r, t = request.param
    jg = jcsr.with_norm(jax_rmat_graph(*GRAPH), "right")
    tg = tcsr.with_norm(rmat_graph(*GRAPH), "right")
    return jmeta.build_edge_tiles(jg, r, t), tmeta.build_edge_tiles(tg, r, t), tg


def _x(dtype, seed=0):
    x = np.random.default_rng(seed).standard_normal((GRAPH[0], D)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_tiles_xla_matches_jax_and_segsum(tables, dtype):
    jt, tt, tg = tables
    jxx, txx = _x(dtype)
    y = tx.spmm_tiles_xla(tt, txx)
    assert y.dtype == txx.dtype
    _close(y.float(), jx.spmm_tiles_xla(jt, jxx).astype(jnp.float32),
           1e-5 if dtype == "float32" else 2.0**-7)
    _close(y.float(), tx.spmm_segsum(tg, txx).float(), 1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("accumulate,window", [("matmul", None), ("matmul", "span"),
                                               ("scatter", None)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_tiles_scan_matches_jax_and_segsum(tables, dtype, accumulate, window):
    """Chunks of 16 tiles (several, the last one short), the accumulator
    unseeded and seeded (`acc0`, a seeded call returns f32), the matmul
    window `chunk` or the tables' `max_block_span`."""
    jt, tt, tg = tables
    if window == "span":
        window = tmeta.max_block_span(tt.block, 16)
        assert window == jmeta.max_block_span(jt.block, 16)
    jxx, txx = _x(dtype)
    tol = 1e-5 if dtype == "float32" else 2.0**-7
    kw = dict(chunk=16, accumulate=accumulate, window=window)
    y = tx.spmm_tiles_scan(tt, txx, **kw)
    assert y.dtype == txx.dtype
    _close(y.float(), jx.spmm_tiles_scan(jt, jxx, **kw).astype(jnp.float32), tol)
    _close(y.float(), tx.spmm_segsum(tg, txx).float(), 1e-5 if dtype == "float32" else 2e-2)
    acc0 = np.random.default_rng(1).standard_normal((GRAPH[0], D)).astype(np.float32)
    ys = tx.spmm_tiles_scan(tt, txx, acc0=torch.from_numpy(acc0), **kw)
    assert ys.dtype == torch.float32
    ref = jx.spmm_tiles_scan(jt, jxx, acc0=jnp.asarray(acc0), **kw)
    assert ref.dtype == jnp.float32
    _close(ys, ref, 1e-5)


def test_tile_spmms_equal_the_dense_oracle_in_f64():
    """In f64 every order of the sums agrees to 1e-12: the one-shot tiles,
    the scan at 5 tiles a chunk and at one short chunk, and the segment sum
    all equal `spmm_dense`, which equals the JAX package's in f32."""
    g = tcsr.with_norm(rmat_graph(*GRAPH), "both")
    tiles = tmeta.build_edge_tiles(g, 8, 64)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((GRAPH[0], 6)))
    ref = tx.spmm_dense(g, x)
    for y in (tx.spmm_tiles_xla(tiles, x), tx.spmm_tiles_scan(tiles, x, chunk=5),
              tx.spmm_tiles_scan(tiles, x, chunk=tiles.num_tiles + 3), tx.spmm_segsum(g, x)):
        assert y.dtype == torch.float64
        torch.testing.assert_close(y, ref, rtol=1e-12, atol=1e-12)
    jg = jcsr.with_norm(jax_rmat_graph(*GRAPH), "both")
    _close(ref, jx.spmm_dense(jg, jnp.asarray(x.numpy(), jnp.float32)), 1e-5)


def test_auto_stays_segsum_with_tables():
    for has_tiles in (False, True):
        assert resolve_mode("auto", has_tiles) == KernelMode.SEGSUM
    assert resolve_mode("tiles_scan") == KernelMode.TILES_SCAN
    assert resolve_mode("tiles_xla", True) == KernelMode.TILES_XLA


@pytest.fixture(scope="module", params=["right", "both"])
def graphs(request):
    return (jax_build_graph(jax_rmat_graph(*GRAPH), norm=request.param, build_tiles=True),
            build_graph(rmat_graph(*GRAPH), norm=request.param, build_tiles=True))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["tiles_xla", "tiles_scan"])
def test_spmm_and_maxk_spgemm_match_jax(graphs, mode, bf16):
    """spmm (forward A, backward Aᵀ) and maxk_spgemm (densify, tile SpMM,
    sampled backward), outputs and gradients, against `jax.vjp` of the JAX
    package's ops in the same mode."""
    jg, tg = graphs
    rng = np.random.default_rng(3)
    x = rng.standard_normal((GRAPH[0], D)).astype(np.float32)
    g = rng.standard_normal((GRAPH[0], D)).astype(np.float32)
    sel = np.stack([rng.choice(D, K, replace=False) for _ in range(GRAPH[0])]).astype(np.int32)
    vals = np.take_along_axis(x, sel, 1)
    jdt, tdt = DTYPES["bfloat16" if bf16 else "float32"]
    tol = 2.0**-7 if bf16 else 1e-5

    y_ref, vjp = jax.vjp(lambda a: jsp.spmm(jg, a, mode=mode), jnp.asarray(x, jdt))
    (dx_ref,) = vjp(jnp.asarray(g, jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    y = tsp.spmm(tg, xt, mode=mode)
    y.backward(torch.from_numpy(g).to(tdt))
    _close(y.detach().float(), y_ref.astype(jnp.float32), tol)
    _close(xt.grad.float(), dx_ref.astype(jnp.float32), tol)

    cdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    my_ref, mvjp = jax.vjp(lambda a: jsp.maxk_spgemm(jg, JCBSR(a, jnp.asarray(sel)), dim=D,
                                                     mode=mode, compute_dtype=cdt[0]),
                           jnp.asarray(vals))
    (dv_ref,) = mvjp(jnp.asarray(g))
    vt = torch.from_numpy(vals).requires_grad_(True)
    my = tsp.maxk_spgemm(tg, CBSR(vt, torch.from_numpy(sel)), dim=D, mode=mode,
                         compute_dtype=cdt[1])
    my.backward(torch.from_numpy(g))
    assert my.dtype == torch.float32 and vt.grad.dtype == torch.float32
    # bf16 compute: the output and the sampled gradient round to bf16 once
    _close(my.detach(), my_ref, tol)
    _close(vt.grad, dv_ref, tol)


# ---------------------------------------------------------------------------
# the row-partitioned tile path on 2 gloo ranks
# ---------------------------------------------------------------------------


def _jax_sharded_tiles(n, x, ct, vals, sel):
    """JAX's sharded spmm and maxk_spgemm (forward and VJP) over its stacked
    tile tables (its sharded ops take the tiles whenever they exist)."""
    sg = jshard.build_sharded_graph(jax_rmat_graph(*GRAPH), n, norm="right", build_tiles=True)

    def f(g, xx, cc, va, se):
        y, vjp = jax.vjp(lambda a: jsp.spmm(g, a, mode="tiles_scan"), xx)
        my, mvjp = jax.vjp(lambda a: jsp.maxk_spgemm(g, JCBSR(a, se), dim=D, mode="tiles_scan"),
                           va)
        return y, vjp(cc)[0], my, mvjp(cc)[0]

    mesh = make_mesh(devices=jax.devices()[:n])
    spec = P(GRAPH_AXIS)
    fn = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(spec,) * 5, out_specs=(spec,) * 4,
                               check_vma=False))
    outs = fn(sg, *(jnp.asarray(jshard.shard_rows(a, n)) for a in (x, ct, vals, sel)))
    return [np.asarray(a)[:GRAPH[0]] for a in outs]


def test_sharded_tiles_on_two_ranks_match_jax_and_single_device(tmp_path):
    n, v = 2, GRAPH[0]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((v, D)).astype(np.float32)
    ct = rng.standard_normal((v, D)).astype(np.float32)
    sel = np.stack([rng.choice(D, K, replace=False) for _ in range(v)]).astype(np.int32)
    vals = np.take_along_axis(x, sel, 1)
    with ThreadPoolExecutor(1) as pool:  # the ranks run while JAX compiles
        ranks = pool.submit(run_ranks, testing.ops_case, n,
                            (GRAPH, "right", x, ct, vals, sel, x, "tiles_scan"),
                            device_type="cpu", init_method=f"file://{tmp_path}/rendezvous",
                            timeout=150)
        ref = _jax_sharded_tiles(n, x, ct, vals, sel)
        results = ranks.result()
    g = build_graph(rmat_graph(*GRAPH), norm="right")
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tsp.spmm(g, xt)
    y.backward(torch.from_numpy(ct))
    vt = torch.from_numpy(vals).requires_grad_(True)
    my = tsp.maxk_spgemm(g, CBSR(vt, torch.from_numpy(sel)), dim=D)
    my.backward(torch.from_numpy(ct))
    single = [y.detach(), xt.grad, my.detach(), vt.grad]
    for i, key in enumerate(("spmm_y", "spmm_dx", "maxk_y", "maxk_dvals")):
        got = np.concatenate([r[key] for r in results])[:v]
        _close(got, ref[i], 1e-5)
        _close(got, single[i].numpy(), 1e-5)


def test_sharded_setup_builds_tiles_for_the_tile_modes_only():
    """Sharded AUTO runs segsum (no tables), unlike the reference's, whose
    sharded AUTO builds and runs the tiles (ROADMAP C)."""
    mesh = type("M", (), {"world_size": 2, "rank": 1, "device": torch.device("cpu")})()
    data = testing.tiny_data()
    auto = sharded_setup(tcfg.TrainConfig(dataset="tiny", device="cpu"), data, mesh)
    assert auto.graph.fwd_tiles is None and auto.graph.bwd_tiles is None
    tiled = sharded_setup(tcfg.TrainConfig(dataset="tiny", device="cpu", kernel_mode="tiles_xla",
                                           row_block=4, edge_tile=32), data, mesh)
    assert tiled.graph.fwd_tiles.row_block == 4 and tiled.graph.bwd_tiles.edge_tile == 32
    assert tiled.graph.fwd_tiles.num_nodes == auto.graph.shard_nodes


# ---------------------------------------------------------------------------
# training under tiles_scan
# ---------------------------------------------------------------------------


def _data():
    jcsr_ = jax_rmat_graph(200, 1500, seed=7)
    feats, labels, masks = planted_partition_data(jcsr_, 32, 5, seed=7)
    common = dict(name="tiny", features=feats, labels=labels, train_mask=masks[0],
                  val_mask=masks[1], test_mask=masks[2], num_classes=5, multilabel=False)
    return JaxGraphData(csr=jcsr_, **common), GraphData(csr=rmat_graph(200, 1500, seed=7), **common)


def test_three_steps_under_tiles_scan_match_jax():
    """3 Adam steps of MaxK-SAGE under `--kernel_mode tiles_scan` from the
    JAX package's parameters, dropout 0: the losses at 1e-4 relative."""
    jdata, tdata = _data()
    args = dict(hidden_dim=32, hidden_layers=2, maxk=4, dropout=0.0, lr=0.01,
                kernel_mode="tiles_scan", row_block=8, edge_tile=64)
    jstate = jax_setup(jcfg.TrainConfig(**args), jdata)
    assert jstate.graph.tiles is not None
    jstep = jax_make_train_step(jstate.model, jstate.tx, False)
    tstate = tloop.setup(tcfg.TrainConfig(device="cpu", **args), tdata)
    assert (tstate.graph.tiles.row_block, tstate.graph.tiles.edge_tile) == (8, 64)
    tstate.model.load_state_dict(
        import_flax_params(jax.tree.map(np.asarray, jstate.variables["params"])), strict=True)
    tstep = tloop.make_train_step(tstate.model, tstate.optimizer, False)
    feats, labels, masks = tloop._device_arrays(tdata, torch.device("cpu"))
    variables, opt_state = jstate.variables, jstate.opt_state
    for _ in range(3):
        variables, opt_state, jloss, _ = jstep(
            variables, opt_state, jstate.rng, jstate.graph, jnp.asarray(jdata.features),
            jnp.asarray(jdata.labels), jnp.asarray(jdata.train_mask))
        tloss, _ = tstep(tstate.graph, feats, labels, masks[0], tstate.generator)
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-4)


def test_cli_trains_under_tiles_scan_with_its_flags(tmp_path):
    """`python -m maxk_tpu_torch --kernel_mode tiles_scan --row_block 4
    --edge_tile 64` on the CPU: the tables take the flags, and the losses
    equal the segsum run's at 1e-5 relative (the same masks, the sums in
    another order)."""
    from maxk_tpu_torch.__main__ import main

    argv = ["--device", "cpu", "--dataset", "flickr", "--data_scale", "0.002", "--epochs", "3",
            "--hidden_dim", "32", "--hidden_layers", "2", "--maxk", "8", "--path", str(tmp_path)]
    tiled = main(argv + ["--kernel_mode", "tiles_scan", "--row_block", "4", "--edge_tile", "64"])
    assert (tiled.graph.tiles.row_block, tiled.graph.tiles.edge_tile) == (4, 64)
    plain = main(argv + ["--kernel_mode", "segsum"])
    assert plain.graph.tiles is None
    np.testing.assert_allclose(tiled.losses, plain.losses, rtol=1e-5)
