"""The port's row-partitioned path (maxk_tpu_torch/parallel/) against the JAX
package's on the 8-device virtual CPU mesh, with gloo ranks spawned on the
CPU in the role of the mesh's devices:

- the host-built blocks equal JAX's stacked arrays on their live part, and
  `shard_rows` and `halo_stats` give the same results;
- sharded spmm and maxk_spgemm, forward and gradient, and the compact
  aggregation of post-dropout features, at n = 2 and 4, against JAX's
  sharded ops and the port's single-device ops; the receive bytes the
  collectives count equal the port's `audit.model_recv_bytes_fwd_bwd`,
  whose `maxk` arm reduce-scatters (Vp, k) sampled partials where the
  reference's reduce-scatters (Vp, D), once a call, and whose gradient
  equals the reference's order (reduce-scatter, then sample) bit for bit;
- 3 steps of sharded MaxK-SAGE at n = 2 from imported flax parameters
  against `make_sharded_train_step`; parameters equal on every rank; GCN
  and GIN losses fall;
- `python -m maxk_tpu_torch --mesh_shape 2` on CPU ranks, and its refusal
  to run on GPUs that are not there.

Float tolerances are normwise, max|got - ref| <= tol · max|ref|, tol 1e-5:
f32 sums in another order. Every spawn runs under a deadline.
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from maxk_tpu.data.synthetic import rmat_graph as jax_rmat_graph
from maxk_tpu.models.layers import _AggMixin
from maxk_tpu.ops import spgemm as jsp
from maxk_tpu.parallel import shard as jshard
from maxk_tpu.parallel import train as jtrain
from maxk_tpu.parallel.mesh import GRAPH_AXIS, make_mesh
from maxk_tpu.sparse.cbsr import CBSR as JCBSR
from maxk_tpu.train.config import TrainConfig as JaxTrainConfig
from maxk_tpu_torch.data.synthetic import rmat_graph
from maxk_tpu_torch.models.convert import import_flax_params
from maxk_tpu_torch.ops import spgemm as tsp
from maxk_tpu_torch.parallel import shard as tshard
from maxk_tpu_torch.parallel import testing
from maxk_tpu_torch.parallel.audit import model_recv_bytes_fwd_bwd
from maxk_tpu_torch.parallel.mesh import run_ranks
from maxk_tpu_torch.sparse.cbsr import CBSR
from maxk_tpu_torch.sparse.graph import build_graph

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
GRAPH = (200, 1500, 123)  # rmat_graph(V, E, seed): the JAX tests' small_graph
D, K = 32, 8
DEADLINE = 150  # seconds for one spawned run


def _close(got, ref, tol=1e-5):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def _spawn(tmp_dir, fn, n, *args):
    init = f"file://{tmp_dir}/rendezvous_{fn.__name__}_{n}"
    return run_ranks(fn, n, args, device_type="cpu", init_method=init, timeout=DEADLINE)


def _jax_sharded(n, sgraph, fn, *arrays, outs=1):
    mesh = make_mesh(devices=jax.devices()[:n])
    spec = P(GRAPH_AXIS)
    f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(spec,) * (1 + len(arrays)),
                              out_specs=spec if outs == 1 else (spec,) * outs, check_vma=False))
    return f(sgraph, *(jnp.asarray(jshard.shard_rows(a, n)) for a in arrays))


# ---------------------------------------------------------------------------
# host-side blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm", ["right", "both", "none"])
@pytest.mark.parametrize("n", [2, 4])
def test_blocks_match_jax_stacked_arrays(n, norm):
    ref = jshard.build_sharded_graph(jax_rmat_graph(*GRAPH), n, norm=norm)
    blocks = tshard.shard_blocks(rmat_graph(*GRAPH), n, norm=norm)
    assert len(blocks) == n
    for i, (fwd, bwd) in enumerate(blocks):
        for got, pre in ((fwd, "fwd"), (bwd, "bwd")):
            indptr = np.asarray(getattr(ref, f"{pre}_indptr")[i])
            live = int(indptr[-1])
            np.testing.assert_array_equal(got.indptr.numpy(), indptr)
            np.testing.assert_array_equal(got.indices.numpy(),
                                          np.asarray(getattr(ref, f"{pre}_indices")[i])[:live])
            np.testing.assert_array_equal(got.values.numpy(),
                                          np.asarray(getattr(ref, f"{pre}_values")[i])[:live])
        assert fwd.num_nodes == ref.shard_nodes and bwd.num_nodes == ref.padded_nodes


def test_shard_rows_and_halo_stats_match_jax():
    x = np.random.default_rng(0).standard_normal((201, 3)).astype(np.float32)
    for n in (1, 2, 4, 8):
        np.testing.assert_array_equal(tshard.shard_rows(x, n), jshard.shard_rows(x, n))
        m = x[:, 0] > 0
        np.testing.assert_array_equal(tshard.shard_rows(m, n, fill=False),
                                      jshard.shard_rows(m, n, fill=False))
    for n, s_cols in ((2, 0), (4, 32)):
        assert tshard.halo_stats(rmat_graph(*GRAPH), n, k=16, s_cols=s_cols) == \
            jshard.halo_stats(jax_rmat_graph(*GRAPH), n, k=16, s_cols=s_cols)


def _fake_mesh(n, rank=0):
    return type("M", (), {"world_size": n, "rank": rank, "device": torch.device("cpu")})()


def test_unported_schedules_raise():
    """build_sharded_graph(hybrid=True) builds the rank's part of the strip
    schedule beside its blocks (`tests/test_torch_hybrid_shard.py` holds it
    to the JAX package's)."""
    from maxk_tpu_torch.sparse.hybrid import degree_perm, permute_csr

    csr = rmat_graph(*GRAPH)
    g = tshard.build_sharded_graph(permute_csr(csr, degree_perm(csr)), _fake_mesh(2, 1),
                                   hybrid=True)
    assert g.hybrid.rank == 1 and g.hybrid.strip.shape == (100, 128)
    assert g.fwd.num_nodes == 100


@pytest.mark.parametrize("norm", ["right", "none"])
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_tiles_are_the_jax_shard_prefix(n, norm):
    """build_sharded_graph(build_tiles=True): each rank's forward (Vs rows)
    and backward (Vp rows) tables equal the first NT rows of the JAX
    package's stacked tables for that shard, bit for bit; the rows past NT,
    its padding to TILE_PAD and to the largest shard, are inert (value 0,
    column 0, local row 0, the last real tile's block)."""
    ref = jshard.build_sharded_graph(jax_rmat_graph(*GRAPH), n, norm=norm, build_tiles=True,
                                     row_block=8, edge_tile=64)
    for r in range(n):
        got = tshard.build_sharded_graph(rmat_graph(*GRAPH), _fake_mesh(n, r), norm=norm,
                                         build_tiles=True, row_block=8, edge_tile=64)
        for tt, stacked, rows in ((got.fwd_tiles, ref.fwd_tiles, ref.shard_nodes),
                                  (got.bwd_tiles, ref.bwd_tiles, ref.padded_nodes)):
            nt = tt.num_tiles
            assert (tt.num_nodes, tt.num_row_blocks) == (rows, -(-rows // 8))
            for f in ("block", "cols", "vals", "localrow"):
                full = np.asarray(stacked[f][r])
                np.testing.assert_array_equal(getattr(tt, f).numpy(), full[:nt], err_msg=f)
                tail = full[nt:]
                if f == "block":
                    assert (tail == full[nt - 1]).all()
                else:
                    assert not tail.any()


# ---------------------------------------------------------------------------
# sharded ops on n gloo ranks
# ---------------------------------------------------------------------------


def _jax_ops(s):
    """JAX's sharded spmm and maxk_spgemm (forward and VJP) and the compact
    aggregation, in one shard_map program."""
    n = s["n"]
    sg = jshard.build_sharded_graph(jax_rmat_graph(*GRAPH), n, norm="right")

    class _Layer:
        kernel_mode = "segsum"
        compute_dtype = None

    agg = _AggMixin._aggregate.__get__(_Layer())

    def f(g, xx, cc, va, se, xd):
        y, vjp = jax.vjp(lambda a: jsp.spmm(g, a, mode="segsum"), xx)
        my, mvjp = jax.vjp(lambda a: jsp.maxk_spgemm(g, JCBSR(a, se), dim=D, mode="segsum"), va)
        return y, vjp(cc)[0], my, mvjp(cc)[0], agg(g, xd, JCBSR(va, se))

    outs = _jax_sharded(n, sg, f, s["x"], s["ct"], s["vals"], s["sel"], s["xdrop"], outs=5)
    return {k: np.asarray(a)[:GRAPH[0]] for k, a in zip(OPS, outs)}


def _single_device_ops(s):
    g = build_graph(rmat_graph(*GRAPH), norm="right")
    xt = torch.from_numpy(s["x"]).requires_grad_(True)
    y = tsp.spmm(g, xt)
    y.backward(torch.from_numpy(s["ct"]))
    vt = torch.from_numpy(s["vals"]).requires_grad_(True)
    my = tsp.maxk_spgemm(g, CBSR(vt, torch.from_numpy(s["sel"])), dim=D)
    my.backward(torch.from_numpy(s["ct"]))
    outs = (y, xt.grad, my, vt.grad, tsp.spmm(g, torch.from_numpy(s["xdrop"])))
    return {k: t.detach().numpy() for k, t in zip(OPS, outs)}


OPS = ("spmm_y", "spmm_dx", "maxk_y", "maxk_dvals", "agg")


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"n{n}")
def ops(request, tmp_path_factory):
    n = request.param
    v = GRAPH[0]
    rng = np.random.default_rng(n)
    x = rng.standard_normal((v, D)).astype(np.float32)
    ct = rng.standard_normal((v, D)).astype(np.float32)
    sel = np.stack([rng.choice(D, K, replace=False) for _ in range(v)]).astype(np.int32)
    vals = np.take_along_axis(x, sel, 1)
    dense = np.zeros_like(x)
    np.put_along_axis(dense, sel, vals, 1)
    xdrop = (dense * (rng.random((v, D)) > 0.5) * 2.0).astype(np.float32)  # dropout after densify
    s = dict(n=n, x=x, ct=ct, vals=vals, sel=sel, xdrop=xdrop)
    with ThreadPoolExecutor(1) as pool:  # the ranks run while JAX compiles
        ranks = pool.submit(_spawn, tmp_path_factory.mktemp("ops"), testing.ops_case, n,
                            GRAPH, "right", x, ct, vals, sel, xdrop)
        s["jax"], s["single"] = _jax_ops(s), _single_device_ops(s)
        results = ranks.result()
    s["got"] = {k: np.concatenate([r[k] for r in results])[:v] for k in OPS}
    s["recv"] = {arm: [r[f"{arm}_recv"] for r in results] for arm in ("maxk", "relu")}
    s["ranks"] = results
    return s


@pytest.mark.parametrize("what", OPS[:4])
def test_sharded_ops_match_jax_and_single_device(ops, what):
    _close(ops["got"][what], ops["jax"][what])
    _close(ops["got"][what], ops["single"][what])


def test_sharded_aggregate_uses_post_dropout_values(ops):
    """The compact sharded path samples the CBSR values again from the
    post-dropout features, as `_AggMixin._aggregate` does."""
    _close(ops["got"]["agg"], ops["jax"]["agg"])
    _close(ops["got"]["agg"], ops["single"]["agg"])


def test_collective_bytes_match_audit_model(ops):
    n, vp = ops["n"], -(-GRAPH[0] // ops["n"]) * ops["n"]
    for arm, kw in (("maxk", dict(k=K)), ("relu", {})):
        for rank_bytes in ops["recv"][arm]:
            assert rank_bytes == pytest.approx(model_recv_bytes_fwd_bwd(arm, n, vp, D, **kw), rel=1e-12)


def test_sharded_maxk_backward_reduce_scatters_sampled_rows_once(ops):
    """maxk_spgemm's forward + backward reduce-scatter once, the (Vp, k) f32
    partials K11 sampled over the transposed block: Vp·k·4 bytes handed to
    the collective, not Vp·D·4."""
    vp = -(-GRAPH[0] // ops["n"]) * ops["n"]
    for r in ops["ranks"]:
        assert tuple(r["maxk_scatter"]) == (1, vp * K * 4)


def test_sharded_maxk_dvals_equal_scatter_then_sample(ops):
    """Sampling before the reduce-scatter gives the gradient of the
    reference's order, K9 over the transposed block, the (Vp, D) partials
    reduce-scattered, then sampled at the local selectors, bit for bit: the
    same products summed in the same order, row v sampled at sel[v] on
    every rank."""
    for r in ops["ranks"]:
        np.testing.assert_array_equal(r["maxk_dvals"], r["maxk_dvals_scatter_first"])


# ---------------------------------------------------------------------------
# sharded training on 2 gloo ranks
# ---------------------------------------------------------------------------

TRAIN = dict(hidden_dim=32, hidden_layers=2, maxk=8, dropout=0.0, kernel_mode="segsum")


@pytest.fixture(scope="module")
def training(tiny_data, tmp_path_factory):
    n = 2
    mesh = make_mesh(devices=jax.devices()[:n])
    cfg = JaxTrainConfig(dataset="tiny", model="sage", epochs=3, lr=0.01, **TRAIN)
    model, variables, opt_state, sgraph, arrays, tx = jtrain.sharded_setup(cfg, tiny_data, mesh)
    params = {k: t.numpy() for k, t in
              import_flax_params(jax.tree.map(np.asarray, variables["params"])).items()}
    runs = [(dict(model="sage", epochs=3, lr=0.01, **TRAIN), params)] + [
        (dict(model=m, epochs=15, lr=0.02, **TRAIN), None) for m in ("gcn", "gin")
    ]
    pool = ThreadPoolExecutor(1)  # the ranks run while JAX compiles
    ranks = pool.submit(_spawn, tmp_path_factory.mktemp("train"), testing.train_case, n, runs)
    pool.shutdown(wait=False)
    step = jtrain.make_sharded_train_step(model, tx, False, mesh)
    losses = []
    for _ in range(cfg.epochs):
        variables, opt_state, loss, _ = step(variables, opt_state, jax.random.PRNGKey(0), sgraph,
                                             arrays["feats"], arrays["labels"], arrays["train"])
        losses.append(float(loss))
    accs = jtrain.make_sharded_eval_step(model, False, mesh)(
        variables, sgraph, arrays["feats"], arrays["labels"],
        (arrays["train"], arrays["val"], arrays["test"]))
    return dict(jax_losses=losses, jax_accs=[float(a) for a in accs],
                ranks=ranks.result())


def test_sharded_sage_three_steps_match_jax(training):
    got = training["ranks"][0][0]
    np.testing.assert_allclose(got["losses"], training["jax_losses"], rtol=1e-4)
    # one node's argmax may flip
    np.testing.assert_allclose(got["accs"], training["jax_accs"], rtol=0, atol=1.5 / 40)


def test_parameters_identical_on_every_rank(training):
    rank0, rank1 = training["ranks"]
    for run0, run1 in zip(rank0, rank1):
        assert run0["losses"] == run1["losses"]
        for name, p in run0["params"].items():
            np.testing.assert_array_equal(run1["params"][name], p, err_msg=name)


@pytest.mark.parametrize("which", [1, 2], ids=["gcn", "gin"])
def test_sharded_gcn_and_gin_losses_fall(training, which):
    losses = training["ranks"][0][which]["losses"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_sharded_multilabel_matches_single_device(tmp_path):
    """BCE over the global mask count and micro-F1 from all-reduced counts:
    3 sharded steps on 2 ranks against the port's single-device loop."""
    from maxk_tpu_torch.train.config import TrainConfig
    from maxk_tpu_torch.train.loop import evaluate, train

    kwargs = dict(model="sage", epochs=3, lr=0.01, **TRAIN)
    got = _spawn(tmp_path, testing.train_case, 2, [(kwargs, None)], True)[0][0]
    data = testing.tiny_data(multilabel=True)
    state = train(TrainConfig(dataset="tiny", device="cpu", **kwargs), data, warmup_epochs=3)
    np.testing.assert_allclose(got["losses"], state.losses, rtol=1e-5)
    np.testing.assert_allclose(got["accs"], evaluate(state, data), rtol=1e-5)


def test_sharded_rocauc_matches_single_device(tmp_path):
    """ogbn-proteins' metric on the row-partitioned path: the logits,
    labels and mask rows all-gathered and ranked globally. 3 sharded steps
    on 2 ranks against the port's single-device loop: losses at rtol 1e-5,
    train/val/test ROC-AUC at atol 1e-6."""
    from maxk_tpu_torch.train.config import TrainConfig
    from maxk_tpu_torch.train.loop import evaluate, train

    kwargs = dict(model="sage", epochs=3, lr=0.01, **TRAIN)
    got = _spawn(tmp_path, testing.train_case, 2, [(kwargs, None)], True, "rocauc")[0][0]
    data = testing.tiny_data(multilabel=True)
    state = train(TrainConfig(dataset="tiny", device="cpu", **kwargs), data, warmup_epochs=3)
    np.testing.assert_allclose(got["losses"], state.losses, rtol=1e-5)
    ref = evaluate(state, data, metric="rocauc")
    assert all(0.0 < x < 1.0 for x in ref)
    np.testing.assert_allclose(got["accs"], ref, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# spawning and the CLI
# ---------------------------------------------------------------------------


def test_run_ranks_defaults_to_cuda_ranks(monkeypatch):
    """With no `device_type`, `run_ranks` asks for one CUDA device a rank
    and raises, naming both counts, where there is none: it never runs CPU
    ranks unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices, found 0"):
        run_ranks(testing.train_case, 2, ([],))


def test_run_ranks_fails_on_a_rank_error_and_on_its_deadline(tmp_path):
    import torch.multiprocessing as mp

    with pytest.raises(mp.ProcessRaisedException, match="nonsense"):
        _spawn(tmp_path, testing.train_case, 2, [(dict(model="nonsense"), None)])
    with pytest.raises(TimeoutError, match="outlasted"):
        run_ranks(testing.train_case, 2, ([],), device_type="cpu",
                  init_method=f"file://{tmp_path}/slow", timeout=0.2)


def test_cli_mesh_shape_2_on_cpu_ranks(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "maxk_tpu_torch", "--device", "cpu", "--mesh_shape", "2",
         "--dataset", "flickr", "--data_scale", "0.002", "--epochs", "2", "--hidden_dim", "32",
         "--hidden_layers", "2", "--maxk", "4", "--path", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=DEADLINE,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    log = (tmp_path / "flickr_seed97" / "sage_maxk" / "train.log").read_text()
    assert "mesh: 2 ranks, backend gloo" in log
    assert "epoch 00001" in log and "best val" in log


def test_cli_mesh_shape_on_missing_gpus_raises(monkeypatch, tmp_path):
    from maxk_tpu_torch.__main__ import main

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices, found 1"):
        main(["--mesh_shape", "2", "--device", "cuda", "--path", str(tmp_path)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs 4 CUDA devices, found 0"):
        main(["--mesh_shape", "4", "--path", str(tmp_path)])
    assert not any(tmp_path.iterdir())  # raised before any work
