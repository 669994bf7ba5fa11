"""The port's row-partitioned strip hybrid (`parallel/shard.ShardedHybrid`,
`build_sharded_hybrid`, `ops/spmm_hybrid.spmm_hybrid_sharded` and the
hybrid in `parallel/train.sharded_setup`) against the JAX package's host
build and the port's single-device hybrid, with gloo ranks spawned on the
CPU:

- each rank's strip rows, scales and tail tables equal the JAX package's
  stacked arrays for that shard (tables: the first NT rows), bit for bit;
- spmm and maxk_spgemm, forward and gradient, on 2 and 4 ranks equal the
  single-device hybrid (f32 strip) within 1e-5 · max|ref| (f32 sums in
  another order), and each hub reduce is one all_reduce of S·D·4 bytes;
- the sharded setup permutes the graph and the node rows, and refuses an
  explicit hybrid mode on a directed graph.

Every spawn runs under a deadline.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxk_tpu.data.synthetic import rmat_graph as jax_rmat_graph
from maxk_tpu.parallel import shard as jshard
from maxk_tpu.sparse import hybrid as jh
from maxk_tpu_torch.data.datasets import GraphData
from maxk_tpu_torch.data.synthetic import rmat_graph
from maxk_tpu_torch.ops import spgemm as tsp
from maxk_tpu_torch.parallel import testing
from maxk_tpu_torch.parallel.mesh import run_ranks
from maxk_tpu_torch.parallel.shard import build_sharded_hybrid
from maxk_tpu_torch.parallel.train import sharded_setup
from maxk_tpu_torch.sparse import csr as tcsr
from maxk_tpu_torch.sparse import hybrid as th
from maxk_tpu_torch.sparse.cbsr import CBSR
from maxk_tpu_torch.sparse.graph import build_graph
from maxk_tpu_torch.train.config import TrainConfig

torch.set_num_threads(1)

GRAPH = (700, 9000, 3)
S, D, K = 128, 32, 8
DEADLINE = 150  # seconds for one spawned run
TILE_FIELDS = ("block", "cols", "vals", "localrow")


def _close(got, ref, tol=1e-5):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("dtype", [(jnp.int8, torch.int8), (jnp.bfloat16, torch.bfloat16)],
                         ids=["int8", "bfloat16"])
@pytest.mark.parametrize("norm", ["right", "both"])
@pytest.mark.parametrize("n", [2, 4])
def test_rank_parts_equal_the_jax_host_build(n, norm, dtype):
    jg, tg = jax_rmat_graph(*GRAPH), rmat_graph(*GRAPH)
    jpc = jh.permute_csr(jg, jh.degree_perm(jg))
    tpc = th.permute_csr(tg, th.degree_perm(tg))
    ref = jshard.build_sharded_hybrid(jpc, n, s_cols=S, norm=norm, strip_dtype=dtype[0])
    for r in range(n):
        got = build_sharded_hybrid(tpc, n, r, s_cols=S, norm=norm, strip_dtype=dtype[1])
        assert (got.s_cols, got.padded_nodes, got.shard_nodes) == \
            (ref.s_cols, ref.padded_nodes, ref.shard_nodes)
        assert got.strip.dtype == dtype[1]
        np.testing.assert_array_equal(got.strip.float().numpy(),
                                      np.asarray(ref.strip[r].astype(jnp.float32)))
        np.testing.assert_array_equal(got.pre.numpy(), np.asarray(ref.pre[r]))
        np.testing.assert_array_equal(got.post.numpy(), np.asarray(ref.post[r]))
        nt = got.tail_tiles.num_tiles
        for f in TILE_FIELDS:
            np.testing.assert_array_equal(getattr(got.tail_tiles, f).numpy(),
                                          np.asarray(ref.tail_tiles[f][r])[:nt], err_msg=f)
        assert not np.asarray(ref.tail_tiles["vals"][r])[nt:].any()
        assert got.tail_window <= ref.tail_window  # the rank's own tables, not the largest


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_ops_equal_the_single_device_hybrid(tmp_path, n):
    norm = "right"
    g = build_graph(rmat_graph(*GRAPH), norm=norm, hybrid=True, strip_cols=S,
                    strip_dtype=torch.float32)
    v = g.num_nodes
    rng = np.random.default_rng(n)
    x, ct = (rng.standard_normal((v, D)).astype(np.float32) for _ in range(2))
    vals = rng.standard_normal((v, K)).astype(np.float32)
    sel = np.stack([rng.choice(D, K, replace=False) for _ in range(v)]).astype(np.int32)

    xt = torch.from_numpy(x).requires_grad_(True)
    tsp.spmm(g, xt, mode="hybrid").backward(torch.from_numpy(ct))
    y_ref = tsp.spmm(g, torch.from_numpy(x), mode="hybrid")
    vt = torch.from_numpy(vals).requires_grad_(True)
    y_maxk = tsp.maxk_spgemm(g, CBSR(vt, torch.from_numpy(sel)), dim=D, mode="hybrid")
    y_maxk.backward(torch.from_numpy(ct))

    init = f"file://{tmp_path}/rendezvous_hybrid_{n}"
    outs = run_ranks(testing.hybrid_case, n, (GRAPH, norm, S, x, ct, vals, sel),
                     device_type="cpu", init_method=init, timeout=DEADLINE)
    cat = lambda key: np.concatenate([o[key] for o in outs])[:v]  # noqa: E731
    _close(cat("spmm_y"), y_ref.detach())
    _close(cat("spmm_dx"), xt.grad)
    _close(cat("maxk_y"), y_maxk.detach())
    _close(cat("maxk_dvals"), vt.grad)
    for o in outs:
        assert o["s_cols"] == S
        for key in ("spmm_reduce", "maxk_reduce"):  # one hub reduce a direction
            assert o[key] == (2, 2 * S * D * 4), (key, o[key])


def _fake_mesh(n, rank=0):
    return type("M", (), {"world_size": n, "rank": rank, "device": torch.device("cpu")})()


def test_sharded_setup_permutes_and_refuses_directed_graphs():
    csr = rmat_graph(200, 1500, seed=7)
    rng = np.random.default_rng(0)
    data = GraphData(name="tiny", csr=csr, features=rng.standard_normal((200, 16)).astype(
        np.float32), labels=rng.integers(0, 4, 200), train_mask=rng.random(200) < 0.5,
        val_mask=rng.random(200) < 0.3, test_mask=rng.random(200) < 0.3, num_classes=4,
        multilabel=False)
    cfg = TrainConfig(device="cpu", kernel_mode="hybrid", hidden_dim=16, hidden_layers=1,
                      maxk=4)
    for r in range(2):
        state = sharded_setup(cfg, data, _fake_mesh(2, r))
        h = state.graph.hybrid
        assert h is not None and h.strip.dtype == torch.int8 and h.rank == r
        perm = th.degree_perm(csr)
        np.testing.assert_array_equal(state.feats.numpy(), data.features[perm][r * 100:(r + 1) * 100])
    directed = tcsr.csr_from_coo(np.array([0, 1, 2, 2]), np.array([1, 2, 0, 1]), 3)
    small = GraphData(name="tiny", csr=directed, features=np.ones((3, 4), np.float32),
                      labels=np.zeros(3, np.int64), train_mask=np.ones(3, bool),
                      val_mask=np.ones(3, bool), test_mask=np.ones(3, bool), num_classes=2,
                      multilabel=False)
    for mode in ("hybrid", "hybrid_int8"):
        with pytest.raises(ValueError, match="requires a value-symmetric"):
            sharded_setup(TrainConfig(device="cpu", kernel_mode=mode, hidden_dim=8, maxk=2,
                                      hidden_layers=1), small, _fake_mesh(2))
    assert sharded_setup(TrainConfig(device="cpu", hidden_dim=8, maxk=2, hidden_layers=1), small,
                         _fake_mesh(2)).graph.hybrid is None
