"""MaxK-SAGE, MaxK-GCN, MaxK-GIN and GNNRes in the port against the flax
models, from imported parameters (and GNNRes's batch statistics): logits
and the gradient of the masked loss for every parameter, at 1e-5; GNNRes's
running mean and variance after a training forward, at 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxk_tpu.data.synthetic import planted_partition_data, rmat_graph as jax_rmat_graph
from maxk_tpu.models.layers import MaxKSAGEConv as JaxSAGEConv
from maxk_tpu.models.models import build_model as jax_build_model
from maxk_tpu.sparse.graph import build_graph as jax_build_graph
from maxk_tpu.train.loop import _loss_fn as jax_loss_fn
from maxk_tpu_torch.data.synthetic import rmat_graph
from maxk_tpu_torch.models.convert import import_flax_params
from maxk_tpu_torch.models.layers import MaxKSAGEConv, dense
from maxk_tpu_torch.models.models import build_model, dropout
from maxk_tpu_torch.sparse.graph import build_graph
from maxk_tpu_torch.train.loop import _loss_fn

torch.set_num_threads(1)

F_IN, HIDDEN, LAYERS, MAXK, CLASSES = 24, 32, 2, 4, 5


@pytest.fixture(scope="module")
def setting():
    jcsr = jax_rmat_graph(200, 1500, seed=11)
    feats, labels, masks = planted_partition_data(jcsr, F_IN, CLASSES, seed=11)
    jg = jax_build_graph(jcsr, norm="right", build_tiles=False)
    tg = build_graph(rmat_graph(200, 1500, seed=11), norm="right")
    s = dict(jg=jg, tg=tg, feats=feats, labels=labels, mask=masks[0])
    s["model"], s["params"] = _jax_model(s)
    return s


def _jax_model(s, **flags):
    model, _ = jax_build_model("sage", CLASSES, hidden_dim=HIDDEN, num_layers=LAYERS,
                               maxk=MAXK, dropout=0.0, kernel_mode="segsum", **flags)
    key = jax.random.PRNGKey(0)
    params = model.init({"params": key, "dropout": key}, s["jg"], jnp.asarray(s["feats"]))
    return model, params["params"]


def _torch_model(params, **flags):
    m, norm = build_model("sage", F_IN, CLASSES, hidden_dim=HIDDEN, num_layers=LAYERS,
                          maxk=MAXK, dropout=0.0, generator=torch.Generator().manual_seed(0),
                          **flags)
    assert norm == "right"
    m.load_state_dict(import_flax_params(jax.tree.map(np.asarray, params)), strict=True)
    return m


@pytest.mark.parametrize("flags", [{}, {"nonlinear": "relu"}, {"norm": True}], ids=str)
def test_logits_match(setting, flags):
    s = setting
    model, params = _jax_model(s, **flags) if flags else (s["model"], s["params"])
    ref = model.apply({"params": params}, s["jg"], jnp.asarray(s["feats"]))
    got = _torch_model(params, **flags)(s["tg"], torch.from_numpy(s["feats"]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_param_grads_match(setting):
    s = setting
    labels, mask = jnp.asarray(s["labels"]), jnp.asarray(s["mask"])

    def loss_of(p):
        logits = s["model"].apply({"params": p}, s["jg"], jnp.asarray(s["feats"]), train=True,
                                  rngs={"dropout": jax.random.PRNGKey(1)})
        return jax_loss_fn(logits, labels, mask, False)

    loss_ref, grads = jax.value_and_grad(loss_of)(s["params"])
    m = _torch_model(s["params"])
    loss = _loss_fn(m(s["tg"], torch.from_numpy(s["feats"]), train=True),
                    torch.from_numpy(s["labels"]), torch.from_numpy(s["mask"]), False)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5)
    ref = import_flax_params(jax.tree.map(np.asarray, grads))
    named = dict(m.named_parameters())
    assert set(named) == set(ref)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_conv_lin_before_mp(setting):
    """A conv that shrinks the width applies fc_neigh before aggregating."""
    s = setting
    x = np.random.default_rng(3).standard_normal((s["jg"].num_nodes, HIDDEN)).astype(np.float32)
    conv = JaxSAGEConv(HIDDEN // 2, kernel_mode="segsum")
    params = conv.init(jax.random.PRNGKey(2), s["jg"], jnp.asarray(x))["params"]
    ref = conv.apply({"params": params}, s["jg"], jnp.asarray(x))
    tconv = MaxKSAGEConv(HIDDEN, HIDDEN // 2)
    assert tconv.lin_before_mp
    tconv.load_state_dict(import_flax_params(jax.tree.map(np.asarray, params)))
    got = tconv(s["tg"], torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_init_follows_flax_and_leaves_global_rng_alone():
    state = torch.get_rng_state()
    lin = dense(400, 300, generator=torch.Generator().manual_seed(5))
    assert torch.equal(torch.get_rng_state(), state)
    std = (1 / 400) ** 0.5 / 0.87962566103423978
    w = lin.weight.detach()
    assert w.shape == (300, 400) and torch.all(lin.bias == 0)
    assert w.abs().max() <= 2 * std
    assert abs(w.std().item() - (1 / 400) ** 0.5) < 0.02 * (1 / 400) ** 0.5
    again = dense(400, 300, generator=torch.Generator().manual_seed(5))
    assert torch.equal(again.weight, lin.weight)


def test_dropout_draws_from_its_generator():
    x = torch.ones(1000, 64)
    a = dropout(x, 0.5, torch.Generator().manual_seed(1))
    b = dropout(x, 0.5, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    assert set(torch.unique(a).tolist()) == {0.0, 2.0}
    assert abs((a == 0).float().mean().item() - 0.5) < 0.02
    assert dropout(x, 0.0, None) is x
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.5, None)


@pytest.mark.parametrize("flags", [{}, {"nonlinear": "relu"}, {"norm": True}], ids=str)
@pytest.mark.parametrize("name", ["gcn", "gin"])
def test_gcn_gin_logits_and_grads_match(name, flags):
    """MaxK-GCN (norm "both") and MaxK-GIN (norm "none", learnable eps) from
    imported flax parameters: logits and every parameter's gradient of the
    masked loss at 1e-5."""
    jcsr = jax_rmat_graph(200, 1500, seed=11)
    feats, labels, masks = planted_partition_data(jcsr, F_IN, CLASSES, seed=11)
    jmodel, gnorm = jax_build_model(name, CLASSES, hidden_dim=HIDDEN, num_layers=LAYERS,
                                    maxk=MAXK, dropout=0.0, kernel_mode="segsum", **flags)
    jg = jax_build_graph(jcsr, norm=gnorm, build_tiles=False)
    key = jax.random.PRNGKey(0)
    params = jmodel.init({"params": key, "dropout": key}, jg, jnp.asarray(feats))["params"]

    def loss_of(p):
        logits = jmodel.apply({"params": p}, jg, jnp.asarray(feats))
        return jax_loss_fn(logits, jnp.asarray(labels), jnp.asarray(masks[0]), False), logits

    (_, ref), grads = jax.value_and_grad(loss_of, has_aux=True)(params)
    m, norm = build_model(name, F_IN, CLASSES, hidden_dim=HIDDEN, num_layers=LAYERS, maxk=MAXK,
                          dropout=0.0, generator=torch.Generator().manual_seed(0), **flags)
    assert norm == gnorm
    m.load_state_dict(import_flax_params(jax.tree.map(np.asarray, params)), strict=True)
    logits = m(build_graph(rmat_graph(200, 1500, seed=11), norm=norm), torch.from_numpy(feats))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    _loss_fn(logits, torch.from_numpy(labels), torch.from_numpy(masks[0]), False).backward()
    ref_grads = import_flax_params(jax.tree.map(np.asarray, grads))
    named = dict(m.named_parameters())
    assert set(named) == set(ref_grads)
    for pname, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[pname].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=pname)


def test_relu_aliases_default_to_relu():
    from maxk_tpu_torch.models.models import GCN, GIN, MaxKGCN

    for cls in (GCN, GIN):
        assert cls(F_IN, hidden_dim=HIDDEN, num_layers=LAYERS).nonlinear == "relu"
    assert MaxKGCN(F_IN, hidden_dim=HIDDEN, num_layers=LAYERS).nonlinear == "maxk"


def test_sage_alias_is_maxk_sage_with_relu(setting):
    """`SAGE` (exported as the JAX package exports it) equals
    `MaxKSAGE(nonlinear="relu")`: the same parameters, the same logits."""
    from maxk_tpu_torch.models import SAGE, MaxKSAGE

    s = setting
    kw = dict(hidden_dim=HIDDEN, num_layers=LAYERS, out_dim=CLASSES, dropout=0.0)
    alias = SAGE(F_IN, generator=torch.Generator().manual_seed(4), **kw)
    relu = MaxKSAGE(F_IN, nonlinear="relu", generator=torch.Generator().manual_seed(4), **kw)
    assert alias.nonlinear == relu.nonlinear == "relu"
    for (n1, a), (n2, b) in zip(alias.state_dict().items(), relu.state_dict().items()):
        assert n1 == n2 and torch.equal(a, b)
    x = torch.from_numpy(s["feats"])
    assert torch.equal(alias(s["tg"], x), relu(s["tg"], x))


def test_unported_models_raise():
    """GNNRes has no row-partitioned path (nor has the reference); an
    unknown model is a KeyError."""
    from maxk_tpu_torch.parallel.train import check_sharded_model

    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        check_sharded_model("gnn_res")
    check_sharded_model("sage")
    with pytest.raises(KeyError):
        build_model("nonsense", F_IN, CLASSES)


@pytest.fixture(scope="module")
def gnn_res():
    """flax GNNRes (norm "both", dropout 0) at its init, with batch stats
    moved off their zeros/ones by one training forward, and the port's
    model built from the same params and batch stats."""
    jcsr = jax_rmat_graph(200, 1500, seed=11)
    feats, labels, masks = planted_partition_data(jcsr, F_IN, CLASSES, seed=11)
    jmodel, gnorm = jax_build_model("gnn_res", CLASSES, hidden_dim=HIDDEN, num_layers=LAYERS,
                                    dropout=0.0, kernel_mode="segsum")
    assert gnorm == "both"
    jg = jax_build_graph(jcsr, norm=gnorm, build_tiles=False)
    key = jax.random.PRNGKey(0)
    v = jmodel.init({"params": key, "dropout": key}, jg, jnp.asarray(feats))
    _, upd = jmodel.apply(v, jg, jnp.asarray(feats) * 0.5 + 0.1, train=True,
                          mutable=["batch_stats"])
    params, stats = v["params"], upd["batch_stats"]
    tg = build_graph(rmat_graph(200, 1500, seed=11), norm=gnorm)
    return dict(jmodel=jmodel, jg=jg, tg=tg, feats=feats, labels=labels, mask=masks[0],
                params=params, stats=stats)


def _torch_gnn_res(g):
    m, norm = build_model("gnn_res", F_IN, CLASSES, hidden_dim=HIDDEN, num_layers=LAYERS,
                          dropout=0.0, generator=torch.Generator().manual_seed(0))
    assert norm == "both"
    m.load_state_dict(import_flax_params(jax.tree.map(np.asarray, g["params"]),
                                         jax.tree.map(np.asarray, g["stats"])), strict=True)
    return m


def test_gnn_res_eval_logits_match(gnn_res):
    """Eval mode normalizes with the running statistics: logits at 1e-5."""
    g = gnn_res
    ref = g["jmodel"].apply({"params": g["params"], "batch_stats": g["stats"]}, g["jg"],
                            jnp.asarray(g["feats"]))
    m = _torch_gnn_res(g)
    before = {k: b.clone() for k, b in m.named_buffers()}
    got = m(g["tg"], torch.from_numpy(g["feats"]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    for k, b in m.named_buffers():
        assert torch.equal(b, before[k]), k  # eval leaves the statistics alone


def test_gnn_res_train_logits_grads_and_stats_match(gnn_res):
    """Train mode normalizes with the biased batch statistics and moves the
    running ones by momentum 0.99 — even with `module.eval()` set, since the
    mode is the `train` argument: logits, every parameter's gradient of the
    masked loss, and the running mean and variance at 1e-5."""
    g = gnn_res
    labels, mask = jnp.asarray(g["labels"]), jnp.asarray(g["mask"])

    def loss_of(p):
        logits, upd = g["jmodel"].apply({"params": p, "batch_stats": g["stats"]}, g["jg"],
                                        jnp.asarray(g["feats"]), train=True,
                                        mutable=["batch_stats"])
        return jax_loss_fn(logits, labels, mask, False), (logits, upd["batch_stats"])

    (_, (ref, ref_stats)), grads = jax.value_and_grad(loss_of, has_aux=True)(g["params"])
    m = _torch_gnn_res(g).eval()
    logits = m(g["tg"], torch.from_numpy(g["feats"]), train=True)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    _loss_fn(logits, torch.from_numpy(g["labels"]), torch.from_numpy(g["mask"]), False).backward()
    ref_grads = import_flax_params(jax.tree.map(np.asarray, grads))
    named = dict(m.named_parameters())
    assert set(named) == set(ref_grads)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    for i in range(LAYERS):
        for stat in ("mean", "var"):
            np.testing.assert_allclose(getattr(getattr(m, f"bn{i}"), stat).numpy(),
                                       np.asarray(ref_stats[f"bn{i}"][stat]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"bn{i}.{stat}")
