"""maxk_tpu_torch.train.metrics against maxk_tpu.train.metrics on seeded
inputs: `rocauc` (rank-sum, ordinal ranks on ties, masked rows sunk to the
bottom, classes with one side only left out of the mean) and top-k
`accuracy`, both at rtol 1e-6 (f32 sums in another order); and
`loop.evaluate` on ogbn-proteins from imported flax parameters, where the
ROC-AUC is held at atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxk_tpu.data.datasets import load_dataset as jax_load_dataset
from maxk_tpu.train import config as jcfg
from maxk_tpu.train import metrics as jmet
from maxk_tpu.train.loop import evaluate as jax_evaluate
from maxk_tpu.train.loop import setup as jax_setup
from maxk_tpu_torch.data.datasets import load_dataset
from maxk_tpu_torch.models.convert import import_flax_params
from maxk_tpu_torch.train import config as tcfg
from maxk_tpu_torch.train import loop as tloop
from maxk_tpu_torch.train import metrics as tmet

torch.set_num_threads(1)

N, C = 300, 12


def _inputs(seed, ties=False, mask_frac=None, empty_class=False):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((N, C)).astype(np.float32)
    if ties:
        # few distinct scores a column: many ties inside every column
        logits = np.round(logits * 2) / 2
    labels = (rng.random((N, C)) < 0.3).astype(np.float32)
    if empty_class:
        labels[:, 3] = 0.0  # no positive
        labels[:, 5] = 1.0  # no negative
    mask = np.ones(N, bool) if mask_frac is None else rng.random(N) < mask_frac
    return logits, labels, mask


CASES = {
    "random": {},
    "ties": {"ties": True},
    "partial_mask": {"mask_frac": 0.4},
    "ties_partial_mask": {"ties": True, "mask_frac": 0.6},
    "one_sided_classes": {"empty_class": True, "mask_frac": 0.7},
}


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("case", list(CASES))
def test_rocauc_matches_jax(case, seed):
    logits, labels, mask = _inputs(seed, **CASES[case])
    ref = float(jmet.rocauc(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask)))
    got = tmet.rocauc(torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), ref, rtol=1e-6)


def test_rocauc_ties_are_ordinal_not_mid_ranks():
    """Three tied scores, one positive first in row order: ordinal ranks
    give the positive the lowest tied rank (AUC 0), mid-ranks would give
    0.5."""
    logits = np.zeros((3, 1), np.float32)
    labels = np.array([[1.0], [0.0], [0.0]], np.float32)
    ref = float(jmet.rocauc(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(tmet.rocauc(torch.from_numpy(logits), torch.from_numpy(labels)))
    assert got == ref == 0.0


def test_rocauc_no_mask_and_no_valid_class():
    logits, labels, _ = _inputs(3)
    np.testing.assert_allclose(
        float(tmet.rocauc(torch.from_numpy(logits), torch.from_numpy(labels))),
        float(jmet.rocauc(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6)
    none = np.zeros_like(labels)
    assert float(tmet.rocauc(torch.from_numpy(logits), torch.from_numpy(none))) == 0.0


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_accuracy_matches_jax(ties):
    """Top-1/3/5 accuracy in percent; with ties the stable order of -logits
    decides which tied class is in the top k."""
    logits, _, _ = _inputs(11, ties=ties)
    labels = np.random.default_rng(11).integers(0, C, N)
    ref = jmet.accuracy(jnp.asarray(logits), jnp.asarray(labels), topk=(1, 3, 5))
    got = tmet.accuracy(torch.from_numpy(logits), torch.from_numpy(labels), topk=(1, 3, 5))
    np.testing.assert_allclose([float(g) for g in got], [float(r) for r in ref], rtol=1e-6)


def test_evaluate_proteins_rocauc_matches_jax():
    """ogbn-proteins at scale 0.002 (DC-SBM): the port's `loop.evaluate`
    picks ROC-AUC and gives the JAX package's train/val/test values from
    the same imported parameters (logits within f32 rounding, so a near-tie
    may swap two ranks: atol 1e-5)."""
    kw = dict(scale=0.002, seed=123, feat_snr=0.15, graph_kind="sbm")
    jdata, tdata = jax_load_dataset("ogbn-proteins", **kw), load_dataset("ogbn-proteins", **kw)
    args = dict(dataset="ogbn-proteins", hidden_dim=32, hidden_layers=2, maxk=8, dropout=0.0,
                kernel_mode="segsum")
    jstate = jax_setup(jcfg.TrainConfig(**args), jdata)
    tstate = tloop.setup(tcfg.TrainConfig(device="cpu", **args), tdata)
    tstate.model.load_state_dict(
        import_flax_params(jax.tree.map(np.asarray, jstate.variables["params"])), strict=True)
    ref = jax_evaluate(jstate, jdata)
    got = tloop.evaluate(tstate, tdata)
    assert all(0.0 < x < 1.0 for x in got)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    # the explicit metric argument: "f1" gives micro-F1 on the same state
    np.testing.assert_allclose(tloop.evaluate(tstate, tdata, metric="f1"),
                               jax_evaluate(jstate, jdata, metric="f1"), rtol=0, atol=1e-3)
