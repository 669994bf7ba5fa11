"""maxk_tpu_torch.data against maxk_tpu.data: bit-equal on the same seeds."""

import numpy as np
import pytest
import torch

from maxk_tpu.data import synthetic as jsyn
from maxk_tpu.data.datasets import load_dataset as jax_load_dataset
from maxk_tpu_torch.data import io as tio
from maxk_tpu_torch.data import synthetic as tsyn
from maxk_tpu_torch.data.datasets import load_dataset

torch.set_num_threads(1)

SEEDS = [0, 7, 123]


def _assert_csr_equal(jax_csr, torch_csr):
    np.testing.assert_array_equal(np.asarray(jax_csr.indptr), torch_csr.indptr.numpy())
    np.testing.assert_array_equal(np.asarray(jax_csr.indices), torch_csr.indices.numpy())
    np.testing.assert_array_equal(np.asarray(jax_csr.values), torch_csr.values.numpy())
    assert torch_csr.indptr.dtype == torch.int32
    assert torch_csr.indices.dtype == torch.int32
    assert torch_csr.values.dtype == torch.float32


@pytest.mark.parametrize("seed", SEEDS)
def test_rmat_graph_bit_equal(seed):
    _assert_csr_equal(jsyn.rmat_graph(300, 2000, seed), tsyn.rmat_graph(300, 2000, seed))


@pytest.mark.parametrize("multilabel", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_planted_partition_bit_equal(seed, multilabel):
    jcsr = jsyn.rmat_graph(250, 1800, seed)
    tcsr = tsyn.rmat_graph(250, 1800, seed)
    ref = jsyn.planted_partition_data(jcsr, 24, 6, seed=seed, multilabel=multilabel)
    got = tsyn.planted_partition_data(tcsr, 24, 6, seed=seed, multilabel=multilabel)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    for a, b in zip(got[2], ref[2]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", SEEDS)
def test_load_dataset_reddit_bit_equal(seed):
    ref = jax_load_dataset("reddit", scale=0.001, seed=seed)
    got = load_dataset("reddit", scale=0.001, seed=seed)
    _assert_csr_equal(ref.csr, got.csr)
    for name in ("features", "labels", "train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    assert (got.num_classes, got.multilabel, got.feat_dim) == (41, False, 602)


def test_graph_binary_drop_in(tmp_path, monkeypatch):
    """$MAXK_TPU_DATA binaries load the same graph in both packages."""
    csr = tsyn.rmat_graph(120, 900, seed=5)
    tio.save_graph_binary(str(tmp_path / "flickr"), csr.indptr, csr.indices)
    monkeypatch.setenv("MAXK_TPU_DATA", str(tmp_path))
    ref = jax_load_dataset("flickr", scale=1.0, seed=3)
    got = load_dataset("flickr", scale=1.0, seed=3)
    _assert_csr_equal(ref.csr, got.csr)
    np.testing.assert_array_equal(got.features, ref.features)
    np.testing.assert_array_equal(got.labels, ref.labels)


def test_corrupt_binary_raises(tmp_path):
    tio.save_graph_binary(str(tmp_path / "g"), [0, 1, 3], [0, 1])
    with pytest.raises(ValueError, match="corrupt graph binary"):
        tio.load_graph_binary(str(tmp_path / "g"))


def test_unported_datasets_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        load_dataset("ogbn-proteins", scale=0.001)
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        load_dataset("reddit", scale=0.001, graph_kind="sbm")
