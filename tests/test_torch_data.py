"""maxk_tpu_torch.data against maxk_tpu.data: bit-equal on the same seeds
(ogbn-proteins' node features within rtol 1e-6, atol 1e-6); export writes
the same bytes and check gives the same reports."""

from pathlib import Path

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
    """Every registered dataset and both generators load; a generator or a
    dataset that neither package has raises as in the JAX package."""
    with pytest.raises(ValueError, match="unknown graph_kind 'bogus'"):
        jax_load_dataset("reddit", scale=0.001, graph_kind="bogus")
    with pytest.raises(ValueError, match="unknown graph_kind 'bogus'"):
        load_dataset("reddit", scale=0.001, graph_kind="bogus")
    with pytest.raises(KeyError):
        load_dataset("cora", scale=0.001)


# ---------------------------------------------------------------------------
# the DC-SBM generator, ogbn-proteins, export and check
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_dcsbm_graph_bit_equal(seed):
    ref_csr, ref_blocks = jsyn.dcsbm_graph(600, 9000, 7, p_intra=0.7, seed=seed)
    got_csr, got_blocks = tsyn.dcsbm_graph(600, 9000, 7, p_intra=0.7, seed=seed)
    _assert_csr_equal(ref_csr, got_csr)
    np.testing.assert_array_equal(got_blocks, ref_blocks)
    assert got_blocks.dtype == np.int32


def _assert_data_equal(ref, got, features_exact=True):
    _assert_csr_equal(ref.csr, got.csr)
    for name in ("labels", "train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)
    assert got.features.dtype == ref.features.dtype
    if features_exact:
        np.testing.assert_array_equal(got.features, ref.features)
    else:
        # incident-edge sums: index_add_ and segment_sum may add in
        # another order, so within f32 rounding
        np.testing.assert_allclose(got.features, ref.features, rtol=1e-6, atol=1e-6)
    assert (got.num_classes, got.multilabel) == (ref.num_classes, ref.multilabel)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name,scale", [("reddit", 0.001), ("flickr", 0.005), ("yelp", 0.001)])
def test_load_dataset_sbm_bit_equal(name, scale, seed):
    kw = dict(scale=scale, seed=seed, feat_snr=0.15, graph_kind="sbm", sbm_p_intra=0.3)
    _assert_data_equal(jax_load_dataset(name, **kw), load_dataset(name, **kw))


@pytest.mark.parametrize("graph_kind", ["sbm", "rmat"])
@pytest.mark.parametrize("seed", SEEDS)
def test_load_dataset_proteins(seed, graph_kind):
    """CSR, labels and masks bit-equal; the node features (edge-feature
    means) within rtol 1e-6, atol 1e-6."""
    kw = dict(scale=0.002, seed=seed, feat_snr=0.15, graph_kind=graph_kind)
    ref, got = jax_load_dataset("ogbn-proteins", **kw), load_dataset("ogbn-proteins", **kw)
    _assert_data_equal(ref, got, features_exact=False)
    assert (got.feat_dim, got.num_classes, got.multilabel) == (8, 112, True)


def test_proteins_edge_features_match_jax():
    """`synthetic_edge_features` bit-equal; `node_features_from_edges`
    within rtol 1e-6, atol 1e-6 (another summation order)."""
    from maxk_tpu.data import proteins as jprot
    from maxk_tpu_torch.data import proteins as tprot

    jcsr, tcsr = jsyn.rmat_graph(300, 4000, 3), tsyn.rmat_graph(300, 4000, 3)
    ef = tprot.synthetic_edge_features(tcsr, 8, seed=5)
    np.testing.assert_array_equal(ef, jprot.synthetic_edge_features(jcsr, 8, seed=5))
    got = tprot.node_features_from_edges(tcsr, ef)
    assert got.dtype == torch.float32 and got.shape == (300, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(jprot.node_features_from_edges(jcsr, ef)),
                               rtol=1e-6, atol=1e-6)


def _files(prefix):
    return {f.name[len(prefix.name):]: f.read_bytes()
            for f in sorted(prefix.parent.iterdir()) if f.name.startswith(prefix.name + ".")}


@pytest.mark.parametrize("name", ["flickr", "yelp"])
def test_export_byte_identical(tmp_path, name):
    """`python -m ...data.export` of both packages writes the same bytes:
    graph, values, features, labels (int32, or f32 multilabel), masks."""
    from maxk_tpu.data.export import main as jax_export
    from maxk_tpu_torch.data.export import main as export

    argv = ["--dataset", name, "--scale", "0.003", "--seed", "5"]
    jax_export(argv + ["--out", str(tmp_path / "jax")])
    (prefix,) = export(argv + ["--out", str(tmp_path / "torch")])
    got = _files(Path(prefix))
    ref = _files(tmp_path / "jax" / Path(prefix).name)
    assert sorted(got) == [".feat", ".indices", ".indptr", ".labels", ".masks", ".values"]
    assert sorted(ref) == sorted(got)
    for ext, data in got.items():
        assert data == ref[ext], ext


def test_check_graph_reports_equal(tmp_path):
    """`check_graph` on a DC-SBM and an R-MAT graph and on a binary read
    back: the same report."""
    from maxk_tpu.data.check import check_graph as jax_check
    from maxk_tpu.data.check import main as jax_check_main
    from maxk_tpu_torch.data.check import check_graph
    from maxk_tpu_torch.data.check import main as check_main

    graphs = [(jsyn.dcsbm_graph(300, 5000, 5, seed=2)[0], tsyn.dcsbm_graph(300, 5000, 5, seed=2)[0]),
              (jsyn.rmat_graph(256, 3000, 9), tsyn.rmat_graph(256, 3000, 9))]
    for jcsr, tcsr in graphs:
        assert check_graph(tcsr) == jax_check(jcsr)
    tio.save_graph_binary(str(tmp_path / "g"), [0, 2, 3, 3], [1, 2, 0])
    ref = jax_check_main(["--binary", str(tmp_path / "g")])
    got = check_main(["--binary", str(tmp_path / "g")])
    assert got == ref
    assert got["symmetric_structure"] is False and got["isolated_nodes"] == 1
