"""The device R-MAT copy and the other inputs, on the CPU at a small scale."""

import pytest
import torch

from portbench import gen, registry
from portbench.tests.conftest import TINY


def _graph(seed, v=700, e=9000):
    return gen.rmat_csr(v, e, gen.generator(seed, "cpu"))


def test_rmat_shape_symmetry_no_loops_dedup_exact_count():
    indptr, indices = _graph(3)
    v = 700
    assert indptr.shape == (v + 1,) and indptr.dtype == torch.int32
    assert int(indptr[0]) == 0 and int(indptr[-1]) == indices.numel()
    rows = torch.repeat_interleave(torch.arange(v), torch.diff(indptr.long()))
    cols = indices.long()
    assert int(cols.min()) >= 0 and int(cols.max()) < v
    keys = rows * v + cols
    assert torch.equal(keys, torch.unique(keys))  # sorted within rows, no duplicates
    assert torch.equal(torch.sort(cols * v + rows).values, keys)  # symmetric
    assert not bool((rows == cols).any())  # no self-loops
    assert indices.numel() == 9000  # exactly the edges asked for


def test_rmat_dense_corner_takes_several_rounds():
    # a few nodes asked for most of their pairs: the first round's duplicates
    # are made up by later ones, and the count is still exact
    indptr, indices = gen.rmat_csr(64, 64 * 63 - 200, gen.generator(11, "cpu"))
    assert indices.numel() == 64 * 63 - 200
    rows = torch.repeat_interleave(torch.arange(64), torch.diff(indptr.long()))
    assert not bool((rows == indices.long()).any())


def test_rmat_refuses_what_cannot_be_drawn():
    with pytest.raises(ValueError):
        gen.rmat_csr(10, 91, gen.generator(1, "cpu"))  # odd
    with pytest.raises(ValueError):
        gen.rmat_csr(10, 92, gen.generator(1, "cpu"))  # more than 10 nodes hold


def test_rmat_skew_and_seeds():
    a, b = _graph(3), _graph(3)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    c = _graph(4)
    assert not torch.equal(a[1][: c[1].numel()], c[1][: a[1].numel()])
    deg = torch.diff(a[0].long()).float()
    assert float(deg.max()) > 4 * float(deg.mean())  # R-MAT's hubs


def test_rmat_large_seed():
    indptr, _ = gen.rmat_csr(300, 2000, gen.generator(2**31 + 2**30 + 17, "cpu"))
    assert indptr.shape == (301,)


def test_inputs_from_seed():
    _, _, config = registry.cell("sage-reddit.maxk32")
    config = {**config, **TINY}
    params = registry.reference(config).parameters(config)
    x = gen.make_inputs(config, params, 9, "cpu")
    y = gen.make_inputs(config, params, 9, "cpu")
    v = TINY["num_nodes"]
    assert x.features.shape == (v, TINY["feat_dim"]) and torch.equal(x.features, y.features)
    z = gen.make_inputs(config, params, 10, "cpu")
    assert torch.equal(x.indices, z.indices) and torch.equal(x.indptr, z.indptr)  # one graph
    assert not torch.equal(x.features, z.features)
    assert int(x.labels.min()) >= 0 and int(x.labels.max()) < TINY["num_classes"]
    train, val, test = x.masks
    assert not bool((train & val).any() | (train & test).any() | (val & test).any())
    assert bool((train | val | test).all())
    assert int(train.sum()) == round(config["split"][0] * v)
    assert int(val.sum()) == round(config["split"][1] * v)
    assert [n for n, _, _ in params] == list(x.weights)
    for name, shape, fan_in in params:
        w = x.weights[name]
        assert tuple(w.shape) == tuple(shape) and torch.equal(w, y.weights[name])
    w = x.weights["conv0.fc_self.weight"]
    assert abs(float(w.std()) * 256**0.5 - 1.0) < 0.05
