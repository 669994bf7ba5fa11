"""The FLOP count and the read-once bytes against hand counts at a tiny shape."""

import pytest

from portbench import registry, roofline


def test_csr_and_k9_bytes():
    # 5 nodes, 12 live edges: 6 pointers, 12 columns and 12 weights of 4 bytes
    assert roofline.csr_bytes(5, 12) == 6 * 4 + 12 * 8
    # x read and y written once: 2 x 5 x 8 x 4 bytes
    assert roofline.k9_bytes(5, 12, 8) == 6 * 4 + 12 * 8 + 320
    assert roofline.k9_bytes(5, 12, 8, itemsize=2) == 6 * 4 + 12 * 8 + 160


def test_bound_takes_the_larger():
    assert roofline.bound_seconds(3.35e12) == pytest.approx(1.0)
    assert roofline.bound_seconds(0, 67e12) == pytest.approx(1.0)
    assert roofline.bound_seconds(3.35e12, 2 * 67e12) == pytest.approx(2.0)
    assert roofline.bound_seconds(0, 989e12, "bfloat16") == pytest.approx(1.0)


@pytest.mark.parametrize("nonlinear,width", [("maxk", 2), ("relu", 4)])
def test_sage_flops_by_hand(nonlinear, width):
    # V=10, F=3, H=4, C=2, L=2, E=20, k=2
    config = {"feat_dim": 3, "hidden_dim": 4, "num_classes": 2, "hidden_layers": 2,
              "reference": "sage"}
    traffic = {"nonlinear": nonlinear, "maxk": 2}
    lin_in, lin_out = 2 * 10 * 3 * 4, 2 * 10 * 4 * 2  # 240, 160
    conv = 2 * (2 * 10 * 4 * 4)  # fc_self + fc_neigh: 640
    agg = 2 * 20 * width
    fwd = lin_in + 2 * (conv + agg) + lin_out
    bwd = lin_in + 2 * (2 * conv + agg) + 2 * lin_out  # features take no gradient
    ref = registry.reference(config)
    assert ref.model_flops(config, traffic, 10, 20) == 2 * fwd + bwd


def test_reddit_epoch_flops():
    _, traffic, config = registry.cell("sage-reddit.maxk32")
    flops = registry.reference(config).model_flops(config, traffic, 232965, 79_037_673)
    assert flops == pytest.approx(1.27e12, rel=0.01)
