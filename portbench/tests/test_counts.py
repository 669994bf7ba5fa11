"""The FLOP count and the read-once bytes against hand counts at a tiny shape."""

import pytest

from portbench import registry, roofline


def test_csr_and_k9_bytes():
    # 5 nodes, 12 live edges: 6 pointers, 12 columns and 12 weights of 4 bytes
    assert roofline.csr_bytes(5, 12) == 6 * 4 + 12 * 8
    # x read and y written once: 2 x 5 x 8 x 4 bytes
    assert roofline.k9_bytes(5, 12, 8) == 6 * 4 + 12 * 8 + 320
    assert roofline.k9_bytes(5, 12, 8, itemsize=2) == 6 * 4 + 12 * 8 + 160


def test_k10_and_k11_bytes():
    # 5 nodes, 12 live edges, D = 8, k = 2: the CSR (120 bytes) once
    # K10: merged rows 5 x 2 x (4 + 2) = 60, y written 5 x 8 x 4 = 160
    assert roofline.k10_bytes(5, 12, 8, 2) == 120 + 60 + 160
    # K11: g read 160, selectors 5 x 2 x 4 = 40 read, dvals 40 written
    assert roofline.k11_bytes(5, 12, 8, 2) == 120 + 160 + 40 + 40
    assert roofline.k10_bytes(5, 12, 8, 2, itemsize=2) == 120 + 5 * 2 * 4 + 80
    assert roofline.k11_bytes(5, 12, 8, 2, itemsize=2) == 120 + 80 + 40 + 20


def _record(ops, chips=1):
    return {"trace": {"ops": ops}, "num_nodes": 5, "live_edges": 12, "chips": chips,
            "config": {"hidden_dim": 8, "feat_dim": 3, "num_classes": 2, "hidden_layers": 2,
                       "reference": "sage"},
            "traffic": {"maxk": 2, "nonlinear": "maxk", "compute_dtype": "float32"},
            "stamps": [(0.0, 0.5, 0.8, 1.0)]}


def test_cbsr_pair_roofline_by_hand():
    read = registry.reader("cbsr_pair_roofline").read
    k10 = roofline.k10_bytes(5, 12, 8, 2) / roofline.HBM_BYTES_PER_S
    k11 = roofline.k11_bytes(5, 12, 8, 2) / roofline.HBM_BYTES_PER_S
    ops = {"spgemm_cbsr_kernel<float, true, 8>": {"count": 4, "seconds": 1e-6},
           "cbsr_merge_kernel<float>": {"count": 4, "seconds": 1e-6},
           "combine_kernel<float>": {"count": 4, "seconds": 1e-6},
           "sspmm_cbsr_kernel<float, 4, 2>": {"count": 2, "seconds": 2e-6},
           "ampere_sgemm": {"count": 9, "seconds": 1.0}}
    assert read(_record(ops)) == pytest.approx(100 * (4 * k10 + 2 * k11) / 5e-6)
    # where K9 runs too, the partial-sum pass is not K10's alone: left out
    ops["spmm_csr_kernel<float, true>"] = {"count": 1, "seconds": 1.0}
    assert read(_record(ops)) == pytest.approx(100 * (4 * k10 + 2 * k11) / 4e-6)
    assert read(_record({"ampere_sgemm": {"count": 1, "seconds": 1.0}})) is None


def test_mfu_divides_by_the_cards():
    read = registry.reader("mfu").read
    one, four = read(_record({})), read(_record({}, chips=4))
    assert one > 0 and four == pytest.approx(one / 4)


def test_comm_recv_gb_per_traced_epoch():
    read = registry.reader("comm_recv_gb").read
    assert read({**_record({}), "comm_recv_bytes": [3e9, 5e9]}) == pytest.approx(4.0)
    assert read(_record({})) is None


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
