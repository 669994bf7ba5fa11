"""The trace reduction and the tail samples, on made-up events."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import run, trace


def ev(name, start, end, device=DeviceType.CPU):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


def test_union_gaps_and_labels():
    events = [
        ev("portbench.epoch", 0, 100), ev("portbench.train_step", 0, 60),
        ev("portbench.eval_step", 60, 90), ev("portbench.loss_read", 90, 100),
        ev("void spmm_csr_kernel<float, true>(int const*)", 5, 30, DeviceType.CUDA),
        ev("void spmm_csr_kernel<float, true>(int const*)", 20, 40, DeviceType.CUDA),
        ev("Memcpy DtoH (Device -> Pageable)", 70, 80, DeviceType.CUDA),
        ev("ampere_sgemm", 95, 120, DeviceType.CUDA),  # clipped at the window's end
        ev("portbench.train_step", 0, 60, DeviceType.CUDA),  # a span's mark, not an op
        ev("nccl:_all_gather_base", 70, 80, DeviceType.CUDA),  # a collective's mark
        ev("ampere_sgemm", -50, -10, DeviceType.CUDA),  # before the window: left out
        ev("void (anonymous namespace)::combine_kernel<float>(float const*)", 38, 40,
           DeviceType.CUDA),
    ]
    rec = trace.reduce(events)
    assert rec["window_s"] == pytest.approx(100e-6)
    assert rec["busy_s"] == pytest.approx((35 + 10 + 5) * 1e-6)
    assert rec["ops"]["spmm_csr_kernel<float, true>"] == {"count": 2, "seconds": 45e-6}
    assert rec["ops"]["ampere_sgemm"]["count"] == 1
    assert "Memcpy DtoH (Device -> Pageable)" in rec["ops"]
    assert rec["ops"]["combine_kernel<float>"]["count"] == 1
    assert not any(n.startswith(("portbench", "nccl:")) for n in rec["ops"])
    gaps = dict((round(s * 1e6), n) for n, s in rec["idle_gaps"])
    # idle 0-5 and 40-70 (starting in the train step), 80-95 (in the evaluation)
    assert gaps == {30: "train_step", 5: "train_step", 15: "eval_step"}
    assert rec["idle_gaps"][0] == ("train_step", pytest.approx(30e-6))
    b = trace.breakdown(rec)
    assert b["device_ops"][0][0] == "spmm_csr_kernel<float, true>"
    assert len(b["idle_gaps"]) <= trace.TOP


def test_intervals_are_kept_inside_the_window():
    events = [ev("portbench.epoch", 100, 200),
              ev("ncclDevKernel_AllGather_RING_LL(x)", 90, 130, DeviceType.CUDA),
              ev("ampere_sgemm", 150, 160, DeviceType.CUDA)]
    rec = trace.reduce(events)
    assert rec["intervals"] == [("ncclDevKernel_AllGather_RING_LL", 0.0, 30e-6),
                                ("ampere_sgemm", 50e-6, 60e-6)]


def test_overlap_of_interval_lists():
    a = [[0, 10], [20, 30]]
    b = [[5, 25], [28, 40]]
    assert trace.overlap(a, b) == 5 + 5 + 2
    assert trace.overlap(a, []) == 0 and trace.length(a) == 20


def test_comm_exposed_ms_leaves_out_what_other_kernels_overlap():
    from portbench import registry

    read = registry.reader("comm_exposed_ms").read
    # two epochs; NCCL 0-4 ms (a GEMM over 1-2) and 10-13 ms (alone)
    intervals = [("ncclDevKernel_AllGather_RING_LL", 0.0, 0.004), ("sgemm", 0.001, 0.002),
                 ("ncclDevKernel_ReduceScatter_RING_LL", 0.010, 0.013), ("k", 0.02, 0.03)]
    record = {"trace": {"intervals": intervals}, "stamps": [(0, 0, 0, 1), (1, 1, 1, 2)]}
    assert read(record) == pytest.approx((3 + 3) / 2)
    record["trace"]["intervals"] = intervals[1:2] + intervals[3:]
    assert read(record) is None


def test_reduce_needs_an_epoch():
    with pytest.raises(ValueError):
        trace.reduce([ev("aten::mm", 0, 1)])


def test_epoch_ms_p95_is_over_every_epoch():
    # 100 epochs of 100 ms with ten stalls of 400 ms: the tail shows them whole
    lengths = [0.1] * 90 + [0.4] * 10
    t, stamps = 0.0, []
    for x in lengths:
        stamps.append((t, t + x / 2, t + x / 2, t + x))
        t += x
    assert run.epoch_ms_p95(stamps) == pytest.approx(400.0)
    assert run.epoch_ms_p95(stamps[:90]) == pytest.approx(100.0)
    assert run.epoch_ms_p95(stamps[:1]) is None
