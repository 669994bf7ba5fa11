"""Whole runs on the CPU at a tiny size: the harness without its look for a
card, the program against the plain reference, and the check coming out
false under each fault a one-card training cell can have."""

import math

import pytest
import torch

from portbench import calibrate, checks, gen, registry, run
from portbench.tests.conftest import TINY

SEED = 2**31 + 4242


@pytest.mark.parametrize("cell", ["sage-reddit.maxk32", "sage-reddit.relu", "sage-reddit.maxk8"])
def test_sound_run_is_correct(cell):
    res = run.run(cell, SEED, 1.5, False, device="cpu", sizes=TINY)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {m["name"] for m in registry.metrics("end_to_end", cell)}
    for name, v in res["checks"].items():
        assert v["value"] <= v["limit"] / 10, name


def test_traced_run_reads_per_layer_metrics():
    res = run.run("sage-products.maxk32", SEED, 0.0, True, device="cpu",
                  sizes={**TINY, "feat_dim": 100, "num_classes": 47})
    assert res["correct"]
    assert {"train_step_ms", "eval_ms", "mfu", "build_graph_s"} <= set(res["metrics"])
    # no device on the CPU: the device's readers find nothing and stay out
    assert "cbsr_pair_roofline" not in res["metrics"]
    assert "device_idle_share" not in res["metrics"]
    assert res["attempted"] == registry.cell("sage-products.maxk32")[1]["trace_epochs"]
    assert "breakdown" in res and res["device"]["window_s"] > 0


FAULTS = ["unchanged", "half_batch", "altered_rows"]


# at k = 8 too: `altered_rows` has to reach K10 and K11 at that width
@pytest.mark.parametrize("cell, fault",
                         [pytest.param("sage-reddit.maxk32", f, id=f) for f in FAULTS]
                         + [pytest.param("sage-reddit.maxk8", f, id=f"maxk8-{f}")
                            for f in FAULTS])
def test_each_fault_fails_the_check(cell, fault):
    res = run.run(cell, SEED, 0.0, True, device="cpu", fault=fault, sizes=TINY)
    assert not res["correct"]
    assert any(v["value"] is None or v["value"] > v["limit"] for v in res["checks"].values())


@pytest.mark.parametrize("nonlinear", ["maxk", "relu"])
def test_reference_matches_the_program_forward(nonlinear):
    from maxk_tpu_torch.train import loop
    from portbench import program

    cell = "sage-reddit.maxk32" if nonlinear == "maxk" else "sage-reddit.relu"
    _, traffic, config = registry.cell(cell)
    config = {**config, **TINY}
    ref = registry.reference(config)
    inputs = gen.make_inputs(config, ref.parameters(config), 3, "cpu")
    cfg = program.train_config(config, traffic, "cpu", 1)
    data = program.graph_data(config, inputs)
    state, _ = program.setup_state(cfg, data)
    state.model.load_state_dict(inputs.weights)
    with torch.no_grad():
        want = ref.forward(inputs.weights, ref.Graph(inputs.indptr, inputs.indices),
                           inputs.features, config, traffic)
        got = state.model(state.graph, inputs.features, train=False)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-5)
    assert isinstance(loop.dataset_metric(data), str)


def test_gaps_by_the_worst_leaf():
    ref = {"losses": [2.0, 1.0], "grad_norms": {"a": 1.0, "b": 2.0, "c": 4.0, "q": 1e-9},
           "changes": {"a": 1.0, "b": 1.0, "c": 1.0, "q": 5.0}, "correct": [[10, 5, 5]]}
    prog = {"losses": [2.0, 1.001], "grad_norms": {"a": 1.1, "b": 2.0, "c": 4.0, "q": 0.0},
            "changes": {"a": 1.0, "b": 1.02, "c": 1.0, "q": 0.0}, "correct": [[10, 7, 5]]}
    g = checks.gaps(prog, ref)
    assert g["loss_gap"] == pytest.approx(1e-3)
    assert g["grad_gap"] == pytest.approx(0.1 / 1.5)  # against the median leaf's 1.5
    assert g["update_gap"] == pytest.approx(0.02)  # q is quiet: left out
    assert g["eval_gap"] == 2
    ok, table = checks.judge(g, {"loss_gap": 1e-2, "grad_gap": 0.1, "update_gap": 0.1,
                                 "eval_gap": 1})
    assert not ok and table["eval_gap"] == {"value": 2, "limit": 1}
    g["loss_gap"] = math.nan
    assert not checks.judge(g, {n: 1e9 for n in checks.NUMBERS})[0]


def test_calibration_readings_separate():
    out = calibrate.readings("sage-reddit.maxk32", 5, "cpu", TINY)
    limits = registry.cell("sage-reddit.maxk32")[1]["limits"]
    assert checks.judge(out["sound"], limits)[0] and out["judged"]["sound"]
    for fault in ("unchanged", "half_batch", "altered_rows"):
        assert not checks.judge(out[fault], limits)[0], fault
        assert out["judged"][fault] is False, fault


def test_derive_sets_limits_between_the_readings_and_judges_each_variant():
    def line(seed, sound, control, unchanged):
        z = {"loss_gap": 0.0, "eval_gap": 0.0}
        return {"cell": "c", "seed": seed,
                "sound": {**z, "grad_gap": sound, "update_gap": sound},
                calibrate.CONTROL: {**z, "grad_gap": control, "update_gap": sound},
                "unchanged": {**z, "grad_gap": 1.0, "update_gap": unchanged},
                "half_batch": {**z, "grad_gap": 0.5, "update_gap": 0.5},
                "altered_rows": {**z, "grad_gap": 0.5, "update_gap": 0.5}}

    out = calibrate.derive([line(1, 1e-6, 1e-4, 1.0), line(2, 2e-6, 5e-5, 1.0)])["c"]
    g = out["grad_gap"]
    assert g["lower"] == 2e-6 and g["upper"] == 5e-5 and g["upper_from"] == calibrate.CONTROL
    assert g["lower"] < g["limit"] < g["upper"]
    assert out["loss_gap"]["limit"] is None  # no lower reading above 0: not compared
    assert out["judged"]["sound"] == {"correct": 2, "of": 2}
    assert out["judged"][calibrate.CONTROL] == {"correct": 0, "of": 2}
    assert out["judged"]["unchanged"] == {"correct": 0, "of": 2}
