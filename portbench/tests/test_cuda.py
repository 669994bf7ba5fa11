"""On the card, at a reddit shape cut to a test's size: the sound program
passes the check, and the control (the reference with TF32 on, the next
precision below the configuration's float32) and each planted fault fail it.
Run with `python -m pytest portbench/tests -q -m cuda`; skipped without a card."""

import pytest

from portbench import calibrate, checks, registry, run

# reddit's widths and degree (E/V 492), a fifth of its nodes
SMALL = {"num_nodes": 46593, "num_edges": 22_923_178}
SEEDS = (101, 2**31 + 102, 103)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["sage-reddit.maxk32", "sage-reddit.relu"])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_and_faults_fail_the_check(cuda, cell, seed):
    out = calibrate.readings(cell, seed, cuda, SMALL,
                             variants=("sound", "unchanged", "half_batch", "altered_rows"))
    limits = registry.cell(cell)[1]["limits"]
    assert checks.judge(out["sound"], limits)[0], out["sound"]
    for name in ("control_tf32", "unchanged", "half_batch", "altered_rows"):
        assert not checks.judge(out[name], limits)[0], (name, out[name])


@pytest.mark.cuda
def test_traced_run_on_the_card(cuda):
    res = run.run("sage-reddit.maxk32", 7, 0.0, True, device=cuda, sizes=SMALL)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert 0 < m["k9_roofline"]["value"] <= 100 and 0 < m["mfu"]["value"] <= 100
    assert m["spmm_ms_per_epoch"]["value"] > 0 and "device_idle_share" in m
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert res["device"]["platform"] == "gpu" and res["device"]["memory_peak_bytes"] > 0
