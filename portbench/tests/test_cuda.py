"""On the card, at a reddit shape cut to a test's size: the sound program
passes the check, and the control (the reference with TF32 on, the next
precision below the configuration's float32) and each planted fault fail it;
the same on four cards at a sixteenth of the papers100m cell.
Run with `python -m pytest portbench/tests -q -m cuda`; skipped without a card
(the four-card test without four)."""

import pytest
import torch

from portbench import calibrate, checks, ranks, registry, run

# reddit's widths and degree (E/V 492), a fifth of its nodes
SMALL = {"num_nodes": 46593, "num_edges": 22_923_178}
SEEDS = (101, 2**31 + 102, 103)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["sage-reddit.maxk32", "sage-reddit.relu", "sage-reddit.maxk8"])
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
    assert 0 < m["cbsr_pair_roofline"]["value"] <= 100 and 0 < m["mfu"]["value"] <= 100
    assert "k9_roofline" not in m  # K9 does not run in a MaxK cell
    assert m["spmm_ms_per_epoch"]["value"] > 0 and "device_idle_share" in m
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert res["device"]["platform"] == "gpu" and res["device"]["memory_peak_bytes"] > 0


# papers100m's widths and degree (E/V 29.1) at a sixteenth of its nodes
PAPERS_SMALL = {"num_nodes": 867_655, "num_edges": 25_245_092}


@pytest.mark.cuda
def test_four_card_control_and_faults_fail_the_check(cuda):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    cell = "sage-papers100m.maxk32"
    job = {"cell": cell, "seeds": list(SEEDS), "variants": calibrate.variants_of(4),
           "details": False, "sizes": PAPERS_SMALL, "out": ""}
    lines = ranks.spawn(calibrate.sharded_readings, 4, job, "cuda", 1500)[0]
    limits = registry.cell(cell)[1]["limits"]
    assert len(lines) == len(SEEDS)
    for out in lines:
        assert checks.judge(out["sound"], limits)[0], out["sound"]
        for name in ("control_tf32", "unchanged", "half_batch", "altered_rows", "no_exchange"):
            assert not checks.judge(out[name], limits)[0], (name, out[name])
