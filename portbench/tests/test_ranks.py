"""The four-card cell's harness on CPU ranks (gloo) at a tiny size: whole
runs through the program's row-partitioned path against the row-partitioned
reference, each fault that such a cell can have failing the check, the row
reference against the one-card reference, and the collectives' byte counter
against the program's byte model."""

import math

import pytest
import torch

from portbench import ranks, registry, run
from portbench.tests.conftest import TINY

CELL = "sage-papers100m.maxk32"
SEED = 2**31 + 4343
# papers100m's degree (E/V 29) at the tiny cell's size
ROWS = {**TINY, "num_edges": 44000}


def _config(sizes):
    return {**registry.cell(CELL)[2], **sizes}


@pytest.mark.parametrize("world", [2, 4])
def test_sound_run_is_correct(world):
    res = run.run(CELL, SEED, 1.0, False, device="cpu", sizes=ROWS, world=world)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 2
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(res["metrics"]) == {m["name"] for m in registry.metrics("end_to_end", CELL)}
    assert res["device"]["count"] == world and res["device"]["platform"] == "cpu"
    for name, v in res["checks"].items():
        assert v["value"] <= v["limit"] / 10, name


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered_rows", "no_exchange"])
def test_each_fault_fails_the_check(fault):
    res = run.run(CELL, SEED, 0.0, False, device="cpu", fault=fault, sizes=ROWS, world=2)
    assert not res["correct"]
    assert any(v["value"] is None or v["value"] > v["limit"] for v in res["checks"].values())


def rows_follow(mesh, job):
    """The row reference's readings on this rank (a spawned rank's body)."""
    from portbench import gen

    config = _config(job["sizes"])
    ref = registry.reference(config)
    traffic = registry.cell(CELL)[1]
    inputs = gen.make_inputs(config, ref.parameters(config), job["seed"], "cpu")
    return ref.follow(inputs, config, traffic, 5, 3, mesh.rank, mesh.world_size)


@pytest.mark.parametrize("world", [2, 4])
def test_row_reference_matches_the_one_card_reference(world):
    # dropout off: the ranks draw their masks from their own streams
    sizes = {**ROWS, "dropout": 0.0}
    config = _config(sizes)
    from portbench import gen

    one = registry.reference({"reference": "sage"})
    inputs = gen.make_inputs(config, one.parameters(config), SEED, "cpu")
    want = one.follow(inputs, config, registry.cell(CELL)[1], 5, 3)
    got = ranks.spawn(rows_follow, world, {"sizes": sizes, "seed": SEED}, "cpu", 300)
    assert all(g == got[0] for g in got[1:])  # every rank reads the same
    got = got[0]
    assert got["losses"] == pytest.approx(want["losses"], rel=1e-5)
    for key in ("grad_norms", "changes"):
        for name, v in want[key].items():
            assert got[key][name] == pytest.approx(v, rel=1e-4, abs=1e-7), (key, name)
    for a, b in zip(got["correct"], want["correct"]):
        assert all(abs(x - y) <= 1 for x, y in zip(a, b))


@pytest.mark.parametrize("world", [2, 4])
def test_comm_recv_counter_equals_the_byte_model(world):
    from maxk_tpu_torch.parallel.audit import model_recv_bytes_fwd_bwd

    res = run.run(CELL, SEED, 0.0, True, device="cpu", sizes=ROWS, world=world)
    assert res["correct"], res["checks"]
    config = _config(ROWS)
    traffic = registry.cell(CELL)[1]
    vp = -(-config["num_nodes"] // world) * world
    d, k, layers = config["hidden_dim"], traffic["maxk"], config["hidden_layers"]
    r = (world - 1) / world
    train = layers * model_recv_bytes_fwd_bwd("maxk", world, vp, d, k)
    evaluation = layers * r * vp * k * (4 + 4)  # the CBSR's all_gathers alone
    params = sum(math.prod(s) for _, s, _ in registry.reference(config).parameters(config))
    # the train mask's count, the gradients in one flat buffer, the loss; the
    # evaluation's (3 masks × 2) sums
    reduces = 2 * r * 4 * (1 + params + 1) + 2 * r * 4 * 6
    assert res["metrics"]["comm_recv_gb"]["value"] * 1e9 == pytest.approx(
        train + evaluation + reduces, abs=1e-3)
    assert {"train_step_ms", "eval_ms", "mfu", "build_graph_s"} <= set(res["metrics"])
    assert res["device"]["count"] == world and res["attempted"] == traffic["trace_epochs"]


def test_fingerprint_tells_inputs_apart():
    from portbench import gen

    config = _config(ROWS)
    params = registry.reference(config).parameters(config)
    a = gen.make_inputs(config, params, 1, "cpu")
    b = gen.make_inputs(config, params, 1, "cpu")
    c = gen.make_inputs(config, params, 2, "cpu")
    assert torch.equal(ranks._fingerprint(a), ranks._fingerprint(b))
    assert not torch.equal(ranks._fingerprint(a), ranks._fingerprint(c))


def test_a_failing_rank_ends_the_run():
    with pytest.raises(RuntimeError, match="failed"):
        ranks.spawn(_raise_on_rank_1, 2, {}, "cpu", 120)


def _raise_on_rank_1(mesh, job):
    if mesh.rank == 1:
        raise ValueError("planted")
    torch.distributed.barrier()  # rank 0 waits for a rank that never comes
    return {}


def test_calibration_readings_separate_on_ranks():
    from portbench import calibrate

    job = {"cell": CELL, "seeds": [SEED], "variants": calibrate.variants_of(4),
           "details": False, "sizes": ROWS, "out": ""}
    lines = ranks.spawn(calibrate.sharded_readings, 2, job, "cpu", 300)
    assert lines[1] == [] and len(lines[0]) == 1
    out = lines[0][0]
    assert out["judged"]["sound"] and out["sound"]["grad_gap"] < 1e-5
    for fault in ("unchanged", "half_batch", "altered_rows", "no_exchange"):
        assert out["judged"][fault] is False, (fault, out[fault])
