"""The harness finds every cell, configuration, reference and metric by name
from files alone, and BENCHMARK.json keeps to the benchmark's contract."""

import json
import re
import shutil

import pytest

from portbench import checks, registry

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][:3] == ["python3", "-m", "portbench.run"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    entry, traffic, config = registry.cell(cell)
    assert NAME.match(cell) and NAME.match(entry["traffic"]) and NAME.match(entry["config"])
    assert cell == f"{entry['config']}.{entry['traffic']}"
    assert entry["chips"] in (1, 4) and 1 <= len(entry["why"]) <= 200
    assert config["name"] == entry["config"]
    ref = registry.reference(config)
    for fn in ("parameters", "model_flops", "follow"):
        assert callable(getattr(ref, fn))
    assert traffic["limits"] and set(traffic["limits"]) <= set(checks.NUMBERS)
    assert all(v > 0 for v in traffic["limits"].values())
    reported = {m["name"] for m in registry.metrics("end_to_end", cell)}
    assert {"setup_s", "epoch_ms"} <= reported
    assert registry.metrics("per_layer", cell)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"].startswith("portbench/configs/")
    body = json.loads((registry.ROOT / config["file"]).read_text())
    assert body["source"] == config["source"] and len(config["source"]) <= 200
    assert config["reduced"] == body["reduced"]
    assert all(NAME.match(k) and k in body for k in config["reduced"])
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


def test_four_card_cells_within_a_quarter():
    four = [w["name"] for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)


def test_papers100m_cut_keeps_the_shape():
    body = registry.cell("sage-papers100m.maxk32")[2]
    published = body["deployment"]["published"]
    assert body["num_nodes"] == published["num_nodes"] // 8
    assert body["num_edges"] * 8 == published["num_edges"] and body["num_edges"] % 2 == 0
    assert body["num_edges"] / body["num_nodes"] == pytest.approx(
        published["num_edges"] / published["num_nodes"], rel=1e-6)
    assert (body["hidden_dim"], body["feat_dim"], body["num_classes"]) == (256, 128, 172)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metrics(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher") and metric["source"] in SOURCES
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert callable(registry.reader(metric["name"]).read)
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_setup_bound():
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] == 0.25


def test_new_cell_is_found_from_files_alone(tmp_path):
    shutil.copytree(registry.HERE, tmp_path / "portbench")
    bench = json.loads((registry.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "sage-reddit.maxk8", "config": "sage-reddit",
                               "traffic": "maxk8", "chips": 1, "why": "k = 8"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((registry.HERE / "workloads" / "sage-reddit.maxk32.json").read_text())
    traffic["maxk"] = 8
    (tmp_path / "portbench" / "workloads" / "sage-reddit.maxk8.json").write_text(
        json.dumps(traffic))
    entry, got, config = registry.cell("sage-reddit.maxk8", root=tmp_path)
    assert got["maxk"] == 8 and config["name"] == "sage-reddit"
    names = {m["name"] for m in registry.metrics("per_layer", "sage-reddit.maxk8", tmp_path)}
    assert {"train_step_ms", "mfu", "device_idle_share"} <= names
    assert "k9_roofline" not in names  # listed for its own cells only
    with pytest.raises(KeyError):
        registry.cell("sage-reddit.maxk8")  # the repository's benchmark is unchanged
