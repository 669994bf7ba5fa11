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


# A name no planned cell or configuration takes: the leading `_` is outside
# every `<config>.<traffic>` name the benchmark plans.
PROBE = "_probe"


def _copy(tmp_path):
    """The benchmark's files in `tmp_path`, and its BENCHMARK.json as a dict."""
    shutil.copytree(registry.HERE, tmp_path / "portbench")
    return json.loads((registry.ROOT / "BENCHMARK.json").read_text())


def _add_cell(tmp_path, bench, config, source_cell):
    """A cell `<config>._probe` whose workload file copies `source_cell`'s."""
    cell = f"{config}.{PROBE}"
    assert cell not in {w["name"] for w in BENCH["workloads"]}
    bench["workloads"].append({"name": cell, "config": config, "traffic": PROBE,
                               "chips": 1, "why": "probe"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((registry.HERE / "workloads" / f"{source_cell}.json").read_text())
    traffic["config"] = config
    (tmp_path / "portbench" / "workloads" / f"{cell}.json").write_text(json.dumps(traffic))
    return cell


def _unlisted(kind):
    return {m["name"] for m in BENCH[kind] if "workloads" not in m}


def _repository_unchanged(cell):
    assert registry.benchmark() == BENCH
    with pytest.raises(KeyError):
        registry.cell(cell)


def test_new_cell_is_found_from_files_alone(tmp_path):
    bench = _copy(tmp_path)
    cell = _add_cell(tmp_path, bench, "sage-reddit", "sage-reddit.maxk8")
    entry, got, config = registry.cell(cell, root=tmp_path)
    assert entry["traffic"] == PROBE and got["maxk"] == 8 and config["name"] == "sage-reddit"
    # a cell that no metric's `workloads` lists reports the unlisted metrics
    for kind in ("end_to_end", "per_layer"):
        names = {m["name"] for m in registry.metrics(kind, cell, tmp_path)}
        assert names == _unlisted(kind), kind
    _repository_unchanged(cell)


def test_new_configuration_is_found_from_files_alone(tmp_path):
    bench = _copy(tmp_path)
    body = json.loads((registry.HERE / "configs" / "sage-reddit.json").read_text())
    body.update(name=PROBE, reference=PROBE)
    (tmp_path / "portbench" / "configs" / f"{PROBE}.json").write_text(json.dumps(body))
    shutil.copy(registry.HERE / "reference" / "sage.py",
                tmp_path / "portbench" / "reference" / f"{PROBE}.py")
    assert PROBE not in {c["name"] for c in BENCH["configs"]}
    bench["configs"].append({"name": PROBE, "source": body["source"],
                             "file": f"portbench/configs/{PROBE}.json", "reduced": [],
                             "why": "probe"})
    cell = _add_cell(tmp_path, bench, PROBE, "sage-reddit.maxk32")
    entry, traffic, config = registry.cell(cell, root=tmp_path)
    assert entry["config"] == config["name"] == traffic["config"] == PROBE
    ref = registry.reference(config, root=tmp_path)
    assert ref.__file__ == str(tmp_path / "portbench" / "reference" / f"{PROBE}.py")
    for fn in ("parameters", "model_flops", "follow"):
        assert callable(getattr(ref, fn))
    assert ref.parameters(config) == registry.reference(body | {"reference": "sage"}).parameters(
        config)
    names = {m["name"] for m in registry.metrics("per_layer", cell, tmp_path)}
    assert names == _unlisted("per_layer")
    _repository_unchanged(cell)
    with pytest.raises(FileNotFoundError):
        registry.reference(config)  # the repository holds no such reference
