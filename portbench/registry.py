"""Finds a cell's files by the names in `BENCHMARK.json`.

A cell (`workloads/<cell>.json`) names its configuration and holds its
traffic parameters and limits; a configuration (`configs/<config>.json`, the
file `BENCHMARK.json` gives) holds the model and graph sizes and names its
plain reference (`reference/<name>.py`); a per-layer metric is read by
`metrics/<metric>.py`'s `read(record)`. Adding any of them is adding files
and entries: no code here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(name: str, root: Path = ROOT) -> tuple:
    """(BENCHMARK.json's entry, the workload file, the configuration file)
    of the cell `name`."""
    bench = benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: {sorted(entries)}")
    entry = entries[name]
    traffic = json.loads((root / "portbench" / "workloads" / f"{name}.json").read_text())
    if traffic["config"] != entry["config"]:
        raise ValueError(f"{name}: BENCHMARK.json names config {entry['config']!r}, "
                         f"the workload file {traffic['config']!r}")
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[entry["config"]]["file"]).read_text())
    return entry, traffic, config


def metrics(kind: str, cell_name: str, root: Path = ROOT) -> list:
    """The `end_to_end` or `per_layer` entries that the cell reports."""
    return [m for m in benchmark(root)[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


def _load(path: Path):
    """The module of a file, loaded by path: a name may hold `.` and `-`."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} does not exist")
    name = "portbench._by_path." + "".join(c if c.isalnum() else "_" for c in
                                           str(path.relative_to(path.parents[1])))
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference(config: dict, root: Path = ROOT):
    """The plain reference module that the configuration names."""
    return _load(root / "portbench" / "reference" / f"{config['reference']}.py")


def reader(metric: str):
    """The module whose `read(record)` gives the per-layer metric."""
    return _load(HERE / "metrics" / f"{metric}.py")
