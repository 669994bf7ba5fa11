"""The port's campaign scripts (`maxk_tpu_torch.bench`: assemble_suite,
assemble_study, degree_sweep, ksweep, memcheck, spgemm_study, three_arms,
plots) against the JAX package's where both compute the same thing, on
the CPU at tiny sizes:

- assemble_suite / assemble_study: the same record JSON, made with numpy
  from a seed, gives the JAX package's `consistency`, `summary` and
  winner table key for key (the port adds cuSPARSE keys); planted defects
  are flagged alike;
- ksweep: a finished `json_out` resumes without training in both packages
  to the same summary (1e-12); a core-protocol mismatch exits 2 in both;
- memcheck: the exact byte fields equal the JAX package's at the same
  --v/--e/--k;
- spgemm_study, three_arms, degree_sweep, kernel_bench's cuSPARSE arm and
  plots run on `--device cpu`, validate and write the reference's keys.
"""

import contextlib
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from maxk_tpu.bench import assemble_study as j_study
from maxk_tpu.bench import assemble_suite as j_suite
from maxk_tpu.bench import ksweep as j_ksweep
from maxk_tpu.bench import memcheck as j_memcheck
from maxk_tpu_torch.bench import assemble_study, assemble_suite, degree_sweep, kernel_bench
from maxk_tpu_torch.bench import ksweep, memcheck, plots, spgemm_study, three_arms

torch.set_num_threads(1)
CPU = ["--device", "cpu"]


def _quiet(fn, *args):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        ret = fn(*args)
    return ret, out.getvalue()


@pytest.fixture
def jax_config_kept(monkeypatch):
    """Keep the test process's jax config: the JAX scripts point the
    compilation cache elsewhere."""
    update = jax.config.update
    monkeypatch.setattr(jax.config, "update", lambda k, v: None if "cache" in k else update(k, v))


def _suite_records(seed=0):
    """kernel_bench records of 4 graphs (2 each side of average degree 50)
    × k 8, 16 with consistent derived fields, and two dispatch checks."""
    rng = np.random.default_rng(seed)
    recs = []
    for gi, deg in enumerate((12, 30, 80, 200)):
        v = int(rng.integers(500, 5000))
        e = v * deg
        t_base, t_base16 = rng.uniform(5, 50, 2)
        t_cus, t_cus16 = rng.uniform(0.2, 3, 2)
        for k in (8, 16):
            t_fwd = float(rng.uniform(1, 40))
            recs.append({
                "graph": f"g{gi}", "V": v, "E": e, "k": k, "mode": "segsum",
                "t_fwd_ms": t_fwd, "t_fwd_bwd_ms": t_fwd * 2.5,
                "t_fwd_cbsr_ms": t_fwd * 1.2, "t_fwd_bwd_cbsr_ms": t_fwd * 2.9,
                "t_baseline_ms": t_base, "t_baseline_bf16_ms": t_base16,
                "fwd_gnnz_s": e / (t_fwd * 1e-3) / 1e9, "speedup_vs_baseline": t_base / t_fwd,
                "t_cusparse_ms": t_cus, "t_cusparse_bf16_ms": t_cus16,
                "speedup_vs_cusparse": t_cus / t_fwd, "valid": True,
            })
    checks = [{"kind": "dispatch_check", "graph": "g2", "picked": "hybrid", "alt": "segsum",
               "picked_faster": True},
              {"kind": "dispatch_check", "graph": "g3", "picked": "hybrid", "alt": "segsum",
               "picked_faster": False}]
    return recs, checks


def _run_both(tmp_path, records, mains=(j_suite.main, assemble_suite.main)):
    d = tmp_path / "recs"
    d.mkdir(exist_ok=True)
    for i in range(0, len(records), 4):
        (d / f"part{i:03d}.json").write_text(json.dumps(records[i:i + 4]))
    docs = []
    for tag, main in zip(("jax", "torch"), mains):
        out = tmp_path / f"{tag}.json"
        _quiet(main, ["--dir", str(d), "--out", str(out)])
        docs.append(json.loads(out.read_text()))
    return docs


def _assert_subset_equal(ref, got, path=""):
    """Every key of `ref` is in `got` with an equal value (dicts recursed)."""
    if isinstance(ref, dict):
        for key, value in ref.items():
            assert key in got, path + "/" + key
            _assert_subset_equal(value, got[key], path + "/" + key)
    else:
        assert got == ref, (path, got, ref)


def test_assemble_suite_matches_jax(tmp_path):
    recs, checks = _suite_records()
    ref, got = _run_both(tmp_path, recs + checks)
    assert ref["consistency"]["ok"] and got["consistency"]["ok"]
    _assert_subset_equal(ref["consistency"], got["consistency"])
    _assert_subset_equal(ref["summary"], got["summary"])
    assert set(got["summary"]) == set(ref["summary"]) and len(got["summary"]) == 4
    for key in ("validated", "dispatch_checks", "dispatch_picked_faster_everywhere"):
        assert got["protocol"][key] == ref["protocol"][key], key
    assert got["results"] == ref["results"]
    for row_key, row in got["summary"].items():
        rows = [r for r in recs if f"k={r['k']} " in row_key + " "
                and (r["E"] / r["V"] > 50) == (">" in row_key)]
        for tag, field in (("f32", "t_cusparse_ms"), ("bf16", "t_cusparse_bf16_ms")):
            gm = np.exp(np.mean([np.log(r[field] / r["t_fwd_ms"]) for r in rows]))
            assert row[f"geomean_speedup_{tag}_cusparse"] == round(float(gm), 3)
    assert set(got["protocol"]["baseline"]) == {"geomean_speedup_*_baseline",
                                                "geomean_speedup_*_cusparse"}


def test_assemble_suite_null_bf16_yardstick(tmp_path):
    """A record without a bf16 cuSPARSE time (the CPU) nulls its rows' bf16
    geomean and nothing else."""
    recs, _ = _suite_records(1)
    recs[0]["t_cusparse_bf16_ms"] = None
    got = _run_both(tmp_path, recs)[1]
    row = got["summary"][f"k={recs[0]['k']} avg_deg<=50"]
    assert row["geomean_speedup_bf16_cusparse"] is None
    assert row["geomean_speedup_f32_cusparse"] is not None and got["consistency"]["ok"]


def test_assemble_suite_flags_planted_defects(tmp_path):
    """A 1000× unit bug in fwd_gnnz_s and a forward + backward faster than
    the forward are flagged by both packages alike; a wrong
    speedup_vs_cusparse by the port alone."""
    recs, _ = _suite_records(2)
    recs[1] = dict(recs[1], fwd_gnnz_s=recs[1]["fwd_gnnz_s"] / 1000)
    recs[2] = dict(recs[2], t_fwd_bwd_ms=recs[2]["t_fwd_ms"] / 2)
    ref, got = _run_both(tmp_path, recs)
    assert not ref["consistency"]["ok"] and not got["consistency"]["ok"]
    assert got["consistency"]["violations"] == ref["consistency"]["violations"]
    assert {v["field"] for v in got["consistency"]["violations"]} == {"fwd_gnnz_s",
                                                                      "t_fwd_bwd_ms"}
    recs[3] = dict(recs[3], speedup_vs_cusparse=recs[3]["speedup_vs_cusparse"] * 2)
    ref, got = _run_both(tmp_path, recs)
    extra = [v for v in got["consistency"]["violations"]
             if v not in ref["consistency"]["violations"]]
    assert [(v["graph"], v["k"], v["field"]) for v in extra] == [
        (recs[3]["graph"], recs[3]["k"], "speedup_vs_cusparse")]


def test_assemble_study_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    d = tmp_path / "study"
    d.mkdir()
    for g in ("reddit", "flickr"):
        results = []
        for sp in (0.5, 0.25, 0.125, 0.0625):
            rec = {"sparsity": sp, "k": int(256 * sp), "flop": 1.0}
            for arm in assemble_study.ARMS:
                ms = rng.uniform(0.5, 20, 2)
                rec[arm] = {"numeric_ms": ms[0], "symbolic_ms": ms[1], "total_ms": ms.sum(),
                            "gflops": 1.0}
            results.append(rec)
        (d / f"{g}.json").write_text(json.dumps({"graph": g, "V": 100, "E": 1000,
                                                 "results": results}))
    (d / "broken.json").write_text("{not json")
    docs = []
    for tag, main in (("jax", j_study.main), ("torch", assemble_study.main)):
        out = tmp_path / f"{tag}.json"
        _quiet(main, ["--dir", str(d), "--out", str(out)])
        docs.append(json.loads(out.read_text()))
    assert docs[1] == docs[0] and len(docs[0]["winners"]) == 8


KSWEEP_ARGS = ["--datasets", "flickr", "reddit", "--models", "sage", "gcn", "--k", "4", "16",
               "--scale", "0.005", "--epochs", "3", "--hidden_dim", "16", "--hidden_layers", "2",
               "--kernel_mode", "segsum"]


def _ksweep_file(path, epochs=3):
    """A finished sweep's json_out: every arm of KSWEEP_ARGS done, measured
    at the ACC_PROTOCOL values, with numbers from a seed."""
    from maxk_tpu_torch.train.golden import ACC_PROTOCOL

    rng = np.random.default_rng(5)
    results = []
    for ds in ("flickr", "reddit"):
        proto = ACC_PROTOCOL[ds]
        for model in ("sage", "gcn"):
            for arm in ("relu", "relu_lib", "maxk_k4", "maxk_k16"):
                results.append({
                    "dataset": ds, "model": model, "arm": arm,
                    "best_val": round(float(rng.uniform(0.3, 0.9)), 4),
                    "best_test": round(float(rng.uniform(0.3, 0.9)), 4),
                    "epoch_ms": round(float(rng.uniform(5, 50)), 2),
                    "feat_snr": proto["feat_snr"], "lr": proto["lr"],
                    "p_intra": proto.get("p_intra", 0.8),
                })
    core = {"scale": 0.005, "epochs": epochs, "hidden_dim": 16, "hidden_layers": 2,
            "seed": 97, "graph_kind": "sbm", "kernel_mode": "segsum",
            "lib_mode": "tiles_scan", "compute_dtype": ""}
    path.write_text(json.dumps({"core_protocol": core, "results": results}))


def test_ksweep_resume_matches_jax(tmp_path, monkeypatch, jax_config_kept):
    """Both packages resume a finished sweep without training (their train
    is replaced by one that fails) to the same vs_relu table."""
    import maxk_tpu.train.loop as jloop
    import maxk_tpu_torch.train.loop as tloop

    def no_training(*a, **kw):
        raise AssertionError("an arm was trained on resume")

    monkeypatch.setattr(jloop, "train", no_training)
    monkeypatch.setattr(tloop, "train", no_training)
    docs = []
    for tag, main, extra in (("jax", j_ksweep.main, ["--platform", "cpu"]),
                             ("torch", ksweep.main, CPU)):
        path = tmp_path / f"{tag}.json"
        _ksweep_file(path)
        _, out = _quiet(main, KSWEEP_ARGS + extra + ["--json_out", str(path)])
        docs.append(json.loads(out.strip().splitlines()[-1]))
    ref, got = docs
    assert got["core_protocol"] == ref["core_protocol"]
    assert len(got["vs_relu"]) == len(ref["vs_relu"]) == 8
    for r, g in zip(ref["vs_relu"], got["vs_relu"]):
        assert set(g) == set(r)
        for key, value in r.items():
            if isinstance(value, float):
                assert g[key] == pytest.approx(value, rel=1e-12, abs=1e-12), key
            else:
                assert g[key] == value, key
    assert "upper bound" in got["protocol"]["relu_lib"]


def test_ksweep_trains_the_arm_triple():
    """The relu, relu_lib and maxk arms trained on the CPU, each record with
    its device beside its epoch time."""
    results, out = _quiet(ksweep.main, ["--datasets", "flickr", "--models", "sage", "--k", "4",
                                        "--scale", "0.005", "--epochs", "3", "--hidden_dim",
                                        "16", "--hidden_layers", "2", "--kernel_mode",
                                        "segsum"] + CPU)
    assert {r["arm"] for r in results} == {"relu", "relu_lib", "maxk_k4"}
    assert all(r["device"] == "cpu" and 0.0 <= r["best_test"] <= 1.0 for r in results)
    payload = json.loads(out.strip().splitlines()[-1])
    assert payload["protocol"]["graph_kind"] == "sbm"
    assert payload["protocol"]["feat_snr"] == "per-dataset (ACC_PROTOCOL)"
    row = payload["vs_relu"][0]
    assert row["arm"] == "maxk_k4" and {"acc_delta", "speedup_vs_lib_pct"} <= set(row)


def test_ksweep_refuses_a_core_protocol_mismatch(tmp_path, jax_config_kept):
    for main, extra in ((j_ksweep.main, ["--platform", "cpu"]), (ksweep.main, CPU)):
        path = tmp_path / "ks.json"
        _ksweep_file(path, epochs=5)
        with pytest.raises(SystemExit) as e:
            _quiet(main, KSWEEP_ARGS + extra + ["--json_out", str(path)])
        assert e.value.code == 2


# XLA's output size of a jitted value_and_grad adds a table of the 2-tuple's
# two 8-byte buffer pointers to the loss and the gradient
XLA_TUPLE_TABLE = 16


def test_memcheck_exact_bytes_match_jax(jax_config_kept):
    argv = ["--v", "1024", "--e", "8192", "--k", "8", "32", "--train_scale", "0.001"]
    ref, _ = _quiet(j_memcheck.main, argv)
    got, _ = _quiet(memcheck.main, argv + CPU)
    assert got["shapes"]["V"] == ref["shapes"]["V"] and got["shapes"]["D"] == ref["shapes"]["D"]
    assert got["shapes"]["E"] == ref["shapes"]["E"]
    ops = {r["arm"]: r for r in got["op_level"]}
    for r in ref["op_level"]:
        assert ops[r["arm"]]["output_bytes"] + XLA_TUPLE_TABLE == r["output_bytes"], r["arm"]
        assert ops[r["arm"]]["k"] == r["k"]
    assert [r["arm"] for r in got["train_step"]] == [r["arm"] for r in ref["train_step"]]
    assert ops["maxk_cbsr_k8"]["grad_bytes"] < ops["maxk_cbsr_k32"]["grad_bytes"] < \
        ops["masked_dense"]["grad_bytes"]
    assert not got["measured"]
    assert all(r["peak_bytes"] is None and r["measured"] is False
               for r in got["op_level"] + got["train_step"])
    assert "edge chunks" in ops["maxk_cbsr_k8"]["note"]


def test_spgemm_study_cpu():
    results, out = _quiet(spgemm_study.main, ["--graph", "flickr", "--scale", "0.002",
                                              "--mode", "segsum"] + CPU)
    assert len(results) == 4  # 4 sparsities
    payload = json.loads(out.strip().splitlines()[-1])
    assert payload["generator"] == "host rmat_graph" and payload["best_arm"]
    for rec in payload["results"]:
        assert rec["hybrid_mean_rel_err"] < 1e-3
        assert rec["flop"] == 2.0 * payload["E"] * rec["k"]
        for arm in ("segsum_topk", "dense_topk", "cbsr_fused", "hybrid_topk"):
            assert rec[arm]["gflops"] > 0 and rec[arm]["symbolic_ms"] > 0
            assert rec[arm]["total_ms"] == pytest.approx(
                sum(v for k, v in rec[arm].items() if k.endswith("_ms") and k != "total_ms"))
        assert rec["dense_topk"]["densify_ms"] > 0


def test_three_arms_cpu(tmp_path):
    out = tmp_path / "three.json"
    results, _ = _quiet(three_arms.main, ["--graphs", "flickr", "reddit", "--scale", "0.003",
                                          "--out", str(out)] + CPU)
    assert out.exists() and len(results) == 2
    for rec in results:
        for arm in ("tiles_scan", "hybrid", "bricks"):
            assert rec[f"{arm}_valid"] and rec[f"{arm}_ms"] > 0, arm
        assert rec["cusparse_ms"] > 0 and rec["cusparse_dtype"] == "float32"
    doc = json.loads(out.read_text())
    assert doc["protocol"]["generator"] == "host rmat_graph"
    assert doc["geomean_by_degree_class"]


def test_kernel_bench_records_the_cusparse_yardstick(capsys):
    recs = kernel_bench.main(["--graphs", "flickr", "--k", "8", "--scale", "0.002",
                              "--mode", "segsum", "--validate"] + CPU)
    rec = recs[0]
    assert rec["valid"] and rec["t_cusparse_ms"] > 0
    assert rec["speedup_vs_cusparse"] == pytest.approx(rec["t_cusparse_ms"] / rec["t_fwd_ms"],
                                                       rel=1e-12)
    # torch has no bf16 CSR product on the CPU
    assert rec["t_cusparse_bf16_ms"] is None and "bf16" in rec["cusparse_bf16_note"]
    lines = capsys.readouterr().out.splitlines()
    assert any(line.split()[-2:-1] == ["cusparse"] for line in lines)
    assert any(line.split()[-2:] == ["cusparse_bf16", "nan"] for line in lines)


def test_degree_sweep_cpu(tmp_path):
    """One tiny graph each side of average degree 50, one kernel_bench child
    each, assembled with the degree-50 split."""
    out = tmp_path / "sweep.json"
    doc = degree_sweep.main(["--graphs", "rmat_v1024_d20", "rmat_v1024_d160", "--k", "8",
                             "--dir", str(tmp_path / "d"), "--out", str(out),
                             "--timeout", "120"] + CPU)
    assert json.loads(out.read_text()) == doc
    assert "failed" not in doc and doc["protocol"]["generator"] == "host rmat_graph"
    assert doc["protocol"]["validated"]
    # the derived fields are exact; "fwd_bwd >= fwd" compares two host-clock
    # timings, which a loaded CPU may invert at this size
    derived = [v for v in doc["consistency"]["violations"] if "recomputed" in v]
    assert not derived, derived
    assert doc["protocol"]["dispatch_checks"] == 2
    assert set(doc["summary"]) == {"k=8 avg_deg>50", "k=8 avg_deg<=50"}
    assert all(r["t_cusparse_ms"] > 0 for r in doc["results"])


def test_degree_sweep_lists_a_failed_graph(tmp_path):
    """A child that fails costs itself only: it is listed under `failed`."""
    doc = degree_sweep.main(["--graphs", "no_such_graph", "--k", "8",
                             "--dir", str(tmp_path / "d"), "--out", str(tmp_path / "s.json"),
                             "--timeout", "60"] + CPU)
    assert doc["failed"] == [{"graph": "no_such_graph", "rc": 1}] and doc["results"] == []


def _plot_inputs():
    kb = [{"graph": g, "V": 100, "E": e, "k": k, "mode": m, "speedup_vs_baseline": s,
           "speedup_vs_cusparse": s / 20, "fwd_gnnz_s": 0.1 * s}
          for g, e, m, s in (("a", 10000, "hybrid", 3.0), ("b", 900, "segsum", 1.2))
          for k in (8, 32)]
    ks = {"results": [
        {"dataset": "flickr", "model": "sage", "arm": "relu", "best_test": 0.8, "epoch_ms": 100.0},
        {"dataset": "flickr", "model": "sage", "arm": "relu_lib", "best_test": 0.8,
         "epoch_ms": 150.0},
        {"dataset": "flickr", "model": "sage", "arm": "maxk_k8", "best_test": 0.75,
         "epoch_ms": 90.0},
        {"dataset": "flickr", "model": "sage", "arm": "maxk_k32", "best_test": 0.79,
         "epoch_ms": 95.0}]}
    sc = {"protocol": {"device": "cpu"}, "results": [
        {"arm": "maxk", "n": 1, "step_ms": 10.0}, {"arm": "maxk", "n": 2, "step_ms": 6.0}]}
    study = {"graph": "flickr", "V": 100, "E": 1000, "results": [
        {"sparsity": 0.5, "k": 128, "flop": 1.0,
         "segsum_topk": {"numeric_ms": 1.0, "symbolic_ms": 0.5, "total_ms": 1.5, "gflops": 1.0},
         "hybrid_topk": {"densify_ms": 0.2, "numeric_ms": 0.7, "symbolic_ms": 0.5,
                         "total_ms": 1.4, "gflops": 1.0}}]}
    three = {"results": [
        {"graph": "reddit", "tiles_scan_ms": 10.0, "hybrid_ms": 2.0, "bricks_ms": 14.0,
         "cusparse_ms": 0.5},
        {"graph": "flickr", "tiles_scan_ms": 1.0, "bricks_error": "SomeError: nope"}]}
    return {"kernel": kb, "degree": {"results": kb}, "ksweep": ks, "scaling": sc,
            "study": study, "three_arms": three}


@pytest.mark.parametrize("name", ["kernel_bench", "degree_sweep", "ksweep", "scaling",
                                  "spgemm_study", "spgemm_study_list", "three_arms",
                                  "training_curves"])
def test_plots_write_pngs(tmp_path, name):
    data = _plot_inputs()
    if name == "training_curves":
        path = tmp_path / "scalars.jsonl"
        path.write_text("".join(json.dumps({"tag": "val_acc", "step": i, "value": 0.1 * i}) + "\n"
                                for i in range(5)))
        png = plots.plot_training_curves(str(path), str(tmp_path))
    elif name == "spgemm_study_list":
        png = plots.plot_spgemm_study([data["study"], data["study"]], str(tmp_path))
    else:
        arg = {"kernel_bench": data["kernel"], "degree_sweep": data["degree"],
               "ksweep": data["ksweep"], "scaling": data["scaling"],
               "spgemm_study": data["study"], "three_arms": data["three_arms"]}[name]
        png = getattr(plots, f"plot_{name}")(arg, str(tmp_path))
    assert os.path.getsize(png) > 1000 and png.endswith(".png")


def test_plots_main_renders_every_input(tmp_path):
    data = _plot_inputs()
    args = []
    for key in ("kernel", "degree", "ksweep", "scaling", "study", "three_arms"):
        path = tmp_path / f"{key}.json"
        path.write_text(json.dumps({"results": data[key]} if key == "kernel" else data[key]))
        args += [f"--{key}", str(path)]
    paths, _ = _quiet(plots.main, args + ["--out", str(tmp_path / "figs")])
    assert len(paths) == 6 and all(os.path.getsize(p) > 1000 for p in paths)
