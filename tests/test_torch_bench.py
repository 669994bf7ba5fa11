"""The port's benchmark entry points (maxk_tpu_torch/bench/) and the plain
versions of the gather kernels K6-K8 (ops/gather_cuda.py), on the CPU.

K6 and K7 compute `jnp.take(slab, idx, axis=0)` and K8
`jnp.take_along_axis(x, idx, axis=1)` (the reference's probe checks K8's
Pallas body against the same function): the plain versions must equal them
bit for bit. The entry points run at tiny sizes with `--device cpu`, where
every kernel wrapper takes its plain version."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxk_tpu_torch.bench import (ablate_bricks, ablate_csr, ablate_mask_gather,
                                  ablate_topk_sample, kernel_bench, micro, probe_bricks,
                                  probe_hybrid, probe_int8, probe_topk)
from maxk_tpu_torch.ops import gather_cuda
from maxk_tpu_torch.ops.dispatch import resolve_mode

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
TINY = ["--graphs", "flickr", "--k", "8", "--scale", "0.002", "--validate"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,d,n", [(64, 32, 1000), (300, 48, 77), (1, 16, 5), (512, 256, 300)])
def test_row_gather_plain_is_jnp_take(s, d, n, dtype):
    rng = np.random.default_rng(s + n)
    table = rng.standard_normal((s, d)).astype(np.float32)
    idx = rng.integers(0, s, n).astype(np.int32)
    ref = jnp.take(jnp.asarray(table, getattr(jnp, dtype)), jnp.asarray(idx), axis=0)
    t = torch.from_numpy(table).to(getattr(torch, dtype))
    i = torch.from_numpy(idx)
    for fn in (gather_cuda.gather_rows_plain, gather_cuda.slab_gather, gather_cuda.dma_gather):
        got = fn(t, i)
        assert got.dtype == t.dtype
        assert np.array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,d,k", [(256, 256, 32), (37, 64, 5), (8, 16, 16)])
def test_take_along_rows_plain_is_jnp_take_along_axis(r, d, k, dtype):
    rng = np.random.default_rng(r + k)
    x = rng.standard_normal((r, d)).astype(np.float32)
    idx = rng.integers(0, d, (r, k)).astype(np.int32)
    ref = jnp.take_along_axis(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(idx), axis=1)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    for fn in (gather_cuda.take_along_rows_plain, gather_cuda.take_along_rows):
        got = fn(xt, torch.from_numpy(idx))
        assert np.array_equal(np.asarray(got.float()), np.asarray(ref.astype(jnp.float32)))


def test_out_of_range_indices_give_zeros():
    table = torch.randn(10, 8)
    got = gather_cuda.gather_rows_plain(table, torch.tensor([3, -1, 10, 9], dtype=torch.int32))
    assert torch.equal(got[0], table[3]) and torch.equal(got[3], table[9])
    assert torch.equal(got[1:3], torch.zeros(2, 8))
    idx = torch.tensor([[0, 8, -2]] * 10, dtype=torch.int32)
    rows = gather_cuda.take_along_rows_plain(table, idx)
    assert torch.equal(rows[:, 0], table[:, 0]) and not rows[:, 1:].any()


def test_bench_entry_prints_one_json_line():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "maxk_tpu_torch.bench", "--device", "cpu", "--scale", "0.002"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert len(lines) == 1, proc.stdout
    rec = json.loads(lines[0])
    # the keys of the record the root bench.py prints
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
    assert rec["unit"] == "Gnnz/s" and rec["value"] > 0
    assert rec["metric"] == "spmm_maxk fwd nnz/s (reddit x0.002, k=32, segsum, cpu)"
    assert "maxk fwd+bwd" in proc.stderr


def test_kernel_bench_records_have_the_reference_keys(monkeypatch, capsys):
    from maxk_tpu.bench import kernel_bench as jax_kernel_bench

    got = kernel_bench.main(["--device", "cpu", *TINY])
    out = capsys.readouterr().out.splitlines()
    # keep the test process's jax config: the reference's main points the
    # compilation cache elsewhere
    update = jax.config.update
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: None if "cache" in k else update(k, v))
    ref = jax_kernel_bench.main(["--platform", "cpu", "--mode", "segsum", *TINY])
    assert len(got) == len(ref) == 1
    # the reference's keys, and the cuSPARSE yardstick's beside them
    assert set(got[0]) == set(ref[0]) | {"t_cusparse_ms", "t_cusparse_bf16_ms",
                                         "speedup_vs_cusparse", "cusparse_bf16_note"}
    assert got[0]["valid"] and got[0]["cbsr_val_dtype"] == "float32"
    assert set(got[0]["validation"]) == set(ref[0]["validation"])
    assert (got[0]["V"], got[0]["k"], got[0]["mode"]) == (ref[0]["V"], 8, "segsum")
    assert [line.split()[:5] for line in out] == [
        ["0", "flickr", "256", "-", "cusparse_role"],
        ["0", "flickr", "256", "-", "cusparse_role_bf16"],
        ["0", "flickr", "256", "-", "cusparse"],
        ["0", "flickr", "256", "-", "cusparse_bf16"],
        *[["0", "flickr", "256", "8", arm] for arm in
          ("maxk_mask", "maxk_fwd", "maxk_fwd_bwd", "maxk_fwd_cbsr", "maxk_fwd_bwd_cbsr")],
    ]


def test_kernel_bench_io_bf16_and_json_out(tmp_path):
    path = tmp_path / "suite.json"
    recs = kernel_bench.main(["--device", "cpu", *TINY, "--io_itemsize", "2",
                              "--json_out", str(path)])
    assert recs[0]["cbsr_val_dtype"] == recs[0]["mask_dtype"] == "bfloat16"
    assert recs[0]["bwd_grad_bytes_cbsr"] == recs[0]["V"] * 8 * 2
    assert json.loads(path.read_text()) == recs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_probe_bricks_validates_on_cpu(dtype):
    out = probe_bricks.main(["--device", "cpu", "--v", "700", "--e", "9000", "--dim", "64",
                             "--dtype", dtype])
    assert out["max_abs"] / out["ref_scale"] <= out["max_rel_tol"]
    assert out["stats"]["live_edges"] == out["stats"]["slots"] * out["stats"]["fill"]
    # the product's rate and the time's share of the function's bound
    assert out["product_tflop_per_s"] > 0 and out["bound_by"] == "bytes"
    assert out["bound_share"] == out["bound_ms"] / (1e3 * out["bricks_s"])
    assert 0 < out["heaviest_block_share"] <= 1
    # the library call in the features' dtype: timed, or the library's own
    # refusal (the CPU build has no bf16 CSR product)
    if out["library_s"] is None:
        assert dtype == "bfloat16" and "BFloat16" in out["library_error"]
    else:
        assert out["library_s"] > 0 and "library_error" not in out


def test_probe_topk_validates_on_cpu():
    t = probe_topk.main(["--device", "cpu", "--v", "600", "--d", "64", "--k", "8"])
    assert set(t) == {"torch_topk", "topk_cbsr", "maxk_mask", "mask_fwd_bwd",
                      "take_along_rows_256", "take_along_rows_all"}
    assert all(s > 0 for s in t.values())


def test_micro_benchmarks_run_on_cpu(capsys):
    cpu = dict(device="cpu")
    micro.bench_plain_gather(500, 32, 2000, **cpu)
    micro.bench_slab_gather(64, 32, 2000, **cpu)
    micro.bench_dma_gather(500, 32, 2000, **cpu)
    micro.bench_onehot_gather(64, 32, 4096, block=1024, **cpu)
    micro.bench_topk(300, 64, 8, **cpu)
    micro.bench_segment_sum(100, 32, 3000, **cpu)
    lines = capsys.readouterr().out.splitlines()
    assert [line[:2] for line in lines] == ["A.", "B.", "C.", "D.", "E.", "  ", "F."]


def test_timeit_uses_the_host_clock_on_cpu():
    assert micro.timeit(torch.mm, torch.randn(32, 32), torch.randn(32, 32), iters=3) > 0


def test_pallas_mode_refuses_with_the_reference_reason():
    with pytest.raises(NotImplementedError) as e:
        resolve_mode("pallas")
    msg = str(e.value)
    assert "no production kernel" in msg
    assert "ops.spmm_bricks.spmm_bricks" in msg and "bench.probe_bricks" in msg


@pytest.mark.parametrize("entry", ["bench", "kernel_bench", "micro", "probe_topk", "probe_bricks",
                                   "ablate_bricks", "ablate_mask_gather", "ablate_topk_sample",
                                   "ablate_csr", "probe_hybrid", "probe_int8", "degree_sweep", "ksweep",
                                   "memcheck", "spgemm_study", "three_arms", "scaling"])
def test_entry_points_default_to_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from maxk_tpu_torch.bench import (
        bench,
        degree_sweep,
        ksweep,
        memcheck,
        scaling,
        spgemm_study,
        three_arms,
    )

    main = {"bench": bench.main, "kernel_bench": kernel_bench.main, "micro": micro.main,
            "probe_topk": probe_topk.main, "probe_bricks": probe_bricks.main,
            "ablate_bricks": ablate_bricks.main, "ablate_mask_gather": ablate_mask_gather.main,
            "ablate_topk_sample": ablate_topk_sample.main, "ablate_csr": ablate_csr.main,
            "probe_hybrid": probe_hybrid.main,
            "probe_int8": probe_int8.main, "degree_sweep": degree_sweep.main,
            "ksweep": ksweep.main, "memcheck": memcheck.main, "spgemm_study": spgemm_study.main,
            "three_arms": three_arms.main, "scaling": scaling.main}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])


@pytest.mark.parametrize("edits", ["K9_EDITS", "K10_EDITS"])
def test_ablate_csr_edits_apply_to_the_kernel_source(edits):
    """Every text edit of the CSR kernels' probe names text that stands in
    `csrc/spmm_csr.cu` and changes it (a rewrite that drops a line makes
    the probe raise on the card; this finds it on the CPU)."""
    from maxk_tpu_torch.ops import _native

    src = (_native.CSRC / "spmm_csr.cu").read_text()
    for name, pairs in getattr(ablate_csr, edits).items():
        out = ablate_csr.edited("test", name, src, pairs)
        assert (out != src) == bool(pairs), name


def test_probe_bricks_tiles_arm_on_cpu():
    """`probe_bricks --tiles`: spmm_tiles_scan over the device-built tile
    tables, beside the brick kernel, within 1e-5 of segsum relative to
    max|ref| (f32 sums in another order)."""
    out = probe_bricks.main(["--device", "cpu", "--v", "700", "--e", "9000", "--dim", "64",
                             "--tiles"])
    assert out["tiles_num"] > 0 and out["tiles_scan_s"] > 0 and out["tiles_build_s"] > 0
    assert out["tiles_max_rel"] <= 1e-5


@pytest.mark.parametrize("mode", ["tiles_xla", "tiles_scan"])
def test_kernel_bench_and_bench_take_the_tile_modes(mode, capsys):
    """`kernel_bench --mode tiles_*` validates against the plain path; on the
    CPU its library arm stays segsum. `python -m maxk_tpu_torch.bench --mode
    tiles_*` prints its one record."""
    from maxk_tpu_torch.bench import bench

    recs = kernel_bench.main(["--device", "cpu", *TINY, "--mode", mode])
    assert len(recs) == 1 and recs[0]["valid"]
    assert (recs[0]["mode"], recs[0]["base_mode"]) == (mode, "segsum")
    rec = bench.main(["--device", "cpu", "--scale", "0.002", "--mode", mode])
    assert rec["metric"] == f"spmm_maxk fwd nnz/s (reddit x0.002, k=32, {mode}, cpu)"
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == rec


@pytest.mark.parametrize("mode", ["hybrid", "hybrid_int8"])
def test_kernel_bench_and_bench_take_the_hybrid_modes(mode, capsys):
    """`kernel_bench --mode hybrid|hybrid_int8` validates against the plain
    path over the permuted graph and writes the strip it built: its dtype,
    width, tail, and whether the features were int8; the lossy mode's
    validation takes its quantization bound on top of the exact tolerance
    and writes both. `bench --mode hybrid*` adds the schedule to its one
    record."""
    from maxk_tpu_torch.bench import bench

    recs = kernel_bench.main(["--device", "cpu", *TINY, "--mode", mode])
    rec = recs[0]
    assert len(recs) == 1 and rec["valid"] and rec["mode"] == mode
    assert (rec["strip_dtype"], rec["strip_cols"], rec["tail_band_cols"]) == ("int8", 128, 0)
    assert rec["feat_int8"] == (mode == "hybrid_int8") and rec["tail_tiles"] > 0
    lossy = rec["validation"].get("lossy_bound")
    if mode == "hybrid_int8":
        assert 0 < lossy and rec["validation"]["tol"] == 1e-3 + lossy
    else:
        assert lossy is None and "tol" not in rec["validation"]
    bf16_strip = ["--device", "cpu", *TINY, "--mode", mode, "--strip_dtype", "bfloat16",
                  "--tail_band_cols", "128"]
    if mode == "hybrid_int8":  # int8 features need an integer strip
        with pytest.raises(ValueError, match="requires an integer strip"):
            kernel_bench.main(bf16_strip)
    else:
        recs = kernel_bench.main(bf16_strip)
        assert recs[0]["valid"] and recs[0]["strip_dtype"] == "bfloat16"
    capsys.readouterr()
    out = bench.main(["--device", "cpu", "--scale", "0.002", "--mode", mode])
    assert out["metric"] == f"spmm_maxk fwd nnz/s (reddit x0.002, k=32, {mode}, cpu)"
    assert out["schedule"]["strip_dtype"] == "int8"
    assert out["schedule"]["feat_int8"] == (mode == "hybrid_int8")
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out


def test_kernel_bench_dispatch_check_times_the_other_arm():
    recs = kernel_bench.main(["--device", "cpu", *TINY, "--mode", "hybrid", "--dispatch_check"])
    check = recs[-1]
    assert check["kind"] == "dispatch_check" and (check["picked"], check["alt"]) == \
        ("hybrid", "segsum")
    assert check["t_fwd_alt_ms"] > 0 and check["t_fwd_picked_ms"] == recs[0]["t_fwd_ms"]


def test_probe_hybrid_and_probe_int8_on_cpu():
    """probe_hybrid validates the hybrid (int8 strip, tail in 32-edge tiles)
    and its lossy int8-feature arm against the tile scan and times every
    arm; probe_int8's four parts run, its quantization error within half a
    step of each column's absmax / 127."""
    out = probe_hybrid.main(["--device", "cpu", "--scale", "0.003", "--s", "256", "--dtype",
                             "int8", "--feat_int8", "--tail_chunks", "64", "--dim", "64"])
    assert out["s_cols"] == 256 and out["max_rel"] <= 2e-2 and out["mean_rel"] <= 1e-3
    assert 0 < out["int8_max_abs"] <= out["int8_bound"] + 1e-5
    assert len(out["tail_ms"]) == 2 and "chunk64_chunk_window64" in out["tail_ms"]
    res = probe_int8.main(["--device", "cpu", "--v", "2048", "--s", "256", "--d", "64"])
    assert res["bf16_ms"] > 0 and res["int8_ms"] > 0 and res["int8_e2e_ms"] > 0
    # half a step of a column's absmax / 127; the normal draws stay under 6
    assert 0 < res["quant_abs_err_max"] <= 6.0 / 127 / 2
