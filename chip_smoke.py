#!/usr/bin/env python3
"""On-card check of the maxk_tpu_torch port, on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from `maxk_tpu_torch/csrc/`, holds each against
its plain PyTorch version at the main path's shapes, runs the op
`maxk_spgemm` on full-scale synthetic reddit against its plain path, then
trains MaxK-SAGE (4×256, k=32, dropout 0.5, lr 0.01 — the reference's
reddit launch) on full-scale synthetic reddit for 10 epochs through the
port's `train()`. Each phase prints one JSON line; every failure exits
non-zero with no `ok` line. The last three lines are the kernels record,
the card's `nvidia-smi` name and power limit, and the `ok` line.

float32 matrix products and convolutions run in full float32 here: TF32 is
switched off for both.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
DIM, K, LAYERS, EPOCHS = 256, 32, 4, 10
TIMED = 20  # launches per kernel timing


class SmokeFailure(Exception):
    pass


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of `fn()` over `iters` runs, by CUDA events, after
    one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def phase_identity():
    import torch

    smi = nvidia_smi()
    emit("identity", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         python=sys.version.split()[0])
    return smi


def phase_build():
    from maxk_tpu_torch.ops import _native

    t0 = time.perf_counter()
    path = _native.build()
    _native.library()
    emit("build", seconds=time.perf_counter() - t0, library=str(path.relative_to(HERE)))


def _mask_input(v: int, dtype, gen):
    """(v, DIM) normal values with tie rows: small integers, one -0.0
    among +0.0s, a constant row and an all-negative row."""
    import torch

    x = torch.randn((v, DIM), generator=gen, device="cuda")
    x[:64] = torch.randint(-3, 4, (64, DIM), generator=gen, device="cuda").float()
    x[64] = 0.0
    x[64, 0] = -0.0
    x[65] = 1.0
    x[66] = -x[66].abs() - 1.0
    return x.to(dtype)


def phase_kernels(v: int):
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from maxk_tpu_torch.ops import cbsr_cuda, topk_cuda

    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[-1]
        x = _mask_input(v, dtype, gen)
        y, take = topk_cuda.maxk_mask_cuda(x, K)
        y0, take0 = topk_cuda.maxk_mask_plain(x, K)
        torch.cuda.synchronize()
        err = (y.float() - y0.float()).abs().max().item()
        exact = torch.equal(y, y0) and torch.equal(take, take0)
        k_each = bool((take.sum(1) == K).all())
        ms = cuda_ms(lambda: topk_cuda.maxk_mask_cuda(x, K), TIMED)
        plain = cuda_ms(lambda: topk_cuda.maxk_mask_plain(x, K), TIMED)
        emit("kernel", name="maxk_mask", dtype=tag, shape=[v, DIM], k=K, exact=exact,
             exactly_k=k_each, max_abs_err=err, ms=ms, plain_ms=plain)
        require(exact and k_each, f"maxk_mask {tag}: y/take differ from the plain version")
        res[("maxk_mask", tag)] = (err, ms, plain)

        vals = torch.randn((v, K), generator=gen, device="cuda").to(dtype)
        sel = torch.randint(0, DIM, (v, K), generator=gen, device="cuda", dtype=torch.int32)
        out = cbsr_cuda.densify_cuda(vals, sel, DIM)
        ref = cbsr_cuda.densify_plain(vals, sel, DIM)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        # duplicates sum in another order in the plain version (atomics);
        # in bf16 that may move the one rounding by one ulp (2^-7 relative)
        rtol = 1e-6 if dtype == torch.float32 else 2.0**-7
        ok = torch.allclose(out.float(), ref.float(), rtol=rtol, atol=1e-6)
        ms = cuda_ms(lambda: cbsr_cuda.densify_cuda(vals, sel, DIM), TIMED)
        plain = cuda_ms(lambda: cbsr_cuda.densify_plain(vals, sel, DIM), TIMED)
        emit("kernel", name="cbsr_densify", dtype=tag, shape=[v, K], dim=DIM, rtol=rtol,
             atol=1e-6, ok=ok, max_abs_err=err, ms=ms, plain_ms=plain)
        require(ok, f"cbsr_densify {tag}: differs from the plain version beyond rtol {rtol}")
        res[("cbsr_densify", tag)] = (err, ms, plain)

        z = torch.randn((v, DIM), generator=gen, device="cuda").to(dtype)
        out = cbsr_cuda.sample_cuda(z, sel)
        ref = cbsr_cuda.sample_plain(z, sel)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        exact = torch.equal(out, ref)
        ms = cuda_ms(lambda: cbsr_cuda.sample_cuda(z, sel), TIMED)
        plain = cuda_ms(lambda: cbsr_cuda.sample_plain(z, sel), TIMED)
        emit("kernel", name="cbsr_sample", dtype=tag, shape=[v, K], dim=DIM, exact=exact,
             max_abs_err=err, ms=ms, plain_ms=plain)
        require(exact, f"cbsr_sample {tag}: differs from the plain version")
        res[("cbsr_sample", tag)] = (err, ms, plain)
        del x, y, take, y0, take0, vals, sel, out, ref, z
    return res


def phase_small_slice():
    """3 training steps at a small size, on the card (kernels) and on the
    CPU (plain versions), from the same seed: the losses must agree."""
    from maxk_tpu_torch.data.datasets import load_dataset
    from maxk_tpu_torch.train.config import TrainConfig
    from maxk_tpu_torch.train.loop import train

    data = load_dataset("reddit", scale=0.002, seed=123)
    losses = {}
    for device in ("cpu", "cuda"):
        cfg = TrainConfig(dataset="reddit", epochs=3, hidden_dim=64, hidden_layers=2,
                          maxk=8, dropout=0.0, lr=0.01, device=device)
        losses[device] = train(cfg, data, warmup_epochs=3).losses
    # summation order differs between devices; a top-k near-tie that the
    # order flips moves one row of V, so the bound is 1e-3 relative
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    emit("small_slice", nodes=data.csr.num_nodes, edges=data.csr.nnz,
         cuda_losses=losses["cuda"], cpu_losses=losses["cpu"], max_rel_diff=rel, rtol=1e-3)
    require(rel <= 1e-3, f"small slice: CUDA and CPU losses differ by {rel}")


def phase_data():
    from maxk_tpu_torch.data.datasets import load_dataset
    from maxk_tpu_torch.sparse.graph import build_graph

    t0 = time.perf_counter()
    data = load_dataset("reddit", scale=1.0, seed=123)
    t1 = time.perf_counter()
    graph = build_graph(data.csr, norm="right", device="cuda")
    t2 = time.perf_counter()
    emit("host_data", dataset="reddit", scale=1.0, nodes=data.csr.num_nodes,
         edges=data.csr.nnz, features=data.feat_dim, classes=data.num_classes,
         generate_s=t1 - t0, build_graph_s=t2 - t1,
         transpose_shared=graph.csc is graph.csr)
    return data, graph


def phase_op(graph):
    """maxk_spgemm forward and forward+backward, bf16 compute, against the
    plain path (plain densify and sample around the same SpMM)."""
    import torch

    from maxk_tpu_torch.ops.cbsr_cuda import densify_plain, sample_plain
    from maxk_tpu_torch.ops.spgemm import maxk_spgemm
    from maxk_tpu_torch.ops.spmm_xla import spmm_segsum
    from maxk_tpu_torch.sparse.cbsr import CBSR

    v = graph.num_nodes
    gen = torch.Generator(device="cuda").manual_seed(123)
    vals = torch.randn((v, K), generator=gen, device="cuda")
    sel = torch.randint(0, DIM, (v, K), generator=gen, device="cuda", dtype=torch.int32)
    ct = torch.randn((v, DIM), generator=gen, device="cuda")
    bf16 = torch.bfloat16

    def fwd():
        return maxk_spgemm(graph, CBSR(vals, sel), dim=DIM, compute_dtype=bf16)

    def fwd_bwd():
        va = vals.detach().requires_grad_(True)
        y = maxk_spgemm(graph, CBSR(va, sel), dim=DIM, compute_dtype=bf16)
        torch.vdot(y.flatten(), ct.flatten()).backward()
        return y, va.grad

    def plain_fwd():
        return spmm_segsum(graph.csr, densify_plain(vals.to(bf16), sel, DIM)).float()

    def plain_fwd_bwd():
        y = plain_fwd()
        return y, sample_plain(spmm_segsum(graph.csc, ct.to(bf16)), sel).float()

    y, dvals = fwd_bwd()
    y_ref, dvals_ref = plain_fwd_bwd()
    torch.cuda.synchronize()
    # both paths sum in f32 (index_add_ atomics, order varies run to run)
    # and round once to bf16: they may differ by one bf16 ulp, 2^-7 of the
    # largest magnitude at most
    tol = 1e-2
    err_y = ((y - y_ref).abs().max() / y_ref.abs().max()).item()
    err_d = ((dvals - dvals_ref).abs().max() / dvals_ref.abs().max()).item()
    finite = bool(torch.isfinite(y).all() and torch.isfinite(dvals).all())
    t = {
        "fwd_ms": cuda_ms(fwd, 3),
        "plain_fwd_ms": cuda_ms(plain_fwd, 3),
        "fwd_bwd_ms": cuda_ms(fwd_bwd, 3),
        "plain_fwd_bwd_ms": cuda_ms(plain_fwd_bwd, 3),
    }
    emit("op", name="maxk_spgemm", nodes=v, edges=graph.nnz, k=K, dim=DIM,
         compute_dtype="bfloat16", rel_err_fwd=err_y, rel_err_grad=err_d, tol=tol,
         finite=finite, gnnz_per_s_fwd=graph.nnz / (t["fwd_ms"] * 1e6), **t)
    require(finite and err_y <= tol and err_d <= tol,
            f"maxk_spgemm: kernel path vs plain path {err_y}, {err_d} > {tol}")


def phase_train(data):
    import torch

    from maxk_tpu_torch.train.config import TrainConfig
    from maxk_tpu_torch.train.logging import get_logger
    from maxk_tpu_torch.train.loop import train

    cfg = TrainConfig(dataset="reddit", model="sage", epochs=EPOCHS, lr=0.01,
                      hidden_dim=DIM, hidden_layers=LAYERS, maxk=K, dropout=0.5,
                      device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train(cfg, data, logger=get_logger(name="chip_smoke"), warmup_epochs=2)
    wall = time.perf_counter() - t0
    losses = state.losses
    emit("train", nodes=data.csr.num_nodes, edges=data.csr.nnz, layers=LAYERS,
         hidden=DIM, k=K, dropout=0.5, lr=0.01, epochs=EPOCHS, losses=losses,
         step_ms_post_warmup=1e3 * sum(state.epoch_times) / len(state.epoch_times),
         step_ms=[1e3 * s for s in state.epoch_times], best_val=state.best_val,
         wall_s=wall, max_memory_allocated=torch.cuda.max_memory_allocated())
    require(len(losses) == EPOCHS and all(math.isfinite(x) for x in losses),
            f"training: non-finite or missing losses {losses}")
    require(losses[-1] < losses[0], f"training: loss did not fall {losses}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: FAILED: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    try:
        import maxk_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: FAILED: maxk_tpu_torch is not beside this script: {e}",
              file=sys.stderr)
        return 2
    if Path(maxk_tpu_torch.__file__).resolve().parent != HERE / "maxk_tpu_torch":
        print(f"chip_smoke: FAILED: imported {maxk_tpu_torch.__file__}, not the "
              "package beside this script", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from maxk_tpu_torch.ops import cbsr_cuda, topk_cuda

    wrappers = {
        "maxk_mask": (topk_cuda.maxk_mask_cuda, "maxk_tpu_torch/csrc/maxk_mask.cu",
                      "maxk_tpu/ops/topk_pallas.py:99", "float32"),
        "cbsr_densify": (cbsr_cuda.densify_cuda, "maxk_tpu_torch/csrc/cbsr.cu",
                         "maxk_tpu/ops/cbsr_pallas.py:42", "bfloat16"),
        "cbsr_sample": (cbsr_cuda.sample_cuda, "maxk_tpu_torch/csrc/cbsr.cu",
                        "maxk_tpu/ops/cbsr_pallas.py:52", "bfloat16"),
    }
    try:
        smi = phase_identity()
        phase_build()
        data, graph = phase_data()
        checks = phase_kernels(graph.num_nodes)
        phase_small_slice()

        for fn, *_ in wrappers.values():
            fn.launches = 0
        phase_op(graph)
        del graph
        torch.cuda.empty_cache()
        phase_train(data)
        launches = {name: w[0].launches for name, w in wrappers.items()}
        emit("launches", **launches)
        for name, n in launches.items():
            require(n > 0, f"{name} was not launched on the main path")
        require(launches["maxk_mask"] >= LAYERS * EPOCHS,
                f"maxk_mask launched {launches['maxk_mask']} < {LAYERS * EPOCHS} times")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    kernels = []
    for name, (_, source, replaces, dtype) in wrappers.items():
        err, ms, plain = checks[(name, dtype)]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "dtype": dtype,
            "max_abs_err": max(checks[(name, d)][0] for d in ("float32", "bfloat16")),
            "ms": ms, "plain_ms": plain,
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
