#!/usr/bin/env python3
"""On-card check of the maxk_tpu_torch port, on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from `maxk_tpu_torch/csrc/`, holds each against
its plain PyTorch version at the main path's shapes (the segsum path's CSR
kernels, K9 `spmm_csr` over A and Aᵀ, K10 `spgemm_cbsr` and K11
`sspmm_cbsr` at k = 16, 32 and 64, each beside its gather ceiling, on
full-scale synthetic reddit: `csr_kernels`), runs the op
`maxk_spgemm` under segsum (K10, K11) on that graph against its plain
path, then
trains MaxK-SAGE (4×256, k=32, dropout 0.5, lr 0.01 — the reference's
reddit launch) on full-scale synthetic reddit for 10 epochs through the
port's `train()`, and GNNRes (4×256) for 3 epochs on the same graph. Then
the row-partitioned path: at a small size against the single-device path
(SAGE, GCN, GIN, and ogbn-proteins, whose gathered ROC-AUC must equal the
single-device one on the same logits), and 5 epochs of the same
full-width training through `parallel.train.train_sharded`, one rank per
card (NCCL). Then the benchmark path, through the entry points of
`maxk_tpu_torch.bench`: the `bench.py` record on the same reddit graph,
the kernel suite on the five training graphs (validated), the MaxK probe
(K1, K4, K8), the brick probe (K5) and the microbenchmarks (K6, K7). Then
the accuracy path: the ten golden rows (`train.golden.run_golden` on the
card, each at or above its floor but the ROADMAP C rows), and
ogbn-proteins ×1.0 with the published launch (3×256, k=32) for 3 epochs
with ROC-AUC eval. Between GNNRes and the row-partitioned path, the
edge-tile path on the same reddit graph: the tables (`host_tiles`: the C++
builder's, the device builder's equal to them, C++ equal to numpy at
scale 0.02), the tile SpMM against segsum and `torch.sparse.mm`
(`tiles_op`: A and Aᵀ, f32 and bf16, one profiled call's device busy
share; `maxk_spgemm` under tiles_scan; `tiles_xla` at scale 0.02), and 3
epochs of the same training under `--kernel_mode tiles_scan` with the
sharded small case at world size 1 (`tiles_train`). After the benchmark
path, the campaign scripts (`campaign`: the degree sweep on two R-MAT
graphs either side of average degree 50 through `kernel_bench` children,
assembled with its audit and the cuSPARSE yardstick; the SpGEMM study,
the three schedules, memcheck on the reddit ×1.0 graph still in memory,
a ksweep arm triple, scaling, the figures, and a `--validate_kernels`
run; K1–K5 must each launch in the process), then Lookahead with
checkpoints and a resume through the CLI's entry, and `--evaluate` on its
`best/` (`lookahead_ckpt`).
Before the paths, every kernel is held against its plain version at its
path's shapes, and timed beside its bound and, where one exists, the
PyTorch library call that computes the same function; the CBSR densify
and sample also on the top-k kernel's output, the training path's input,
and the sample and take-along-rows bounded by the 32-byte sectors and
64-byte granules their selectors touch beside the elements
(`sector_bound_ms`, `granule_bound_ms`: `micro.in_row_gather_bound`). The
`launch_path` line takes K8's call at probe_topk's (256, 256) apart on the
host clock, step by step, for the earlier and the current launch path.
Each phase prints one JSON line (with `at_s`, the seconds since the
start); every failure exits non-zero with no `ok` line. The last three lines are the kernels record, the card's
`nvidia-smi` name and power limit, and the `ok` line.

float32 matrix products and convolutions run in full float32 here: TF32 is
switched off for both.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
DIM, K, LAYERS, EPOCHS = 256, 32, 4, 10
SHARDED_EPOCHS = 5
GNN_EPOCHS = PROTEINS_EPOCHS = TILE_EPOCHS = 3
TILE_FIELDS = ("block", "cols", "vals", "localrow")
BRICK_V, BRICK_E = 32768, 1_000_000  # probe_bricks' default graph
TIMED = 20  # launches per kernel timing
ROUNDS = 5  # rounds of the launch-path and K7 timings


class SmokeFailure(Exception):
    pass


_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line: the phase, its fields and `at_s`, the seconds since
    the script started (so a slow run can be taken apart phase by phase)."""
    print(json.dumps({"phase": phase, **fields,
                      "at_s": round(time.perf_counter() - _START, 1)}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def reset_launches(names) -> None:
    """Set the launch counts of the wrappers `names` to 0
    (`telemetry.launches`, counted by `ops/_native.launch`)."""
    from maxk_tpu_torch import telemetry

    for name in names:
        telemetry.launches[name] = 0


def read_launches(names) -> dict:
    """The launch count of each wrapper of `names`."""
    from maxk_tpu_torch import telemetry

    return {name: telemetry.launches[name] for name in names}


# the MaxK activation's kernels: K4 where the conv aggregates through the
# CBSR pair (one device under segsum in f32), K1 elsewhere
MAXK_KERNELS = ("maxk_mask", "topk_cbsr")


def maxk_launches() -> int:
    """The launches of the MaxK activation's kernels so far."""
    return sum(read_launches(MAXK_KERNELS).values())


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of `fn()` in ms over `iters` runs after one warm-up
    run: `micro.timeit`, by CUDA events."""
    from maxk_tpu_torch.bench.micro import timeit

    return 1e3 * timeit(fn, iters=iters, warmup=1)


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
    among +0.0s, a constant row and an all-negative row; then f32 values
    sharing their top 16 bits but differing below (a whole row, positive
    and negative, exactly 32 and 33 of a row), and a row whose shared top
    halves straddle the k-th place with ties below them too (in bf16 they
    round to plain ties)."""
    import torch

    x = torch.randn((v, DIM), generator=gen, device="cuda")
    x[:64] = torch.randint(-3, 4, (64, DIM), generator=gen, device="cuda").float()
    x[64] = 0.0
    x[64, 0] = -0.0
    x[65] = 1.0
    x[66] = -x[66].abs() - 1.0
    j = torch.arange(DIM, device="cuda", dtype=torch.float64)
    x[67] = (1.0 + j * 2.0**-20).float()
    x[68] = (-1.0 - j * 2.0**-20).float()
    for r, m in ((69, 32), (70, 33)):
        x[r] = 0.0
        x[r, :m] = (1.0 + j[:m] * 2.0**-20).float()
    x[71] = 0.1 * x[71]
    x[71, :10] = 5.0
    x[71, 10:40] = (3.0 + (j[:30] % 7) * 2.0**-20).float()
    return x.to(dtype)


def _unique(t) -> int:
    return int(t.unique().numel())


def phase_kernels(v: int):
    """Each kernel of the training paths against its plain version at the
    main path's shapes, timed beside its bound and the library call."""
    import torch

    from maxk_tpu_torch.bench.micro import bound, in_row_gather_bound
    from maxk_tpu_torch.ops import cbsr_cuda, topk_cuda

    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {}

    def sample_check(z, sel, input_name, key):
        """K3 on (v, K) selectors `sel` into z: bit-equal to the plain
        version, timed beside `torch.gather`; bounded by the distinct elements
        the selectors touch and, beside it, by the 32-byte sectors and
        64-byte granules (`micro.in_row_gather_bound`)."""
        out = cbsr_cuda.sample_cuda(z, sel)
        ref = cbsr_cuda.sample_plain(z, sel)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        exact = torch.equal(_bits(out), _bits(ref))
        sel64 = sel.long()
        ms = cuda_ms(lambda: cbsr_cuda.sample_cuda(z, sel), TIMED)
        plain = cuda_ms(lambda: cbsr_cuda.sample_plain(z, sel), TIMED)
        lib = cuda_ms(lambda: torch.gather(z, 1, sel64), TIMED)
        b = in_row_gather_bound(sel, DIM, z.element_size())
        tag = str(z.dtype).split(".")[-1]
        emit("kernel", name="cbsr_sample", input=input_name, dtype=tag, shape=list(sel.shape),
             dim=DIM, exact=exact, max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
             library="torch.gather", bound_share=b["bound_ms"] / ms,
             sector_bound_share=b["sector_bound_ms"] / ms, **b)
        require(exact, f"cbsr_sample {tag} on {input_name} selectors: differs from the plain version")
        res[("cbsr_sample", key)] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, **b)
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[-1]
        isz = torch.finfo(dtype).bits // 8
        x = _mask_input(v, dtype, gen)
        y, take = topk_cuda.maxk_mask_cuda(x, K)
        y0, take0 = topk_cuda.maxk_mask_plain(x, K)
        torch.cuda.synchronize()
        err = (y.float() - y0.float()).abs().max().item()
        exact = torch.equal(_bits(y), _bits(y0)) and torch.equal(take, take0)
        k_each = bool((take.sum(1) == K).all())
        ms = cuda_ms(lambda: topk_cuda.maxk_mask_cuda(x, K), TIMED)
        plain = cuda_ms(lambda: topk_cuda.maxk_mask_plain(x, K), TIMED)
        # the library call selects only, in another layout: (values, indices)
        lib = cuda_ms(lambda: torch.topk(x, K), TIMED)
        b = bound(v * DIM * (2 * isz + 1))  # x in; y, take out
        emit("kernel", name="maxk_mask", dtype=tag, shape=[v, DIM], k=K, exact=exact,
             exactly_k=k_each, max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
             library="torch.topk (selection only, different output layout)", **b)
        require(exact and k_each, f"maxk_mask {tag}: y/take differ from the plain version")
        res[("maxk_mask", tag)] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, **b)

        vals = torch.randn((v, K), generator=gen, device="cuda").to(dtype)
        sel = torch.randint(0, DIM, (v, K), generator=gen, device="cuda", dtype=torch.int32)
        sel64 = sel.long()
        out = cbsr_cuda.densify_cuda(vals, sel, DIM)
        ref = cbsr_cuda.densify_plain(vals, sel, DIM)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        # duplicates sum in another order in the plain version (atomics);
        # in bf16 that may move the one rounding by one ulp (2^-7 relative)
        rtol = 1e-6 if dtype == torch.float32 else 2.0**-7
        ok = torch.allclose(out.float(), ref.float(), rtol=rtol, atol=1e-6)
        exact = torch.equal(_bits(out), _bits(ref))
        ms = cuda_ms(lambda: cbsr_cuda.densify_cuda(vals, sel, DIM), TIMED)
        plain = cuda_ms(lambda: cbsr_cuda.densify_plain(vals, sel, DIM), TIMED)
        lib = cuda_ms(lambda: torch.zeros((v, DIM), dtype=dtype, device="cuda")
                      .scatter_add_(1, sel64, vals), TIMED)
        b = bound(v * K * (isz + 4) + v * DIM * isz)
        emit("kernel", name="cbsr_densify", input="random", dtype=tag, shape=[v, K], dim=DIM,
             rtol=rtol, atol=1e-6, ok=ok, exact=exact, max_abs_err=err, ms=ms, plain_ms=plain,
             library_ms=lib, library="scatter_add_ into zeros", **b)
        require(ok, f"cbsr_densify {tag}: differs from the plain version beyond rtol {rtol}")
        res[("cbsr_densify", tag)] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                          library_ms=lib, **b)

        cvals, csel = topk_cuda.topk_cbsr_cuda(x, K)
        cvals0, csel0 = topk_cuda.topk_cbsr_plain(x, K)
        torch.cuda.synchronize()
        err = (cvals - cvals0).abs().max().item()
        exact = (torch.equal(csel, csel0)
                 and torch.equal(cvals.view(torch.int32), cvals0.view(torch.int32)))
        ms = cuda_ms(lambda: topk_cuda.topk_cbsr_cuda(x, K), TIMED)
        plain = cuda_ms(lambda: topk_cuda.topk_cbsr_plain(x, K), TIMED)
        lib = cuda_ms(lambda: torch.topk(x, K), TIMED)
        b = bound(v * DIM * isz + v * K * 8)  # x in; f32 values and int32 selectors out
        emit("kernel", name="topk_cbsr", dtype=tag, shape=[v, DIM], k=K, exact=exact,
             max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
             library="torch.topk (selection only, different output layout)",
             bound_share=b["bound_ms"] / ms, **b)
        require(exact, f"topk_cbsr {tag}: sel/vals differ from the plain version")
        res[("topk_cbsr", tag)] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, **b)

        # K2 on K4's output, the training path's input: distinct ascending
        # selectors, one value a column, so bit-equal to the plain version
        cv = cvals.to(dtype)
        out = cbsr_cuda.densify_cuda(cv, csel, DIM)
        ref = cbsr_cuda.densify_plain(cv, csel, DIM)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        exact = torch.equal(_bits(out), _bits(ref))
        ms = cuda_ms(lambda: cbsr_cuda.densify_cuda(cv, csel, DIM), TIMED)
        plain = cuda_ms(lambda: cbsr_cuda.densify_plain(cv, csel, DIM), TIMED)
        csel64 = csel.long()
        lib = cuda_ms(lambda: torch.zeros((v, DIM), dtype=dtype, device="cuda")
                      .scatter_add_(1, csel64, cv), TIMED)
        b = bound(v * K * (isz + 4) + v * DIM * isz)
        emit("kernel", name="cbsr_densify", input="topk_cbsr", dtype=tag, shape=[v, K], dim=DIM,
             exact=exact, max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
             library="scatter_add_ into zeros", **b)
        require(exact, f"cbsr_densify {tag} on topk_cbsr's output: differs from the plain version")
        res[("cbsr_densify", f"topk_cbsr_{tag}")] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                                         library_ms=lib, **b)
        del cv, csel64

        # K3 on random selectors (duplicates within a row) and on K4's output,
        # the training paths' input (distinct, ascending within a row)
        z = torch.randn((v, DIM), generator=gen, device="cuda").to(dtype)
        sample_check(z, sel, "random", tag)
        sample_check(z, csel, "topk_cbsr", f"topk_cbsr_{tag}")
        del x, y, take, y0, take0, vals, sel, sel64, cvals, csel, cvals0, csel0, out, ref, z
    return res


def phase_csr_kernels(graph) -> dict:
    """K9 over A and Aᵀ, K10 over A (k = 32) and K11 over Aᵀ (k = 32, 16 and
    64: each lane layout), f32 and bf16,
    at reddit ×1.0, against their plain versions on the card (`index_add_`:
    the order of its f32 sum varies), timed beside the bound, the plain
    version and `torch.sparse.mm` on the same CSR (K10: on the densified
    features; K11: Aᵀ @ g, before the sample). Each element within
    2·n·2⁻²⁴·Σ|terms| + ulp·|ref| of the plain version's (n the row's
    edges: both sum the same rounded products in f32 in other orders, and
    round once); two launches of each give the same bits. Returns the
    checks and K9's f32 seconds a live edge over A.

    Each line adds the gather ceiling: the kernel timed on a copy of the
    CSR whose column indices are folded into the rows whose bytes (K9, K11:
    feature rows; K10: merged CBSR rows) fill half the card's L2, so every
    gathered row is a hit (`gather_ceiling_ms`; its share of the kernel's
    time), beside the bytes gathered (`gathered_bytes`: a row, or k slots, an
    edge; K11 the 32-byte sectors of g's rows its selectors touch,
    `ablate_csr.sector_bytes`). K9's and K11's add their column slice, K10's
    the hub rows it holds in shared memory and the share of the edges whose
    source is one of them."""
    import torch

    from maxk_tpu_torch.bench.ablate_csr import csr_bytes, folded_csr, hub_share, sector_bytes
    from maxk_tpu_torch.bench.micro import bound
    from maxk_tpu_torch.ops import _native
    from maxk_tpu_torch.ops import spmm_csr as sc
    from maxk_tpu_torch.ops.cbsr_cuda import densify_plain, sample_plain
    from maxk_tpu_torch.ops.spmm_xla import spmm_segsum
    from maxk_tpu_torch.sparse.csr import CSRGraph

    v, e_live = graph.num_nodes, int(graph.csr.indptr[-1])
    gen = torch.Generator(device="cuda").manual_seed(12)
    vals32 = torch.randn((v, K), generator=gen, device="cuda")
    sel = torch.randint(0, DIM, (v, K), generator=gen, device="cuda", dtype=torch.int32)
    res, lines = {}, []

    def check(name, key, kernel, plain, abs_terms, csr, library, nbytes, **fields):
        out, again = kernel(), kernel()
        ref = plain()
        torch.cuda.synchronize()
        deg = torch.diff(csr.indptr.long()).double()[:, None]
        ulp = 2.0**-7 if out.dtype == torch.bfloat16 else 2.0**-23
        err = (out.double() - ref.double()).abs()
        # Σ|terms| ×1.01 for the terms' own bf16 rounding
        slack = 2.0 * deg * 2.0**-24 * 1.01 * abs_terms().double() + ulp * ref.double().abs()
        ratio = float((err / slack.clamp_min(1e-30)).max())
        same = torch.equal(_bits(out), _bits(again))
        rec = dict(max_abs_err=float(err.max()), max_rel_err=float(err.max() / ref.abs().max()),
                   max_err_over_bound=ratio, bit_equal_runs=same,
                   ms=cuda_ms(kernel, TIMED), plain_ms=cuda_ms(plain, 3), **bound(nbytes))
        del out, again, ref, err, slack
        try:
            rec["library_ms"] = cuda_ms(library, 5)
        except (NotImplementedError, RuntimeError) as e:  # the library's gap
            rec["library_ms"], rec["library_error"] = None, f"{type(e).__name__}: {e}"[:200]
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        if "gather_ceiling_ms" in fields:
            fields["gather_ceiling_share"] = fields["gather_ceiling_ms"] / rec["ms"]
        emit("kernel", name=name, check=key, library="torch.sparse.mm", **fields, **rec)
        require(same, f"{name} {key}: two launches differ")
        require(ratio <= 1.0, f"{name} {key}: {ratio} of its bound from the plain version")
        res[(name, key)] = {f: rec[f] for f in ("max_abs_err", "ms", "plain_ms", "library_ms",
                                                 "bound_ms", "bound_by")}

    def abs_csr(csr):
        return CSRGraph(csr.indptr, csr.indices, csr.values.abs())

    l2 = _native.l2_cache_bytes()

    def ceiling(kernel_on, csr, row_bytes, gathered, hubs=False, **fields):
        """The gather-ceiling fields of a kernel line."""
        folded = folded_csr(csr, l2 // 2 // row_bytes, hubs=hubs)
        ms = cuda_ms(lambda: kernel_on(folded), TIMED)
        del folded
        return dict(gather_ceiling_ms=ms, gathered_bytes=gathered, **fields)

    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[-1]
        isz = torch.finfo(dtype).bits // 8
        layout = sc.kernel_layout(isz, K, DIM)
        for op, csr in (("A", graph.csr), ("At", graph.csc)):
            x = torch.randn((v, DIM), generator=gen, device="cuda").to(dtype)
            a = torch.sparse_csr_tensor(csr.indptr.long(), csr.indices.long(),
                                        csr.values.to(dtype), (v, v))
            extra = ceiling(lambda c: sc.spmm_csr_cuda(c, x), csr, DIM * isz,
                            e_live * DIM * isz, slice_cols=layout["slice_cols"])
            check("spmm_csr", f"{op}_{tag}", lambda: sc.spmm_csr_cuda(csr, x),
                  lambda: sc.spmm_csr_plain(csr, x),
                  lambda: spmm_segsum(abs_csr(csr), x.abs().float()), csr,
                  lambda: torch.sparse.mm(a, x),
                  csr_bytes(csr) + 2 * v * DIM * isz,
                  operand=op, dtype=tag, nodes=v, edges=e_live, dim=DIM, **extra)
            del a
        vals = vals32.to(dtype)
        a = torch.sparse_csr_tensor(graph.csr.indptr.long(), graph.csr.indices.long(),
                                    graph.csr.values.to(dtype), (v, v))
        dense = densify_plain(vals, sel, DIM)
        cache_rows, segs = layout["k10_cache_rows"], graph.csr.segments
        extra = ceiling(lambda c: sc.spgemm_cbsr_cuda(c, vals, sel, DIM), graph.csr,
                        K * (2 + isz), e_live * K * (2 + isz), hubs=True,
                        hub_rows=min(cache_rows, segs.hub_rows.shape[0]),
                        hub_share=hub_share(graph.csr, cache_rows))
        check("spgemm_cbsr", tag, lambda: sc.spgemm_cbsr_cuda(graph.csr, vals, sel, DIM),
              lambda: sc.spgemm_cbsr_plain(graph.csr, vals, sel, DIM),
              lambda: spmm_segsum(abs_csr(graph.csr), dense.abs().float()), graph.csr,
              lambda: torch.sparse.mm(a, dense),
              csr_bytes(graph.csr) + v * K * (isz + 4) + v * DIM * isz,
              operand="A", dtype=tag, nodes=v, edges=e_live, dim=DIM, k=K,
              library_input="densified CBSR", **extra)
        del a, dense
        csc = graph.csc
        at = torch.sparse_csr_tensor(csc.indptr.long(), csc.indices.long(),
                                     csc.values.to(dtype), (v, v))
        ct = torch.randn((v, DIM), generator=gen, device="cuda").to(dtype)
        for k in (K, 16, 64):  # a warp, 16 lanes and 2 slots a lane a segment
            ks = sel if k == K else torch.randint(0, DIM, (v, k), generator=gen, device="cuda",
                                                  dtype=torch.int32)
            extra = ceiling(lambda c: sc.sspmm_cbsr_cuda(c, ct, ks), csc, DIM * isz,
                            sector_bytes(csc, ks, DIM, isz),
                            slice_cols=sc.k11_slice(isz, k, DIM, v, csc.nnz))
            check("sspmm_cbsr", tag if k == K else f"{tag}_k{k}",
                  lambda: sc.sspmm_cbsr_cuda(csc, ct, ks),
                  lambda: sc.sspmm_cbsr_plain(csc, ct, ks),
                  lambda: sample_plain(spmm_segsum(abs_csr(csc), ct.abs().float()), ks),
                  csc, lambda: torch.sparse.mm(at, ct),
                  csr_bytes(csc) + v * DIM * isz + v * k * (4 + isz),
                  operand="At", dtype=tag, nodes=v, edges=e_live, dim=DIM, k=k,
                  library_input="Aᵀ @ g, not sampled", **extra)
            del ks
        del at, ct, x, vals
    return res, res[("spmm_csr", "A_float32")]["ms"] * 1e-3 / e_live


def _bits(t):
    import torch

    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def brick_inputs():
    """probe_bricks' default graph (R-MAT, BRICK_V nodes, BRICK_E edges
    drawn, seed 123) and its default brick schedule, on the card: built once
    for the K5 check and the probe."""
    from maxk_tpu_torch.data.synthetic import rmat_graph
    from maxk_tpu_torch.sparse.bricks import build_bricks

    t0 = time.perf_counter()
    g = rmat_graph(BRICK_V, BRICK_E, seed=123)
    sched = build_bricks(g)
    emit("brick_inputs", nodes=g.num_nodes, edges=g.nnz, seconds=time.perf_counter() - t0)
    return g.to("cuda"), sched.to("cuda")


def phase_bench_kernels(bg, sched):
    """K5-K8, the kernels of the benchmark path, against their plain
    versions at the shapes the entry points give them: K5 on probe_bricks'
    default schedule `sched` of the graph `bg`, K6 and K7 at micro's
    shapes, K8 at probe_topk's. K5 is timed by the probe (phase_probes)."""
    import torch

    from maxk_tpu_torch.bench.micro import bound, in_row_gather_bound
    from maxk_tpu_torch.ops import gather_cuda, spmm_bricks

    res = {}
    gen = torch.Generator(device="cuda").manual_seed(1)

    # K5 at D = 256. float32: probe_bricks' criterion, relative to max|ref|.
    # bfloat16: element by element, one bf16 ulp (2^-7 of |ref| at most;
    # both sum in f32, maybe in another order, and round once) plus 1e-5 of
    # max|ref| where the f32 sum cancels
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[-1]
        x = torch.randn((bg.num_nodes, DIM), generator=gen, device="cuda").to(dtype)
        y = spmm_bricks.spmm_bricks_cuda(sched, x).float()
        ref = spmm_bricks.spmm_bricks_plain(sched, x).float()
        scale = ref.abs().max().item()
        e = (y - ref).abs()
        if dtype == torch.float32:
            tol = {"max_rel": 1e-5, "mean_rel": 1e-4}
            ok = e.max().item() <= 1e-5 * scale and e.mean().item() <= 1e-4 * scale
        else:
            tol = {"rtol": 2.0**-7, "atol_rel": 1e-5}
            ok = bool((e <= 2.0**-7 * ref.abs() + 1e-5 * scale).all())
        err = {"max_abs": e.max().item(), "max_rel": e.max().item() / scale,
               "mean_rel": e.mean().item() / scale,
               "bitwise_equal": torch.equal(_bits(y.to(dtype)), _bits(ref.to(dtype)))}
        emit("kernel", name="spmm_bricks", dtype=tag, nodes=bg.num_nodes, edges=bg.nnz,
             dim=DIM, ok=ok, tolerance=tol, vs_plain=err)
        require(ok, f"spmm_bricks {tag}: {err} beyond {tol} against the plain version")
        res[("spmm_bricks", tag)] = dict(max_abs_err=err["max_abs"])
        del x, y, ref, e

    def gather_check(name, kernel, plain, library_fn, args, b, key, iters=TIMED,
                     rounds=1, **shape):
        """`b`: the bound (`micro.bound`). `rounds` > 1: kernel and library
        call are each the median of that many runs of `iters` launches, taken
        in turns (kernel, library, library, kernel, ...), with the range
        beside."""
        out = kernel(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        exact = torch.equal(_bits(out), _bits(ref))
        err = (out.float() - ref.float()).abs().max().item()
        del out, ref
        runs = {"ms": [], "library_ms": []}
        fns = {"ms": lambda: kernel(*args), "library_ms": lambda: library_fn(*args)}
        for r in range(rounds):
            for arm in (("ms", "library_ms") if r % 2 == 0 else ("library_ms", "ms")):
                runs[arm].append(cuda_ms(fns[arm], iters))
        ms, lib = statistics.median(runs["ms"]), statistics.median(runs["library_ms"])
        plain_ms = cuda_ms(lambda: plain(*args), iters)
        spread = {} if rounds == 1 else {
            "rounds": rounds, "ms_range": [min(runs["ms"]), max(runs["ms"])],
            "library_ms_range": [min(runs["library_ms"]), max(runs["library_ms"])]}
        emit("kernel", name=name, exact=exact, max_abs_err=err, ms=ms, plain_ms=plain_ms,
             library_ms=lib, bound_share=b["bound_ms"] / ms, iters=iters, **spread, **shape, **b)
        require(exact, f"{name} {shape}: differs from the plain version")
        res[(name, key)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib, **b)

    # K6: slabs of 2048 and 8192 rows, D = 256, 2^20 indices
    n = 1 << 20
    for s in (2048, 8192):
        for dtype in (torch.float32, torch.bfloat16):
            tag = str(dtype).split(".")[-1]
            isz = torch.finfo(dtype).bits // 8
            slab = torch.randn((s, DIM), generator=gen, device="cuda").to(dtype)
            idx = torch.randint(0, s, (n,), generator=gen, device="cuda", dtype=torch.int32)
            gather_check("slab_gather", gather_cuda.slab_gather_cuda,
                         gather_cuda.gather_rows_plain, lambda t, i: torch.index_select(t, 0, i),
                         (slab, idx), bound(n * 4 + s * DIM * isz + n * DIM * isz), f"{s}_{tag}",
                         dtype=tag, slab=[s, DIM], n=n, library="torch.index_select")
    del slab, idx

    # K7: 2^18 random rows of a (2^18, 256) table, rows of 1 KB (f32) and
    # 512 B (bf16); K7 and index_select are close in f32, so both are
    # medians of ROUNDS runs taken in turns
    v7 = n7 = 1 << 18
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[-1]
        isz = torch.finfo(dtype).bits // 8
        x = torch.randn((v7, DIM), generator=gen, device="cuda").to(dtype)
        idx = torch.randint(0, v7, (n7,), generator=gen, device="cuda", dtype=torch.int32)
        gather_check("dma_gather", gather_cuda.dma_gather_cuda, gather_cuda.gather_rows_plain,
                     lambda t, i: torch.index_select(t, 0, i), (x, idx),
                     bound(n7 * 4 + (_unique(idx) + n7) * DIM * isz), tag, rounds=ROUNDS,
                     dtype=tag, table=[v7, DIM], n=n7, library="torch.index_select")
    del x, idx

    # K8: probe_topk's (262144, 256) at 32 random in-row indices, and its
    # (256, 256) at the indices 0..31: a call there is host time, which over
    # TIMED calls moves by a fifth and more between runs, so 1,000 calls
    for r, dtype in ((262144, torch.float32), (262144, torch.bfloat16), (256, torch.float32)):
        tag = str(dtype).split(".")[-1]
        isz = torch.finfo(dtype).bits // 8
        x = torch.randn((r, DIM), generator=gen, device="cuda").to(dtype)
        if r == 256:
            idx = torch.arange(K, device="cuda", dtype=torch.int32).repeat(r, 1)
        else:
            idx = torch.randint(0, DIM, (r, K), generator=gen, device="cuda", dtype=torch.int32)
        idx64 = idx.long()
        # as K3's: by the distinct elements read, and beside it by the sectors
        # and granules
        gather_check("take_along_rows", gather_cuda.take_along_rows_cuda,
                     gather_cuda.take_along_rows_plain,
                     lambda t, i, i64=idx64: torch.gather(t, 1, i64), (x, idx),
                     in_row_gather_bound(idx, DIM, isz), f"{r}_{tag}",
                     iters=1_000 if r == 256 else TIMED, dtype=tag, shape=[r, DIM], k=K,
                     library="torch.gather")
    return res


def _host_us(fn, iters: int = 10_000, warmup: int = 1_000) -> float:
    """Mean host time of `fn()` in µs over `iters` calls after `warmup`
    calls, on the host clock, the device drained before and after."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / iters


def phase_launch_path():
    """K8 at probe_topk's (256, 256), k = 32 at the indices 0..31, where one
    call is about 3 µs of device work and the wrapper's host time is its
    time: each step of a call timed alone on the host clock, for the earlier
    launch path (written out below as it was) and the current one, with
    `torch.gather` beside them, and both wrappers timed as the kernels line
    times a kernel (CUDA events over back-to-back calls)."""
    import torch

    from maxk_tpu_torch.ops import _native, gather_cuda

    name, entry, dtypes = "take_along_rows", "take_rows_f32", gather_cuda.KERNEL_DTYPES
    r, d = 256, DIM
    x = torch.randn((r, d), generator=torch.Generator(device="cuda").manual_seed(3),
                    device="cuda")
    idx = torch.arange(K, device="cuda", dtype=torch.int32).repeat(r, 1)
    idx64 = idx.long()
    out = torch.empty((r, K), device="cuda")
    fn = _native._fns[entry]

    def earlier_check(t, dts, ndim=2):
        # the per-tensor check of the earlier path: the current device by
        # `torch.cuda.current_device()`, the shape by a generator
        if not t.is_cuda:
            raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
        if t.device.index != torch.cuda.current_device():
            raise ValueError(f"{name}: tensor on {t.device}")
        if t.dtype not in dts:
            raise TypeError(name)
        if t.dim() != ndim:
            raise ValueError(name)
        if not t.is_contiguous():
            raise ValueError(name)
        if any(n >= 2**31 for n in t.shape):
            raise ValueError(name)

    def earlier_wrapper(x, idx):
        earlier_check(x, dtypes)
        earlier_check(idx, (torch.int32,))
        rows, dim = x.shape
        if idx.shape[0] != rows or idx.device != x.device:
            raise ValueError(name)
        k = idx.shape[1]
        o = torch.empty((rows, k), dtype=x.dtype, device=x.device)
        if rows == 0 or k == 0:
            return o
        fn_name = entry if x.dtype == torch.float32 else "take_rows_bf16"
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_native.library(), fn_name)(x.data_ptr(), idx.data_ptr(), o.data_ptr(), rows,
                                                  k, dim, stream)
        if err != 0:
            raise RuntimeError(f"{fn_name}: CUDA error {err} at launch")
        return o

    stream = torch._C._cuda_getCurrentRawStream(x.get_device())
    earlier = {
        "check_x2": lambda: (earlier_check(x, dtypes), earlier_check(idx, (torch.int32,))),
        "devices_match": lambda: idx.device != x.device,
        "empty": lambda: torch.empty((r, K), dtype=x.dtype, device=x.device),
        "stream": lambda: torch.cuda.current_stream().cuda_stream,
        "entry_lookup": lambda: getattr(_native.library(), entry),
    }
    current = {
        "check_x2": lambda: (_native.check(name, x, dtypes),
                             _native.check(name, idx, (torch.int32,))),
        "devices_match": lambda: idx.get_device() != x.get_device(),
        "empty": lambda: x.new_empty((r, K)),
        "stream": lambda: (x.get_device() != torch._C._cuda_getDevice(),
                           torch._C._cuda_getCurrentRawStream(x.get_device())),
        "entry_lookup": lambda: _native._fns[entry],
    }
    # the ctypes call is the same on both paths; with rows = 0 the entry
    # point returns before it launches, which leaves the ctypes part alone
    shared = {
        "ctypes_call": lambda: fn(x.data_ptr(), idx.data_ptr(), out.data_ptr(), r, K, d, stream),
        "ctypes_call_no_launch": lambda: fn(x.data_ptr(), idx.data_ptr(), out.data_ptr(), 0, K, d,
                                            stream),
    }
    require(torch.equal(earlier_wrapper(x, idx), gather_cuda.take_along_rows_cuda(x, idx)),
            "launch path: the earlier and the current wrapper disagree")
    # the host clock of this machine moves by up to 2x between runs of the
    # same step: each number is the median of ROUNDS rounds, taken in turns
    paths = {"earlier_us": {**earlier, **shared, "wrapper": lambda: earlier_wrapper(x, idx)},
             "current_us": {**current, **shared,
                            "wrapper": lambda: gather_cuda.take_along_rows_cuda(x, idx)},
             "torch_gather_us": {"call": lambda: torch.gather(x, 1, idx64)}}
    rounds = {(path, part): [] for path, parts in paths.items() for part in parts}
    for _ in range(ROUNDS):
        for (path, part), times in rounds.items():
            times.append(_host_us(paths[path][part]))
    rec = {path: {part: statistics.median(rounds[(path, part)]) for part in parts}
           for path, parts in paths.items()}
    rec["call_us_range"] = {key[0]: [min(t), max(t)] for key, t in rounds.items()
                            if key[1] in ("wrapper", "call")}
    # as the kernels line times a call (CUDA events over back-to-back calls),
    # 1,000 calls a run, the median of ROUNDS runs
    for key, f in (("earlier_ms", paths["earlier_us"]["wrapper"]),
                   ("current_ms", paths["current_us"]["wrapper"]),
                   ("torch_gather_ms", paths["torch_gather_us"]["call"])):
        rec[key] = statistics.median(cuda_ms(f, 1_000) for _ in range(ROUNDS))
    emit("launch_path", kernel="take_along_rows", shape=[r, d], k=K, iters=10_000, warmup=1_000,
         rounds=ROUNDS, **rec)


def phase_bench(csr):
    """`python -m maxk_tpu_torch.bench`'s record on the reddit ×1.0 graph."""
    from maxk_tpu_torch.bench.bench import run_bench

    t0 = time.perf_counter()
    rec = run_bench(csr, k=K, dim=DIM, mode="auto", device="cuda", label="reddit x1.0")
    emit("bench", seconds=time.perf_counter() - t0, **rec)
    require(rec["value"] > 0 and math.isfinite(rec["value"]), f"bench: record {rec}")


def phase_kernel_bench():
    """The kernel suite: the five training graphs at scale 0.02, k 16/32/64,
    validated; its text lines go to stderr."""
    from maxk_tpu_torch.bench import kernel_bench

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        recs = kernel_bench.main(["--device", "cuda", "--scale", "0.02", "--validate"])
    keep = ("graph", "V", "E", "k", "t_mask_ms", "t_fwd_ms", "t_fwd_bwd_ms", "t_fwd_cbsr_ms",
            "t_fwd_bwd_cbsr_ms", "t_baseline_ms", "t_baseline_bf16_ms", "valid")
    emit("kernel_bench", seconds=time.perf_counter() - t0,
         records=[{**{f: r[f] for f in keep}, "max_err": r["validation"]["max_err"],
                   "mean_err": r["validation"]["mean_err"]} for r in recs])
    require(len(recs) == 15 and all(r["valid"] for r in recs),
            f"kernel_bench: {sum(r['valid'] for r in recs)} of {len(recs)} records valid")


def phase_probes(bg, sched) -> dict:
    """probe_topk (K4, K1, K8) at its default size, and probe_bricks (K5,
    f32 and bf16) on its default graph `bg` and schedule `sched`; each exits
    non-zero on a failed check. Returns K5's times and bound by dtype."""
    from maxk_tpu_torch.bench import probe_bricks, probe_topk

    t0 = time.perf_counter()
    t = probe_topk.main(["--device", "cuda"])
    emit("probe_topk", seconds=time.perf_counter() - t0,
         **{f"{k}_ms": 1e3 * s for k, s in t.items()})
    k5 = {}
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        out = probe_bricks.probe(bg, sched, DIM, dtype)
        emit("probe_bricks", seconds=time.perf_counter() - t0, **out)
        lib = out["library_s"]
        # the bound of the function Y = A @ X on this run's graph, as the
        # probe computes it (probe_bricks.function_bound)
        k5[dtype] = dict(ms=1e3 * out["bricks_s"], plain_ms=1e3 * out["plain_s"],
                         library_ms=None if lib is None else 1e3 * lib,
                         heaviest_block_share=out["heaviest_block_share"],
                         bound_ms=out["bound_ms"], bound_by=out["bound_by"])
    return k5


def phase_micro():
    from maxk_tpu_torch.bench import micro

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        t = micro.main(["--device", "cuda"])
    emit("micro", seconds=time.perf_counter() - t0,
         **{f"{k}_ms": 1e3 * s for k, s in t.items()})


CAMPAIGN_GRAPHS = ("rmat_v65536_d20", "rmat_v65536_d100")  # either side of avg degree 50


def phase_campaign(csr, cards: int) -> None:
    """The campaign scripts of `maxk_tpu_torch.bench`, each at a small size
    through its entry point: `degree_sweep` on two R-MAT graphs either side
    of average degree 50 (one `kernel_bench` child a graph, validated, with
    `--dispatch_check`) and `assemble_suite` on its records; `spgemm_study`
    and `three_arms` at scale 0.02; `memcheck` A at k 8 and 32 on the
    reddit ×1.0 graph `csr` already in memory, B at its default scale;
    one `ksweep` arm triple for 3 epochs; `scaling` at n = min(2, cards);
    `plots.main` over their JSON where matplotlib is installed (the phase
    line says when it is not); and a 2-epoch `--validate_kernels` run
    through `python -m maxk_tpu_torch`'s entry. Every record must be
    valid, the suite's audit consistent, and `t_cusparse_ms` above 0 in
    every record."""
    import importlib.util
    import tempfile

    from maxk_tpu_torch.__main__ import main as cli
    from maxk_tpu_torch.bench import (
        assemble_suite,
        degree_sweep,
        ksweep,
        memcheck,
        plots,
        scaling,
        spgemm_study,
        three_arms,
    )

    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    with tempfile.TemporaryDirectory() as tmp:
        t = Path(tmp)
        sweep = timed("degree_sweep", degree_sweep.main, [
            "--graphs", *CAMPAIGN_GRAPHS, "--scale", "1.0", "--timeout", "300",
            "--dir", str(t / "sweep"), "--out", str(t / "sweep.json")])
        suite = timed("assemble_suite", assemble_suite.main, [
            "--dir", str(t / "sweep"), "--out", str(t / "suite.json")])
        recs = [r for r in suite["results"] if "k" in r]
        checks = [r for f in sorted((t / "sweep").glob("*.json"))
                  for r in json.loads(f.read_text()) if r.get("kind") == "dispatch_check"]
        study = timed("spgemm_study", spgemm_study.main, [
            "--scale", "0.02", "--json_out", str(t / "study.json")])
        arms = timed("three_arms", three_arms.main, [
            "--scale", "0.02", "--out", str(t / "three.json")])
        mem = timed("memcheck", memcheck.run, csr, DIM, [8, 32], 0.02, "cuda")
        timed("ksweep", ksweep.main, [
            "--datasets", "flickr", "--models", "sage", "--k", "8", "--scale", "0.01",
            "--epochs", "3", "--hidden_dim", "64", "--hidden_layers", "2",
            "--json_out", str(t / "ksweep.json")])
        n = min(2, cards)
        scal = timed("scaling", scaling.main, [
            "--devices", str(n), "--scale", "0.02", "--hidden_dim", "64", "--maxk", "16",
            "--iters", "5", "--repeats", "1", "--warmup", "2",
            "--json_out", str(t / "scaling.json")])
        # the figures need matplotlib, which the card's machine may lack;
        # the CPU tests render each of them from the same record layout
        figs = None
        if importlib.util.find_spec("matplotlib") is not None:
            figs = timed("plots", plots.main, [
                "--kernel", str(t / "suite.json"), "--degree", str(t / "sweep.json"),
                "--ksweep", str(t / "ksweep.json"), "--scaling", str(t / "scaling.json"),
                "--study", str(t / "study.json"), "--three_arms", str(t / "three.json"),
                "--out", str(t / "figs")])
            figs_ok = len(figs) == 6 and all(Path(f).stat().st_size > 0 for f in figs)
        timed("validate_kernels", cli, [
            "--dataset", "flickr", "--data_scale", "0.02", "--epochs", "2",
            "--hidden_dim", str(DIM), "--hidden_layers", "2", "--maxk", str(K),
            "--validate_kernels", "--path", str(t / "vk")])
        log = (t / "vk" / "flickr_seed97" / "sage_maxk" / "train.log").read_text()
        vk = [line.split("INFO ", 1)[-1] for line in log.splitlines()
              if "kernel validation:" in line]

    emit("campaign", seconds=seconds, total_s=sum(seconds.values()),
         sweep_failed=sweep.get("failed", []), consistency=suite["consistency"],
         summary=suite["summary"],
         suite=[{f: r.get(f) for f in ("graph", "V", "E", "k", "mode", "t_fwd_ms",
                                        "t_baseline_ms", "t_cusparse_ms", "t_cusparse_bf16_ms",
                                        "speedup_vs_baseline", "speedup_vs_cusparse", "valid")}
                for r in recs],
         dispatch_checks=checks,
         spgemm_study=[{"sparsity": r["sparsity"], "hybrid_mean_rel_err": r["hybrid_mean_rel_err"],
                        **{a: v["total_ms"] for a, v in r.items() if isinstance(v, dict)}}
                       for r in study],
         three_arms=arms,
         memcheck={"op_level": [{f: r[f] for f in ("arm", "peak_bytes", "grad_bytes")}
                                for r in mem["op_level"]],
                   "train_step": [{f: r[f] for f in ("arm", "peak_bytes")}
                                  for r in mem["train_step"]]},
         scaling=[{f: r.get(f) for f in ("arm", "n", "step_ms", "recv_bytes_per_step",
                                          "analytic_step_ms")} for r in scal],
         figures=len(figs) if figs is not None else "matplotlib is not installed: not rendered",
         validate_kernels=vk)
    require(not sweep.get("failed"), f"degree_sweep: failed graphs {sweep.get('failed')}")
    require(len(recs) == 2 * len(CAMPAIGN_GRAPHS) and all(r.get("valid") for r in recs),
            f"degree_sweep: {sum(bool(r.get('valid')) for r in recs)} of {len(recs)} valid")
    require(suite["consistency"]["ok"], f"assemble_suite: {suite['consistency']['violations']}")
    require(all(r["t_cusparse_ms"] > 0 and r["t_cusparse_bf16_ms"] for r in recs),
            "kernel_bench: a record without its cuSPARSE times")
    require(len(study) == 4, f"spgemm_study: {len(study)} of 4 sparsities")
    require(all(r.get(f"{a}_valid") for r in arms for a in ("tiles_scan", "hybrid", "bricks")),
            f"three_arms: {[{a: r.get(f'{a}_valid') for a in ('tiles_scan', 'hybrid', 'bricks')} for r in arms]}")
    require(all(r["cusparse_ms"] > 0 for r in arms), "three_arms: no cuSPARSE time")
    require(all(r["measured"] and r["peak_bytes"] > 0 for r in mem["op_level"] + mem["train_step"]),
            "memcheck: an arm was not measured")
    require(len(scal) == 4 and all(math.isfinite(r["step_ms"]) for r in scal),
            f"scaling: {len(scal)} records")
    require(figs is None or figs_ok, f"plots: {figs}")
    require(len(vk) == 1 and "ok=True" in vk[0], f"--validate_kernels: {vk}")


def phase_small_slice():
    """3 training steps at a small size, on the card (kernels) and on the
    CPU (plain versions), from the same seed, under segsum (where AUTO would
    differ between the two): the losses must agree."""
    from maxk_tpu_torch.data.datasets import load_dataset
    from maxk_tpu_torch.train.config import TrainConfig
    from maxk_tpu_torch.train.loop import train

    data = load_dataset("reddit", scale=0.002, seed=123)
    losses = {}
    for device in ("cpu", "cuda"):
        cfg = TrainConfig(dataset="reddit", epochs=3, hidden_dim=64, hidden_layers=2,
                          maxk=8, dropout=0.0, lr=0.01, kernel_mode="segsum", device=device)
        losses[device] = train(cfg, data, warmup_epochs=3).losses
    # summation order differs between devices; a top-k near-tie that the
    # order flips moves one row of V, so the bound is 1e-3 relative
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    emit("small_slice", nodes=data.csr.num_nodes, edges=data.csr.nnz,
         cuda_losses=losses["cuda"], cpu_losses=losses["cpu"], max_rel_diff=rel, rtol=1e-3)
    require(rel <= 1e-3, f"small slice: CUDA and CPU losses differ by {rel}")


def phase_sharded_small(names) -> dict:
    """3 steps at the small size for SAGE, GCN and GIN: the single-device
    path on the CPU (plain versions) and on the card, and the sharded path
    at world size 1 on the card (K4, NCCL collectives, maxk_spgemm), from
    the same parameters: the losses must agree. Then ogbn-proteins at a
    small scale the same way, whose sharded eval ranks the all-gathered
    rows for ROC-AUC (`gathered_rocauc`): it must equal the single-device
    `rocauc` on the same logits, bit for bit. Returns the kernel launches of the proteins case, counted from
    0 (the sharded segsum path: K4, K10, K3, K11)."""
    import torch

    from maxk_tpu_torch.data.datasets import load_dataset
    from maxk_tpu_torch.parallel.mesh import destroy_mesh, free_tcp_init_method, init_mesh
    from maxk_tpu_torch.parallel.train import gathered_rocauc, train_sharded
    from maxk_tpu_torch.train.config import TrainConfig
    from maxk_tpu_torch.train.loop import train
    from maxk_tpu_torch.train.metrics import rocauc

    data = load_dataset("reddit", scale=0.002, seed=123)
    proteins = load_dataset("ogbn-proteins", scale=0.01, seed=123, feat_snr=0.15,
                            graph_kind="sbm")
    mesh = init_mesh(0, 1, "cuda", free_tcp_init_method())
    launches = {}
    try:
        for model, d in (("sage", data), ("gcn", data), ("gin", data), ("sage", proteins)):
            losses = {}
            for device in ("cpu", "cuda"):
                cfg = TrainConfig(dataset=d.name, model=model, epochs=3, hidden_dim=64,
                                  hidden_layers=2, maxk=8, dropout=0.0, lr=0.01,
                                  kernel_mode="segsum", device=device)
                losses[device] = train(cfg, d, warmup_epochs=3).losses
            if d is proteins:
                reset_launches(names)
            state = train_sharded(cfg, d, mesh, warmup_epochs=3)
            losses["sharded_cuda"] = state.losses
            # as in phase_small_slice: a top-k near-tie that the summation
            # order flips moves one row of V
            rel = {name: max(abs(a - b) / abs(b) for a, b in zip(ls, losses["cpu"]))
                   for name, ls in losses.items() if name != "cpu"}
            extra = {}
            if d is proteins:
                # one forward's logits (another forward's would differ in
                # their last bits: atomics); at world size 1 the gathered
                # rows are this rank's, unpadded
                with torch.no_grad():
                    logits = state.model(state.graph, state.feats, train=False)
                sharded = gathered_rocauc(logits, state.labels, state.masks, mesh)
                single = [rocauc(logits, state.labels, m) for m in state.masks]
                launches = read_launches(names)
                extra = dict(sharded_rocauc=[float(x) for x in sharded],
                             single_rocauc=[float(x) for x in single], launches=launches)
                require(all(torch.equal(a, b) for a, b in zip(sharded, single)),
                        f"sharded proteins: sharded ROC-AUC {extra['sharded_rocauc']} != "
                        f"single-device {extra['single_rocauc']} on the same logits")
                require(all(0.0 < x < 1.0 for x in extra["sharded_rocauc"]),
                        f"sharded proteins: ROC-AUC {extra['sharded_rocauc']} outside (0, 1)")
                for name in ("topk_cbsr", "spgemm_cbsr", "sspmm_cbsr", "cbsr_sample"):
                    require(launches[name] > 0,
                            f"{name} was not launched on the sharded proteins case")
            emit("sharded_small", model=model, dataset=d.name, world_size=1,
                 nodes=d.csr.num_nodes, edges=d.csr.nnz, losses=losses,
                 max_rel_diff_vs_cpu=rel, rtol=1e-3, **extra)
            require(all(math.isfinite(x) for ls in losses.values() for x in ls),
                    f"sharded small {model} {d.name}: non-finite losses {losses}")
            require(max(rel.values()) <= 1e-3,
                    f"sharded small {model} {d.name}: losses differ by {rel}")
    finally:
        destroy_mesh(mesh)
    return launches


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
    """maxk_spgemm under segsum (K10 forward, K11 backward), forward and
    forward+backward, bf16 compute, against the plain path (plain densify
    and sample around the plain segment-sum SpMM)."""
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
        return maxk_spgemm(graph, CBSR(vals, sel), dim=DIM, mode="segsum", compute_dtype=bf16)

    def fwd_bwd():
        va = vals.detach().requires_grad_(True)
        y = maxk_spgemm(graph, CBSR(va, sel), dim=DIM, mode="segsum", compute_dtype=bf16)
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
    # both paths sum in f32 (the plain one with index_add_ atomics, whose
    # order varies run to run) and round once to bf16: they may differ by
    # one bf16 ulp, 2^-7 of the largest magnitude at most
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
    """The main path's training, under `--kernel_mode segsum` (K4 and its
    densify, K10 forward and K11 backward in every layer): the baseline
    that tiles_train's and hybrid_train's steps and losses are held to,
    whatever AUTO picks on this graph; then one more step under the
    profiler (`step_profile`: busy share, top kernels)."""
    import torch

    from maxk_tpu_torch.train.config import TrainConfig
    from maxk_tpu_torch.train.logging import get_logger
    from maxk_tpu_torch.train.loop import _device_arrays, make_train_step, train

    cfg = TrainConfig(dataset="reddit", model="sage", epochs=EPOCHS, lr=0.01,
                      hidden_dim=DIM, hidden_layers=LAYERS, maxk=K, dropout=0.5,
                      kernel_mode="segsum", device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train(cfg, data, logger=get_logger(name="chip_smoke"), warmup_epochs=2)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses, best_val, times = state.losses, state.best_val, state.epoch_times
    step_ms = 1e3 * sum(times) / len(times)
    # one more step, profiled: where the segsum step's device time goes
    step = make_train_step(state.model, state.optimizer, data.multilabel)
    feats, labels, masks = _device_arrays(data, state.device)
    profile = device_busy(lambda: step(state.graph, feats, labels, masks[0], state.generator),
                          top=10)
    del step, feats, labels, masks, state
    emit("train", nodes=data.csr.num_nodes, edges=data.csr.nnz, layers=LAYERS,
         hidden=DIM, k=K, dropout=0.5, lr=0.01, epochs=EPOCHS, losses=losses,
         step_ms_post_warmup=step_ms, step_ms=[1e3 * t for t in times], best_val=best_val,
         wall_s=wall, max_memory_allocated=peak, step_profile=profile)
    require(len(losses) == EPOCHS and all(math.isfinite(x) for x in losses),
            f"training: non-finite or missing losses {losses}")
    require(losses[-1] < losses[0], f"training: loss did not fall {losses}")
    return losses, step_ms


def device_busy(fn, top: int = 0) -> dict:
    """One call of `fn()` under `torch.profiler` (CPU and CUDA): its wall
    time by CUDA events, the summed time of the device kernels the profiler
    recorded, and their share of the wall (None when it recorded none);
    with `top`, the `top` kernel names with the most device time (ms each).
    The profiler's own host cost lowers the share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    out = {"profiled_wall_ms": wall, "kernel_ms": busy, "kernels": len(kernels),
           "busy_share": busy / wall if kernels else None}
    if top:
        by_name = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        out["top_kernels_ms"] = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:top])
    return out


def phase_host_tiles(data, graph):
    """The edge-tile tables (R = 8, T = 256) of the reddit ×1.0 graph `graph`
    (right norm, on the card): the host library's build seconds, each
    table's host build seconds (`build_edge_tiles`, C++), tile count and
    device bytes; `build_edge_tiles_device` on the card equal to them; and
    the C++ builder equal to the numpy one at scale 0.02. Returns `graph`
    with the tables."""
    import torch

    from maxk_tpu_torch.data.datasets import load_dataset
    from maxk_tpu_torch.sparse import _native
    from maxk_tpu_torch.sparse.csr import with_norm
    from maxk_tpu_torch.sparse.graph import Graph
    from maxk_tpu_torch.sparse.meta import (
        build_edge_tiles,
        build_edge_tiles_device,
        build_edge_tiles_numpy,
    )

    t0 = time.perf_counter()
    _native.build()
    native_build_s = time.perf_counter() - t0
    require(_native.available(), "sparse/_native: the host library did not load")
    tables, rec = {}, {}
    for name, csr in (("A", graph.csr), ("At", graph.csc)):
        t0 = time.perf_counter()
        tables[name] = build_edge_tiles(csr).to("cuda")
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        dev = build_edge_tiles_device(csr)
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
        t = tables[name]
        equal = all(torch.equal(getattr(dev, f), getattr(t, f)) for f in TILE_FIELDS)
        rec[name] = dict(num_tiles=t.num_tiles, device_bytes=t.nbytes,
                         live_slot_share=csr.nnz / (t.num_tiles * t.edge_tile),
                         host_build_s=host_s, device_build_s=dev_s, device_equal_host=equal)
        require(equal, f"build_edge_tiles_device ({name}) differs from the host tables")
        del dev
    small = with_norm(load_dataset("reddit", scale=0.02, seed=123).csr, "right")
    t0 = time.perf_counter()
    nat = build_edge_tiles(small)
    nat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    npy = build_edge_tiles_numpy(small)
    npy_s = time.perf_counter() - t0
    same = all(torch.equal(getattr(nat, f), getattr(npy, f)) for f in TILE_FIELDS)
    emit("host_tiles", nodes=graph.num_nodes, edges=graph.nnz, row_block=8, edge_tile=256,
         native_build_s=native_build_s, tables=rec,
         small={"scale": 0.02, "edges": small.nnz, "num_tiles": nat.num_tiles,
                "native_s": nat_s, "numpy_s": npy_s, "native_equal_numpy": same})
    require(same, "the C++ tile builder differs from the numpy one at scale 0.02")
    return Graph(csr=graph.csr, csc=graph.csc, tiles=tables["A"], tiles_t=tables["At"])


def phase_tiles_op(tgraph):
    """On reddit ×1.0 with its tile tables `tgraph`: `spmm(mode="tiles_scan")`
    over A and Aᵀ, f32 and bf16, against `spmm(mode="segsum")` and
    `torch.sparse.mm` (a CSR tensor, the features' dtype) on the same
    inputs, by CUDA events; `maxk_spgemm` under tiles_scan, forward and
    backward at k = 32 with bf16 compute (K2, K3), against its segsum mode;
    and `tiles_xla` at scale 0.02."""
    import torch

    from maxk_tpu_torch.data.datasets import load_dataset
    from maxk_tpu_torch.ops.spgemm import maxk_spgemm, spmm
    from maxk_tpu_torch.sparse.cbsr import CBSR
    from maxk_tpu_torch.sparse.graph import Graph, build_graph

    v = tgraph.num_nodes
    gen = torch.Generator(device="cuda").manual_seed(7)
    spmms = []
    for name, csr, tiles in (("A", tgraph.csr, tgraph.tiles), ("At", tgraph.csc, tgraph.tiles_t)):
        view = Graph(csr=csr, csc=csr, tiles=tiles, tiles_t=tiles)
        for dtype in (torch.float32, torch.bfloat16):
            tag = str(dtype).split(".")[-1]
            x = torch.randn((v, DIM), generator=gen, device="cuda").to(dtype)
            y = spmm(view, x, mode="tiles_scan").float()
            ref = spmm(view, x, mode="segsum").float()
            rel = ((y - ref).abs().max() / ref.abs().max()).item()
            del y, ref
            # tiles_scan's time is mostly host launches, which move with the
            # host: two runs of 3 calls a mode, in turns, the mean beside both
            runs = {"tiles_scan": [], "segsum": []}
            for order in (("tiles_scan", "segsum"), ("segsum", "tiles_scan")):
                for m in order:
                    runs[m].append(cuda_ms(lambda m=m: spmm(view, x, mode=m), 3))
            t = {m: sum(r) / len(r) for m, r in runs.items()}
            busy = {}
            if name == "A" and dtype == torch.float32:
                busy = {m: device_busy(lambda m=m: spmm(view, x, mode=m))
                        for m in ("tiles_scan", "segsum")}
            a = torch.sparse_csr_tensor(csr.indptr.long(), csr.indices.long(), csr.values.to(dtype),
                                        (v, v))
            try:
                lib = cuda_ms(lambda: torch.sparse.mm(a, x), 3)
            except (NotImplementedError, RuntimeError) as e:  # the library's gap
                lib = f"{type(e).__name__}: {e}"[:200]
            del a, x
            # f32: both sum in f32 in another order; bf16: both sum in f32
            # and round once, so one bf16 ulp of the largest magnitude
            tol = 1e-5 if dtype == torch.float32 else 2.0**-7
            spmms.append(dict(operand=name, dtype=tag, tiles_scan_ms=t["tiles_scan"],
                              segsum_ms=t["segsum"], runs_ms=runs, sparse_mm_ms=lib,
                              tiles_over_segsum=t["tiles_scan"] / t["segsum"],
                              max_rel_diff=rel, tol=tol, profile=busy))
            require(rel <= tol, f"spmm tiles_scan {name} {tag}: {rel} from segsum > {tol}")

    vals = torch.randn((v, K), generator=gen, device="cuda")
    sel = torch.randint(0, DIM, (v, K), generator=gen, device="cuda", dtype=torch.int32)
    ct = torch.randn((v, DIM), generator=gen, device="cuda")
    bf16 = torch.bfloat16

    def fwd_bwd(mode):
        va = vals.detach().requires_grad_(True)
        y = maxk_spgemm(tgraph, CBSR(va, sel), dim=DIM, mode=mode, compute_dtype=bf16)
        torch.vdot(y.flatten(), ct.flatten()).backward()
        return y, va.grad

    out = {m: fwd_bwd(m) for m in ("tiles_scan", "segsum")}
    (y, dv), (y0, dv0) = out["tiles_scan"], out["segsum"]
    rel_y = ((y - y0).abs().max() / y0.abs().max()).item()
    rel_d = ((dv - dv0).abs().max() / dv0.abs().max()).item()
    finite = bool(torch.isfinite(y).all() and torch.isfinite(dv).all())
    del out, y, dv, y0, dv0
    t = {}
    for m in ("tiles_scan", "segsum"):
        t[f"{m}_fwd_ms"] = cuda_ms(
            lambda m=m: maxk_spgemm(tgraph, CBSR(vals, sel), dim=DIM, mode=m, compute_dtype=bf16), 3)
        t[f"{m}_fwd_bwd_ms"] = cuda_ms(lambda m=m: fwd_bwd(m), 3)
    tol = 1e-2  # as phase_op: both sum in f32 and round once to bf16
    op = dict(k=K, dim=DIM, compute_dtype="bfloat16", rel_diff_fwd=rel_y, rel_diff_grad=rel_d,
              tol=tol, finite=finite, **t)
    require(finite and rel_y <= tol and rel_d <= tol,
            f"maxk_spgemm tiles_scan vs segsum: {rel_y}, {rel_d} > {tol}")
    del vals, sel, ct

    small = load_dataset("reddit", scale=0.02, seed=123)
    sg = build_graph(small.csr, norm="right", build_tiles=True, device="cuda")
    x = torch.randn((sg.num_nodes, DIM), generator=gen, device="cuda")
    y = spmm(sg, x, mode="tiles_xla")
    ref = spmm(sg, x, mode="segsum")
    rel = ((y - ref).abs().max() / ref.abs().max()).item()
    xla = dict(scale=0.02, nodes=sg.num_nodes, edges=sg.nnz, num_tiles=sg.tiles.num_tiles,
               max_rel_diff=rel, tol=1e-5, tiles_xla_ms=cuda_ms(lambda: spmm(sg, x, mode="tiles_xla"), 3),
               segsum_ms=cuda_ms(lambda: spmm(sg, x, mode="segsum"), 3))
    emit("tiles_op", nodes=v, edges=tgraph.nnz, dim=DIM, spmm=spmms, maxk_spgemm=op,
         tiles_xla=xla)
    require(rel <= 1e-5, f"spmm tiles_xla at scale 0.02: {rel} from segsum > 1e-5")


def phase_tiles_train(data, segsum_losses, segsum_step_ms):
    """MaxK-SAGE 4×256, k=32, dropout 0.5, lr 0.01 on reddit ×1.0 under
    `--kernel_mode tiles_scan` for TILE_EPOCHS epochs (K1 in every layer, the
    tile SpMM its aggregation): the step beside the segsum step of the train
    phase, and the losses against that run's first epochs (the same
    parameters and dropout masks; the sums differ in order). Then the
    sharded small case at world size 1 under tiles_scan (K4, K2, K3 over
    the rank's tile tables) against the single-device path on the CPU."""
    import torch

    from maxk_tpu_torch.data.datasets import load_dataset
    from maxk_tpu_torch.parallel.mesh import destroy_mesh, free_tcp_init_method, init_mesh
    from maxk_tpu_torch.parallel.train import train_sharded
    from maxk_tpu_torch.train.config import TrainConfig
    from maxk_tpu_torch.train.loop import train

    cfg = TrainConfig(dataset="reddit", model="sage", epochs=TILE_EPOCHS, lr=0.01,
                      hidden_dim=DIM, hidden_layers=LAYERS, maxk=K, dropout=0.5,
                      kernel_mode="tiles_scan", device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train(cfg, data, warmup_epochs=1)
    wall = time.perf_counter() - t0
    losses = state.losses
    step = 1e3 * sum(state.epoch_times) / len(state.epoch_times)
    ref = segsum_losses[:TILE_EPOCHS]
    # a top-k near-tie that the summation order flips moves one row of V
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
    tiles = state.graph.tiles
    emit("tiles_train", nodes=data.csr.num_nodes, edges=data.csr.nnz, layers=LAYERS, hidden=DIM,
         k=K, dropout=0.5, lr=0.01, epochs=TILE_EPOCHS, kernel_mode="tiles_scan",
         losses=losses, segsum_losses=ref, max_rel_diff=rel, rtol=1e-3,
         step_ms=[1e3 * t for t in state.epoch_times], step_ms_post_warmup=step,
         segsum_step_ms_post_warmup=segsum_step_ms, step_over_segsum=step / segsum_step_ms,
         num_tiles=tiles.num_tiles, tables_bytes=tiles.nbytes + state.graph.tiles_t.nbytes,
         wall_s=wall, max_memory_allocated=torch.cuda.max_memory_allocated())
    require(len(losses) == TILE_EPOCHS and all(math.isfinite(x) for x in losses),
            f"tiles training: non-finite or missing losses {losses}")
    require(rel <= 1e-3, f"tiles training: losses {losses} differ from segsum's {ref} by {rel}")
    del state

    small = load_dataset("reddit", scale=0.002, seed=123)
    args = dict(dataset="reddit", epochs=3, hidden_dim=64, hidden_layers=2, maxk=8, dropout=0.0,
                lr=0.01)
    cpu = train(TrainConfig(device="cpu", **args), small, warmup_epochs=3).losses
    mesh = init_mesh(0, 1, "cuda", free_tcp_init_method())
    try:
        sharded = train_sharded(TrainConfig(device="cuda", kernel_mode="tiles_scan", **args),
                                small, mesh, warmup_epochs=3)
    finally:
        destroy_mesh(mesh)
    rel = max(abs(a - b) / abs(b) for a, b in zip(sharded.losses, cpu))
    emit("tiles_sharded_small", world_size=1, kernel_mode="tiles_scan",
         nodes=small.csr.num_nodes, edges=small.csr.nnz,
         fwd_tiles=sharded.graph.fwd_tiles.num_tiles, bwd_tiles=sharded.graph.bwd_tiles.num_tiles,
         losses=sharded.losses, cpu_segsum_losses=cpu, max_rel_diff=rel, rtol=1e-3)
    require(rel <= 1e-3, f"sharded tiles_scan: losses differ from the CPU's by {rel}")


def _host_max_rss_gb() -> float:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20  # KiB on Linux


def phase_host_hybrid(data):
    """The strip schedule of the reddit ×1.0 graph on the card, as training
    builds it (`build_graph(hybrid=True)`, right norm, its widths from the
    card's rates): the whole build's seconds, then each piece timed by
    itself (the symmetry check, the permutation, the strip and tail build,
    the tail tables alone); the strip's dtype, width and bytes; the tail's
    live edges, tiles and padding, held to `tail_slot_stats`; the peak
    device memory and the process's peak host memory (the strip goes
    straight to the card: no (Vp, S) f32 host array). Returns the graph."""
    import torch

    from maxk_tpu_torch.sparse import hybrid as hyb
    from maxk_tpu_torch.sparse.graph import build_graph
    from maxk_tpu_torch.sparse.meta import build_edge_tiles

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    rss0 = _host_max_rss_gb()
    graph, graph_s = timed(lambda: build_graph(data.csr, norm="right", device="cuda",
                                               hybrid=True, dim=DIM))
    h = graph.hybrid
    require(h is not None, "build_graph(hybrid=True) built no schedule on reddit x1.0")
    peak = torch.cuda.max_memory_allocated()
    csr = data.csr.to("cuda")
    ok, check_s = timed(lambda: hyb.check_hybrid_ok(csr))
    pcsr, perm_s = timed(lambda: hyb.permute_csr(csr, hyb.degree_perm(csr)))
    del csr
    rates = hyb.card_rates("cuda")
    dtype = hyb.auto_strip_dtype(pcsr)
    e_live = int(pcsr.indptr[-1])
    s_auto = hyb.auto_strip_cols(pcsr.num_nodes, e_live=e_live, dim=DIM,
                                 strip_itemsize=torch.empty((), dtype=dtype).element_size(),
                                 rates=rates)
    again, build_s = timed(lambda: hyb.build_hybrid(pcsr, s_cols=s_auto, norm="right",
                                                    strip_dtype=dtype))
    same = torch.equal(again.strip, h.strip) and torch.equal(again.tail_tiles.cols,
                                                             h.tail_tiles.cols)
    del again
    rows, cols, vals = hyb._live(pcsr)
    m = (rows >= h.s_cols) & (cols >= h.s_cols) & (vals != 0)
    _, tail_s = timed(lambda: build_edge_tiles(
        hyb._subgraph(pcsr.num_nodes, rows[m], cols[m], vals[m]), 8,
        h.tail_tiles.edge_tile).to("cuda"))
    del rows, cols, vals, m
    t = h.tail_tiles
    tail_live = int((t.vals != 0).sum())
    stats = hyb.tail_slot_stats(pcsr, h.s_cols, edge_tile=t.edge_tile, presorted=True)
    rec = dict(nodes=h.num_nodes, edges=e_live, hbm_bytes=rates.hbm_bytes,
               strip_budget=rates.strip_budget, strip_dtype=str(h.strip.dtype).split(".")[-1],
               s_cols=h.s_cols, s_auto=s_auto, strip_bytes=h.strip.numel() * h.strip.element_size(),
               tail_live=tail_live, tail_share=tail_live / e_live, tail_tiles=t.num_tiles,
               tail_edge_tile=t.edge_tile, tail_pad_ratio=t.num_tiles * t.edge_tile / tail_live,
               tail_chunk=h.tail_chunk, tail_window=h.tail_window,
               strip_line_sum=h.strip_line_sum, schedule_bytes=h.nbytes,
               build_graph_s=graph_s, check_s=check_s, permute_s=perm_s,
               build_hybrid_s=build_s, tail_tables_s=tail_s, strip_s=build_s - tail_s,
               max_memory_allocated=peak, host_max_rss_gb_before=rss0,
               host_max_rss_gb_after=_host_max_rss_gb(), stats_tiles=stats["tiles"])
    emit("host_hybrid", **rec)
    require(ok, "reddit x1.0 is not value-symmetric")
    require(same, "build_hybrid on the card differs from build_graph's schedule")
    require(stats["tiles"] == t.num_tiles and stats["tail_live"] == tail_live,
            f"tail_slot_stats {stats} against the tables' {t.num_tiles} tiles, {tail_live} live")
    require(h.strip.dtype == torch.int8, f"the reddit strip is {h.strip.dtype}, not int8")
    return graph


def phase_hybrid_op(hgraph):
    """On reddit ×1.0 with its strip schedule `hgraph` (permuted, right norm):
    `spmm(mode="hybrid")` over A and Aᵀ, f32 and bf16, against
    `spmm(mode="segsum")` (K9) and `torch.sparse.mm` on the same inputs (two
    runs of 3 calls a mode, in turns), each element within 2^-6 · (|A| @ |x|) +
    2^-7 · |ref| + 1e-5 · max|ref| of segsum's (each side rounds a term at
    most twice to bf16, a scale and a feature or a product, a relative 2^-8
    each, and its bf16 result once); the A f32 call's pieces timed
    apart (the int8 strip's conversion alone, the two strip products with
    it, the tail scan) and one call profiled (launches, device busy share);
    `hybrid_int8` against the exact hybrid, within its quantization bound;
    `maxk_spgemm` under hybrid (K2, K3), forward and backward at k = 32,
    bf16 compute, against its segsum mode."""
    import torch

    from maxk_tpu_torch.ops import spmm_hybrid as sh
    from maxk_tpu_torch.ops.spgemm import maxk_spgemm, spmm
    from maxk_tpu_torch.ops.spmm_xla import spmm_segsum, spmm_tiles_scan
    from maxk_tpu_torch.sparse.cbsr import CBSR
    from maxk_tpu_torch.sparse.graph import Graph

    h = hgraph.hybrid
    v = h.num_nodes
    gen = torch.Generator(device="cuda").manual_seed(11)
    spmms, parts = [], {}
    for name, csr in (("A", hgraph.csr), ("At", hgraph.csc)):
        view = Graph(csr=csr, csc=csr, hybrid=h if name == "A" else None)

        def hybrid_call(x, name=name):
            if name == "A":
                return spmm(view, x, mode="hybrid")
            return sh.spmm_hybrid(h, x, transpose=True)

        for dtype in (torch.float32, torch.bfloat16):
            tag = str(dtype).split(".")[-1]
            x = torch.randn((v, DIM), generator=gen, device="cuda").to(dtype)
            y = hybrid_call(x).float()
            ref = spmm_segsum(csr, x).float()
            absref = spmm_segsum(csr, x.abs().float())
            slack = 2.0**-6 * absref + 2.0**-7 * ref.abs() + 1e-5 * ref.abs().max()
            ratio = float(((y - ref).abs() / slack).max())
            rel = float((y - ref).abs().max() / ref.abs().max())
            del y, ref, absref, slack
            runs = {"hybrid": [], "segsum": []}
            for order in (("hybrid", "segsum"), ("segsum", "hybrid")):
                for m in order:
                    fn = (lambda: hybrid_call(x)) if m == "hybrid" else (
                        lambda: spmm(view, x, mode="segsum"))
                    runs[m].append(cuda_ms(fn, 3))
            t = {m: sum(r) / len(r) for m, r in runs.items()}
            a = torch.sparse_csr_tensor(csr.indptr.long(), csr.indices.long(),
                                        csr.values.to(dtype), (v, v))
            try:
                lib = cuda_ms(lambda: torch.sparse.mm(a, x), 3)
            except (NotImplementedError, RuntimeError) as e:  # the library's gap
                lib = f"{type(e).__name__}: {e}"[:200]
            del a
            busy = {}
            if name == "A" and dtype == torch.float32:
                busy = {m: device_busy(lambda m=m: spmm(view, x, mode=m))
                        for m in ("hybrid", "segsum")}
                s = h.s_cols
                xc = x.to(torch.bfloat16)
                buf = torch.empty((sh.ROW_CHUNK, s), dtype=torch.bfloat16, device="cuda")

                def convert():  # returns the buffer, so timeit takes CUDA events
                    for r0, r1 in sh._row_ranges(v, s, sh.ROW_CHUNK):
                        buf[: r1 - r0].copy_(h.strip[r0:r1])
                    return buf

                arms = lambda: sh._strip_arms(h.strip, xc, xc[:s], 0)  # noqa: E731
                acc0 = arms()[1]
                parts = {"strip_convert_ms": cuda_ms(convert, 3),
                         "strip_arms_ms": cuda_ms(arms, 3),
                         "tail_scan_ms": cuda_ms(lambda: spmm_tiles_scan(
                             h.tail_tiles, x, chunk=h.tail_chunk, acc0=acc0,
                             window=h.tail_window or None), 3)}
                parts["strip_products_ms"] = parts["strip_arms_ms"] - parts["strip_convert_ms"]
                del buf, xc, acc0
                # the lossy int8-feature mode against the exact hybrid
                yq, ye = sh.spmm_hybrid(h, x, feat_int8=True), sh.spmm_hybrid(h, x)
                bound = sh.int8_error_bound(h, x)
                err, ymax = float((yq - ye).abs().max()), float(ye.abs().max())
                parts["hybrid_int8"] = dict(
                    max_abs_diff=err, bound=bound, max_rel_diff=err / ymax,
                    ms=cuda_ms(lambda: sh.spmm_hybrid(h, x, feat_int8=True), 3))
                del yq, ye
                # the lossy bound, never the exact tolerance (f32 sums' slack)
                require(err <= bound + 1e-5 * ymax,
                        f"hybrid_int8: {err} from the exact hybrid, beyond its bound {bound}")
            del x
            spmms.append(dict(operand=name, dtype=tag, hybrid_ms=t["hybrid"],
                              segsum_ms=t["segsum"], runs_ms=runs, sparse_mm_ms=lib,
                              hybrid_over_segsum=t["hybrid"] / t["segsum"],
                              max_rel_diff=rel, max_err_over_bound=ratio, profile=busy))
            require(ratio <= 1.0, f"spmm hybrid {name} {tag}: {ratio} of its bound from segsum")

    vals = torch.randn((v, K), generator=gen, device="cuda")
    sel = torch.randint(0, DIM, (v, K), generator=gen, device="cuda", dtype=torch.int32)
    ct = torch.randn((v, DIM), generator=gen, device="cuda")
    bf16 = torch.bfloat16

    def fwd_bwd(mode):
        va = vals.detach().requires_grad_(True)
        y = maxk_spgemm(hgraph, CBSR(va, sel), dim=DIM, mode=mode, compute_dtype=bf16)
        torch.vdot(y.flatten(), ct.flatten()).backward()
        return y, va.grad

    out = {m: fwd_bwd(m) for m in ("hybrid", "segsum")}
    (y, dv), (y0, dv0) = out["hybrid"], out["segsum"]
    rel_y = ((y - y0).abs().max() / y0.abs().max()).item()
    rel_d = ((dv - dv0).abs().max() / dv0.abs().max()).item()
    finite = bool(torch.isfinite(y).all() and torch.isfinite(dv).all())
    del out, y, dv, y0, dv0
    t = {}
    for m in ("hybrid", "segsum"):
        t[f"{m}_fwd_ms"] = cuda_ms(
            lambda m=m: maxk_spgemm(hgraph, CBSR(vals, sel), dim=DIM, mode=m, compute_dtype=bf16),
            3)
        t[f"{m}_fwd_bwd_ms"] = cuda_ms(lambda m=m: fwd_bwd(m), 3)
    tol = 2e-2  # bf16 values both ways; the hybrid's strip products round no product
    emit("hybrid_op", nodes=v, edges=hgraph.nnz, dim=DIM, s_cols=h.s_cols,
         strip_dtype=str(h.strip.dtype).split(".")[-1], tail_chunk=h.tail_chunk,
         row_chunk=sh.ROW_CHUNK, spmm=spmms, parts=parts,
         maxk_spgemm=dict(k=K, compute_dtype="bfloat16", rel_diff_fwd=rel_y, rel_diff_grad=rel_d,
                          tol=tol, finite=finite, **t))
    require(finite and rel_y <= tol and rel_d <= tol,
            f"maxk_spgemm hybrid vs segsum: {rel_y}, {rel_d} > {tol}")


def phase_hybrid_train(data, segsum_losses, segsum_step_ms, k9_sec_per_edge):
    """MaxK-SAGE 4×256, k=32, dropout 0.5, lr 0.01 on reddit ×1.0 under
    `--kernel_mode hybrid` for TILE_EPOCHS epochs (K1 in every layer, the
    strip hybrid its aggregation): the step beside the segsum step of the
    train phase (`step_over_segsum`), and the losses against that run's
    first epochs within 2e-2 relative (the same parameters; the hybrid's
    nodes are permuted, so the dropout masks fall on other nodes, and its
    strip features are rounded to bf16). Then the sharded small case at
    world size 1 under hybrid (K4, K2, K3 over the rank's strip) against
    the single-device hybrid on the CPU, and the AUTO rule's decision on
    this graph with its numbers, beside K9's seconds a live edge measured in
    this run (`k9_sec_per_edge`) and the measured step ratio."""
    import torch

    from maxk_tpu_torch.data.datasets import load_dataset
    from maxk_tpu_torch.parallel.mesh import destroy_mesh, free_tcp_init_method, init_mesh
    from maxk_tpu_torch.parallel.train import train_sharded
    from maxk_tpu_torch.sparse import hybrid as hyb
    from maxk_tpu_torch.train.config import TrainConfig
    from maxk_tpu_torch.train.loop import train

    cfg = TrainConfig(dataset="reddit", model="sage", epochs=TILE_EPOCHS, lr=0.01,
                      hidden_dim=DIM, hidden_layers=LAYERS, maxk=K, dropout=0.5,
                      kernel_mode="hybrid", device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train(cfg, data, warmup_epochs=1)
    wall = time.perf_counter() - t0
    losses = state.losses
    step = 1e3 * sum(state.epoch_times) / len(state.epoch_times)
    ref = segsum_losses[:TILE_EPOCHS]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
    h = state.graph.hybrid
    emit("hybrid_train", nodes=data.csr.num_nodes, edges=data.csr.nnz, layers=LAYERS, hidden=DIM,
         k=K, dropout=0.5, lr=0.01, epochs=TILE_EPOCHS, kernel_mode="hybrid",
         losses=losses, segsum_losses=ref, max_rel_diff=rel, rtol=2e-2,
         step_ms=[1e3 * t for t in state.epoch_times], step_ms_post_warmup=step,
         segsum_step_ms_post_warmup=segsum_step_ms, step_over_segsum=step / segsum_step_ms,
         s_cols=h.s_cols, strip_dtype=str(h.strip.dtype).split(".")[-1],
         schedule_bytes=h.nbytes, wall_s=wall, best_val=state.best_val,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    require(len(losses) == TILE_EPOCHS and all(math.isfinite(x) for x in losses),
            f"hybrid training: non-finite or missing losses {losses}")
    require(rel <= 2e-2, f"hybrid training: losses {losses} differ from segsum's {ref} by {rel}")
    del state

    rates = hyb.card_rates("cuda")
    v, e = data.csr.num_nodes, int(data.csr.indptr[-1])
    s = hyb.auto_strip_cols(v, e_live=e, dim=DIM, strip_itemsize=1, rates=rates)
    emit("auto_rule", nodes=v, edges=e, s_cols=s, matmul_flops=rates.matmul_flops,
         gather_sec_per_edge=rates.gather_sec_per_edge,
         k9_sec_per_edge_this_run=k9_sec_per_edge, hbm_bytes=rates.hbm_bytes,
         strip_products_s=3.0 * -(-v // 128) * 128 * s * DIM * 2 / rates.matmul_flops,
         gather_s=e * rates.gather_sec_per_edge,
         auto_picks_hybrid=hyb.auto_hybrid(data.csr, dim=DIM, device="cuda"),
         hybrid_step_over_segsum=step / segsum_step_ms)

    small = load_dataset("reddit", scale=0.002, seed=123)
    args = dict(dataset="reddit", epochs=3, hidden_dim=64, hidden_layers=2, maxk=8, dropout=0.0,
                lr=0.01, kernel_mode="hybrid")
    cpu = train(TrainConfig(device="cpu", **args), small, warmup_epochs=3).losses
    mesh = init_mesh(0, 1, "cuda", free_tcp_init_method())
    try:
        sharded = train_sharded(TrainConfig(device="cuda", **args), small, mesh, warmup_epochs=3)
    finally:
        destroy_mesh(mesh)
    rel = max(abs(a - b) / abs(b) for a, b in zip(sharded.losses, cpu))
    emit("hybrid_sharded_small", world_size=1, kernel_mode="hybrid",
         nodes=small.csr.num_nodes, edges=small.csr.nnz, s_cols=sharded.graph.hybrid.s_cols,
         losses=sharded.losses, cpu_hybrid_losses=cpu, max_rel_diff=rel, rtol=1e-3)
    require(rel <= 1e-3, f"sharded hybrid: losses differ from the CPU's by {rel}")


def phase_lookahead_ckpt():
    """Through `python -m maxk_tpu_torch`'s entry (`__main__.main`), on the
    card: MaxK-SAGE 4×256, k=32, dropout 0.5 with Lookahead (k = 2) on
    reddit ×0.02 for 6 epochs with `--checkpoint_every 3`; the same cut
    after 3 epochs and run again to 6, which resumes from `ckpt_2`: its
    losses against the uninterrupted run's last 3 (rtol 1e-3: segsum's
    atomics change the sums' last bits from run to run). Then `--evaluate`
    on the uninterrupted run's `best/`: its validation value against the
    logged best, within two validation nodes (the atomics may flip an
    argmax)."""
    import tempfile

    from maxk_tpu_torch.__main__ import main as cli
    from maxk_tpu_torch.data.datasets import load_dataset

    common = ["--device", "cuda", "--dataset", "reddit", "--data_scale", "0.02",
              "--hidden_layers", str(LAYERS), "--hidden_dim", str(DIM), "--maxk", str(K),
              "--dropout", "0.5", "--lr", "0.01", "--enable_lookahead", "--w_lookahead", "2",
              "--checkpoint_every", "3"]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        whole = cli(common + ["--epochs", "6", "--path", f"{tmp}/whole"])
        cli(common + ["--epochs", "3", "--path", f"{tmp}/cut"])
        resumed = cli(common + ["--epochs", "6", "--path", f"{tmp}/cut"])
        exp = Path(tmp) / "whole" / "reddit_seed97" / "sage_maxk"
        tr, va, te = cli(common + ["--epochs", "6", "--path", f"{tmp}/eval",
                                   "--evaluate", str(exp / "best")])
        wall = time.perf_counter() - t0
        layout = sorted(p.name for p in exp.iterdir() if p.is_dir())
    n_val = int(load_dataset("reddit", scale=0.02, seed=123).val_mask.sum())
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed.losses, whole.losses[3:]))
    emit("lookahead_ckpt", scale=0.02, layers=LAYERS, hidden=DIM, k=K, lookahead_k=2,
         checkpoint_every=3, layout=layout, losses=whole.losses, resumed_losses=resumed.losses,
         max_rel_diff=rel, rtol=1e-3, best_val=whole.best_val, evaluate_val=va,
         evaluate_train_test=[tr, te], val_nodes=n_val, wall_s=wall)
    require(layout == ["best", "ckpt_2", "ckpt_5"], f"checkpoint layout {layout}")
    require(len(resumed.losses) == 3 and rel <= 1e-3,
            f"resumed losses {resumed.losses} against {whole.losses[3:]}: {rel}")
    require(abs(va - whole.best_val) <= 2.0 / n_val,
            f"--evaluate best/: val {va} against the logged best {whole.best_val}")


def sharded_train_rank(mesh, names, data=None) -> dict:
    """One rank of the full-width sharded run: counts reset to 0, train
    SHARDED_EPOCHS epochs, counts read. `data` None: load it (a spawned
    rank); rank 0's summary is the phase's."""
    import torch

    from maxk_tpu_torch.data.datasets import load_dataset
    from maxk_tpu_torch.parallel.train import train_sharded
    from maxk_tpu_torch.train.config import TrainConfig

    if data is None:
        data = load_dataset("reddit", scale=1.0, seed=123)
    cfg = TrainConfig(dataset="reddit", model="sage", epochs=SHARDED_EPOCHS, lr=0.01,
                      hidden_dim=DIM, hidden_layers=LAYERS, maxk=K, dropout=0.5,
                      device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_launches(names)
    t0 = time.perf_counter()
    state = train_sharded(cfg, data, mesh, warmup_epochs=1)
    wall = time.perf_counter() - t0
    launches = read_launches(names)
    return {"losses": state.losses, "step_ms": [1e3 * t for t in state.epoch_times],
            "launches": launches, "collective_bytes_per_step": state.step_bytes,
            "shard_nodes": state.graph.shard_nodes, "shard_edges": state.graph.nnz,
            "wall_s": wall, "max_memory_allocated": torch.cuda.max_memory_allocated()}


def phase_sharded_train(data, names) -> dict:
    """MaxK-SAGE 4×256, k=32, dropout 0.5, lr 0.01 on reddit ×1.0 through the
    row-partitioned path, one rank per card. The process group is stopped
    before the phase returns."""
    import torch

    from maxk_tpu_torch.parallel.mesh import destroy_mesh, free_tcp_init_method, init_mesh, run_ranks

    n = torch.cuda.device_count()
    if n == 1:
        mesh = init_mesh(0, 1, "cuda", free_tcp_init_method())
        try:
            out = sharded_train_rank(mesh, names, data)
        finally:
            destroy_mesh(mesh)
    else:  # each rank generates the data from its seed
        out = run_ranks(sharded_train_rank, n, (names,), device_type="cuda")[0]
    losses, launches = out["losses"], out["launches"]
    emit("sharded_train", world_size=n, nodes=data.csr.num_nodes, edges=data.csr.nnz,
         layers=LAYERS, hidden=DIM, k=K, dropout=0.5, lr=0.01, epochs=SHARDED_EPOCHS,
         step_ms_post_warmup=sum(out["step_ms"]) / len(out["step_ms"]), **out)
    require(len(losses) == SHARDED_EPOCHS and all(math.isfinite(x) for x in losses),
            f"sharded training: non-finite or missing losses {losses}")
    require(losses[-1] < losses[0], f"sharded training: loss did not fall {losses}")
    # AUTO is segsum at reddit x1.0 on the card: K4, K3's resample and K10
    # forward, K11 over the transposed block backward
    for name in ("topk_cbsr", "spgemm_cbsr", "sspmm_cbsr", "cbsr_sample"):
        require(launches[name] > 0, f"{name} was not launched on the sharded path")
    require(launches["topk_cbsr"] >= LAYERS * SHARDED_EPOCHS,
            f"topk_cbsr launched {launches['topk_cbsr']} < {LAYERS * SHARDED_EPOCHS} times")
    return launches


def phase_gnn_res(data):
    """GNNRes (4×256, norm "both", no MaxK, so no kernel of ours) for
    GNN_EPOCHS epochs on the reddit ×1.0 graph: finite losses, and BatchNorm
    running statistics that the steps moved."""
    import torch

    from maxk_tpu_torch.train.config import TrainConfig
    from maxk_tpu_torch.train.loop import train

    cfg = TrainConfig(dataset="reddit", model="gnn_res", epochs=GNN_EPOCHS, lr=0.01,
                      hidden_dim=DIM, hidden_layers=LAYERS, dropout=0.5, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train(cfg, data, warmup_epochs=1)
    wall = time.perf_counter() - t0
    bn = [getattr(state.model, f"bn{i}") for i in range(LAYERS)]
    moved = all(not torch.equal(b.mean, torch.zeros_like(b.mean))
                and not torch.equal(b.var, torch.ones_like(b.var)) for b in bn)
    emit("gnn_res", nodes=data.csr.num_nodes, edges=data.csr.nnz, layers=LAYERS, hidden=DIM,
         epochs=GNN_EPOCHS, losses=state.losses, step_ms=[1e3 * t for t in state.epoch_times],
         step_ms_post_warmup=1e3 * sum(state.epoch_times) / len(state.epoch_times),
         best_val=state.best_val, running_stats_moved=moved,
         bn0_mean_abs=bn[0].mean.abs().mean().item(), bn0_var_mean=bn[0].var.mean().item(),
         wall_s=wall, max_memory_allocated=torch.cuda.max_memory_allocated())
    require(len(state.losses) == GNN_EPOCHS and all(math.isfinite(x) for x in state.losses),
            f"gnn_res: non-finite or missing losses {state.losses}")
    require(moved, "gnn_res: BatchNorm running statistics did not move")


def phase_golden() -> None:
    """Every golden row (`train.golden.GOLDEN`, the published widths) through
    `run_golden(gc, device="cuda")`: best validation value at or above its
    floor, and a MaxK kernel (K1 or K4) launched on every MaxK row. A row
    of `golden.KNOWN_MISSES` (each a ROADMAP C entry) may stay under its
    floor; it is printed as such."""
    from maxk_tpu_torch.train.golden import GOLDEN, KNOWN_MISSES, row_id, run_golden

    missed = []
    for gc in GOLDEN:
        before = maxk_launches()
        t0 = time.perf_counter()
        best_val, best_test = run_golden(gc, device="cuda")
        row = row_id(gc)
        launches = maxk_launches() - before
        ok = best_val >= gc.min_val
        emit("golden", row=row, best_val=best_val, best_test=best_test, min_val=gc.min_val,
             ok=ok, known_miss=row in KNOWN_MISSES, seconds=time.perf_counter() - t0,
             maxk_launches=launches, scale=gc.scale, hidden=gc.hidden_dim,
             layers=gc.hidden_layers, epochs=gc.epochs)
        if not ok and row not in KNOWN_MISSES:
            missed.append(f"{row} {best_val:.4f} < {gc.min_val}")
        if gc.nonlinear == "maxk":
            require(launches > 0, f"golden {row}: no MaxK kernel {MAXK_KERNELS} was launched")
    require(not missed, f"golden rows under their floors: {missed}")


def phase_proteins() -> None:
    """ogbn-proteins ×1.0 (DC-SBM, p_intra 0.8, snr 0.15, seed 123) with the
    published launch (MaxK-SAGE 3×256, k=32, dropout 0.5, lr 0.01, ROC-AUC
    eval) for PROTEINS_EPOCHS epochs on one card."""
    import torch

    from maxk_tpu_torch.data.datasets import load_dataset
    from maxk_tpu_torch.train.config import TrainConfig
    from maxk_tpu_torch.train.loop import evaluate, synchronize, train

    t0 = time.perf_counter()
    data = load_dataset("ogbn-proteins", scale=1.0, seed=123, feat_snr=0.15, graph_kind="sbm",
                        sbm_p_intra=0.8)
    generate_s = time.perf_counter() - t0
    cfg = TrainConfig(dataset="ogbn-proteins", model="sage", epochs=PROTEINS_EPOCHS, lr=0.01,
                      hidden_dim=DIM, hidden_layers=3, maxk=K, dropout=0.5, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    before = maxk_launches()
    t0 = time.perf_counter()
    state = train(cfg, data, warmup_epochs=1)
    wall = time.perf_counter() - t0
    launches = maxk_launches() - before
    synchronize(state.device)
    t1 = time.perf_counter()
    rocaucs = evaluate(state, data)
    eval_ms = 1e3 * (time.perf_counter() - t1)
    emit("proteins", scale=1.0, nodes=data.csr.num_nodes, edges=data.csr.nnz,
         features=data.feat_dim, classes=data.num_classes, generate_s=generate_s,
         layers=3, hidden=DIM, k=K, dropout=0.5, lr=0.01, epochs=PROTEINS_EPOCHS,
         losses=state.losses, step_ms=[1e3 * t for t in state.epoch_times],
         step_ms_post_warmup=1e3 * sum(state.epoch_times) / len(state.epoch_times),
         eval_ms=eval_ms, rocauc_train_val_test=list(rocaucs), best_val_rocauc=state.best_val,
         wall_s=wall, max_memory_allocated=torch.cuda.max_memory_allocated(),
         maxk_launches=launches)
    require(len(state.losses) == PROTEINS_EPOCHS
            and all(math.isfinite(x) for x in state.losses),
            f"proteins: non-finite or missing losses {state.losses}")
    require(all(0.0 < x < 1.0 for x in rocaucs), f"proteins: ROC-AUC {rocaucs} outside (0, 1)")
    require(launches > 0, f"proteins: no MaxK kernel {MAXK_KERNELS} was launched")


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

    # name: (source, the TPU kernel it replaces (K9-K11: the
    # reference's XLA function), the check whose numbers the kernels line
    # reports)
    wrappers = {
        "maxk_mask": ("maxk_tpu_torch/csrc/maxk_mask.cu",
                      "maxk_tpu/ops/topk_pallas.py:99", "float32"),
        "topk_cbsr": ("maxk_tpu_torch/csrc/topk_cbsr.cu",
                      "maxk_tpu/ops/topk_pallas.py:79", "float32"),
        "cbsr_densify": ("maxk_tpu_torch/csrc/cbsr.cu",
                         "maxk_tpu/ops/cbsr_pallas.py:42", "bfloat16"),
        "cbsr_sample": ("maxk_tpu_torch/csrc/cbsr.cu",
                        "maxk_tpu/ops/cbsr_pallas.py:52", "bfloat16"),
        "spmm_bricks": ("maxk_tpu_torch/csrc/spmm_bricks.cu",
                        "maxk_tpu/ops/spmm_bricks.py:37", "float32"),
        "slab_gather": ("maxk_tpu_torch/csrc/gather.cu",
                        "maxk_tpu/bench/micro.py:142", "2048_float32"),
        "dma_gather": ("maxk_tpu_torch/csrc/gather.cu",
                       "maxk_tpu/bench/micro.py:204", "float32"),
        "take_along_rows": ("maxk_tpu_torch/csrc/gather.cu",
                            "maxk_tpu/bench/probe_topk.py:96", "262144_float32"),
        "spmm_csr": ("maxk_tpu_torch/csrc/spmm_csr.cu",
                     "maxk_tpu/ops/spmm_xla.py:21", "A_float32"),
        "spgemm_cbsr": ("maxk_tpu_torch/csrc/spmm_csr.cu",
                        "maxk_tpu/ops/spgemm.py:157", "bfloat16"),
        "sspmm_cbsr": ("maxk_tpu_torch/csrc/spmm_csr.cu",
                       "maxk_tpu/ops/spgemm.py:224", "bfloat16"),
    }
    counts = {}

    def reset():
        reset_launches(wrappers)

    def read(path):
        counts[path] = read_launches(wrappers)
        emit("launches", path=path, **counts[path])
        return counts[path]

    try:
        smi = phase_identity()
        phase_build()
        data, graph = phase_data()
        checks = phase_kernels(graph.num_nodes)
        csr_checks, k9_sec_per_edge = phase_csr_kernels(graph)
        checks.update(csr_checks)
        bg, sched = brick_inputs()
        checks.update(phase_bench_kernels(bg, sched))
        phase_launch_path()
        phase_small_slice()
        # the sharded proteins case (counts reset inside, read right after)
        counts["sharded_proteins"] = phase_sharded_small(tuple(wrappers))
        emit("launches", path="sharded_proteins", **counts["sharded_proteins"])

        # the single-device main path: the op, then training (segsum in f32:
        # K4 and its densify in the model, K10 and K11 in maxk_spgemm; no K1
        # and no K9)
        reset()
        phase_op(graph)
        torch.cuda.empty_cache()
        segsum_losses, segsum_step = phase_train(data)
        single = read("single_device")
        for name in ("topk_cbsr", "spgemm_cbsr", "sspmm_cbsr"):
            require(single[name] >= LAYERS * EPOCHS,
                    f"{name} launched {single[name]} < {LAYERS * EPOCHS} times on the main path")
        for name in ("maxk_mask", "spmm_csr"):
            require(single[name] == 0, f"{name} launched {single[name]} times on the main path")

        # GNNRes: no kernel of ours on its path
        torch.cuda.empty_cache()
        reset()
        phase_gnn_res(data)
        read("gnn_res")

        # the edge-tile path: the tables, the op, then training under tiles_scan
        torch.cuda.empty_cache()
        tgraph = phase_host_tiles(data, graph)
        del graph
        reset()
        phase_tiles_op(tgraph)
        del tgraph
        torch.cuda.empty_cache()
        phase_tiles_train(data, segsum_losses, segsum_step)
        tiles = read("tiles")
        for name in ("maxk_mask", "cbsr_densify", "cbsr_sample"):
            require(tiles[name] > 0, f"{name} was not launched on the tile path")

        # the strip hybrid: the schedule, the op, then training under hybrid
        torch.cuda.empty_cache()
        hgraph = phase_host_hybrid(data)
        reset()
        phase_hybrid_op(hgraph)
        del hgraph
        torch.cuda.empty_cache()
        phase_hybrid_train(data, segsum_losses, segsum_step, k9_sec_per_edge)
        hybrid = read("hybrid")
        for name in ("maxk_mask", "topk_cbsr", "cbsr_densify", "cbsr_sample"):
            require(hybrid[name] > 0, f"{name} was not launched on the hybrid path")

        # the row-partitioned path (counts reset inside, read right after)
        torch.cuda.empty_cache()
        counts["sharded"] = phase_sharded_train(data, tuple(wrappers))
        emit("launches", path="sharded", **counts["sharded"])

        # the benchmark path, through the entry points of maxk_tpu_torch.bench
        torch.cuda.empty_cache()
        reset()
        phase_bench(data.csr)
        phase_kernel_bench()
        for tag, t in phase_probes(bg, sched).items():
            checks[("spmm_bricks", tag)].update(t)
        del bg, sched
        phase_micro()
        bench = read("bench")
        for name, n in bench.items():
            require(n > 0, f"{name} was not launched on the benchmark path")

        # the campaign scripts, on the reddit graph still in memory; the
        # degree sweep's kernel_bench children count in their own processes
        torch.cuda.empty_cache()
        reset()
        phase_campaign(data.csr, torch.cuda.device_count())
        del data
        campaign = read("campaign")
        for name in ("maxk_mask", "cbsr_densify", "cbsr_sample", "topk_cbsr", "spmm_bricks"):
            require(campaign[name] > 0, f"{name} was not launched on the campaign path")

        # Lookahead, checkpoints and resume, through the CLI's entry
        torch.cuda.empty_cache()
        reset()
        phase_lookahead_ckpt()
        ckpt = read("lookahead_ckpt")
        require(sum(ckpt[name] for name in MAXK_KERNELS) > 0,
                f"no MaxK kernel {MAXK_KERNELS} was launched on the checkpoint path")

        # the accuracy path: the golden floors, then ogbn-proteins x1.0
        torch.cuda.empty_cache()
        reset()
        phase_golden()
        read("golden")
        reset()
        phase_proteins()
        read("proteins")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    kernels = []
    for name, (source, replaces, key) in wrappers.items():
        by_path = {path: c[name] for path, c in counts.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path, "check": key,
            **checks[(name, key)],
            "bound_share": checks[(name, key)]["bound_ms"] / checks[(name, key)]["ms"],
            "max_abs_err": max(c["max_abs_err"] for (n, _), c in checks.items() if n == name),
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
