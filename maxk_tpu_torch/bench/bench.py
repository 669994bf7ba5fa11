"""The kernel benchmark record: the root `bench.py` of the JAX package, on the card.

    python -m maxk_tpu_torch.bench [--graph reddit --scale 0 --k 32 --dim 256
                                    --mode auto --device cuda]

Protocol (as `bench.py`): a synthetic graph at the dataset's published
size × scale with right normalization, random CBSR features (V, k) over
dim columns from seed 123, and these arms, each timed over 8 calls after 2
warm-up calls (`micro.timeit`, CUDA events on the card):

  - `maxk_spgemm` forward with bf16 compute (the headline);
  - its components: the densify (to bf16) and the SpMM on the result;
  - the dense f32 baseline, the SpMM over the densified f32 features;
  - forward + backward through autograd, at a random cotangent.

Prints one JSON line on stdout, `{"metric", "value", "unit",
"vs_baseline"}`, with the forward's live edges per second against the
same A100 estimate as `bench.py` (4.0 Gnnz/s, see its docstring);
everything else goes to stderr. Scale 0 means 1.0 on a card and 0.02 with
`--device cpu`. `auto` resolves to segsum; `tiles_xla` and `tiles_scan`
run the edge-tile SpMMs (their tables built with the graph); `hybrid` and
`pallas` raise (`ops/dispatch.resolve_mode`). The dense baseline stays
segsum, as the reference's does off the TPU.

The graph is the port's host `data.synthetic.rmat_graph(v, e, seed=123)`,
the call `load_dataset` makes, so at reddit × 1.0 it is the training
graph. The reference draws its graph on the device
(`data/device_gen.rmat_graph_device`, a workaround for slow host uploads),
a different instance of the same R-MAT distribution. Not ported: the
backend probe and retry (`bench.py:43-90`) and the compilation cache.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

A100_MAXK_K32_NNZ_S = 4.0e9  # derived estimate, `bench.py` docstring


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run_bench(csr, k: int = 32, dim: int = 256, mode: str = "auto", device="cuda",
              label: str = "reddit x1.0") -> dict:
    """Time the arms on the raw (unnormalized) CSR `csr`; returns the JSON
    record. `label` names the graph in the metric."""
    from maxk_tpu_torch.bench.micro import timeit
    from maxk_tpu_torch.ops.dispatch import TILE_MODES, resolve_mode
    from maxk_tpu_torch.ops.spgemm import maxk_spgemm, spmm
    from maxk_tpu_torch.sparse.cbsr import CBSR, cbsr_densify
    from maxk_tpu_torch.sparse.graph import build_graph
    from maxk_tpu_torch.train.loop import resolve_device

    device = resolve_device(device)
    mode = resolve_mode(mode).value
    # right norm breaks value symmetry, so the backward arm gets the real Aᵀ
    graph = build_graph(csr, norm="right", symmetric=False, device=device,
                        build_tiles=mode in TILE_MODES)
    v = graph.num_nodes
    e_real = int((graph.csr.values != 0).sum())
    bf16 = torch.bfloat16

    gen = torch.Generator(device=device).manual_seed(123)
    vals = torch.randn((v, k), generator=gen, device=device)
    sel = torch.randint(0, dim, (v, k), generator=gen, device=device, dtype=torch.int32)
    ct = torch.randn((v, dim), generator=gen, device=device)
    cbsr = CBSR(values=vals, selector=sel)
    x_dense = cbsr_densify(cbsr, dim)

    def fwd():
        return maxk_spgemm(graph, cbsr, dim=dim, mode=mode, compute_dtype=bf16)

    t_fwd = timeit(fwd, iters=8)
    log(f"maxk fwd k={k}: {t_fwd*1e3:.3f} ms -> {e_real/t_fwd/1e9:.3f} Gnnz/s")

    def densify_bf16():
        return cbsr_densify(cbsr, dim).to(bf16)

    t_densify = timeit(densify_bf16, iters=8)
    xb = densify_bf16()
    t_spmm = timeit(lambda: spmm(graph, xb, mode=mode), iters=8)
    log(f"components: densify {t_densify*1e3:.3f} + spmm(normed) {t_spmm*1e3:.3f} = "
        f"{(t_densify+t_spmm)*1e3:.3f} ms vs maxk_spgemm {t_fwd*1e3:.3f} ms")
    del xb

    t_base = timeit(lambda: spmm(graph, x_dense, mode="segsum"), iters=8)
    log(f"dense f32 baseline (segsum): {t_base*1e3:.3f} ms ({e_real/t_base/1e9:.3f} Gnnz/s)")

    def fwd_bwd():
        va = vals.detach().requires_grad_(True)
        y = maxk_spgemm(graph, CBSR(va, sel), dim=dim, mode=mode, compute_dtype=bf16)
        loss = torch.vdot(y.flatten(), ct.flatten())
        loss.backward()
        return loss, va.grad

    t_bwd = timeit(fwd_bwd, iters=8)
    log(f"maxk fwd+bwd: {t_bwd*1e3:.3f} ms")

    nnz_s = e_real / t_fwd
    return {
        "metric": f"spmm_maxk fwd nnz/s ({label}, k={k}, {mode}, {device.type})",
        "value": round(nnz_s / 1e9, 4),
        "unit": "Gnnz/s",
        "vs_baseline": round(nnz_s / A100_MAXK_K32_NNZ_S, 4),
    }


def main(argv=None) -> dict:
    from maxk_tpu_torch.data.datasets import DATASETS
    from maxk_tpu_torch.data.synthetic import rmat_graph
    from maxk_tpu_torch.train.loop import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--graph", default="reddit")
    p.add_argument("--scale", type=float, default=0.0)  # 0 = by device
    p.add_argument("--k", type=int, default=32)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--mode", default="auto")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    scale = args.scale or (1.0 if device.type == "cuda" else 0.02)
    spec = DATASETS[args.graph]
    v = max(int(spec.num_nodes * scale), 64)
    e = max(int(spec.num_edges * scale), 256)
    csr = rmat_graph(v, e, seed=123)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    log(f"graph {args.graph} x{scale}: V={v} E={csr.nnz}; device {device} ({name})")
    rec = run_bench(csr, k=args.k, dim=args.dim, mode=args.mode, device=device,
                    label=f"{args.graph} x{scale}")
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
