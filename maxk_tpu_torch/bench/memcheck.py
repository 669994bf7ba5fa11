"""Device memory against k — port of `maxk_tpu/bench/memcheck.py`.

The reference reads XLA's buffer assignment (`compiled.memory_analysis()`);
the port has no compiler to ask, so it measures real arrays on the card:
`torch.cuda.max_memory_allocated` after `reset_peak_memory_stats`, less
what was allocated before the call (the graph and the call's inputs),
i.e. the call's own working set (`peak_bytes`).

  A. op level: forward + backward of `maxk_spgemm` (bf16 compute, loss
     vdot(y, ct)) under segsum and under the strip hybrid, one per k, and
     the masked-dense arm (the SpMM of (V, D) bf16 features) once, on an
     R-MAT graph of `--v` nodes and `--e` edges drawn (default: published
     reddit). Beside the measured bytes, the exact k-shaped ones: the
     gradient, (V, k) f32 for the CBSR arms against (V, D) bf16 for the
     masked one, and the (V, D) f32 output.
  B. one train step (flickr at `--train_scale`, segsum, dropout 0.5): relu
     against maxk at each k, measured the same way.

The port's segsum is edge-chunked (`ops/spmm_xla.EDGE_CHUNK`), so its peak
is not the reference's (E, D) gather scratch. On the CPU nothing is
measured: the measured fields are null and `"measured": false`; the exact
bytes are written all the same.

    python -m maxk_tpu_torch.bench.memcheck [--v 232965 --e 114615892] [--json_out F]
    python -m maxk_tpu_torch.bench.memcheck --device cpu --v 4096 --e 65536 --k 8 32 \\
        --train_scale 0.002
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

SEGSUM_NOTE = ("segsum runs in edge chunks (ops/spmm_xla.EDGE_CHUNK), so its peak is not the "
               "reference's (E, D) gather scratch")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def measure(fn, device) -> dict:
    """Run `fn()` once; on a card the bytes allocated at its peak above what
    was allocated before it (`peak_bytes`), and that base (`resident_bytes`);
    on the CPU both null."""
    if device.type != "cuda":
        fn()
        return {"measured": False, "peak_bytes": None, "resident_bytes": None}
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn()
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) - base
    del out
    return {"measured": True, "peak_bytes": int(peak), "resident_bytes": int(base)}


def op_level(csr, dim: int, ks, device) -> list:
    """Part A on the raw CSR `csr`, moved to `device`: one record an arm."""
    from maxk_tpu_torch.ops.spgemm import maxk_spgemm, spmm
    from maxk_tpu_torch.sparse.cbsr import CBSR
    from maxk_tpu_torch.sparse.graph import build_graph

    bf16 = torch.bfloat16
    # one operand for both directions, as the reference's Graph(csr, csr)
    graph = build_graph(csr, norm="right", symmetric=True, device=device, hybrid=True, dim=dim)
    v = graph.num_nodes
    gen = torch.Generator(device=device).manual_seed(123)
    ct = torch.randn((v, dim), generator=gen, device=device)
    graph_bytes = _nbytes(graph.csr.indptr, graph.csr.indices, graph.csr.values)
    if graph.hybrid is not None:
        graph_bytes += graph.hybrid.nbytes
    out = []

    def record(arm, k, mode, grad, inputs, m):
        rec = {"arm": arm, "k": k, "mode": mode, **m,
               "input_bytes": _nbytes(*inputs), "graph_bytes": graph_bytes,
               # exact: what the call returns, the loss (f32) and the gradient
               "grad_bytes": grad, "output_bytes": 4 + grad,
               "forward_output_bytes": v * dim * 4}
        if mode == "segsum":
            rec["note"] = SEGSUM_NOTE
        out.append(rec)
        peak = "not measured" if m["peak_bytes"] is None else f"{m['peak_bytes']/1e9:.3f} GB"
        log(f"op {arm}: peak {peak}, grad {grad/1e6:.3f} MB")

    modes = [("maxk_cbsr", "segsum")]
    if graph.hybrid is not None:
        modes.append(("hybrid_cbsr", "hybrid"))
    for k in ks:
        vals = torch.randn((v, k), generator=gen, device=device)
        sel = torch.randint(0, dim, (v, k), generator=gen, device=device, dtype=torch.int32)
        for arm, mode in modes:
            def fwd_bwd(mode=mode):
                va = vals.detach().requires_grad_(True)
                y = maxk_spgemm(graph, CBSR(va, sel), dim=dim, mode=mode, compute_dtype=bf16)
                torch.vdot(y.flatten(), ct.flatten()).backward()
                return va.grad

            record(f"{arm}_k{k}", k, mode, v * k * 4, (vals, sel, ct), measure(fwd_bwd, device))
        del vals, sel

    x = torch.randn((v, dim), generator=gen, device=device).to(bf16)

    def masked():
        xr = x.detach().requires_grad_(True)
        torch.vdot(spmm(graph, xr, mode="segsum").float().flatten(), ct.flatten()).backward()
        return xr.grad

    record("masked_dense", None, "segsum", v * dim * 2, (x, ct), measure(masked, device))
    del graph, x, ct
    return out


def train_step_level(scale: float, ks, device) -> list:
    """Part B: one train step of SAGE on flickr at `scale`, relu (k 32) and
    maxk at each k."""
    from maxk_tpu_torch.data.datasets import load_dataset
    from maxk_tpu_torch.train.config import TrainConfig
    from maxk_tpu_torch.train.loop import _device_arrays, make_train_step, setup

    data = load_dataset("flickr", scale=scale, seed=123)
    out = []
    for nonlinear, k in [("relu", 32)] + [("maxk", kk) for kk in ks]:
        cfg = TrainConfig(dataset="flickr", model="sage", epochs=1, nonlinear=nonlinear, maxk=k,
                          dropout=0.5, kernel_mode="segsum", data_scale=scale,
                          device=str(device))
        state = setup(cfg, data)
        step = make_train_step(state.model, state.optimizer, data.multilabel)
        feats, labels, masks = _device_arrays(data, device)
        m = measure(lambda: step(state.graph, feats, labels, masks[0], state.generator), device)
        arm = "relu" if nonlinear == "relu" else f"maxk_k{k}"
        out.append({"arm": arm, **m,
                    "param_bytes": _nbytes(*state.model.parameters())})
        peak = "not measured" if m["peak_bytes"] is None else f"{m['peak_bytes']/1e6:.2f} MB"
        log(f"train {arm}: peak {peak}")
        del state, step, feats, labels, masks
    return out


def main(argv=None) -> dict:
    from maxk_tpu_torch.data.synthetic import rmat_graph
    from maxk_tpu_torch.train.loop import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--v", type=int, default=232965)  # published reddit V
    p.add_argument("--e", type=int, default=114_615_892)  # reddit E
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--k", nargs="+", type=int, default=[8, 16, 32, 64])
    p.add_argument("--train_scale", type=float, default=0.02)
    p.add_argument("--device", default="cuda")
    p.add_argument("--json_out", default="")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    csr = rmat_graph(args.v, args.e, seed=123)
    out = run(csr, args.dim, args.k, args.train_scale, device)
    out["shapes"]["E"] = args.e
    s = json.dumps(out, indent=1)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(s)
        log(f"wrote {args.json_out}")
    print(s)
    return out


def run(csr, dim: int, ks, train_scale: float, device) -> dict:
    """Parts A and B on the raw CSR `csr`; the memcheck document."""
    device = torch.device(device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {
        "shapes": {"V": csr.num_nodes, "E": csr.nnz, "E_live": int(csr.indptr[-1]), "D": dim},
        "device": name,
        "measured": device.type == "cuda",
        "method": "torch.cuda.max_memory_allocated after reset_peak_memory_stats, less the "
                  "bytes allocated before the call (graph and inputs)",
        "op_level": op_level(csr, dim, ks, device),
        "train_step": train_step_level(train_scale, ks, device),
    }


if __name__ == "__main__":
    main()
