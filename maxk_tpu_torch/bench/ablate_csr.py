"""Where the segsum path's CSR kernels K9 (`spmm_csr`) and K10
(`spgemm_cbsr`) spend their time on the card.

    python -m maxk_tpu_torch.bench.ablate_csr [--graph reddit ... --scale 1.0 --dim 256
        --k 32 --rounds 3] [--earlier path/to/spmm_csr.cu]

On synthetic reddit at `--scale` (seed 123, right-normalized; `--graph
rmat_v<nodes>_d<degree>` takes a graph of the degree sweep as
`kernel_bench` draws it; several graphs share one build), D = dim, f32 and
bf16. K9 over A and Aᵀ; copies of `csrc/spmm_csr.cu`, each with one
part taken out or changed by a text edit:

  kernel        the kernel (column slices of 64 f32 / 128 bf16 columns)
  table_order   segments taken in table (CSR) order, not longest first
  slice_half    slices half as wide (32 f32 / 64 bf16 columns)
  slice_double  slices twice as wide (128 f32 / 256 bf16 columns)
  streaming_loads  the CSR's columns and weights loaded as streaming data
                (`__ldcs`, evict first) in place of plain loads
  no_math       rows loaded, their words folded into one value: no products
  fma           (bf16) products neither rounded nor paired: one f32 FMA an
                element, the least arithmetic a gather-a-row design can do
  cvt_round     (bf16) products rounded by a conversion an element, as the
                earlier design did, in place of `__hmul2_rn` pairs
  l2_resident   the kernel on a copy of the CSR whose column indices are
                folded (modulo) into the first rows whose bytes fill half the
                card's L2 (`cudaDevAttrL2CacheSize`): every gathered row an
                L2 hit, the card's ceiling for a gather-a-row-an-edge design

K10 over A (k CBSR slots a row, random selectors): `kernel`, `no_hubs` (no
hub rows held in shared memory), `no_sync` (no `__syncwarp` between
edges), `no_rmw` (slots loaded, nothing added into the shared accumulator
row), `cvt_round` (bf16 products by a conversion, not `__hmul2_rn`),
`streaming_loads`, `merge_only` (the merge pass, an empty launch of the
kernel and the combine pass: the call's fixed cost), `grab1` / `grab4` (a
warp takes one / four segments a take everywhere, in place of the rule
that sizes the take by the work a warp has) and `l2_resident` (indices
folded into the rows whose merged slots fill half of L2). `torch.sparse.mm` on the same CSR (K10: on the
densified CBSR) beside them. With `--earlier`, a `spmm_csr.cu` of the
design these kernels replaced (with its own `common.cuh` beside it) is
built too and its K9 and K10 timed in the same turns (`earlier`).

Every arm is the median of --rounds runs of 20 launches after one (and its
range), the arms in turns, the order reversed each run. The arms that
compute the function (`K9_EXACT`, `K10_EXACT`, `earlier`) are each held to
the kernel's bits first (`exact`). `gather_ceiling_ms` is the gathered
bytes (a row or k slots an edge) over the `l2_resident` arm's rate; the
read-once bound (`bound_ms`) counts the CSR, its table, the features and
the output once; K10's `hub_share` is the share of the edges whose source
it holds in shared memory.
`ncu` says whether Nsight Compute is on PATH: the hardware counters (L2 hit
rate, DRAM bytes, bank conflicts) need it. Prints one JSON line a graph.

The edits name lines of the kernel's source as it stands: a rewrite may
leave one without its line, and the tool then raises naming it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
from pathlib import Path

import torch

from maxk_tpu_torch.bench.ablate_mask_gather import build, bits, edited, turns

K9_EDITS = {
    "kernel": [],
    "table_order": [("order[oi]", "oi")],
    "slice_half": [("constexpr int kSliceVecs = 2;", "constexpr int kSliceVecs = 1;")],
    "slice_double": [("constexpr int kSliceVecs = 2;", "constexpr int kSliceVecs = 4;")],
    "streaming_loads": [(f"{a}[sg.begin + {i}]", f"__ldcs({a} + sg.begin + {i})")
                        for a in ("indices", "values")
                        for i in ("lg", "kBatch + lg", "e0 + 2 * kBatch + lg")],
    "no_math": [("if (e0 + u < n) r[u].add(acc, au);",
                 "if (e0 + u < n) {\n            unsigned f = au;\n"
                 "            for (int v = 0; v < kSliceVecs; ++v)\n"
                 "              f ^= r[u].q[v].x ^ r[u].q[v].y ^ r[u].q[v].z ^ r[u].q[v].w;\n"
                 "            acc[0] = __uint_as_float(__float_as_uint(acc[0]) ^ f);\n          }")],
    "fma": [("          const unsigned p = hmul2_bits(w[i], aw);\n"
             "          acc[8 * v + 2 * i] = __fadd_rn(acc[8 * v + 2 * i], bf16_lo(p));\n"
             "          acc[8 * v + 2 * i + 1] = __fadd_rn(acc[8 * v + 2 * i + 1], bf16_hi(p));",
             "          acc[8 * v + 2 * i] = fmaf(bf16_lo(w[i]), bf16_lo(aw), acc[8 * v + 2 * i]);\n"
             "          acc[8 * v + 2 * i + 1] = fmaf(bf16_hi(w[i]), bf16_lo(aw), "
             "acc[8 * v + 2 * i + 1]);")],
    "cvt_round": [("          const unsigned p = hmul2_bits(w[i], aw);\n"
                   "          acc[8 * v + 2 * i] = __fadd_rn(acc[8 * v + 2 * i], bf16_lo(p));\n"
                   "          acc[8 * v + 2 * i + 1] = __fadd_rn(acc[8 * v + 2 * i + 1], bf16_hi(p));",
                   "          acc[8 * v + 2 * i] = __fadd_rn(acc[8 * v + 2 * i], "
                   "product<T>(bf16_lo(w[i]), bf16_lo(aw)));\n"
                   "          acc[8 * v + 2 * i + 1] = __fadd_rn(acc[8 * v + 2 * i + 1], "
                   "product<T>(bf16_hi(w[i]), bf16_lo(aw)));")],
}
K9_BF16_ONLY = ("fma", "cvt_round")
K9_EXACT = ("kernel", "table_order", "slice_half", "slice_double", "streaming_loads")

_K10_ADD = ("                  if (sc[u] >= t0 && col < tw) acc[col] = __fadd_rn(acc[col], "
            "product_w<T>(v[u], au));")
K10_EDITS = {
    "no_sync": [(_K10_ADD + "\n                  __syncwarp();", _K10_ADD)],
    "no_rmw": [(_K10_ADD, "                  if ((sc[u] ^ __float_as_int(v[u])) == 0x7fffffff) "
                          "acc[0] = __uint_as_float(au);")],
    "cvt_round": [("product_w<T>(v[u], au)",
                   "product<T>(v[u], sizeof(T) == 2 ? bf16_lo(au) : __uint_as_float(au))")],
    "streaming_loads": [("indices[e0 + lane], hubs)", "__ldcs(indices + e0 + lane), hubs)"),
                        ("weight_word<T>(values[e0 + lane])",
                         "weight_word<T>(__ldcs(values + e0 + lane))")],
    "merge_only": [("  extern __shared__ float4 smem4[];\n  const int lane = threadIdx.x & 31;\n"
                    "  float* acc",
                    "  extern __shared__ float4 smem4[];\n  if (nseg >= 0) return;\n"
                    "  const int lane = threadIdx.x & 31;\n  float* acc")],
    "grab1": [("constexpr int kGrab = 4;", "constexpr int kGrab = 1;")],
    "grab4": [("  const int grab = fill < 1 ? 1 : fill < kGrab ? (int)fill : kGrab;",
               "  const int grab = kGrab + 0 * (int)fill;")],
}
K10_EXACT = ("kernel", "no_hubs", "cvt_round", "streaming_loads", "grab1", "grab4")

_P, _I = ctypes.c_void_p, ctypes.c_int
# the earlier design's entry points: no work order, hub table or counters
EARLIER_SIGNATURES = {
    "spmm_csr": (_P,) * 12 + (_I,) * 4 + (_P,),
    "spgemm_cbsr": (_P,) * 15 + (_I,) * 6 + (_P,),
}


def build_variants(earlier: str | None) -> dict:
    """(kernel, variant) -> the loaded library of that copy of the source."""
    from maxk_tpu_torch.ops import _native

    tool = "ablate_csr"
    src = (_native.CSRC / "spmm_csr.cu").read_text()
    sources = {("csr", k): edited(tool, k, src, e) for k, e in K9_EDITS.items()}
    sources.update({("k10", k): edited(tool, k, src, e) for k, e in K10_EDITS.items()})
    if earlier:
        # its own common.cuh, inlined: the build's -I names this tree's
        path = Path(earlier).resolve()
        common = (path.parent / "common.cuh").read_text().replace("#pragma once\n", "")
        sources[("earlier", "")] = path.read_text().replace('#include "common.cuh"\n', common)
    return build(tool, sources)


def _entry(lib, name, argtypes):
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def _slice_cols_of(lib):
    """`ops/spmm_csr._slice_cols` as the variant `lib` lays K9 out: the
    wrapper hands K9 one counter a column slice."""
    from maxk_tpu_torch.ops import _native

    fn = _entry(lib, "csr_kernels_layout", _native.SIGNATURES["csr_kernels_layout"])

    def slice_cols(itemsize: int) -> int:
        out = [ctypes.c_int(0) for _ in range(2)]
        err = fn(itemsize, 1, 1, *map(ctypes.byref, out))
        if err:
            raise RuntimeError(f"csr_kernels_layout: CUDA error {err}")
        return out[0].value
    return slice_cols


def _through(entry: str, fn, call, lib):
    """`call()` (a wrapper's launch) with the wrapper's entry point `entry`
    bound to `fn` and its K9 layout to that of `lib`, a variant's."""
    from maxk_tpu_torch.ops import _native
    from maxk_tpu_torch.ops import spmm_csr as sc

    _native.library()
    cols = _slice_cols_of(lib)

    def run():
        keep, keep_cols = _native._fns[entry], sc._slice_cols
        _native._fns[entry], sc._slice_cols = fn, cols
        try:
            return call()
        finally:
            _native._fns[entry], sc._slice_cols = keep, keep_cols
    return run


def folded_csr(csr, rows: int, hubs: bool = False):
    """A copy of `csr` whose column indices are folded into [0, rows), with
    its own segment table (and hub table where `hubs`)."""
    from maxk_tpu_torch.sparse.csr import CSRGraph, with_segments

    return with_segments(CSRGraph(csr.indptr, torch.remainder(csr.indices, rows).int(),
                                  csr.values), hubs=hubs)


def _no_hubs(csr):
    from dataclasses import replace

    from maxk_tpu_torch.sparse.csr import CSRGraph

    t = csr.segments
    return CSRGraph(csr.indptr, csr.indices, csr.values,
                    replace(t, hub_rows=t.hub_rows[:0], hub_slot=t.hub_slot[:0]))


def _table_ptrs(csr):
    t = csr.segments
    return [a.data_ptr() for a in (csr.indptr, csr.indices, csr.values, t.row, t.begin, t.part,
                                   t.multi_row, t.multi_part0, t.multi_nseg)]


def _earlier_spmm(fn, csr, x):
    def run():
        t = csr.segments
        d = x.shape[1]
        out = torch.empty_like(x)
        part = torch.empty((t.num_parts, d), dtype=torch.float32, device=x.device)
        err = fn(*_table_ptrs(csr), x.data_ptr(), out.data_ptr(), part.data_ptr(),
                 t.num_segments, t.multi_row.shape[0], t.seg_edges, d,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"earlier spmm_csr: CUDA error {err}")
        return out
    return run


def _earlier_spgemm(fn, csr, vals, sel, dim):
    def run():
        t = csr.segments
        out = vals.new_empty((csr.num_nodes, dim))
        part = torch.empty((t.num_parts, dim), dtype=torch.float32, device=vals.device)
        mv, ms = torch.empty_like(vals), torch.empty_like(sel)
        err = fn(*_table_ptrs(csr), vals.data_ptr(), sel.data_ptr(), mv.data_ptr(), ms.data_ptr(),
                 out.data_ptr(), part.data_ptr(), t.num_segments, t.multi_row.shape[0],
                 t.seg_edges, sel.shape[1], dim, vals.shape[0],
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"earlier spgemm_cbsr: CUDA error {err}")
        return out
    return run


def _csr_bytes(csr, hubs: bool) -> int:
    """The bytes of the CSR and its segment table (with its hub table where
    `hubs`)."""
    t = csr.segments
    return sum(a.numel() * a.element_size() for a in (
        csr.indptr, csr.indices, csr.values, t.row, t.begin, t.part, t.multi_row,
        t.multi_part0, t.multi_nseg, t.order, *((t.hub_rows, t.hub_slot) if hubs else ())))


def hub_share(csr, rows: int) -> float:
    """The share of the live edges whose source is among the first `rows`
    hub rows."""
    t = csr.segments
    live = csr.indices[: int(csr.indptr[-1])].long()
    slot = t.hub_slot.long()[live]
    return float(((slot >= 0) & (slot < rows)).float().mean())


def _case(arms: dict, exact_arms, rounds: int, ref_fn, nbytes: int, gathered: int, **fields):
    """Check `exact_arms` against `ref_fn`'s bits, time every arm in turns.
    Each output is filled with NaN before it is freed, so an arm whose
    output lands in a freed one's memory and leaves part of it unwritten
    fails the check."""
    from maxk_tpu_torch.bench.micro import bound

    ref_fn().fill_(float("nan"))
    ref = ref_fn()
    torch.cuda.synchronize()
    exact = {}
    for name in exact_arms:
        got = arms[name]()
        torch.cuda.synchronize()
        exact[name] = torch.equal(bits(got), bits(ref))
        got.fill_(float("nan"))
        del got
    del ref
    t = turns(arms, rounds)
    rec = {**fields, "exact": exact, **bound(nbytes), "gathered_bytes": gathered, "arms": t}
    if "l2_resident" in t:
        ms = t["l2_resident"][0]
        rec["gather_ceiling_gbs"] = gathered / ms * 1e-6
        rec["gather_ceiling_ms"] = ms
        rec["ceiling_share"] = ms / t["kernel"][0]
    return rec


def main(argv=None) -> list:
    p = argparse.ArgumentParser()
    p.add_argument("--graph", nargs="+", default=["reddit"],
                   help="reddit, or rmat_v<nodes>_d<degree> as kernel_bench names them")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--k", type=int, default=32)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--earlier", default=None,
                   help="a spmm_csr.cu of the earlier design, timed beside the kernels")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ablate_csr: no CUDA device; the kernels run only on the card")
    libs = build_variants(args.earlier)
    outs = []
    for name in args.graph:
        outs.append(probe_graph(args, name, libs))
        print(json.dumps(outs[-1]), flush=True)
    return outs


def probe_graph(args, name: str, libs: dict) -> dict:
    """Every arm on one graph, as `main` describes."""
    from maxk_tpu_torch.bench import kernel_bench
    from maxk_tpu_torch.data.datasets import load_dataset
    from maxk_tpu_torch.ops import _native
    from maxk_tpu_torch.ops import spmm_csr as sc
    from maxk_tpu_torch.ops.cbsr_cuda import densify_plain
    from maxk_tpu_torch.sparse.graph import build_graph

    if name == "reddit":
        raw = load_dataset("reddit", scale=args.scale, seed=123).csr
    else:
        suite = argparse.Namespace(dir=None, graphs=[name], scale=args.scale)
        (_, raw), = kernel_bench.load_suite(suite)
    graph = build_graph(raw, norm="right", device="cuda")
    del raw
    v, d, k = graph.num_nodes, args.dim, args.k
    e_live = int(graph.csr.indptr[-1])
    l2 = _native.l2_cache_bytes()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"device": torch.cuda.get_device_name(0), "graph": name, "scale": args.scale,
           "nodes": v, "edges": e_live, "dim": d, "k": k,
           "l2_bytes": l2, "ncu": shutil.which("ncu")}
    earlier = args.earlier is not None
    for dtype in (torch.float32, torch.bfloat16):
        tag, isz = str(dtype).split(".")[-1], torch.finfo(dtype).bits // 8
        suffix = "f32" if isz == 4 else "bf16"
        layout = sc.kernel_layout(isz, k, d)
        entry = f"spmm_csr_{suffix}"
        sig = _native.SIGNATURES[entry]
        vlibs = {var: libs[("csr", var)] for var in K9_EDITS
                 if isz == 2 or var not in K9_BF16_ONLY}
        fns = {var: _entry(lib, entry, sig) for var, lib in vlibs.items()}
        if earlier:
            old = _entry(libs[("earlier", "")], entry, EARLIER_SIGNATURES["spmm_csr"])
        folded_rows = l2 // 2 // (d * isz)
        for op, csr in (("A", graph.csr), ("At", graph.csc)):
            x = torch.randn((v, d), generator=gen, device="cuda").to(dtype)
            folded = folded_csr(csr, folded_rows)
            arms = {var: _through(entry, fn, lambda c=csr: sc.spmm_csr_cuda(c, x), vlibs[var])
                    for var, fn in fns.items()}
            arms["l2_resident"] = _through(entry, fns["kernel"],
                                           lambda: sc.spmm_csr_cuda(folded, x), vlibs["kernel"])
            if earlier:
                arms["earlier"] = _earlier_spmm(old, csr, x)
            a = torch.sparse_csr_tensor(csr.indptr.long(), csr.indices.long(),
                                        csr.values.to(dtype), (v, v))
            arms["torch_sparse_mm"] = lambda: torch.sparse.mm(a, x)
            exact_arms = [*K9_EXACT] + (["earlier"] if earlier else [])
            out[f"spmm_csr_{op}_{tag}"] = _case(
                arms, exact_arms, args.rounds, arms["kernel"],
                _csr_bytes(csr, False) + 2 * v * d * isz, e_live * d * isz,
                slice_cols=layout["slice_cols"], folded_rows=folded_rows)
            del x, folded, arms, a

        entry = f"spgemm_cbsr_{suffix}"
        sig = _native.SIGNATURES[entry]
        vlibs = {var: libs[("k10" if var in K10_EDITS else "csr", var)]
                 for var in ("kernel", *K10_EDITS)}
        fns = {var: _entry(lib, entry, sig) for var, lib in vlibs.items()}
        csr = graph.csr
        vals = torch.randn((v, k), generator=gen, device="cuda").to(dtype)
        sel = torch.randint(0, d, (v, k), generator=gen, device="cuda", dtype=torch.int32)
        folded_rows = l2 // 2 // (k * (2 + isz))
        folded, bare = folded_csr(csr, folded_rows, hubs=True), _no_hubs(csr)
        arms = {var: _through(entry, fn, lambda: sc.spgemm_cbsr_cuda(csr, vals, sel, d),
                              vlibs[var])
                for var, fn in fns.items()}
        arms["no_hubs"] = _through(entry, fns["kernel"],
                                   lambda: sc.spgemm_cbsr_cuda(bare, vals, sel, d),
                                   vlibs["kernel"])
        arms["l2_resident"] = _through(entry, fns["kernel"],
                                       lambda: sc.spgemm_cbsr_cuda(folded, vals, sel, d),
                                       vlibs["kernel"])
        if earlier:
            old = _entry(libs[("earlier", "")], entry, EARLIER_SIGNATURES["spgemm_cbsr"])
            arms["earlier"] = _earlier_spgemm(old, csr, vals, sel, d)
        a = torch.sparse_csr_tensor(csr.indptr.long(), csr.indices.long(), csr.values.to(dtype),
                                    (v, v))
        dense = densify_plain(vals, sel, d)
        arms["torch_sparse_mm"] = lambda: torch.sparse.mm(a, dense)
        out[f"spgemm_cbsr_{tag}"] = _case(
            arms, [*K10_EXACT] + (["earlier"] if earlier else []), args.rounds,
            arms["kernel"], _csr_bytes(csr, True) + v * k * (isz + 4) + v * d * isz,
            e_live * k * (2 + isz), hub_rows=min(layout["k10_cache_rows"],
                                                 csr.segments.hub_rows.shape[0]),
            hub_share=hub_share(csr, layout["k10_cache_rows"]), folded_rows=folded_rows)
        del vals, sel, folded, bare, arms, a, dense
    return out


if __name__ == "__main__":
    main()
