"""Where the segsum path's CSR kernels K9 (`spmm_csr`), K10 (`spgemm_cbsr`)
and K11 (`sspmm_cbsr`) spend their time on the card.

    python -m maxk_tpu_torch.bench.ablate_csr [--graph reddit ... --scale 1.0 --dim 256
        --k 16 32 64 --ops k9 k10 k11 --rounds 3] [--earlier path/to/spmm_csr.cu]

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
folded into the rows whose merged slots fill half of L2).

K11 over Aᵀ (k random selectors a row): `kernel` (column slices of 512
bytes a row of g where the rule takes them), `table_order` (its `work`
table in table order), `one_lane_layout` (one slot a lane, 32 slots a
walk of the edges: the earlier layout inside the new grid), `unsorted` (a
lane's several slots not ordered by selector), `chunk16` (16 gathers a
chunk a lane in place of 8), `static_units` / `dynamic_units` (every unit
in turn, w, w + W, ..., or every unit from the counter, in place of the
counter for the long segments' units where they outnumber the warps and
turns for the rest), `other_pipe` (the other choice of chunks in flight
and blocks an SM: at 8 or 16 lanes a segment, and in f32 at several
slots a lane, without a chunk in flight during the adds at 6 blocks an
SM; elsewhere with one at 4), `lean_warp` (no chunk in flight at 32
lanes in f32 at several slots a lane too),
`persistent_grid` / `hw_grid` (a persistent grid for every walk, or a
warp a unit on as many blocks as that takes for every walk, in place of
the first for walks in slices and the second over whole rows), `snake`
(the in-turn units dealt back and forth, w, 2W - 1 - w, 2W + w, ...),
`slice_256` (slices of 256 bytes), `sliced` / `whole_rows`
(the walk in slices, or over whole rows, whatever the rule
`spmm_csr.K11_SLICE_MIN_DEGREE` picks), `no_math` (gathers folded into
one value), `cvt_round` (bf16 products by a conversion) and
`l2_resident` (Aᵀ's column indices folded into the rows of g that fill
half of L2: the sampled gather's ceiling).

`torch.sparse.mm` on the same CSR (K10: on the densified CBSR; K11: Aᵀ @ g,
not sampled) beside them. K10 and K11 run at each `--k`; `--ops` picks the
kernels. With `--earlier`, a `spmm_csr.cu` of the earlier design (with
its own `common.cuh` beside it: K9 and K10 that take the arguments the
current ones take, and the K11 of `EARLIER_SIGNATURES`, before the work
table and the counters) is built too and timed in the same turns
(`earlier`).

Every arm is the median of --rounds runs of 20 launches after one (and its
range), the arms in turns, the order reversed each run. The arms that
compute the function (`K9_EXACT`, `K10_EXACT`, `K11_EXACT`, `earlier`) are
each held to the kernel's bits first (`exact`). `gathered_bytes` is a row
(K9) or k slots (K10) an edge, and for K11 the 32-byte sectors of g's
rows that the selectors touch (`sector_bytes`); `gather_ceiling_ms` is
the `l2_resident` arm's time (`gather_ceiling_gbs` its rate); the
read-once bound (`bound_ms`) counts what the function reads and writes,
once: the CSR (`csr_bytes`: not the kernels' segment, work or hub
tables), the features or CBSR, and the output; K10's `hub_share` is the share of the edges whose source
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

# K11's adds, as they stand in the source (leading blanks left out)
_K11_PAIR = "if (has0 && live[s]) add_bf16_pair(acc[s], v[u][s], v[u + 1][s], ap, has1);"
_K11_F32 = ("if (has0 && live[s]) acc[s] = __fadd_rn(acc[s], __fmul_rn(v[u][s], a0));",
            "if (has1 && live[s]) acc[s] = __fadd_rn(acc[s], __fmul_rn(v[u + 1][s], a1));")


def _k11_layout(lanes: str, slots: str) -> list:
    """The edit that gives K11's launch the lane layout (lanes a segment,
    slots a lane) of the expressions `lanes` and `slots` of k."""
    return [("const int lanes = k <= 8 ? 8 : k <= 16 ? 16 : 32;", f"const int lanes = {lanes};"),
            ("const int slots = k <= 32 ? 1 : k <= 64 ? 2 : 4;", f"const int slots = {slots};")]


K11_EDITS = {
    "kernel": [],
    "one_lane_layout": _k11_layout("32 + 0 * k", "1 + 0 * k"),
    "unsorted": [("constexpr int kSortMin = 16;", "constexpr int kSortMin = 1 << 30;")],
    "chunk16": [("constexpr int kK11Chunk = 8;", "constexpr int kK11Chunk = 16;")],
    "slice_256": [("constexpr int kK11SliceBytes = 512;", "constexpr int kK11SliceBytes = 256;")],
    "static_units": [("const int dyn = dyn_units >= nwarps ? dyn_units : 0;",
                      "const int dyn = 0 * dyn_units;")],
    "dynamic_units": [("const int dyn = dyn_units >= nwarps ? dyn_units : 0;",
                       "const int dyn = units + 0 * dyn_units;")],
    "other_pipe": [("constexpr bool kK11Pipelined = G < 32 || (sizeof(T) == 4 && S > 1);",
                    "constexpr bool kK11Pipelined = !(G < 32 || (sizeof(T) == 4 && S > 1));")],
    # the grid: persistent for every walk, or a warp a unit (as many blocks
    # as that takes, the block scheduler dealing them out) for every walk;
    # the in-turn units dealt back and forth; no chunk in flight at
    # whole-warp groups in f32 too
    "persistent_grid": [("const unsigned blocks = slice < dim ?",
                         "const unsigned blocks = slice < dim || true ?")],
    "hw_grid": [("const unsigned blocks = slice < dim ?",
                 "const unsigned blocks = slice < dim && false ?")],
    "lean_warp": [("constexpr bool kK11Pipelined = G < 32 || (sizeof(T) == 4 && S > 1);",
                   "constexpr bool kK11Pipelined = G < 32;")],
    "snake": [("if (unit >= dyn) return unit + nwarps;",
               "if (unit >= dyn) return unit + 2 * nwarps - 1 - 2 * ((unit - dyn) % nwarps);")],
    "no_math": [(_K11_PAIR, "if (has0 && live[s]) acc[s] = __uint_as_float("
                            "__float_as_uint(acc[s]) ^ v[u][s] ^ v[u + 1][s] ^ ap);"),
                (_K11_F32[0], "if (has0 && live[s]) acc[s] = __uint_as_float("
                              "__float_as_uint(acc[s]) ^ __float_as_uint(v[u][s]) ^ "
                              "__float_as_uint(v[u + 1][s]) ^ __float_as_uint(a0) ^ "
                              "__float_as_uint(a1));"),
                (_K11_F32[1], "")],
    "cvt_round": [(_K11_PAIR, "if (has0 && live[s]) {\n"
                              "acc[s] = __fadd_rn(acc[s], product<T>(bf16_lo(v[u][s]), "
                              "bf16_lo(ap)));\n"
                              "if (has1) acc[s] = __fadd_rn(acc[s], "
                              "product<T>(bf16_lo(v[u + 1][s]), bf16_hi(ap)));\n}")],
}
K11_BF16_ONLY = ("cvt_round",)
K11_EXACT = ("kernel", "table_order", "one_lane_layout", "unsorted", "chunk16", "static_units",
             "dynamic_units", "other_pipe", "persistent_grid", "hw_grid", "snake", "lean_warp",
             "slice_256", "sliced", "whole_rows", "cvt_round")
# arms that the slicing rule (`spmm_csr.K11_SLICE_MIN_DEGREE`) decides: the
# walk in slices where the rule would take whole rows, and the reverse
K11_RULE_ARMS = {"sliced": (0, 1 << 30), "whole_rows": (1 << 40, 0)}

_P, _I = ctypes.c_void_p, ctypes.c_int
# the earlier design's K11 entry point: no work order or counter (its K9 and
# K10 take the arguments the current ones take, through the wrappers)
EARLIER_SIGNATURES = {"sspmm_cbsr": (_P,) * 13 + (_I,) * 5 + (_P,)}


def build_variants(earlier: str | None, ops=("k9", "k10", "k11")) -> dict:
    """(kernel, variant) -> the loaded library of that copy of the source,
    for the kernels `ops` (the kernel itself always)."""
    from maxk_tpu_torch.ops import _native

    tool = "ablate_csr"
    src = (_native.CSRC / "spmm_csr.cu").read_text()
    sources = {("csr", k): edited(tool, k, src, e) for k, e in K9_EDITS.items()
               if "k9" in ops or not e}
    if "k10" in ops:
        sources.update({("k10", k): edited(tool, k, src, e) for k, e in K10_EDITS.items()})
    if "k11" in ops:
        sources.update({("k11", k): edited(tool, k, src, e) for k, e in K11_EDITS.items() if e})
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


def _layout_of(lib):
    """`csr_kernels_layout` as the variant `lib` lays K9 and K11 out:
    itemsize -> (K9's slice, K10's cached rows, K11's slice) in columns; the
    wrappers hand K9 and K11 one counter a column slice."""
    from maxk_tpu_torch.ops import _native

    fn = _entry(lib, "csr_kernels_layout", _native.SIGNATURES["csr_kernels_layout"])

    def layout(itemsize: int) -> tuple:
        out = [ctypes.c_int(0) for _ in range(3)]
        err = fn(itemsize, 1, 1, *map(ctypes.byref, out))
        if err:
            raise RuntimeError(f"csr_kernels_layout: CUDA error {err}")
        return tuple(o.value for o in out)
    return layout


def _through(entry: str, fn, call, lib):
    """`call()` (a wrapper's launch) with the wrapper's entry point `entry`
    bound to `fn` and its K9 and K11 layouts to those of `lib`, a
    variant's."""
    from maxk_tpu_torch.ops import _native
    from maxk_tpu_torch.ops import spmm_csr as sc

    _native.library()
    layout = _layout_of(lib)

    def run():
        keep = _native._fns[entry], sc._slice_cols, sc._k11_slice_cols
        _native._fns[entry] = fn
        sc._slice_cols = lambda itemsize: layout(itemsize)[0]
        sc._k11_slice_cols = lambda itemsize: layout(itemsize)[2]
        try:
            return call()
        finally:
            _native._fns[entry], sc._slice_cols, sc._k11_slice_cols = keep
    return run


def _with_rule(rule: tuple, fn):
    """`fn()` with K11's slicing rule set to (K11_SLICE_MIN_DEGREE,
    K11_SLICE_MAX_K) = `rule`."""
    from maxk_tpu_torch.ops import spmm_csr as sc

    def run():
        keep = sc.K11_SLICE_MIN_DEGREE, sc.K11_SLICE_MAX_K
        sc.K11_SLICE_MIN_DEGREE, sc.K11_SLICE_MAX_K = rule
        try:
            return fn()
        finally:
            sc.K11_SLICE_MIN_DEGREE, sc.K11_SLICE_MAX_K = keep
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


def _in_table_order(csr):
    """`csr` whose segment table's `work` lists the segments in table (CSR)
    order, not longest first."""
    from dataclasses import replace

    from maxk_tpu_torch.sparse.csr import CSRGraph

    t = csr.segments
    inv = torch.empty_like(t.order)
    inv[t.order.long()] = torch.arange(t.num_segments, dtype=t.order.dtype, device=inv.device)
    return CSRGraph(csr.indptr, csr.indices, csr.values,
                    replace(t, work=t.work[inv.long()].contiguous()))


def _table_ptrs(csr):
    t = csr.segments
    return [a.data_ptr() for a in (csr.indptr, csr.indices, csr.values, t.row, t.begin, t.part,
                                   t.multi_row, t.multi_part0, t.multi_nseg)]


def _earlier_sspmm(fn, csc, g, sel):
    def run():
        t = csc.segments
        k = sel.shape[1]
        out = g.new_empty((csc.num_nodes, k))
        part = torch.empty((t.num_parts, k), dtype=torch.float32, device=g.device)
        err = fn(*_table_ptrs(csc), g.data_ptr(), sel.data_ptr(), out.data_ptr(), part.data_ptr(),
                 t.num_segments, t.multi_row.shape[0], t.seg_edges, k, g.shape[1],
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"earlier sspmm_cbsr: CUDA error {err}")
        return out
    return run


def sector_bytes(csr, sel, dim: int, itemsize: int) -> int:
    """K11's gathered bytes: over the rows j of `csr` (Aᵀ), its live edges
    × 32 × the distinct 32-byte sectors of a row of g (`itemsize`-byte
    elements) that the selectors sel[j] in [0, dim) fall in. Computed on
    the selectors' device."""
    valid = (sel >= 0) & (sel < dim)
    sec = torch.where(valid, sel.long() * itemsize // 32, -1).sort(dim=1).values
    new = sec >= 0
    new[:, 1:] &= sec[:, 1:] != sec[:, :-1]
    deg = torch.diff(csr.indptr.long())
    return 32 * int((deg * new.sum(dim=1)).sum())


def csr_bytes(csr) -> int:
    """The bytes a function of the CSR reads of it, once: the row pointers
    and the live edges' columns and weights. The segment, work and hub
    tables are the kernels' own layout, not an input of what they compute,
    so no bound counts them."""
    live = int(csr.indptr[-1])
    return (csr.indptr.numel() * csr.indptr.element_size()
            + live * (csr.indices.element_size() + csr.values.element_size()))


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
    p.add_argument("--k", type=int, nargs="+", default=[16, 32, 64],
                   help="CBSR slots a row: K10 and K11 run at each")
    p.add_argument("--ops", nargs="+", choices=("k9", "k10", "k11"), default=["k9", "k10", "k11"])
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--earlier", default=None,
                   help="a spmm_csr.cu of the earlier design, timed beside the kernels")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ablate_csr: no CUDA device; the kernels run only on the card")
    libs = build_variants(args.earlier, args.ops)
    outs = []
    for name in args.graph:
        outs.append(probe_graph(args, name, libs))
        print(json.dumps(outs[-1]), flush=True)
    return outs


def _arms(entry: str, variants, libs: dict, kernel_lib, call, earlier_lib=None) -> dict:
    """Each variant's launch of `call` through `entry` (a variant without
    edits is the kernel's own library), and the earlier design's where it
    is given."""
    from maxk_tpu_torch.ops import _native

    sig = _native.SIGNATURES[entry]
    arms = {}
    for var in variants:
        lib = libs.get(var, kernel_lib)
        arms[var] = _through(entry, _entry(lib, entry, sig), call, lib)
    if earlier_lib is not None:
        arms["earlier"] = _through(entry, _entry(earlier_lib, entry, sig), call, earlier_lib)
    return arms


def probe_graph(args, name: str, libs: dict) -> dict:
    """Every arm on one graph, as `main` describes."""
    from maxk_tpu_torch.bench import kernel_bench
    from maxk_tpu_torch.data.datasets import load_dataset
    from maxk_tpu_torch.ops import _native
    from maxk_tpu_torch.ops import spmm_csr as sc
    from maxk_tpu_torch.sparse.graph import build_graph

    if name == "reddit":
        raw = load_dataset("reddit", scale=args.scale, seed=123).csr
    else:
        suite = argparse.Namespace(dir=None, graphs=[name], scale=args.scale)
        (_, raw), = kernel_bench.load_suite(suite)
    graph = build_graph(raw, norm="right", device="cuda")
    del raw
    v, d = graph.num_nodes, args.dim
    e_live = int(graph.csr.indptr[-1])
    l2 = _native.l2_cache_bytes()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"device": torch.cuda.get_device_name(0), "graph": name, "scale": args.scale,
           "nodes": v, "edges": e_live, "dim": d, "k": args.k,
           "l2_bytes": l2, "ncu": shutil.which("ncu")}
    old = libs.get(("earlier", "")) if args.earlier else None
    ex = ["earlier"] if old is not None else []
    kernel_lib = libs[("csr", "kernel")]
    for dtype in (torch.float32, torch.bfloat16):
        tag, isz = str(dtype).split(".")[-1], torch.finfo(dtype).bits // 8
        suffix = "f32" if isz == 4 else "bf16"
        if "k9" in args.ops:
            k9 = {var: libs[("csr", var)] for var in K9_EDITS}
            variants = [var for var in K9_EDITS if isz == 2 or var not in K9_BF16_ONLY]
            folded_rows = l2 // 2 // (d * isz)
            for op, csr in (("A", graph.csr), ("At", graph.csc)):
                x = torch.randn((v, d), generator=gen, device="cuda").to(dtype)
                folded = folded_csr(csr, folded_rows)
                arms = _arms(f"spmm_csr_{suffix}", variants, k9, kernel_lib,
                             lambda c=csr: sc.spmm_csr_cuda(c, x), old)
                arms["l2_resident"] = _arms(f"spmm_csr_{suffix}", ["kernel"], k9, kernel_lib,
                                            lambda: sc.spmm_csr_cuda(folded, x))["kernel"]
                a = torch.sparse_csr_tensor(csr.indptr.long(), csr.indices.long(),
                                            csr.values.to(dtype), (v, v))
                arms["torch_sparse_mm"] = lambda: torch.sparse.mm(a, x)
                out[f"spmm_csr_{op}_{tag}"] = _case(
                    arms, [*K9_EXACT, *ex], args.rounds, arms["kernel"],
                    csr_bytes(csr) + 2 * v * d * isz, e_live * d * isz,
                    slice_cols=sc.kernel_layout(isz, 1, d)["slice_cols"],
                    folded_rows=folded_rows)
                del x, folded, arms, a
        for k in args.k:
            sel = torch.randint(0, d, (v, k), generator=gen, device="cuda", dtype=torch.int32)
            if "k10" in args.ops:
                out[f"spgemm_cbsr_{tag}_k{k}"] = _k10_case(args, graph, libs, kernel_lib, old,
                                                          dtype, sel, gen)
            if "k11" in args.ops:
                out[f"sspmm_cbsr_{tag}_k{k}"] = _k11_case(args, graph, libs, kernel_lib, old,
                                                         dtype, sel, gen)
            del sel
    return out


def _k10_case(args, graph, libs, kernel_lib, old, dtype, sel, gen) -> dict:
    from maxk_tpu_torch.ops import _native
    from maxk_tpu_torch.ops import spmm_csr as sc
    from maxk_tpu_torch.ops.cbsr_cuda import densify_plain

    v, d, k = graph.num_nodes, args.dim, sel.shape[1]
    isz = torch.finfo(dtype).bits // 8
    entry = f"spgemm_cbsr_{'f32' if isz == 4 else 'bf16'}"
    layout = sc.kernel_layout(isz, k, d)
    csr = graph.csr
    e_live = int(csr.indptr[-1])
    vals = torch.randn((v, k), generator=gen, device="cuda").to(dtype)
    folded_rows = _native.l2_cache_bytes() // 2 // (k * (2 + isz))
    folded, bare = folded_csr(csr, folded_rows, hubs=True), _no_hubs(csr)
    k10 = {var: libs[("k10", var)] for var in K10_EDITS}
    arms = _arms(entry, ["kernel", *K10_EDITS], k10, kernel_lib,
                 lambda: sc.spgemm_cbsr_cuda(csr, vals, sel, d), old)
    arms["no_hubs"] = _arms(entry, ["kernel"], k10, kernel_lib,
                            lambda: sc.spgemm_cbsr_cuda(bare, vals, sel, d))["kernel"]
    arms["l2_resident"] = _arms(entry, ["kernel"], k10, kernel_lib,
                                lambda: sc.spgemm_cbsr_cuda(folded, vals, sel, d))["kernel"]
    a = torch.sparse_csr_tensor(csr.indptr.long(), csr.indices.long(), csr.values.to(dtype),
                                (v, v))
    dense = densify_plain(vals, sel, d)
    arms["torch_sparse_mm"] = lambda: torch.sparse.mm(a, dense)
    return _case(
        arms, [*K10_EXACT, *(["earlier"] if old is not None else [])], args.rounds,
        arms["kernel"], csr_bytes(csr) + v * k * (isz + 4) + v * d * isz,
        e_live * k * (2 + isz), k=k,
        hub_rows=min(layout["k10_cache_rows"], csr.segments.hub_rows.shape[0]),
        hub_share=hub_share(csr, layout["k10_cache_rows"]), folded_rows=folded_rows)


def _k11_case(args, graph, libs, kernel_lib, old, dtype, sel, gen) -> dict:
    from maxk_tpu_torch.ops import _native
    from maxk_tpu_torch.ops import spmm_csr as sc

    v, d, k = graph.num_nodes, args.dim, sel.shape[1]
    isz = torch.finfo(dtype).bits // 8
    entry = f"sspmm_cbsr_{'f32' if isz == 4 else 'bf16'}"
    csc = graph.csc
    g = torch.randn((v, d), generator=gen, device="cuda").to(dtype)
    folded_rows = _native.l2_cache_bytes() // 2 // (d * isz)
    folded = folded_csr(csc, folded_rows)
    k11 = {var: libs[("k11", var)] for var, e in K11_EDITS.items() if e}
    variants = [var for var in K11_EDITS if isz == 2 or var not in K11_BF16_ONLY]
    arms = _arms(entry, variants, k11, kernel_lib, lambda: sc.sspmm_cbsr_cuda(csc, g, sel))
    for var, rule in K11_RULE_ARMS.items():
        arms[var] = _with_rule(rule, arms["kernel"])
    arms["slice_256"] = _with_rule(K11_RULE_ARMS["sliced"], arms["slice_256"])
    arms["l2_resident"] = _arms(entry, ["kernel"], k11, kernel_lib,
                                lambda: sc.sspmm_cbsr_cuda(folded, g, sel))["kernel"]
    listed = _in_table_order(csc)
    arms["table_order"] = _arms(entry, ["kernel"], k11, kernel_lib,
                                lambda: sc.sspmm_cbsr_cuda(listed, g, sel))["kernel"]
    if old is not None:
        arms["earlier"] = _earlier_sspmm(
            _entry(old, entry, EARLIER_SIGNATURES["sspmm_cbsr"]), csc, g, sel)
    a = torch.sparse_csr_tensor(csc.indptr.long(), csc.indices.long(), csc.values.to(dtype),
                                (v, v))
    arms["torch_sparse_mm"] = lambda: torch.sparse.mm(a, g)
    exact = [var for var in K11_EXACT if var in arms] + (["earlier"] if old is not None else [])
    return _case(arms, exact, args.rounds, arms["kernel"],
                 csr_bytes(csc) + v * d * isz + v * k * (4 + isz),
                 sector_bytes(csc, sel, d, isz), k=k, folded_rows=folded_rows,
                 slice_cols=sc.k11_slice(isz, k, d, v, csc.nnz))


if __name__ == "__main__":
    main()
