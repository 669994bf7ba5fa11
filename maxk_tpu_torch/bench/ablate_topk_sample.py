"""Where the top-k → CBSR (K4) and the CBSR sample (K3) spend their time on
the card, with the designs each replaced timed beside them.

    python -m maxk_tpu_torch.bench.ablate_topk_sample [--v 232965 --dim 256 --k 32]

K4 at (V, dim) normal values, k of 32, f32 and bf16; copies of
`csrc/topk_cbsr.cu`, each with one part of the work taken out or changed by
a text edit:

  kernel       the kernel (each (value, column) pair stored from registers)
  staged       the other compaction: where k % 4 == 0, the pairs staged
               through a per-warp shared buffer and stored as 16-byte vectors
  no_search    a fixed mask in place of the search, exactly k taken (the
               first k/32 columns of each lane's span, one more in the
               first k % 32 lanes): loads, compaction, stores
  no_stores    nothing stored (only for k < 1, never): loads and search
  loads_only   each lane's elements folded, stored only on one value
  two_level    f32 by the two-level compare search in place of the
               bit-sliced one (`ablate_mask_gather.search_edits`)
  sliced16     bf16 by the bit-sliced search in place of the 16-step one
  strided      the design it replaced: lane l owns the columns i*32+l,
               scalar loads, the 32-step search (`ablate_mask_gather.
               STRIDED_SEARCH`), a ballot per column for the compaction

and `torch.topk` (selection only) beside them. K3 at (V, k) selectors into
a (V, dim) table, f32 and bf16, on the selectors K4 gives (distinct,
ascending within a row: the training paths' input) and on random ones
(duplicates within a row); copies of `csrc/cbsr.cu`:

  kernel       the kernel (f32: a slot a thread, loads through the
               read-only cache; bf16: 4 slots a thread, spaced by the block,
               data not allocated in L1)
  slots1       one slot a thread in both dtypes; `slots4` 4 slots a thread
  l1           loads through the read-only cache (`__ldg`) in both dtypes;
               `no_l1` streaming selectors, data not allocated in L1
  loads_only   selectors and data loaded, stored only on one value
  stores_only  no data loaded: each store writes its selectors
  per_slot     the design it replaced: a thread per slot, a 64-bit
               division for its row (`maxk::gather_in_row`)
  vec4         a first redesign, not kept: 4 consecutive slots a thread,
               one 16-byte selector load, 4 data loads not allocated in
               L1, one vector store (a warp instruction spans 4 rows)
  whole_row    a warp per row reads its row of the table whole (16-byte
               vectors, coalesced) beside its selectors, and picks the
               values by shuffles: no load waits for another (dim = 256)

and `torch.gather` beside them; `slots1`/`slots4` and `l1`/`no_l1` each
repeat the kernel in one dtype. Every arm is the median of --rounds runs of
20 launches after one, the arms taken in turns, their order reversed each
run (`ablate_mask_gather.turns`). Every arm but `no_search`, `no_stores`,
`loads_only` and `stores_only` computes the function, and is held equal to
the plain version first. Prints one JSON line: per arm the median and
range in ms, the bound (K3: by the distinct elements read, and beside it
by the distinct 32-byte sectors and 64-byte granules,
`micro.in_row_gather_bound`), the card's name.

The edits name lines of the kernels' sources as they stand: a rewrite may
leave one without its line, and the tool then raises naming it.
"""

from __future__ import annotations

import argparse
import json

import torch

from maxk_tpu_torch.bench.ablate_mask_gather import (SEARCH_ARMS, STRIDED_SEARCH, bits, build,
                                                     edited, entry, search_edits, turns)

TOOL = "ablate_topk_sample"

# exactly k taken without a search: c = k/32 (+1 in the first k % 32 lanes)
# columns from the start of each lane's span, c <= NPL since k <= D
_FIXED_MASK = ("    { const int c = k / 32 + (lane < k % 32);"
               " mask = c >= 32 ? ~0u : (1u << c) - 1u; }")

# the pairs through a per-warp shared buffer (8·k bytes), out as 16-byte
# vectors: values and columns in one store instruction at k = 32
_STAGED = """  if (k % 4 == 0) {
    extern __shared__ uint4 stage[];
    float* sv = reinterpret_cast<float*>(stage) + warp * 2 * k;
    int* ss = reinterpret_cast<int*>(sv + k);
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      if ((mask >> i) & 1u) {
        sv[slot] = cbsr_value(kBf16 ? bits[i] << 16 : bits[i]);
        ss[slot] = lane * NPL + i;
        ++slot;
      }
    }
    __syncwarp();
    const int q = k / 4;
    const uint4* src = reinterpret_cast<const uint4*>(sv);
    uint4* vo = reinterpret_cast<uint4*>(vals + row * k);
    uint4* so = reinterpret_cast<uint4*>(sel + row * k);
#pragma unroll 1
    for (int u = lane; u < 2 * q; u += 32) *(u < q ? vo + u : so + (u - q)) = src[u];
    return;
  }
"""

TOPK_EDITS = {
    "kernel": [],
    "staged": [("  float* vr = vals + row * k;\n", _STAGED + "  float* vr = vals + row * k;\n"),
               ("<<<grid, block, 0, stream>>>",
                "<<<grid, block, kWarpsPerBlock * 2 * k * sizeof(float), stream>>>")],
    "no_search": [("    mask = maxk::row_topk_mask16<NPL>(key, k, lane);", _FIXED_MASK),
                  ("    mask = maxk::row_topk_mask32<NPL>(key, k, lane, scratch[warp]);",
                   _FIXED_MASK)],
    "no_stores": [("  unsigned slot = maxk::exclusive_warp_sum(__popc(mask), lane);",
                   "  if (k > 0) return;\n"
                   "  unsigned slot = maxk::exclusive_warp_sum(__popc(mask), lane);")],
    "loads_only": [("  uint32_t key[NPL];\n  uint32_t mask;",
                    "  {\n    uint32_t a = 0;\n#pragma unroll\n"
                    "    for (int i = 0; i < NPL; ++i) a ^= bits[i] * 0x9e3779b1u;\n"
                    "    if (a == 0x2545f491u) sel[row * k] = 1;\n    return;\n  }\n"
                    "  uint32_t key[NPL];\n  uint32_t mask;")],
}

SAMPLE_EDITS = {
    "kernel": [],
    "slots1": [("constexpr int kSlots = sizeof(U) == 4 ? 1 : 4;", "constexpr int kSlots = 1;")],
    "slots4": [("constexpr int kSlots = sizeof(U) == 4 ? 1 : 4;", "constexpr int kSlots = 4;")],
    "l1": [("constexpr bool kL1 = sizeof(U) == 4;", "constexpr bool kL1 = true;")],
    "no_l1": [("constexpr bool kL1 = sizeof(U) == 4;", "constexpr bool kL1 = false;")],
    "loads_only": [("if (i0 + j * kSampleThreads < n) out[i0 + j * kSampleThreads] = v[j];",
                    "if (i0 + j * kSampleThreads < n && v[j] == (U)0x2545f491u)"
                    " out[i0 + j * kSampleThreads] = v[j];")],
    "stores_only": [("      v[j] = L1 ? __ldg(p) : load_data(p);", "      v[j] = (U)(c[j] + (int)r[j]);")],
}

# the designs replaced or not kept, with the C signatures of the kernels
EARLIER = r'''
#include "common.cuh"
''' + STRIDED_SEARCH + r'''
namespace {
// the top-k → CBSR design replaced: lane l holds the columns i*32+l; the
// warp walks its columns in order, and a lane whose column i*32+l is taken
// writes slot taken_before + popc(ballot(taken at i) & lanes below l)
template <typename T, int NPL>
__global__ void __launch_bounds__(256) strided_topk(const T* __restrict__ x, float* __restrict__ vals,
                                                    int* __restrict__ sel, int rows, int k) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * (NPL * 32) + lane;
  uint32_t key[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) key[i] = maxk::to_key(maxk::load_f32(xr + i * 32));
  const uint32_t mask = strided::row_topk_mask<NPL>(key, k, lane);
  const unsigned below = (1u << lane) - 1u;
  float* vr = vals + row * k;
  int* sr = sel + row * k;
  unsigned taken_before = 0;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const bool t = (mask >> i) & 1u;
    const unsigned ballot = __ballot_sync(maxk::kFull, t);
    if (t) {
      const unsigned slot = taken_before + __popc(ballot & below);
      const float v = strided::from_key(key[i]);
      vr[slot] = (v == 0.0f) ? 0.0f : v;
      sr[slot] = i * 32 + lane;
    }
    taken_before += __popc(ballot);
  }
}

// the sample design replaced: a thread per slot in a grid-stride loop
template <typename T>
__global__ void per_slot_sample(const T* __restrict__ z, const int* __restrict__ sel,
                                T* __restrict__ out, int64_t n, int k, int dim) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    maxk::gather_in_row(z, sel, out, i, k, dim);
}

__device__ __forceinline__ uint32_t load_na(const uint32_t* p) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ uint16_t load_na(const uint16_t* p) {
  uint16_t v;
  asm("ld.global.nc.L1::no_allocate.b16 %0, [%1];" : "=h"(v) : "l"(p));
  return v;
}

// a first sample redesign, not kept: a thread per 4 consecutive slots (k %
// 4 == 0, aligned pointers), one 16-byte selector load, 4 data loads not
// allocated in L1, one 16-byte (f32) or 8-byte (bf16) store
template <typename U>
__global__ void __launch_bounds__(256) vec4_sample(const U* __restrict__ z, const int* __restrict__ sel,
                                                   U* __restrict__ out, int rows, int k, int dim) {
  const int per_row = k / 4;
  const int64_t units = (int64_t)rows * per_row;
  const int64_t u = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (u >= units) return;
  const int64_t r = units <= 0xffffffffll ? (int64_t)((uint32_t)u / (uint32_t)per_row) : u / per_row;
  const U* zr = z + r * dim;
  const int4 s = __ldcs(reinterpret_cast<const int4*>(sel) + u);
  const int c[4] = {s.x, s.y, s.z, s.w};
  U v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = (unsigned)c[j] < (unsigned)dim ? load_na(zr + c[j]) : 0;
  if constexpr (sizeof(U) == 4)
    reinterpret_cast<uint4*>(out)[u] = make_uint4(v[0], v[1], v[2], v[3]);
  else
    reinterpret_cast<uint2*>(out)[u] =
        make_uint2(v[0] | ((uint32_t)v[1] << 16), v[2] | ((uint32_t)v[3] << 16));
}

// a warp per row: lane l holds the row's words [l*NW, (l+1)*NW) (16-byte
// loads), and the lane of slot l takes its value from the word's owner by NW
// shuffles; selectors outside the row give 0
template <typename U, int NW>
__global__ void __launch_bounds__(256) whole_row_sample(const uint32_t* __restrict__ z,
                                                        const int* __restrict__ sel,
                                                        U* __restrict__ out, int rows, int k) {
  constexpr int kPer = 4 / (int)sizeof(U);  // elements a word
  constexpr int D = 32 * NW * kPer;
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (r >= rows) return;
  uint32_t w[NW];
  const uint4* src = reinterpret_cast<const uint4*>(z + r * (32 * NW)) + lane * (NW / 4);
#pragma unroll
  for (int j = 0; j < NW / 4; ++j) {
    const uint4 q = __ldcs(src + j);
    w[4 * j] = q.x, w[4 * j + 1] = q.y, w[4 * j + 2] = q.z, w[4 * j + 3] = q.w;
  }
#pragma unroll 1
  for (int l0 = 0; l0 < k; l0 += 32) {
    const int l = l0 + lane;
    const int c = l < k ? __ldcs(sel + r * k + l) : -1;
    const bool ok = (unsigned)c < (unsigned)D;
    const int word = ok ? c / kPer : 0;
    const int owner = word / NW, at = word % NW;
    uint32_t got = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const uint32_t t = __shfl_sync(maxk::kFull, w[j], owner);
      if (j == at) got = t;
    }
    if (l < k) out[r * k + l] = ok ? (U)(kPer == 2 ? got >> (16 * (c & 1)) : got) : (U)0;
  }
}
}  // namespace

#define STRIDED(NAME, T)                                                                      \
  extern "C" int NAME(const void* x, void* v, void* s, int rows, int dim, int k, void* st) {  \
    if (dim != 256) return (int)cudaErrorInvalidValue;                                       \
    strided_topk<T, 8><<<(rows + 7) / 8, 256, 0, (cudaStream_t)st>>>((const T*)x, (float*)v, \
                                                                     (int*)s, rows, k);       \
    return (int)cudaGetLastError();                                                           \
  }
STRIDED(strided_topk_f32, float) STRIDED(strided_topk_bf16, __nv_bfloat16)

#define PER_SLOT(NAME, T)                                                                     \
  extern "C" int NAME(const void* z, const void* s, void* o, int rows, int k, int dim,        \
                      void* st) {                                                             \
    const int64_t n = (int64_t)rows * k, want = (n + 255) / 256;                               \
    const int64_t blocks = want < ((int64_t)1 << 20) ? want : ((int64_t)1 << 20);              \
    per_slot_sample<T><<<(unsigned)blocks, 256, 0, (cudaStream_t)st>>>(                      \
        (const T*)z, (const int*)s, (T*)o, n, k, dim);                                       \
    return (int)cudaGetLastError();                                                           \
  }
PER_SLOT(per_slot_sample_f32, float) PER_SLOT(per_slot_sample_bf16, __nv_bfloat16)

#define WHOLE_ROW(NAME, U, NW)                                                                \
  extern "C" int NAME(const void* z, const void* s, void* o, int rows, int k, int dim,        \
                      void* st) {                                                             \
    if (dim * (int)sizeof(U) != 128 * NW) return (int)cudaErrorInvalidValue;                  \
    whole_row_sample<U, NW><<<(rows + 7) / 8, 256, 0, (cudaStream_t)st>>>(                   \
        (const uint32_t*)z, (const int*)s, (U*)o, rows, k);                                   \
    return (int)cudaGetLastError();                                                           \
  }
WHOLE_ROW(whole_row_sample_f32, uint32_t, 8) WHOLE_ROW(whole_row_sample_bf16, uint16_t, 4)

#define VEC4(NAME, U)                                                                         \
  extern "C" int NAME(const void* z, const void* s, void* o, int rows, int k, int dim,        \
                      void* st) {                                                             \
    if (k % 4) return (int)cudaErrorInvalidValue;                                             \
    const int64_t blocks = ((int64_t)rows * (k / 4) + 255) / 256;                              \
    vec4_sample<U><<<(unsigned)blocks, 256, 0, (cudaStream_t)st>>>((const U*)z, (const int*)s, \
                                                                  (U*)o, rows, k, dim);       \
    return (int)cudaGetLastError();                                                           \
  }
VEC4(vec4_sample_f32, uint32_t) VEC4(vec4_sample_bf16, uint16_t)
'''


def build_variants() -> dict:
    """(kernel, variant) -> the loaded library of that copy of the source."""
    from maxk_tpu_torch.ops import _native

    sources = {("earlier", ""): EARLIER}
    topk, cbsr, common = ((_native.CSRC / f).read_text()
                          for f in ("topk_cbsr.cu", "cbsr.cu", "common.cuh"))
    edits = {**TOPK_EDITS, **search_edits(common)}
    sources.update({("topk", k): edited(TOOL, k, topk, e) for k, e in edits.items()})
    sources.update({("sample", k): edited(TOOL, k, cbsr, e) for k, e in SAMPLE_EDITS.items()})
    return build(TOOL, sources)


def main(argv=None) -> dict:
    from maxk_tpu_torch.bench.micro import bound, in_row_gather_bound
    from maxk_tpu_torch.ops import _native, cbsr_cuda, topk_cuda

    p = argparse.ArgumentParser()
    p.add_argument("--v", type=int, default=232965)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--k", type=int, default=32)
    p.add_argument("--rounds", type=int, default=5)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ablate_topk_sample: no CUDA device; the kernels run only on the card")
    libs = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(0)
    v, d, k = args.v, args.dim, args.k
    out = {"device": torch.cuda.get_device_name(0)}

    def stream():
        return torch.cuda.current_stream().cuda_stream

    for dtype in (torch.float32, torch.bfloat16):
        tag, isz = str(dtype).split(".")[-1], torch.finfo(dtype).bits // 8
        suffix = "f32" if dtype == torch.float32 else "bf16"
        x = torch.randn((v, d), generator=gen, device="cuda").to(dtype)
        vals = torch.empty((v, k), device="cuda")
        sel = torch.empty((v, k), dtype=torch.int32, device="cuda")
        sig = _native.SIGNATURES[f"topk_cbsr_{suffix}"]
        fns = {var: entry(libs[("topk", var)], f"topk_cbsr_{suffix}", sig)
               for var in (*TOPK_EDITS, *SEARCH_ARMS)}
        fns["strided"] = entry(libs[("earlier", "")], f"strided_topk_{suffix}", sig)

        def call(fn):
            return lambda: fn(x.data_ptr(), vals.data_ptr(), sel.data_ptr(), v, d, k, stream())

        vals0, sel0 = topk_cuda.topk_cbsr_plain(x, k)
        exact = {}
        for var in ("kernel", "staged", *SEARCH_ARMS, "strided"):
            vals.zero_()
            sel.zero_()
            call(fns[var])()
            torch.cuda.synchronize()
            exact[var] = torch.equal(sel, sel0) and torch.equal(bits(vals), bits(vals0))
        arms = {var: call(fn) for var, fn in fns.items()}
        arms["torch_topk"] = lambda: torch.topk(x, k)
        out[f"topk_cbsr_{tag}"] = {"exact": exact, **bound(v * d * isz + v * k * 8),
                                   **turns(arms, args.rounds)}
        del x, vals, vals0

        z = torch.randn((v, d), generator=gen, device="cuda").to(dtype)
        o = torch.empty((v, k), dtype=dtype, device="cuda")
        sig = _native.SIGNATURES[f"cbsr_sample_{suffix}"]
        fns = {var: entry(libs[("sample", var)], f"cbsr_sample_{suffix}", sig)
               for var in SAMPLE_EDITS}
        fns.update({var: entry(libs[("earlier", "")], f"{var}_sample_{suffix}", sig)
                    for var in ("per_slot", "vec4", "whole_row")})
        inputs = {"topk_cbsr": sel0,
                  "random": torch.randint(0, d, (v, k), generator=gen, device="cuda",
                                          dtype=torch.int32)}
        for name, s in inputs.items():
            s64 = s.long()

            def scall(fn, s=s):
                return lambda: fn(z.data_ptr(), s.data_ptr(), o.data_ptr(), v, k, d, stream())

            ref = cbsr_cuda.sample_plain(z, s)
            exact = {}
            for var in ("kernel", "slots1", "slots4", "l1", "no_l1", "per_slot", "vec4", "whole_row"):
                o.zero_()
                scall(fns[var])()
                torch.cuda.synchronize()
                exact[var] = torch.equal(bits(o), bits(ref))
            arms = {var: scall(fn) for var, fn in fns.items()}
            arms["torch_gather"] = lambda s64=s64: torch.gather(z, 1, s64)
            out[f"cbsr_sample_{tag}_{name}"] = {"exact": exact, **in_row_gather_bound(s, d, isz),
                                                **turns(arms, args.rounds)}
        del z, o, sel, sel0, inputs, ref
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
