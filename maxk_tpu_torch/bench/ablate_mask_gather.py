"""Where the MaxK mask (K1) and the row gather (K7) spend their time on the
card, with the designs each replaced timed beside them.

    python -m maxk_tpu_torch.bench.ablate_mask_gather [--v 232965 --dim 256 --k 32 --n 262144]

K1 at (V, dim) normal values, k of 32, f32 and bf16; copies of `csrc/maxk_mask.cu`, each with one part of the
work taken out by a text edit:

  kernel       the kernel
  no_search    the threshold fixed at the key of 1.0: loads, tie pass, stores
  no_stores    y and take stored only for k < 1 (never): loads and search
  loads_only   each lane's elements folded, stored only on one value
  two_level    f32 by the two-level compare search in place of the
               bit-sliced one (`search_edits`)
  sliced16     bf16 by the bit-sliced search in place of the 16-step
               compare search (`search_edits`)
  strided      the design it replaced: lane l owns columns i*32+l, scalar
               loads and stores, the 32-step search (`STRIDED_SEARCH` below,
               which the top-k → CBSR ablation's strided design shares);
               `strided_no_search`, `strided_no_stores`,
               `strided_loads_only` its same ablations

and `torch.topk` beside them. K7 at micro's shape (n random rows of an
(n, dim) table), f32 and bf16; copies of `csrc/gather.cu`:

  kernel       the kernel
  loads_only   the rows loaded, stored only on one value
  stores_only  no row loaded: each store writes its indices
  cp_async     the design it replaced: a block per 512 indices, 16 rows of
               16-byte `cp.async` copies in flight through a shared ring,
               stored from registers; `cp_async_loads_only`,
               `cp_async_stores_only` its ablations
  tma_ring     a TMA design, measured and not kept: each thread a ring of 4
               row slots, whole rows by `cp.async.bulk` global → shared
               (completing on an mbarrier) and shared → global
  warp_rows    a register design, not kept: a warp per row, 4 rows in
               flight a warp, 16-byte chunks, streaming stores, a grid of
               every warp resident
  row_ranges   the same, ordered by source row: a warp holds 32 indices and
               all warps sweep the table in 16 MB ranges, so that a row
               drawn twice is read again while L2 holds it; not kept

and `torch.index_select` beside them. Every arm is the median of --rounds
runs of 20 launches after one, the arms taken in turns, their order
reversed each run. `kernel`, `two_level`, `sliced16`, `strided`, `cp_async`, `tma_ring`,
`warp_rows` and `row_ranges` compute the function; each of those is held equal to the plain
version first. Prints one JSON line: per arm the median and range in ms,
the bound, the card's name.

The edits name lines of the kernels' sources as they stand: a rewrite may
leave one without its line, and the tool then raises naming it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics

import torch

MASK_EDITS = {
    "kernel": [],
    "no_search": [
        ("mask = maxk::row_topk_mask16<NPL>(key, k, lane);",
         "mask = maxk::take_at<NPL>(key, 0xbf80u, (unsigned)k, lane);"),
        ("mask = maxk::row_topk_mask32<NPL>(key, k, lane, scratch[warp]);",
         "mask = maxk::take_at<NPL>(key, 0xbf800000u, (unsigned)k, lane);"),
    ],
    "no_stores": [("  if constexpr (VEC) {\n    uint32_t w[kWords];\n#pragma unroll\n"
                   "    for (int j = 0; j < kWords; ++j) {",
                   "  if (k > 0) return;\n  if constexpr (VEC) {\n    uint32_t w[kWords];\n"
                   "#pragma unroll\n    for (int j = 0; j < kWords; ++j) {")],
    "loads_only": [("  uint32_t key[NPL];\n  uint32_t mask;",
                    "  {\n    uint32_t a = 0;\n#pragma unroll\n"
                    "    for (int i = 0; i < NPL; ++i) a ^= bits[i] * 0x9e3779b1u;\n"
                    "    if (a == 0x2545f491u) take[base] = 1;\n    return;\n  }\n"
                    "  uint32_t key[NPL];\n  uint32_t mask;")],
}

GATHER_EDITS = {
    "kernel": [],
    "loads_only": [("if (g < total) store_stream(out + g, q[u]);",
                    "if (g < total && q[u].x == 0x2545f491u && q[u].y == 1u) store_stream(out + g, q[u]);")],
    "stores_only": [("if (r >= 0 && r < v) q[u] = __ldg(x + (int64_t)r * nch + (g - e * nch));",
                     "q[u] = make_uint4(r, (unsigned)g, 0, 0);")],
}

SEARCH_ARMS = ("two_level", "sliced16")


def search_edits(common: str) -> dict:
    """The search arms of the MaxK mask and the top-k → CBSR kernel, whose
    search lines are the same; `common` is common.cuh's text:
      two_level  f32 at D <= 256 by the two-level compare search (common.cuh
                 inlined with the bit-sliced search's reach set to 0)
      sliced16   bf16 at D <= 256 by the bit-sliced search on 16-bit keys
    """
    inlined = edited("search_edits", "two_level", common,
                     [("#pragma once\n", ""),
                      ("constexpr int kSlicedMaxNpl = 8;", "constexpr int kSlicedMaxNpl = 0;")])
    return {
        "two_level": [('#include "common.cuh"\n', inlined)],
        "sliced16": [("mask = maxk::row_topk_mask16<NPL>(key, k, lane);",
                      "if constexpr (NPL <= maxk::kSlicedMaxNpl) mask = maxk::row_topk_mask_sliced<NPL, 16>"
                      "(key, k, lane); else mask = maxk::row_topk_mask16<NPL>(key, k, lane);")],
    }


# The strided search that the MaxK mask and the top-k → CBSR kernels ran
# before they took contiguous columns a lane (common.cuh's search).
STRIDED_SEARCH = r'''
namespace strided {
__device__ __forceinline__ float from_key(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// Exact top-k of one row held by one warp, lane `l` holding the keys of
// columns i*32+l, i < NPL. Returns a mask whose bit i says the lane's column
// i*32+l is taken, exactly k per row:
//   * threshold = the k-th largest key, by a 32-step binary search from the
//     top bit (largest t with #{key >= t} >= k), one `__reduce_add_sync` a
//     step;
//   * every key above the threshold is taken, then the lowest columns among
//     keys equal to it until k are taken; the rank among equal keys is an
//     exclusive prefix count in column order (a running warp total plus
//     `__popc` of the ballot below the lane).
template <int NPL>
__device__ __forceinline__ uint32_t row_topk_mask(const uint32_t (&key)[NPL], int k, int lane) {
  uint32_t thr = 0;
#pragma unroll 1
  for (int bit = 31; bit >= 0; --bit) {
    const uint32_t cand = thr | (1u << bit);
    unsigned c = 0;
#pragma unroll
    for (int i = 0; i < NPL; ++i) c += key[i] >= cand;
    if (__reduce_add_sync(maxk::kFull, c) >= (unsigned)k) thr = cand;
  }
  unsigned n_gt = 0;
#pragma unroll
  for (int i = 0; i < NPL; ++i) n_gt += key[i] > thr;
  n_gt = __reduce_add_sync(maxk::kFull, n_gt);
  const unsigned need = (unsigned)k - n_gt;  // >= 1 by the search invariant
  const unsigned below = (1u << lane) - 1u;
  unsigned eq_before = 0;  // equal keys in earlier columns (warp-uniform)
  uint32_t take = 0;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const bool eq = key[i] == thr;
    const unsigned ballot = __ballot_sync(maxk::kFull, eq);
    const bool t = key[i] > thr || (eq && eq_before + __popc(ballot & below) < need);
    eq_before += __popc(ballot);
    take |= (uint32_t)t << i;
  }
  return take;
}
}  // namespace strided
'''

# the designs replaced or not kept, with C entry points of the kernels' shapes
EARLIER = r'''
#include "common.cuh"
''' + STRIDED_SEARCH + r'''
namespace {
// MODE 0 the kernel, 1 search removed (threshold fixed at the key of 1.0,
// then the tie pass), 2 stores removed, 3 loads only
template <typename T, int NPL, int MODE>
__global__ void __launch_bounds__(256) strided_mask(const T* __restrict__ x, T* __restrict__ y,
                                                    uint8_t* __restrict__ take, int rows, int k) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int64_t base = row * (NPL * 32) + lane;
  uint32_t key[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) key[i] = maxk::to_key(maxk::load_f32(x + base + i * 32));
  if (MODE == 3) {
    uint32_t a = 0;
#pragma unroll
    for (int i = 0; i < NPL; ++i) a ^= key[i] * 0x9e3779b1u;
    if (a == 0x2545f491u) take[base] = 1;
    return;
  }
  uint32_t mask;
  if (MODE == 1) {
    const uint32_t thr = 0xbf800000u;
    unsigned n_gt = 0, eq_before = 0;
#pragma unroll
    for (int i = 0; i < NPL; ++i) n_gt += key[i] > thr;
    const unsigned need = (unsigned)k - __reduce_add_sync(maxk::kFull, n_gt);
    mask = 0;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const bool eq = key[i] == thr;
      const unsigned ballot = __ballot_sync(maxk::kFull, eq);
      mask |= (uint32_t)(key[i] > thr || (eq && eq_before + __popc(ballot & ((1u << lane) - 1u)) < need)) << i;
      eq_before += __popc(ballot);
    }
  } else {
    mask = strided::row_topk_mask<NPL>(key, k, lane);
  }
  if (MODE == 2 && k > 0) return;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const bool t = (mask >> i) & 1u;
    maxk::store_f32(y + base + i * 32, t ? strided::from_key(key[i]) : 0.0f);
    take[base + i * 32] = t;
  }
}

__device__ __forceinline__ uint32_t sa(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

// MODE 0 the kernel, 1 loads only (the ring read back, stored only on one
// value), 2 stores only (nothing copied in)
template <int MODE>
__global__ void cp_async_kernel(const uint4* __restrict__ x, const int* __restrict__ idx,
                                uint4* __restrict__ out, int v, int nch, int64_t n) {
  extern __shared__ uint4 ring[];
  const int64_t e0 = (int64_t)blockIdx.x * 512;
  const int rows = n - e0 < 512 ? (int)(n - e0) : 512;
  auto start = [&](int e) {
    if (MODE != 2 && e < rows) {
      const int r = idx[e0 + e];
      const bool ok = r >= 0 && r < v;
      const uint4* src = x + (ok ? (int64_t)r * nch : 0);
      uint4* dst = ring + (e % 32) * nch;
      for (int j = threadIdx.x; j < nch; j += blockDim.x)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa(dst + j)),
                     "l"(src + j), "r"(ok ? 16 : 0));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  for (int e = 0; e < 16; ++e) start(e);
  for (int e = 0; e < rows; ++e) {
    asm volatile("cp.async.wait_group 15;\n" ::);
    start(e + 16);
    const uint4* buf = ring + (e % 32) * nch;
    uint4* o = out + (e0 + e) * nch;
    for (int j = threadIdx.x; j < nch; j += blockDim.x) {
      const uint4 q = buf[j];
      if (MODE != 1 || (q.x == 0x2545f491u && q.y == 1u)) o[j] = q;
    }
  }
}

constexpr int kSlots = 4;
__global__ void __launch_bounds__(32) tma_ring_kernel(const char* __restrict__ x,
                                                      const int* __restrict__ idx,
                                                      char* __restrict__ out, int v, int rb,
                                                      int64_t n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = blockDim.x, t = threadIdx.x;
  const uint64_t* bars = reinterpret_cast<const uint64_t*>(smem) + t * kSlots;
  unsigned char* zero = smem + (nt * kSlots * 8 + 15) / 16 * 16;
  const unsigned char* ring = zero + rb + (int64_t)t * kSlots * rb;
  for (int i = 16 * t; i < rb; i += 16 * nt) *reinterpret_cast<uint4*>(zero + i) = make_uint4(0, 0, 0, 0);
  for (int p = 0; p < kSlots; ++p)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(sa(bars + p)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * nt, first = (int64_t)blockIdx.x * nt + t;
  auto start = [&](int p, int64_t j) {
    const int64_t e = first + j * stride;
    if (e >= n) return false;
    const int r = idx[e];
    if (r < 0 || r >= v) return false;
    const uint32_t bar = sa(bars + p);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(rb) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
                 ::"r"(sa(ring + p * rb)), "l"(x + (int64_t)r * rb), "r"(rb), "r"(bar) : "memory");
    return true;
  };
  bool loaded[kSlots];
#pragma unroll
  for (int p = 0; p < kSlots; ++p) loaded[p] = start(p, p);
  uint32_t parity = 0;
  for (int64_t j0 = 0;; j0 += kSlots) {
#pragma unroll
    for (int p = 0; p < kSlots; ++p) {
      const int64_t j = j0 + p, e = first + j * stride;
      if (e >= n) {
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        return;
      }
      uint32_t src = sa(zero);
      if (loaded[p]) {
        uint32_t done = 0;
        while (!done)
          asm volatile("{\n\t.reg .pred q;\n\tmbarrier.try_wait.parity.shared::cta.b64 q, [%1], %2;\n\t"
                       "selp.u32 %0, 1, 0, q;\n\t}\n"
                       : "=r"(done) : "r"(sa(bars + p)), "r"((parity >> p) & 1u) : "memory");
        parity ^= 1u << p;
        src = sa(ring + p * rb);
      }
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                   ::"l"(out + e * rb), "r"(src), "r"(rb) : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      if (j > 0) {
        const int q = (p + kSlots - 1) % kSlots;
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        loaded[q] = start(q, j - 1 + kSlots);
      }
    }
  }
}

// a warp per row, 4 rows in flight a warp; B > 1: all warps sweep the table
// in B ranges of rows, a warp holding 32 indices, one a lane
__global__ void __launch_bounds__(256) warp_rows_kernel(const uint4* __restrict__ x,
                                                        const int* __restrict__ idx,
                                                        uint4* __restrict__ out, int v, int nch,
                                                        int64_t n, int buckets) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * 8;
  for (int64_t seg = (int64_t)blockIdx.x * 8 + (threadIdx.x >> 5); seg * 32 < n; seg += warps) {
    const int64_t e = seg * 32 + lane;
    const bool has = e < n;
    const int r = has ? idx[e] : 0;
    const int b = r >= 0 && r < v ? (int)((int64_t)r * buckets / v) : 0;
    for (int bk = 0; bk < buckets; ++bk) {
      unsigned todo = __ballot_sync(0xffffffffu, has && b == bk);
      while (todo) {
        int src[4];
        int64_t dst[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int l = todo ? __ffs(todo) - 1 : -1;
          todo &= todo - 1;
          const int ru = __shfl_sync(0xffffffffu, r, l < 0 ? 0 : l);
          src[u] = l < 0 || ru < 0 || ru >= v ? -1 : ru;
          dst[u] = l < 0 ? -1 : seg * 32 + l;
        }
        for (int c = lane; c < nch; c += 32) {
          uint4 q[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            q[u] = src[u] >= 0 ? __ldg(x + (int64_t)src[u] * nch + c) : make_uint4(0, 0, 0, 0);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (dst[u] >= 0) __stcs(out + dst[u] * nch + c, q[u]);
        }
      }
    }
  }
}
}  // namespace

#define STRIDED(NAME, T, MODE)                                                               \
  extern "C" int NAME(const void* x, void* y, void* t, int rows, int dim, int k, void* s) {   \
    if (dim != 256) return (int)cudaErrorInvalidValue;                                       \
    strided_mask<T, 8, MODE><<<(rows + 7) / 8, 256, 0, (cudaStream_t)s>>>(                   \
        (const T*)x, (T*)y, (uint8_t*)t, rows, k);                                            \
    return (int)cudaGetLastError();                                                           \
  }
STRIDED(strided_f32, float, 0) STRIDED(strided_no_search_f32, float, 1)
STRIDED(strided_no_stores_f32, float, 2) STRIDED(strided_loads_only_f32, float, 3)
STRIDED(strided_bf16, __nv_bfloat16, 0) STRIDED(strided_no_search_bf16, __nv_bfloat16, 1)
STRIDED(strided_no_stores_bf16, __nv_bfloat16, 2) STRIDED(strided_loads_only_bf16, __nv_bfloat16, 3)

#define CP_ASYNC(NAME, MODE)                                                                  \
  extern "C" int NAME(const void* x, const void* idx, void* out, int v, int rb, int n, void* s) { \
    const int nch = rb / 16, smem = 32 * rb;                                                  \
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;                                 \
    cudaFuncSetAttribute(cp_async_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem); \
    cp_async_kernel<MODE><<<(n + 511) / 512, nch >= 128 ? 128 : (nch + 31) / 32 * 32, smem,   \
                            (cudaStream_t)s>>>((const uint4*)x, (const int*)idx, (uint4*)out, v, \
                                               nch, n);                                       \
    return (int)cudaGetLastError();                                                           \
  }
CP_ASYNC(cp_async_gather, 0) CP_ASYNC(cp_async_loads_only_gather, 1)
CP_ASYNC(cp_async_stores_only_gather, 2)

static int warp_rows_launch(const void* x, const void* idx, void* out, int v, int rb, int n,
                            int buckets, void* s) {
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, warp_rows_kernel, 256, 0);
  const long want = ((long)n + 255) / 256;
  const long blocks = want < (long)sms * per ? want : (long)sms * per;
  warp_rows_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)s>>>(
      (const uint4*)x, (const int*)idx, (uint4*)out, v, rb / 16, n, buckets);
  return (int)cudaGetLastError();
}
extern "C" int warp_rows_gather(const void* x, const void* idx, void* out, int v, int rb, int n,
                                void* s) {
  return warp_rows_launch(x, idx, out, v, rb, n, 1, s);
}
extern "C" int row_ranges_gather(const void* x, const void* idx, void* out, int v, int rb, int n,
                                 void* s) {
  const long ranges = ((long)v * rb + (16l << 20) - 1) / (16l << 20);
  return warp_rows_launch(x, idx, out, v, rb, n, ranges < 64 ? (int)ranges : 64, s);
}
extern "C" int tma_ring_gather(const void* x, const void* idx, void* out, int v, int rb, int n,
                               void* s) {
  // a block's slots take 64 KB at most; as many blocks an SM as fit
  int fit = 64 * 1024 / (kSlots * rb), th = fit < 1 ? 1 : fit > 32 ? 32 : fit;
  const int smem = (th * kSlots * 8 + 15) / 16 * 16 + (th * kSlots + 1) * rb;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(tma_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, sm_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  int per = sm_smem / (smem + 1024);
  per = per < 1 ? 1 : per > 32 ? 32 : per;
  const long want = ((long)n + th - 1) / th;
  const long blocks = want < (long)sms * per ? want : (long)sms * per;
  tma_ring_kernel<<<(unsigned)blocks, th, smem, (cudaStream_t)s>>>(
      (const char*)x, (const int*)idx, (char*)out, v, rb, n);
  return (int)cudaGetLastError();
}
'''


def edited(tool: str, name: str, src: str, edits) -> str:
    """`src` with each (old, new) of `edits` applied; raises naming the
    variant `name` of `tool` if an old text is not in the source."""
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{tool}: edit {name!r} no longer applies to the source")
        src = src.replace(old, new)
    return src


def build(tool: str, sources: dict) -> dict:
    """(kernel, variant) -> the loaded library of the source text at that
    key, all built by nvcc at once into the kernels' build directory."""
    from maxk_tpu_torch.ops import _native

    _native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmds, paths = [], {}
    for key, text in sources.items():
        cu = _native.BUILD_DIR / f"{tool}_{key[0]}_{key[1] or 'designs'}.cu"
        cu.write_text(text)
        paths[key] = cu.with_suffix(".so")
        cmds.append([_native._nvcc(), *_native.NVCC_FLAGS, f"-I{_native.CSRC}", "-shared",
                     "-o", str(paths[key]), str(cu)])
    _native._run_all(cmds)
    return {key: ctypes.CDLL(str(path)) for key, path in paths.items()}


def build_variants() -> dict:
    """(kernel, variant) -> the loaded library of that copy of the source."""
    from maxk_tpu_torch.ops import _native

    tool = "ablate_mask_gather"
    sources = {("earlier", ""): EARLIER}
    mask, gather, common = ((_native.CSRC / f).read_text()
                            for f in ("maxk_mask.cu", "gather.cu", "common.cuh"))
    edits = {**MASK_EDITS, **search_edits(common)}
    sources.update({("mask", k): edited(tool, k, mask, e) for k, e in edits.items()})
    sources.update({("gather", k): edited(tool, k, gather, e) for k, e in GATHER_EDITS.items()})
    return build(tool, sources)


def entry(lib, name: str, argtypes):
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def turns(arms: dict, rounds: int, iters: int = 20) -> dict:
    """Per arm [median, min, max] ms of `rounds` runs of `iters` launches
    after one, by CUDA events, the arms in turns, the order reversed each
    run."""
    runs = {name: [] for name in arms}
    names = list(arms)
    for r in range(rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            fn = arms[name]
            fn()
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(iters):
                fn()
            b.record()
            torch.cuda.synchronize()
            runs[name].append(a.elapsed_time(b) / iters)
    return {name: [statistics.median(t), min(t), max(t)] for name, t in runs.items()}


def bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def main(argv=None) -> dict:
    from maxk_tpu_torch.bench.micro import bound
    from maxk_tpu_torch.ops import _native, gather_cuda, topk_cuda

    p = argparse.ArgumentParser()
    p.add_argument("--v", type=int, default=232965)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--k", type=int, default=32)
    p.add_argument("--n", type=int, default=1 << 18)
    p.add_argument("--rounds", type=int, default=5)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ablate_mask_gather: no CUDA device; the kernels run only on the card")
    libs = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"device": torch.cuda.get_device_name(0)}
    for dtype in (torch.float32, torch.bfloat16):
        tag, isz = str(dtype).split(".")[-1], torch.finfo(dtype).bits // 8
        v, d, k = args.v, args.dim, args.k
        x = torch.randn((v, d), generator=gen, device="cuda").to(dtype)
        y = torch.empty_like(x)
        take = torch.empty((v, d), dtype=torch.uint8, device="cuda")
        name = "maxk_mask_f32" if dtype == torch.float32 else "maxk_mask_bf16"
        sig = _native.SIGNATURES[name]
        fns = {var: entry(libs[("mask", var)], name, sig) for var in (*MASK_EDITS, *SEARCH_ARMS)}
        fns.update({f"strided{var}": entry(libs[("earlier", "")], f"strided{var}_{name[10:]}", sig)
                    for var in ("", "_no_search", "_no_stores", "_loads_only")})

        def call(fn):
            return lambda: fn(x.data_ptr(), y.data_ptr(), take.data_ptr(), v, d, k,
                              torch.cuda.current_stream().cuda_stream)

        y0, take0 = topk_cuda.maxk_mask_plain(x, k)
        exact = {}
        for var in ("kernel", *SEARCH_ARMS, "strided"):
            call(fns[var])()
            torch.cuda.synchronize()
            exact[var] = torch.equal(bits(y), bits(y0)) and torch.equal(take, take0)
        arms = {var: call(fn) for var, fn in fns.items()}
        arms["torch_topk"] = lambda: torch.topk(x, k)
        out[f"maxk_mask_{tag}"] = {"exact": exact, **bound(v * d * (2 * isz + 1)),
                                   **turns(arms, args.rounds)}
        del x, y, take, y0, take0

        n = args.n
        x = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
        idx = torch.randint(0, n, (n,), generator=gen, device="cuda", dtype=torch.int32)
        o = torch.empty_like(x)
        sig = _native.SIGNATURES["dma_gather"]
        fns = {var: entry(libs[("gather", var)], "dma_gather", sig) for var in GATHER_EDITS}
        fns.update({var: entry(libs[("earlier", "")], f"{var}_gather", sig)
                    for var in ("cp_async", "cp_async_loads_only", "cp_async_stores_only",
                                "tma_ring", "warp_rows", "row_ranges")})

        def gcall(fn):
            return lambda: fn(x.data_ptr(), idx.data_ptr(), o.data_ptr(), n, d * isz, n,
                              torch.cuda.current_stream().cuda_stream)

        ref = gather_cuda.gather_rows_plain(x, idx)
        exact = {}
        for var in ("kernel", "cp_async", "tma_ring", "warp_rows", "row_ranges"):
            o.zero_()
            gcall(fns[var])()
            torch.cuda.synchronize()
            exact[var] = torch.equal(bits(o), bits(ref))
        arms = {var: gcall(fn) for var, fn in fns.items()}
        arms["index_select"] = lambda: torch.index_select(x, 0, idx)
        nbytes = n * 4 + (int(idx.unique().numel()) + n) * d * isz
        out[f"dma_gather_{tag}"] = {"exact": exact, **bound(nbytes), **turns(arms, args.rounds)}
        del x, idx, o, ref
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
