// CBSR densify and sample: the forward and backward of maxk_spgemm's
// feature expansion.
//
// densify replaces the Pallas `_densify_kernel`
// (maxk_tpu/ops/cbsr_pallas.py:42):   out[r, sel[r,l]] += vals[r,l]
// sample replaces the Pallas `_sample_kernel` (cbsr_pallas.py:52):
//                                     out[r, l] = z[r, sel[r,l]]
// A selector outside [0, D) adds nothing (densify) or yields 0 (sample),
// and is never used as an address.
//
// Bound on the H100: device memory. densify reads (V,k) values and
// selectors and writes (V,D); sample reads (V,k) selectors, the touched
// part of (V,D) and writes (V,k).
// densify design: one warp per row, 8 warps a block. Each warp owns an f32
// row buffer in shared memory, at most kTileCols columns wide; a wider row
// is walked in column tiles, its selectors once per tile. The warp zeroes
// the buffer, then walks the row's selectors in chunks of 32 slots, in l
// order: lane l loads slot l (coalesced; bf16 widened to f32), a selector
// outside the tile becomes a sentinel, `__match_any_sync` groups the lanes
// that hold one column, and the lowest lane of each group adds the group's
// values, shuffled to it in lane order, to what the buffer holds. A column
// has one writer in a chunk and a `__syncwarp` orders the chunks, so its
// sum is +0.0 + v[l1] + v[l2] + ... in l order, taken in f32 and rounded
// once: no atomics, no k compares per output element, the same bits as a
// sequential sum, and +0.0 for a lone -0.0 value. The warp then writes the
// row once, as 16-byte vectors where the row's bytes and `out` allow it
// (streaming stores measured no faster, and slower in bf16). Each warp's
// row is a chain of latencies (load, group, add, write), so what pays is
// warps in flight: 8 blocks an SM, 32 registers with every loop rolled.
// The TPU kernel rounds after every add in the output dtype, so with bf16
// and duplicate selectors the two may differ by one bf16 ulp.
// sample design: each slot is a selector load, a data load that waits for
// it, and a store. At k = 32 of D = 256 the data loads touch ≈20 of an f32
// row's 32 sectors (≈14 of bf16's 16), and device memory serves them as
// 64-byte granules, so the time is those granules at the card's rate: the
// kernel's reach is its access pattern. A thread takes kSlots slots spaced
// by the block, so that each load instruction of a warp asks for 32
// consecutive slots (one row at k = 32), whose requests to the row's
// shared sectors merge; a thread finds each row by one 32-bit division (64
// bits only past 2^32 slots), not a 64-bit division a slot. f32: one slot
// a thread, loads through the read-only cache; bf16: 4 slots a thread (4
// loads in flight), selectors streamed (`ld.global.cs`) and data loaded
// without L1 allocation (`ld.global.nc.L1::no_allocate`). Each is the
// faster shape in its dtype; 4 slots a thread as one 16-byte selector load
// (a warp instruction then spans 4 rows and asks for their shared sectors
// again), a warp reading its row whole, and the design this replaced (a
// thread a slot, a 64-bit division each) measured slower or no faster
// (bench/ablate_topk_sample.py, PERF.md). Bits move, not values.
#include "common.cuh"

namespace {

constexpr int kDensifyWarps = 8;
// shared-memory budget of a block's row buffers: 1536 f32 columns a warp
constexpr int kDensifySmemBytes = 48 * 1024;
constexpr int kTileCols = kDensifySmemBytes / (kDensifyWarps * (int)sizeof(float));

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

// The n columns of `buf` to `o`. kVec: 16-byte vectors (n and `o` allow
// it: 4 f32 or 8 bf16 columns a vector), otherwise one element a store.
template <typename T, bool kVec>
__device__ __forceinline__ void write_row(T* __restrict__ o, const float* __restrict__ buf,
                                          int n, int lane) {
  const float4* b4 = reinterpret_cast<const float4*>(buf);
  uint4* o4 = reinterpret_cast<uint4*>(o);
  if constexpr (kVec && sizeof(T) == 4) {
#pragma unroll 1
    for (int u = lane; u < n / 4; u += 32) {
      const float4 a = b4[u];
      o4[u] = make_uint4(__float_as_uint(a.x), __float_as_uint(a.y), __float_as_uint(a.z),
                         __float_as_uint(a.w));
    }
  } else if constexpr (kVec) {
#pragma unroll 1
    for (int u = lane; u < n / 8; u += 32) {
      const float4 a = b4[2 * u], b = b4[2 * u + 1];
      o4[u] = make_uint4(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w), pack_bf16x2(b.x, b.y),
                         pack_bf16x2(b.z, b.w));
    }
  } else {
#pragma unroll 1
    for (int c = lane; c < n; c += 32) maxk::store_f32(o + c, buf[c]);
  }
}

// tile: the columns a pass takes (min(dim, kTileCols)); stride: a warp's
// buffer in floats (tile rounded up to a multiple of 4, 16-byte aligned)
template <typename T, bool kVec>
__global__ void __launch_bounds__(kDensifyWarps * 32, 8)
    densify_kernel(const T* __restrict__ vals, const int* __restrict__ sel,
                   T* __restrict__ out, int rows, int k, int dim, int tile, int stride) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kDensifyWarps + (threadIdx.x >> 5);
  if (r >= rows) return;
  float* buf = reinterpret_cast<float*>(smem4) + (threadIdx.x >> 5) * stride;
  const unsigned below = (1u << lane) - 1u;
  const int* s = sel + r * k;
  const T* v = vals + r * k;
#pragma unroll 1
  for (int t0 = 0; t0 < dim; t0 += tile) {
    const int tw = dim - t0 < tile ? dim - t0 : tile;
    const int tw4 = tw & ~3;
#pragma unroll 1
    for (int u = lane; u < tw4 / 4; u += 32)
      reinterpret_cast<float4*>(buf)[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 1
    for (int c = tw4 + lane; c < tw; c += 32) buf[c] = 0.0f;
    __syncwarp();
#pragma unroll 1
    for (int l0 = 0; l0 < k; l0 += 32) {
      const int l = l0 + lane;
      int sc = -1;
      float x = 0.0f;
      if (l < k) {  // both loads at once: the value does not wait for the selector
        sc = s[l];
        x = maxk::load_f32(v + l);
      }
      const int c = sc >= t0 && sc < t0 + tw ? sc - t0 : -1;  // -1: the sentinel
      const unsigned grp = __match_any_sync(maxk::kFull, c);
      const bool lead = c >= 0 && (grp & below) == 0;
      unsigned rest = lead ? grp & (grp - 1u) : 0u;  // the group's later lanes
      float acc = lead ? buf[c] + x : 0.0f;
      const unsigned more = __reduce_max_sync(maxk::kFull, (unsigned)__popc(rest));
#pragma unroll 1
      for (unsigned i = 0; i < more; ++i) {
        const int src = rest ? __ffs(rest) - 1 : lane;
        const float y = __shfl_sync(maxk::kFull, x, src);
        if (rest) {
          acc += y;
          rest &= rest - 1u;
        }
      }
      if (lead) buf[c] = acc;
      __syncwarp();
    }
    write_row<T, kVec>(out + r * dim + t0, buf, tw, lane);
    __syncwarp();  // the next tile zeroes what the write read
  }
}

constexpr int kSampleThreads = 256;

__device__ __forceinline__ uint32_t load_data(const uint32_t* p) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ uint16_t load_data(const uint16_t* p) {
  uint16_t v;
  asm("ld.global.nc.L1::no_allocate.b16 %0, [%1];" : "=h"(v) : "l"(p));
  return v;
}

// U: the element's bits (uint32_t for f32, uint16_t for bf16); SLOTS slots
// a thread, kSampleThreads apart; L1: loads through the read-only cache,
// else streaming selectors and data not allocated in L1
template <typename U, int SLOTS, bool L1>
__global__ void __launch_bounds__(kSampleThreads)
    sample_kernel(const U* __restrict__ z, const int* __restrict__ sel, U* __restrict__ out,
                  int rows, int k, int dim) {
  const int64_t n = (int64_t)rows * k;
  const int64_t i0 = (int64_t)blockIdx.x * (kSampleThreads * SLOTS) + threadIdx.x;
  int c[SLOTS];
  int64_t r[SLOTS];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int64_t i = i0 + j * kSampleThreads;
    c[j] = i < n ? (L1 ? __ldg(sel + i) : __ldcs(sel + i)) : -1;
    r[j] = n <= 0xffffffffll ? (int64_t)((uint32_t)i / (uint32_t)k) : i / k;
  }
  U v[SLOTS];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    v[j] = 0;
    if ((unsigned)c[j] < (unsigned)dim) {  // never an address outside the row
      const U* p = z + r[j] * dim + c[j];
      v[j] = L1 ? __ldg(p) : load_data(p);
    }
  }
#pragma unroll
  for (int j = 0; j < SLOTS; ++j)
    if (i0 + j * kSampleThreads < n) out[i0 + j * kSampleThreads] = v[j];
}

template <typename T>
int launch_densify(const void* vals, const void* sel, void* out, int rows, int k, int dim,
                   cudaStream_t stream) {
  if (rows <= 0 || k < 1 || dim < 1) return (int)cudaErrorInvalidValue;
  const int tile = dim < kTileCols ? dim : kTileCols;
  const int stride = (tile + 3) / 4 * 4;
  const size_t smem = (size_t)kDensifyWarps * stride * sizeof(float);
  // a tile starts at a multiple of kTileCols, 16-byte aligned in both dtypes
  const bool vec = (int64_t)dim * sizeof(T) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const unsigned blocks = (unsigned)(((int64_t)rows + kDensifyWarps - 1) / kDensifyWarps);
  const T* v = static_cast<const T*>(vals);
  const int* s = static_cast<const int*>(sel);
  T* o = static_cast<T*>(out);
  if (vec)
    densify_kernel<T, true><<<blocks, kDensifyWarps * 32, smem, stream>>>(v, s, o, rows, k, dim,
                                                                          tile, stride);
  else
    densify_kernel<T, false><<<blocks, kDensifyWarps * 32, smem, stream>>>(v, s, o, rows, k, dim,
                                                                           tile, stride);
  return (int)cudaGetLastError();
}

template <typename U>
int launch_sample(const void* z, const void* sel, void* out, int rows, int k,
                  int dim, cudaStream_t stream) {
  if (rows <= 0 || k < 1 || dim < 1) return (int)cudaErrorInvalidValue;
  // the faster shape of each dtype (bench/ablate_topk_sample.py)
  constexpr int kSlots = sizeof(U) == 4 ? 1 : 4;
  constexpr bool kL1 = sizeof(U) == 4;
  const int64_t per_block = (int64_t)kSampleThreads * kSlots;
  const int64_t blocks = ((int64_t)rows * k + per_block - 1) / per_block;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  sample_kernel<U, kSlots, kL1><<<(unsigned)blocks, kSampleThreads, 0, stream>>>(
      static_cast<const U*>(z), static_cast<const int*>(sel), static_cast<U*>(out), rows, k, dim);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (ctypes). Each returns the cudaError_t of the launch.
extern "C" int cbsr_densify_f32(const void* vals, const void* sel, void* out,
                                int rows, int k, int dim, void* stream) {
  return launch_densify<float>(vals, sel, out, rows, k, dim,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int cbsr_densify_bf16(const void* vals, const void* sel, void* out,
                                 int rows, int k, int dim, void* stream) {
  return launch_densify<__nv_bfloat16>(vals, sel, out, rows, k, dim,
                                       static_cast<cudaStream_t>(stream));
}

extern "C" int cbsr_sample_f32(const void* z, const void* sel, void* out,
                               int rows, int k, int dim, void* stream) {
  return launch_sample<uint32_t>(z, sel, out, rows, k, dim,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" int cbsr_sample_bf16(const void* z, const void* sel, void* out,
                                int rows, int k, int dim, void* stream) {
  return launch_sample<uint16_t>(z, sel, out, rows, k, dim,
                                 static_cast<cudaStream_t>(stream));
}
