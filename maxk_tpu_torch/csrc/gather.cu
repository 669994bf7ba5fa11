// Row gathers: the three microbenchmark kernels of the benchmark entry
// points.
//
// slab gather replaces the Pallas `kernel` of `bench_pallas_vmem_gather`
// (maxk_tpu/bench/micro.py:142):       out[e] = slab[idx[e]], slab on chip
// dma gather replaces the Pallas `kernel` of `bench_pallas_dma_gather`
// (micro.py:204):                      out[e] = x[idx[e]], from device memory
// take-along-rows replaces the Pallas `gk` (maxk_tpu/bench/probe_topk.py:96):
//                                      out[r, j] = x[r, idx[r, j]]
// An index outside the table (or the row) yields a zero row (element) and is
// never used as an address.
//
// Bound on the H100: device memory, all three. Each writes its output once
// and reads its indices and the gathered rows once.
//
// slab design: the TPU core holds the whole (S, D) slab in VMEM. Its
// counterpart here is the 50 MB L2, not a block's 227 KB of shared memory
// (the slab is 2-16 MiB); nor is a thread-block cluster's distributed
// shared memory, whose 16 × 227 KB holds S = 2048 f32 rows of 256 but not
// 8192. So the slab stays in L2 and every row moves whole: a group of
// lanes (a warp for a row of 32 or more 16-byte vectors) serves one index,
// 4 indices in flight, each lane moving 16-byte vectors. The slab is read
// with an L2 evict-last policy (`createpolicy` + `ld.global.nc.L2::
// cache_hint`) and the output, 1 GiB for 2^20 rows of 1 KB, is stored with
// the streaming hint (`st.global.cs`), so it streams past the slab rather
// than evicting it. Neither sets a persisting-L2 limit nor an access-policy
// window: no device state outlives the launch. Rows that are not 16-byte
// multiples move element by element. The slab must fit L2 (the launch reads
// its size from the device and refuses a larger slab).
// dma design: a thread per 16-byte chunk of the output, kDmaUnroll chunks
// a thread spaced by the block (all their loads, then their stores), a
// grid over every chunk: out chunk g is x[idx[g / nch]] chunk g % nch, so
// a warp moves 512 contiguous bytes of a row per instruction and the card
// keeps many small independent reads in flight. Stores stream
// (`st.global.cs`). The TPU kernel's `make_async_copy` of a whole row
// would be a TMA bulk copy here; a ring of TMA row copies (loads and
// stores by `cp.async.bulk` through shared memory), the `cp.async` ring it
// replaces, a warp per row with rows in flight on a persistent grid, and a
// sweep of the table in row ranges so that repeated rows hit L2 were all
// measured slower than this at micro's shape (bench/ablate_mask_gather.py,
// PERF.md).
// take-along-rows design: one thread per (r, j), the selector-guarded gather
// of the CBSR sample (`maxk::gather_in_row`).
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kSlabThreads = 256;
constexpr int kSlabUnroll = 4;  // indices in flight per lane group
constexpr int kDmaThreads = 256;
constexpr int kDmaUnroll = 4;  // chunks a thread

__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// read through the non-coherent path, kept in L2; store streaming
__device__ __forceinline__ uint4 load_keep(const uint4* p, uint64_t policy) {
  uint4 v;
  asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p), "l"(policy));
  return v;
}
__device__ __forceinline__ unsigned load_keep(const unsigned* p, uint64_t policy) {
  unsigned v;
  asm("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;\n" : "=r"(v) : "l"(p), "l"(policy));
  return v;
}
__device__ __forceinline__ unsigned short load_keep(const unsigned short* p, uint64_t policy) {
  unsigned short v;
  asm("ld.global.nc.L2::cache_hint.u16 %0, [%1], %2;\n" : "=h"(v) : "l"(p), "l"(policy));
  return v;
}
__device__ __forceinline__ void store_stream(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ void store_stream(unsigned* p, unsigned v) {
  asm volatile("st.global.cs.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ void store_stream(unsigned short* p, unsigned short v) {
  asm volatile("st.global.cs.u16 [%0], %1;\n" ::"l"(p), "h"(v) : "memory");
}

// U: the unit a lane moves, a 16-byte vector or one element's bits; a row
// is `units` units, served by a group of `lanes` lanes (a power of two <= 32)
template <typename U>
__global__ void __launch_bounds__(kSlabThreads)
    slab_gather_kernel(const U* __restrict__ slab, const int* __restrict__ idx,
                       U* __restrict__ out, int s, int units, int lanes, int64_t n) {
  const uint64_t policy = l2_evict_last();
  const int64_t gt = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t groups = (int64_t)gridDim.x * blockDim.x / lanes;
  const int j = (int)(gt % lanes);
  for (int64_t e0 = gt / lanes; e0 < n; e0 += groups * kSlabUnroll) {
    int r[kSlabUnroll];
#pragma unroll
    for (int u = 0; u < kSlabUnroll; ++u) {
      const int64_t e = e0 + u * groups;
      r[u] = e < n ? idx[e] : -1;
    }
    for (int c = j; c < units; c += lanes) {
      U v[kSlabUnroll];
#pragma unroll
      for (int u = 0; u < kSlabUnroll; ++u)
        v[u] = r[u] >= 0 && r[u] < s ? load_keep(slab + (int64_t)r[u] * units + c, policy) : U{};
#pragma unroll
      for (int u = 0; u < kSlabUnroll; ++u) {
        const int64_t e = e0 + u * groups;
        if (e < n) store_stream(out + e * units + c, v[u]);
      }
    }
  }
}

// x and out as rows of `nch` 16-byte chunks, `total` chunks of output
__global__ void __launch_bounds__(kDmaThreads)
    dma_gather_kernel(const uint4* __restrict__ x, const int* __restrict__ idx,
                      uint4* __restrict__ out, int v, int nch, int64_t total) {
  const int64_t g0 = (int64_t)blockIdx.x * kDmaThreads * kDmaUnroll + threadIdx.x;
  uint4 q[kDmaUnroll];
#pragma unroll
  for (int u = 0; u < kDmaUnroll; ++u) {
    const int64_t g = g0 + u * kDmaThreads;
    q[u] = make_uint4(0, 0, 0, 0);
    if (g < total) {
      const int64_t e = g / nch;
      const int r = idx[e];
      if (r >= 0 && r < v) q[u] = __ldg(x + (int64_t)r * nch + (g - e * nch));
    }
  }
#pragma unroll
  for (int u = 0; u < kDmaUnroll; ++u) {
    const int64_t g = g0 + u * kDmaThreads;
    if (g < total) store_stream(out + g, q[u]);
  }
}

template <typename T>
__global__ void take_rows_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                                 T* __restrict__ out, int64_t n, int k, int dim) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    maxk::gather_in_row(x, idx, out, i, k, dim);
}

template <typename U>
int launch_slab_units(const void* slab, const void* idx, void* out, int s, int units, int n,
                      cudaStream_t stream) {
  int lanes = 1;
  while (lanes < 32 && lanes < units) lanes *= 2;
  const int sms = maxk::device_attribute<cudaDevAttrMultiProcessorCount>();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  // a lane group per index, up to eight blocks an SM
  const int64_t want = ((int64_t)n * lanes + kSlabThreads - 1) / kSlabThreads;
  const int64_t blocks = want < 8 * sms ? want : 8 * sms;
  slab_gather_kernel<U><<<(unsigned)blocks, kSlabThreads, 0, stream>>>(
      static_cast<const U*>(slab), static_cast<const int*>(idx), static_cast<U*>(out), s, units,
      lanes, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_slab_gather(const void* slab, const void* idx, void* out, int s, int d, int n,
                       cudaStream_t stream) {
  if (s < 1 || d < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const int64_t row = (int64_t)d * sizeof(T);
  const int l2 = maxk::device_attribute<cudaDevAttrL2CacheSize>();
  if (l2 < 1) return (int)cudaErrorInvalidDevice;
  if (s * row > l2) return (int)cudaErrorInvalidValue;
  const bool vec = row % 16 == 0 && reinterpret_cast<uintptr_t>(slab) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) return launch_slab_units<uint4>(slab, idx, out, s, (int)(row / 16), n, stream);
  using Bits = typename std::conditional<sizeof(T) == 4, unsigned, unsigned short>::type;
  return launch_slab_units<Bits>(slab, idx, out, s, d, n, stream);
}

template <typename T>
int launch_take_rows(const void* x, const void* idx, void* out, int rows, int k, int dim,
                     cudaStream_t stream) {
  if (rows <= 0 || k < 1 || dim < 1) return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)rows * k;
  const int threads = 256;
  const int64_t want = (n + threads - 1) / threads;
  const int64_t blocks = want < ((int64_t)1 << 20) ? want : ((int64_t)1 << 20);
  take_rows_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(idx), static_cast<T*>(out), n, k, dim);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (ctypes). Each returns the cudaError_t of the launch.
extern "C" int slab_gather_f32(const void* slab, const void* idx, void* out, int s, int d,
                               int n, void* stream) {
  return launch_slab_gather<float>(slab, idx, out, s, d, n, static_cast<cudaStream_t>(stream));
}

extern "C" int slab_gather_bf16(const void* slab, const void* idx, void* out, int s, int d,
                                int n, void* stream) {
  return launch_slab_gather<__nv_bfloat16>(slab, idx, out, s, d, n,
                                           static_cast<cudaStream_t>(stream));
}

// The card's L2 size in bytes (cudaDevAttrL2CacheSize of the current device).
extern "C" int l2_cache_bytes(int* bytes) {
  *bytes = maxk::device_attribute<cudaDevAttrL2CacheSize>();
  return *bytes > 0 ? (int)cudaSuccess : (int)cudaErrorInvalidDevice;
}

// Rows of any dtype, `row_bytes` a multiple of 16 and both pointers 16-byte
// aligned (the wrapper checks).
extern "C" int dma_gather(const void* x, const void* idx, void* out, int v, int row_bytes,
                          int n, void* stream) {
  if (v < 1 || n < 1 || row_bytes < 16 || row_bytes % 16) return (int)cudaErrorInvalidValue;
  const int nch = row_bytes / 16;
  const int64_t total = (int64_t)n * nch;
  const int64_t per_block = (int64_t)kDmaThreads * kDmaUnroll;
  const int64_t blocks = (total + per_block - 1) / per_block;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  dma_gather_kernel<<<(unsigned)blocks, kDmaThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<const int*>(idx), static_cast<uint4*>(out), v, nch,
      total);
  return (int)cudaGetLastError();
}

extern "C" int take_rows_f32(const void* x, const void* idx, void* out, int rows, int k,
                             int dim, void* stream) {
  return launch_take_rows<float>(x, idx, out, rows, k, dim, static_cast<cudaStream_t>(stream));
}

extern "C" int take_rows_bf16(const void* x, const void* idx, void* out, int rows, int k,
                              int dim, void* stream) {
  return launch_take_rows<__nv_bfloat16>(x, idx, out, rows, k, dim,
                                         static_cast<cudaStream_t>(stream));
}
