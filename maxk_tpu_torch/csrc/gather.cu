// Row gathers: the three microbenchmark kernels of the benchmark entry
// points.
//
// slab gather replaces the Pallas `kernel` of `bench_pallas_vmem_gather`
// (maxk_tpu/bench/micro.py:142):       out[e] = slab[idx[e]], slab on chip
// dma gather replaces the Pallas `kernel` of `bench_pallas_dma_gather`
// (micro.py:204):                      out[e] = x[idx[e]], 16 copies in flight
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
// dma design (the structure of micro.py:204-225): a block takes 512
// indices and a shared ring of 2·16 rows; every thread owns the same
// 16-byte chunks of every row, keeps 16 rows of `cp.async` copies in
// flight (one commit group per row), and for each row e waits for its
// group, starts row e+16 and stores its chunks of row e. A thread reads
// back only what it copied itself, so no barrier is needed.
// take-along-rows design: one thread per (r, j), the selector-guarded gather
// of the CBSR sample (`maxk::gather_in_row`).
#include <atomic>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kSlabThreads = 256;
constexpr int kSlabUnroll = 4;  // indices in flight per lane group
constexpr int kDmaSlots = 16;   // rows of copies in flight
constexpr int kDmaRing = 2 * kDmaSlots;
constexpr int kDmaRowsPerBlock = 512;
constexpr int kMaxSmemBytes = 227 * 1024;

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src_bytes = 0 reads nothing and fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x and out as rows of `nch` 16-byte chunks
__global__ void dma_gather_kernel(const uint4* __restrict__ x, const int* __restrict__ idx,
                                  uint4* __restrict__ out, int v, int nch, int64_t n) {
  extern __shared__ uint4 ring[];
  const int64_t e0 = (int64_t)blockIdx.x * kDmaRowsPerBlock;
  const int rows = n - e0 < kDmaRowsPerBlock ? (int)(n - e0) : kDmaRowsPerBlock;
  // one commit group per row, empty past the block's last row, so that
  // group e is complete once at most kDmaSlots - 1 groups are pending
  auto start = [&](int e) {
    if (e < rows) {
      const int r = idx[e0 + e];
      const bool ok = r >= 0 && r < v;
      const uint4* src = x + (ok ? (int64_t)r * nch : 0);
      uint4* dst = ring + (e % kDmaRing) * nch;
      for (int j = threadIdx.x; j < nch; j += blockDim.x) cp_async16(dst + j, src + j, ok ? 16 : 0);
    }
    cp_async_commit();
  };
  for (int e = 0; e < kDmaSlots; ++e) start(e);
  for (int e = 0; e < rows; ++e) {
    cp_async_wait<kDmaSlots - 1>();
    start(e + kDmaSlots);
    const uint4* buf = ring + (e % kDmaRing) * nch;
    uint4* o = out + (e0 + e) * nch;
    for (int j = threadIdx.x; j < nch; j += blockDim.x) o[j] = buf[j];
  }
}

template <typename T>
__global__ void take_rows_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                                 T* __restrict__ out, int64_t n, int k, int dim) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    maxk::gather_in_row(x, idx, out, i, k, dim);
}

// An attribute of the current device, 0 on error. Asked once per device and
// kept: it does not change, and a launch should not pay a query for it.
template <cudaDeviceAttr kAttr>
int device_attribute() {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> kept[kMaxDevices];  // zero-initialized
  int dev = 0, value = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices && (value = kept[dev].load(std::memory_order_relaxed)) > 0) return value;
  if (cudaDeviceGetAttribute(&value, kAttr, dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices) kept[dev].store(value, std::memory_order_relaxed);
  return value;
}

template <typename U>
int launch_slab_units(const void* slab, const void* idx, void* out, int s, int units, int n,
                      cudaStream_t stream) {
  int lanes = 1;
  while (lanes < 32 && lanes < units) lanes *= 2;
  const int sms = device_attribute<cudaDevAttrMultiProcessorCount>();
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
  const int l2 = device_attribute<cudaDevAttrL2CacheSize>();
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
  *bytes = device_attribute<cudaDevAttrL2CacheSize>();
  return *bytes > 0 ? (int)cudaSuccess : (int)cudaErrorInvalidDevice;
}

// Rows of any dtype, `row_bytes` a multiple of 16 and both pointers 16-byte
// aligned (the wrapper checks).
extern "C" int dma_gather(const void* x, const void* idx, void* out, int v, int row_bytes,
                          int n, void* stream) {
  if (v < 1 || n < 1 || row_bytes < 16 || row_bytes % 16) return (int)cudaErrorInvalidValue;
  const int nch = row_bytes / 16;
  const int smem = kDmaRing * row_bytes;
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(dma_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = nch >= 128 ? 128 : (nch + 31) / 32 * 32;
  const int64_t blocks = ((int64_t)n + kDmaRowsPerBlock - 1) / kDmaRowsPerBlock;
  dma_gather_kernel<<<(unsigned)blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<const int*>(idx), static_cast<uint4*>(out), v,
      nch, n);
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
