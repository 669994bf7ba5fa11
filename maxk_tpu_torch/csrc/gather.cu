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
// and reads its indices and the gathered rows once (the slab gather reads
// its small slab once per block; it stays in L2).
//
// slab design: a TPU core holds the whole (S, D) slab in VMEM; a block here
// has at most 227 KB of shared memory, and the slab is 2 MiB (S = 2048, f32)
// or more. So a block stages one column slice, slab[:, c0:c0+DC], with DC
// the widest power of two that divides D and keeps S·DC·itemsize within
// kSlabSmemBytes, and serves a run of indices for that slice; the slices
// of one run are neighbours in the grid, so the partial rows they write
// meet in L2. The later design holds the whole slab in the distributed
// shared memory of a thread-block cluster and serves whole rows.
// dma design (the structure of micro.py:204-225): a block takes 512
// indices and a shared ring of 2·16 rows; every thread owns the same
// 16-byte chunks of every row, keeps 16 rows of `cp.async` copies in
// flight (one commit group per row), and for each row e waits for its
// group, starts row e+16 and stores its chunks of row e. A thread reads
// back only what it copied itself, so no barrier is needed.
// take-along-rows design: one thread per (r, j), the selector-guarded gather
// of the CBSR sample (`maxk::gather_in_row`).
#include "common.cuh"

namespace {

constexpr int kSlabThreads = 1024;
constexpr int kSlabSmemBytes = 200 * 1024;
constexpr int kDmaSlots = 16;  // rows of copies in flight
constexpr int kDmaRing = 2 * kDmaSlots;
constexpr int kDmaRowsPerBlock = 512;
constexpr int kMaxSmemBytes = 227 * 1024;

template <typename T>
__global__ void __launch_bounds__(kSlabThreads)
    slab_gather_kernel(const T* __restrict__ slab, const int* __restrict__ idx,
                       T* __restrict__ out, int s, int d, int dc, int64_t n,
                       int64_t per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* part = reinterpret_cast<T*>(smem);
  const int c0 = blockIdx.x * dc;
  for (int i = threadIdx.x; i < s * dc; i += blockDim.x) {
    const int r = i / dc;
    part[i] = slab[(int64_t)r * d + c0 + (i - r * dc)];
  }
  __syncthreads();
  // dc and blockDim are powers of two, dc <= blockDim: a thread keeps its
  // column and steps over the run's indices
  const int c = threadIdx.x & (dc - 1);
  const int step = blockDim.x / dc;
  const int64_t e0 = (int64_t)blockIdx.y * per_block;
  const int64_t e1 = e0 + per_block < n ? e0 + per_block : n;
  for (int64_t e = e0 + threadIdx.x / dc; e < e1; e += step) {
    const int r = idx[e];
    T* o = out + e * d + c0 + c;
    if (r >= 0 && r < s)
      *o = part[r * dc + c];
    else
      maxk::store_f32(o, 0.0f);
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

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return sms;
}

template <typename T>
int launch_slab_gather(const void* slab, const void* idx, void* out, int s, int d, int n,
                       cudaStream_t stream) {
  const int64_t row = (int64_t)s * sizeof(T);
  if (s < 1 || d < 1 || n < 1 || row > kSlabSmemBytes) return (int)cudaErrorInvalidValue;
  int dc = 1;
  while (dc < kSlabThreads && d % (2 * dc) == 0 && 2 * dc * row <= kSlabSmemBytes) dc *= 2;
  const int sms = sm_count();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  // about four blocks an SM: runs of indices × column slices
  const int slices = d / dc;
  const int64_t runs_wanted = (4 * sms + slices - 1) / slices;
  const int64_t per_block = (n + runs_wanted - 1) / runs_wanted;
  const int64_t runs = (n + per_block - 1) / per_block;
  const int smem = (int)(dc * row);
  cudaError_t err = cudaFuncSetAttribute(
      slab_gather_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  slab_gather_kernel<T><<<dim3(slices, (unsigned)runs), kSlabThreads, smem, stream>>>(
      static_cast<const T*>(slab), static_cast<const int*>(idx), static_cast<T*>(out), s, d,
      dc, n, per_block);
  return (int)cudaGetLastError();
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
