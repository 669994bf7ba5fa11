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
// densify design: a block takes a few rows, stages their selectors and
// values (as f32) in shared memory, and each thread owns output columns,
// summing the row's matching values in l order. Every output element has
// one writer, so duplicate selectors need no atomics and the sum is
// deterministic; shared-memory reads are broadcasts (all threads read the
// same slot). The sum is taken in f32 and rounded once: the TPU kernel
// rounds after every add in the output dtype, so with bf16 and duplicate
// selectors the two may differ by one bf16 ulp.
// sample design: one thread per (r, l); a bounds check on the selector.
#include "common.cuh"

namespace {

constexpr int kDensifyMaxRows = 8;
constexpr int kSmemBytes = 48 * 1024;

template <typename T>
__global__ void densify_kernel(const T* __restrict__ vals,
                               const int* __restrict__ sel, T* __restrict__ out,
                               int rows, int k, int dim, int rows_per_block) {
  extern __shared__ unsigned char smem[];
  float* s_val = reinterpret_cast<float*>(smem);
  int* s_sel = reinterpret_cast<int*>(s_val + rows_per_block * k);
  const int64_t row0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t left = rows - row0;
  const int nr = left < rows_per_block ? (int)left : rows_per_block;
  for (int i = threadIdx.x; i < nr * k; i += blockDim.x) {
    s_val[i] = maxk::load_f32(vals + row0 * k + i);
    s_sel[i] = sel[row0 * k + i];
  }
  __syncthreads();
  for (int r = 0; r < nr; ++r) {
    const float* v = s_val + r * k;
    const int* s = s_sel + r * k;
    T* o = out + (row0 + r) * dim;
    for (int c = threadIdx.x; c < dim; c += blockDim.x) {
      float acc = 0.0f;
      for (int l = 0; l < k; ++l)
        if (s[l] == c) acc += v[l];
      maxk::store_f32(o + c, acc);
    }
  }
}

template <typename T>
__global__ void sample_kernel(const T* __restrict__ z, const int* __restrict__ sel,
                              T* __restrict__ out, int64_t n, int k, int dim) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int c = sel[i];
    if (c >= 0 && c < dim)
      out[i] = z[(i / k) * dim + c];
    else
      maxk::store_f32(out + i, 0.0f);
  }
}

template <typename T>
int launch_densify(const void* vals, const void* sel, void* out, int rows, int k,
                   int dim, cudaStream_t stream) {
  if (rows <= 0 || k < 1 || dim < 1) return (int)cudaErrorInvalidValue;
  const int per_row = k * (int)(sizeof(float) + sizeof(int));
  const int fit = kSmemBytes / per_row;
  const int rpb = fit < kDensifyMaxRows ? fit : kDensifyMaxRows;
  if (rpb < 1) return (int)cudaErrorInvalidValue;
  const int threads = dim >= 256 ? 256 : (dim + 31) / 32 * 32;
  const dim3 grid((rows + rpb - 1) / rpb);
  densify_kernel<T><<<grid, threads, rpb * per_row, stream>>>(
      static_cast<const T*>(vals), static_cast<const int*>(sel),
      static_cast<T*>(out), rows, k, dim, rpb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sample(const void* z, const void* sel, void* out, int rows, int k,
                  int dim, cudaStream_t stream) {
  if (rows <= 0 || k < 1 || dim < 1) return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)rows * k;
  const int threads = 256;
  const int64_t want = (n + threads - 1) / threads;
  const int64_t blocks = want < ((int64_t)1 << 20) ? want : ((int64_t)1 << 20);
  sample_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(z), static_cast<const int*>(sel),
      static_cast<T*>(out), n, k, dim);
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
  return launch_sample<float>(z, sel, out, rows, k, dim,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int cbsr_sample_bf16(const void* z, const void* sel, void* out,
                                int rows, int k, int dim, void* stream) {
  return launch_sample<__nv_bfloat16>(z, sel, out, rows, k, dim,
                                      static_cast<cudaStream_t>(stream));
}
