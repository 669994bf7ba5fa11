// MaxK mask: y = x ⊙ take, with take the exact top-k of each row.
//
// Replaces the Pallas `_mask_kernel` (maxk_tpu/ops/topk_pallas.py:99, with
// the shared `_take_mask` at :39-76). Same result bit for bit, a dropped
// entry being +0.0 whatever the sign of x. The key, the threshold search
// and the tie rule are `maxk::row_topk_mask` (common.cuh), shared with the
// top-k → CBSR kernel; bf16 is upcast to f32 first.
//
// Bound on the H100: device memory. Each row is read once and y and take
// are written once, O(V·D) bytes; the 32 counting passes run on registers.
// Design: one warp per row, D/32 keys per lane held in registers (lane
// `l` owns columns i*32+l, so every load and store is one contiguous
// 32-element span per warp). No shared memory, no atomics; the −inf row
// padding and VMEM block budgets of the TPU kernel have no counterpart
// here.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename T, int NPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
maxk_mask_kernel(const T* __restrict__ x, T* __restrict__ y,
                 uint8_t* __restrict__ take, int rows, int k) {
  constexpr int D = NPL * 32;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // warp-uniform: a warp owns one row
  const int64_t base = row * D + lane;

  uint32_t key[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) key[i] = maxk::to_key(maxk::load_f32(x + base + i * 32));

  const uint32_t mask = maxk::row_topk_mask<NPL>(key, k, lane);
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const bool t = (mask >> i) & 1u;
    maxk::store_f32(y + base + i * 32, t ? maxk::from_key(key[i]) : 0.0f);
    take[base + i * 32] = t;
  }
}

template <typename T>
int launch(const void* x, void* y, void* take, int rows, int dim, int k,
           cudaStream_t stream) {
  if (rows <= 0 || dim % 32 != 0 || dim < 32 || dim > 1024 || k < 1 || k > dim)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  uint8_t* tp = static_cast<uint8_t*>(take);
  switch (dim / 32) {
#define MAXK_CASE(N)                                                         \
  case N:                                                                    \
    maxk_mask_kernel<T, N><<<grid, block, 0, stream>>>(xp, yp, tp, rows, k); \
    break;
    MAXK_CASE(1) MAXK_CASE(2) MAXK_CASE(3) MAXK_CASE(4) MAXK_CASE(5)
    MAXK_CASE(6) MAXK_CASE(7) MAXK_CASE(8) MAXK_CASE(9) MAXK_CASE(10)
    MAXK_CASE(11) MAXK_CASE(12) MAXK_CASE(13) MAXK_CASE(14) MAXK_CASE(15)
    MAXK_CASE(16) MAXK_CASE(17) MAXK_CASE(18) MAXK_CASE(19) MAXK_CASE(20)
    MAXK_CASE(21) MAXK_CASE(22) MAXK_CASE(23) MAXK_CASE(24) MAXK_CASE(25)
    MAXK_CASE(26) MAXK_CASE(27) MAXK_CASE(28) MAXK_CASE(29) MAXK_CASE(30)
    MAXK_CASE(31) MAXK_CASE(32)
#undef MAXK_CASE
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (ctypes). Returns the cudaError_t of the launch.
extern "C" int maxk_mask_f32(const void* x, void* y, void* take, int rows,
                             int dim, int k, void* stream) {
  return launch<float>(x, y, take, rows, dim, k, static_cast<cudaStream_t>(stream));
}

extern "C" int maxk_mask_bf16(const void* x, void* y, void* take, int rows,
                              int dim, int k, void* stream) {
  return launch<__nv_bfloat16>(x, y, take, rows, dim, k,
                               static_cast<cudaStream_t>(stream));
}
