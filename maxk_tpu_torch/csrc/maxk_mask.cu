// MaxK mask: y = x ⊙ take, with take the exact top-k of each row.
//
// Replaces the Pallas `_mask_kernel` (maxk_tpu/ops/topk_pallas.py:99, with
// the shared `_take_mask` at :39-76). Same result bit for bit, a dropped
// entry being +0.0 whatever the sign of x:
//   * order-preserving key: bits | 0x80000000 for x >= +0, ~bits for x < 0
//     (so -0.0 ranks below +0.0); bf16 is upcast to f32 first;
//   * threshold = the k-th largest key, found by a 32-step binary search
//     from the top bit (largest t with #{key >= t} >= k);
//   * ties: every key above the threshold is kept, then the lowest columns
//     among keys equal to it, until exactly k are kept.
//
// Bound on the H100: device memory. Each row is read once and y and take
// are written once, O(V·D) bytes; the 32 counting passes run on registers.
// Design: one warp per row, D/32 keys per lane held in registers (lane
// `l` owns columns i*32+l, so every load and store is one contiguous
// 32-element span per warp). Each search step is NPL compares per lane and
// one `__reduce_add_sync`. The tie rank is an exclusive prefix count in
// column order: a running warp total plus `__popc` of the ballot below the
// lane. No shared memory, no atomics; the −inf row padding and VMEM block
// budgets of the TPU kernel have no counterpart here.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t to_key(float v) {
  const uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_key(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

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
  for (int i = 0; i < NPL; ++i) key[i] = to_key(maxk::load_f32(x + base + i * 32));

  uint32_t thr = 0;
#pragma unroll 1
  for (int bit = 31; bit >= 0; --bit) {
    const uint32_t cand = thr | (1u << bit);
    unsigned c = 0;
#pragma unroll
    for (int i = 0; i < NPL; ++i) c += key[i] >= cand;
    if (__reduce_add_sync(kFull, c) >= (unsigned)k) thr = cand;
  }

  unsigned n_gt = 0;
#pragma unroll
  for (int i = 0; i < NPL; ++i) n_gt += key[i] > thr;
  n_gt = __reduce_add_sync(kFull, n_gt);
  const unsigned need = (unsigned)k - n_gt;  // >= 1 by the search invariant
  const unsigned below = (1u << lane) - 1u;
  unsigned eq_before = 0;  // equal keys in earlier columns (warp-uniform)
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const bool eq = key[i] == thr;
    const unsigned ballot = __ballot_sync(kFull, eq);
    const bool t = key[i] > thr || (eq && eq_before + __popc(ballot & below) < need);
    eq_before += __popc(ballot);
    maxk::store_f32(y + base + i * 32, t ? from_key(key[i]) : 0.0f);
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
