// Shared helpers for the maxk_tpu_torch kernels: float32 and bfloat16
// element access through one float-valued interface, the exact row
// top-k selection shared by the MaxK mask (maxk_mask.cu) and the top-k →
// CBSR kernel (topk_cbsr.cu), and the in-row gather shared by the CBSR
// sample (cbsr.cu) and the take-along-rows kernel (gather.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace maxk {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Order-preserving key of an f32: bits | 0x80000000 for x >= +0, ~bits for
// x < 0, so -0.0 ranks below +0.0 (the TPU kernels' `_take_mask`,
// maxk_tpu/ops/topk_pallas.py:39-76).
__device__ __forceinline__ uint32_t to_key(float v) {
  const uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_key(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// Exact top-k of one row held by one warp: lane `l` holds the keys of
// columns i*32+l, i < NPL. Returns a mask whose bit i says the lane's
// column i*32+l is taken, exactly k per row:
//   * threshold = the k-th largest key, by a 32-step binary search from
//     the top bit (largest t with #{key >= t} >= k), one
//     `__reduce_add_sync` per step;
//   * every key above the threshold is taken, then the lowest columns
//     among keys equal to it until k are taken; the rank among equal keys
//     is an exclusive prefix count in column order (a running warp total
//     plus `__popc` of the ballot below the lane).
// Every lane of the warp must call it (warp-synchronous).
template <int NPL>
__device__ __forceinline__ uint32_t row_topk_mask(const uint32_t (&key)[NPL], int k,
                                                  int lane) {
  static_assert(NPL >= 1 && NPL <= 32, "one mask bit per key");
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
  uint32_t take = 0;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const bool eq = key[i] == thr;
    const unsigned ballot = __ballot_sync(kFull, eq);
    const bool t = key[i] > thr || (eq && eq_before + __popc(ballot & below) < need);
    eq_before += __popc(ballot);
    take |= (uint32_t)t << i;
  }
  return take;
}

// Element i of an in-row gather over (rows, k) slots:
// out[i] = z[i / k, sel[i]] for a selector in [0, dim), and 0 otherwise; a
// selector outside the row is never used as an address.
template <typename T>
__device__ __forceinline__ void gather_in_row(const T* __restrict__ z,
                                              const int* __restrict__ sel,
                                              T* __restrict__ out, int64_t i, int k,
                                              int dim) {
  const int c = sel[i];
  if (c >= 0 && c < dim)
    out[i] = z[(i / k) * dim + c];
  else
    store_f32(out + i, 0.0f);
}

}  // namespace maxk
