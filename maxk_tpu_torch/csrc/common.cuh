// Shared helpers for the maxk_tpu_torch kernels: float32 and bfloat16
// element access through one float-valued interface, the exact row
// top-k selections of the top-k → CBSR kernel (topk_cbsr.cu, columns
// strided over the lanes) and of the MaxK mask (maxk_mask.cu, contiguous
// columns a lane), and the in-row gather shared by the CBSR sample
// (cbsr.cu) and the take-along-rows kernel (gather.cu).
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

// Exact top-k of one row held by one warp, the top-k → CBSR kernel's
// layout: lane `l` holds the keys of columns i*32+l, i < NPL. Returns a
// mask whose bit i says the lane's column i*32+l is taken, exactly k per
// row:
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

// Order-preserving 16-bit key of a bf16's bits `u`: the top half of
// to_key(the f32 it widens to). The low half of that f32 key is 0x0000
// for x >= +0 and 0xffff below, fixed by the sign, so the top half alone
// orders bf16 values exactly as the f32 key does.
__device__ __forceinline__ uint32_t to_key16(uint32_t u) {
  return (u & 0x8000u) ? (~u & 0xffffu) : (u | 0x8000u);
}

__device__ __forceinline__ uint32_t exclusive_warp_sum(uint32_t v, int lane) {
  uint32_t incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  return incl - v;
}

// Steps HI..LO of the binary search for the row's k-th largest key (the
// largest t with #{key >= t} >= k), from the bits `thr` already fixed:
// NPL compares a lane and one `__reduce_add_sync` a step. The bounds are
// constants, so the loop unrolls and every candidate is an immediate.
template <int NPL, int HI, int LO>
__device__ __forceinline__ uint32_t search_bits(const uint32_t (&key)[NPL], uint32_t thr,
                                                unsigned k) {
#pragma unroll
  for (int bit = HI; bit >= LO; --bit) {
    const uint32_t cand = thr | (1u << bit);
    unsigned c = 0;
#pragma unroll
    for (int i = 0; i < NPL; ++i) c += key[i] >= cand;
    if (__reduce_add_sync(kFull, c) >= k) thr = cand;
  }
  return thr;
}

// The take mask of a row whose k-th largest key is `thr`, lane `l`
// holding columns l*NPL + i, i < NPL: every key above `thr`, then the
// lowest columns among keys equal to it until k are taken. A key's rank
// among the equal keys is the equal keys of lower lanes (one exclusive
// warp scan) plus those earlier in its own lane.
template <int NPL>
__device__ __forceinline__ uint32_t take_at(const uint32_t (&key)[NPL], uint32_t thr, unsigned k,
                                            int lane) {
  unsigned n_gt = 0, n_eq = 0;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    n_gt += key[i] > thr;
    n_eq += key[i] == thr;
  }
  const unsigned need = k - __reduce_add_sync(kFull, n_gt);  // >= 1
  unsigned before = exclusive_warp_sum(n_eq, lane);
  uint32_t take = 0;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const bool eq = key[i] == thr;
    take |= (uint32_t)(key[i] > thr || (eq && before < need)) << i;
    before += eq;
  }
  return take;
}

// Exact top-k of one row of 16-bit keys (to_key16) held by one warp, lane
// `l` holding columns l*NPL + i: a 16-step search, then the tie pass.
template <int NPL>
__device__ __forceinline__ uint32_t row_topk_mask16(const uint32_t (&key)[NPL], int k, int lane) {
  return take_at<NPL>(key, search_bits<NPL, 15, 0>(key, 0u, (unsigned)k), (unsigned)k, lane);
}

// Exact top-k of one row of 32-bit keys (to_key) held by one warp, lane
// `l` holding columns l*NPL + i. Two levels of 16 bits:
//   1. 16 search steps on the keys' top halves find the threshold's top
//      half h (comparing a whole key with a candidate whose low half is
//      0 compares the top halves);
//   2. with n_above keys whose top half exceeds h, the threshold's low
//      half is the (k - n_above)-th largest low half among the keys whose
//      top half is h. When at most 32 keys share h (one or a few at
//      normal data), they are compacted one a lane through `scratch` in
//      column order and searched with one compare and one ballot a step;
//      otherwise (many equal values) the search goes on over every key,
//      as steps 15..0 of a 32-step search. The branch is warp-uniform.
// `scratch` is 32 entries the warp owns.
template <int NPL>
__device__ __forceinline__ uint32_t row_topk_mask32(const uint32_t (&key)[NPL], int k, int lane,
                                                    uint16_t* scratch) {
  const uint32_t h = search_bits<NPL, 31, 16>(key, 0u, (unsigned)k) >> 16;
  unsigned above = 0, same = 0;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    above += (key[i] >> 16) > h;
    same += (key[i] >> 16) == h;
  }
  // both counts in one reduction: each is at most 1024
  const unsigned both = __reduce_add_sync(kFull, (same << 16) | above);
  const unsigned m = both >> 16;
  uint32_t thr = h << 16;
  if (m <= 32) {
    unsigned pos = exclusive_warp_sum(same, lane);
#pragma unroll
    for (int i = 0; i < NPL; ++i)
      if ((key[i] >> 16) == h) scratch[pos++] = (uint16_t)key[i];
    __syncwarp();
    // an empty lane's 0 counts for no candidate: every candidate is >= 1
    const uint32_t lo = (unsigned)lane < m ? scratch[lane] : 0u;
    __syncwarp();
    const unsigned need = (unsigned)k - (both & 0xffffu);
    uint32_t t = 0;
#pragma unroll
    for (int bit = 15; bit >= 0; --bit) {
      const uint32_t cand = t | (1u << bit);
      if ((unsigned)__popc(__ballot_sync(kFull, lo >= cand)) >= need) t = cand;
    }
    thr |= t;
  } else {
    thr = search_bits<NPL, 15, 0>(key, thr, (unsigned)k);
  }
  return take_at<NPL>(key, thr, (unsigned)k, lane);
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
