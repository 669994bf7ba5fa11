// Shared helpers for the maxk_tpu_torch kernels: float32 and bfloat16
// element access through one float-valued interface, the exact row top-k
// selections of the MaxK mask (maxk_mask.cu) and the top-k → CBSR kernel
// (topk_cbsr.cu), both with contiguous columns a lane (compare-based and
// bit-sliced searches), and the in-row gather of the take-along-rows
// kernel (gather.cu); a device attribute asked once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace maxk {

constexpr unsigned kFull = 0xffffffffu;

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

// Rows of at most 32·kSlicedMaxNpl keys take the bit-sliced search below
// in row_topk_mask32: a 32-bit search that stops early pays there.
constexpr int kSlicedMaxNpl = 8;

// Exact top-k of one row of KB-bit keys (KB 16 or 32) held by one warp,
// lane `l` holding columns l*NPL + i, NPL <= 8, bit-sliced:
//   * an 8x8 bit transpose in each byte of the lane's (zero-padded) 8 keys
//     turns them into KB masks over the lane's keys, one a key bit (byte j
//     of r[c] is the mask of bit 8j + c): 12 exchanges of 3-4 instructions;
//   * a binary search for the threshold from the top bit, each step one
//     AND, one popc and one `__reduce_add_sync` whatever NPL: `eq` holds
//     the lane's keys equal to the threshold on the bits fixed so far,
//     `gt` those above it, and the warp's count of gt | eq is kept; it
//     stops as soon as that count is exactly k, since gt | eq is then the
//     top k with every key equal to the k-th among them (no tie to break).
//     At normal data that is about half-way through an f32 key;
//   * otherwise, after the last bit, `eq` holds the keys equal to the
//     threshold and the lowest columns among them are taken: the equal keys
//     of lower lanes (one exclusive warp scan) plus those earlier in the
//     lane.
// The same taken set as the compare-based searches.
template <int NPL, int KB>
__device__ __forceinline__ uint32_t row_topk_mask_sliced(const uint32_t (&key)[NPL], int k,
                                                         int lane) {
  static_assert(NPL >= 1 && NPL <= 8 && (KB == 16 || KB == 32), "8 keys of 16 or 32 bits a lane");
  uint32_t r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = i < NPL ? key[i] : 0u;  // padding: outside eq, never counted
#define MAXK_SWAP(a, b, s, m)                         \
  {                                                   \
    const uint32_t t = ((r[a] >> (s)) ^ r[b]) & (m);  \
    r[a] ^= t << (s);                                 \
    r[b] ^= t;                                        \
  }
  MAXK_SWAP(0, 4, 4, 0x0f0f0f0fu) MAXK_SWAP(1, 5, 4, 0x0f0f0f0fu)
  MAXK_SWAP(2, 6, 4, 0x0f0f0f0fu) MAXK_SWAP(3, 7, 4, 0x0f0f0f0fu)
  MAXK_SWAP(0, 2, 2, 0x33333333u) MAXK_SWAP(1, 3, 2, 0x33333333u)
  MAXK_SWAP(4, 6, 2, 0x33333333u) MAXK_SWAP(5, 7, 2, 0x33333333u)
  MAXK_SWAP(0, 1, 1, 0x55555555u) MAXK_SWAP(2, 3, 1, 0x55555555u)
  MAXK_SWAP(4, 5, 1, 0x55555555u) MAXK_SWAP(6, 7, 1, 0x55555555u)
#undef MAXK_SWAP
  uint32_t eq = (1u << NPL) - 1u, gt = 0u;
  unsigned above = 0, at_or_above = 32 * NPL;  // the warp's counts of gt, gt | eq
#pragma unroll
  for (int b = KB - 1; b >= 0; --b) {
    if (at_or_above == (unsigned)k) break;  // warp-uniform
    const uint32_t x = eq & (r[b & 7] >> (8 * (b >> 3)));
    const unsigned c = __reduce_add_sync(kFull, __popc(x));
    if (above + c >= (unsigned)k) {  // the threshold has bit b
      eq = x;
      at_or_above = above + c;
    } else {
      above += c;
      gt |= x;
      eq ^= x;
    }
  }
  if (at_or_above == (unsigned)k) return gt | eq;
  const unsigned need = (unsigned)k - above;  // >= 1
  unsigned before = exclusive_warp_sum(__popc(eq), lane);
  uint32_t take = gt;
#pragma unroll
  for (int i = 0; i < NPL; ++i)
    if ((eq >> i) & 1u) take |= (uint32_t)(before++ < need) << i;
  return take;
}

// Exact top-k of one row of 32-bit keys (to_key) held by one warp, lane
// `l` holding columns l*NPL + i. Up to kSlicedMaxNpl keys a lane, the
// bit-sliced search above; past it, two levels of 16 bits:
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
  if constexpr (NPL <= kSlicedMaxNpl) return row_topk_mask_sliced<NPL, 32>(key, k, lane);
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
