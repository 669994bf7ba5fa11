// MaxK mask: y = x ⊙ take, with take the exact top-k of each row.
//
// Replaces the Pallas `_mask_kernel` (maxk_tpu/ops/topk_pallas.py:99, with
// the shared `_take_mask` at :39-76). Same result bit for bit, a dropped
// entry being +0.0 whatever the sign of x: the same order-preserving key
// (`maxk::to_key`, −0.0 below +0.0), exactly k taken, ties to the lowest
// columns.
//
// Bound on the H100: the instructions it runs, not device memory. A row is read
// once and y and take are written once, O(V·D) bytes, but a 32-step
// threshold search of NPL compares a lane a step over a row of 256 is
// ≈850 warp instructions, and bf16, with 44% fewer bytes, ran as slowly as
// f32. So the design cuts instructions:
//   * one warp per row, lane `l` owning the contiguous columns
//     [l·NPL, (l+1)·NPL): x and y move as 16-byte vectors (f32 at D = 256:
//     two loads and two stores a lane; bf16 one of each) and take as one
//     8-byte store; rows whose lane span is not a 16-byte multiple, or
//     pointers not 16-byte aligned, move element by element;
//   * bf16: the 16-bit key (`maxk::to_key16`) orders exactly, so the search
//     is 16 steps (`maxk::row_topk_mask16`);
//   * f32 (`maxk::row_topk_mask32`): up to D = 256, the bit-sliced search
//     (`maxk::row_topk_mask_sliced`: a lane's keys transposed into one mask
//     a key bit, one AND, popc and reduction a step, stopping as soon as
//     exactly k keys are at or above the threshold's prefix); past it, 16
//     steps on the keys' top halves, then 16 one-compare ballot steps over
//     the few keys that share the threshold's top half, compacted one a
//     lane (many equal values take the full search of the low half);
//   * the rank among keys equal to the threshold is a lane's own prefix
//     plus one exclusive warp scan.
// No atomics; 64 bytes of shared memory a warp for the compaction. The
// −inf row padding and VMEM block budgets of the TPU kernel have no
// counterpart here.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

// take bits i..i+3 of `mask` as four 0/1 bytes of a little-endian word
__device__ __forceinline__ uint32_t take_bytes(uint32_t mask, int i) {
  return (((mask >> i) & 0xfu) * 0x00204081u) & 0x01010101u;
}

// the bits of element i, zero-extended
__device__ __forceinline__ uint32_t elem_bits(const float* p, int i) {
  return __float_as_uint(p[i]);
}
__device__ __forceinline__ uint32_t elem_bits(const __nv_bfloat16* p, int i) {
  return __bfloat16_as_ushort(p[i]);
}
__device__ __forceinline__ void put_bits(float* p, int i, uint32_t b) { p[i] = __uint_as_float(b); }
__device__ __forceinline__ void put_bits(__nv_bfloat16* p, int i, uint32_t b) {
  p[i] = __ushort_as_bfloat16((unsigned short)b);
}

// VEC: x, y and take move as 16-byte vectors (NPL·sizeof(T) a multiple of
// 16, every pointer 16-byte aligned); else element by element
template <typename T, int NPL, bool VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
maxk_mask_kernel(const T* __restrict__ x, T* __restrict__ y, uint8_t* __restrict__ take,
                 int rows, int k) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kWords = NPL * (int)sizeof(T) / 4;  // 32-bit words a lane (VEC)
  __shared__ uint16_t scratch[kWarpsPerBlock][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (row >= rows) return;  // warp-uniform: a warp owns one row
  const int64_t base = row * (NPL * 32) + lane * NPL;

  uint32_t bits[NPL];
  if constexpr (VEC) {
    uint32_t w[kWords];
    const uint4* src = reinterpret_cast<const uint4*>(x + base);
#pragma unroll
    for (int j = 0; j < kWords / 4; ++j) {
      const uint4 q = src[j];
      w[4 * j] = q.x, w[4 * j + 1] = q.y, w[4 * j + 2] = q.z, w[4 * j + 3] = q.w;
    }
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      if constexpr (kBf16)
        bits[i] = (w[i / 2] >> (16 * (i % 2))) & 0xffffu;  // element 2j in the low half
      else
        bits[i] = w[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < NPL; ++i) bits[i] = elem_bits(x + base, i);
  }

  uint32_t key[NPL];
  uint32_t mask;
  if constexpr (kBf16) {
#pragma unroll
    for (int i = 0; i < NPL; ++i) key[i] = maxk::to_key16(bits[i]);
    mask = maxk::row_topk_mask16<NPL>(key, k, lane);
  } else {
#pragma unroll
    for (int i = 0; i < NPL; ++i) key[i] = maxk::to_key(__uint_as_float(bits[i]));
    mask = maxk::row_topk_mask32<NPL>(key, k, lane, scratch[warp]);
  }

  if constexpr (VEC) {
    uint32_t w[kWords];
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      if constexpr (kBf16) {
        const uint32_t lo = (mask >> (2 * j)) & 1u ? bits[2 * j] : 0u;
        const uint32_t hi = (mask >> (2 * j + 1)) & 1u ? bits[2 * j + 1] : 0u;
        w[j] = lo | (hi << 16);
      } else {
        w[j] = (mask >> j) & 1u ? bits[j] : 0u;
      }
    }
    uint4* dst = reinterpret_cast<uint4*>(y + base);
#pragma unroll
    for (int j = 0; j < kWords / 4; ++j)
      dst[j] = make_uint4(w[4 * j], w[4 * j + 1], w[4 * j + 2], w[4 * j + 3]);
    // NPL is a multiple of 4 here (f32) or of 8 (bf16): take in the widest
    // units NPL bytes allow
    uint8_t* tp = take + base;
    if constexpr (NPL % 16 == 0) {
#pragma unroll
      for (int i = 0; i < NPL; i += 16)
        *reinterpret_cast<uint4*>(tp + i) = make_uint4(
            take_bytes(mask, i), take_bytes(mask, i + 4), take_bytes(mask, i + 8),
            take_bytes(mask, i + 12));
    } else if constexpr (NPL % 8 == 0) {
#pragma unroll
      for (int i = 0; i < NPL; i += 8)
        *reinterpret_cast<uint2*>(tp + i) = make_uint2(take_bytes(mask, i), take_bytes(mask, i + 4));
    } else {
#pragma unroll
      for (int i = 0; i < NPL; i += 4)
        *reinterpret_cast<uint32_t*>(tp + i) = take_bytes(mask, i);
    }
  } else {
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const bool t = (mask >> i) & 1u;
      put_bits(y + base, i, t ? bits[i] : 0u);
      take[base + i] = t;
    }
  }
}

template <typename T, int NPL>
void launch_npl(const T* x, T* y, uint8_t* take, int rows, int k, bool aligned,
                cudaStream_t stream) {
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  if constexpr (NPL * sizeof(T) % 16 == 0) {
    if (aligned) {
      maxk_mask_kernel<T, NPL, true><<<grid, block, 0, stream>>>(x, y, take, rows, k);
      return;
    }
  }
  maxk_mask_kernel<T, NPL, false><<<grid, block, 0, stream>>>(x, y, take, rows, k);
}

template <typename T>
int launch(const void* x, void* y, void* take, int rows, int dim, int k,
           cudaStream_t stream) {
  if (rows <= 0 || dim % 32 != 0 || dim < 32 || dim > 1024 || k < 1 || k > dim)
    return (int)cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  uint8_t* tp = static_cast<uint8_t*>(take);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                        reinterpret_cast<uintptr_t>(take)) % 16 == 0;
  switch (dim / 32) {
#define MAXK_CASE(N)                                          \
  case N:                                                     \
    launch_npl<T, N>(xp, yp, tp, rows, k, aligned, stream); \
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
