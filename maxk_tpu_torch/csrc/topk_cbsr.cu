// Top-k → CBSR: the k largest values of each row and their columns, in
// ascending column order.
//
// Replaces the Pallas `_topk_kernel` (maxk_tpu/ops/topk_pallas.py:79,
// launcher `_topk_pallas_raw` :184-207). Same result bit for bit: the taken
// set of the MaxK mask (maxk_mask.cu: the order-preserving key, exactly k
// taken, ties to the lowest columns), values as f32 and selectors as int32
// whatever the input dtype (bf16 widens exactly). The TPU kernel builds each
// value as a masked row sum, so a selected -0.0 comes out as +0.0; this
// kernel writes it so.
//
// Bound on the H100: the instructions of the threshold search, as for the
// mask kernel. A row is read once (V·D elements) and (V, k) values and
// selectors are written once, fewer bytes than the mask kernel moves, so
// the design is the mask kernel's, with a compaction for its layout:
//   * one warp per row, lane `l` owning the contiguous columns
//     [l·NPL, (l+1)·NPL), loaded as 16-byte vectors where NPL·sizeof(T)
//     is a multiple of 16 and x is 16-byte aligned (f32 at D = 256: two a
//     lane; bf16 one), otherwise element by element;
//   * the mask kernel's search (`maxk::row_topk_mask16` on the 16-bit key
//     for bf16, `maxk::row_topk_mask32` for f32), so the same taken set;
//   * compaction: a lane's taken columns ascend and follow those of every
//     lower lane, so one exclusive warp scan of the lanes' taken counts
//     gives each lane its first slot, and the lane stores its pairs to
//     consecutive slots from registers. Staging the pairs through a
//     per-warp shared buffer to store them as 16-byte vectors cost more
//     instructions than it saved (bench/ablate_topk_sample.py, PERF.md).
// The one-hot MXU contraction and the 2·k select-and-reduce passes of the
// TPU kernel have no counterpart.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

// a selected -0.0 becomes +0.0
__device__ __forceinline__ float cbsr_value(uint32_t f32_bits) {
  return __uint_as_float(f32_bits == 0x80000000u ? 0u : f32_bits);
}

// VEC: x moves as 16-byte vectors (NPL·sizeof(T) a multiple of 16, x
// 16-byte aligned); else element by element
template <typename T, int NPL, bool VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
topk_cbsr_kernel(const T* __restrict__ x, float* __restrict__ vals, int* __restrict__ sel,
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
    for (int i = 0; i < NPL; ++i) {
      if constexpr (kBf16)
        bits[i] = __bfloat16_as_ushort(x[base + i]);
      else
        bits[i] = __float_as_uint(x[base + i]);
    }
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

  // a lane's first slot: the taken columns of the lanes below it
  unsigned slot = maxk::exclusive_warp_sum(__popc(mask), lane);
  float* vr = vals + row * k;
  int* sr = sel + row * k;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    if ((mask >> i) & 1u) {
      vr[slot] = cbsr_value(kBf16 ? bits[i] << 16 : bits[i]);
      sr[slot] = lane * NPL + i;
      ++slot;
    }
  }
}

template <typename T, int NPL>
void launch_npl(const T* x, float* vals, int* sel, int rows, int k, bool x_aligned,
                cudaStream_t stream) {
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  if constexpr (NPL * sizeof(T) % 16 == 0) {
    if (x_aligned) {
      topk_cbsr_kernel<T, NPL, true><<<grid, block, 0, stream>>>(x, vals, sel, rows, k);
      return;
    }
  }
  topk_cbsr_kernel<T, NPL, false><<<grid, block, 0, stream>>>(x, vals, sel, rows, k);
}

template <typename T>
int launch(const void* x, void* vals, void* sel, int rows, int dim, int k,
           cudaStream_t stream) {
  if (rows <= 0 || dim % 32 != 0 || dim < 32 || dim > 1024 || k < 1 || k > dim)
    return (int)cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  float* vp = static_cast<float*>(vals);
  int* sp = static_cast<int*>(sel);
  const bool x_aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  switch (dim / 32) {
#define TOPK_CASE(N)                                           \
  case N:                                                      \
    launch_npl<T, N>(xp, vp, sp, rows, k, x_aligned, stream); \
    break;
    TOPK_CASE(1) TOPK_CASE(2) TOPK_CASE(3) TOPK_CASE(4) TOPK_CASE(5)
    TOPK_CASE(6) TOPK_CASE(7) TOPK_CASE(8) TOPK_CASE(9) TOPK_CASE(10)
    TOPK_CASE(11) TOPK_CASE(12) TOPK_CASE(13) TOPK_CASE(14) TOPK_CASE(15)
    TOPK_CASE(16) TOPK_CASE(17) TOPK_CASE(18) TOPK_CASE(19) TOPK_CASE(20)
    TOPK_CASE(21) TOPK_CASE(22) TOPK_CASE(23) TOPK_CASE(24) TOPK_CASE(25)
    TOPK_CASE(26) TOPK_CASE(27) TOPK_CASE(28) TOPK_CASE(29) TOPK_CASE(30)
    TOPK_CASE(31) TOPK_CASE(32)
#undef TOPK_CASE
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (ctypes). Returns the cudaError_t of the launch.
extern "C" int topk_cbsr_f32(const void* x, void* vals, void* sel, int rows,
                             int dim, int k, void* stream) {
  return launch<float>(x, vals, sel, rows, dim, k, static_cast<cudaStream_t>(stream));
}

extern "C" int topk_cbsr_bf16(const void* x, void* vals, void* sel, int rows,
                              int dim, int k, void* stream) {
  return launch<__nv_bfloat16>(x, vals, sel, rows, dim, k,
                               static_cast<cudaStream_t>(stream));
}
