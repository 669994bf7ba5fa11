// Top-k → CBSR: the k largest values of each row and their columns, in
// ascending column order.
//
// Replaces the Pallas `_topk_kernel` (maxk_tpu/ops/topk_pallas.py:79,
// launcher `_topk_pallas_raw` :184-207). Same result bit for bit: the
// same taken set as the MaxK mask (`maxk::row_topk_mask`, common.cuh: the
// order-preserving key, the 32-step threshold search, ties to the lowest
// columns), values as f32 and selectors as int32 whatever the input dtype
// (bf16 is upcast exactly). The TPU kernel builds each value as a masked
// row sum, so a selected -0.0 comes out as +0.0; this kernel writes it so.
//
// Bound on the H100: device memory. Each row is read once (V·D elements)
// and (V, k) values and selectors are written once; the 32 counting
// passes run on registers. Design: one warp per row, D/32 keys per lane in
// registers, as the mask kernel. Compaction has no scatter and no shared
// memory: the warp walks its columns in order, i = 0..D/32-1, and a lane
// whose column i*32+l is taken writes slot
//   taken_before + __popc(ballot(taken at i) & lanes below l),
// with taken_before the warp-uniform count of taken columns before i. The
// one-hot MXU contraction and the 2·k select-and-reduce passes of the TPU
// kernel have no counterpart.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename T, int NPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
topk_cbsr_kernel(const T* __restrict__ x, float* __restrict__ vals,
                 int* __restrict__ sel, int rows, int k) {
  constexpr int D = NPL * 32;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // warp-uniform: a warp owns one row
  const T* xr = x + row * D + lane;

  uint32_t key[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) key[i] = maxk::to_key(maxk::load_f32(xr + i * 32));

  const uint32_t mask = maxk::row_topk_mask<NPL>(key, k, lane);
  const unsigned below = (1u << lane) - 1u;
  float* vr = vals + row * k;
  int* sr = sel + row * k;
  unsigned taken_before = 0;  // warp-uniform
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const bool t = (mask >> i) & 1u;
    const unsigned ballot = __ballot_sync(maxk::kFull, t);
    if (t) {
      const unsigned slot = taken_before + __popc(ballot & below);
      const float v = maxk::from_key(key[i]);
      vr[slot] = (v == 0.0f) ? 0.0f : v;  // a selected -0.0 becomes +0.0
      sr[slot] = i * 32 + lane;
    }
    taken_before += __popc(ballot);
  }
}

template <typename T>
int launch(const void* x, void* vals, void* sel, int rows, int dim, int k,
           cudaStream_t stream) {
  if (rows <= 0 || dim % 32 != 0 || dim < 32 || dim > 1024 || k < 1 || k > dim)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  const T* xp = static_cast<const T*>(x);
  float* vp = static_cast<float*>(vals);
  int* sp = static_cast<int*>(sel);
  switch (dim / 32) {
#define TOPK_CASE(N)                                                         \
  case N:                                                                    \
    topk_cbsr_kernel<T, N><<<grid, block, 0, stream>>>(xp, vp, sp, rows, k); \
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
