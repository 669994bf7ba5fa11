// Brick SpMM: Y = A @ X over a brick schedule (maxk_tpu_torch/sparse/bricks.py).
//
// Replaces the Pallas `_brick_kernel` (maxk_tpu/ops/spmm_bricks.py:37).
// The schedule streams A as 128-slot subtiles, each slot a packed
// (lr << 7) | lc and an f32 value (0 = padding), CH subtiles a chunk,
// chunks sorted by (supergroup, panel). A subtile's meta holds win (bits
// 0-5), rb (6-8), first (9) and end (10): `first` starts a new (WB × WIN)
// brick, and `end` flushes it, Y[sgroup·SG + rb·WB :+WB] +=
// brick @ X[panel·PANEL + win·WIN :+WIN]. A brick may be first and end in
// one subtile; duplicate (lr, lc) slots add.
//
// Bound on the H100: the flush, a dense (WB × WIN) @ (WIN × D) product per
// occupied brick, on the f32 CUDA cores (bricks · WB · WIN · D · 2 flops;
// for R-MAT at 32768 nodes and 1M edges almost every 128 × 128 brick is
// occupied, ≈0.55 TFLOP). The schedule, X and Y are ≈0.14 GB.
//
// Design: the TPU grid walks the chunks in order on one core and carries
// the brick and the Y block in VMEM from step to step. Here one block owns
// one supergroup's SG output rows and a slice of kDS output columns, finds
// its supergroup's chunk range by binary search over the sorted
// chunk_sgroup, and walks it in order: no two blocks write the same
// element of Y, so no atomics on Y. The block keeps in shared memory
//   - the f32 brick (WB × (WIN+1), padded against bank conflicts),
//     cleared on `first`; slots scatter into it with shared atomics;
//   - the X window of the flush (WIN × kDS, as f32; rows past V read 0);
//   - the f32 Y slice (SG × kDS), zero at the start (so a supergroup with
//     no brick comes out zero) and written once at the end in x's dtype.
// A block starts with a zero brick: the TPU kernel would carry the last
// supergroup's brick into a supergroup whose first subtile lacks `first`,
// which a built schedule never has. In the flush each thread accumulates a
// 4-row × 2-column tile in registers. f32 x: f32 FMAs throughout (no
// TF32). bf16 x: the brick is rounded to bf16 before the product, as the
// TPU kernel's `brick.astype(x.dtype)` does, with f32 accumulation. A slot
// outside the brick, or a flush outside the supergroup or panel, adds
// nothing (the TPU kernel's one-hot compares give the same for slots).
// Each block repeats the densify of its supergroup's bricks for its column
// slice; the later design keeps the brick once and puts the flush on the
// tensor cores.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kDS = 16;           // output columns per block
constexpr int kTileCols = 2;      // per thread
constexpr int kTileRows = 4;      // per thread
constexpr int kColGroups = kDS / kTileCols;             // 8
constexpr int kRowGroups = kThreads / kColGroups;       // 32
constexpr int kRowsPerPass = kRowGroups * kTileRows;    // 128
constexpr int kMaxSmemBytes = 227 * 1024;

__device__ __forceinline__ float as_x(float v, const float*) { return v; }
__device__ __forceinline__ float as_x(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// the brick's shared floats, rounded up to 16 bytes for the float2 reads of xs
__host__ __device__ __forceinline__ int brick_floats(int wb, int win) {
  return (wb * (win + 1) + 3) & ~3;
}

__device__ int lower_bound(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bricks_kernel(const int* __restrict__ chunk_panel, const int* __restrict__ chunk_sgroup,
                  const int* __restrict__ meta, const int* __restrict__ idx,
                  const float* __restrict__ val, const T* __restrict__ x, T* __restrict__ y,
                  int nc, int ch, int t, int sg, int panel, int wb, int win, int v_out,
                  int v_in, int d) {
  extern __shared__ float smem[];
  const int bstride = win + 1;
  float* brick = smem;                        // wb × bstride
  float* xs = brick + brick_floats(wb, win);  // win × kDS, 16-byte aligned
  float* ys = xs + win * kDS;                 // sg × kDS
  __shared__ int range[2];

  const int s = blockIdx.x;
  const int d0 = blockIdx.y * kDS;
  const int dn = d - d0 < kDS ? d - d0 : kDS;
  const int tid = threadIdx.x;
  if (tid == 0) {
    range[0] = lower_bound(chunk_sgroup, nc, s);
    range[1] = lower_bound(chunk_sgroup, nc, s + 1);
  }
  for (int i = tid; i < sg * kDS; i += kThreads) ys[i] = 0.0f;
  for (int i = tid; i < wb * bstride; i += kThreads) brick[i] = 0.0f;
  __syncthreads();

  const int cg = tid % kColGroups;  // this thread's columns 2cg, 2cg+1
  const int rg = tid / kColGroups;  // rows rg + 32q of each pass
  for (int c = range[0]; c < range[1]; ++c) {
    const int64_t x_panel = (int64_t)chunk_panel[c] * panel;
    for (int j = 0; j < ch; ++j) {
      const int64_t sub = (int64_t)c * ch + j;
      const int m = meta[sub];  // uniform over the block
      if ((m >> 9) & 1) {
        for (int i = tid; i < wb * bstride; i += kThreads) brick[i] = 0.0f;
        __syncthreads();
      }
      for (int k = tid; k < t; k += kThreads) {
        const float v = val[sub * t + k];
        if (v != 0.0f) {
          const int e = idx[sub * t + k];
          const int lr = e >> 7, lc = e & 0x7F;
          if (lr < wb && lc < win) atomicAdd(brick + lr * bstride + lc, v);
        }
      }
      __syncthreads();
      const int rb = (m >> 6) & 7, w = m & 0x3F;
      if (!((m >> 10) & 1) || rb * wb >= sg || w * win >= panel) continue;

      const int64_t xr0 = x_panel + (int64_t)w * win;
      for (int i = tid; i < win * kDS; i += kThreads) {
        const int r = i / kDS, cc = i % kDS;
        const int64_t xr = xr0 + r;
        xs[i] = (xr < v_in && cc < dn) ? maxk::load_f32(x + xr * d + d0 + cc) : 0.0f;
      }
      __syncthreads();
      for (int r0 = 0; r0 < wb; r0 += kRowsPerPass) {
        float acc[kTileRows][kTileCols] = {};
        const float* b[kTileRows];
#pragma unroll
        for (int q = 0; q < kTileRows; ++q) {
          const int r = r0 + rg + q * kRowGroups;
          b[q] = brick + (r < wb ? r : 0) * bstride;
        }
        for (int cc = 0; cc < win; ++cc) {
          const float2 xv = *reinterpret_cast<const float2*>(xs + cc * kDS + kTileCols * cg);
#pragma unroll
          for (int q = 0; q < kTileRows; ++q) {
            const float a = as_x(b[q][cc], x);
            acc[q][0] = fmaf(a, xv.x, acc[q][0]);
            acc[q][1] = fmaf(a, xv.y, acc[q][1]);
          }
        }
#pragma unroll
        for (int q = 0; q < kTileRows; ++q) {
          const int r = r0 + rg + q * kRowGroups;
          if (r < wb) {
            float* yr = ys + (rb * wb + r) * kDS + kTileCols * cg;
            yr[0] += acc[q][0];
            yr[1] += acc[q][1];
          }
        }
      }
      __syncthreads();
    }
  }

  const int64_t row0 = (int64_t)s * sg;
  for (int i = tid; i < sg * kDS; i += kThreads) {
    const int r = i / kDS, cc = i % kDS;
    if (row0 + r < v_out && cc < dn) maxk::store_f32(y + (row0 + r) * d + d0 + cc, ys[i]);
  }
}

template <typename T>
int launch_bricks(const void* cp, const void* cs, const void* meta, const void* idx,
                  const void* val, const void* x, void* y, int nc, int ch, int t, int nsg,
                  int sg, int panel, int wb, int win, int v_out, int v_in, int d,
                  cudaStream_t stream) {
  if (nc < 1 || ch < 1 || t < 1 || nsg < 1 || sg < 1 || panel < 1 || wb < 1 || wb > 512 ||
      win < 1 || win > 128 || d < 1 || v_out < 1 || v_in < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t smem =
      ((int64_t)brick_floats(wb, win) + (int64_t)win * kDS + (int64_t)sg * kDS) * 4;
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bricks_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nsg, (d + kDS - 1) / kDS);
  bricks_kernel<T><<<grid, kThreads, (int)smem, stream>>>(
      static_cast<const int*>(cp), static_cast<const int*>(cs), static_cast<const int*>(meta),
      static_cast<const int*>(idx), static_cast<const float*>(val), static_cast<const T*>(x),
      static_cast<T*>(y), nc, ch, t, sg, panel, wb, win, v_out, v_in, d);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (ctypes). Returns the cudaError_t of the launch.
extern "C" int spmm_bricks_f32(const void* cp, const void* cs, const void* meta,
                               const void* idx, const void* val, const void* x, void* y,
                               int nc, int ch, int t, int nsg, int sg, int panel, int wb,
                               int win, int v_out, int v_in, int d, void* stream) {
  return launch_bricks<float>(cp, cs, meta, idx, val, x, y, nc, ch, t, nsg, sg, panel, wb,
                              win, v_out, v_in, d, static_cast<cudaStream_t>(stream));
}

extern "C" int spmm_bricks_bf16(const void* cp, const void* cs, const void* meta,
                                const void* idx, const void* val, const void* x, void* y,
                                int nc, int ch, int t, int nsg, int sg, int panel, int wb,
                                int win, int v_out, int v_in, int d, void* stream) {
  return launch_bricks<__nv_bfloat16>(cp, cs, meta, idx, val, x, y, nc, ch, t, nsg, sg,
                                      panel, wb, win, v_out, v_in, d,
                                      static_cast<cudaStream_t>(stream));
}
