// Brick SpMM: Y = A @ X over a brick schedule (maxk_tpu_torch/sparse/bricks.py).
//
// Replaces the Pallas `_brick_kernel` (maxk_tpu/ops/spmm_bricks.py:37).
// The schedule streams A as T-slot subtiles, each slot a packed
// (lr << 7) | lc and an f32 value (0 = padding), CH subtiles a chunk,
// chunks sorted by (supergroup, panel). A subtile's meta holds win (bits
// 0-5), rb (6-8), first (9) and end (10): `first` starts a new (WB × WIN)
// brick, and `end` flushes it, Y[sgroup·SG + rb·WB :+WB] +=
// brick @ X[panel·PANEL + win·WIN :+WIN]. A brick may be first and end in
// one subtile; duplicate (lr, lc) slots add; a brick that ends twice
// flushes all it holds each time.
//
// Bound on the H100: the function Y = A@X reads a CSR-sized A and X once
// and writes Y once (74 MB at probe_bricks' default in f32, 0.022 ms at
// 3.35 TB/s) and does 2·nnz·D operations. The work that scales here: one
// slice of one X row per live slot (≈0.9 GB of row reads at D = 256 in
// f32, from L2), a shared atomic add per element of it, and a pass over
// the schedule (8 B a slot, ≈10% of slots live) per column slice.
//
// Design. The TPU kernel densifies each brick and flushes it with a dense
// (WB × WIN) @ (WIN × D) product; at ≈13 live slots per 16,384-position
// brick that is ≈1200× the operations of the product. Here a flush touches
// only the positions its brick's slots name:
//   - a block owns one (supergroup, row brick rb, slice of DC <= 128
//     columns) and keeps that f32 Y tile (WB × DC) in shared memory: zero
//     at the start, so a supergroup with no brick comes out zero, and
//     written once at the end in x's dtype. No two blocks write one element
//     of Y: no global atomics. The slices of one (supergroup, rb) are
//     neighbours in the grid, so they read its slots from L2 together.
//   - its warps take 32-subtile windows of the supergroup's chunk range
//     (binary search over the sorted chunk_sgroup; a shared counter hands
//     the windows out), one subtile a lane: the lanes read meta, and those
//     holding an `end` of the block's rb load the X base of their flush and
//     prefetch its slots into L1. Then the warp takes the flushes in turn,
//     walks back to the brick's start (its `first`, or the supergroup's
//     first subtile: a block starts from an empty brick) and reads the
//     slots from there to the `end`, 128 a round.
//   - each live slot inside the brick whose X row is below V becomes an
//     item (Y row, X row, value) in the warp's ring; 8 items at a time go
//     out: 4 columns a lane by one 16-byte (f32) or 8-byte (bf16) load with
//     an L2 evict-last hint, and shared atomics, since rows may meet across
//     warps. Within each row the tile is stored lane-major (column 4j + i
//     at i·L + j), so a warp's atomics fall on distinct banks.
//   - f32 x: one item per slot, duplicate slots add. bf16 x: each brick
//     entry (the f32 sum of its slots) is rounded to bf16 before it
//     multiplies X, as the TPU kernel's `brick.astype(x.dtype)` does, with
//     f32 accumulation. So a warp first marks the brick's positions in a
//     bitmap of WB × WIN bits and notes those held by more than one slot; a
//     single-slot entry is its own sum, and the first slot to claim a
//     duplicated position sums the brick's slots there (a warp scan); the
//     others drop out.
//   - a slot outside the brick, a flush outside the supergroup or panel,
//     and X rows past V add nothing. f32 products with no TF32.
// So the work is nnz·D multiply-adds and one schedule pass per slice (two at
// D = 256), not bricks·WB·WIN·D. On the H100 it is bound by each warp's
// chain of dependent latencies, not by bytes (bench/ablate_bricks.py
// takes it apart): the shared f32 atomics, which compile to compare-and-
// swap loops, take about a third of the time in f32, the X loads a fifth
// and the walk of the schedule a sixth; and the heaviest (supergroup, rb)
// holds 2.6× the mean share of the live slots. Owner warps fed through a
// bucketed queue, a block-wide staged walk, row-owning warps that each walk
// every flush, batched compare-and-swaps and row locks all measured slower.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kWindow = 32;            // subtiles a warp claims at once, one a lane
constexpr int kRing = 64;              // items a warp holds before it adds them
constexpr int kUnroll = 8;             // lane groups' X loads in flight
constexpr int kMaxCols = 128;          // columns of a slice: 32 lanes × 4
constexpr int kTileBytes = 64 * 1024;  // the Y tile: DC halves for WB > 128
constexpr int kMaxSmemBytes = 227 * 1024;

__device__ __forceinline__ float as_x(float v, const float*) { return v; }
__device__ __forceinline__ float as_x(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// 4 consecutive columns of X as f32, by one 16-byte (f32) or 8-byte (bf16)
// load that asks L2 to keep X
__device__ __forceinline__ void load4(const float* p, uint64_t policy, float (&o)[4]) {
  asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;\n"
      : "=f"(o[0]), "=f"(o[1]), "=f"(o[2]), "=f"(o[3])
      : "l"(p), "l"(policy));
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, uint64_t policy, float (&o)[4]) {
  unsigned a, b;
  asm("ld.global.nc.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;\n"
      : "=r"(a), "=r"(b)
      : "l"(p), "l"(policy));
  o[0] = __uint_as_float(a << 16), o[1] = __uint_as_float(a & 0xffff0000u);
  o[2] = __uint_as_float(b << 16), o[3] = __uint_as_float(b & 0xffff0000u);
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

// slots 4k..4k+3 of subtile `sub`, zero past its t slots
__device__ __forceinline__ void load_slots(const float* val, const int* idx, int64_t sub, int t,
                                           int k, float (&v)[4], int (&e)[4]) {
  if (4 * k < t) {
    const int64_t o = sub * t + 4 * k;  // t % 4 == 0: 16-byte aligned
    const float4 vv = __ldg(reinterpret_cast<const float4*>(val + o));
    const int4 ee = __ldg(reinterpret_cast<const int4*>(idx + o));
    v[0] = vv.x, v[1] = vv.y, v[2] = vv.z, v[3] = vv.w;
    e[0] = ee.x, e[1] = ee.y, e[2] = ee.z, e[3] = ee.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = 0.0f, e[i] = 0;
  }
}

// the columns of a block's slice: kMaxCols, halved while the Y tile exceeds
// its budget
int slice_cols(int wb) {
  int dc = kMaxCols;
  while (dc > 32 && (int64_t)wb * dc * 4 > kTileBytes) dc /= 2;
  return dc;
}

// the Y tile, the warps' item rings (X row, Y row, value) and, for bf16,
// two bitmaps of wb × win bits per warp
int64_t smem_bytes(int wb, int win, bool bf16) {
  const int64_t words = bf16 ? (int64_t)kWarps * 2 * ((wb * win + 31) / 32) : 0;
  return (int64_t)wb * slice_cols(wb) * 4 + kWarps * kRing * 12 + words * 4;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, std::is_same<T, float>::value ? 3 : 2)
    bricks_kernel(const int* __restrict__ chunk_panel, const int* __restrict__ chunk_sgroup,
                  const int* __restrict__ meta, const int* __restrict__ idx,
                  const float* __restrict__ val, const T* __restrict__ x, T* __restrict__ y,
                  int nc, int ch, int t, int sg, int panel, int wb, int win, int v_out,
                  int v_in, int d, int rbs, int dc, int nsl) {
  constexpr bool kBf16 = !std::is_same<T, float>::value;
  extern __shared__ __align__(16) float smem[];
  __shared__ int range[2];
  __shared__ int next_window;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slice = blockIdx.x % nsl;
  const int rb = (blockIdx.x / nsl) % rbs;
  const int s = blockIdx.x / nsl / rbs;
  const int d0 = slice * dc;
  const int dn = d - d0 < dc ? d - d0 : dc;
  const int nwords = (wb * win + 31) / 32;
  // an item's columns, 4 a lane, go to L lanes: G items a warp step
  const int L = dc / 4 < 32 ? dc / 4 : 32;
  const int G = 32 / L;
  const int g = lane / L, j = lane % L;
  const uint64_t keep = l2_evict_last();
  const unsigned below = (1u << lane) - 1u;

  float* ys = smem;  // wb × dc; column 4j + i of a row at i·L + j
  int* ring_x = reinterpret_cast<int*>(ys + wb * dc) + warp * kRing;
  int* ring_r = ring_x + kWarps * kRing;
  float* ring_a = reinterpret_cast<float*>(ring_r + kWarps * kRing);
  unsigned* seen = reinterpret_cast<unsigned*>(smem + wb * dc + 3 * kWarps * kRing) +
                   warp * 2 * nwords;
  unsigned* dup = seen + nwords;

  if (tid == 0) {
    range[0] = lower_bound(chunk_sgroup, nc, s);
    range[1] = lower_bound(chunk_sgroup, nc, s + 1);
    next_window = 0;
  }
  for (int i = tid; i < wb * dc; i += kThreads) ys[i] = 0.0f;
  if (kBf16)
    for (int i = lane; i < 2 * nwords; i += 32) seen[i] = 0u;
  __syncthreads();
  const int64_t lo = (int64_t)range[0] * ch, hi = (int64_t)range[1] * ch;
  const int t4 = t / 4;

  // add n items from the head of the warp's ring into the Y tile: shared
  // atomics, as rows may meet across warps (and within a warp step for G > 1)
  int head = 0, tail = 0;
  auto add_items = [&](int n) {
    float xv[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = u * G + g;
      if (q < n && 4 * j < dn) {
        const T* xr = x + (int64_t)ring_x[(head + q) & (kRing - 1)] * d + d0;
        if (VEC) {
          load4(xr + 4 * j, keep, xv[u]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            xv[u][i] = 4 * j + i < dn ? maxk::load_f32(xr + 4 * j + i) : 0.0f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = u * G + g;
      if (q < n && 4 * j < dn) {
        const int it = (head + q) & (kRing - 1);
        const float a = ring_a[it];
        float* yr = ys + ring_r[it] * dc + j;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (4 * j + i < dn) atomicAdd(yr + i * L, a * xv[u][i]);
      }
    }
    head += n;
    // for G = 4 the next ring writes may reuse the slots just read
    __syncwarp();
  };

  // the f32 sum of the brick's slots at position p over subtiles [a, f] (warp-wide)
  auto position_sum = [&](int64_t a, int64_t f, int p) {
    float part = 0.0f;
    for (int64_t sub = a; sub <= f; ++sub)
      for (int k = lane; k < t4; k += 32) {
        float v[4];
        int e[4];
        load_slots(val, idx, sub, t, k, v, e);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int lr = e[i] >> 7, lc = e[i] & 0x7F;
          if (v[i] != 0.0f && lr < wb && lc < win && lr * win + lc == p) part += v[i];
        }
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(maxk::kFull, part, o);
    return part;
  };

  // one flush: the `end` subtile f with meta mf, its X rows from xb
  auto flush = [&](int64_t f, int mf, int64_t xb) {
    // the brick starts at its `first`, or at the supergroup's first subtile
    int64_t a = f;
    for (int ma = mf; a > lo && !((ma >> 9) & 1);) ma = meta[--a];

    bool dupl = false;  // bf16: a position held by more than one slot
    if (kBf16) {
      for (int64_t sub = a; sub <= f; ++sub)
        for (int k = lane; k < t4; k += 32) {
          float v[4];
          int e[4];
          load_slots(val, idx, sub, t, k, v, e);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int lr = e[i] >> 7, lc = e[i] & 0x7F;
            if (v[i] != 0.0f && lr < wb && lc < win) {
              const int p = lr * win + lc;
              const unsigned bit = 1u << (p & 31);
              if (atomicOr(seen + (p >> 5), bit) & bit) {
                atomicOr(dup + (p >> 5), bit);
                dupl = true;
              }
            }
          }
        }
      __syncwarp();
      dupl = __any_sync(maxk::kFull, dupl);
    }

    for (int64_t sub = a; sub <= f; ++sub)
      for (int k0 = 0; k0 < t4; k0 += 32) {
        float v[4];
        int e[4];
        load_slots(val, idx, sub, t, k0 + lane, v, e);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int lr = e[i] >> 7, lc = e[i] & 0x7F;
          const int p = lr * win + lc;
          const bool in = v[i] != 0.0f && lr < wb && lc < win;
          bool ok = in && xb + lc < v_in;
          if (kBf16 && in) {
            const unsigned bit = 1u << (p & 31);
            if (!dupl)
              seen[p >> 5] = 0u;  // nothing reads it again in this flush
            else if (dup[p >> 5] & bit)
              // a duplicated position: the first slot to clear its bit sums it
              ok = ok && (atomicAnd(seen + (p >> 5), ~bit) & bit);
          }
          if (kBf16 && dupl) {
            const bool need = ok && (dup[p >> 5] & (1u << (p & 31)));
            for (unsigned m = __ballot_sync(maxk::kFull, need); m; m &= m - 1) {
              const int src = __ffs(m) - 1;
              const float sum = position_sum(a, f, __shfl_sync(maxk::kFull, p, src));
              if (lane == src) v[i] = sum;
            }
          }
          const unsigned bal = __ballot_sync(maxk::kFull, ok);
          if (ok) {
            const int it = (tail + __popc(bal & below)) & (kRing - 1);
            ring_x[it] = (int)(xb + lc);
            ring_r[it] = lr;
            ring_a[it] = as_x(v[i], x);
          }
          tail += __popc(bal);
          __syncwarp();
          while (tail - head >= G * kUnroll) add_items(G * kUnroll);
        }
      }

    if (kBf16 && dupl) {
      __syncwarp();
      for (int i = lane; i < 2 * nwords; i += 32) seen[i] = 0u;  // seen and dup
      __syncwarp();
    }
  };

  for (;;) {
    int w = 0;
    if (lane == 0) w = atomicAdd(&next_window, 1);
    const int64_t sub0 = lo + (int64_t)__shfl_sync(maxk::kFull, w, 0) * kWindow;
    if (sub0 >= hi) break;
    // lane l reads subtile sub0 + l of the window
    const int64_t f = sub0 + lane;
    const int m = lane < kWindow && f < hi ? meta[f] : 0;
    const bool mine = ((m >> 10) & 1) && ((m >> 6) & 7) == rb && (m & 0x3F) * win < panel;
    int64_t xb = 0;
    if (mine) {
      xb = (int64_t)chunk_panel[f / ch] * panel + (int64_t)(m & 0x3F) * win;
      // bring the flush's subtile into L1 ahead of its turn
      for (int o = 0; o < t; o += 32) {
        asm volatile("prefetch.global.L1 [%0];\n" ::"l"(val + f * t + o));
        asm volatile("prefetch.global.L1 [%0];\n" ::"l"(idx + f * t + o));
      }
    }
    for (unsigned tasks = __ballot_sync(maxk::kFull, mine); tasks; tasks &= tasks - 1) {
      const int src = __ffs(tasks) - 1;
      flush(sub0 + src, __shfl_sync(maxk::kFull, m, src), __shfl_sync(maxk::kFull, xb, src));
    }
  }
  add_items(tail - head);
  __syncthreads();

  const int64_t row0 = (int64_t)s * sg + (int64_t)rb * wb;
  for (int i = tid; i < wb * dn; i += kThreads) {
    const int r = i / dn, cc = i - r * dn;
    const int c = cc / 4;
    if (rb * wb + r < sg && row0 + r < v_out)
      maxk::store_f32(y + (row0 + r) * d + d0 + cc, ys[r * dc + (cc % 4) * L + c]);
  }
}

template <typename T, bool VEC>
int launch_vec(const void* cp, const void* cs, const void* meta, const void* idx,
               const void* val, const void* x, void* y, int nc, int ch, int t, int nsg, int sg,
               int panel, int wb, int win, int v_out, int v_in, int d, cudaStream_t stream) {
  const bool bf16 = !std::is_same<T, float>::value;
  const int64_t smem = smem_bytes(wb, win, bf16);
  const int dc = slice_cols(wb);
  const int rbs = (sg + wb - 1) / wb;
  const int nsl = (d + dc - 1) / dc;
  const int64_t blocks = (int64_t)nsg * rbs * nsl;
  if (smem > kMaxSmemBytes || blocks >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bricks_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  bricks_kernel<T, VEC><<<(unsigned)blocks, kThreads, (int)smem, stream>>>(
      static_cast<const int*>(cp), static_cast<const int*>(cs), static_cast<const int*>(meta),
      static_cast<const int*>(idx), static_cast<const float*>(val), static_cast<const T*>(x),
      static_cast<T*>(y), nc, ch, t, sg, panel, wb, win, v_out, v_in, d, rbs, dc, nsl);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

template <typename T>
int launch_bricks(const void* cp, const void* cs, const void* meta, const void* idx,
                  const void* val, const void* x, void* y, int nc, int ch, int t, int nsg,
                  int sg, int panel, int wb, int win, int v_out, int v_in, int d,
                  cudaStream_t stream) {
  if (nc < 1 || ch < 1 || t < 4 || t % 4 || nsg < 1 || sg < 1 || panel < 1 || wb < 1 ||
      wb > 512 || win < 1 || win > 128 || d < 1 || v_out < 1 || v_in < 1 ||
      !aligned(idx, 16) || !aligned(val, 16))
    return (int)cudaErrorInvalidValue;
  // 4 columns a lane by one load where rows allow it
  if (d % 4 == 0 && aligned(x, 4 * sizeof(T)))
    return launch_vec<T, true>(cp, cs, meta, idx, val, x, y, nc, ch, t, nsg, sg, panel, wb, win,
                               v_out, v_in, d, stream);
  return launch_vec<T, false>(cp, cs, meta, idx, val, x, y, nc, ch, t, nsg, sg, panel, wb, win,
                              v_out, v_in, d, stream);
}

}  // namespace

// The shared memory a block needs for a schedule of wb × win bricks, and the
// most a block may have: the wrapper names both when it refuses.
extern "C" int spmm_bricks_smem_bytes(int wb, int win, int bf16, int* need, int* limit) {
  *need = (int)smem_bytes(wb, win, bf16 != 0);
  *limit = kMaxSmemBytes;
  return 0;
}

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
