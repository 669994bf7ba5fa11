// The CSR aggregation of the segsum path: the SpMM over dense features and
// the paper's CBSR pair of maxk_spgemm, over a CSR's segment table
// (`sparse/csr.row_segments`).
//
// K9 spmm_csr replaces `spmm_segsum` (maxk_tpu/ops/spmm_xla.py:21, the
// port's ops/spmm_xla.py): y = A @ x,
//     y[i, c] = T( sum_e f32( T(x[col_e, c] * T(a_e)) ) )
// K10 spgemm_cbsr replaces densify + that SpMM, maxk_spgemm's forward
// (maxk_tpu/ops/spgemm.py:157): y = A @ densify(vals, sel, dim), the
// densified value of a column being T(f32 sum of its slots in slot order).
// K11 sspmm_cbsr replaces that SpMM over the CSR of A^T + sample,
// maxk_spgemm's backward (maxk_tpu/ops/spgemm.py:224):
//     dvals[j, l] = T( sum_e f32( T(g[col_e, sel[j, l]] * T(a_e)) ) )
// for a selector in [0, dim), else 0; e runs over row j of A^T.
// T is the features' dtype (f32 or bf16): each product is rounded to it,
// the sum is taken in f32 and rounded once. Products and sums use __fmul_rn
// and __fadd_rn: a fused multiply-add would skip the product's rounding.
//
// Schedule: one warp a segment of at most seg_edges edges of one row, 8
// warps a block. A warp sums its edges in CSR order; a row of one segment
// is written straight to the output, so it carries the plain version's
// bits; a row of several writes f32 partial rows, which a second kernel
// (`combine_kernel`) adds in segment order and rounds once. No atomics:
// every launch gives the same bits. Hub rows spread over many warps, so no
// warp holds the card's tail.
//
// Bound on the H100: device memory. Read once, the inputs are the CSR and
// x (and y written once): ~1.1 GB at reddit x1.0, D = 256, f32, 0.33 ms.
// But each edge gathers its source row, 79M x 1 KB, and what the L2 does
// not hold of x comes from device memory again: the gather is the cost.
// K9's design keeps the gathers wide and many: lanes own the row's 16-byte
// vectors (a warp's load is 512 contiguous bytes), and U edges' row loads
// are issued before their adds. K10 moves k values and k selectors an edge
// in place of a D-wide row (256 B at k = 32 in f32) and adds into a per-warp
// f32 accumulator of the output row in shared memory. A first pass
// (`cbsr_merge_kernel`, once over the (V, k) CBSR) merges each source row's
// equal selectors into their first slot, summed in slot order and rounded
// once as the densify kernel (cbsr.cu) does, so the edges' slots need no
// grouping: a `__match_any_sync` and a reduction an edge, the design this
// replaced, made K10 twice as slow as K9 at reddit x1.0 (PERF.md). K11
// gathers k elements an edge (a lane a slot) into registers.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kCols = 256;  // K9's columns a pass: 8 a lane
// K10's shared-memory budget: kWarps f32 rows
constexpr int kSmemBytes = 48 * 1024;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// a value rounded to T, as a float
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (sizeof(T) == 2) return bf16_round(v);
  else return v;
}

// T(x * a) for x and a already in T
template <typename T>
__device__ __forceinline__ float product(float x, float a) {
  return round_to<T>(__fmul_rn(x, a));
}

__device__ __forceinline__ float bf16_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

// A lane's 8 elements of a kCols-column tile of one row:
//   f32 vectors: columns 4*lane + {0..3} and 128 + 4*lane + {0..3}
//   bf16 vectors: columns 8*lane + {0..7}
//   scalars: columns lane + 32*i
// (a warp's load instruction reads contiguous bytes in each layout).
template <typename T, bool kVec>
struct Frag {
  uint4 r[kVec && sizeof(T) == 4 ? 2 : 1];
  float s[kVec ? 1 : 8];

  // the lane's elements of the tile at `p`, w columns of it valid (w is a
  // multiple of the vector in the vector layouts)
  __device__ __forceinline__ void load(const T* __restrict__ p, int lane, int w) {
    if constexpr (kVec && sizeof(T) == 4) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 4 * lane + 128 * h;
        r[h] = c < w ? __ldg(reinterpret_cast<const uint4*>(p + c)) : make_uint4(0, 0, 0, 0);
      }
    } else if constexpr (kVec) {
      const int c = 8 * lane;
      r[0] = c < w ? __ldg(reinterpret_cast<const uint4*>(p + c)) : make_uint4(0, 0, 0, 0);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = lane + 32 * i;
        s[i] = c < w ? maxk::load_f32(p + c) : 0.0f;
      }
    }
  }

  __device__ __forceinline__ float get(int i) const {
    if constexpr (kVec && sizeof(T) == 4) {
      const uint4 q = r[i >> 2];
      const unsigned u = (i & 3) == 0 ? q.x : (i & 3) == 1 ? q.y : (i & 3) == 2 ? q.z : q.w;
      return __uint_as_float(u);
    } else if constexpr (kVec) {
      const uint4 q = r[0];
      const unsigned u = (i >> 1) == 0 ? q.x : (i >> 1) == 1 ? q.y : (i >> 1) == 2 ? q.z : q.w;
      return (i & 1) ? bf16_hi(u) : bf16_lo(u);
    } else {
      return s[i];
    }
  }
};

// The lane's 8 sums to the tile at `o` (w columns valid): rounded to T, or
// f32 for a partial row.
template <typename T, bool kVec, typename O>
__device__ __forceinline__ void store8(O* __restrict__ o, const float (&acc)[8], int lane, int w) {
  if constexpr (kVec && sizeof(O) == 4) {
    // f32 out: the f32 vector layout, or two vectors for bf16's 8 columns
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = sizeof(T) == 4 ? 4 * lane + 128 * h : 8 * lane + 4 * h;
      if (c < w)
        *reinterpret_cast<float4*>(o + c) =
            make_float4(acc[4 * h], acc[4 * h + 1], acc[4 * h + 2], acc[4 * h + 3]);
    }
  } else if constexpr (kVec) {
    const int c = 8 * lane;
    if (c < w)
      *reinterpret_cast<uint4*>(o + c) =
          make_uint4(pack_bf16x2(acc[0], acc[1]), pack_bf16x2(acc[2], acc[3]),
                     pack_bf16x2(acc[4], acc[5]), pack_bf16x2(acc[6], acc[7]));
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = lane + 32 * i;
      if (c < w) maxk::store_f32(o + c, acc[i]);
    }
  }
}

// A segment's edges: [begin, end), and where its sums go.
struct Segment {
  int row;
  int64_t begin, end;
  int part;  // partial row, or -1: the output row
};

__device__ __forceinline__ Segment segment(const int* __restrict__ indptr,
                                           const int* __restrict__ seg_row,
                                           const int* __restrict__ seg_begin,
                                           const int* __restrict__ seg_part, int s,
                                           int seg_edges) {
  Segment g;
  g.row = seg_row[s];
  g.begin = seg_begin[s];
  const int64_t row_end = indptr[g.row + 1];
  g.end = g.begin + seg_edges < row_end ? g.begin + seg_edges : row_end;
  g.part = seg_part[s];
  return g;
}

// K9: a warp a segment; U edges' row loads in flight, added in edge order.
template <typename T, bool kVec, int U>
__global__ void __launch_bounds__(kWarps * 32)
    spmm_csr_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                    const float* __restrict__ values, const int* __restrict__ seg_row,
                    const int* __restrict__ seg_begin, const int* __restrict__ seg_part,
                    const T* __restrict__ x, T* __restrict__ out, float* __restrict__ part,
                    int nseg, int seg_edges, int dim) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= nseg) return;
  const Segment g = segment(indptr, seg_row, seg_begin, seg_part, s, seg_edges);
#pragma unroll 1
  for (int t0 = 0; t0 < dim; t0 += kCols) {
    const int w = dim - t0 < kCols ? dim - t0 : kCols;
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
#pragma unroll 1
    for (int64_t e0 = g.begin; e0 < g.end; e0 += 32) {
      const int n = g.end - e0 < 32 ? (int)(g.end - e0) : 32;
      int c = 0;
      float a = 0.0f;
      if (lane < n) {  // the batch's columns and weights, one edge a lane
        c = indices[e0 + lane];
        a = round_to<T>(values[e0 + lane]);
      }
#pragma unroll 1
      for (int j = 0; j < n; j += U) {
        Frag<T, kVec> f[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int cu = __shfl_sync(maxk::kFull, c, (j + u) & 31);
          if (j + u < n) f[u].load(x + (int64_t)cu * dim + t0, lane, w);  // warp-uniform
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float au = __shfl_sync(maxk::kFull, a, (j + u) & 31);
          if (j + u < n) {
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[i] = __fadd_rn(acc[i], product<T>(f[u].get(i), au));
          }
        }
      }
    }
    if (g.part < 0)
      store8<T, kVec>(out + (int64_t)g.row * dim + t0, acc, lane, w);
    else
      store8<T, kVec>(part + (int64_t)g.part * dim + t0, acc, lane, w);
  }
}

// The rows of several segments: a warp a (row, 32-column slice), lane l
// column 32·slice + l, the row's partial rows added in segment order (f32)
// and rounded once to T; kCombineU partial rows' loads in flight. The
// slices spread a hub row's columns over warps, whose chains of adds are
// then its segment count over kCombineU long.
constexpr int kCombineU = 8;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    combine_kernel(const float* __restrict__ part, const int* __restrict__ multi_row,
                   const int* __restrict__ multi_part0, const int* __restrict__ multi_nseg,
                   T* __restrict__ out, int nmulti, int width, int slices) {
  const int lane = threadIdx.x & 31;
  const int64_t w = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= (int64_t)nmulti * slices) return;
  const int m = (int)(w / slices);
  const int c = (int)(w % slices) * 32 + lane;
  if (c >= width) return;
  const float* p = part + (int64_t)multi_part0[m] * width + c;
  const int n = multi_nseg[m];
  float acc = 0.0f;
  int i = 0;
#pragma unroll 1
  for (; i + kCombineU <= n; i += kCombineU) {
    float v[kCombineU];
#pragma unroll
    for (int u = 0; u < kCombineU; ++u) v[u] = p[(int64_t)(i + u) * width];
#pragma unroll
    for (int u = 0; u < kCombineU; ++u) acc = __fadd_rn(acc, v[u]);
  }
#pragma unroll 1
  for (; i < n; ++i) acc = __fadd_rn(acc, p[(int64_t)i * width]);
  maxk::store_f32(out + (int64_t)multi_row[m] * width + c, acc);
}

// K10's first pass, a warp a row of the CBSR: the row's equal selectors
// merged. Slot l keeps T(the f32 sum, in slot order, of the values of the
// slots that hold its selector) where l is the first of them, and -1
// where an earlier slot holds it or it lies outside [0, dim): the densified
// row's values at the columns it touches, one slot each. A slot's loop
// reads the row's selectors at one address for the warp (a broadcast).
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    cbsr_merge_kernel(const T* __restrict__ vals, const int* __restrict__ sel,
                      T* __restrict__ mvals, int* __restrict__ msel, int rows, int k, int dim) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int* s = sel + r * k;
  const T* v = vals + r * k;
#pragma unroll 1
  for (int l0 = 0; l0 < k; l0 += 32) {
    const int l = l0 + lane;
    int c = l < k ? s[l] : -1;
    if ((unsigned)c >= (unsigned)dim) c = -1;
    bool first = true;
    float acc = 0.0f;
#pragma unroll 1
    for (int m = 0; m < k; ++m) {
      if (c >= 0 && s[m] == c) {
        if (m < l)
          first = false;
        else
          acc = __fadd_rn(acc, maxk::load_f32(v + m));
      }
    }
    if (l < k) {
      const bool keep = c >= 0 && first;
      msel[r * k + l] = keep ? c : -1;
      maxk::store_f32(mvals + r * k + l, keep ? acc : 0.0f);
    }
  }
}

// K10: a warp a segment, its output row's `tw` columns of the tile at t0 in
// the warp's shared f32 row `acc`, over the merged CBSR (no column twice in
// a row, so an edge's slots add into distinct columns; a `__syncwarp`
// orders the edges). kOneChunk (k <= 32): lane l loads slot l of U edges'
// source rows at once; else each edge's slots are walked 32 at a time.
template <typename T, bool kOneChunk, int U>
__global__ void __launch_bounds__(kWarps * 32)
    spgemm_cbsr_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                       const float* __restrict__ values, const int* __restrict__ seg_row,
                       const int* __restrict__ seg_begin, const int* __restrict__ seg_part,
                       const T* __restrict__ mvals, const int* __restrict__ msel,
                       T* __restrict__ out, float* __restrict__ part, int nseg, int seg_edges,
                       int k, int dim, int tile, int stride) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s = blockIdx.x * kWarps + warp;
  if (s >= nseg) return;
  float* acc = reinterpret_cast<float*>(smem4) + warp * stride;
  const Segment g = segment(indptr, seg_row, seg_begin, seg_part, s, seg_edges);
#pragma unroll 1
  for (int t0 = 0; t0 < dim; t0 += tile) {
    const int tw = dim - t0 < tile ? dim - t0 : tile;
#pragma unroll 1
    for (int c = lane; c < tw; c += 32) acc[c] = 0.0f;
    __syncwarp();
#pragma unroll 1
    for (int64_t e0 = g.begin; e0 < g.end; e0 += 32) {
      const int n = g.end - e0 < 32 ? (int)(g.end - e0) : 32;
      int c = 0;
      float a = 0.0f;
      if (lane < n) {
        c = indices[e0 + lane];
        a = round_to<T>(values[e0 + lane]);
      }
      if constexpr (kOneChunk) {
#pragma unroll 1
        for (int j = 0; j < n; j += U) {
          int sc[U];
          float v[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int64_t cu = __shfl_sync(maxk::kFull, c, (j + u) & 31);
            sc[u] = -1;
            v[u] = 0.0f;
            if (j + u < n && lane < k) {
              sc[u] = msel[cu * k + lane];
              v[u] = maxk::load_f32(mvals + cu * k + lane);
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const float au = __shfl_sync(maxk::kFull, a, (j + u) & 31);
            if (j + u < n) {  // warp-uniform
              const int col = sc[u] - t0;
              if (sc[u] >= t0 && col < tw) acc[col] = __fadd_rn(acc[col], product<T>(v[u], au));
              __syncwarp();
            }
          }
        }
      } else {
#pragma unroll 1
        for (int j = 0; j < n; ++j) {
          const int64_t cu = __shfl_sync(maxk::kFull, c, j);
          const float au = __shfl_sync(maxk::kFull, a, j);
#pragma unroll 1
          for (int l = lane; l < k; l += 32) {
            const int sc = msel[cu * k + l];
            const int col = sc - t0;
            if (sc >= t0 && col < tw)
              acc[col] = __fadd_rn(acc[col], product<T>(maxk::load_f32(mvals + cu * k + l), au));
          }
          __syncwarp();
        }
      }
    }
    if (g.part < 0) {
      T* o = out + (int64_t)g.row * dim + t0;
#pragma unroll 1
      for (int c = lane; c < tw; c += 32) maxk::store_f32(o + c, acc[c]);
    } else {
      float* o = part + (int64_t)g.part * dim + t0;
#pragma unroll 1
      for (int c = lane; c < tw; c += 32) o[c] = acc[c];
    }
    __syncwarp();  // the next tile zeroes what the writes read
  }
}

// K11: a warp a segment of row j of A^T, lane l slot l0 + l; U edges'
// gathers in flight, added in edge order.
template <typename T, int U>
__global__ void __launch_bounds__(kWarps * 32)
    sspmm_cbsr_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                      const float* __restrict__ values, const int* __restrict__ seg_row,
                      const int* __restrict__ seg_begin, const int* __restrict__ seg_part,
                      const T* __restrict__ gr, const int* __restrict__ sel,
                      T* __restrict__ out, float* __restrict__ part, int nseg, int seg_edges,
                      int k, int dim) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= nseg) return;
  const Segment g = segment(indptr, seg_row, seg_begin, seg_part, s, seg_edges);
#pragma unroll 1
  for (int l0 = 0; l0 < k; l0 += 32) {
    const int l = l0 + lane;
    const int sc = l < k ? sel[(int64_t)g.row * k + l] : -1;
    const bool valid = (unsigned)sc < (unsigned)dim;  // never an address outside the row
    float acc = 0.0f;
#pragma unroll 1
    for (int64_t e0 = g.begin; e0 < g.end; e0 += 32) {
      const int n = g.end - e0 < 32 ? (int)(g.end - e0) : 32;
      int c = 0;
      float a = 0.0f;
      if (lane < n) {
        c = indices[e0 + lane];
        a = round_to<T>(values[e0 + lane]);
      }
#pragma unroll 1
      for (int j = 0; j < n; j += U) {
        float gv[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int64_t cu = __shfl_sync(maxk::kFull, c, (j + u) & 31);
          gv[u] = j + u < n && valid ? maxk::load_f32(gr + cu * dim + sc) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float au = __shfl_sync(maxk::kFull, a, (j + u) & 31);
          if (j + u < n && valid) acc = __fadd_rn(acc, product<T>(gv[u], au));
        }
      }
    }
    if (l < k) {
      if (g.part < 0)
        maxk::store_f32(out + (int64_t)g.row * k + l, acc);
      else
        part[(int64_t)g.part * k + l] = acc;
    }
  }
}

unsigned blocks_for(int n) { return (unsigned)(((int64_t)n + kWarps - 1) / kWarps); }

template <typename T>
int launch_combine(const void* part, const void* multi_row, const void* multi_part0,
                   const void* multi_nseg, void* out, int nmulti, int width,
                   cudaStream_t stream) {
  if (nmulti <= 0) return (int)cudaSuccess;
  const int slices = (width + 31) / 32;
  const int64_t blocks = ((int64_t)nmulti * slices + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  combine_kernel<T><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const int*>(multi_row),
      static_cast<const int*>(multi_part0), static_cast<const int*>(multi_nseg),
      static_cast<T*>(out), nmulti, width, slices);
  return (int)cudaGetLastError();
}

struct Csr {
  const int *indptr, *indices;
  const float* values;
  const int *seg_row, *seg_begin, *seg_part, *multi_row, *multi_part0, *multi_nseg;
};

Csr csr_of(const void* indptr, const void* indices, const void* values, const void* seg_row,
           const void* seg_begin, const void* seg_part, const void* multi_row,
           const void* multi_part0, const void* multi_nseg) {
  return Csr{static_cast<const int*>(indptr),    static_cast<const int*>(indices),
             static_cast<const float*>(values),  static_cast<const int*>(seg_row),
             static_cast<const int*>(seg_begin), static_cast<const int*>(seg_part),
             static_cast<const int*>(multi_row), static_cast<const int*>(multi_part0),
             static_cast<const int*>(multi_nseg)};
}

template <typename T>
int launch_spmm(const Csr& a, const void* x, void* out, void* part, int nseg, int nmulti,
                int seg_edges, int dim, cudaStream_t stream) {
  if (nseg <= 0 || seg_edges < 1 || dim < 1) return (int)cudaErrorInvalidValue;
  // 16-byte vectors where a row's bytes and both pointers allow (the
  // partial rows then allow them too)
  const bool vec = (int64_t)dim * sizeof(T) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  float* p = static_cast<float*>(part);
  // U: 8 16-byte loads in flight a lane (f32 rows take two a tile)
  constexpr int kU = sizeof(T) == 4 ? 4 : 8;
  if (vec)
    spmm_csr_kernel<T, true, kU><<<blocks_for(nseg), kWarps * 32, 0, stream>>>(
        a.indptr, a.indices, a.values, a.seg_row, a.seg_begin, a.seg_part, xt, o, p, nseg,
        seg_edges, dim);
  else
    spmm_csr_kernel<T, false, 4><<<blocks_for(nseg), kWarps * 32, 0, stream>>>(
        a.indptr, a.indices, a.values, a.seg_row, a.seg_begin, a.seg_part, xt, o, p, nseg,
        seg_edges, dim);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_combine<T>(part, a.multi_row, a.multi_part0, a.multi_nseg, out, nmulti, dim,
                           stream);
}

template <typename T>
int launch_spgemm(const Csr& a, const void* vals, const void* sel, void* mvals, void* msel,
                  void* out, void* part, int nseg, int nmulti, int seg_edges, int k, int dim,
                  int rows, cudaStream_t stream) {
  if (nseg <= 0 || seg_edges < 1 || k < 1 || dim < 1 || rows < 0) return (int)cudaErrorInvalidValue;
  T* mv = static_cast<T*>(mvals);
  int* ms = static_cast<int*>(msel);
  if (rows > 0) {
    cbsr_merge_kernel<T><<<blocks_for(rows), kWarps * 32, 0, stream>>>(
        static_cast<const T*>(vals), static_cast<const int*>(sel), mv, ms, rows, k, dim);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const int max_tile = kSmemBytes / (kWarps * (int)sizeof(float));
  const int tile = dim < max_tile ? dim : max_tile;
  const int stride = (tile + 3) / 4 * 4;
  const size_t smem = (size_t)kWarps * stride * sizeof(float);
  T* o = static_cast<T*>(out);
  float* p = static_cast<float*>(part);
  if (k <= 32)
    spgemm_cbsr_kernel<T, true, 8><<<blocks_for(nseg), kWarps * 32, smem, stream>>>(
        a.indptr, a.indices, a.values, a.seg_row, a.seg_begin, a.seg_part, mv, ms, o, p, nseg,
        seg_edges, k, dim, tile, stride);
  else
    spgemm_cbsr_kernel<T, false, 1><<<blocks_for(nseg), kWarps * 32, smem, stream>>>(
        a.indptr, a.indices, a.values, a.seg_row, a.seg_begin, a.seg_part, mv, ms, o, p, nseg,
        seg_edges, k, dim, tile, stride);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_combine<T>(part, a.multi_row, a.multi_part0, a.multi_nseg, out, nmulti, dim,
                           stream);
}

template <typename T>
int launch_sspmm(const Csr& a, const void* g, const void* sel, void* out, void* part, int nseg,
                 int nmulti, int seg_edges, int k, int dim, cudaStream_t stream) {
  if (nseg <= 0 || seg_edges < 1 || k < 1 || dim < 1) return (int)cudaErrorInvalidValue;
  sspmm_cbsr_kernel<T, 8><<<blocks_for(nseg), kWarps * 32, 0, stream>>>(
      a.indptr, a.indices, a.values, a.seg_row, a.seg_begin, a.seg_part,
      static_cast<const T*>(g), static_cast<const int*>(sel), static_cast<T*>(out),
      static_cast<float*>(part), nseg, seg_edges, k, dim);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_combine<T>(part, a.multi_row, a.multi_part0, a.multi_nseg, out, nmulti, k,
                           stream);
}

}  // namespace

// C interface (ctypes). Each takes the CSR (indptr, indices, values) and
// its segment table (row, begin, part; multi_row, multi_part0,
// multi_nseg), launches its kernel and, for rows of several segments, the
// combine kernel, and returns the cudaError_t of the launches.
extern "C" int spmm_csr_f32(const void* indptr, const void* indices, const void* values,
                            const void* seg_row, const void* seg_begin, const void* seg_part,
                            const void* multi_row, const void* multi_part0, const void* multi_nseg,
                            const void* x, void* out, void* part, int nseg, int nmulti,
                            int seg_edges, int dim, void* stream) {
  const Csr a = csr_of(indptr, indices, values, seg_row, seg_begin, seg_part, multi_row,
                       multi_part0, multi_nseg);
  return launch_spmm<float>(a, x, out, part, nseg, nmulti, seg_edges, dim,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int spmm_csr_bf16(const void* indptr, const void* indices, const void* values,
                             const void* seg_row, const void* seg_begin, const void* seg_part,
                             const void* multi_row, const void* multi_part0, const void* multi_nseg,
                             const void* x, void* out, void* part, int nseg, int nmulti,
                             int seg_edges, int dim, void* stream) {
  const Csr a = csr_of(indptr, indices, values, seg_row, seg_begin, seg_part, multi_row,
                       multi_part0, multi_nseg);
  return launch_spmm<__nv_bfloat16>(a, x, out, part, nseg, nmulti, seg_edges, dim,
                                    static_cast<cudaStream_t>(stream));
}

extern "C" int spgemm_cbsr_f32(const void* indptr, const void* indices, const void* values,
                               const void* seg_row, const void* seg_begin, const void* seg_part,
                               const void* multi_row, const void* multi_part0, const void* multi_nseg,
                               const void* vals, const void* sel, void* mvals, void* msel, void* out,
                               void* part, int nseg, int nmulti, int seg_edges, int k, int dim,
                               int rows, void* stream) {
  const Csr a = csr_of(indptr, indices, values, seg_row, seg_begin, seg_part, multi_row,
                       multi_part0, multi_nseg);
  return launch_spgemm<float>(a, vals, sel, mvals, msel, out, part, nseg, nmulti, seg_edges,
                              k, dim, rows, static_cast<cudaStream_t>(stream));
}

extern "C" int spgemm_cbsr_bf16(const void* indptr, const void* indices, const void* values,
                                const void* seg_row, const void* seg_begin, const void* seg_part,
                                const void* multi_row, const void* multi_part0, const void* multi_nseg,
                                const void* vals, const void* sel, void* mvals, void* msel, void* out,
                                void* part, int nseg, int nmulti, int seg_edges, int k, int dim,
                                int rows, void* stream) {
  const Csr a = csr_of(indptr, indices, values, seg_row, seg_begin, seg_part, multi_row,
                       multi_part0, multi_nseg);
  return launch_spgemm<__nv_bfloat16>(a, vals, sel, mvals, msel, out, part, nseg, nmulti, seg_edges,
                                      k, dim, rows, static_cast<cudaStream_t>(stream));
}

extern "C" int sspmm_cbsr_f32(const void* indptr, const void* indices, const void* values,
                              const void* seg_row, const void* seg_begin, const void* seg_part,
                              const void* multi_row, const void* multi_part0, const void* multi_nseg,
                              const void* g, const void* sel, void* out, void* part, int nseg,
                              int nmulti, int seg_edges, int k, int dim, void* stream) {
  const Csr a = csr_of(indptr, indices, values, seg_row, seg_begin, seg_part, multi_row,
                       multi_part0, multi_nseg);
  return launch_sspmm<float>(a, g, sel, out, part, nseg, nmulti, seg_edges, k, dim,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int sspmm_cbsr_bf16(const void* indptr, const void* indices, const void* values,
                               const void* seg_row, const void* seg_begin, const void* seg_part,
                               const void* multi_row, const void* multi_part0, const void* multi_nseg,
                               const void* g, const void* sel, void* out, void* part, int nseg,
                               int nmulti, int seg_edges, int k, int dim, void* stream) {
  const Csr a = csr_of(indptr, indices, values, seg_row, seg_begin, seg_part, multi_row,
                       multi_part0, multi_nseg);
  return launch_sspmm<__nv_bfloat16>(a, g, sel, out, part, nseg, nmulti, seg_edges, k, dim,
                                     static_cast<cudaStream_t>(stream));
}
