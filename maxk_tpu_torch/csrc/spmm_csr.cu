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
// (bf16 pairs: __hmul2_rn) and __fadd_rn: a fused multiply-add would skip
// the product's rounding. The product of two bf16 values is exact in f32,
// so __hmul2_rn's one rounding equals T(__fmul_rn(x, a)), subnormals too.
//
// Every element sums its terms in edge order within a segment of at most
// seg_edges edges of one row; a row of one segment is written straight to
// the output, so it carries the plain version's bits; a row of several
// writes f32 partial rows, which a second kernel (`combine_kernel`) adds in
// segment order and rounds once. No atomics touch a sum: every launch gives
// the same bits, whatever order the segments run in.
//
// Bound on the H100: device memory. Read once, the inputs are the CSR and
// x (and y written once): ~1.1 GB at reddit x1.0, D = 256, f32, 0.33 ms.
// But each edge gathers its source row, 79M x 1 KB, and that is the cost.
// The measured ceiling (bench/ablate_csr.py: the same call on a CSR whose
// columns all fall in rows L2 holds) is 9.4 ms in f32 and 5.2 in bf16 on
// the H100, 8.6 and 7.8 TB/s of gathered rows: what binds is the rate at
// which L2 and L1 serve rows to the SMs, not device memory.
//
// K11 is bound the same way, by sectors: an edge of row j of A^T reads
// k elements of g's row col_e at sel[j], so it brings the 32-byte sectors
// of that row which sel[j] touches, the same set for every edge of the row:
// of D = 256 columns, k = 32 distinct selectors touch 21.2 of 32 sectors
// in f32 (14.2 of 16 in bf16), k = 64 28.9 (15.9), k = 16 13.1 (10.5),
// whatever lane asks for them (`ablate_csr` counts them: gathered_bytes).
// What its design does about it (bench/ablate_csr.py, on the H100):
//  - rows stay in L2 where they are gathered often: on a graph whose rows
//    of g are gathered 64 times or more (E/V, `ops/spmm_csr.k11_slice`)
//    and k <= 32, g is walked in column slices of 512 bytes a row, slice
//    after slice; f32 rows of 1 KB missed L2 (reddit x1.0, k = 32: 8.1 ms
//    whole, 6.9 sliced, against 6.6 with every row an L2 hit);
//  - no lane idles and the edges are walked once: a segment gets 8 lanes
//    for k <= 8, 16 for k <= 16, else the warp, with up to 4 slots a lane,
//    ordered by selector so an edge's gathers read disjoint sectors (k = 64
//    as two walks of one slot a lane: 1.7x slower);
//  - no warp waits on the schedule: segments in the work order (longest
//    first) from one 16-byte `work` entry each; over whole rows a warp a
//    unit, the block scheduler dealing the blocks out as SMs free up (the
//    balance of a counter without its atomics); in slices a persistent
//    grid, the long units from a counter where they outnumber the warps,
//    the short ones in turn (one atomic a short unit cost 1.5x at 65,536
//    short segments);
//  - columns and weights two batches ahead of the gathers, a chunk of 8
//    gathers a lane in flight while the last is added (at 32 lanes of one
//    slot, and bf16 of several: none, and 6 blocks an SM in place of 4),
//    bf16 products two edges at a time by __hmul2_rn.
//
// K9 walks x in column slices of 256 bytes a row (kSliceVecs: 64 f32 or
// 128 bf16 columns; slices of 128 or 512 bytes measured slower: more work
// an edge, or fewer rows in L1), slice after slice, on a persistent grid
// (at most a block an SM, so every SM works on one slice at a time) that
// takes its work from a counter a slice. A warp takes kGroups segments at
// once, a lane group of kGroupLanes lanes each, two 16-byte vectors a
// lane, and the work order puts segments of equal length together
// (`order`, longest first) so a warp's groups end together. Columns and
// weights are software-pipelined two batches ahead of the rows they name.
// bf16 products go two at a time through __hmul2_rn (rounding each by a
// conversion, as the earlier design did, is 1.30x slower). K9 holds no
// rows in shared memory: a cache of the hub rows' slice (192 KB, the 768
// hottest rows, 17% of the references at reddit x1.0) made it 9-10%
// slower than leaving that memory to L1, which keeps the hot rows without
// a lookup an edge.
//
// K10 moves k values and k selectors an edge in place of a D-wide row. A
// first pass (`cbsr_merge_kernel`, once over the (V, k) CBSR) merges each
// source row's equal selectors into their first slot (int16, -1 for none;
// a bf16 slot's selector and value packed into one word ran slower),
// summed in slot order and rounded once as the densify kernel (cbsr.cu)
// does, so an edge's slots fall in distinct columns and add into a
// per-warp f32 row in shared memory without grouping. Its persistent grid
// (at most kK10Blocks blocks an SM) keeps the hub rows' merged slots in
// shared memory (254 / 381 rows of 32 slots in f32 / bf16 at reddit x1.0,
// 8.5% / 10.7% of the references) and has the next U edges' slots in
// flight while it adds the current ones. K11 gathers k elements an edge
// into registers, S slots a lane.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // the merge and combine passes: warps a block
// K9: a persistent grid, kK9Blocks blocks of kK9Threads an SM
constexpr int kK9Threads = 512;
constexpr int kK9Blocks = 1;
// K9: a lane group a segment, kSliceVecs 16-byte vectors a lane a row: a
// column slice of kGroupLanes * kSliceVecs * 16 bytes a row
constexpr int kGroupLanes = 8;
constexpr int kGroups = 32 / kGroupLanes;
constexpr int kSliceVecs = 2;
constexpr int kK9Warps = kK9Threads / 32;
// K10: kK10Blocks blocks of kK10Threads an SM; the warps' f32 accumulator
// rows take at most kAccBytes of the SM's kSmemBytes, the hub cache the
// rest; a warp takes up to kGrab segments from the counter at once, fewer
// where that would leave it fewer than kMinTakes takes: the grid's last
// takes then end unevenly (at 65,536 nodes and 380K edges one segment a
// take ran 1.7x / 2.1x faster in f32 / bf16 than four, at reddit x1.0 1%
// slower)
constexpr int kK10Threads = 256;
constexpr int kK10Blocks = 4;
constexpr int kK10Warps = kK10Threads / 32;
constexpr int kAccBytes = 64 * 1024;
constexpr int kSmemBytes = 227 * 1024;
constexpr int kBlockSmem = kSmemBytes / kK10Blocks - (kK10Blocks > 1 ? 1024 : 0);
constexpr int kGrab = 4;
constexpr int kMinTakes = 16;
// K11: blocks of kK11Threads; a sliced walk of g takes column slices of
// kK11SliceBytes a row; a lane gathers kK11Chunk elements a chunk
// (kK11Chunk / S edges). At 8 or 16 lanes a segment, and in f32 at
// several slots a lane, it has the next chunk's in flight while it adds
// one, at most kK11Blocks blocks an SM; at whole-warp groups of one slot a
// lane, and in bf16 of several, none, at kK11BlocksLean blocks an SM
// (bench/ablate_csr.py, arms other_pipe and lean_warp: the other choice
// up to 2.1x slower; f32 at two slots a lane without a chunk in flight up
// to 8% faster at 262,144 rows, 1.5x slower at 65,536); segments of
// kSortMin edges or more order their slots by selector where a lane holds
// several
constexpr int kK11SliceBytes = 512;
constexpr int kK11Threads = 256;
constexpr int kK11Blocks = 4;
constexpr int kK11BlocksLean = 6;
constexpr int kK11Warps = kK11Threads / 32;
template <typename T, int G, int S>
constexpr bool kK11Pipelined = G < 32 || (sizeof(T) == 4 && S > 1);
template <typename T, int G, int S>
constexpr int kK11BlocksOf = kK11Pipelined<T, G, S> ? kK11Blocks : kK11BlocksLean;
constexpr int kK11Chunk = 8;
constexpr int kSortMin = 16;

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

// both bf16 halves of x times those of a, each rounded once
__device__ __forceinline__ unsigned hmul2_bits(unsigned x, unsigned a) {
  const __nv_bfloat162 p = __hmul2_rn(*reinterpret_cast<const __nv_bfloat162*>(&x),
                                      *reinterpret_cast<const __nv_bfloat162*>(&a));
  return *reinterpret_cast<const unsigned*>(&p);
}

// an edge weight as K9 carries it: f32 bits, or T(a) twice for bf16 pairs
template <typename T>
__device__ __forceinline__ unsigned weight_word(float a) {
  if constexpr (sizeof(T) == 2) return pack_bf16x2(a, a);
  else return __float_as_uint(a);
}

// T(v * a) as a float, for v in T and aw from weight_word: bf16 by one
// __hmul2_rn, in place of the conversion that rounds T(__fmul_rn(v, a))
template <typename T>
__device__ __forceinline__ float product_w(float v, unsigned aw) {
  if constexpr (sizeof(T) == 2) return bf16_lo(hmul2_bits(__float_as_uint(v) >> 16, aw));
  else return __fmul_rn(v, __uint_as_float(aw));
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

// Where K10 reads an edge's source row: ~slot for a cached hub row, else
// its column.
__device__ __forceinline__ int source_code(const int* __restrict__ hub_slot, int c, int hubs) {
  const int slot = hubs > 0 ? hub_slot[c] : -1;
  return (unsigned)slot < (unsigned)hubs ? ~slot : c;
}

// A lane's kCols consecutive columns of a K9 slice row.
template <typename T, bool kVec>
struct LaneRow {
  static constexpr int kVecCols = 16 / sizeof(T);
  static constexpr int kCols = kSliceVecs * kVecCols;
  uint4 q[kVec ? kSliceVecs : 1];
  float s[kVec ? 1 : kCols];

  // the columns at p, n of them inside the row (none if n <= 0)
  __device__ __forceinline__ void load(const T* p, int n) {
    if constexpr (kVec) {
#pragma unroll
      for (int v = 0; v < kSliceVecs; ++v)
        q[v] = v * kVecCols < n ? reinterpret_cast<const uint4*>(p)[v] : make_uint4(0, 0, 0, 0);
    } else {
#pragma unroll
      for (int i = 0; i < kCols; ++i) s[i] = i < n ? maxk::load_f32(p + i) : 0.0f;
    }
  }

  // acc += T(row * a) in f32, element by element; aw from weight_word
  __device__ __forceinline__ void add(float (&acc)[kCols], unsigned aw) const {
    if constexpr (kVec && sizeof(T) == 2) {
#pragma unroll
      for (int v = 0; v < kSliceVecs; ++v) {
        const unsigned w[4] = {q[v].x, q[v].y, q[v].z, q[v].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const unsigned p = hmul2_bits(w[i], aw);
          acc[8 * v + 2 * i] = __fadd_rn(acc[8 * v + 2 * i], bf16_lo(p));
          acc[8 * v + 2 * i + 1] = __fadd_rn(acc[8 * v + 2 * i + 1], bf16_hi(p));
        }
      }
    } else if constexpr (kVec) {
      const float a = __uint_as_float(aw);
#pragma unroll
      for (int v = 0; v < kSliceVecs; ++v) {
        const unsigned w[4] = {q[v].x, q[v].y, q[v].z, q[v].w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[4 * v + i] = __fadd_rn(acc[4 * v + i], __fmul_rn(__uint_as_float(w[i]), a));
      }
    } else {
      const float a = sizeof(T) == 2 ? bf16_lo(aw) : __uint_as_float(aw);
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[i] = __fadd_rn(acc[i], product<T>(s[i], a));
    }
  }
};

// The lane's kCols sums to o, n of them inside the row: rounded to T, or
// f32 for a partial row.
template <typename T, bool kVec, typename O, int kCols>
__device__ __forceinline__ void store_lane(O* __restrict__ o, const float (&acc)[kCols], int n) {
  if constexpr (kVec && sizeof(O) == 4) {
#pragma unroll
    for (int q = 0; q < kCols / 4; ++q)
      if (4 * q < n)
        *reinterpret_cast<float4*>(o + 4 * q) =
            make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
  } else if constexpr (kVec) {
#pragma unroll
    for (int v = 0; v < kCols / 8; ++v)
      if (8 * v < n)
        *reinterpret_cast<uint4*>(o + 8 * v) = make_uint4(
            pack_bf16x2(acc[8 * v], acc[8 * v + 1]), pack_bf16x2(acc[8 * v + 2], acc[8 * v + 3]),
            pack_bf16x2(acc[8 * v + 4], acc[8 * v + 5]), pack_bf16x2(acc[8 * v + 6], acc[8 * v + 7]));
  } else {
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      if (i < n) maxk::store_f32(o + i, acc[i]);
  }
}

// K9: a persistent block walks the column slices in order. For each slice
// its warps take kGroups segments at a time from the slice's counter (the
// next take in flight), a lane group a segment, kBatch edges' row loads in
// flight a lane, added in edge order.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kK9Threads, kK9Blocks)
    spmm_csr_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                    const float* __restrict__ values, const int* __restrict__ seg_row,
                    const int* __restrict__ seg_begin, const int* __restrict__ seg_part,
                    const int* __restrict__ order, const T* __restrict__ x,
                    T* __restrict__ out, float* __restrict__ part, int* __restrict__ counters,
                    int nseg, int seg_edges, int dim) {
  using Row = LaneRow<T, kVec>;
  constexpr int kLane = Row::kCols;
  constexpr int kSlice = kGroupLanes * kLane;
  // a group's batch: a column and weight each of its first kBatch lanes
  // (fewer for wide slices and element loads, to keep the batch's rows in
  // registers)
  constexpr int kBatch = kVec && kSliceVecs <= 2 ? kGroupLanes : kGroupLanes / 2;
  const int lane = threadIdx.x & 31;
  const int grp = lane / kGroupLanes, lg = lane % kGroupLanes, src0 = grp * kGroupLanes;
  const int c0 = lg * kLane;  // the lane's first column in a slice
  const int takes = (nseg + kGroups - 1) / kGroups;
#pragma unroll 1
  for (int t0 = 0, sl = 0; t0 < dim; t0 += kSlice, ++sl) {
    const int w = dim - t0 < kSlice ? dim - t0 : kSlice;
    int g = lane == 0 ? atomicAdd(counters + sl, 1) : 0;
    g = __shfl_sync(maxk::kFull, g, 0);
#pragma unroll 1
    while (g < takes) {
      const int next = lane == 0 ? atomicAdd(counters + sl, 1) : 0;
      const int oi = g * kGroups + grp;
      Segment sg{0, 0, 0, -1};
      if (oi < nseg) sg = segment(indptr, seg_row, seg_begin, seg_part, order[oi], seg_edges);
      const int n = (int)(sg.end - sg.begin);
      const int nmax = __reduce_max_sync(maxk::kFull, n);
      float acc[kLane];
#pragma unroll
      for (int i = 0; i < kLane; ++i) acc[i] = 0.0f;
      // batch b's rows and b + 2's columns in flight: this lane's edge of
      // each batch is e0 + lg
      int c = 0, c1 = 0, c2 = 0;
      unsigned aw = 0;
      float a1 = 0.0f, a2 = 0.0f;
      const bool meta = lg < kBatch;
      if (meta && lg < n) {
        c = indices[sg.begin + lg];
        aw = weight_word<T>(values[sg.begin + lg]);
      }
      if (meta && kBatch + lg < n) {
        c1 = indices[sg.begin + kBatch + lg];
        a1 = values[sg.begin + kBatch + lg];
      }
#pragma unroll 1
      for (int e0 = 0; e0 < nmax; e0 += kBatch) {
        if (meta && e0 + 2 * kBatch + lg < n) {
          c2 = indices[sg.begin + e0 + 2 * kBatch + lg];
          a2 = values[sg.begin + e0 + 2 * kBatch + lg];
        }
        Row r[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int cu = __shfl_sync(maxk::kFull, c, src0 + u);
          if (e0 + u < n) r[u].load(x + (int64_t)cu * dim + t0 + c0, w - c0);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const unsigned au = __shfl_sync(maxk::kFull, aw, src0 + u);
          if (e0 + u < n) r[u].add(acc, au);
        }
        c = c1;
        aw = weight_word<T>(a1);
        c1 = c2;
        a1 = a2;
      }
      if (oi < nseg && c0 < w) {
        if (sg.part < 0)
          store_lane<T, kVec>(out + (int64_t)sg.row * dim + t0 + c0, acc, w - c0);
        else
          store_lane<T, kVec>(part + (int64_t)sg.part * dim + t0 + c0, acc, w - c0);
      }
      g = __shfl_sync(maxk::kFull, next, 0);
    }
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
// row's values at the columns it touches, one slot each, the selectors as
// int16 (dim < 32768). A slot's loop reads the row's selectors at one
// address for the warp (a broadcast).
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    cbsr_merge_kernel(const T* __restrict__ vals, const int* __restrict__ sel,
                      T* __restrict__ mvals, short* __restrict__ msel, int rows, int k, int dim) {
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
      msel[r * k + l] = (short)(keep ? c : -1);
      maxk::store_f32(mvals + r * k + l, keep ? acc : 0.0f);
    }
  }
}

// K10: a persistent grid of kK10Blocks blocks an SM, each holding the hub
// rows' merged slots in shared memory; its warps take `grab` segments at a
// time from the counter, in the work order. A warp's segment sums into `tw` columns of the tile at
// t0 of the warp's shared f32 row `acc`, over the merged CBSR (no column
// twice in a row, so an edge's slots add into distinct columns; a
// `__syncwarp` orders the edges). kOneChunk (k <= 32): lane l loads slot l
// of U edges' source rows at once; else each edge's slots are walked 32 at
// a time.
template <typename T, bool kOneChunk, int U>
__global__ void __launch_bounds__(kK10Threads, kK10Blocks)
    spgemm_cbsr_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                       const float* __restrict__ values, const int* __restrict__ seg_row,
                       const int* __restrict__ seg_begin, const int* __restrict__ seg_part,
                       const int* __restrict__ order, const int* __restrict__ hub_rows,
                       const int* __restrict__ hub_slot, const T* __restrict__ mvals,
                       const short* __restrict__ msel, T* __restrict__ out,
                       float* __restrict__ part, int* __restrict__ counter, int nseg,
                       int seg_edges, int grab, int hubs, int k, int dim, int tile,
                       int stride) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  float* acc = reinterpret_cast<float*>(smem4) + (threadIdx.x >> 5) * stride;
  // the hub rows' merged slots: selectors, then (16-byte aligned) values
  short* csel = reinterpret_cast<short*>(reinterpret_cast<float*>(smem4) + kK10Warps * stride);
  T* cvals = reinterpret_cast<T*>(csel + (hubs * k + 7) / 8 * 8);
  // kFill slots' loads in flight a thread
  constexpr int kFill = 8;
#pragma unroll 1
  for (int i0 = threadIdx.x; i0 < hubs * k; i0 += kFill * kK10Threads) {
    short sv[kFill];
    T vv[kFill];
#pragma unroll
    for (int u = 0; u < kFill; ++u) {
      const int i = i0 + u * kK10Threads;
      if (i < hubs * k) {
        const int64_t src = (int64_t)hub_rows[i / k] * k + i % k;
        sv[u] = msel[src];
        vv[u] = mvals[src];
      }
    }
#pragma unroll
    for (int u = 0; u < kFill; ++u) {
      const int i = i0 + u * kK10Threads;
      if (i < hubs * k) {
        csel[i] = sv[u];
        cvals[i] = vv[u];
      }
    }
  }
  __syncthreads();
  const int takes = (nseg + grab - 1) / grab;
  int g = lane == 0 ? atomicAdd(counter, 1) : 0;
  g = __shfl_sync(maxk::kFull, g, 0);
#pragma unroll 1
  while (g < takes) {
    const int next = lane == 0 ? atomicAdd(counter, 1) : 0;
#pragma unroll 1
    for (int oi = g * grab; oi < g * grab + grab && oi < nseg; ++oi) {
      const Segment sg = segment(indptr, seg_row, seg_begin, seg_part, order[oi], seg_edges);
#pragma unroll 1
      for (int t0 = 0; t0 < dim; t0 += tile) {
        const int tw = dim - t0 < tile ? dim - t0 : tile;
#pragma unroll 1
        for (int c = lane; c < tw; c += 32) acc[c] = 0.0f;
        __syncwarp();
#pragma unroll 1
        for (int64_t e0 = sg.begin; e0 < sg.end; e0 += 32) {
          const int n = sg.end - e0 < 32 ? (int)(sg.end - e0) : 32;
          int code = 0;
          unsigned aw = 0;
          if (lane < n) {
            code = source_code(hub_slot, indices[e0 + lane], hubs);
            aw = weight_word<T>(values[e0 + lane]);
          }
          if constexpr (kOneChunk) {
            // slot `lane` of edges j..j + U - 1's source rows (shared or global)
            auto load = [&](int j, int (&sc)[U], float (&v)[U]) {
#pragma unroll
              for (int u = 0; u < U; ++u) {
                const int cu = __shfl_sync(maxk::kFull, code, (j + u) & 31);
                sc[u] = -1;
                v[u] = 0.0f;
                if (j + u < n && lane < k) {
                  const int64_t off = (cu < 0 ? (int64_t)~cu : (int64_t)cu) * k + lane;
                  if (cu < 0) {
                    sc[u] = csel[off];
                    v[u] = maxk::load_f32(cvals + off);
                  } else {
                    sc[u] = __ldg(msel + off);
                    v[u] = maxk::load_f32(mvals + off);
                  }
                }
              }
            };
            int sc[U], scn[U];
            float v[U], vn[U];
            load(0, sc, v);
#pragma unroll 1
            for (int j = 0; j < n; j += U) {
              if (j + U < n) load(j + U, scn, vn);  // the next edges' slots in flight
#pragma unroll
              for (int u = 0; u < U; ++u) {
                const unsigned au = __shfl_sync(maxk::kFull, aw, (j + u) & 31);
                if (j + u < n) {  // warp-uniform
                  const int col = sc[u] - t0;
                  if (sc[u] >= t0 && col < tw) acc[col] = __fadd_rn(acc[col], product_w<T>(v[u], au));
                  __syncwarp();
                }
              }
#pragma unroll
              for (int u = 0; u < U; ++u) {
                sc[u] = scn[u];
                v[u] = vn[u];
              }
            }
          } else {
#pragma unroll 1
            for (int j = 0; j < n; ++j) {
              const int cu = __shfl_sync(maxk::kFull, code, j);
              const unsigned au = __shfl_sync(maxk::kFull, aw, j);
              const int64_t base = (cu < 0 ? (int64_t)~cu : (int64_t)cu) * k;
#pragma unroll 1
              for (int l = lane; l < k; l += 32) {
                int sc;
                float vl;
                if (cu < 0) {
                  sc = csel[base + l];
                  vl = maxk::load_f32(cvals + base + l);
                } else {
                  sc = __ldg(msel + base + l);
                  vl = maxk::load_f32(mvals + base + l);
                }
                const int col = sc - t0;
                if (sc >= t0 && col < tw) acc[col] = __fadd_rn(acc[col], product_w<T>(vl, au));
              }
              __syncwarp();
            }
          }
        }
        if (sg.part < 0) {
          T* o = out + (int64_t)sg.row * dim + t0;
#pragma unroll 1
          for (int c = lane; c < tw; c += 32) maxk::store_f32(o + c, acc[c]);
        } else {
          float* o = part + (int64_t)sg.part * dim + t0;
#pragma unroll 1
          for (int c = lane; c < tw; c += 32) o[c] = acc[c];
        }
        __syncwarp();  // the next tile zeroes what the writes read
      }
    }
    g = __shfl_sync(maxk::kFull, next, 0);
  }
}

// K11's bf16 products two edges at a time: acc += T(x0 * a0), then (where
// `has1`) T(x1 * a1), by one __hmul2_rn; x0, x1 bf16 bits in the low half,
// ap = T(a0) | T(a1) << 16. Bit-equal to T(__fmul_rn) a product.
__device__ __forceinline__ void add_bf16_pair(float& acc, unsigned x0, unsigned x1, unsigned ap,
                                              bool has1) {
  const unsigned p = hmul2_bits(__byte_perm(x0, x1, 0x5410), ap);
  acc = __fadd_rn(acc, bf16_lo(p));
  if (has1) acc = __fadd_rn(acc, bf16_hi(p));
}

// K11: its grid walks g's column slices (`slice` columns) in order: a
// persistent grid where there are several, else a warp a unit. For each
// slice its warps take units of kSegs segments in the work order (`work`: each segment's row, first edge, edge count and partial row
// in one 16-byte load), the long ones from the slice's counter and the
// short ones in turn, a lane group of G lanes a segment of row j of A^T, S
// slots a lane (slot l0 + s·G + lane of the group). A slot belongs to the
// slice its selector falls in (one outside [0, dim) to the first, as 0).
// The segment's edges are walked once a slice for all G·S slots: their
// columns and weights G at a time (a batch, an edge a lane of the group),
// two batches ahead; their gathers kU edges at a time (a chunk), the next
// chunk's in flight while the current one's are added in edge order where
// kPipe; a slice in which no slot of the warp's segments gathers is not
// walked. Where S > 1 and a segment of the warp has kSortMin edges or
// more, each group first orders its slots by selector (ranks, then a
// scatter through shared memory), so gather s of an edge reads the sectors
// of the s-th G columns in order and no two gathers of an edge read the
// same sector twice.
template <typename T, int G, int S>
__global__ void __launch_bounds__(kK11Threads, kK11BlocksOf<T, G, S>)
    sspmm_cbsr_kernel(const int* __restrict__ indices, const float* __restrict__ values,
                      const int4* __restrict__ work, const T* __restrict__ gr,
                      const int* __restrict__ sel, T* __restrict__ out, float* __restrict__ part,
                      int* __restrict__ counters, int nseg, int long_segs, int k, int dim,
                      int slice) {
  constexpr bool kPair = sizeof(T) == 2;
  constexpr bool kPipe = kK11Pipelined<T, G, S>;  // the next chunk's gathers in flight
  constexpr int kSegs = 32 / G;
  // edges a chunk: kK11Chunk gathers a lane, at least a bf16 pair
  constexpr int kU = kK11Chunk / S < 2 ? 2 : kK11Chunk / S < G ? kK11Chunk / S : G;
  static_assert(G % kU == 0, "a chunk lies inside a batch");
  __shared__ int2 ranked[S > 1 ? kK11Warps : 1][S > 1 ? 32 * S : 1];
  const int lane = threadIdx.x & 31;
  const int grp = lane / G, lg = lane % G, src0 = grp * G;
  const int units = (nseg + kSegs - 1) / kSegs;
  // raw bits of g's elements: f32, or bf16 in the low half
  using Raw = std::conditional_t<kPair, unsigned short, float>;
  const Raw* graw = reinterpret_cast<const Raw*>(gr);
  // the group's segment of a unit: (row, first edge, edges, part), no edges
  // past the table
  auto segment_of = [&](int unit) {
    const int os = unit * kSegs + grp;
    return os < nseg ? work[os] : make_int4(0, 0, 0, -1);
  };
  // units [0, dyn), whose segments are long (`long_segs`, the first of the
  // work order), where there are at least as many as warps: warp w of W
  // takes unit w, then one at a time from the slice's counter (W + its
  // count), which evens out the warps' loads; the short units after them go
  // round in turn, dyn + w, dyn + w + W, ..., since there a queued atomic
  // would cost as much as the unit (every unit from the counter: 1.5x
  // slower at 65,536 short segments)
  const int nwarps = gridDim.x * kK11Warps;
  const int gw = blockIdx.x * kK11Warps + (threadIdx.x >> 5);
  const int dyn_units = (long_segs + kSegs - 1) / kSegs;
  const int dyn = dyn_units >= nwarps ? dyn_units : 0;  // fewer than a warp each: all in turn
#pragma unroll 1
  for (int t0 = 0, sl = 0; t0 < dim; t0 += slice, ++sl) {
    int* ctr = counters + sl;
    auto next = [&](int unit) {
      if (unit >= dyn) return unit + nwarps;
      const int u = nwarps + __shfl_sync(maxk::kFull, lane == 0 ? atomicAdd(ctr, 1) : 0, 0);
      return u < dyn ? u : dyn + gw;
    };
#pragma unroll 1
    for (int unit = gw < dyn ? gw : dyn + gw; unit < units; unit = next(unit)) {
      const int4 wk = segment_of(unit);
      const int row = wk.x, n = wk.z, own = wk.w;
      const int64_t begin = wk.y;
      const bool has = unit * kSegs + grp < nseg;
      const int nmax = __reduce_max_sync(maxk::kFull, n);
#pragma unroll 1
      for (int l0 = 0; l0 < k; l0 += G * S) {
        int slot[S], col[S];  // the lane's slots and their selectors, -1 outside [0, dim)
#pragma unroll
        for (int s = 0; s < S; ++s) {
          slot[s] = l0 + s * G + lg;
          const int c = has && slot[s] < k ? sel[(int64_t)row * k + slot[s]] : -1;
          col[s] = (unsigned)c < (unsigned)dim ? c : -1;  // never an address outside the row
        }
        if constexpr (S > 1) {
          if (nmax >= kSortMin) {  // warp-uniform
            // rank in the group by (selector, slot): one outside [0, dim)
            // above all others, slots past k last
            int key[S], rank[S];
#pragma unroll
            for (int s = 0; s < S; ++s) {
              key[s] = slot[s] >= k ? 0x7fffffff : col[s] < 0 ? dim : col[s];
              rank[s] = 0;
            }
#pragma unroll
            for (int s2 = 0; s2 < S; ++s2) {
#pragma unroll 4
              for (int i = 0; i < G; ++i) {
                const int kt = __shfl_sync(maxk::kFull, key[s2], src0 + i);
#pragma unroll
                for (int s = 0; s < S; ++s)
                  rank[s] += kt < key[s] || (kt == key[s] && s2 * G + i < s * G + lg);
              }
            }
            int2* r = ranked[threadIdx.x >> 5] + grp * G * S;
#pragma unroll
            for (int s = 0; s < S; ++s) r[rank[s]] = make_int2(slot[s], col[s]);
            __syncwarp();
#pragma unroll
            for (int s = 0; s < S; ++s) {
              const int2 v = r[s * G + lg];
              slot[s] = v.x;
              col[s] = v.y;
            }
            __syncwarp();  // the next scatter overwrites what this read
          }
        }
        // the lane's slots of this slice, and those among them that gather
        bool mine[S], live[S];
        bool any = false;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          mine[s] = col[s] < 0 ? t0 == 0 : col[s] >= t0 && col[s] - t0 < slice;
          live[s] = mine[s] && col[s] >= 0;
          any |= live[s];
        }
        float acc[S];
#pragma unroll
        for (int s = 0; s < S; ++s) acc[s] = 0.0f;
        if (__any_sync(maxk::kFull, any)) {  // else the slice's slots sum to 0
          // batch b's columns and weights (c, w), b + 1's and b + 2's in
          // flight: lane lg holds edge e0 + lg of each; w holds f32 bits,
          // or T(a) in the low half (wp: bf16 edges lg, lg + 1 as a pair)
          int c = 0, c1 = 0, c2 = 0;
          unsigned w = 0, w1 = 0, w2 = 0;
          auto fetch = [&](int e, int& cc, unsigned& ww) {
            if (e + lg < n) {
              cc = indices[begin + e + lg];
              const float a = values[begin + e + lg];
              ww = kPair ? __bfloat16_as_ushort(__float2bfloat16_rn(a)) : __float_as_uint(a);
            }
          };
          auto pair = [&](unsigned x) {
            return kPair ? __byte_perm(x, __shfl_down_sync(maxk::kFull, x, 1), 0x5410) : x;
          };
          fetch(0, c, w);
          fetch(G, c1, w1);
          fetch(2 * G, c2, w2);
          unsigned wp = pair(w);
          // chunk j: edges [j, j + kU) of the batch at j & ~(G - 1), their
          // gathers into v (kPipe: the next chunk's into vn while v's are
          // added)
          Raw v[kU][S], vn[kPipe ? kU : 1][kPipe ? S : 1];
          auto gather = [&](int j, int cc, Raw(&r)[kU][S]) {
#pragma unroll
            for (int u = 0; u < kU; ++u) {
              const int64_t cu = __shfl_sync(maxk::kFull, cc, src0 + (j & (G - 1)) + u);
#pragma unroll
              for (int s = 0; s < S; ++s)
                r[u][s] = j + u < n && live[s] ? graw[cu * dim + col[s]] : Raw(0);
            }
          };
          if constexpr (kPipe) gather(0, c, v);
#pragma unroll 1
          for (int j = 0; j < nmax; j += kU) {
            const int jn = j + kU;
            const bool turn = (jn & (G - 1)) == 0;  // the next chunk opens a batch
            if constexpr (kPipe) {
              if (jn < nmax) gather(jn, turn ? c1 : c, vn);
            } else {
              gather(j, c, v);
            }
            const int u0 = src0 + (j & (G - 1));
#pragma unroll
            for (int u = 0; u < kU; u += 2) {
              const bool has0 = j + u < n, has1 = j + u + 1 < n;
              if constexpr (kPair) {
                const unsigned ap = __shfl_sync(maxk::kFull, wp, u0 + u);
#pragma unroll
                for (int s = 0; s < S; ++s)
                  if (has0 && live[s]) add_bf16_pair(acc[s], v[u][s], v[u + 1][s], ap, has1);
              } else {
                const float a0 = __uint_as_float(__shfl_sync(maxk::kFull, w, u0 + u));
                const float a1 = __uint_as_float(__shfl_sync(maxk::kFull, w, u0 + u + 1));
#pragma unroll
                for (int s = 0; s < S; ++s) {
                  if (has0 && live[s]) acc[s] = __fadd_rn(acc[s], __fmul_rn(v[u][s], a0));
                  if (has1 && live[s]) acc[s] = __fadd_rn(acc[s], __fmul_rn(v[u + 1][s], a1));
                }
              }
            }
            if (turn) {
              c = c1;
              w = w1;
              c1 = c2;
              w1 = w2;
              fetch(jn + 2 * G, c2, w2);
              wp = pair(w);
            }
            if constexpr (kPipe) {
#pragma unroll
              for (int u = 0; u < kU; ++u)
#pragma unroll
                for (int s = 0; s < S; ++s) v[u][s] = vn[u][s];
            }
          }
        }
        if (has) {
#pragma unroll
          for (int s = 0; s < S; ++s) {
            if (!mine[s] || slot[s] >= k) continue;
            if (own < 0)
              maxk::store_f32(out + (int64_t)row * k + slot[s], acc[s]);
            else
              part[(int64_t)own * k + slot[s]] = acc[s];
          }
        }
      }
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

// A CSR and its segment table: K10 takes all of it, K9 no hub table, K11
// the segments in work order as one table (`work`) in place of `order`.
struct Csr {
  const int *indptr, *indices;
  const float* values;
  const int *seg_row, *seg_begin, *seg_part, *multi_row, *multi_part0, *multi_nseg;
  const int *order, *hub_rows, *hub_slot;
  const int4* work;
};

Csr csr_of(const void* indptr, const void* indices, const void* values, const void* seg_row,
           const void* seg_begin, const void* seg_part, const void* multi_row,
           const void* multi_part0, const void* multi_nseg, const void* order = nullptr,
           const void* hub_rows = nullptr, const void* hub_slot = nullptr) {
  return Csr{static_cast<const int*>(indptr),    static_cast<const int*>(indices),
             static_cast<const float*>(values),  static_cast<const int*>(seg_row),
             static_cast<const int*>(seg_begin), static_cast<const int*>(seg_part),
             static_cast<const int*>(multi_row), static_cast<const int*>(multi_part0),
             static_cast<const int*>(multi_nseg), static_cast<const int*>(order),
             static_cast<const int*>(hub_rows),  static_cast<const int*>(hub_slot), nullptr};
}

// A persistent grid of at most `per_sm` blocks an SM, and no more blocks
// than `units` units of work at `warps` a block need.
unsigned persistent_blocks(int per_sm, int64_t units, int warps) {
  const int sms = maxk::device_attribute<cudaDevAttrMultiProcessorCount>();
  const int64_t need = (units + warps - 1) / warps;
  return (unsigned)(need < (int64_t)sms * per_sm ? need : (int64_t)sms * per_sm);
}

template <typename T, bool kVec>
int launch_slices(const Csr& a, const T* x, T* out, float* part, int* counters, int nseg,
                  int seg_edges, int dim, cudaStream_t stream) {
  const unsigned blocks = persistent_blocks(kK9Blocks, (nseg + kGroups - 1) / kGroups, kK9Warps);
  if (blocks < 1) return (int)cudaErrorInvalidDevice;
  spmm_csr_kernel<T, kVec><<<blocks, kK9Threads, 0, stream>>>(
      a.indptr, a.indices, a.values, a.seg_row, a.seg_begin, a.seg_part, a.order, x, out, part,
      counters, nseg, seg_edges, dim);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_spmm(const Csr& a, const void* x, void* out, void* part, void* counters, int nseg,
                int nmulti, int seg_edges, int nctr, int dim, cudaStream_t stream) {
  constexpr int kSliceCols = kGroupLanes * kSliceVecs * 16 / (int)sizeof(T);
  if (nseg <= 0 || seg_edges < 1 || dim < 1 || nctr < (dim + kSliceCols - 1) / kSliceCols)
    return (int)cudaErrorInvalidValue;
  // 16-byte vectors where a row's bytes and both pointers allow (the
  // partial rows then allow them too)
  const bool vec = (int64_t)dim * sizeof(T) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  float* p = static_cast<float*>(part);
  int* ctr = static_cast<int*>(counters);
  const int err = vec ? launch_slices<T, true>(a, xt, o, p, ctr, nseg, seg_edges, dim, stream)
                      : launch_slices<T, false>(a, xt, o, p, ctr, nseg, seg_edges, dim, stream);
  if (err != 0) return err;
  return launch_combine<T>(part, a.multi_row, a.multi_part0, a.multi_nseg, out, nmulti, dim,
                           stream);
}

template <typename T, bool kOneChunk, int U>
int launch_spgemm_kernel(const Csr& a, const T* mv, const short* ms, T* o, float* p, int* ctr,
                         int nseg, int seg_edges, int hubs, int k, int dim, int tile, int stride,
                         size_t smem, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(spgemm_cbsr_kernel<T, kOneChunk, U>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kBlockSmem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = persistent_blocks(kK10Blocks, nseg, kK10Warps);
  if (blocks < 1) return (int)cudaErrorInvalidDevice;
  const int64_t fill = (int64_t)nseg / ((int64_t)blocks * kK10Warps * kMinTakes);
  const int grab = fill < 1 ? 1 : fill < kGrab ? (int)fill : kGrab;
  spgemm_cbsr_kernel<T, kOneChunk, U><<<blocks, kK10Threads, smem, stream>>>(
      a.indptr, a.indices, a.values, a.seg_row, a.seg_begin, a.seg_part, a.order, a.hub_rows,
      a.hub_slot, mv, ms, o, p, ctr, nseg, seg_edges, grab, hubs, k, dim, tile, stride);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_spgemm(const Csr& a, const void* vals, const void* sel, void* mvals, void* msel,
                  void* out, void* part, void* counters, int nseg, int nmulti, int seg_edges,
                  int nctr, int hubs, int k, int dim, int rows, cudaStream_t stream) {
  if (nseg <= 0 || seg_edges < 1 || nctr < 1 || k < 1 || dim < 1 || dim > 32767 || rows < 0 ||
      hubs < 0)
    return (int)cudaErrorInvalidValue;
  T* mv = static_cast<T*>(mvals);
  short* ms = static_cast<short*>(msel);
  if (rows > 0) {
    cbsr_merge_kernel<T><<<blocks_for(rows), kWarps * 32, 0, stream>>>(
        static_cast<const T*>(vals), static_cast<const int*>(sel), mv, ms, rows, k, dim);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const int max_tile = kAccBytes / kK10Blocks / (kK10Warps * (int)sizeof(float));
  const int tile = dim < max_tile ? dim : max_tile;
  const int stride = (tile + 3) / 4 * 4;
  const int64_t acc_bytes = (int64_t)kK10Warps * stride * sizeof(float);
  // the hub rows' merged slots: k int16 selectors, then (16-byte aligned) k values a row
  const int64_t fit = (kBlockSmem - acc_bytes - 16) / ((int64_t)k * (int64_t)(2 + sizeof(T)));
  const int cached = hubs < fit ? hubs : (int)fit;
  const size_t smem = acc_bytes + ((int64_t)cached * k + 7) / 8 * 16 + (int64_t)cached * k * sizeof(T);
  T* o = static_cast<T*>(out);
  float* p = static_cast<float*>(part);
  int* ctr = static_cast<int*>(counters);
  const int err =
      k <= 32 ? launch_spgemm_kernel<T, true, 8>(a, mv, ms, o, p, ctr, nseg, seg_edges, cached, k,
                                                 dim, tile, stride, smem, stream)
              : launch_spgemm_kernel<T, false, 1>(a, mv, ms, o, p, ctr, nseg, seg_edges, cached, k,
                                                  dim, tile, stride, smem, stream);
  if (err != 0) return err;
  return launch_combine<T>(part, a.multi_row, a.multi_part0, a.multi_nseg, out, nmulti, dim,
                           stream);
}

template <typename T, int G, int S>
int launch_sspmm_kernel(const Csr& a, const T* g, const int* sel, T* o, float* p, int* ctr,
                        int nseg, int long_segs, int k, int dim, int slice, cudaStream_t stream) {
  const int64_t units = (nseg + 32 / G - 1) / (32 / G);
  // a walk in slices: a persistent grid, every SM on one slice at a time; a
  // walk of whole rows: a warp a unit, the block scheduler dealing the
  // blocks out in the work order as SMs free up (bench/ablate_csr.py: a
  // persistent grid over whole rows up to 1.24x slower, at most 4% faster;
  // a warp a unit in slices 1.12-1.27x slower)
  const unsigned blocks = slice < dim ? persistent_blocks(kK11BlocksOf<T, G, S>, units, kK11Warps)
                                      : (unsigned)((units + kK11Warps - 1) / kK11Warps);
  if (blocks < 1) return (int)cudaErrorInvalidDevice;
  sspmm_cbsr_kernel<T, G, S><<<blocks, kK11Threads, 0, stream>>>(
      a.indices, a.values, a.work, g, sel, o, p, ctr, nseg, long_segs, k, dim, slice);
  return (int)cudaGetLastError();
}

// K11's column slice, where it walks g in slices, for features of
// `itemsize` bytes: kK11SliceBytes a row
int k11_slice_cols(int itemsize) { return kK11SliceBytes / itemsize; }

template <typename T>
int launch_sspmm(const Csr& a, const void* g, const void* sel, void* out, void* part,
                 void* counters, int nseg, int nmulti, int nctr, int long_segs, int k, int dim,
                 int slice, cudaStream_t stream) {
  if (nseg <= 0 || long_segs < 0 || k < 1 || dim < 1 || slice < 1 || counters == nullptr ||
      nctr < (dim - 1) / slice + 1 || a.work == nullptr ||
      reinterpret_cast<uintptr_t>(a.work) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const T* gt = static_cast<const T*>(g);
  const int* st = static_cast<const int*>(sel);
  T* o = static_cast<T*>(out);
  float* p = static_cast<float*>(part);
  int* ctr = static_cast<int*>(counters);
  // the lane layout: a segment's lanes, and slots a lane (past G·S slots
  // the edges are walked again for the next G·S); 16 lanes of 2 slots at
  // k <= 32, or 8 of 4, measured slower than a warp of one
  const int lanes = k <= 8 ? 8 : k <= 16 ? 16 : 32;
  const int slots = k <= 32 ? 1 : k <= 64 ? 2 : 4;
  int err = (int)cudaErrorInvalidValue;
#define K11_LAYOUT(G, S)                                                                   \
  if (lanes == G && slots == S)                                                            \
    err = launch_sspmm_kernel<T, G, S>(a, gt, st, o, p, ctr, nseg, long_segs, k, dim, slice,  \
                                       stream);
  K11_LAYOUT(8, 1) K11_LAYOUT(16, 1) K11_LAYOUT(32, 1) K11_LAYOUT(32, 2) K11_LAYOUT(32, 4)
#undef K11_LAYOUT
  if (err != 0) return err;
  return launch_combine<T>(part, a.multi_row, a.multi_part0, a.multi_nseg, out, nmulti, k,
                           stream);
}

}  // namespace

// C interface (ctypes). Each takes the CSR (indptr, indices, values) and
// its segment table (row, begin, part; multi_row, multi_part0, multi_nseg;
// the work order (K11: the `work` table, 16-byte aligned, in its place),
// and `nctr` zeroed int counters: K9 one for each column
// slice, `csr_kernels_layout`'s slice_cols columns wide, K10 one, K11 one
// for each of its column slices, `slice` columns wide (the whole row, or
// the layout's k11_slice); fewer, or none, is an invalid value; K11 also
// the table's long segments, and reads each segment's edges from `work`,
// not seg_edges), launches its kernel and, for rows of
// several segments, the combine kernel, and returns the cudaError_t of the
// launches. K10 also takes the
// hub table (hub_rows, hub_slot; `hubs` its length, 0 for none, and then
// both may be null); its merged CBSR (mvals, msel) is (rows, k) T and
// int16, and dim must be below 32768.
extern "C" int spmm_csr_f32(const void* indptr, const void* indices, const void* values,
                            const void* seg_row, const void* seg_begin, const void* seg_part,
                            const void* multi_row, const void* multi_part0, const void* multi_nseg,
                            const void* order, const void* x, void* out, void* part,
                            void* counters, int nseg, int nmulti, int seg_edges, int nctr,
                            int dim, void* stream) {
  const Csr a = csr_of(indptr, indices, values, seg_row, seg_begin, seg_part, multi_row,
                       multi_part0, multi_nseg, order);
  return launch_spmm<float>(a, x, out, part, counters, nseg, nmulti, seg_edges, nctr, dim,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int spmm_csr_bf16(const void* indptr, const void* indices, const void* values,
                             const void* seg_row, const void* seg_begin, const void* seg_part,
                             const void* multi_row, const void* multi_part0, const void* multi_nseg,
                             const void* order, const void* x, void* out, void* part,
                             void* counters, int nseg, int nmulti, int seg_edges, int nctr,
                             int dim, void* stream) {
  const Csr a = csr_of(indptr, indices, values, seg_row, seg_begin, seg_part, multi_row,
                       multi_part0, multi_nseg, order);
  return launch_spmm<__nv_bfloat16>(a, x, out, part, counters, nseg, nmulti, seg_edges, nctr,
                                    dim, static_cast<cudaStream_t>(stream));
}

extern "C" int spgemm_cbsr_f32(const void* indptr, const void* indices, const void* values,
                               const void* seg_row, const void* seg_begin, const void* seg_part,
                               const void* multi_row, const void* multi_part0, const void* multi_nseg,
                               const void* order, const void* hub_rows, const void* hub_slot,
                               const void* vals, const void* sel, void* mvals, void* msel, void* out,
                               void* part, void* counters, int nseg, int nmulti, int seg_edges,
                               int nctr, int hubs, int k, int dim, int rows, void* stream) {
  const Csr a = csr_of(indptr, indices, values, seg_row, seg_begin, seg_part, multi_row,
                       multi_part0, multi_nseg, order, hub_rows, hub_slot);
  return launch_spgemm<float>(a, vals, sel, mvals, msel, out, part, counters, nseg, nmulti,
                              seg_edges, nctr, hubs, k, dim, rows,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int spgemm_cbsr_bf16(const void* indptr, const void* indices, const void* values,
                                const void* seg_row, const void* seg_begin, const void* seg_part,
                                const void* multi_row, const void* multi_part0, const void* multi_nseg,
                                const void* order, const void* hub_rows, const void* hub_slot,
                                const void* vals, const void* sel, void* mvals, void* msel, void* out,
                                void* part, void* counters, int nseg, int nmulti, int seg_edges,
                                int nctr, int hubs, int k, int dim, int rows, void* stream) {
  const Csr a = csr_of(indptr, indices, values, seg_row, seg_begin, seg_part, multi_row,
                       multi_part0, multi_nseg, order, hub_rows, hub_slot);
  return launch_spgemm<__nv_bfloat16>(a, vals, sel, mvals, msel, out, part, counters, nseg,
                                      nmulti, seg_edges, nctr, hubs, k, dim, rows,
                                      static_cast<cudaStream_t>(stream));
}

// K9's and K11's column slices (columns) for features of `itemsize` bytes,
// and the hub rows K10 holds in shared memory for k slots at dim columns
// (what a launch with a long enough hub table keeps there).
extern "C" int csr_kernels_layout(int itemsize, int k, int dim, int* slice_cols, int* k10_rows,
                                  int* k11_slice) {
  if ((itemsize != 2 && itemsize != 4) || k < 1 || dim < 1) return (int)cudaErrorInvalidValue;
  *slice_cols = kGroupLanes * kSliceVecs * 16 / itemsize;
  *k11_slice = k11_slice_cols(itemsize);
  const int max_tile = kAccBytes / kK10Blocks / (kK10Warps * (int)sizeof(float));
  const int stride = ((dim < max_tile ? dim : max_tile) + 3) / 4 * 4;
  *k10_rows = (int)((kBlockSmem - (int64_t)kK10Warps * stride * 4 - 16) / ((int64_t)k * (2 + itemsize)));
  return (int)cudaSuccess;
}

extern "C" int sspmm_cbsr_f32(const void* indptr, const void* indices, const void* values,
                              const void* seg_row, const void* seg_begin, const void* seg_part,
                              const void* multi_row, const void* multi_part0, const void* multi_nseg,
                              const void* work, const void* g, const void* sel, void* out,
                              void* part, void* counters, int nseg, int nmulti, int seg_edges,
                              int nctr, int long_segs, int k, int dim, int slice,
                              void* stream) {
  Csr a = csr_of(indptr, indices, values, seg_row, seg_begin, seg_part, multi_row, multi_part0,
                 multi_nseg);
  a.work = static_cast<const int4*>(work);
  return launch_sspmm<float>(a, g, sel, out, part, counters, nseg, nmulti, nctr, long_segs, k,
                             dim, slice, static_cast<cudaStream_t>(stream));
}

extern "C" int sspmm_cbsr_bf16(const void* indptr, const void* indices, const void* values,
                               const void* seg_row, const void* seg_begin, const void* seg_part,
                               const void* multi_row, const void* multi_part0, const void* multi_nseg,
                               const void* work, const void* g, const void* sel, void* out,
                               void* part, void* counters, int nseg, int nmulti, int seg_edges,
                               int nctr, int long_segs, int k, int dim, int slice,
                               void* stream) {
  Csr a = csr_of(indptr, indices, values, seg_row, seg_begin, seg_part, multi_row, multi_part0,
                 multi_nseg);
  a.work = static_cast<const int4*>(work);
  return launch_sspmm<__nv_bfloat16>(a, g, sel, out, part, counters, nseg, nmulti, nctr,
                                     long_segs, k, dim, slice, static_cast<cudaStream_t>(stream));
}
