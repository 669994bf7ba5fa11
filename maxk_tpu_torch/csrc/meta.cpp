// Host-side preprocessing of maxk_tpu_torch: the edge-tile schedule builder
// and a CSR transpose, plain C ABI, loaded through ctypes by
// maxk_tpu_torch/sparse/_native.py (built there with the host C++ compiler
// at first use). Port of the JAX package's csrc/meta.cpp: the same
// functions, the same arithmetic, so the tables are bit-equal to its own.
// Every function is single-threaded, allocates nothing the caller does not
// see, and is deterministic.

#include <cstdint>
#include <cstring>

extern "C" {

// ---- edge tiles (maxk_tpu_torch/sparse/meta.py holds the layout) ----

// Pass 1: the number of tiles for row blocks of `row_block` rows. Every
// block gets at least one tile (an empty block an all-padding one, so
// every output block is written).
int64_t edge_tiles_count(const int64_t* indptr, int64_t num_nodes,
                         int64_t row_block, int64_t edge_tile) {
  int64_t nb = (num_nodes + row_block - 1) / row_block;
  int64_t nt = 0;
  for (int64_t b = 0; b < nb; ++b) {
    int64_t r0 = b * row_block;
    int64_t r1 = r0 + row_block;
    if (r1 > num_nodes) r1 = num_nodes;
    int64_t cnt = indptr[r1] - indptr[r0];
    int64_t t = (cnt + edge_tile - 1) / edge_tile;
    nt += t > 0 ? t : 1;
  }
  return nt;
}

// Pass 2: fill the tables. The caller zeroes them first (a padding slot
// keeps column 0, value 0, local row 0).
//   tile_block: (nt,) int32; cols, localrow: (nt*T,) int32; vals: (nt*T,) float
void edge_tiles_fill(const int64_t* indptr, const int32_t* indices,
                     const float* values, int64_t num_nodes,
                     int64_t row_block, int64_t edge_tile,
                     int32_t* tile_block, int32_t* cols, float* vals,
                     int32_t* localrow) {
  int64_t nb = (num_nodes + row_block - 1) / row_block;
  int64_t tile = 0;
  for (int64_t b = 0; b < nb; ++b) {
    int64_t r0 = b * row_block;
    int64_t r1 = r0 + row_block;
    if (r1 > num_nodes) r1 = num_nodes;
    int64_t e0 = indptr[r0];
    int64_t cnt = indptr[r1] - e0;
    int64_t ntiles = (cnt + edge_tile - 1) / edge_tile;
    if (ntiles == 0) ntiles = 1;
    for (int64_t t = 0; t < ntiles; ++t) tile_block[tile + t] = (int32_t)b;
    // the local row of each edge by a walk over the block's rows
    int64_t row = r0;
    for (int64_t i = 0; i < cnt; ++i) {
      int64_t e = e0 + i;
      while (row + 1 <= r1 && indptr[row + 1] <= e) ++row;
      int64_t dst = tile * edge_tile + i;
      cols[dst] = indices[e];
      vals[dst] = values[e];
      localrow[dst] = (int32_t)(row - r0);
    }
    tile += ntiles;
  }
}

// ---- CSR transpose (a counting sort by column) ----
// out_indptr: (num_nodes + 1); out_indices, out_values: (nnz)
void csr_transpose(const int64_t* indptr, const int32_t* indices,
                   const float* values, int64_t num_nodes, int64_t nnz,
                   int64_t* out_indptr, int32_t* out_indices,
                   float* out_values) {
  memset(out_indptr, 0, sizeof(int64_t) * (num_nodes + 1));
  for (int64_t e = 0; e < nnz; ++e) out_indptr[indices[e] + 1]++;
  for (int64_t v = 0; v < num_nodes; ++v) out_indptr[v + 1] += out_indptr[v];
  // write cursors per column; walking the rows in order keeps each output
  // row sorted
  int64_t* cursor = new int64_t[num_nodes];
  for (int64_t v = 0; v < num_nodes; ++v) cursor[v] = out_indptr[v];
  int64_t row = 0;
  for (int64_t e = 0; e < nnz; ++e) {
    while (row + 1 <= num_nodes && indptr[row + 1] <= e) ++row;
    int64_t c = indices[e];
    int64_t dst = cursor[c]++;
    out_indices[dst] = (int32_t)row;
    out_values[dst] = values[e];
  }
  delete[] cursor;
}

}  // extern "C"
