"""Edge-tile schedule tables. Port of `maxk_tpu/sparse/meta.py`.

Output rows are grouped into row blocks of R rows; each block's edges are
padded to a multiple of T and cut into (T,) tiles, so a tile never crosses
a block and the output block a tile adds into is `block[t]`. Padding
slots hold column 0, value 0 and local row 0; a block with no edges gets
one all-padding tile (unless `elide_empty`), so every output block is
covered. The tile SpMMs (`ops/spmm_xla.spmm_tiles_xla`, `spmm_tiles_scan`)
contract each tile's (T, D) gathered rows against its (T, R) one-hot of
local rows.

The reference pads every table to a multiple of 512 tiles (`TILE_PAD`, a
TPU layout workaround) with inert tiles: zero values, the last real
tile's block. The port's tables are the reference's first NT rows, NT the
exact tile count; `spmm_tiles_scan` pads its chunks itself.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from maxk_tpu_torch.sparse.csr import CSRGraph

ROW_BLOCK = 8
EDGE_TILE = 256


@dataclass(frozen=True)
class EdgeTiles:
    """Rectangular edge-tile tables.

    block:    (NT,)   int32  row-block id of each tile, ascending
    cols:     (NT, T) int32  column of each edge (0 for padding)
    vals:     (NT, T) f32    edge weight (0 for padding)
    localrow: (NT, T) int32  row within the block, in [0, R)
    """

    block: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    localrow: torch.Tensor
    row_block: int = ROW_BLOCK
    num_row_blocks: int = 0
    num_nodes: int = 0

    @property
    def num_tiles(self) -> int:
        return self.block.shape[0]

    @property
    def edge_tile(self) -> int:
        return self.cols.shape[1]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.block, self.cols, self.vals, self.localrow))

    def to(self, device) -> "EdgeTiles":
        return EdgeTiles(
            block=self.block.to(device), cols=self.cols.to(device), vals=self.vals.to(device),
            localrow=self.localrow.to(device), row_block=self.row_block,
            num_row_blocks=self.num_row_blocks, num_nodes=self.num_nodes,
        )


def _tables(tb, tc, tv, tl, row_block: int, nb: int, v: int) -> EdgeTiles:
    return EdgeTiles(
        block=torch.from_numpy(np.ascontiguousarray(tb, dtype=np.int32)),
        cols=torch.from_numpy(np.ascontiguousarray(tc, dtype=np.int32)),
        vals=torch.from_numpy(np.ascontiguousarray(tv, dtype=np.float32)),
        localrow=torch.from_numpy(np.ascontiguousarray(tl, dtype=np.int32)),
        row_block=row_block, num_row_blocks=nb, num_nodes=v,
    )


def _host_arrays(g: CSRGraph):
    """(indptr int64, cols int32, vals f32) numpy arrays of `g`, without
    any inert tail past indptr[-1], which is not part of the graph."""
    indptr = g.indptr.cpu().numpy().astype(np.int64)
    nnz = int(indptr[-1])
    return (indptr, g.indices.cpu().numpy()[:nnz].astype(np.int32),
            g.values.cpu().numpy()[:nnz].astype(np.float32))


def build_edge_tiles(
    g: CSRGraph,
    row_block: int = ROW_BLOCK,
    edge_tile: int = EDGE_TILE,
    elide_empty: bool = False,
) -> EdgeTiles:
    """Host-side CSR → edge tiles, as CPU tensors: the C++ builder of
    `sparse/_native` when it builds, else `build_edge_tiles_numpy`; both
    give the same tables bit for bit.

    `elide_empty`: a block with no edges gets no tile (an empty graph keeps
    one inert tile). Only for consumers whose accumulator does not depend
    on every block having a tile (the scan paths). The C++ builder does not
    elide, so `elide_empty` takes the numpy path, as in the reference."""
    if not elide_empty:
        from maxk_tpu_torch.sparse import _native

        indptr, cols, vals = _host_arrays(g)
        out = _native.edge_tiles_native(indptr, cols, vals, row_block, edge_tile)
        if out is not None:
            v = indptr.shape[0] - 1
            return _tables(*out, row_block, -(-v // row_block), v)
    return build_edge_tiles_numpy(g, row_block, edge_tile, elide_empty)


def build_edge_tiles_numpy(
    g: CSRGraph,
    row_block: int = ROW_BLOCK,
    edge_tile: int = EDGE_TILE,
    elide_empty: bool = False,
) -> EdgeTiles:
    """`build_edge_tiles` in vectorized numpy (the reference's fallback)."""
    indptr, cols, vals = _host_arrays(g)
    nnz = cols.shape[0]
    v = indptr.shape[0] - 1
    nb = -(-v // row_block)
    # pad the row pointers so every block has exactly row_block rows
    if nb * row_block + 1 > indptr.shape[0]:
        indptr = np.concatenate([indptr, np.full(nb * row_block + 1 - indptr.shape[0], indptr[-1])])
    bounds = indptr[0::row_block][: nb + 1]
    block_start = bounds[:nb]
    counts = np.diff(bounds)  # edges per block
    ntiles = -(-counts // edge_tile)
    if not elide_empty:
        ntiles = np.maximum(ntiles, 1)
    elif ntiles.sum() == 0:
        ntiles[0] = 1  # an empty graph keeps one inert tile
    nt = int(ntiles.sum())
    tile_block = np.repeat(np.arange(nb, dtype=np.int32), ntiles)

    # the slot of every edge in the flat (nt·T) stream
    tile_offset = np.concatenate([[0], np.cumsum(ntiles)])
    edge_block = np.repeat(np.arange(nb), counts)
    local_off = np.arange(nnz) - np.repeat(block_start, counts)
    dest = tile_offset[edge_block] * edge_tile + local_off
    flat_cols = np.zeros(nt * edge_tile, dtype=np.int32)
    flat_vals = np.zeros(nt * edge_tile, dtype=np.float32)
    flat_lrow = np.zeros(nt * edge_tile, dtype=np.int32)
    flat_cols[dest] = cols
    flat_vals[dest] = vals
    edge_row = np.repeat(np.arange(nb * row_block), np.diff(indptr))
    flat_lrow[dest] = (edge_row - edge_block * row_block).astype(np.int32)
    return _tables(tile_block, flat_cols.reshape(nt, edge_tile), flat_vals.reshape(nt, edge_tile),
                   flat_lrow.reshape(nt, edge_tile), row_block, nb, v)


def max_block_span(block, chunk: int) -> int:
    """The largest row-block span of any aligned `chunk` of tiles, rounded
    up to a multiple of 8 (as the reference rounds it, so windows equal
    its own). `spmm_tiles_scan(..., window=w)` is right iff w is at least
    this for the same chunk. Not clamped to `chunk`: tables with elided
    empty blocks may span more blocks than they have tiles."""
    b = block.cpu().numpy() if isinstance(block, torch.Tensor) else np.asarray(block)
    nt = b.shape[0]
    if nt == 0:
        return 1
    nc = -(-nt // chunk)
    bp = np.pad(b, (0, nc * chunk - nt), mode="edge").reshape(nc, chunk)
    span = int((bp[:, -1] - bp[:, 0]).max()) + 1
    return -(-span // 8) * 8


def build_edge_tiles_device(
    g: CSRGraph,
    row_block: int = ROW_BLOCK,
    edge_tile: int = EDGE_TILE,
    elide_empty: bool = False,
) -> EdgeTiles:
    """The same tables as `build_edge_tiles`, built with torch ops on the
    graph's device (one host read: the tile count). Each slot gathers its
    edge: slot → (tile, offset) → source edge, valid while the offset is
    under its block's count."""
    dev = g.indptr.device
    v = g.num_nodes
    ip = g.indptr.long()
    e = int(ip[-1])
    nb = -(-v // row_block)
    ipp = torch.cat([ip, ip[-1:].expand(nb * row_block + 1 - ip.shape[0])])
    bounds = ipp[0::row_block][: nb + 1]
    bstart = bounds[:nb]
    counts = torch.diff(bounds)
    ntiles = -torch.div(-counts, edge_tile, rounding_mode="floor")
    if not elide_empty:
        ntiles = ntiles.clamp_min(1)
    nt = int(ntiles.sum())
    if nt == 0:  # an empty graph keeps one inert tile
        ntiles[0] = 1
        nt = 1
    toffset = torch.cat([ntiles.new_zeros(1), torch.cumsum(ntiles, 0)])
    tile_block = torch.repeat_interleave(torch.arange(nb, device=dev), ntiles, output_size=nt)
    blk = tile_block[:, None]
    within = ((torch.arange(nt, device=dev)[:, None] - toffset[blk]) * edge_tile
              + torch.arange(edge_tile, device=dev)[None, :])
    valid = within < counts[blk]
    if e == 0:
        zeros = torch.zeros((nt, edge_tile), dtype=torch.int32, device=dev)
        return EdgeTiles(block=tile_block.int(), cols=zeros, vals=zeros.float(),
                         localrow=zeros.clone(), row_block=row_block, num_row_blocks=nb,
                         num_nodes=v)
    src = (bstart[blk] + within).clamp_(0, e - 1)
    erow = torch.repeat_interleave(torch.arange(v, device=dev), torch.diff(ip), output_size=e)
    cols = torch.where(valid, g.indices[src].int(), 0)
    vals = torch.where(valid, g.values[src].float(), 0.0)
    lrow = torch.where(valid, (erow[src] - blk * row_block).int(), 0)
    return EdgeTiles(block=tile_block.int(), cols=cols.int(), vals=vals, localrow=lrow.int(),
                     row_block=row_block, num_row_blocks=nb, num_nodes=v)
