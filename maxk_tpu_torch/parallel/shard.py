"""Row-partitioned graph sharding for multi-device aggregation.

Port of `maxk_tpu/parallel/shard.py` (`ShardedGraph`, `ShardedHybrid`,
`build_sharded_graph`, `build_sharded_hybrid`, `shard_rows`, `halo_stats`),
with the edge-tile schedules and the strip hybrid. The scheme is the
reference's:

  - adjacency rows are block-partitioned over the ranks: rank r owns rows
    [r·Vs, (r+1)·Vs) of A and of the node features, Vs = ceil(V/n), and
    the rows past V up to Vp = n·Vs carry no edges;
  - forward: every rank all_gathers the compressed CBSR features (V·k
    values and selectors instead of V·D), densifies and aggregates its row
    block (local rows, global columns);
  - backward: every rank runs its transposed block (global rows, local
    columns) over its local cotangent and a reduce_scatter sums the
    (Vp, D) partials and hands each rank its rows.

  - with a strip schedule (`hybrid`), both directions gather the features
    and run `ops/spmm_hybrid.spmm_hybrid_sharded` over the rank's rows of
    the strip and its tail block (one (S, D) all_reduce of hub partials).

Each rank holds only its own blocks, its own (Vs, S) rows of the strip
among them. JAX pads every shard's edges to the largest shard's count,
and every shard's tile tables to the largest tile count with inert tiles,
because `shard_map` needs stacked arrays; the port needs no such padding:
a rank's tables are the reference's shard prefix.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from maxk_tpu_torch.sparse import hybrid as hyb
from maxk_tpu_torch.sparse.csr import (
    CSRGraph,
    _from_scipy,
    csr_to_scipy,
    with_norm,
    with_segments,
)
from maxk_tpu_torch.sparse.meta import (
    EDGE_TILE,
    ROW_BLOCK,
    EdgeTiles,
    build_edge_tiles,
    max_block_span,
)


@dataclass(frozen=True)
class ShardedHybrid:
    """One rank's part of the strip schedule: its rows [r·Vs, (r+1)·Vs).

    strip:      (Vs, S)  its rows of the hub strip W
    pre, post:  (Vp,) f32 the full diagonal scales (the forward scales the
                gathered full features)
    tail_tiles: the edge tiles of its tail block (local rows ≥ S, global
                columns ≥ S), the reference's shard prefix
    tail_window: the scan window of this rank's tables
    """

    strip: torch.Tensor
    pre: torch.Tensor
    post: torch.Tensor
    tail_tiles: EdgeTiles
    rank: int
    s_cols: int
    num_nodes: int
    padded_nodes: int
    num_shards: int
    tail_chunk: int = hyb.TAIL_CHUNK
    tail_window: int = 0

    @property
    def shard_nodes(self) -> int:
        return self.padded_nodes // self.num_shards


def build_sharded_hybrid(
    csr: CSRGraph,
    num_shards: int,
    rank: int,
    s_cols: Optional[int] = None,
    norm: str = "none",
    strip_dtype: Optional[torch.dtype] = None,
    row_block: int = ROW_BLOCK,
    edge_tile: Optional[int] = None,
    tail_chunk: int = hyb.TAIL_CHUNK,
    dim: int = 256,
    device=None,
) -> ShardedHybrid:
    """Rank `rank`'s part of the row-partitioned strip hybrid, built on
    `device` (None: the CSR's). `csr` must already be degree-permuted and
    raw-value-symmetric (`build_hybrid`'s contract); `norm` only sets the
    scales. `strip_dtype` None: int8 where exact, else bf16; `edge_tile`
    None: the tail width for that dtype; `s_cols` None: the default width
    capped by what V/n rows of it fit in the device's strip budget (the
    reference's rule)."""
    device = csr.device if device is None else torch.device(device)
    g = csr.to(device)
    if strip_dtype is None:
        strip_dtype = hyb.auto_strip_dtype(g)
    itemsize = torch.empty((), dtype=strip_dtype).element_size()
    if edge_tile is None:
        edge_tile = hyb.TAIL_EDGE_TILE_INT8 if itemsize == 1 else hyb.TAIL_EDGE_TILE
    v = csr.num_nodes
    vs = -(-v // num_shards)
    vp = vs * num_shards
    if s_cols is None:
        cap = hyb.STRIP_COLS_INT8 if itemsize == 1 else hyb.STRIP_COLS
        s_cols = hyb.auto_strip_cols(vs, s_cols=min(cap, v), dim=dim, strip_itemsize=itemsize,
                                     rates=hyb.card_rates(device))
    s = hyb.strip_width(v, s_cols)
    rows, cols, vals = hyb._live(g)
    live = vals != 0
    r0, r1 = rank * vs, (rank + 1) * vs
    mine = (rows >= r0) & (rows < r1) & live
    m = mine & (cols < s)
    if not strip_dtype.is_floating_point:
        hyb._check_integer_strip(vals[m], strip_dtype)
    strip = hyb._zeros_strip(vs, s, strip_dtype, device)
    hyb._fill_strip(strip, rows[m], cols[m], vals[m], r0)
    m = mine & (cols >= s) & (rows >= s)
    tail = build_edge_tiles(hyb._subgraph(vs, rows[m] - r0, cols[m], vals[m]), row_block,
                            edge_tile).to(device)
    deg = torch.zeros(vp, dtype=torch.float32, device=device).index_add_(0, rows, live.float())
    pre, post = hyb._scales(deg, norm)
    return ShardedHybrid(
        strip=strip, pre=pre, post=post, tail_tiles=tail, rank=rank, s_cols=s, num_nodes=v,
        padded_nodes=vp, num_shards=num_shards, tail_chunk=tail_chunk,
        tail_window=max_block_span(tail.block, tail_chunk),
    )


@dataclass(frozen=True)
class ShardedGraph:
    """One rank's blocks of the normalized A.

    fwd: rows [r·Vs, (r+1)·Vs) of A, global columns — (Vs, Vp)
    bwd: its transpose, global rows, local columns — (Vp, Vs)
    fwd_tiles, bwd_tiles: their edge-tile tables, or None
    hybrid: the rank's part of the strip schedule, or None
    `mesh` is the rank's `parallel.mesh.Mesh`, whose collectives the
    aggregation ops call."""

    fwd: CSRGraph
    bwd: CSRGraph
    num_nodes: int
    padded_nodes: int
    num_shards: int
    mesh: object
    fwd_tiles: Optional[EdgeTiles] = None
    bwd_tiles: Optional[EdgeTiles] = None
    hybrid: Optional[ShardedHybrid] = None

    @property
    def shard_nodes(self) -> int:
        return self.padded_nodes // self.num_shards

    @property
    def nnz(self) -> int:
        return self.fwd.nnz


def _padded(csr: CSRGraph, num_shards: int, norm: str):
    """The normalized A as a scipy CSR padded to (Vp, Vp), and Vs."""
    import scipy.sparse as sp

    g = csr_to_scipy(with_norm(csr.to("cpu"), norm))
    v = g.shape[0]
    vs = -(-v // num_shards)
    vp = vs * num_shards
    indptr = np.concatenate([g.indptr, np.full(vp - v, g.indptr[-1], g.indptr.dtype)])
    return sp.csr_matrix((g.data, g.indices, indptr), shape=(vp, vp)), vs


def shard_blocks(
    csr: CSRGraph, num_shards: int, norm: str = "none", ranks=None,
) -> List[Tuple[CSRGraph, CSRGraph]]:
    """Host-side (fwd, bwd) CPU blocks of `ranks` (default: every rank)."""
    m, vs = _padded(csr, num_shards, norm)
    out = []
    for r in range(num_shards) if ranks is None else ranks:
        blk = m[r * vs:(r + 1) * vs]  # (Vs, Vp): local rows, global columns
        out.append((_from_scipy(blk), _from_scipy(blk.T.tocsr())))
    return out


def build_sharded_graph(
    csr: CSRGraph,
    mesh,
    norm: str = "none",
    build_tiles: bool = False,
    hybrid: bool = False,
    row_block: int = ROW_BLOCK,
    edge_tile: int = EDGE_TILE,
    strip_cols: Optional[int] = None,
    tail_edge_tile: Optional[int] = None,
    strip_dtype: Optional[torch.dtype] = None,
    dim: int = 256,
) -> ShardedGraph:
    """This rank's blocks of the normalized `csr` on the mesh's device;
    with `build_tiles`, the edge-tile tables of both blocks (the forward's
    Vs rows, the backward's Vp rows), built on the host from the rank's own
    blocks. With `hybrid`, `csr` must already be degree-permuted and
    raw-value-symmetric (callers permute node data alike), and the rank's
    part of the strip schedule is built (`build_sharded_hybrid`, tail tile
    width `tail_edge_tile`); the CSR blocks are still built. Both blocks
    carry their segment tables (`csr.with_segments`), built on the device."""
    n = mesh.world_size
    shyb = None
    if hybrid:
        shyb = build_sharded_hybrid(csr, n, mesh.rank, s_cols=strip_cols, norm=norm,
                                    strip_dtype=strip_dtype, row_block=row_block,
                                    edge_tile=tail_edge_tile, dim=dim, device=mesh.device)
    ((fwd, bwd),) = shard_blocks(csr, n, norm, ranks=[mesh.rank])
    fwd_tiles = bwd_tiles = None
    if build_tiles:
        fwd_tiles = build_edge_tiles(fwd, row_block, edge_tile).to(mesh.device)
        bwd_tiles = build_edge_tiles(bwd, row_block, edge_tile).to(mesh.device)
    v = csr.num_nodes
    return ShardedGraph(
        fwd=with_segments(fwd.to(mesh.device)),
        bwd=with_segments(bwd.to(mesh.device)),
        num_nodes=v,
        padded_nodes=-(-v // n) * n,
        num_shards=n,
        mesh=mesh,
        fwd_tiles=fwd_tiles,
        bwd_tiles=bwd_tiles,
        hybrid=shyb,
    )


def shard_rows(x: np.ndarray, num_shards: int, fill=0) -> np.ndarray:
    """Pad a per-node array to the sharded row count (Vp)."""
    x = np.asarray(x)
    v = x.shape[0]
    vp = -(-v // num_shards) * num_shards
    if vp == v:
        return x
    pad = np.full((vp - v,) + x.shape[1:], fill, dtype=x.dtype)
    return np.concatenate([x, pad])


def halo_stats(csr: CSRGraph, num_shards: int, k: int = 32, s_cols: int = 0) -> dict:
    """Per-shard halo analysis of the row-partitioned aggregation: for each
    shard, the distinct off-shard rows its block references outside the
    hub strip [0, s), and the receive bytes per device of the full
    compressed all_gather against a hub psum plus halo exchange, at CBSR
    width k (f32 value + int16 selector = 6 B per slot). Same fields and
    numbers as the reference (`maxk_tpu/parallel/shard.py:438-486`)."""
    indptr = csr.indptr.cpu().numpy().astype(np.int64)
    nnz = int(indptr[-1])
    cols = csr.indices.cpu().numpy().astype(np.int64)[:nnz]
    vals = csr.values.cpu().numpy().astype(np.float32)[:nnz]
    v = csr.num_nodes
    vs = -(-v // num_shards)
    rows = np.repeat(np.arange(v, dtype=np.int64), np.diff(indptr[: v + 1]))
    live = vals != 0
    s = int(s_cols)

    bytes_per_row = k * 6
    full_ag = (num_shards - 1) / num_shards * vs * num_shards * bytes_per_row
    shards = []
    for i in range(num_shards):
        m = live & (rows >= i * vs) & (rows < (i + 1) * vs) & (cols >= s)
        c = np.unique(cols[m])
        halo = c[(c < i * vs) | (c >= (i + 1) * vs)]
        shards.append(int(halo.shape[0]))
    hub_bytes = 2 * s * bytes_per_row * (num_shards - 1) / max(num_shards, 1)
    return {
        "num_shards": num_shards,
        "k": k,
        "s_cols": s,
        "halo_rows_per_shard": shards,
        "allgather_recv_bytes_per_device": int(full_ag),
        "halo_recv_bytes_per_device_max": int(hub_bytes + max(shards) * bytes_per_row),
        "reduction_vs_allgather": round(
            full_ag / max(hub_bytes + max(shards) * bytes_per_row, 1), 2
        ),
    }
