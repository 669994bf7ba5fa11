"""Row-partitioned graph sharding for multi-device aggregation.

Port of `maxk_tpu/parallel/shard.py` (`ShardedGraph`, `build_sharded_graph`,
`shard_rows`, `halo_stats`), with the edge-tile schedules and without the
strip hybrid. The scheme is the reference's:

  - adjacency rows are block-partitioned over the ranks: rank r owns rows
    [r·Vs, (r+1)·Vs) of A and of the node features, Vs = ceil(V/n), and
    the rows past V up to Vp = n·Vs carry no edges;
  - forward: every rank all_gathers the compressed CBSR features (V·k
    values and selectors instead of V·D), densifies and aggregates its row
    block (local rows, global columns);
  - backward: every rank runs its transposed block (global rows, local
    columns) over its local cotangent and a reduce_scatter sums the
    (Vp, D) partials and hands each rank its rows.

Each rank holds only its own blocks. JAX pads every shard's edges to the
largest shard's count, and every shard's tile tables to the largest tile
count with inert tiles, because `shard_map` needs stacked arrays; the port
needs no such padding: a rank's tables are the reference's shard prefix.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from maxk_tpu_torch.sparse.csr import CSRGraph, _from_scipy, csr_to_scipy, with_norm
from maxk_tpu_torch.sparse.meta import EDGE_TILE, ROW_BLOCK, EdgeTiles, build_edge_tiles


@dataclass(frozen=True)
class ShardedGraph:
    """One rank's blocks of the normalized A.

    fwd: rows [r·Vs, (r+1)·Vs) of A, global columns — (Vs, Vp)
    bwd: its transpose, global rows, local columns — (Vp, Vs)
    fwd_tiles, bwd_tiles: their edge-tile tables, or None
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
) -> ShardedGraph:
    """This rank's blocks of the normalized `csr` on the mesh's device;
    with `build_tiles`, the edge-tile tables of both blocks (the forward's
    Vs rows, the backward's Vp rows), built on the host from the rank's own
    blocks."""
    if hybrid:
        raise NotImplementedError(
            "the sharded strip hybrid (hybrid=True, ShardedHybrid) is not ported "
            "yet: ROADMAP A13"
        )
    n = mesh.world_size
    ((fwd, bwd),) = shard_blocks(csr, n, norm, ranks=[mesh.rank])
    fwd_tiles = bwd_tiles = None
    if build_tiles:
        fwd_tiles = build_edge_tiles(fwd, row_block, edge_tile).to(mesh.device)
        bwd_tiles = build_edge_tiles(bwd, row_block, edge_tile).to(mesh.device)
    v = csr.num_nodes
    return ShardedGraph(
        fwd=fwd.to(mesh.device),
        bwd=bwd.to(mesh.device),
        num_nodes=v,
        padded_nodes=-(-v // n) * n,
        num_shards=n,
        mesh=mesh,
        fwd_tiles=fwd_tiles,
        bwd_tiles=bwd_tiles,
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
