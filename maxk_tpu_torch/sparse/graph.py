"""Graph operator bundle: the forward CSR, the CSR of Aᵀ, and optionally
their edge-tile tables.

Port of `maxk_tpu/sparse/graph.py`, without the strip-hybrid schedule. For
a graph whose normalized values are symmetric (undirected with norm "none"
or "both") the transpose shares the forward arrays, and its tiles the
forward tiles.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from maxk_tpu_torch.sparse.csr import CSRGraph, csr_to_scipy, csr_transpose, with_norm
from maxk_tpu_torch.sparse.meta import (
    EDGE_TILE,
    ROW_BLOCK,
    EdgeTiles,
    build_edge_tiles,
    build_edge_tiles_device,
)


@dataclass(frozen=True)
class Graph:
    csr: CSRGraph
    csc: CSRGraph  # CSR of A^T (is csr for symmetric normalized A)
    tiles: Optional[EdgeTiles] = None  # the forward schedule
    tiles_t: Optional[EdgeTiles] = None  # the backward (Aᵀ) schedule

    @property
    def num_nodes(self) -> int:
        return self.csr.num_nodes

    @property
    def nnz(self) -> int:
        return self.csr.nnz


def build_graph(
    csr: CSRGraph,
    norm: str = "none",
    build_tiles: bool = False,
    symmetric: Optional[bool] = None,
    hybrid: bool = False,
    device=None,
    row_block: int = ROW_BLOCK,
    edge_tile: int = EDGE_TILE,
    device_builder: bool = False,
) -> Graph:
    """Fold `norm` into the edge values (`csr.with_norm`), build Aᵀ on the
    host, and move both to `device` (None keeps the input's device).

    symmetric=None detects A == Aᵀ after normalization and then shares the
    arrays. `build_tiles` adds the edge-tile tables of A and Aᵀ (R =
    `row_block` rows a block, T = `edge_tile` edges a tile), built on the
    host and moved, or with `device_builder` built on the device
    (`build_edge_tiles_device`): the same tables. They cost 12 bytes a slot
    (≈1 GB each at full reddit), so only the tile modes build them."""
    if hybrid:
        raise NotImplementedError(
            "the strip-hybrid schedule (hybrid=True) is not ported yet: ROADMAP A13"
        )
    g = with_norm(csr.to("cpu"), norm)
    gt = csr_transpose(g)
    if symmetric is None:
        d = abs(csr_to_scipy(g) - csr_to_scipy(gt))
        symmetric = d.nnz == 0 or float(d.max()) < 1e-6
    if symmetric:
        gt = g
    if device is not None:
        g = g.to(device)
        gt = g if symmetric else gt.to(device)
    tiles = tiles_t = None
    if build_tiles:
        def tables(a: CSRGraph) -> EdgeTiles:
            if device_builder:
                return build_edge_tiles_device(a, row_block, edge_tile)
            return build_edge_tiles(a, row_block, edge_tile).to(a.device)

        tiles = tables(g)
        tiles_t = tiles if symmetric else tables(gt)
    return Graph(csr=g, csc=gt, tiles=tiles, tiles_t=tiles_t)
