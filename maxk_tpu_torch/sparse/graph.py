"""Graph operator bundle: the forward CSR, the CSR of Aᵀ, and optionally
their edge-tile tables or the strip-hybrid schedule.

Port of `maxk_tpu/sparse/graph.py`. For a graph whose normalized values
are symmetric (undirected with norm "none" or "both") the transpose shares
the forward arrays, and its tiles the forward tiles. A graph with a strip
schedule lives in degree-permuted node space: `perm[i]` is the original id
of node i, so node data is permuted as `features[perm]`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from maxk_tpu_torch import telemetry
from maxk_tpu_torch.sparse.csr import (
    CSRGraph,
    csr_to_scipy,
    csr_transpose,
    with_norm,
    with_segments,
)
from maxk_tpu_torch.sparse.meta import (
    EDGE_TILE,
    ROW_BLOCK,
    EdgeTiles,
    build_edge_tiles,
    build_edge_tiles_device,
)
from maxk_tpu_torch.sparse.hybrid import (
    HybridSchedule,
    auto_strip_cols,
    auto_strip_dtype,
    auto_tail_band_cols,
    build_hybrid,
    card_rates,
    check_hybrid_ok,
    degree_perm,
    permute_csr,
)


@dataclass(frozen=True)
class Graph:
    csr: CSRGraph
    csc: CSRGraph  # CSR of A^T (is csr for symmetric normalized A)
    tiles: Optional[EdgeTiles] = None  # the forward schedule
    tiles_t: Optional[EdgeTiles] = None  # the backward (Aᵀ) schedule
    hybrid: Optional[HybridSchedule] = None  # the strip schedule (A and Aᵀ)
    perm: Optional[np.ndarray] = None  # (V,) int32 new → old node ids, with `hybrid`

    @property
    def num_nodes(self) -> int:
        return self.csr.num_nodes

    @property
    def nnz(self) -> int:
        return self.csr.nnz


def _strip_schedule(csr: CSRGraph, norm: str, device, strip_cols, tail_band_cols: int, dim: int,
                    strip_dtype):
    """(CSR, strip schedule, perm) of `build_graph(hybrid=True)`: the CSR
    degree-permuted on `device` with its schedule, or as it came with no
    schedule where the graph is directed."""
    dev = csr.device if device is None else torch.device(device)
    on_dev = csr.to(dev)
    if not check_hybrid_ok(on_dev):
        return csr, None, None
    if strip_dtype is None:
        strip_dtype = auto_strip_dtype(on_dev)
    if strip_cols is None:
        strip_cols = auto_strip_cols(
            csr.num_nodes, e_live=int(csr.indptr[-1]), dim=dim,
            strip_itemsize=torch.empty((), dtype=strip_dtype).element_size(),
            rates=card_rates(dev),
        )
    if tail_band_cols < 0:
        tail_band_cols = auto_tail_band_cols(csr.num_nodes, strip_cols)
    perm = degree_perm(csr)
    csr = permute_csr(on_dev, perm)
    return csr, build_hybrid(csr, s_cols=strip_cols, norm=norm, strip_dtype=strip_dtype,
                             tail_band_cols=tail_band_cols), perm


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
    strip_cols: Optional[int] = None,
    tail_band_cols: int = -1,
    dim: int = 256,
    strip_dtype: Optional[torch.dtype] = None,
) -> Graph:
    """Fold `norm` into the edge values (`csr.with_norm`), build Aᵀ on the
    host, and move both to `device` (None keeps the input's device),
    where each gets its segment table (`csr.with_segments`).

    symmetric=None detects A == Aᵀ after normalization and then shares the
    arrays. `build_tiles` adds the edge-tile tables of A and Aᵀ (R =
    `row_block` rows a block, T = `edge_tile` edges a tile), built on the
    host and moved, or with `device_builder` built on the device
    (`build_edge_tiles_device`): the same tables. They cost 12 bytes a slot
    (≈1 GB each at full reddit), so only the tile modes build them.

    `hybrid` (a raw-value-symmetric graph; a directed one falls back to no
    schedule, as in the reference): the nodes are permuted by descending
    degree on `device` and the strip schedule is built there
    (`sparse/hybrid.build_hybrid`); the Graph is then in permuted space and
    carries `perm`. `strip_dtype` None: int8 where exact, else bf16;
    `strip_cols` None: `auto_strip_cols` for a `dim`-wide model at the
    device's rates; `tail_band_cols` −1: `auto_tail_band_cols`. The tail
    keeps its own tile width (`TAIL_EDGE_TILE`), not `edge_tile`.

    The build and each phase are host-clock `telemetry` set-up spans:
    `build`, `build.hybrid`, `build.norm` (the copy to the host and the
    norm fold), `build.transpose`, `build.symmetry`, `build.to_device`,
    `build.segments`, `build.tiles`; none synchronizes the device."""
    with telemetry.span("build", device=False):
        hyb = perm = None
        if hybrid:
            with telemetry.span("build.hybrid", device=False):
                csr, hyb, perm = _strip_schedule(csr, norm, device, strip_cols, tail_band_cols,
                                                 dim, strip_dtype)
        with telemetry.span("build.norm", device=False):
            g = with_norm(csr.to("cpu"), norm)
        with telemetry.span("build.transpose", device=False):
            gt = csr_transpose(g)
        if symmetric is None:
            with telemetry.span("build.symmetry", device=False):
                d = abs(csr_to_scipy(g) - csr_to_scipy(gt))
                symmetric = d.nnz == 0 or float(d.max()) < 1e-6
        if symmetric:
            gt = g
        if device is not None:
            with telemetry.span("build.to_device", device=False):
                g = g.to(device)
                gt = g if symmetric else gt.to(device)
        with telemetry.span("build.segments", device=False):
            g = with_segments(g, hubs=True)  # K10 walks A
            gt = g if symmetric else with_segments(gt)
        tiles = tiles_t = None
        if build_tiles:
            def tables(a: CSRGraph) -> EdgeTiles:
                if device_builder:
                    return build_edge_tiles_device(a, row_block, edge_tile)
                return build_edge_tiles(a, row_block, edge_tile).to(a.device)

            with telemetry.span("build.tiles", device=False):
                tiles = tables(g)
                tiles_t = tiles if symmetric else tables(gt)
    return Graph(csr=g, csc=gt, tiles=tiles, tiles_t=tiles_t, hybrid=hyb, perm=perm)
