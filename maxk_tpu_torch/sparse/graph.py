"""Graph operator bundle: the forward CSR and the CSR of Aᵀ.

Port of `maxk_tpu/sparse/graph.py`, single device, without the edge-tile
and strip-hybrid schedules. For a graph whose normalized values are
symmetric (undirected with norm "none" or "both") the transpose shares
the forward arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from maxk_tpu_torch.sparse.csr import CSRGraph, csr_to_scipy, csr_transpose, with_norm


@dataclass(frozen=True)
class Graph:
    csr: CSRGraph
    csc: CSRGraph  # CSR of A^T (is csr for symmetric normalized A)

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
) -> Graph:
    """Fold `norm` into the edge values (`csr.with_norm`), build Aᵀ on the
    host, and move both to `device` (None keeps the input's device).

    symmetric=None detects A == Aᵀ after normalization and then shares the
    arrays."""
    if build_tiles:
        raise NotImplementedError(
            "edge-tile schedules (build_tiles=True) are not ported yet: ROADMAP A12"
        )
    if hybrid:
        raise NotImplementedError(
            "the strip-hybrid schedule (hybrid=True) is not ported yet: ROADMAP A13"
        )
    g = with_norm(csr.to("cpu"), norm)
    gt = csr_transpose(g)
    if symmetric is None:
        d = abs(csr_to_scipy(g) - csr_to_scipy(gt))
        symmetric = d.nnz == 0 or float(d.max()) < 1e-6
    if device is not None:
        g = g.to(device)
        gt = gt.to(device)
    return Graph(csr=g, csc=g if symmetric else gt)
