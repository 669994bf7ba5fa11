"""CSR sparse-adjacency container.

Port of `maxk_tpu/sparse/csr.py`. Degree normalization is folded into the
edge values once at setup, so the backward aggregation is exactly Aᵀ; the
transpose (CSC-as-CSR of Aᵀ) is built on the host with scipy.

Tensors live on whatever device they were moved to (`CSRGraph.to`);
the host-side builders return CPU tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass(frozen=True)
class CSRGraph:
    """Compressed-sparse-row adjacency.

    indptr:  (V+1,) int32 row pointers
    indices: (E,)   int32 column indices
    values:  (E,)   float32 edge weights (normalization folded in)
    """

    indptr: torch.Tensor
    indices: torch.Tensor
    values: torch.Tensor

    @property
    def num_nodes(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def nnz(self) -> int:
        return self.indices.shape[0]

    @property
    def device(self) -> torch.device:
        return self.indices.device

    def in_degrees(self) -> torch.Tensor:
        """Nonzeros per row, clamped to >= 1."""
        return torch.diff(self.indptr).clamp_min(1)

    def row_ids(self) -> torch.Tensor:
        """(E,) int32 row id of every nonzero."""
        v = self.num_nodes
        return torch.repeat_interleave(
            torch.arange(v, dtype=torch.int32, device=self.device),
            torch.diff(self.indptr),
            output_size=self.nnz,
        )

    def to(self, device) -> "CSRGraph":
        return CSRGraph(
            indptr=self.indptr.to(device),
            indices=self.indices.to(device),
            values=self.values.to(device),
        )


def _from_scipy(m) -> CSRGraph:
    return CSRGraph(
        indptr=torch.from_numpy(np.ascontiguousarray(m.indptr, dtype=np.int32)),
        indices=torch.from_numpy(np.ascontiguousarray(m.indices, dtype=np.int32)),
        values=torch.from_numpy(np.ascontiguousarray(m.data, dtype=np.float32)),
    )


def csr_from_coo(
    rows: np.ndarray,
    cols: np.ndarray,
    num_nodes: int,
    values: Optional[np.ndarray] = None,
    dedup: bool = True,
) -> CSRGraph:
    """Host-side COO → CSR (sorted, optionally deduplicated)."""
    import scipy.sparse as sp

    if values is None:
        values = np.ones(rows.shape[0], dtype=np.float32)
    m = sp.coo_matrix(
        (values, (rows.astype(np.int64), cols.astype(np.int64))),
        shape=(num_nodes, num_nodes),
    ).tocsr()
    if dedup:
        m.sum_duplicates()
        # dedup means "keep one", not "sum": reset weights to 1
        m.data[:] = 1.0
    m.sort_indices()
    return _from_scipy(m)


def csr_to_scipy(g: CSRGraph):
    import scipy.sparse as sp

    v = g.num_nodes
    indptr = g.indptr.cpu().numpy()
    nnz = int(indptr[-1])
    return sp.csr_matrix(
        (g.values.cpu().numpy()[:nnz], g.indices.cpu().numpy()[:nnz], indptr),
        shape=(v, v),
    )


def csr_transpose(g: CSRGraph) -> CSRGraph:
    """Host-side CSR → the CSR of Aᵀ (the backward aggregation's operand)."""
    return _from_scipy(csr_to_scipy(g).tocsc())


def with_norm(g: CSRGraph, mode: str = "right") -> CSRGraph:
    """Fold degree normalization into edge values.

      - "right": mean aggregation, `y_i = (1/indeg_i) * sum_j a_ij x_j`
      - "both":  symmetric GCN norm `D^-1/2 A D^-1/2`
      - "left":  `sum_j a_ij x_j / outdeg_j`
      - "none":  raw sum aggregation (GIN)

    Degrees count live edges only: weight-0 entries must not inflate them.
    """
    if mode == "none":
        return g
    if mode not in ("right", "left", "both"):
        raise ValueError(f"unknown norm mode: {mode}")
    v = g.num_nodes
    row = g.row_ids()
    live = (g.values != 0).to(torch.float32)
    zeros = torch.zeros((v,), dtype=torch.float32, device=g.device)
    indeg = zeros.index_add(0, row, live).clamp_min(1.0)
    outdeg = zeros.index_add(0, g.indices, live).clamp_min(1.0)
    if mode == "right":
        vals = g.values / indeg[row]
    elif mode == "left":
        vals = g.values / outdeg[g.indices]
    else:
        vals = g.values / torch.sqrt(indeg[row]) / torch.sqrt(outdeg[g.indices])
    return CSRGraph(indptr=g.indptr, indices=g.indices, values=vals)


def add_self_loops(g: CSRGraph) -> CSRGraph:
    """Add i→i edges (dedup keeps existing ones)."""
    m = csr_to_scipy(g).tocoo()
    v = g.num_nodes
    rows = np.concatenate([m.row, np.arange(v)])
    cols = np.concatenate([m.col, np.arange(v)])
    return csr_from_coo(rows, cols, v)


def symmetrize(g: CSRGraph) -> CSRGraph:
    """Make undirected by adding reverse edges (deduplicated, weight 1)."""
    m = csr_to_scipy(g).tocoo()
    rows = np.concatenate([m.row, m.col])
    cols = np.concatenate([m.col, m.row])
    return csr_from_coo(rows, cols, g.num_nodes)


def reorder_rcm(g: CSRGraph):
    """Reverse-Cuthill-McKee bandwidth-reducing reordering on the host.

    Returns (reordered graph, perm) with perm[i] = old id of new row i;
    apply the same perm to the node arrays: `x_new = x[perm]`."""
    import scipy.sparse.csgraph as csgraph

    m = csr_to_scipy(g)
    perm = np.asarray(csgraph.reverse_cuthill_mckee(m, symmetric_mode=True))
    m2 = m[perm][:, perm].tocsr()
    m2.sort_indices()
    return _from_scipy(m2), perm
