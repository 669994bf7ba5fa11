"""CSR sparse-adjacency container.

Port of `maxk_tpu/sparse/csr.py`. Degree normalization is folded into the
edge values once at setup, so the backward aggregation is exactly Aᵀ; the
transpose (CSC-as-CSR of Aᵀ) is built on the host with scipy.

Tensors live on whatever device they were moved to (`CSRGraph.to`);
the host-side builders return CPU tensors.

`row_segments` cuts every row into segments of at most `SEG_EDGES` edges,
the schedule of the CSR kernels (`ops/spmm_csr.py`): a lane group or a
warp a segment, so a hub row is spread over many, and the partial sums of
a row of several segments are added in segment order by a second pass.
The table also carries the kernels' work order (segments by length) and,
for a CSR that K10 walks, its hub table: the `HUB_ROWS` most-referenced
columns, whose merged CBSR rows K10 keeps in shared memory. The port's own
(the reference sums with `segment_sum`); `with_segments` attaches the
table to a CSR, which `sparse/graph.build_graph` and `parallel/shard.
build_sharded_graph` do once per CSR on its device, with the hub table
for the CSR of A (the forward block).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

# edges a segment: a warp's work in the CSR kernels (the paper's warp4
# schedule gives a warp at most 64 nonzeros; at D = 256 a segment of 256
# edges gathers 256 KB, and its partial sum costs 2 KB of traffic more)
SEG_EDGES = 256
# columns of the hub table: K10 keeps as many of their merged CBSR rows in
# shared memory as fit beside its accumulators (`ops/spmm_csr.kernel_layout`:
# at D = 256, 254 / 381 rows of k = 32 slots in f32 / bf16, 1,018 / 1,527 of
# k = 8), so the table holds what the narrowest rows the model runs fill
HUB_ROWS = 1536
# segments this long or longer count as long (`RowSegments.long_segments`):
# K11 hands them out from a counter, since an atomic costs little beside a
# walk of 128 edges, and the shorter ones in turn, since there a queued
# atomic costs as much as the walk
LONG_EDGES = 128


@dataclass(frozen=True)
class RowSegments:
    """Every row of a CSR cut into segments of at most `seg_edges` edges, in
    CSR order; an empty row is one empty segment.

    row, begin: (S,) int32 each segment's row and first edge; it ends at
                min(begin + seg_edges, indptr[row + 1])
    part:       (S,) int32 its row of the partial-sum buffer, or -1 where
                the row is this one segment (written straight to the output)
    multi_row, multi_part0, multi_nseg: (M,) int32 each row of several
                segments, its first partial row and its segment count
    num_parts:  the partial rows, the sum of multi_nseg
    order:      (S,) int32 the segments by length, longest first (ties in
                table order): the kernels' work order
    work:       (S, 4) int32 the segments in work order, each as (row,
                first edge, edges, part): K11's table, a 16-byte load a
                segment in place of a chain of loads through `order`
    long_segments: the segments of at least LONG_EDGES edges, the first
                of the work order
    hub_rows:   (H,) int32 the H most-referenced columns, most first (ties
                to the lower column); H = 0 where the table was built
                without it
    hub_slot:   (C,) int32 each column's slot in hub_rows, or -1; C is the
                largest column index + 1 (0 without a hub table)
    """

    row: torch.Tensor
    begin: torch.Tensor
    part: torch.Tensor
    multi_row: torch.Tensor
    multi_part0: torch.Tensor
    multi_nseg: torch.Tensor
    num_parts: int
    seg_edges: int
    order: torch.Tensor
    work: torch.Tensor
    hub_rows: torch.Tensor
    hub_slot: torch.Tensor
    long_segments: int = 0

    @property
    def num_segments(self) -> int:
        return self.row.shape[0]

    def to(self, device) -> "RowSegments":
        moved = {f: getattr(self, f).to(device) for f in
                 ("row", "begin", "part", "multi_row", "multi_part0", "multi_nseg", "order",
                  "work", "hub_rows", "hub_slot")}
        return RowSegments(num_parts=self.num_parts, seg_edges=self.seg_edges,
                           long_segments=self.long_segments, **moved)


@dataclass(frozen=True)
class CSRGraph:
    """Compressed-sparse-row adjacency.

    indptr:  (V+1,) int32 row pointers
    indices: (E,)   int32 column indices
    values:  (E,)   float32 edge weights (normalization folded in)
    segments: its `RowSegments`, or None (the CSR kernels then build one
              a call)
    """

    indptr: torch.Tensor
    indices: torch.Tensor
    values: torch.Tensor
    segments: Optional[RowSegments] = None

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
            segments=None if self.segments is None else self.segments.to(device),
        )


def hub_table(indices: torch.Tensor, rows: int = HUB_ROWS):
    """(hub_rows, hub_slot) of a CSR's column indices, on their device: the
    `rows` columns with the most references, ties to the lower column, and
    each column's slot among them or -1, over columns 0..max index."""
    if rows < 0:
        raise ValueError(f"rows={rows} must be >= 0")
    counts = torch.bincount(indices.long())
    h = min(rows, counts.shape[0])
    hubs = torch.sort(counts, descending=True, stable=True).indices[:h]
    slot = torch.full_like(counts, -1)
    slot[hubs] = torch.arange(h, device=counts.device)
    return hubs.int(), slot.int()


def row_segments(g: CSRGraph, seg_edges: int = SEG_EDGES, hubs: bool = False) -> RowSegments:
    """The segment table of `g`, built on its device; with `hubs`, its hub
    table (`hub_table`), else an empty one."""
    if seg_edges < 1:
        raise ValueError(f"seg_edges={seg_edges} must be >= 1")
    dev = g.indptr.device
    indptr = g.indptr.long()
    nseg = torch.clamp((torch.diff(indptr) + seg_edges - 1) // seg_edges, min=1)
    total = int(nseg.sum())
    row = torch.repeat_interleave(torch.arange(g.num_nodes, device=dev), nseg, output_size=total)
    first = torch.cumsum(nseg, 0) - nseg
    local = torch.arange(total, device=dev) - first[row]
    multi = nseg > 1
    mseg = torch.where(multi, nseg, 0)
    part0 = torch.cumsum(mseg, 0) - mseg
    multi_row = torch.nonzero(multi).flatten()
    begin = indptr[row] + local * seg_edges
    length = torch.minimum(begin + seg_edges, indptr[row + 1]) - begin
    if hubs:
        hub_rows, hub_slot = hub_table(g.indices[: int(indptr[-1])])
    else:
        hub_rows = hub_slot = torch.empty(0, dtype=torch.int32, device=dev)
    part = torch.where(multi[row], part0[row] + local, -1)
    order = torch.sort(length, descending=True, stable=True).indices
    return RowSegments(
        row=row.int(),
        begin=begin.int(),
        part=part.int(),
        multi_row=multi_row.int(),
        multi_part0=part0[multi_row].int(),
        multi_nseg=nseg[multi_row].int(),
        num_parts=int(mseg.sum()),
        seg_edges=seg_edges,
        order=order.int(),
        work=torch.stack([row, begin, length, part], 1)[order].int().contiguous(),
        hub_rows=hub_rows,
        hub_slot=hub_slot,
        long_segments=int((length >= LONG_EDGES).sum()),
    )


def with_segments(g: CSRGraph, seg_edges: int = SEG_EDGES, hubs: bool = False) -> CSRGraph:
    """`g` carrying its segment table (with its hub table where `hubs`)."""
    return CSRGraph(indptr=g.indptr, indices=g.indices, values=g.values,
                    segments=row_segments(g, seg_edges, hubs))


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
