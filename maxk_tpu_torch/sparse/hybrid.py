"""Degree-sorted symmetric-strip hybrid schedule.

Port of `maxk_tpu/sparse/hybrid.py`. Nodes are permuted by descending
live degree, so the hub columns [0, S) hold most edges. An undirected
graph's normalized adjacency factors as A = D_post · S · D_pre with S
value-symmetric (the raw weights), so S splits into two parts:

  strip  W = S[:, :S]   dense, (V, S) in the strip dtype; by symmetry it
                        also holds the hub rows S[:S, :] = Wᵀ
  tail   rows ≥ S and columns ≥ S, edge tiles for the tile scan

and `ops/spmm_hybrid.spmm_hybrid` computes Y = post ⊙ (S @ (pre ⊙ x)) as
two dense products over the strip plus one tile scan over the tail; Aᵀ
swaps the two scales.

Differences from the reference, all of layout:
  - the strip holds the first V rows, not V rounded up to 128 (the
    reference's rows past V are zero);
  - the strip is scattered straight into its dtype on the target device
    (the reference fills a (Vp, S) float32 host array first: 22.9 GB at
    reddit's int8 width);
  - the tail tables are the reference's first NT rows, without
    `TILE_PAD` (`sparse/meta.py`).
The planning rules take the card's rates as an argument (`Rates`): the
reference's v5e constants (`V5E`) reproduce its widths and decisions;
`card_rates` gives the H100's, measured on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from maxk_tpu_torch.sparse.csr import CSRGraph
from maxk_tpu_torch.sparse.meta import ROW_BLOCK, EdgeTiles, build_edge_tiles, max_block_span

STRIP_COLS = 16384  # the reference's bf16 strip width
STRIP_COLS_INT8 = 24576  # its int8 strip width (half the bytes a column)
TAIL_EDGE_TILE = 64  # tail tile under a float strip
TAIL_EDGE_TILE_INT8 = 32  # under an integer strip, whose tail is smaller
# tail tiles a scan step. The reference takes 256; on the H100 the scan is
# bound by its host launches (a dozen a step): reddit x1.0's int8-width
# tail (105,496 tiles of 32) took 68.92 and 107.79 ms at 256, 34.19 and
# 22.53 at 1024, 44.27 and 43.86 at 4096 (the chunk's and the exact window,
# equal here; NVIDIA H100 80GB HBM3, 700.00 W; `python -m
# maxk_tpu_torch.bench.probe_hybrid --dtype int8 --s 24576`'s tail sweep)
TAIL_CHUNK = 1024


@dataclass(frozen=True)
class Rates:
    """What the planning rules need to know of a card: the plain gather
    SpMM's seconds a live edge, the strip products' FLOP/s, the device
    memory and the cap on the strip's bytes."""

    gather_sec_per_edge: float
    matmul_flops: float
    hbm_bytes: float
    strip_budget: float


# the reference's constants for one TPU v5e chip (`maxk_tpu/sparse/
# hybrid.py:73-78`): they reproduce its widths and decisions, and plan the
# CPU runs, where there is no card to measure
V5E = Rates(gather_sec_per_edge=9e-9, matmul_flops=1.5e14, hbm_bytes=16e9, strip_budget=8e9)

# measured on NVIDIA H100 80GB HBM3 at its 700.00 W power limit: the plain
# gather SpMM on a card, the CSR kernel K9 (`ops/spmm_csr.spmm_csr`, f32,
# D = 256), over reddit x1.0's 79,037,673 live edges in 10.5436 ms
# (chip_smoke.py's csr_kernels phase); the index_add_ segsum it replaced
# took 279.83 ms
H100_GATHER_SEC_PER_EDGE = 10.5436e-3 / 79_037_673
# the bf16 x bf16 -> f32 strip product (233,088 x 16,384)ᵀ @ (233,088 x 256)
# at 760.15 TFLOP/s, on the same card (`python -m
# maxk_tpu_torch.bench.probe_int8`, part A)
H100_MATMUL_FLOPS = 760.15e12


def card_rates(device) -> Rates:
    """The planning rates of `device`: on a CUDA card the H100's measured
    rates with the card's own memory, the strip capped at half of it (the
    reference's share of its 16 GB chip); on the CPU the reference's."""
    device = torch.device(device)
    if device.type != "cuda":
        return V5E
    hbm = float(torch.cuda.get_device_properties(device).total_memory)
    return Rates(H100_GATHER_SEC_PER_EDGE, H100_MATMUL_FLOPS, hbm, hbm / 2)


def _padded(v: int) -> int:
    return -(-v // 128) * 128


def auto_strip_cols(
    v: int,
    s_cols: Optional[int] = None,
    e_live: Optional[int] = None,
    dim: int = 256,
    io_itemsize: int = 4,
    strip_itemsize: int = 2,
    rates: Rates = V5E,
) -> int:
    """Strip width for a V-node graph: the default for the strip itemsize
    (`STRIP_COLS`, or `STRIP_COLS_INT8` for 1 byte), shrunk to fit the
    strip budget, a multiple of 128. With `e_live` the budget also leaves
    the SpMM's working set: one (V, dim) f32 accumulator, two (V, dim)
    `io_itemsize` buffers, two (V, dim) bf16 ones and 17 bytes an edge,
    plus 1.5 GB (the reference's rule)."""
    if s_cols is None:
        s_cols = STRIP_COLS_INT8 if strip_itemsize == 1 else STRIP_COLS
    budget = rates.strip_budget
    if e_live is not None:
        working = v * dim * 4 + 2 * v * dim * io_itemsize + 2 * v * dim * 2 + 17 * e_live
        budget = min(budget, rates.hbm_bytes - working - 1.5e9)
    fit = int(max(budget, 0.0) // (_padded(v) * strip_itemsize)) // 128 * 128
    return max(min(s_cols, v, fit), 0)


def _live(csr: CSRGraph):
    """(rows int64, cols int64, values f32) of the first indptr[-1] edges,
    on the CSR's device."""
    nnz = int(csr.indptr[-1])
    rows = torch.repeat_interleave(
        torch.arange(csr.num_nodes, device=csr.device), torch.diff(csr.indptr.long()),
        output_size=nnz,
    )
    return rows, csr.indices[:nnz].long(), csr.values[:nnz].float()


def strip_int8_exact(csr: CSRGraph) -> bool:
    """True iff an int8 strip is exact for this graph: every live value is
    an integer of magnitude at most 127. Computed on the CSR's device."""
    vals = csr.values[: int(csr.indptr[-1])].float()
    vals = vals[vals != 0]
    if vals.numel() == 0:
        return True
    frac = float((vals - torch.round(vals)).abs().max())
    return frac == 0.0 and float(vals.abs().max()) <= torch.iinfo(torch.int8).max


def auto_strip_dtype(csr: CSRGraph) -> torch.dtype:
    """int8 where exact (`strip_int8_exact`), else bf16: at an equal budget
    the int8 strip is twice as wide."""
    return torch.int8 if strip_int8_exact(csr) else torch.bfloat16


def auto_tail_band_cols(v: int, s_cols: int) -> int:
    """The tail-banding rule: 0, one band. The reference measured banding
    slower at its production tile widths (`hybrid.py:165-182`)."""
    return 0


def hybrid_profitable(
    v: int,
    e_live: int,
    dim: int = 256,
    io_itemsize: int = 4,
    strip_itemsize: int = 2,
    rates: Rates = V5E,
) -> bool:
    """Build the hybrid only where its three dense strip products,
    3·Vp·S·dim·2 / matmul_flops, take under half the plain gather SpMM's
    time, E · gather_sec_per_edge; and never with a strip under 256
    columns. The itemsizes must be the ones the builder will use."""
    s = auto_strip_cols(v, e_live=e_live, dim=dim, io_itemsize=io_itemsize,
                        strip_itemsize=strip_itemsize, rates=rates)
    if s < 256:
        return False
    strip_time = 3.0 * _padded(v) * s * dim * 2 / rates.matmul_flops
    return strip_time < 0.5 * e_live * rates.gather_sec_per_edge


def auto_hybrid(csr: CSRGraph, dim: int = 256, io_itemsize: int = 4, device="cpu",
                strip_dtype: Optional[torch.dtype] = None) -> bool:
    """AUTO's choice of the strip hybrid for `csr`: on a CUDA card, where
    `hybrid_profitable` says so at the card's rates and the itemsize of the
    strip the builder will make (`strip_dtype`, None: `auto_strip_dtype`);
    never on the CPU. The reference's rule, which it applies on a TPU
    (`maxk_tpu/train/loop.py:83-96`)."""
    device = torch.device(device)
    if device.type != "cuda":
        return False
    if strip_dtype is None:
        strip_dtype = auto_strip_dtype(csr.to(device))
    return hybrid_profitable(csr.num_nodes, int(csr.indptr[-1]), dim=dim,
                             io_itemsize=io_itemsize,
                             strip_itemsize=torch.empty((), dtype=strip_dtype).element_size(),
                             rates=card_rates(device))


def _effective_band(span: int, band: int, max_bands: int = 12) -> int:
    """Widen the requested band so the tail splits into at most max_bands
    bands, a multiple of 128 (the reference's rule)."""
    if span > band * max_bands:
        band = -(-span // max_bands)
        band = -(-band // 128) * 128
    return band


def tail_slot_stats(
    csr: CSRGraph,
    s_cols: int,
    band_cols: int = 0,
    row_block: int = ROW_BLOCK,
    edge_tile: int = TAIL_EDGE_TILE,
    presorted: bool = False,
) -> dict:
    """The tail's live edges, tiles and slots for a candidate strip width
    and band width, without building anything: the tile counts of the
    port's tables (`build_hybrid`), which the reference's are before their
    `TILE_PAD` rounding. `presorted`: csr is already degree-permuted."""
    indptr = csr.indptr.cpu().numpy().astype(np.int64)
    nnz = int(indptr[-1])
    cols = csr.indices.cpu().numpy()[:nnz].astype(np.int64)
    v = indptr.shape[0] - 1
    deg = np.diff(indptr)
    rows = np.repeat(np.arange(v, dtype=np.int64), deg)
    if presorted:
        rr, cr = rows, cols
    else:
        rank = np.empty(v, dtype=np.int64)
        rank[np.argsort(-deg, kind="stable")] = np.arange(v)
        rr, cr = rank[rows], rank[cols]
    t = (rr >= s_cols) & (cr >= s_cols)
    rt, ct = rr[t], cr[t]
    live = int(t.sum())
    blk = rt // row_block
    if band_cols > 0:
        band = _effective_band(v - s_cols, band_cols)
        key = blk * np.int64(1 << 20) + (ct - s_cols) // band
        n_bands = -(-(v - s_cols) // band)
    else:
        key = blk
        n_bands = 1
    keys, counts = np.unique(key, return_counts=True)
    tiles = int(np.ceil(counts / edge_tile).sum())
    if band_cols <= 0:
        # the single-band tables give an empty row block one all-padding tile
        tiles += -(-v // row_block) - len(counts)
    slots = tiles * edge_tile
    return {
        "s_cols": s_cols,
        "band_cols": band_cols,
        "n_bands": n_bands,
        "tail_live": live,
        "tiles": tiles,
        "slots": slots,
        "pad_ratio": slots / max(live, 1),
        "strip_gb": v * s_cols * 2 / 1e9,
    }


@dataclass(frozen=True)
class HybridSchedule:
    """One graph's symmetric-strip decomposition, on one device.

    strip:      (V, S) strip dtype  W = S[:, :S], the raw symmetric values
    pre, post:  (V,) f32            the diagonal norm factors
    tail_tiles: EdgeTiles           the rows ≥ S, columns ≥ S remainder
    tail_bands: column bands of the tail, columns rebased to each band's
                start (empty: one band, `tail_tiles`); `tail_band_meta`
                holds each band's (column start, width, scan window)
    strip_row_sums: (V,) f64 the sum of |S| over the entries the strip
                products give each row: its whole row under S (W's column
                by symmetry), its hub columns from S on. Their largest
                bounds the int32 sums of the int8 × int8 products
    """

    strip: torch.Tensor
    pre: torch.Tensor
    post: torch.Tensor
    tail_tiles: EdgeTiles
    num_nodes: int
    s_cols: int
    strip_row_sums: torch.Tensor
    tail_chunk: int = TAIL_CHUNK
    tail_window: int = 0  # the tail scan's window (0: the chunk)
    tail_bands: tuple = ()
    tail_band_meta: tuple = ()

    @property
    def strip_line_sum(self) -> float:
        """The largest row or column sum of |W|."""
        return float(self.strip_row_sums.max()) if self.num_nodes else 0.0

    @property
    def nbytes(self) -> int:
        tables = (self.tail_tiles,) + tuple(self.tail_bands)
        return (self.strip.numel() * self.strip.element_size()
                + 4 * (self.pre.numel() + self.post.numel()) + sum(t.nbytes for t in tables))


def degree_perm(csr: CSRGraph) -> np.ndarray:
    """The permutation sorting nodes by descending degree (stable)."""
    deg = np.diff(csr.indptr.cpu().numpy().astype(np.int64))
    return np.argsort(-deg, kind="stable").astype(np.int32)


def permute_csr(csr: CSRGraph, perm) -> CSRGraph:
    """Relabel nodes so that new node i is old node perm[i], on the CSR's
    device: the edges sorted by (new row, new column)."""
    dev = csr.device
    v = csr.num_nodes
    perm = torch.as_tensor(np.asarray(perm), device=dev).long()
    rank = torch.empty(v, dtype=torch.long, device=dev)
    rank[perm] = torch.arange(v, device=dev)
    rows, cols, vals = _live(csr)
    r, c = rank[rows], rank[cols]
    del rows, cols
    order = torch.argsort(r * v + c, stable=True)
    counts = torch.bincount(r, minlength=v)
    return CSRGraph(
        indptr=torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]).int(),
        indices=c[order].int(),
        values=vals[order],
    )


def check_hybrid_ok(csr: CSRGraph, tol: float = 1e-6) -> bool:
    """The hybrid needs raw value symmetry (an undirected graph): every
    entry of |A − Aᵀ| under `tol`, on the CSR's device."""
    rows, cols, vals = _live(csr)
    v = csr.num_nodes
    keys, inv = torch.unique(torch.cat([rows * v + cols, cols * v + rows]), return_inverse=True)
    d = torch.zeros(keys.shape[0], dtype=torch.float32, device=csr.device)
    d.index_add_(0, inv, torch.cat([vals, -vals]))
    return d.numel() == 0 or float(d.abs().max()) < tol


def _scales(deg: torch.Tensor, norm: str):
    ones = torch.ones_like(deg)
    d = torch.clamp_min(deg, 1.0)
    if norm == "none":
        return ones, ones
    if norm == "right":
        return ones, 1.0 / d
    if norm == "left":
        return 1.0 / d, ones
    if norm == "both":
        inv = 1.0 / torch.sqrt(d)
        return inv, inv
    raise ValueError(f"unknown norm mode: {norm}")


def _subgraph(v: int, rows, cols, vals) -> CSRGraph:
    """The CPU CSR of v rows holding the given edges (int64 rows, columns)."""
    order = torch.argsort(rows * (1 << 32) + cols, stable=True)
    rows = rows[order]
    indptr = torch.searchsorted(rows, torch.arange(v + 1, device=rows.device))
    return CSRGraph(indptr=indptr.int(), indices=cols[order].int(),
                    values=vals[order].float()).to("cpu")


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


def _check_integer_strip(vals: torch.Tensor, strip_dtype: torch.dtype) -> None:
    """An integer strip is exact only for integer values in its range."""
    iinfo = torch.iinfo(strip_dtype)
    bad = int(((vals != torch.round(vals)) | (vals.abs() > iinfo.max)).sum())
    if bad:
        raise ValueError(
            f"strip_dtype={_dtype_name(strip_dtype)} requires integer strip values in "
            f"[{iinfo.min}, {iinfo.max}]; {bad} edges violate this"
        )


def _zeros_strip(rows: int, s: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A zero (rows, S) strip; raises when it cannot fit the card's free memory."""
    nbytes = rows * s * torch.empty((), dtype=dtype).element_size()
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        if nbytes > free:
            raise ValueError(
                f"the ({rows}, {s}) {_dtype_name(dtype)} strip needs {nbytes} bytes, "
                f"{device} has {free} free: pass a smaller strip_cols"
            )
    return torch.zeros((rows, s), dtype=dtype, device=device)


def strip_width(v: int, s_cols: int) -> int:
    """The width the builders use: at most V, a multiple of 128 (at least
    128) once V reaches 128. It decides which edges fall in the tail."""
    s = min(s_cols, v)
    return max(128, (s // 128) * 128) if v >= 128 else v


def _fill_strip(strip, rows, cols, vals, row0: int) -> torch.Tensor:
    """Scatter the edges (global rows from row0) into `strip`; returns the
    strip's row sums of |values| (`HybridSchedule.strip_row_sums`): a row
    under S takes its column's sum."""
    s = strip.shape[1]
    strip.view(-1).index_put_(((rows - row0) * s + cols,), vals.to(strip.dtype))
    a = vals.abs().double()
    sums = torch.zeros(strip.shape[0], dtype=torch.float64, device=vals.device)
    sums.index_add_(0, rows - row0, a)
    col_sum = torch.zeros(s, dtype=torch.float64, device=vals.device).index_add_(0, cols, a)
    hub = min(max(s - row0, 0), strip.shape[0])
    sums[:hub] = col_sum[row0:row0 + hub]
    return sums


def build_hybrid(
    csr: CSRGraph,
    s_cols: int = STRIP_COLS,
    norm: str = "none",
    strip_dtype: torch.dtype = torch.bfloat16,
    row_block: int = ROW_BLOCK,
    edge_tile: Optional[int] = None,
    tail_chunk: int = TAIL_CHUNK,
    tail_band_cols: int = 0,
    device=None,
) -> HybridSchedule:
    """The schedule of `csr`, which must already be degree-permuted
    (`permute_csr(csr, degree_perm(csr))`) and raw-value-symmetric; `norm`
    only sets the diagonal scales. The strip is built on `device` (None:
    the CSR's), the tail tables on the host (`build_edge_tiles`) and moved.
    `tail_band_cols` > 0 splits the tail into column bands of that width.
    `edge_tile` None: `TAIL_EDGE_TILE_INT8` for an integer strip, else
    `TAIL_EDGE_TILE`."""
    integer = not strip_dtype.is_floating_point
    if edge_tile is None:
        edge_tile = TAIL_EDGE_TILE_INT8 if integer else TAIL_EDGE_TILE
    device = csr.device if device is None else torch.device(device)
    v = csr.num_nodes
    s = strip_width(v, s_cols)
    rows, cols, vals = _live(csr.to(device))
    live = vals != 0
    in_strip = (cols < s) & live
    if integer:
        _check_integer_strip(vals[in_strip], strip_dtype)
    strip = _zeros_strip(v, s, strip_dtype, device)
    row_sums = _fill_strip(strip, rows[in_strip], cols[in_strip], vals[in_strip], 0)
    del in_strip

    in_tail = (cols >= s) & (rows >= s) & live
    tail_tiles = build_edge_tiles(
        _subgraph(v, rows[in_tail], cols[in_tail], vals[in_tail]), row_block, edge_tile
    ).to(device)
    bands, meta = [], []
    if tail_band_cols > 0 and v - s > tail_band_cols:
        band = _effective_band(v - s, tail_band_cols)
        for c0 in range(s, v, band):
            width = min(band, v - c0)
            m = in_tail & (cols >= c0) & (cols < c0 + width)
            if not bool(m.any()):
                continue  # an empty band would still cost a tile a block
            # columns rebased to the band's start: its scan gathers x[c0:c0 + width]
            sub = _subgraph(v, rows[m], cols[m] - c0, vals[m])
            # empty blocks elided: every band's scan is seeded (acc0)
            tb = build_edge_tiles(sub, row_block, edge_tile, elide_empty=True).to(device)
            bands.append(tb)
            meta.append((c0, width, max_block_span(tb.block, tail_chunk)))

    deg = torch.zeros(v, dtype=torch.float32, device=device).index_add_(0, rows, live.float())
    pre, post = _scales(deg, norm)
    return HybridSchedule(
        strip=strip, pre=pre, post=post, tail_tiles=tail_tiles, num_nodes=v, s_cols=s,
        tail_chunk=tail_chunk, tail_window=max_block_span(tail_tiles.block, tail_chunk),
        tail_bands=tuple(bands), tail_band_meta=tuple(meta), strip_row_sums=row_sums,
    )
