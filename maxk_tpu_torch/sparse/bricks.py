"""Brick schedules: the stream that the brick SpMM (`ops/spmm_bricks.py`) walks.

Port of `maxk_tpu/sparse/bricks.py` (`build_bricks`, `bricks_stats`). A is
cut into (WB × WIN) bricks; only occupied bricks appear. Output rows are
grouped into supergroups of SG rows, source rows into panels of PANEL
rows; a supergroup × panel cell owns the bricks inside it. Each brick's
edges stream as fixed T-slot subtiles (padded per brick), CH subtiles to a
chunk, and chunks are sorted by (supergroup, panel), so one supergroup's
chunks are consecutive. Every supergroup has at least one chunk.

Layout (all tensors, on the device they were moved to):

    chunk_panel:   (NC,)        int32  X panel of each chunk
    chunk_sgroup:  (NC,)        int32  Y supergroup of each chunk (sorted)
    meta:          (NC, 1, CH)  int32  per subtile: bits 0-5 win, 6-8 rb,
                                       9 first, 10 end
    idx:           (NC, CH, T)  int32  per slot (lr << 7) | lc
    val:           (NC, CH, T)  f32    per slot edge weight (0 = padding)

`build_bricks` is the reference's numpy construction, bit-equal to it.
`schedule_from_numpy` takes a schedule's arrays from anywhere (the JAX
package's, as numpy) so the kernel can be held against a schedule made
elsewhere. The reference's on-device construction (`build_bricks_device`)
exists for its slow host uploads and is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from maxk_tpu_torch.sparse.csr import CSRGraph

# Defaults. WB/WIN are the brick dims; SG/PANEL the output and source row
# groups; T the edge slots of a subtile; CH subtiles per chunk.
SUPERGROUP = 512
PANEL = 4096
BRICK_ROWS = 128
BRICK_COLS = 128
SLOTS = 128
CHUNK = 32


@dataclass(frozen=True)
class BrickSchedule:
    chunk_panel: torch.Tensor
    chunk_sgroup: torch.Tensor
    meta: torch.Tensor
    idx: torch.Tensor
    val: torch.Tensor
    num_nodes: int = 0
    num_cols: int = 0
    sg: int = SUPERGROUP
    panel: int = PANEL
    wb: int = BRICK_ROWS
    win: int = BRICK_COLS

    @property
    def num_chunks(self) -> int:
        return self.meta.shape[0]

    @property
    def ch(self) -> int:
        return self.meta.shape[2]

    @property
    def slots(self) -> int:
        return self.idx.shape[2]

    @property
    def num_sgroups(self) -> int:
        return -(-self.num_nodes // self.sg)

    @property
    def num_panels(self) -> int:
        return -(-self.num_cols // self.panel)

    @property
    def device(self) -> torch.device:
        return self.val.device

    def to(self, device) -> "BrickSchedule":
        return BrickSchedule(
            chunk_panel=self.chunk_panel.to(device),
            chunk_sgroup=self.chunk_sgroup.to(device),
            meta=self.meta.to(device),
            idx=self.idx.to(device),
            val=self.val.to(device),
            num_nodes=self.num_nodes,
            num_cols=self.num_cols,
            sg=self.sg,
            panel=self.panel,
            wb=self.wb,
            win=self.win,
        )


def _check_dims(sg, panel, wb, win, t, ch) -> None:
    if not (sg % wb == 0 and panel % win == 0):
        raise ValueError(
            f"bricks: sg={sg} must be a multiple of wb={wb}, panel={panel} of win={win}"
        )
    if sg // wb > 8:
        raise ValueError(f"bricks: sg/wb={sg // wb} > 8 (the rb field is 3 bits)")
    if panel // win > 64:
        raise ValueError(f"bricks: panel/win={panel // win} > 64 (the win field is 6 bits)")
    if not (wb <= 512 and win <= 128):
        raise ValueError(f"bricks: wb={wb} > 512 or win={win} > 128 (lr/lc pack into 7+N bits)")
    if not (t % 8 == 0 and ch >= 1):
        raise ValueError(f"bricks: t={t} must be a multiple of 8 and ch={ch} >= 1")


def schedule_from_numpy(
    chunk_panel,
    chunk_sgroup,
    meta,
    idx,
    val,
    num_nodes: int,
    num_cols: int,
    sg: int = SUPERGROUP,
    panel: int = PANEL,
    wb: int = BRICK_ROWS,
    win: int = BRICK_COLS,
) -> BrickSchedule:
    """A CPU `BrickSchedule` from a schedule's arrays (anything numpy reads)."""
    meta = np.asarray(meta, dtype=np.int32)
    idx = np.asarray(idx, dtype=np.int32)
    _check_dims(sg, panel, wb, win, idx.shape[2], meta.shape[2])

    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype))  # a writable copy

    return BrickSchedule(
        chunk_panel=t(chunk_panel, np.int32),
        chunk_sgroup=t(chunk_sgroup, np.int32),
        meta=t(meta, np.int32),
        idx=t(idx, np.int32),
        val=t(val, np.float32),
        num_nodes=int(num_nodes),
        num_cols=int(num_cols),
        sg=sg,
        panel=panel,
        wb=wb,
        win=win,
    )


def build_bricks(
    g: CSRGraph,
    sg: int = SUPERGROUP,
    panel: int = PANEL,
    wb: int = BRICK_ROWS,
    win: int = BRICK_COLS,
    t: int = SLOTS,
    ch: int = CHUNK,
) -> BrickSchedule:
    """Host (numpy) schedule build, a pure function of the graph; returns a
    CPU schedule (`.to(device)` moves it)."""
    _check_dims(sg, panel, wb, win, t, ch)
    indptr = g.indptr.cpu().numpy().astype(np.int64)
    nnz = int(indptr[-1])  # live edges
    cols = g.indices.cpu().numpy().astype(np.int64)[:nnz]
    vals = g.values.cpu().numpy().astype(np.float32)[:nnz]
    v = indptr.shape[0] - 1
    rows = np.repeat(np.arange(v, dtype=np.int64), np.diff(indptr))

    ns = -(-v // sg)
    npan = -(-v // panel)
    rbs = sg // wb
    wins = panel // win

    s = rows // sg
    rb = (rows % sg) // wb
    lr = rows % wb
    p = cols // panel
    w = (cols % panel) // win
    lc = cols % win
    cell = s * npan + p
    brick = (cell * rbs + rb) * wins + w

    order = np.argsort(brick, kind="stable")
    brick_s = brick[order]
    packed = ((lr[order] << 7) | lc[order]).astype(np.int32)
    val_s = vals[order]

    nbricks = ns * npan * rbs * wins
    cnt = np.bincount(brick_s, minlength=nbricks).astype(np.int64)
    st_per_brick = -(-cnt // t)  # 0 for empty bricks
    brick_edge_off = np.cumsum(cnt) - cnt
    brick_st_cum = np.cumsum(st_per_brick)

    ncells = ns * npan
    cell_st = np.bincount(
        np.arange(nbricks) // (rbs * wins), weights=st_per_brick, minlength=ncells
    ).astype(np.int64)
    cell_chunks = -(-cell_st // ch)
    # every supergroup needs >= 1 chunk so its Y rows are written
    per_sg = cell_chunks.reshape(ns, npan).sum(axis=1)
    empty_sg = np.nonzero(per_sg == 0)[0]
    cell_chunks[empty_sg * npan] = 1

    nc = int(cell_chunks.sum())
    chunk_cell = np.repeat(np.arange(ncells, dtype=np.int64), cell_chunks)

    # global padded-subtile index -> (brick, within-brick subtile)
    cell_pad_off = np.cumsum(cell_chunks * ch) - cell_chunks * ch
    cell_real_off = np.cumsum(cell_st) - cell_st
    st = np.arange(nc * ch, dtype=np.int64)
    st_cell = chunk_cell[st // ch]
    jj = st - cell_pad_off[st_cell]
    real = jj < cell_st[st_cell]
    rst = np.minimum(cell_real_off[st_cell] + jj, max(brick_st_cum[-1] - 1, 0))
    bk = np.searchsorted(brick_st_cum, rst, side="right")
    k = rst - (brick_st_cum[bk] - st_per_brick[bk])

    m_win = bk % wins
    m_rb = (bk // wins) % rbs
    m_first = (k == 0).astype(np.int64)
    m_end = (k == st_per_brick[bk] - 1).astype(np.int64)
    meta = np.where(real, m_win | (m_rb << 6) | (m_first << 9) | (m_end << 10), 0)

    e = brick_edge_off[bk][:, None] + (k[:, None] * t + np.arange(t)[None, :])
    valid = real[:, None] & (e < (brick_edge_off[bk] + cnt[bk])[:, None])
    ec = np.clip(e, 0, max(nnz - 1, 0))
    idx = np.where(valid, packed[ec], 0)
    val = np.where(valid, val_s[ec], 0.0)

    return schedule_from_numpy(
        chunk_panel=chunk_cell % npan,
        chunk_sgroup=chunk_cell // npan,
        meta=meta.reshape(nc, 1, ch),
        idx=idx.reshape(nc, ch, t),
        val=val.reshape(nc, ch, t),
        num_nodes=v,
        num_cols=v,
        sg=sg,
        panel=panel,
        wb=wb,
        win=win,
    )


def bricks_stats(sched: BrickSchedule) -> dict:
    """Occupancy diagnostics (host): slot fill rate, chunks, and the
    reference's dense counts: `flush_tflop` is the dense (WB × WIN) @
    (WIN × 256) flush per brick that the TPU kernel does, not work the CUDA
    kernel does."""
    val = sched.val.cpu().numpy()
    meta = sched.meta.cpu().numpy()
    live = int((val != 0).sum())
    slots = val.size
    flushes = int(((meta >> 10) & 1).sum())
    return {
        "chunks": sched.num_chunks,
        "subtiles": meta.size,
        "slots": slots,
        "live_edges": live,
        "fill": live / max(slots, 1),
        "bricks": flushes,
        "densify_tflop": meta.size * sched.slots * sched.wb * sched.win * 2 / 1e12,
        "flush_tflop": flushes * sched.wb * sched.win * 256 * 2 / 1e12,
    }
