"""Symmetric-strip hybrid SpMM over a `HybridSchedule`.

Port of `maxk_tpu/ops/spmm_hybrid.py` (see `sparse/hybrid.py` for the
decomposition):

    Y = post ⊙ ( [Wᵀ @ xs ; W[S:] @ xh]  +  tail_scan(xs) ),
    xs = pre ⊙ x,  xh = xs[:S]

Rows under S take all their columns from Wᵀ @ xs (symmetry); rows from S
on take their hub columns from W[S:] @ xh and the rest from the tail's
tile scan (`spmm_tiles_scan`), which the strip products seed. Aᵀ swaps the
two scales, so `transpose=True` is the same computation, and the op's
gradient is the transposed op. The reference computes these in XLA; here
they are torch matrix products and the tile scan, with no kernel of the
port's own.

The strip products take the features in the strip's compute dtype (bf16
for an integer strip) and give f32: exact products, f32 sums, the role of
XLA's `preferred_element_type=float32`. On a CUDA card that is
`torch.mm(..., out_dtype=torch.float32)`; on the CPU both operands are
widened to f32 first. The strip is walked in row chunks of `ROW_CHUNK`,
hub rows [0, S) apart from the rest: an int8 strip converts a chunk at a
time into one reused bf16 buffer (torch has no int8 × bf16 product), so
its bytes stay int8, where a whole conversion would take 11.5 GB at
reddit's S = 24,576.

`feat_int8` (lossy, `hybrid_int8`) quantizes the features per column to
int8 for the two strip products, which then run int8 × int8 → int32
(`torch._int_mm`, whose CUDA kernels want k and n multiples of 8 and
m above 16: chunks are padded with zero rows to suit). The int32 sums are
exact while 127 × the strip's largest line sum stays under 2³¹, which is
checked. Every row takes a quantized term: rows under S all of theirs,
rows from S on their hub columns; only their tail columns use the
unquantized features.
"""

from __future__ import annotations

import torch

from maxk_tpu_torch.ops.spmm_xla import spmm_tiles_scan
from maxk_tpu_torch.parallel.collectives import all_reduce_sum
from maxk_tpu_torch.sparse.hybrid import HybridSchedule

ROW_CHUNK = 8192  # strip rows a product step takes
INT8_BOUND = 127


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with f32 output: bf16 operands multiply exactly and sum in
    f32; f32 operands multiply in f32 (TF32 off)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _row_ranges(n: int, split: int, chunk: int):
    """[r0, r1) ranges over n rows in chunks, none crossing `split`."""
    split = min(max(split, 0), n)
    for lo, hi in ((0, split), (split, n)):
        for r0 in range(lo, hi, chunk):
            yield r0, min(r0 + chunk, hi)


def _quant_cols(x: torch.Tensor, bound: int = INT8_BOUND):
    """Per-column symmetric int8 quantization, x ≈ x_q · scale: (x_q int8,
    scale (1, D) f32). A zero column gets the smallest normal scale."""
    xf = x.float()
    absmax = xf.abs().amax(0, keepdim=True)
    scale = absmax.clamp_min(torch.finfo(torch.float32).tiny) / bound
    xq = torch.clamp(torch.round(xf / scale), -bound, bound).to(torch.int8)
    return xq, scale


def _strip_operand(strip: torch.Tensor) -> torch.dtype:
    """The dtype the strip's products take: bf16 for an integer strip."""
    return torch.bfloat16 if not strip.dtype.is_floating_point else strip.dtype


def _strip_arms(strip, x_rows, xh, row0: int, chunk: int = ROW_CHUNK):
    """Over the strip's rows, global rows row0 on: the hub partial
    Wᵀ @ x_rows (S, D) and, for the rows at or past S, W @ xh (their hub
    columns; zero in the other rows), both f32."""
    n, s = strip.shape
    d = x_rows.shape[1]
    hub = torch.zeros((s, d), dtype=torch.float32, device=x_rows.device)
    low = torch.zeros((n, d), dtype=torch.float32, device=x_rows.device)
    convert = not strip.dtype.is_floating_point
    buf = None
    for r0, r1 in _row_ranges(n, s - row0, chunk):
        w = strip[r0:r1]
        if convert:  # one reused bf16 buffer: the strip stays int8
            if buf is None:
                buf = torch.empty((min(chunk, n), s), dtype=torch.bfloat16, device=strip.device)
            w = buf[: r1 - r0].copy_(w)
        hub += _mm_f32(w.t(), x_rows[r0:r1])
        if row0 + r0 >= s:
            low[r0:r1] = _mm_f32(w, xh)
    return hub, low


def _padded_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    if t.shape[0] == rows:
        return t
    out = t.new_zeros((rows,) + tuple(t.shape[1:]))
    out[: t.shape[0]] = t
    return out


def _strip_arms_int8(strip, xq_rows, xqh, row0: int, chunk: int = ROW_CHUNK):
    """`_strip_arms` for int8 operands, with int32 results. Each chunk is
    padded with zero rows to a multiple of 8 and more than 16 rows."""
    n, s = strip.shape
    d = xq_rows.shape[1]
    if s % 8 or d % 8:
        raise ValueError(f"feat_int8 needs S and D multiples of 8 (torch._int_mm), got S={s}, "
                         f"D={d}")
    hub_t = torch.zeros((d, s), dtype=torch.int32, device=xq_rows.device)
    low = torch.zeros((n, d), dtype=torch.int32, device=xq_rows.device)
    for r0, r1 in _row_ranges(n, s - row0, chunk):
        m = max(-(-(r1 - r0) // 8) * 8, 24)
        w = _padded_rows(strip[r0:r1], m)
        hub_t += torch._int_mm(_padded_rows(xq_rows[r0:r1], m).t().contiguous(), w)
        if row0 + r0 >= s:
            low[r0:r1] = torch._int_mm(w, xqh)[: r1 - r0]
    return hub_t.t(), low


def check_int32_sums(h) -> None:
    """Raise unless the int8 × int8 products' int32 sums cannot overflow:
    127 · (the strip's largest row or column sum of |W|) < 2³¹."""
    worst = INT8_BOUND * h.strip_line_sum
    if worst >= 2**31:
        raise ValueError(
            f"feat_int8: int32 sums may overflow: 127 x the strip's largest line sum "
            f"{h.strip_line_sum:g} = {worst:g} >= 2^31"
        )


def int8_error_bound(h: HybridSchedule, x: torch.Tensor, transpose: bool = False,
                     pre_applied: bool = False) -> float:
    """The most `feat_int8` can move an element of `spmm_hybrid(h, x)` from
    the exact hybrid's: each quantized feature is within scale_d / 2 of the
    bf16 feature, so row i moves by at most post_i · strip_row_sums_i ·
    max_d scale_d / 2 (before the f32 sums' rounding)."""
    pre, post = (h.post, h.pre) if transpose else (h.pre, h.post)
    xs = x if pre_applied else x * pre[:, None].to(x.dtype)
    _, scale = _quant_cols(xs.to(_strip_operand(h.strip)))
    return float((post.double() * h.strip_row_sums).max()) * float(scale.max()) / 2


def _check_feat_int8(h) -> None:
    if h.strip.dtype.is_floating_point:
        raise ValueError(
            "feat_int8 requires an integer strip (strip_dtype=int8): a float strip would "
            "make the int32 accumulation lossy on BOTH operands"
        )
    check_int32_sums(h)


def spmm_hybrid(
    h: HybridSchedule,
    x: torch.Tensor,
    transpose: bool = False,
    pre_applied: bool = False,
    feat_int8: bool = False,
) -> torch.Tensor:
    """y = A @ x (Aᵀ @ x with `transpose`) over the symmetric-strip
    decomposition, in x's dtype.

    `pre_applied`: x already carries the pre-scale (the CBSR path scales
    the (V, k) values before densify). `feat_int8` (lossy): per-column int8
    features on the strip products; it needs an integer strip, and every
    row's strip term carries the quantization error (rows from S on keep
    exact tail terms)."""
    s = h.s_cols
    pre, post = (h.post, h.pre) if transpose else (h.pre, h.post)
    xs = x if pre_applied else x * pre[:, None].to(x.dtype)
    xc = xs.to(_strip_operand(h.strip))
    if feat_int8:
        _check_feat_int8(h)
        xq, qscale = _quant_cols(xc)
        hub, y = _strip_arms_int8(h.strip, xq, xq[:s], 0)
        y = y.float() * qscale
        y[:s] = hub.float() * qscale
    else:
        hub, y = _strip_arms(h.strip, xc, xc[:s], 0)
        y[:s] = hub
    # the tail arm gathers xs in x's dtype; the strip terms seed its sum
    if h.tail_band_meta:
        for tiles_b, (c0, width, win) in zip(h.tail_bands, h.tail_band_meta):
            y = spmm_tiles_scan(tiles_b, xs[c0:c0 + width], chunk=h.tail_chunk, acc0=y,
                                window=win or None)
    else:
        y = spmm_tiles_scan(h.tail_tiles, xs, chunk=h.tail_chunk, acc0=y,
                            window=h.tail_window or None)
    return (y * post[:, None]).to(x.dtype)


def spmm_hybrid_sharded(h, x: torch.Tensor, mesh, transpose: bool = False,
                        pre_applied: bool = False) -> torch.Tensor:
    """This rank's (Vs, D) rows of A @ x (Aᵀ @ x with `transpose`) over a
    `parallel.shard.ShardedHybrid`, from the full (Vp, D) features x (the
    caller gathered them). Rank r's rows [r·Vs, (r+1)·Vs): those under S
    take the hub partials Wᵣᵀ @ xs[rows] summed over the ranks (one (S, D)
    f32 all_reduce, S·D·4 bytes a call whatever V and E); the others
    W_r @ xh plus their tail. The reference's sharded path has no
    `feat_int8`, and neither has this one."""
    s, vs = h.s_cols, h.shard_nodes
    r0 = mesh.rank * vs
    pre, post = (h.post, h.pre) if transpose else (h.pre, h.post)
    xs = x if pre_applied else x * pre[:, None].to(x.dtype)
    xc = xs.to(_strip_operand(h.strip))
    hub, y = _strip_arms(h.strip, xc[r0:r0 + vs], xc[:s], r0)
    hub = all_reduce_sum(hub, mesh)
    if r0 < s:
        y[: min(s - r0, vs)] = hub[r0:r0 + vs]
    y = spmm_tiles_scan(h.tail_tiles, xs, chunk=h.tail_chunk, acc0=y,
                        window=h.tail_window or None)
    return (y * post[r0:r0 + vs, None]).to(x.dtype)
