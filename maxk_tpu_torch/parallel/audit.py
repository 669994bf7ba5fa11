"""The collective byte model of the row-partitioned path.

A copy of `maxk_tpu/parallel/audit.py`'s `model_recv_bytes_fwd_bwd`, but
for the `maxk` arm's backward: the port samples the (Vp, D) cotangent
partials at the CBSR selectors before the reduce_scatter (`ops/spgemm.py`),
so it moves (Vp, k), r·Vp·(D − k)·ct bytes fewer than the reference's. The
reference's HLO parsers (`hlo_collectives`, `recv_bytes_per_device`) have
no counterpart: the port's collectives count what they move in the mesh's
`ByteCounter` (`parallel/collectives.py`), which the tests hold to this
model.
"""

from __future__ import annotations


def model_recv_bytes_fwd_bwd(
    arm: str,
    n: int,
    vp: int,
    d: int,
    k: int = 0,
    vals_itemsize: int = 4,
    sel_itemsize: int = 4,
    x_itemsize: int = 4,
    ct_itemsize: int = 4,
    s_cols: int = 0,
) -> float:
    """Receive bytes per device for ONE aggregation forward + backward on
    n ranks over Vp padded rows of width d, by the ring model:

      maxk:        fwd all_gather of the CBSR, Vp·k·(vals + sel bytes);
                   bwd reduce_scatter of (Vp, k) sampled cotangent partials
      relu:        fwd all_gather of dense rows, Vp·D·x bytes; bwd
                   reduce_scatter of (Vp, D) cotangent partials
      maxk_hybrid: fwd CBSR all_gather + one (S, D) f32 hub all_reduce;
                   bwd cotangent all_gather (Vp, D) + one hub all_reduce
      relu_hybrid: the same with a dense forward gather
    """
    r = (n - 1) / n
    hub = 2 * r * s_cols * d * 4  # one (S, D) f32 all-reduce, ring
    if arm == "maxk":
        return r * vp * k * (vals_itemsize + sel_itemsize + ct_itemsize)
    if arm == "relu":
        return r * vp * d * (x_itemsize + ct_itemsize)
    if arm == "maxk_hybrid":
        return (
            r * vp * k * (vals_itemsize + sel_itemsize)
            + r * vp * d * ct_itemsize
            + 2 * hub
        )
    if arm == "relu_hybrid":
        return r * vp * d * (x_itemsize + ct_itemsize) + 2 * hub
    raise ValueError(f"unknown arm {arm!r}")
