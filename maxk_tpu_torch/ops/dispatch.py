"""SpMM implementation selection.

Port of `maxk_tpu/ops/dispatch.py`. The port's SpMMs are the segment sum
(SEGSUM: the CSR kernels of `ops/spmm_csr.py` on a card, the edge-chunked
gather + index_add_ on the CPU) and the edge-tile SpMMs (TILES_XLA, the
one-shot form; TILES_SCAN, the chunked one) of `ops/spmm_xla.py`, and the
strip hybrid of `ops/spmm_hybrid.py` (HYBRID; HYBRID_INT8, its lossy
int8-feature form, which AUTO never picks). AUTO resolves to HYBRID when
the graph carries a strip schedule, as in the reference: the training
setup builds one under AUTO on a CUDA card where it pays
(`sparse/hybrid.auto_hybrid`), as the reference does on a TPU. Otherwise
AUTO is SEGSUM: the reference picks TILES_SCAN on a TPU, and the port keeps
SEGSUM on CUDA, where the tiles lose (ROADMAP C). PALLAS raises for the
reference's reason (`maxk_tpu/ops/spgemm.py:105-114`): the brick SpMM is a
benchmark kernel, not a production one.
"""

from __future__ import annotations

import enum


class KernelMode(str, enum.Enum):
    AUTO = "auto"
    HYBRID = "hybrid"
    HYBRID_INT8 = "hybrid_int8"
    PALLAS = "pallas"
    TILES_XLA = "tiles_xla"
    TILES_SCAN = "tiles_scan"
    SEGSUM = "segsum"


TILE_MODES = (KernelMode.TILES_XLA, KernelMode.TILES_SCAN)
HYBRID_MODES = (KernelMode.HYBRID, KernelMode.HYBRID_INT8)


def resolve_mode(mode, has_tiles: bool = False, has_hybrid: bool = False) -> KernelMode:
    """The SpMM that `mode` runs. AUTO is HYBRID on a graph with a strip
    schedule (`has_hybrid`), else SEGSUM whether or not the graph carries
    tile tables (`has_tiles`, the reference's argument)."""
    mode = KernelMode(mode)
    if mode == KernelMode.AUTO:
        return KernelMode.HYBRID if has_hybrid else KernelMode.SEGSUM
    if mode != KernelMode.PALLAS:
        return mode
    raise NotImplementedError(
        "kernel_mode='pallas' has no production kernel, as in the reference: "
        "the brick SpMM (ROADMAP B5) is reachable through "
        "maxk_tpu_torch.ops.spmm_bricks.spmm_bricks and "
        "`python -m maxk_tpu_torch.bench.probe_bricks`; train with "
        "kernel_mode='auto'"
    )


def missing_hybrid(mode) -> ValueError:
    """The error of a hybrid mode on a graph without a strip schedule (the
    reference's text)."""
    return ValueError(
        f"kernel_mode='{KernelMode(mode).value}' needs a graph built with "
        "build_graph(hybrid=True) (undirected graphs only)"
    )
