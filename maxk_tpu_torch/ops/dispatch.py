"""SpMM implementation selection.

Port of `maxk_tpu/ops/dispatch.py`. The port's SpMMs are the edge-chunked
gather + index_add_ (SEGSUM) and the edge-tile SpMMs (TILES_XLA, the
one-shot form; TILES_SCAN, the chunked one) of `ops/spmm_xla.py`. AUTO
resolves to SEGSUM: the reference picks TILES_SCAN on a TPU only, and the
port keeps SEGSUM on CUDA until a run on the card shows that the tiles win.
PALLAS raises for the reference's reason (`maxk_tpu/ops/spgemm.py:
105-114`): the brick SpMM is a benchmark kernel, not a production one. The
strip-hybrid modes name the ROADMAP item that ports them.
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


def resolve_mode(mode, has_tiles: bool = False) -> KernelMode:
    """The SpMM that `mode` runs. AUTO is SEGSUM whether or not the graph
    carries tile tables (`has_tiles`, the reference's argument)."""
    mode = KernelMode(mode)
    if mode in (KernelMode.AUTO, KernelMode.SEGSUM):
        return KernelMode.SEGSUM
    if mode in TILE_MODES:
        return mode
    if mode == KernelMode.PALLAS:
        raise NotImplementedError(
            "kernel_mode='pallas' has no production kernel, as in the reference: "
            "the brick SpMM (ROADMAP B5) is reachable through "
            "maxk_tpu_torch.ops.spmm_bricks.spmm_bricks and "
            "`python -m maxk_tpu_torch.bench.probe_bricks`; train with "
            "kernel_mode='auto' (segsum)"
        )
    raise NotImplementedError(
        f"kernel_mode={mode.value!r} is not ported yet (the strip-hybrid SpMM: ROADMAP A13)"
    )
