"""SpMM implementation selection.

Port of `maxk_tpu/ops/dispatch.py`. The port has one SpMM so far, the
edge-chunked gather + index_add_ of `ops/spmm_xla.py`: AUTO resolves to
SEGSUM, and every other mode raises, naming the ROADMAP item that ports it.
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


_NOT_PORTED = {
    KernelMode.HYBRID: "the strip-hybrid SpMM: ROADMAP A13",
    KernelMode.HYBRID_INT8: "the int8 strip-hybrid SpMM: ROADMAP A13",
    KernelMode.PALLAS: "the brick SpMM kernel: ROADMAP B5",
    KernelMode.TILES_XLA: "the edge-tile SpMM: ROADMAP A12",
    KernelMode.TILES_SCAN: "the edge-tile SpMM: ROADMAP A12",
}


def resolve_mode(mode) -> KernelMode:
    mode = KernelMode(mode)
    if mode in (KernelMode.AUTO, KernelMode.SEGSUM):
        return KernelMode.SEGSUM
    raise NotImplementedError(
        f"kernel_mode={mode.value!r} is not ported yet ({_NOT_PORTED[mode]})"
    )
