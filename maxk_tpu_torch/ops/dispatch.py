"""SpMM implementation selection.

Port of `maxk_tpu/ops/dispatch.py`. The port has one production SpMM so
far, the edge-chunked gather + index_add_ of `ops/spmm_xla.py`: AUTO
resolves to SEGSUM, and every other mode raises. PALLAS raises for the
reference's reason (`maxk_tpu/ops/spgemm.py:105-114`): the brick SpMM is a
benchmark kernel, not a production one. The others name the ROADMAP item
that ports them.
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
    KernelMode.TILES_XLA: "the edge-tile SpMM: ROADMAP A12",
    KernelMode.TILES_SCAN: "the edge-tile SpMM: ROADMAP A12",
}


def resolve_mode(mode) -> KernelMode:
    mode = KernelMode(mode)
    if mode in (KernelMode.AUTO, KernelMode.SEGSUM):
        return KernelMode.SEGSUM
    if mode == KernelMode.PALLAS:
        raise NotImplementedError(
            "kernel_mode='pallas' has no production kernel, as in the reference: "
            "the brick SpMM (ROADMAP B5) is reachable through "
            "maxk_tpu_torch.ops.spmm_bricks.spmm_bricks and "
            "`python -m maxk_tpu_torch.bench.probe_bricks`; train with "
            "kernel_mode='auto' (segsum)"
        )
    raise NotImplementedError(
        f"kernel_mode={mode.value!r} is not ported yet ({_NOT_PORTED[mode]})"
    )
