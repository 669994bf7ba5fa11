"""Build and load the hand-written CUDA kernels in `maxk_tpu_torch/csrc/`.

nvcc compiles every `.cu` there for `sm_90a`, one process per source, all
started together, and links the objects into one shared library with a
plain C interface, loaded through ctypes. No source includes PyTorch's
headers, so the build takes seconds. It runs at first use, into
`csrc/build/`, under a name that carries the hash of the sources and the
flags: an edited source builds anew. A failed build raises with nvcc's
output. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from maxk_tpu_torch import telemetry

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# every kernel's entry point: (pointers..., ints..., stream) -> cudaError_t
SIGNATURES = {
    "maxk_mask_f32": (_P, _P, _P, _I, _I, _I, _P),
    "maxk_mask_bf16": (_P, _P, _P, _I, _I, _I, _P),
    "topk_cbsr_f32": (_P, _P, _P, _I, _I, _I, _P),
    "topk_cbsr_bf16": (_P, _P, _P, _I, _I, _I, _P),
    "cbsr_densify_f32": (_P, _P, _P, _I, _I, _I, _P),
    "cbsr_densify_bf16": (_P, _P, _P, _I, _I, _I, _P),
    "cbsr_sample_f32": (_P, _P, _P, _I, _I, _I, _P),
    "cbsr_sample_bf16": (_P, _P, _P, _I, _I, _I, _P),
    "spmm_bricks_f32": (_P,) * 7 + (_I,) * 11 + (_P,),
    "spmm_bricks_bf16": (_P,) * 7 + (_I,) * 11 + (_P,),
    "spmm_bricks_smem_bytes": (_I, _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)),
    "slab_gather_f32": (_P, _P, _P, _I, _I, _I, _P),
    "slab_gather_bf16": (_P, _P, _P, _I, _I, _I, _P),
    "dma_gather": (_P, _P, _P, _I, _I, _I, _P),
    "take_rows_f32": (_P, _P, _P, _I, _I, _I, _P),
    "take_rows_bf16": (_P, _P, _P, _I, _I, _I, _P),
    "l2_cache_bytes": (ctypes.POINTER(_I),),
    # CSR (3) + segment table (6) [+ work order [+ hub table (2)]] +
    # features, [selectors, merged CBSR (2),] output, partials [, counters]
    "spmm_csr_f32": (_P,) * 14 + (_I,) * 5 + (_P,),
    "spmm_csr_bf16": (_P,) * 14 + (_I,) * 5 + (_P,),
    "spgemm_cbsr_f32": (_P,) * 19 + (_I,) * 8 + (_P,),
    "spgemm_cbsr_bf16": (_P,) * 19 + (_I,) * 8 + (_P,),
    "csr_kernels_layout": (_I, _I, _I) + (ctypes.POINTER(_I),) * 3,
    "sspmm_cbsr_f32": (_P,) * 15 + (_I,) * 8 + (_P,),
    "sspmm_cbsr_bf16": (_P,) * 15 + (_I,) * 8 + (_P,),
}

_lib = None
_fns = {}  # entry point name -> its ctypes function, bound once by library()


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (
        os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None,
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of maxk_tpu_torch are built from "
        "source at first use (set CUDA_HOME or put nvcc on PATH)"
    )


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libmaxk_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> None:
    """Start every command, wait for all; raise with the output of the
    first that failed."""
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for cmd in cmds
    ]
    failed = None
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, out + err)
    if failed is not None:
        cmd, code, output = failed
        raise RuntimeError(f"nvcc failed with exit code {code}:\n{' '.join(cmd)}\n{output}")


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    cu, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [Path(tmpdir) / f"{src.stem}.o" for src in cu]
        _run_all([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                 for src, obj in zip(cu, objs))
        tmp = Path(tmpdir) / out.name
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), its entry points
    bound in `_fns`."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[name] = fn
        _lib = lib
    return _lib


def check(name: str, t, dtypes, ndim: int = 2) -> None:
    """Raise unless `t` is a contiguous `ndim`-D CUDA tensor of one of
    `dtypes` whose dims fit int32. `launch` checks that the tensor the
    kernel runs with lies on the current device."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected a {ndim}-D tensor, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    for n in t.shape:
        if n >= 2**31:
            raise ValueError(f"{name}: shape {tuple(t.shape)} exceeds the int32 range")


def launch(name: str, entry: str, t, *args) -> None:
    """Call the C entry point `entry` on the current stream of `t`'s device,
    which must be the current device (else the wrapper `name` raises); raise
    on a CUDA error, else count the launch under `name` in
    `telemetry.launches`. One device check a launch, and the stream as a raw
    handle: building a `torch.cuda.Stream` costs more host time than a
    small kernel's work."""
    dev = t.get_device()
    cur = torch._C._cuda_getDevice()
    if dev != cur:
        raise ValueError(f"{name}: tensor on cuda:{dev}, current device is cuda:{cur}")
    if not _fns:
        library()
    err = _fns[entry](*args, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} at launch")
    telemetry.launches[name] += 1


def l2_cache_bytes() -> int:
    """The current card's L2 size in bytes, as the device reports it
    (`cudaDevAttrL2CacheSize`)."""
    out = ctypes.c_int(0)
    err = library().l2_cache_bytes(ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"l2_cache_bytes: CUDA error {err}")
    return out.value
