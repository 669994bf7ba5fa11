"""Build and load the hand-written CUDA kernels in `maxk_tpu_torch/csrc/`.

nvcc compiles every `.cu` there for `sm_90a` into one shared library with a
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
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# every entry point: (pointers..., ints..., stream) -> cudaError_t
SIGNATURES = {
    "maxk_mask_f32": (_P, _P, _P, _I, _I, _I, _P),
    "maxk_mask_bf16": (_P, _P, _P, _I, _I, _I, _P),
    "cbsr_densify_f32": (_P, _P, _P, _I, _I, _I, _P),
    "cbsr_densify_bf16": (_P, _P, _P, _I, _I, _I, _P),
    "cbsr_sample_f32": (_P, _P, _P, _I, _I, _I, _P),
    "cbsr_sample_bf16": (_P, _P, _P, _I, _I, _I, _P),
}

_lib = None


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


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    cu, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(name: str, t, dtypes) -> None:
    """Raise unless `t` is a contiguous 2-D CUDA tensor of one of `dtypes`
    on the current device (the kernels launch on its current stream)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(
            f"{name}: tensor on {t.device}, current device is "
            f"cuda:{torch.cuda.current_device()}"
        )
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != 2:
        raise ValueError(f"{name}: expected a 2-D tensor, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if t.shape[0] >= 2**31:
        raise ValueError(f"{name}: {t.shape[0]} rows exceed the int32 range")


def launch(name: str, *args) -> None:
    """Call one C entry point on the current stream; raise on a CUDA error."""
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
