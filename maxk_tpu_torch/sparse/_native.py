"""ctypes binding to the port's host preprocessing library (`csrc/meta.cpp`).

Port of `maxk_tpu/sparse/_native.py`: the edge-tile schedule builder and a
CSR transpose in C++. The library is compiled with the host C++ compiler
(`g++ -O3 -march=native -fPIC -std=c++17 -shared`) at first use, into
`csrc/build/` under a name that carries the hash of the source and the
flags, and loaded through ctypes. When it cannot be built or loaded,
`edge_tiles_native` and `csr_transpose_native` return None and callers
take their numpy path, as in the reference. Nothing here runs at import
time. This is not the CUDA build of `ops/_native.py`, which compiles only
the `*.cu` sources.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCE = "meta.cpp"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")

_lib = None
_tried = False


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update((CSRC / SOURCE).read_bytes())
    return BUILD_DIR / f"libmaxk_meta_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile `csrc/meta.cpp` unless a library for it exists; raise with
    the compiler's output when the build fails. The library is written
    under a temporary name and renamed, so concurrent builds never load a
    half-written file."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: sparse/_native builds csrc/meta.cpp with it")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = Path(tmpdir) / out.name
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(CSRC / SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed with exit code {proc.returncode}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, or None when it cannot be built or loaded (one
    attempt a process)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    i64, i32p, f32p, i64p = (
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64),
    )
    lib.edge_tiles_count.restype = i64
    lib.edge_tiles_count.argtypes = [i64p, i64, i64, i64]
    lib.edge_tiles_fill.restype = None
    lib.edge_tiles_fill.argtypes = [i64p, i32p, f32p, i64, i64, i64, i32p, i32p, f32p, i32p]
    lib.csr_transpose.restype = None
    lib.csr_transpose.argtypes = [i64p, i32p, f32p, i64, i64, i64p, i32p, f32p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def edge_tiles_native(
    indptr: np.ndarray, indices: np.ndarray, values: np.ndarray, row_block: int, edge_tile: int,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """(tile_block, cols, vals, localrow) numpy tables, or None without the
    library. `indices` and `values` hold at least indptr[-1] entries."""
    lib = _load()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    values = np.ascontiguousarray(values, dtype=np.float32)
    if indices.shape[0] < indptr[-1] or values.shape[0] < indptr[-1]:
        raise ValueError(f"edge_tiles_native: {indices.shape[0]} indices, {values.shape[0]} "
                         f"values for indptr[-1] = {indptr[-1]}")
    v = indptr.shape[0] - 1
    nt = lib.edge_tiles_count(_ptr(indptr, ctypes.c_int64), v, row_block, edge_tile)
    tile_block = np.zeros(nt, dtype=np.int32)
    cols = np.zeros(nt * edge_tile, dtype=np.int32)
    vals = np.zeros(nt * edge_tile, dtype=np.float32)
    localrow = np.zeros(nt * edge_tile, dtype=np.int32)
    lib.edge_tiles_fill(
        _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        _ptr(values, ctypes.c_float), v, row_block, edge_tile,
        _ptr(tile_block, ctypes.c_int32), _ptr(cols, ctypes.c_int32),
        _ptr(vals, ctypes.c_float), _ptr(localrow, ctypes.c_int32),
    )
    return (tile_block, cols.reshape(nt, edge_tile), vals.reshape(nt, edge_tile),
            localrow.reshape(nt, edge_tile))


def csr_transpose_native(
    indptr: np.ndarray, indices: np.ndarray, values: np.ndarray,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(indptr, indices, values) of Aᵀ, each output row sorted, or None
    without the library. Every column index must lie in [0, V)."""
    lib = _load()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    values = np.ascontiguousarray(values, dtype=np.float32)
    v = indptr.shape[0] - 1
    nnz = indices.shape[0]
    if values.shape[0] != nnz or indptr[-1] != nnz:
        raise ValueError(f"csr_transpose_native: indptr[-1] = {indptr[-1]}, "
                         f"{nnz} indices, {values.shape[0]} values")
    if nnz and (indices.min() < 0 or indices.max() >= v):
        raise ValueError(f"csr_transpose_native: a column index outside [0, {v})")
    out_indptr = np.zeros(v + 1, dtype=np.int64)
    out_indices = np.zeros(nnz, dtype=np.int32)
    out_values = np.zeros(nnz, dtype=np.float32)
    lib.csr_transpose(
        _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        _ptr(values, ctypes.c_float), v, nnz,
        _ptr(out_indptr, ctypes.c_int64), _ptr(out_indices, ctypes.c_int32),
        _ptr(out_values, ctypes.c_float),
    )
    return out_indptr, out_indices, out_values
