"""Binary graph IO — the reference's on-disk kernel format.

A copy of `maxk_tpu/data/io.py`: two flat little-endian int32 files,
`<name>.indptr` and `<name>.indices`, plus an optional float32 `.values`
sidecar (absent → uniform 1.0). This is the `$MAXK_TPU_DATA` drop-in
path of `data/datasets.py`.
"""

from __future__ import annotations

import os

import numpy as np


def save_graph_binary(path_prefix: str, indptr, indices, values=None) -> None:
    os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
    np.asarray(indptr, dtype=np.int32).tofile(path_prefix + ".indptr")
    np.asarray(indices, dtype=np.int32).tofile(path_prefix + ".indices")
    if values is not None:
        np.asarray(values, dtype=np.float32).tofile(path_prefix + ".values")


def load_graph_binary(path_prefix: str):
    """Returns a CPU `CSRGraph` from `<prefix>.indptr/.indices[/.values]`."""
    import torch

    from maxk_tpu_torch.sparse.csr import CSRGraph

    indptr = np.fromfile(path_prefix + ".indptr", dtype=np.int32)
    indices = np.fromfile(path_prefix + ".indices", dtype=np.int32)
    vpath = path_prefix + ".values"
    if os.path.exists(vpath):
        values = np.fromfile(vpath, dtype=np.float32)
    else:
        values = np.ones(indices.shape[0], dtype=np.float32)
    if indptr[-1] != indices.shape[0]:
        raise ValueError(
            f"corrupt graph binary {path_prefix}: indptr[-1]={indptr[-1]} "
            f"!= nnz={indices.shape[0]}"
        )
    return CSRGraph(
        indptr=torch.from_numpy(indptr),
        indices=torch.from_numpy(indices),
        values=torch.from_numpy(values),
    )


def list_graph_binaries(directory: str):
    """All graph prefixes in a directory."""
    names = []
    for f in sorted(os.listdir(directory)):
        if f.endswith(".indptr"):
            names.append(os.path.join(directory, f[: -len(".indptr")]))
    return names
