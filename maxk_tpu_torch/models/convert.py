"""Import the JAX package's flax parameters into the port's modules.

A flax `Dense.kernel` is (in, out) and `nn.Linear.weight` is (out, in);
`LayerNorm.scale` and `BatchNorm.scale` become `weight`; GIN's scalar
`eps` stays `eps`; BatchNorm's `batch_stats` (`mean`, `var`) become the
buffers of the same names.
Module names carry over unchanged, so `params["conv0"]["fc_self"]["kernel"]`
lands in `conv0.fc_self.weight`, and GCN's `conv0.weight.kernel` in
`conv0.weight.weight`.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Optional

import numpy as np
import torch


def import_flax_params(params: Mapping, batch_stats: Optional[Mapping] = None
                       ) -> Dict[str, torch.Tensor]:
    """flax params (nested dict of arrays), and for `GNNRes` its
    `batch_stats`, → a state_dict for the port's model of the same family."""
    out: Dict[str, torch.Tensor] = {}

    def walk(prefix: str, node: Mapping) -> None:
        for name, leaf in node.items():
            if isinstance(leaf, Mapping):
                walk(f"{prefix}{name}.", leaf)
                continue
            arr = np.asarray(leaf, dtype=np.float32)
            if name == "kernel":
                out[prefix + "weight"] = torch.from_numpy(np.ascontiguousarray(arr.T))
            elif name == "scale":
                out[prefix + "weight"] = torch.from_numpy(arr.copy())
            elif name in ("bias", "eps", "mean", "var"):
                out[prefix + name] = torch.from_numpy(arr.copy())
            else:
                raise KeyError(f"no torch counterpart for parameter {prefix}{name}")

    walk("", params)
    if batch_stats is not None:
        walk("", batch_stats)
    return out
