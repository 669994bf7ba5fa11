"""Import the JAX package's flax parameters into the port's modules.

A flax `Dense.kernel` is (in, out) and `nn.Linear.weight` is (out, in);
`LayerNorm.scale` becomes `weight`; GIN's scalar `eps` stays `eps`.
Module names carry over unchanged, so `params["conv0"]["fc_self"]["kernel"]`
lands in `conv0.fc_self.weight`, and GCN's `conv0.weight.kernel` in
`conv0.weight.weight`.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch


def import_flax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax params (nested dict of arrays) → a state_dict for the port's
    `MaxKSAGE`, `MaxKGCN` or `MaxKGIN`."""
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
            elif name in ("bias", "eps"):
                out[prefix + name] = torch.from_numpy(arr.copy())
            else:
                raise KeyError(f"no torch counterpart for parameter {prefix}{name}")

    walk("", params)
    return out
