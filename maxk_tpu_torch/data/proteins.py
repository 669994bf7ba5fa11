"""ogbn-proteins-style edge-feature handling.

Port of `maxk_tpu/data/proteins.py`: the proteins graph has 8-dim *edge*
features and no node features; a node's features are the sum of its
incident edges' features. Here that is one `index_add_` over the CSR's
row ids, in f32. It may add in another order than the JAX package's
`segment_sum`, so the two agree within rounding, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from maxk_tpu_torch.sparse.csr import CSRGraph


def node_features_from_edges(g: CSRGraph, edge_feats) -> torch.Tensor:
    """(E, F) edge features → (V, F) f32 node features by incident-edge sum,
    on the graph's device."""
    edge_feats = torch.as_tensor(edge_feats, dtype=torch.float32, device=g.device)
    out = torch.zeros((g.num_nodes, edge_feats.shape[1]), dtype=torch.float32, device=g.device)
    return out.index_add_(0, g.row_ids(), edge_feats)


def synthetic_edge_features(g: CSRGraph, feat_dim: int = 8, seed: int = 123) -> np.ndarray:
    """Random nonnegative edge features (the proteins regime: association
    scores in [0, 1])."""
    rng = np.random.default_rng(seed)
    return rng.random((g.nnz, feat_dim)).astype(np.float32)
