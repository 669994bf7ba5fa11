"""The GNN layers and models, and the flax parameter importer."""

from maxk_tpu_torch.models.layers import MaxKGINConv, MaxKGraphConv, MaxKSAGEConv
from maxk_tpu_torch.models.models import (
    GCN,
    GIN,
    SAGE,
    GNNRes,
    MaxKGCN,
    MaxKGIN,
    MaxKSAGE,
    build_model,
)

__all__ = [
    "MaxKSAGEConv",
    "MaxKGraphConv",
    "MaxKGINConv",
    "MaxKSAGE",
    "MaxKGCN",
    "MaxKGIN",
    "SAGE",
    "GCN",
    "GIN",
    "GNNRes",
    "build_model",
]
