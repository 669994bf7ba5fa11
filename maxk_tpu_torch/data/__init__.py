"""Dataset registry, seeded synthetic graphs and the binary graph format."""

from maxk_tpu_torch.data.datasets import DATASETS, GraphData, load_dataset
from maxk_tpu_torch.data.io import load_graph_binary, save_graph_binary
from maxk_tpu_torch.data.synthetic import planted_partition_data, rmat_graph

__all__ = [
    "DATASETS",
    "GraphData",
    "load_dataset",
    "rmat_graph",
    "planted_partition_data",
    "save_graph_binary",
    "load_graph_binary",
]
