"""Dataset registry — the five training datasets at their published shapes.

Port of `maxk_tpu/data/datasets.py`. Each dataset resolves in order:

  1. real binaries under `$MAXK_TPU_DATA/<name>.indptr/.indices`
     (+ optional `.feat`/`.labels`/`.masks` sidecars), at scale 1.0;
  2. a seeded synthetic graph with the dataset's published (V, E, F, C)
     and label regime (multilabel for yelp and ogbn-proteins): R-MAT
     (`graph_kind="rmat"`, the kernel benchmarks) or a DC-SBM
     (`graph_kind="sbm"`, the accuracy protocols). ogbn-proteins has edge
     features only; its node features are the mean of its incident edges'.

`scale` shrinks V and E proportionally (scale=1 is full size). Graphs are
built on the CPU; `build_graph` moves them to the run's device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from maxk_tpu_torch.data.io import load_graph_binary
from maxk_tpu_torch.data.proteins import node_features_from_edges
from maxk_tpu_torch.data.synthetic import dcsbm_graph, planted_partition_data, rmat_graph
from maxk_tpu_torch.sparse.csr import CSRGraph, add_self_loops


@dataclass
class DatasetSpec:
    num_nodes: int
    num_edges: int
    feat_dim: int
    num_classes: int
    multilabel: bool = False
    self_loop: bool = False  # per scripts_train/*.sh (flickr: yes)


# published stats of the reference's training datasets
DATASETS = {
    "flickr": DatasetSpec(89_250, 899_756, 500, 7, self_loop=True),
    "reddit": DatasetSpec(232_965, 114_615_892, 602, 41),
    "yelp": DatasetSpec(716_847, 13_954_819, 300, 100, multilabel=True),
    "ogbn-products": DatasetSpec(2_449_029, 123_718_280, 100, 47),
    "ogbn-proteins": DatasetSpec(132_534, 79_122_504, 8, 112, multilabel=True),
}


@dataclass
class GraphData:
    name: str
    csr: CSRGraph  # raw adjacency (undirected, dedup, ±self-loops), CPU
    features: np.ndarray
    labels: np.ndarray
    train_mask: np.ndarray
    val_mask: np.ndarray
    test_mask: np.ndarray
    num_classes: int
    multilabel: bool

    @property
    def feat_dim(self) -> int:
        return self.features.shape[1]


def _data_dir() -> Optional[str]:
    d = os.environ.get("MAXK_TPU_DATA")
    return d if d and os.path.isdir(d) else None


def load_dataset(
    name: str,
    scale: float = 1.0,
    seed: int = 123,
    feat_snr: float = 0.5,
    graph_kind: str = "rmat",
    sbm_p_intra: float = 0.8,
) -> GraphData:
    """Load or synthesize `name`.

    `graph_kind` selects the synthetic generator (ignored for real
    binaries): "rmat" (kernel benchmarks: the degree profile is what
    matters) or "sbm" (accuracy protocols: DC-SBM homophily makes
    aggregation useful; see `synthetic.dcsbm_graph`). `sbm_p_intra` is
    the DC-SBM's intra-community edge fraction, the difficulty knob of the
    accuracy protocol on dense graphs."""
    spec = DATASETS[name]
    d = _data_dir()
    prefix = os.path.join(d, name) if d else None
    if scale == 1.0 and prefix and os.path.exists(prefix + ".indptr"):
        csr = load_graph_binary(prefix)
        if spec.self_loop:
            csr = add_self_loops(csr)
        feats, labels, masks = _load_sidecars(prefix, csr, spec, seed)
    else:
        v = max(int(spec.num_nodes * scale), 64)
        e = max(int(spec.num_edges * scale), 256)
        labels_init = None
        if graph_kind == "sbm":
            csr, labels_init = dcsbm_graph(v, e, spec.num_classes, p_intra=sbm_p_intra, seed=seed)
        elif graph_kind == "rmat":
            csr = rmat_graph(v, e, seed=seed)
        else:
            raise ValueError(f"unknown graph_kind {graph_kind!r}")
        feats, labels, masks = planted_partition_data(
            csr, spec.feat_dim, spec.num_classes, seed=seed,
            multilabel=spec.multilabel, feat_snr=feat_snr, labels_init=labels_init,
        )
        if name == "ogbn-proteins":
            feats = _proteins_node_features(csr, feats, seed)
    return GraphData(
        name=name,
        csr=csr,
        features=feats,
        labels=labels,
        train_mask=masks[0],
        val_mask=masks[1],
        test_mask=masks[2],
        num_classes=spec.num_classes,
        multilabel=spec.multilabel,
    )


def _proteins_node_features(csr: CSRGraph, feats: np.ndarray, seed: int) -> np.ndarray:
    """The proteins regime has edge features only; node features are the
    incident-edge sum over the clamped degree. The synthetic edge features
    are coloured by their endpoints' planted features (`rng(seed + 1)`), so
    the task stays learnable through the pathway."""
    rows = csr.row_ids().numpy()
    cols = csr.indices.numpy()
    rng = np.random.default_rng(seed + 1)
    edge_feats = 0.5 * (feats[rows] + feats[cols]) + 0.25 * rng.standard_normal(
        (csr.nnz, feats.shape[1])
    ).astype(np.float32)
    deg = np.maximum(np.diff(csr.indptr.numpy()), 1)
    return node_features_from_edges(csr, edge_feats.astype(np.float32)).numpy() / deg[:, None]


def _load_sidecars(prefix: str, csr: CSRGraph, spec: DatasetSpec, seed: int):
    v = csr.num_nodes
    fpath, lpath, mpath = prefix + ".feat", prefix + ".labels", prefix + ".masks"
    if os.path.exists(fpath) and os.path.exists(lpath):
        feats = np.fromfile(fpath, dtype=np.float32).reshape(v, spec.feat_dim)
        if spec.multilabel:
            labels = np.fromfile(lpath, dtype=np.float32).reshape(
                v, spec.num_classes
            )
        else:
            labels = np.fromfile(lpath, dtype=np.int32)
        if os.path.exists(mpath):
            m = np.fromfile(mpath, dtype=np.int8).reshape(3, v).astype(bool)
            masks = (m[0], m[1], m[2])
        else:
            masks = _random_split(v, seed)
        return feats, labels, masks
    # graph is real but features aren't — synthesize the rest
    return planted_partition_data(
        csr, spec.feat_dim, spec.num_classes, seed=seed,
        multilabel=spec.multilabel,
    )


def _random_split(v: int, seed: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    order = rng.permutation(v)
    tm = np.zeros(v, dtype=bool)
    vm = np.zeros(v, dtype=bool)
    sm = np.zeros(v, dtype=bool)
    tm[order[: int(0.6 * v)]] = True
    vm[order[int(0.6 * v) : int(0.8 * v)]] = True
    sm[order[int(0.8 * v) :]] = True
    return tm, vm, sm
