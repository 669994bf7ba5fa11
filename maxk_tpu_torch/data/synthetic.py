"""Synthetic graph generators (seeded, vectorized numpy).

A copy of `maxk_tpu/data/synthetic.py` (`rmat_edges`, `rmat_graph`,
`dcsbm_graph`, `planted_partition_data`), kept bit-equal on the same
seeds: the same `rng` calls in the same order. The JAX package's
`__init__` imports jax, so the port cannot import it. Graphs come back as
the port's `CSRGraph`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def rmat_edges(
    scale: int,
    num_edges: int,
    seed: int = 123,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    chunk: int = 1 << 24,
) -> Tuple[np.ndarray, np.ndarray]:
    """R-MAT edge generator (Graph500 parameters): V = 2**scale."""
    rng = np.random.default_rng(seed)
    rows = np.empty(num_edges, dtype=np.int64)
    cols = np.empty(num_edges, dtype=np.int64)
    for start in range(0, num_edges, chunk):
        n = min(chunk, num_edges - start)
        r = np.zeros(n, dtype=np.int64)
        cl = np.zeros(n, dtype=np.int64)
        for _ in range(scale):
            u = rng.random(n)
            right = (u >= a + b) & (u < a + b + c) | (u >= a + b + c)
            down = ((u >= a) & (u < a + b)) | (u >= a + b + c)
            r = (r << 1) | down.astype(np.int64)
            cl = (cl << 1) | right.astype(np.int64)
        rows[start : start + n] = r
        cols[start : start + n] = cl
    return rows, cols


def rmat_graph(num_nodes: int, num_edges: int, seed: int = 123):
    """Undirected, deduplicated, self-looped CSR at roughly (V, E).

    Nodes are relabeled by a random permutation so community structure
    isn't axis-aligned. Returns a `CSRGraph` on the CPU.
    """
    from maxk_tpu_torch.sparse.csr import csr_from_coo

    scale = max(1, int(np.ceil(np.log2(max(num_nodes, 2)))))
    rows, cols = rmat_edges(scale, num_edges // 2 + num_edges % 2, seed)
    rows %= num_nodes
    cols %= num_nodes
    rng = np.random.default_rng(seed + 1)
    perm = rng.permutation(num_nodes)
    rows, cols = perm[rows], perm[cols]
    # symmetrize + self loops (dataset_gen.py pipeline semantics)
    v = num_nodes
    rr = np.concatenate([rows, cols, np.arange(v)])
    cc = np.concatenate([cols, rows, np.arange(v)])
    return csr_from_coo(rr, cc, v)


def dcsbm_graph(
    num_nodes: int,
    num_edges: int,
    num_blocks: int,
    p_intra: float = 0.8,
    power: float = 0.75,
    seed: int = 123,
):
    """Degree-corrected stochastic block model: homophilous communities and
    power-law hubs. Returns (CPU `CSRGraph`, block labels int32 (V,)).

    The accuracy protocols (golden floors, k-sweep) train on it: R-MAT has
    no community structure, so at reddit's density aggregation mixes
    random-labelled neighbours; here neighbourhoods are label-correlated
    while the degree profile stays power-law."""
    from maxk_tpu_torch.sparse.csr import csr_from_coo

    rng = np.random.default_rng(seed)
    v = num_nodes
    block = rng.integers(0, num_blocks, size=v)
    # power-law node weights, randomly assigned (hubs in every block)
    w = rng.permutation(np.arange(1, v + 1)).astype(np.float64) ** -power
    w /= w.sum()
    e0 = num_edges // 2 + num_edges % 2
    src = rng.choice(v, size=e0, p=w)
    intra = rng.random(e0) < p_intra
    dst = np.empty(e0, dtype=np.int64)
    n_glob = int((~intra).sum())
    if n_glob:
        dst[~intra] = rng.choice(v, size=n_glob, p=w)
    for b in range(num_blocks):
        sel = intra & (block[src] == b)
        n = int(sel.sum())
        if n == 0:
            continue
        nodes_b = np.flatnonzero(block == b)
        wb = w[nodes_b]
        wb /= wb.sum()
        dst[sel] = rng.choice(nodes_b, size=n, p=wb)
    rr = np.concatenate([src, dst, np.arange(v)])
    cc = np.concatenate([dst, src, np.arange(v)])
    return csr_from_coo(rr, cc, v), block.astype(np.int32)


def planted_partition_data(
    csr,
    feat_dim: int,
    num_classes: int,
    seed: int = 123,
    multilabel: bool = False,
    homophily: float = 0.8,
    feat_snr: float = 0.5,
    labels_init=None,
):
    """Features/labels with learnable graph-correlated signal.

    Labels: propagate random seed-labels one hop so that neighborhoods are
    label-correlated (homophilous), making aggregation genuinely useful.
    Features: noisy class-indicator projections.
    Returns (features f32 (V,F), labels, train/val/test masks) as numpy.
    """
    from maxk_tpu_torch.sparse.csr import csr_to_scipy

    rng = np.random.default_rng(seed)
    m = csr_to_scipy(csr)
    v = m.shape[0]
    # labels_init (e.g. block ids) seeds the labels with the graph's own
    # community structure; the smoothing hop then reinforces it
    raw = (
        np.asarray(labels_init, dtype=np.int64)
        if labels_init is not None
        else rng.integers(0, num_classes, size=v)
    )
    onehot = np.zeros((v, num_classes), dtype=np.float32)
    onehot[np.arange(v), raw] = 1.0
    # one smoothing hop: node label = argmax of neighborhood label votes,
    # mixed with its own label by `homophily`
    votes = m @ onehot
    votes = votes / np.maximum(votes.sum(1, keepdims=True), 1e-6)
    mix = homophily * votes + (1 - homophily) * onehot
    if multilabel:
        labels = (mix > 1.0 / (2 * num_classes)).astype(np.float32)
    else:
        labels = mix.argmax(1).astype(np.int32)
        onehot = np.zeros((v, num_classes), dtype=np.float32)
        onehot[np.arange(v), labels] = 1.0
        mix = onehot
    proj = rng.standard_normal((num_classes, feat_dim)).astype(np.float32)
    feats = mix @ proj * feat_snr + rng.standard_normal((v, feat_dim)).astype(
        np.float32
    )
    # 60/20/20 seeded random split
    order = rng.permutation(v)
    train_mask = np.zeros(v, dtype=bool)
    val_mask = np.zeros(v, dtype=bool)
    test_mask = np.zeros(v, dtype=bool)
    train_mask[order[: int(0.6 * v)]] = True
    val_mask[order[int(0.6 * v) : int(0.8 * v)]] = True
    test_mask[order[int(0.8 * v) :]] = True
    return feats, labels, (train_mask, val_mask, test_mask)
