"""A cell's inputs, made on the device from the run's seed.

The graph follows the R-MAT of `maxk_tpu_torch/data/synthetic.rmat_graph`
(Graph500 a/b/c = 0.57/0.19/0.19 at scale ceil(log2 V), taken mod V,
relabelled by a random permutation, symmetrised, deduplicated), copied here in
torch so that it runs on the card in seconds where the host generator takes
about a minute at reddit's size. Two departures make it hold the published
graph's edges: pairs are drawn in rounds until the distinct undirected pairs
reach E/2 and a random E/2 of them are kept, so the graph has exactly E
directed edges (the host generator draws E/2 pairs once and loses about a
third of reddit's to duplicates); and it has no self-loops, as the reference's
sage launch scripts add none (the host generator adds one to every node). It
draws from torch's generator, not numpy's, so it is not bit-equal to the host
generator. Features are standard normal, labels uniform over the classes, and
the train / val / test masks a random split at the configuration's fractions.
Weights are one normal draw, each leaf scaled by 1/sqrt(fan_in), in the
reference's parameter order.

The graph is one draw from the configuration's own seed (`graph.seed`), as
a dataset is one graph: every run of a configuration aggregates over the
same edges, so the work of a run does not change with its seed. Everything
else (features, labels, split, weights) comes from one `torch.Generator`
on the device seeded with the run's seed, in a fixed order, so one seed
gives one set of inputs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

RMAT_CHUNK = 1 << 24  # pairs drawn a pass, as in the host generator


@dataclass
class Inputs:
    indptr: torch.Tensor  # (V+1,) int32, the raw graph (every value 1)
    indices: torch.Tensor  # (E,) int32, columns ascending within a row
    features: torch.Tensor  # (V, F) float32
    labels: torch.Tensor  # (V,) int64
    masks: tuple  # (train, val, test) (V,) bool
    weights: dict  # parameter name -> float32 tensor, the initial weights

    @property
    def num_nodes(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def num_edges(self) -> int:
        return self.indices.shape[0]


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2**64)
    return g


def rmat_pairs(scale: int, n: int, gen: torch.Generator, a: float, b: float, c: float):
    """(rows, cols) int64 of n R-MAT edges in a 2**scale square: each level
    picks a quadrant, top-left with probability a, bottom-left b, top-right
    c, bottom-right the rest (the host generator's quadrant rule)."""
    device = gen.device
    rows = torch.empty(n, dtype=torch.int64, device=device)
    cols = torch.empty(n, dtype=torch.int64, device=device)
    for start in range(0, n, RMAT_CHUNK):
        m = min(RMAT_CHUNK, n - start)
        r = torch.zeros(m, dtype=torch.int64, device=device)
        cl = torch.zeros(m, dtype=torch.int64, device=device)
        for _ in range(scale):
            u = torch.rand(m, generator=gen, device=device)
            right = u >= a + b
            down = ((u >= a) & (u < a + b)) | (u >= a + b + c)
            r = (r << 1) | down
            cl = (cl << 1) | right
        rows[start:start + m] = r
        cols[start:start + m] = cl
    return rows, cols


def rmat_csr(num_nodes: int, num_edges: int, gen: torch.Generator, a: float = 0.57,
             b: float = 0.19, c: float = 0.19):
    """(indptr, indices) int32 of an undirected R-MAT graph on `num_nodes`
    nodes with exactly `num_edges` directed edges (even), no self-loops and
    no duplicates: pairs are drawn in rounds, each sized by the last round's
    yield of new distinct pairs, until num_edges / 2 distinct undirected pairs
    are in hand, and a random num_edges / 2 of them are kept."""
    if num_edges % 2:
        raise ValueError(f"an undirected graph has an even edge count, got {num_edges}")
    device = gen.device
    v = num_nodes
    want = num_edges // 2
    if want > v * (v - 1) // 2:
        raise ValueError(f"{v} nodes hold at most {v * (v - 1)} directed edges")
    scale = max(1, math.ceil(math.log2(max(v, 2))))
    perm = torch.randperm(v, generator=gen, device=device)
    keys = torch.empty(0, dtype=torch.int64, device=device)
    draw, yield_ = want, 1.0
    while keys.numel() < want:
        rows, cols = rmat_pairs(scale, draw, gen, a, b, c)
        rows, cols = perm[rows % v], perm[cols % v]
        lo, hi = torch.minimum(rows, cols), torch.maximum(rows, cols)
        del rows, cols
        new = (lo * v + hi)[lo != hi]  # an undirected pair once, self-loops dropped
        del lo, hi
        before = keys.numel()
        keys = torch.unique(torch.cat([keys, new]))
        del new
        yield_ = max((keys.numel() - before) / draw, 1e-3)
        draw = min(int(1.1 * (want - keys.numel()) / yield_) + 1024, 1 << 31)
    if keys.numel() > want:
        keep = torch.randperm(keys.numel(), generator=gen, device=device)[:want]
        keys = torch.sort(keys[keep]).values
    lo, hi = keys // v, keys % v
    del keys
    keys = torch.sort(torch.cat([lo * v + hi, hi * v + lo])).values  # row-major, columns ascending
    del lo, hi
    counts = torch.bincount(keys // v, minlength=v)
    indptr = torch.zeros(v + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(counts, 0)
    return indptr.int(), (keys % v).int()


def split_masks(v: int, fractions, gen: torch.Generator):
    """(train, val, test) bool masks: a random order cut at the train and
    val fractions; the test mask takes the rest."""
    order = torch.randperm(v, generator=gen, device=gen.device)
    n_train = round(fractions[0] * v)
    n_val = round(fractions[1] * v)
    masks = []
    for lo, hi in ((0, n_train), (n_train, n_train + n_val), (n_train + n_val, v)):
        m = torch.zeros(v, dtype=torch.bool, device=gen.device)
        m[order[lo:hi]] = True
        masks.append(m)
    return tuple(masks)


def initial_weights(params, gen: torch.Generator) -> dict:
    """{name: tensor} for `params`, a list of (name, shape, fan_in): one
    normal draw, each leaf scaled by 1/sqrt(fan_in)."""
    sizes = [math.prod(shape) for _, shape, _ in params]
    flat = torch.randn(sum(sizes), generator=gen, device=gen.device)
    out = {}
    for (name, shape, fan_in), chunk in zip(params, torch.split(flat, sizes)):
        out[name] = (chunk * (1.0 / math.sqrt(fan_in))).view(shape).clone()
    return out


def make_graph(config: dict, device):
    """(indptr, indices) of `config`'s graph, drawn from the graph's seed."""
    g = config["graph"]
    return rmat_csr(config["num_nodes"], config["num_edges"], generator(g["seed"], device),
                    g["a"], g["b"], g["c"])


def make_inputs(config: dict, params, seed: int, device, graph=None) -> Inputs:
    """The inputs of a cell of `config` (its graph, or `graph` where one of
    `make_graph` is at hand, and sizes) and the initial weights of `params`,
    from `seed`, on `device`."""
    v = config["num_nodes"]
    indptr, indices = graph if graph is not None else make_graph(config, device)
    gen = generator(seed, device)
    features = torch.randn((v, config["feat_dim"]), generator=gen, device=gen.device)
    labels = torch.randint(0, config["num_classes"], (v,), generator=gen, device=gen.device)
    masks = split_masks(v, config["split"], gen)
    return Inputs(indptr=indptr, indices=indices, features=features, labels=labels,
                  masks=masks, weights=initial_weights(params, gen))
