"""Golden-accuracy regression floors — port of `maxk_tpu/train/golden.py`.

Each row trains one dataset's published architecture (hidden width,
layers, dropout from `scripts_train/*.sh`) on the calibrated synthetic
task: a DC-SBM graph at the dataset's shape (homophilous communities and
power-law hubs, so aggregation helps as on the real datasets) with planted
features at a per-dataset feature SNR, at a scale a CPU trains in minutes.
A row passes when its best validation metric (accuracy, micro-F1 for
yelp, ROC-AUC for ogbn-proteins) reaches `min_val`.

The rows, floors and seeds are the JAX package's, copied because the port
cannot import it: each `min_val` is the JAX package's value measured by
`python -m maxk_tpu.train.golden --measure` minus a 0.04 margin. The port
draws its initial weights and dropout masks from torch generators, not
flax keys, so a row lands elsewhere in its band, never bit-equal; on a
CUDA device `index_add_` adds with atomics, so a row also moves a little
from run to run. The margin is there for both.

  python -m maxk_tpu_torch.train.golden --measure --device cpu
  python -m maxk_tpu_torch.train.golden --measure            (the card)
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass


@dataclass(frozen=True)
class GoldenConfig:
    dataset: str
    model: str
    nonlinear: str  # maxk | relu
    maxk: int
    hidden_dim: int
    hidden_layers: int
    lr: float
    dropout: float
    epochs: int
    scale: float
    min_val: float  # the JAX package's measured value - 0.04 margin
    # task overrides; default: ACC_PROTOCOL. A row pins its own task where
    # the sweep's discriminative one collapses to chance at golden's scale
    feat_snr: float = 0.0  # 0 = ACC_PROTOCOL value
    p_intra: float = -1.0  # <0 = ACC_PROTOCOL value (default 0.8)


# the accuracy protocol: per-dataset feature SNR, lr and, for reddit, the
# DC-SBM homophily p_intra (at reddit's density aggregation over an
# 0.8-homophilous neighbourhood denoises any SNR)
ACC_PROTOCOL = {
    "flickr": {"feat_snr": 0.15, "lr": 0.001},
    "reddit": {"feat_snr": 0.05, "lr": 0.001, "p_intra": 0.3},
    "yelp": {"feat_snr": 0.5, "lr": 0.001},
    "ogbn-products": {"feat_snr": 0.5, "lr": 0.003},
    "ogbn-proteins": {"feat_snr": 0.15, "lr": 0.01},
}
GRAPH_KIND = "sbm"

# published per-dataset architecture (reddit 4x256 dropout .5 | flickr
# 3x256 .2 | yelp 4x384 .1 | products 3x256 .5 | proteins 3x256 .5) at
# CPU-feasible scales. The JAX package measured (cpu backend, seed 97, data
# seed 123): reddit maxk 0.597 / relu 0.683, flickr 0.963 / 0.969, yelp
# 0.262 / 0.399, products 1.0 / 1.0, proteins 0.626 / 0.526; min_val is
# that minus about 0.04. reddit's maxk row trains at lr 0.01 (at 0.001 it
# sits near chance after 120 epochs), and both reddit rows pin the task
# snr 0.15, p_intra 0.8.
GOLDEN = [
    GoldenConfig("reddit", "sage", "maxk", 32, 256, 4, 0.01, 0.5, 120, 0.004, 0.56,
                 feat_snr=0.15, p_intra=0.8),
    GoldenConfig("reddit", "sage", "relu", 32, 256, 4, 0.001, 0.5, 120, 0.004, 0.64,
                 feat_snr=0.15, p_intra=0.8),
    GoldenConfig("flickr", "sage", "maxk", 32, 256, 3, 0.001, 0.2, 150, 0.05, 0.92),
    GoldenConfig("flickr", "sage", "relu", 32, 256, 3, 0.001, 0.2, 150, 0.05, 0.92),
    GoldenConfig("yelp", "sage", "maxk", 32, 384, 4, 0.001, 0.1, 120, 0.004, 0.22),
    GoldenConfig("yelp", "sage", "relu", 32, 384, 4, 0.001, 0.1, 120, 0.004, 0.35),
    GoldenConfig("ogbn-products", "sage", "maxk", 32, 256, 3, 0.003, 0.5, 120, 0.0004, 0.96),
    GoldenConfig("ogbn-products", "sage", "relu", 32, 256, 3, 0.003, 0.5, 120, 0.0004, 0.96),
    GoldenConfig("ogbn-proteins", "sage", "maxk", 32, 256, 3, 0.01, 0.5, 100, 0.002, 0.58),
    GoldenConfig("ogbn-proteins", "sage", "relu", 32, 256, 3, 0.01, 0.5, 100, 0.002, 0.48),
]

SEED = 97
DATA_SEED = 123

# rows the port misses at SEED, each logged under ROADMAP C with the JAX
# package's value beside the port's: row id -> the C entry
KNOWN_MISSES = {
    "reddit-sage-maxk": (
        "ROADMAP C, golden row reddit MaxK: at seed 97 the port reaches 0.5591 "
        "(CPU, 2 torch threads) against the 0.56 floor (JAX measured 0.597); over "
        "seeds 1-8 both packages spread alike (JAX 0.527-0.640, port 0.548-0.651), "
        "so the floor lies inside the row's own spread"
    ),
}


def row_id(gc: GoldenConfig) -> str:
    return f"{gc.dataset}-{gc.model}-{gc.nonlinear}"


def run_golden(gc: GoldenConfig, device: str = "cuda", seed: int = SEED):
    """Train one golden row on `device` from `seed` (weights and dropout);
    returns (best_val, best_test)."""
    from maxk_tpu_torch.data.datasets import load_dataset
    from maxk_tpu_torch.train.config import TrainConfig
    from maxk_tpu_torch.train.loop import train

    proto = ACC_PROTOCOL[gc.dataset]
    snr = gc.feat_snr or proto["feat_snr"]
    p_intra = gc.p_intra if gc.p_intra >= 0 else proto.get("p_intra", 0.8)
    data = load_dataset(gc.dataset, scale=gc.scale, seed=DATA_SEED, feat_snr=snr,
                        graph_kind=GRAPH_KIND, sbm_p_intra=p_intra)
    cfg = TrainConfig(
        dataset=gc.dataset, model=gc.model, epochs=gc.epochs, lr=gc.lr,
        hidden_dim=gc.hidden_dim, hidden_layers=gc.hidden_layers,
        nonlinear=gc.nonlinear, maxk=gc.maxk, dropout=gc.dropout, seed=seed,
        data_scale=gc.scale, feat_snr=snr, device=device,
    )
    state = train(cfg, data, logger=None, writer=None)
    return state.best_val, state.best_test


def main(argv=None):
    p = argparse.ArgumentParser(description="train every golden row and print "
                                "its best validation value beside its floor")
    p.add_argument("--measure", action="store_true",
                   help="train every golden row and print the measured best-val")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without one)")
    args = p.parse_args(argv)
    from maxk_tpu_torch.train.loop import resolve_device

    resolve_device(args.device)  # a missing card raises before any work
    rows = []
    for gc in GOLDEN:
        t0 = time.perf_counter()
        bv, bt = run_golden(gc, device=args.device)
        rows.append({
            "dataset": gc.dataset, "model": gc.model, "nonlinear": gc.nonlinear,
            "best_val": round(bv, 4), "best_test": round(bt, 4), "min_val": gc.min_val,
            "ok": bv >= gc.min_val,
        })
        print(f"{gc.dataset:14s} {gc.model} {gc.nonlinear:4s} val {bv:.4f} test {bt:.4f} "
              f"(floor {gc.min_val}) {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
