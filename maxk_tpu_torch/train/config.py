"""Training configuration — port of `maxk_tpu/train/config.py`.

The same flags and validation messages as `train.py`, plus `--device`
(default `cuda`). `--kernel_mode pallas` and `--model gnn_res` with
`--mesh_shape` > 1 raise `NotImplementedError` naming the ROADMAP item, as
the reference refuses or lacks them too.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass, fields

from maxk_tpu_torch.ops.dispatch import resolve_mode


@dataclass
class TrainConfig:
    dataset: str = "reddit"
    model: str = "sage"  # sage | gcn | gin | gnn_res
    epochs: int = 500
    lr: float = 0.01
    weight_decay: float = 0.0
    hidden_dim: int = 256
    hidden_layers: int = 3
    nonlinear: str = "maxk"  # maxk | relu
    maxk: int = 32
    dropout: float = 0.5
    norm: bool = False
    seed: int = 97
    path: str = "experiment"
    data_scale: float = 1.0
    # feature SNR of the planted-partition generator
    feat_snr: float = 0.5
    enable_lookahead: bool = False
    save_model: bool = False
    evaluate: str = ""  # checkpoint path: eval-only mode
    checkpoint_every: int = 0  # 0 = only final/best
    kernel_mode: str = "auto"  # auto|hybrid|hybrid_int8|pallas|tiles_xla|tiles_scan|segsum
    compute_dtype: str = ""  # "" | bfloat16
    validate_kernels: bool = False
    profile_kernels: bool = False
    row_block: int = 8
    edge_tile: int = 256
    mesh_shape: int = 0  # > 1: that many ranks, one per device (row-partitioned)
    w_lookahead: int = 5
    device: str = "cuda"  # torch device the run uses; never falls back

    def as_markdown(self) -> str:
        lines = ["|name|value|", "|-|-|"]
        for f in fields(self):
            lines.append(f"|{f.name}|{getattr(self, f.name)}|")
        return "\n".join(lines)

    def validate(self) -> None:
        if self.model not in ("sage", "gcn", "gin", "gnn_res"):
            raise ValueError(
                f"--model must be one of sage|gcn|gin|gnn_res, got {self.model!r}"
            )
        if self.nonlinear not in ("maxk", "relu"):
            raise ValueError(
                f"--nonlinear must be maxk|relu, got {self.nonlinear!r}"
            )
        if not 1 <= self.maxk <= self.hidden_dim:
            raise ValueError(
                f"--maxk must be in [1, hidden_dim={self.hidden_dim}], "
                f"got {self.maxk}"
            )
        modes = ("auto", "hybrid", "hybrid_int8", "pallas", "tiles_xla",
                 "tiles_scan", "segsum")
        if self.kernel_mode not in modes:
            raise ValueError(
                f"--kernel_mode must be one of {'|'.join(modes)}, "
                f"got {self.kernel_mode!r}"
            )
        self._check_ported()

    def _check_ported(self) -> None:
        resolve_mode(self.kernel_mode)
        if self.mesh_shape > 1:
            from maxk_tpu_torch.parallel.train import check_sharded_model

            check_sharded_model(self.model)


HELP = {
    "validate_kernels": "before the first step, hold maxk_spgemm under --kernel_mode against "
                        "the plain path on the features' first hidden_dim columns (MaxK runs "
                        "only); a failure raises. The row-partitioned path (--mesh_shape > 1) "
                        "does not read it, as in the reference",
}


def parse_args(argv=None) -> TrainConfig:
    p = argparse.ArgumentParser(description="maxk_tpu_torch GNN training")
    defaults = TrainConfig()
    for f in fields(TrainConfig):
        flag = "--" + f.name
        default = getattr(defaults, f.name)
        if f.type == "bool" or isinstance(default, bool):
            p.add_argument(flag, action="store_true", default=default, help=HELP.get(f.name))
        else:
            p.add_argument(flag, type=type(default), default=default, help=HELP.get(f.name))
    ns = p.parse_args(argv)
    cfg = TrainConfig(**vars(ns))
    cfg.validate()
    return cfg
