"""Training CLI of the port — `train.py`'s flags plus `--device`.

  python -m maxk_tpu_torch --dataset reddit --model sage --maxk 32 \\
      --hidden_layers 4 --hidden_dim 256 --dropout 0.5 --lr 0.01
  python -m maxk_tpu_torch --mesh_shape 4 ...     (4 ranks, rows sharded)

Experiment artifacts land in `{path}/{dataset}_seed{seed}/{model}_{nonlinear}`.
`--device cuda` (the default) raises when no CUDA device is present.
`--mesh_shape N > 1` spawns N ranks, one per device (NCCL on `cuda:0..N-1`,
gloo with `--device cpu`), each loading the dataset and training its row
block; it raises, naming both counts, when fewer than N GPUs are present.
"""

from __future__ import annotations

import os

import torch


def run_sharded(cfg):
    """The `--mesh_shape N` run; returns rank 0's summary."""
    from maxk_tpu_torch.parallel.mesh import run_ranks
    from maxk_tpu_torch.parallel.train import run_rank

    return run_ranks(run_rank, cfg.mesh_shape, (cfg,), device_type=torch.device(cfg.device).type)[0]


def main(argv=None):
    from maxk_tpu_torch.data.datasets import load_dataset
    from maxk_tpu_torch.train.config import parse_args
    from maxk_tpu_torch.train.logging import ScalarWriter, experiment_dir, get_logger
    from maxk_tpu_torch.train.loop import resolve_device, train

    cfg = parse_args(argv)
    if cfg.mesh_shape > 1:
        return run_sharded(cfg)
    device = resolve_device(cfg.device)
    exp = experiment_dir(cfg)
    logger = get_logger(os.path.join(exp, "train.log"))
    writer = ScalarWriter(exp)
    try:
        logger.info(f"config: {cfg}")
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        logger.info(f"device: {device} ({name})")
        data = load_dataset(
            cfg.dataset, scale=cfg.data_scale, seed=123, feat_snr=cfg.feat_snr
        )
        logger.info(
            f"dataset {cfg.dataset}: V={data.csr.num_nodes} E={data.csr.nnz} "
            f"F={data.feat_dim} C={data.num_classes} multilabel={data.multilabel}"
        )
        return train(cfg, data, logger, writer)
    finally:
        writer.close()


if __name__ == "__main__":
    main()
