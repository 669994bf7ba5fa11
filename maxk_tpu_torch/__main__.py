"""Training CLI of the port — `train.py`'s flags plus `--device`.

  python -m maxk_tpu_torch --dataset reddit --model sage --maxk 32 \\
      --hidden_layers 4 --hidden_dim 256 --dropout 0.5 --lr 0.01

Experiment artifacts land in `{path}/{dataset}_seed{seed}/{model}_{nonlinear}`.
`--device cuda` (the default) raises when no CUDA device is present.
"""

from __future__ import annotations

import os

import torch


def main(argv=None):
    from maxk_tpu_torch.data.datasets import load_dataset
    from maxk_tpu_torch.train.config import parse_args
    from maxk_tpu_torch.train.logging import ScalarWriter, experiment_dir, get_logger
    from maxk_tpu_torch.train.loop import resolve_device, train

    cfg = parse_args(argv)
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
