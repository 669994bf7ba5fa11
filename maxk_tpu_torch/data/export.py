"""Dataset → kernel-binary exporter CLI.

Port of `maxk_tpu/data/export.py`: load a dataset and write the
reference's binary layout (`.indptr`/`.indices` int32, `.values` f32,
`.feat` f32, `.labels` int32 or f32 when multilabel, `.masks` int8
(3, V)), then read the graph back and check it. The files are
byte-identical to the JAX package's on the same dataset and seed.

  python -m maxk_tpu_torch.data.export --dataset flickr --out graphs/
  python -m maxk_tpu_torch.data.export --all --out graphs/ --scale 0.01
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def export_dataset(name: str, out_dir: str, scale: float = 1.0, seed: int = 123) -> str:
    """Write `name` under `out_dir`; returns the files' path prefix."""
    from maxk_tpu_torch.data.datasets import load_dataset
    from maxk_tpu_torch.data.io import load_graph_binary, save_graph_binary

    data = load_dataset(name, scale=scale, seed=seed)
    prefix = os.path.join(out_dir, name if scale == 1.0 else f"{name}_x{scale}")
    csr = data.csr
    save_graph_binary(prefix, csr.indptr.numpy(), csr.indices.numpy(), csr.values.numpy())
    data.features.astype(np.float32).tofile(prefix + ".feat")
    data.labels.astype(np.float32 if data.multilabel else np.int32).tofile(prefix + ".labels")
    masks = np.stack([data.train_mask, data.val_mask, data.test_mask]).astype(np.int8)
    masks.tofile(prefix + ".masks")

    # read the graph back
    g2 = load_graph_binary(prefix)
    assert g2.num_nodes == csr.num_nodes
    assert g2.nnz == csr.nnz
    np.testing.assert_array_equal(g2.indices.numpy(), csr.indices.numpy())
    print(f"exported {name}: V={g2.num_nodes} E={g2.nnz} -> {prefix}.*", file=sys.stderr)
    return prefix


def main(argv=None):
    from maxk_tpu_torch.data.datasets import DATASETS

    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="")
    p.add_argument("--all", action="store_true")
    p.add_argument("--out", required=True)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=123)
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    names = list(DATASETS) if args.all else [args.dataset]
    return [export_dataset(name, args.out, args.scale, args.seed) for name in names]


if __name__ == "__main__":
    main()
