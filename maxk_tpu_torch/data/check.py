"""Graph structure checker CLI.

Port of `maxk_tpu/data/check.py`: for a dataset or a graph binary, the
degree profile, symmetry (structure and values), self loops, and for each
norm mode whether the normalized adjacency differs from its transpose,
i.e. whether the backward aggregation needs Aᵀ (`build_graph` decides
the same way). Prints one JSON report.

  python -m maxk_tpu_torch.data.check --dataset flickr --scale 0.01
  python -m maxk_tpu_torch.data.check --binary graphs/reddit
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def check_graph(csr) -> dict:
    from maxk_tpu_torch.sparse.csr import csr_to_scipy, with_norm

    m = csr_to_scipy(csr)
    v = m.shape[0]
    deg = np.diff(m.indptr)
    asym = abs(m - m.T)
    diag = m.diagonal()
    report = {
        "num_nodes": int(v),
        "num_edges": int(m.nnz),
        "avg_degree": float(deg.mean()),
        "max_degree": int(deg.max()),
        "min_degree": int(deg.min()),
        "isolated_nodes": int((deg == 0).sum()),
        "symmetric_structure": bool(
            (abs(m != 0).astype(int) - (m.T != 0).astype(int)).nnz == 0
        ),
        "symmetric_values": bool(asym.nnz == 0 or float(asym.max()) < 1e-6),
        "self_loops": int((diag != 0).sum()),
        "self_loop_complete": bool(np.all(diag != 0)),
    }
    # per norm mode: right-norm breaks value symmetry on symmetric
    # structure; the criterion is `build_graph`'s symmetric=None one
    needs_t = {}
    for mode in ("none", "right", "left", "both"):
        mn = csr_to_scipy(with_norm(csr, mode))
        d = abs(mn - mn.T)
        needs_t[mode] = not (d.nnz == 0 or float(d.max()) < 1e-6)
    report["backward_needs_transpose"] = needs_t
    return report


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="")
    p.add_argument("--binary", default="", help="graph binary prefix")
    p.add_argument("--scale", type=float, default=1.0)
    args = p.parse_args(argv)
    if args.binary:
        from maxk_tpu_torch.data.io import load_graph_binary

        csr = load_graph_binary(args.binary)
        name = args.binary
    else:
        from maxk_tpu_torch.data.datasets import load_dataset

        csr = load_dataset(args.dataset, scale=args.scale).csr
        name = args.dataset
    report = {"graph": name, **check_graph(csr)}
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
