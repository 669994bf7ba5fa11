"""Rank functions for the multi-rank parity tests (`tests/test_torch_shard.py`).

A spawned rank imports these by module path, so they live in the package,
which imports no jax: the test computes the JAX reference in its own
process and hands each rank numpy inputs. Each function takes the rank's
`Mesh` first (see `parallel.mesh.run_ranks`) and returns numpy arrays and
plain numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from maxk_tpu_torch.data.datasets import GraphData
from maxk_tpu_torch.data.synthetic import planted_partition_data, rmat_graph
from maxk_tpu_torch.models.layers import aggregate
from maxk_tpu_torch.ops.dispatch import TILE_MODES
from maxk_tpu_torch.ops.spgemm import maxk_spgemm, spmm
from maxk_tpu_torch.parallel.shard import build_sharded_graph, shard_rows
from maxk_tpu_torch.parallel.train import (
    make_sharded_eval_step,
    make_sharded_train_step,
    sharded_setup,
)
from maxk_tpu_torch.sparse.cbsr import CBSR
from maxk_tpu_torch.train.config import TrainConfig


def _local(mesh, a: np.ndarray, vs: int) -> torch.Tensor:
    r = mesh.rank
    return torch.from_numpy(np.ascontiguousarray(shard_rows(a, mesh.world_size)[r * vs:(r + 1) * vs]))


def ops_case(mesh, graph_args: tuple, norm: str, x, ct, vals, sel, xdrop,
             mode: str = "segsum") -> dict:
    """spmm and maxk_spgemm, forward and gradient, and the compact sharded
    aggregation of post-dropout features, on this rank's rows of
    `rmat_graph(*graph_args)`, under kernel mode `mode` (the tile modes
    build the rank's tile tables); with the receive bytes of each op's
    forward + backward."""
    graph = build_sharded_graph(rmat_graph(*graph_args), mesh, norm=norm,
                                build_tiles=mode in TILE_MODES)
    vs, d = graph.shard_nodes, x.shape[1]
    out = {}

    xt = _local(mesh, x, vs).requires_grad_(True)
    mesh.bytes.reset()
    y = spmm(graph, xt, mode=mode)
    y.backward(_local(mesh, ct, vs))
    out.update(spmm_y=y.detach().numpy(), spmm_dx=xt.grad.numpy(),
               relu_recv=mesh.bytes.total_recv())

    vt = _local(mesh, vals, vs).requires_grad_(True)
    st = _local(mesh, sel, vs)
    mesh.bytes.reset()
    y = maxk_spgemm(graph, CBSR(vt, st), dim=d, mode=mode)
    y.backward(_local(mesh, ct, vs))
    out.update(maxk_y=y.detach().numpy(), maxk_dvals=vt.grad.numpy(),
               maxk_recv=mesh.bytes.total_recv())

    with torch.no_grad():
        agg = aggregate(graph, _local(mesh, xdrop, vs), mode, None,
                        CBSR(_local(mesh, vals, vs), st))
    out["agg"] = agg.numpy()
    return out


def tiny_data(multilabel: bool = False) -> GraphData:
    """The 200-node planted-partition graph of the JAX tests' `tiny_data`;
    `multilabel`: 5 independent 0/1 labels per node instead."""
    csr = rmat_graph(200, 1500, seed=7)
    feats, labels, masks = planted_partition_data(csr, 32, 5, seed=7)
    if multilabel:
        labels = (np.random.default_rng(7).random((200, 5)) < 0.3).astype(np.float32)
    return GraphData(name="tiny", csr=csr, features=feats, labels=labels,
                     train_mask=masks[0], val_mask=masks[1], test_mask=masks[2],
                     num_classes=5, multilabel=multilabel)


def train_case(mesh, runs, multilabel: bool = False, metric: str = "f1") -> list:
    """For each `(cfg_kwargs, state_dict or None)` of `runs`, `epochs`
    sharded train steps on `tiny_data(multilabel)` from that state: the
    losses, the final parameters and the train/val/test `metric` (accuracy,
    micro-F1 when multilabel, or "rocauc")."""
    data = tiny_data(multilabel)
    out = []
    for kwargs, state_dict in runs:
        cfg = TrainConfig(dataset="tiny", device="cpu", **kwargs)
        state = sharded_setup(cfg, data, mesh)
        if state_dict is not None:
            state.model.load_state_dict(
                {k: torch.from_numpy(v) for k, v in state_dict.items()}, strict=True
            )
        step = make_sharded_train_step(state.model, state.optimizer, multilabel, mesh)
        losses = [
            float(step(state.graph, state.feats, state.labels, state.masks[0], state.generator)[0])
            for _ in range(cfg.epochs)
        ]
        accs = make_sharded_eval_step(state.model, multilabel, mesh, metric)(
            state.graph, state.feats, state.labels, state.masks
        )
        out.append({
            "losses": losses,
            "accs": [float(a) for a in accs],
            "params": {k: v.detach().numpy().copy() for k, v in state.model.state_dict().items()},
        })
    return out
