"""Checkpoints and resume of the port (maxk_tpu_torch/train/checkpoint.py,
the loop's checkpoint logic, the CLI's `--evaluate` and `--save_model`),
on the CPU:

- the reference's layout (`ckpt_<step>/`, `best/`) and its
  `latest_checkpoint`, which picks the same directory;
- a run cut after 3 epochs and resumed equals the uninterrupted run bit for
  bit (losses, parameters, BatchNorm buffers, optimizer state), with
  dropout 0.5 and Lookahead, for MaxK-SAGE and GNNRes: the checkpoint
  carries the dropout generator's state;
- a run with no checkpoint flags keeps the losses it had before
  checkpoints existed (pinned below at 1e-6 relative, from the tree before
  them, one torch thread), and writing `best/` does not move them;
- `--save_model` writes `ckpt_<epochs>` and `best/`, and `--evaluate` on
  `best/` gives the final model's metrics exactly."""

import os

import numpy as np
import pytest
import torch

from maxk_tpu.train.checkpoint import latest_checkpoint as jax_latest_checkpoint
from maxk_tpu_torch.data.datasets import GraphData
from maxk_tpu_torch.data.synthetic import planted_partition_data, rmat_graph
from maxk_tpu_torch.train import checkpoint as ckpt
from maxk_tpu_torch.train import loop as tloop
from maxk_tpu_torch.train.config import TrainConfig
from maxk_tpu_torch.train.optim import Lookahead

torch.set_num_threads(1)

# the 5 losses of `_cfg(model, epochs=5)` on `_data()` before checkpoints
# and Lookahead were ported
PINNED = {
    "sage": [2.1385414600372314, 1.870193600654602, 1.671692132949829, 1.623162031173706,
             1.5784748792648315],
    "gnn_res": [2.4481053352355957, 1.7412548065185547, 1.4206783771514893, 1.1134886741638184,
                0.839079737663269],
}


def _data():
    csr = rmat_graph(200, 1500, seed=7)
    feats, labels, masks = planted_partition_data(csr, 32, 5, seed=7)
    return GraphData(name="tiny", csr=csr, features=feats, labels=labels, train_mask=masks[0],
                     val_mask=masks[1], test_mask=masks[2], num_classes=5, multilabel=False)


def _cfg(model, **kw):
    return TrainConfig(model=model, hidden_dim=32, hidden_layers=2, maxk=4, dropout=0.5, lr=0.01,
                       device="cpu", **kw)


def test_layout_and_latest_checkpoint(tmp_path):
    d = str(tmp_path)
    assert ckpt.latest_checkpoint(d + "/missing") is None is jax_latest_checkpoint(d + "/missing")
    payload = {"w": torch.arange(6.0).reshape(2, 3), "epoch": 3, "best_val": 0.5}
    ckpt.save_checkpoint(d, payload, step=3)
    ckpt.save_checkpoint(d, {**payload, "epoch": 12}, step=12, is_best=True)
    os.makedirs(tmp_path / "ckpt_old")  # not a step: ignored by both
    assert sorted(os.listdir(d)) == ["best", "ckpt_12", "ckpt_3", "ckpt_old"]
    latest = ckpt.latest_checkpoint(d)
    assert latest == jax_latest_checkpoint(d) == os.path.join(d, "ckpt_12")
    for path in (latest, os.path.join(d, "best")):
        assert os.listdir(path) == [ckpt.PAYLOAD]
        got = ckpt.restore_checkpoint(path)
        assert got["epoch"] == 12 and torch.equal(got["w"], payload["w"])
    ckpt.save_best(d, payload)
    assert ckpt.restore_checkpoint(os.path.join(d, "best"))["epoch"] == 3


@pytest.mark.parametrize("model", ["sage", "gnn_res"])
def test_resume_equals_the_uninterrupted_run(tmp_path, model):
    """6 epochs with `checkpoint_every` 2 and Lookahead every 3 steps (a sync
    after the resume point), against 3 epochs (ckpt_1 written) resumed to
    6: the resumed epochs 2-5 equal the uninterrupted run's bit for bit."""
    data = _data()
    kw = dict(checkpoint_every=2, enable_lookahead=True, w_lookahead=3)
    whole = tloop.train(_cfg(model, epochs=6, **kw), data, checkpoint_dir=str(tmp_path / "a"))
    tloop.train(_cfg(model, epochs=3, **kw), data, checkpoint_dir=str(tmp_path / "b"))
    assert sorted(os.listdir(tmp_path / "b")) == ["best", "ckpt_1"]
    resumed = tloop.train(_cfg(model, epochs=6, **kw), data, checkpoint_dir=str(tmp_path / "b"))
    assert resumed.losses == whole.losses[2:]
    assert (resumed.best_val, resumed.best_test) == (whole.best_val, whole.best_test)
    got, ref = resumed.model.state_dict(), whole.model.state_dict()
    assert set(got) == set(ref)
    if model == "gnn_res":
        assert {"bn0.mean", "bn0.var"} <= set(got)
    for name in ref:
        assert torch.equal(got[name], ref[name]), name
    assert isinstance(resumed.optimizer, Lookahead)
    assert resumed.optimizer.step_count == whole.optimizer.step_count == 6
    for a, b in zip(resumed.optimizer.slow, whole.optimizer.slow):
        assert torch.equal(a, b)
    assert torch.equal(resumed.generator.get_state(), whole.generator.get_state())


@pytest.mark.parametrize("model", ["sage", "gnn_res"])
def test_runs_without_checkpoint_flags_keep_their_losses(tmp_path, model):
    data = _data()
    plain = tloop.train(_cfg(model, epochs=5), data)
    np.testing.assert_allclose(plain.losses, PINNED[model], rtol=1e-6, atol=0)
    with_best = tloop.train(_cfg(model, epochs=5), data, checkpoint_dir=str(tmp_path))
    assert with_best.losses == plain.losses
    assert os.listdir(tmp_path) == ["best"]  # checkpoint_every 0: best/ only


def test_cli_save_model_and_evaluate(tmp_path):
    """`--save_model` after 3 epochs of GNNRes writes ckpt_3 and best/ from the
    final model; `--evaluate best` restores it, BatchNorm buffers included,
    and logs the final model's train/val/test metrics."""
    from maxk_tpu_torch.__main__ import main

    argv = ["--device", "cpu", "--model", "gnn_res", "--dataset", "flickr", "--data_scale",
            "0.002", "--hidden_dim", "32", "--hidden_layers", "2", "--epochs", "3",
            "--path", str(tmp_path)]
    state = main(argv + ["--save_model"])
    exp = tmp_path / "flickr_seed97" / "gnn_res_maxk"
    assert sorted(p.name for p in exp.iterdir() if p.is_dir()) == ["best", "ckpt_3"]
    saved = ckpt.restore_checkpoint(str(exp / "ckpt_3"))
    assert saved["epoch"] == 2 and not torch.equal(saved["model"]["bn0.var"], torch.ones(32))
    from maxk_tpu_torch.data.datasets import load_dataset

    data = load_dataset("flickr", scale=0.002, seed=123, feat_snr=0.5)
    want = tloop.evaluate(state, data)
    got = main(argv + ["--evaluate", str(exp / "best")])
    assert got == want
    assert "eval-only: train" in (exp / "train.log").read_text()
