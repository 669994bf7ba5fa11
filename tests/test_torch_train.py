"""The port's training slice against the JAX package's: the loss over 3
Adam steps from imported parameters (dropout 0) at 1e-4 relative; the CLI's
validation; flags the port parses and flags it does not port yet;
`--device cuda` without a card; and a run with jax blocked from import."""

import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxk_tpu.data.datasets import GraphData as JaxGraphData
from maxk_tpu.data.synthetic import planted_partition_data, rmat_graph as jax_rmat_graph
from maxk_tpu.train import config as jcfg
from maxk_tpu.train.loop import evaluate as jax_evaluate
from maxk_tpu.train.loop import make_train_step as jax_make_train_step, setup as jax_setup
from maxk_tpu_torch.data.datasets import GraphData
from maxk_tpu_torch.data.synthetic import rmat_graph
from maxk_tpu_torch.models.convert import import_flax_params
from maxk_tpu_torch.train import config as tcfg
from maxk_tpu_torch.train import loop as tloop

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _data():
    jcsr = jax_rmat_graph(200, 1500, seed=7)
    feats, labels, masks = planted_partition_data(jcsr, 32, 5, seed=7)
    common = dict(name="tiny", features=feats, labels=labels, train_mask=masks[0],
                  val_mask=masks[1], test_mask=masks[2], num_classes=5, multilabel=False)
    return JaxGraphData(csr=jcsr, **common), GraphData(csr=rmat_graph(200, 1500, seed=7), **common)


@pytest.mark.parametrize("weight_decay", [0.0, 5e-4])
def test_three_steps_match_jax(weight_decay):
    jdata, tdata = _data()
    args = dict(hidden_dim=32, hidden_layers=2, maxk=4, dropout=0.0, lr=0.01,
                weight_decay=weight_decay, kernel_mode="segsum")
    jstate = jax_setup(jcfg.TrainConfig(**args), jdata)
    jstep = jax_make_train_step(jstate.model, jstate.tx, False)
    tstate = tloop.setup(tcfg.TrainConfig(device="cpu", **args), tdata)
    tstate.model.load_state_dict(
        import_flax_params(jax.tree.map(np.asarray, jstate.variables["params"])), strict=True
    )
    # the optimizer holds the same parameter objects the state_dict filled
    tstep = tloop.make_train_step(tstate.model, tstate.optimizer, False)
    feats, labels, masks = tloop._device_arrays(tdata, torch.device("cpu"))
    variables, opt_state = jstate.variables, jstate.opt_state
    for _ in range(3):
        variables, opt_state, jloss, _ = jstep(
            variables, opt_state, jstate.rng, jstate.graph, jnp.asarray(jdata.features),
            jnp.asarray(jdata.labels), jnp.asarray(jdata.train_mask),
        )
        tloss, _ = tstep(tstate.graph, feats, labels, masks[0], tstate.generator)
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-4)
    jstate.variables = variables
    # train/val/test accuracy after the steps; one node's argmax may flip
    np.testing.assert_allclose(
        tloop.evaluate(tstate, tdata), jax_evaluate(jstate, jdata), rtol=0, atol=1.5 / 40
    )


BAD_ARGS = [
    ["--model", "nonsense"],
    ["--nonlinear", "tanh"],
    ["--maxk", "512", "--hidden_dim", "256"],
    ["--maxk", "0"],
    ["--kernel_mode", "bogus"],
]


@pytest.mark.parametrize("argv", BAD_ARGS, ids=lambda a: " ".join(a))
def test_parse_args_rejects_what_jax_rejects(argv):
    with pytest.raises(ValueError) as ref:
        jcfg.parse_args(argv)
    with pytest.raises(ValueError) as got:
        tcfg.parse_args(argv)
    assert str(got.value) == str(ref.value)


def test_parse_args_defaults_match_jax():
    ref, got = jcfg.parse_args([]), tcfg.parse_args([])
    for name, value in vars(ref).items():
        assert getattr(got, name) == value, name
    assert got.device == "cuda"


OUT_OF_SLICE = [
    (["--model", "gnn_res"], "ROADMAP A7"),
    (["--kernel_mode", "hybrid"], "ROADMAP A13"),
    (["--kernel_mode", "hybrid_int8"], "ROADMAP A13"),
    (["--kernel_mode", "tiles_xla"], "ROADMAP A12"),
    (["--kernel_mode", "tiles_scan"], "ROADMAP A12"),
    (["--kernel_mode", "pallas"], "ROADMAP B5"),
    (["--enable_lookahead"], "ROADMAP A8"),
    (["--checkpoint_every", "5"], "ROADMAP A8"),
    (["--evaluate", "ckpt"], "ROADMAP A8"),
    (["--save_model"], "ROADMAP A8"),
    (["--validate_kernels"], "ROADMAP A11"),
    (["--dataset", "ogbn-proteins"], "ROADMAP A8"),
]


@pytest.mark.parametrize("argv,item", OUT_OF_SLICE, ids=lambda a: " ".join(a) if isinstance(a, list) else a)
def test_out_of_slice_flags_raise(argv, item):
    jcfg.parse_args(argv)  # valid for the reference
    with pytest.raises(NotImplementedError, match=item):
        tcfg.parse_args(argv)


@pytest.mark.parametrize("argv", [["--model", "gcn"], ["--model", "gin"], ["--mesh_shape", "2"]],
                         ids=lambda a: " ".join(a))
def test_ported_flags_parse_as_in_jax(argv):
    ref, got = jcfg.parse_args(argv), tcfg.parse_args(argv)
    for name, value in vars(ref).items():
        assert getattr(got, name) == value, name


def test_device_cuda_without_cuda_raises(monkeypatch, tmp_path):
    from maxk_tpu_torch.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--dataset", "flickr", "--data_scale", "0.002", "--epochs", "1",
              "--path", str(tmp_path)])
    assert not any(tmp_path.iterdir())  # raised before any work


def test_train_cpu_without_jax(tmp_path):
    """`import maxk_tpu_torch` and a 2-epoch CPU run with jax, flax, optax
    and maxk_tpu blocked from import."""
    script = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "flax", "optax", "maxk_tpu"):
            sys.modules[name] = None
        import torch
        torch.set_num_threads(1)
        import maxk_tpu_torch
        from maxk_tpu_torch.__main__ import main
        state = main(["--device", "cpu", "--dataset", "flickr", "--data_scale", "0.002",
                      "--epochs", "2", "--hidden_dim", "32", "--hidden_layers", "2",
                      "--maxk", "4", "--path", {str(tmp_path)!r}])
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                        ("jax", "jaxlib", "flax", "optax", "maxk_tpu") and sys.modules[m] is not None)
        print("RESULT", len(state.losses), state.losses[-1], loaded)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT")][0]
    assert line.endswith("[]") and line.split()[1] == "2"
    log = tmp_path / "flickr_seed97" / "sage_maxk"
    assert "epoch 00001" in (log / "train.log").read_text()
    tags = [json.loads(l)["tag"] for l in (log / "scalars.jsonl").read_text().splitlines()]
    assert tags.count("loss") == 2


def test_port_sources_import_no_jax():
    """No import of jax, flax, optax or maxk_tpu in the port or chip_smoke.py."""
    banned = {"jax", "jaxlib", "flax", "optax", "maxk_tpu"}
    stmt = re.compile(r"^\s*(?:from|import)\s+([A-Za-z_][\w.]*)")
    files = sorted((REPO / "maxk_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        for i, line in enumerate(path.read_text().splitlines(), 1):
            m = stmt.match(line)
            if m:
                assert m.group(1).split(".")[0] not in banned, f"{path}:{i}: {line}"
