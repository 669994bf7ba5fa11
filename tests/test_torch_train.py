"""The port's training slice against the JAX package's: the loss over 3
Adam steps from imported parameters (dropout 0) at 1e-4 relative, for
MaxK-SAGE and for GNNRes (with its batch statistics); the CLI's
validation; flags the port parses and flags it does not port yet; CLI runs
of GNNRes and ogbn-proteins; `--validate_kernels` (passes under segsum
and the hybrid, raises on a noisy SpMM, is skipped under relu);
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


def test_gnn_res_three_steps_match_jax():
    """GNNRes from imported flax parameters and batch statistics, dropout 0:
    the loss of 3 Adam steps at 1e-4 relative, then the parameters and the
    running variance at 1e-4 relative (f32 sums in another order, through
    three updates).

    The conv biases feed BatchNorm, so their gradient is 0 up to rounding
    (≈1e-8), and Adam scales that noise to steps of ±lr: they and the
    running mean, which tracks them, differ between the packages by design.
    So the biases are left out, and the running mean is compared with the
    biases' share (1 - m)·m^(2-s)·b_s of each step s taken off."""
    jdata, tdata = _data()
    args = dict(model="gnn_res", hidden_dim=32, hidden_layers=2, dropout=0.0, lr=0.01,
                kernel_mode="segsum")
    jstate = jax_setup(jcfg.TrainConfig(**args), jdata)
    jstep = jax_make_train_step(jstate.model, jstate.tx, False)
    tstate = tloop.setup(tcfg.TrainConfig(device="cpu", **args), tdata)
    as_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    tstate.model.load_state_dict(import_flax_params(
        as_np(jstate.variables["params"]), as_np(jstate.variables["batch_stats"])), strict=True)
    tstep = tloop.make_train_step(tstate.model, tstate.optimizer, False)
    feats, labels, masks = tloop._device_arrays(tdata, torch.device("cpu"))
    variables, opt_state = jstate.variables, jstate.opt_state
    m, steps, layers = 0.99, 3, range(2)
    bias_share = {"jax": {i: 0.0 for i in layers}, "torch": {i: 0.0 for i in layers}}
    for s in range(steps):
        for i in layers:
            w = (1 - m) * m ** (steps - 1 - s)
            bias_share["jax"][i] += w * np.asarray(variables["params"][f"conv{i}"]["weight"]["bias"])
            bias_share["torch"][i] += w * getattr(tstate.model, f"conv{i}").weight.bias.detach().numpy()
        variables, opt_state, jloss, _ = jstep(
            variables, opt_state, jstate.rng, jstate.graph, jnp.asarray(jdata.features),
            jnp.asarray(jdata.labels), jnp.asarray(jdata.train_mask),
        )
        tloss, _ = tstep(tstate.graph, feats, labels, masks[0], tstate.generator)
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-4)
    ref = import_flax_params(as_np(variables["params"]), as_np(variables["batch_stats"]))
    got = tstate.model.state_dict()
    assert set(got) == set(ref)
    for name, t in got.items():
        if name.endswith("weight.bias") or name.endswith(".mean"):
            continue
        np.testing.assert_allclose(t.numpy(), ref[name].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    for i in layers:
        np.testing.assert_allclose(got[f"bn{i}.mean"].numpy() - bias_share["torch"][i],
                                   ref[f"bn{i}.mean"].numpy() - bias_share["jax"][i],
                                   rtol=1e-4, atol=1e-6, err_msg=f"bn{i}.mean")
    assert not torch.equal(got["bn0.var"], torch.ones(32))  # the steps moved them


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
    (["--model", "gnn_res", "--mesh_shape", "2"], "ROADMAP A7"),
    (["--kernel_mode", "pallas"], "ROADMAP B5"),
]


@pytest.mark.parametrize("argv,item", OUT_OF_SLICE, ids=lambda a: " ".join(a) if isinstance(a, list) else a)
def test_out_of_slice_flags_raise(argv, item):
    jcfg.parse_args(argv)  # valid for the reference
    with pytest.raises(NotImplementedError, match=item):
        tcfg.parse_args(argv)


@pytest.mark.parametrize("argv", [["--model", "gcn"], ["--model", "gin"], ["--mesh_shape", "2"],
                                  ["--model", "gnn_res"], ["--dataset", "ogbn-proteins"],
                                  ["--kernel_mode", "tiles_xla"], ["--kernel_mode", "tiles_scan"],
                                  ["--kernel_mode", "hybrid"], ["--kernel_mode", "hybrid_int8"],
                                  ["--row_block", "4", "--edge_tile", "64"],
                                  ["--enable_lookahead", "--w_lookahead", "3"],
                                  ["--checkpoint_every", "5"], ["--evaluate", "ckpt"],
                                  ["--save_model"], ["--validate_kernels"]],
                         ids=lambda a: " ".join(a))
def test_ported_flags_parse_as_in_jax(argv):
    ref, got = jcfg.parse_args(argv), tcfg.parse_args(argv)
    for name, value in vars(ref).items():
        assert getattr(got, name) == value, name


class _Log:
    def __init__(self):
        self.lines = []

    def info(self, msg):
        self.lines.append(msg)


def _validated_run(**kw):
    """2 epochs of `loop.train` with `--validate_kernels` on the tiny graph;
    the log lines."""
    _, tdata = _data()
    log = _Log()
    cfg = tcfg.TrainConfig(device="cpu", epochs=2, hidden_dim=32, hidden_layers=2, maxk=4,
                           validate_kernels=True, **kw)
    tloop.train(cfg, tdata, logger=log)
    return [line for line in log.lines if line.startswith("kernel validation")]


@pytest.mark.parametrize("mode", ["segsum", "hybrid"])
def test_validate_kernels_passes_on_cpu(mode):
    """The hook runs once, before the first step, and passes: under the
    hybrid both sides of the comparison use the permuted graph."""
    lines = _validated_run(kernel_mode=mode)
    assert len(lines) == 1 and lines[0].startswith("kernel validation: ok=True"), lines


def test_validate_kernels_raises_on_a_noisy_spmm(monkeypatch):
    from maxk_tpu_torch.ops import spgemm

    # under segsum maxk_spgemm's forward is the CSR × CBSR product (K10's
    # wrapper), so the noise goes there
    impl = spgemm.spgemm_cbsr
    gen = torch.Generator().manual_seed(0)
    def noisy(*a, **kw):
        y = impl(*a, **kw)
        return y + 0.1 * torch.randn(y.shape, generator=gen)

    monkeypatch.setattr(spgemm, "spgemm_cbsr", noisy)
    with pytest.raises(RuntimeError, match="kernel validation failed"):
        _validated_run(kernel_mode="segsum")


def test_validate_kernels_is_skipped_under_relu(monkeypatch):
    from maxk_tpu_torch.bench import kernel_bench

    def boom(*a, **kw):
        raise AssertionError("validate_graph ran under relu")

    monkeypatch.setattr(kernel_bench, "validate_graph", boom)
    assert _validated_run(kernel_mode="segsum", nonlinear="relu") == []


@pytest.mark.parametrize("argv,metric_range", [
    (["--model", "gnn_res", "--dataset", "flickr", "--data_scale", "0.002"], (0.0, 1.0)),
    (["--dataset", "ogbn-proteins", "--data_scale", "0.002"], (0.0, 1.0)),
], ids=["gnn_res", "ogbn-proteins"])
def test_cli_trains_gnn_res_and_proteins(tmp_path, argv, metric_range):
    """`python -m maxk_tpu_torch --model gnn_res` and `--dataset
    ogbn-proteins` (ROC-AUC eval) train 3 epochs on the CPU: finite losses,
    metrics inside their range, the log written."""
    from maxk_tpu_torch.__main__ import main

    state = main(["--device", "cpu", "--epochs", "3", "--hidden_dim", "32",
                  "--hidden_layers", "2", "--maxk", "8", "--path", str(tmp_path)] + argv)
    assert len(state.losses) == 3 and all(np.isfinite(state.losses))
    lo, hi = metric_range
    assert lo < state.best_val < hi and lo < state.best_test <= hi
    logs = list(tmp_path.rglob("train.log"))
    assert len(logs) == 1 and "epoch 00002" in logs[0].read_text()


def test_device_cuda_without_cuda_raises(monkeypatch, tmp_path):
    from maxk_tpu_torch.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--dataset", "flickr", "--data_scale", "0.002", "--epochs", "1",
              "--path", str(tmp_path)])
    assert not any(tmp_path.iterdir())  # raised before any work


def test_golden_table_equals_jax():
    """The port's copy of the golden rows, protocol and seeds is the JAX
    package's, field by field."""
    from maxk_tpu.train import golden as jgold
    from maxk_tpu_torch.train import golden as tgold

    assert [vars(g) for g in tgold.GOLDEN] == [vars(g) for g in jgold.GOLDEN]
    assert tgold.ACC_PROTOCOL == jgold.ACC_PROTOCOL
    assert (tgold.GRAPH_KIND, tgold.SEED, tgold.DATA_SEED) == (
        jgold.GRAPH_KIND, jgold.SEED, jgold.DATA_SEED)
    assert set(tgold.KNOWN_MISSES) <= {tgold.row_id(g) for g in tgold.GOLDEN}


def test_golden_cli_defaults_to_cuda(monkeypatch):
    """`python -m maxk_tpu_torch.train.golden` runs on the card unless told
    otherwise, and raises without one: never a silent CPU run."""
    from maxk_tpu_torch.train import golden

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        golden.main(["--measure"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        golden.run_golden(golden.GOLDEN[-1])


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
