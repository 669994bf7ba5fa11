"""The port's scaling script and byte model against the JAX package's, on
the CPU:

- `bench.scaling.analytic_ms` with the v5e rates (`sparse.hybrid.V5E`) and
  the v5e link rate equals `maxk_tpu.bench.scaling.analytic_v5e_ms` to
  1e-12 relative, for every arm at n ∈ {1, 2, 4, 8}, but `maxk`'s, which is
  less by the bytes below over the link rate;
- `parallel.audit.model_recv_bytes_fwd_bwd` equals the JAX package's
  exactly over a grid of arms, n, itemsizes and strip widths, but the
  `maxk` arm's, which is less by r·Vp·(D − k)·ct: the port reduce-scatters
  the sampled (Vp, k) cotangent partials, the reference the (Vp, D) ones;
- the sharded strip hybrid's measured receive bytes of one fwd + bwd
  (`ByteCounter`, 2 gloo ranks) equal the model's `maxk_hybrid` and
  `relu_hybrid` arms;
- `scaling.main` on 2 gloo ranks writes the reference's keys for the four
  arms, with the measured step bytes and the link rate.

Every spawn runs under a deadline.
"""

import contextlib
import io
import itertools
import json

import numpy as np
import pytest
import torch

from maxk_tpu.bench.scaling import analytic_v5e_ms
from maxk_tpu.parallel.audit import model_recv_bytes_fwd_bwd as jax_model
from maxk_tpu_torch.bench import scaling
from maxk_tpu_torch.parallel import testing
from maxk_tpu_torch.parallel.audit import model_recv_bytes_fwd_bwd
from maxk_tpu_torch.parallel.mesh import run_ranks
from maxk_tpu_torch.sparse.hybrid import V5E

torch.set_num_threads(1)

ARMS = ("maxk", "relu", "maxk_hybrid", "relu_hybrid")
V5E_LINK = 4.5e10  # the reference's v5e ICI bytes a second
DEADLINE = 150


def _sampled_scatter_saving(arm, n, vp, d, k, ct_itemsize=4):
    """Bytes the port's sampled reduce_scatter receives fewer than the
    reference's (Vp, D) one: r·Vp·(D − k)·ct in the `maxk` arm, else 0."""
    return (n - 1) / n * vp * (d - k) * ct_itemsize if arm == "maxk" else 0


@pytest.mark.parametrize("arm", ARMS)
def test_analytic_ms_equals_jax_with_v5e_rates(arm):
    v, e, d, k, nl = 232_965, 114_615_892, 256, 32, 4
    for n in (1, 2, 4, 8):
        for s_cols, tail_e in ((0, 0), (16384, e // 15)):
            ref = analytic_v5e_ms(arm, n, v, e, d, k, nl, s_cols=s_cols, tail_e=tail_e)
            ref -= nl * _sampled_scatter_saving(arm, n, v, d, k) / V5E_LINK * 1e3
            got = scaling.analytic_ms(arm, n, v, e, d, k, nl, s_cols=s_cols, tail_e=tail_e,
                                      rates=V5E, link_bytes_s=V5E_LINK)
            assert got == pytest.approx(ref, rel=1e-12), (n, s_cols)


def test_byte_model_equals_jax():
    grid = itertools.product(ARMS, (1, 2, 4, 8), (1024, 232_968), (64, 256), (0, 8, 32),
                             ((4, 4, 4, 4), (2, 2, 2, 2), (2, 4, 2, 4)), (0, 128, 16384))
    for arm, n, vp, d, k, (vi, si, xi, ci), s in grid:
        kw = dict(k=k, vals_itemsize=vi, sel_itemsize=si, x_itemsize=xi, ct_itemsize=ci,
                  s_cols=s)
        want = jax_model(arm, n, vp, d, **kw) - _sampled_scatter_saving(arm, n, vp, d, k, ci)
        assert model_recv_bytes_fwd_bwd(arm, n, vp, d, **kw) == want
    with pytest.raises(ValueError, match="unknown arm"):
        model_recv_bytes_fwd_bwd("dense", 2, 8, 8)


def test_sharded_hybrid_bytes_match_the_model(tmp_path):
    """spmm (dense gather) and maxk_spgemm (CBSR gather) on the sharded
    strip hybrid: every rank's receive bytes of one forward + backward are
    the model's relu_hybrid and maxk_hybrid arms, with the rank's tail
    window playing no part in them."""
    graph, s, d, k, n = (700, 9000, 3), 128, 32, 8, 2
    v = graph[0]
    rng = np.random.default_rng(0)
    x, ct = (rng.standard_normal((v, d)).astype(np.float32) for _ in range(2))
    vals = rng.standard_normal((v, k)).astype(np.float32)
    sel = np.stack([rng.choice(d, k, replace=False) for _ in range(v)]).astype(np.int32)
    outs = run_ranks(testing.hybrid_case, n, (graph, "right", s, x, ct, vals, sel),
                     device_type="cpu", init_method=f"file://{tmp_path}/rendezvous",
                     timeout=DEADLINE)
    for o in outs:
        vp = o["padded_nodes"]
        assert o["maxk_recv"] == model_recv_bytes_fwd_bwd("maxk_hybrid", n, vp, d, k=k,
                                                          s_cols=o["s_cols"])
        assert o["spmm_recv"] == model_recv_bytes_fwd_bwd("relu_hybrid", n, vp, d,
                                                          s_cols=o["s_cols"])


def test_scaling_main_on_gloo_ranks(tmp_path):
    out = tmp_path / "scaling.json"
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        results = scaling.main(["--device", "cpu", "--devices", "2", "--scale", "0.004",
                                "--hidden_dim", "32", "--maxk", "8", "--hidden_layers", "2",
                                "--iters", "2", "--repeats", "1", "--warmup", "1",
                                "--timeout", str(DEADLINE), "--json_out", str(out)])
    doc = json.loads(printed.getvalue().strip().splitlines()[-1])
    assert json.loads(out.read_text()) == doc
    assert [(r["arm"], r["n"]) for r in results] == [(a, 2) for a in scaling.ARMS]
    for r in results:
        assert r["step_ms"] > 0 and r["recv_bytes_per_step"] > 0
        assert r["analytic_step_ms"] > 0
        assert {"fwd_allgather_bytes_per_layer"} <= set(r)
    by_arm = {r["arm"]: r for r in results}
    assert by_arm["maxk"]["halo_alt_recv_bytes_per_device"] > 0
    assert by_arm["maxk_hybrid"]["tail_edges"] >= 0 and by_arm["maxk_hybrid"]["s_cols"] > 0
    link = doc["protocol"]["link"]
    assert link["n"] == 2 and link["bytes_s"] > 0
    assert doc["protocol"]["backend"] == "gloo"
    assert doc["compressed_collective_ratio"] == round(8 * 8 / (32 * 4), 4)
