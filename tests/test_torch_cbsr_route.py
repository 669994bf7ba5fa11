"""The one-device MaxK route through the CBSR pair (`layers.takes_cbsr`):
where a conv aggregates its f32 input under the CSR segment sum, the
activation is K4 (`maxk_cbsr_fast`) and its densify, and the conv
aggregates through `maxk_spgemm` (K10 forward, K11 backward).

On the CPU the route is bit-equal to the composition it replaces, built
here by hand: `maxk_mask_fast` → dropout from the same generator → `spmm`
→ the conv's linears, for the loss, every parameter's gradient and the
evaluation logits. The `agg.calls.*` counters say where the route engaged
and where the mask and the SpMM stay. The `cuda` test holds the route
against the hand-made composition on the card.

This file imports torch and maxk_tpu_torch only, so its `cuda` test also
runs where jax is not installed:

    python -m pytest --noconftest tests/test_torch_cbsr_route.py -q
"""

import pytest
import torch

from maxk_tpu_torch import telemetry
from maxk_tpu_torch.data.synthetic import planted_partition_data, rmat_graph
from maxk_tpu_torch.models.layers import MaxKSAGEConv, dense, takes_cbsr
from maxk_tpu_torch.models.models import build_model, dropout
from maxk_tpu_torch.ops.spgemm import spmm
from maxk_tpu_torch.ops.topk_cuda import maxk_mask_fast
from maxk_tpu_torch.sparse.graph import build_graph
from maxk_tpu_torch.train.loop import _loss_fn

torch.set_num_threads(1)

F_IN, HIDDEN, LAYERS, MAXK, CLASSES = 24, 32, 2, 4, 5


@pytest.fixture(autouse=True)
def fresh_recorder():
    telemetry.clear()
    yield
    telemetry.clear()


def _inputs(norm, device="cpu", seed=11, **graph_kw):
    csr = rmat_graph(200, 1500, seed=seed)
    feats, labels, masks = planted_partition_data(csr, F_IN, CLASSES, seed=seed)
    graph = build_graph(csr, norm=norm, device=device, **graph_kw)
    return graph, *(torch.as_tensor(a).to(device) for a in (feats, labels, masks[0]))


def _model(name, seed, device="cpu", **kw):
    kw.setdefault("dropout", 0.5)
    m, norm = build_model(name, F_IN, CLASSES, hidden_dim=HIDDEN, num_layers=LAYERS, maxk=MAXK,
                          generator=torch.Generator().manual_seed(seed), **kw)
    return m.to(device), norm


def _by_hand(m, graph, x, train, generator):
    """The composition the route replaces: K1, dropout, the SpMM, the
    conv's linears, for MaxK SAGE, GCN and GIN."""
    x = m.lin_in(x)
    for i in range(m.num_layers):
        conv = getattr(m, f"conv{i}")
        x = maxk_mask_fast(x, m.maxk)
        if train:
            x = dropout(x, m.dropout, generator)
        agg = spmm(graph, x, mode=conv.kernel_mode)
        if hasattr(conv, "fc_self"):
            x = conv.fc_self(x) + conv.fc_neigh(agg)
        elif hasattr(conv, "weight"):
            x = conv.weight(agg)
        else:
            x = conv.apply_func_1(torch.relu(conv.apply_func_0((1.0 + conv.eps) * x + agg)))
        if m.norm:
            x = getattr(m, f"ln{i}")(x)
    return m.lin_out(x)


def _step(forward, m, graph, feats, labels, mask, seed, device="cpu"):
    """(loss, {name: grad}, eval logits): a train step's loss and gradients
    with dropout drawn from `seed`, and an evaluation forward."""
    m.zero_grad(set_to_none=True)
    gen = torch.Generator(device=device).manual_seed(seed)
    loss = _loss_fn(forward(graph, feats, True, gen), labels, mask, False)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in m.named_parameters()}
    with torch.no_grad():
        logits = forward(graph, feats, False, None)
    return loss.detach(), grads, logits


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name, flags", [("sage", {}), ("gcn", {}), ("gin", {}),
                                         ("gcn", {"norm": True})], ids=str)
def test_route_is_bit_equal_to_mask_and_spmm(name, flags, seed):
    m, norm = _model(name, seed, **flags)
    graph, feats, labels, mask = _inputs(norm, seed=11 + seed)
    with telemetry.enabled(), telemetry.step("s"):
        loss, grads, logits = _step(
            lambda g, x, train, gen: m(g, x, train=train, generator=gen),
            m, graph, feats, labels, mask, seed)
    # the route engaged: K10 in the train and the eval forward, K11 in the backward
    assert telemetry.counters() == {
        "agg.calls.k10": 2 * LAYERS, "agg.calls.k11": LAYERS,
        "agg.gather_bytes": graph.nnz * MAXK * (2 * LAYERS * (4 + 2) + LAYERS * 4)}
    ref_loss, ref_grads, ref_logits = _step(
        lambda g, x, train, gen: _by_hand(m, g, x, train, gen),
        m, graph, feats, labels, mask, seed)
    assert torch.equal(loss, ref_loss)
    assert set(grads) == set(ref_grads)
    for pname, g in grads.items():
        assert torch.equal(g, ref_grads[pname]), pname
    assert torch.equal(logits, ref_logits)


def _train_counters(m, graph, feats, labels, mask):
    with telemetry.enabled(), telemetry.step("s"):
        gen = torch.Generator().manual_seed(3)
        _loss_fn(m(graph, feats, train=True, generator=gen), labels, mask, False).backward()
    return telemetry.counters()


@pytest.mark.parametrize("case, path, graph_kw, model_kw", [
    ("hybrid", "hybrid", {"hybrid": True, "dim": HIDDEN}, {"kernel_mode": "hybrid"}),
    ("auto_hybrid", "hybrid", {"hybrid": True, "dim": HIDDEN}, {}),
    ("tiles_xla", "tiles_xla", {"build_tiles": True, "row_block": 8, "edge_tile": 256},
     {"kernel_mode": "tiles_xla"}),
    ("tiles_scan", "tiles_scan", {"build_tiles": True, "row_block": 8, "edge_tile": 256},
     {"kernel_mode": "tiles_scan"}),
    ("bf16", "k9", {}, {"compute_dtype": torch.bfloat16}),
    ("relu", "k9", {}, {"nonlinear": "relu"}),
], ids=lambda c: c if isinstance(c, str) else "")
def test_route_stays_off_where_it_does_not_pay(case, path, graph_kw, model_kw):
    """The strip hybrid, the tile modes, bf16 aggregation and ReLU keep the
    mask (or ReLU) and their SpMM: only their path counts, both ways."""
    m, norm = _model("sage", 0, **model_kw)
    graph, feats, labels, mask = _inputs(norm, **graph_kw)
    counters = _train_counters(m, graph, feats, labels, mask)
    item = 2 if case == "bf16" else 4
    assert counters == {f"agg.calls.{path}": 2 * LAYERS,
                        "agg.gather_bytes": 2 * LAYERS * graph.nnz * HIDDEN * item}


def test_route_stays_off_for_a_conv_that_shrinks_first():
    """A `lin_before_mp` conv (fc_neigh before the SpMM) never reads a
    CBSR: the mask and K9 over its narrowed rows, both ways."""
    m, norm = _model("sage", 0, dropout=0.0)
    m.num_layers = 1
    m.conv0 = MaxKSAGEConv(HIDDEN, HIDDEN // 2, kernel_mode="segsum",
                           generator=torch.Generator().manual_seed(1))
    m.lin_out = dense(HIDDEN // 2, CLASSES, True, torch.Generator().manual_seed(2))
    graph, feats, labels, mask = _inputs(norm)
    assert m.conv0.lin_before_mp and not takes_cbsr(m.conv0, graph, torch.float32)
    counters = _train_counters(m, graph, feats, labels, mask)
    assert counters == {"agg.calls.k9": 2, "agg.gather_bytes": 2 * graph.nnz * HIDDEN // 2 * 4}


def test_takes_cbsr_follows_the_segsum_predicate():
    """Under AUTO and SEGSUM on a plain graph, with f32 aggregation
    (compute_dtype None or float32 over f32 features); not in bf16."""
    graph, *_ = _inputs("right")
    for mode in ("auto", "segsum"):
        for dtype in (None, torch.float32):
            assert takes_cbsr(MaxKSAGEConv(HIDDEN, HIDDEN, kernel_mode=mode, compute_dtype=dtype),
                              graph, torch.float32)
    assert not takes_cbsr(MaxKSAGEConv(HIDDEN, HIDDEN, compute_dtype=torch.bfloat16), graph,
                          torch.float32)
    assert not takes_cbsr(MaxKSAGEConv(HIDDEN, HIDDEN), graph, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sage", "gin"])
def test_route_on_the_card(name):
    """On the card a one-device MaxK step launches K4, K10 and K11 and no
    K1 or K9; its loss and gradients lie within 1e-4 of the hand-made K1 +
    K9 composition (the same sums, but the f32 GEMMs and a top-k near-tie
    may round apart), and the route's evaluation logits within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    m, norm = _model(name, 0, device=dev)
    graph, feats, labels, mask = _inputs(norm, device=dev)
    names = ("topk_cbsr", "spgemm_cbsr", "sspmm_cbsr", "maxk_mask", "spmm_csr")

    def run(forward):
        before = [telemetry.launches[c] for c in names]
        out = _step(forward, m, graph, feats, labels, mask, 5, device=dev)
        torch.cuda.synchronize()
        return out, dict(zip(names, (telemetry.launches[c] - b for c, b in zip(names, before))))

    (loss, grads, logits), routed = run(lambda g, x, train, gen: m(g, x, train=train,
                                                                   generator=gen))
    assert routed == {"topk_cbsr": 2 * LAYERS, "spgemm_cbsr": 2 * LAYERS,
                      "sspmm_cbsr": LAYERS, "maxk_mask": 0, "spmm_csr": 0}
    (ref_loss, ref_grads, ref_logits), by_hand = run(
        lambda g, x, train, gen: _by_hand(m, g, x, train, gen))
    assert by_hand["maxk_mask"] == 2 * LAYERS and by_hand["spmm_csr"] == 3 * LAYERS
    torch.testing.assert_close(loss, ref_loss, rtol=1e-4, atol=1e-4)
    for pname, g in grads.items():
        torch.testing.assert_close(g, ref_grads[pname], rtol=1e-4, atol=1e-4, msg=pname)
    torch.testing.assert_close(logits, ref_logits, rtol=1e-4, atol=1e-4)
