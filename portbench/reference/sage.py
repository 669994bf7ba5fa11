"""Plain PyTorch reference of MaxK-SAGE full-graph training.

The model of MaxK-GNN's `scripts_train/*_maxk.sh` with `--model sage`:
`lin_in -> L x [MaxK (or ReLU) -> dropout -> SAGEConv(mean)] -> lin_out`,
SAGEConv(mean) being `fc_self(h) + fc_neigh(A @ h)` with A row-normalised
(each edge of row i weighted 1/deg(i), no self-loop added; a row of
no edges aggregates 0) and no bias on
`fc_neigh`; MaxK keeps the k largest entries of each row. Dropout keeps an
entry where a uniform draw is below 1 - rate and scales it by 1/(1 - rate).
The loss is the cross-entropy averaged over the train mask, the optimizer
Adam (betas 0.9 / 0.999, eps 1e-8), and evaluation the argmax accuracy
(single-label micro-F1) on each mask.

It recomputes from the raw graph what the program derives: the normalised
adjacency and its transpose (here as torch CSR tensors, multiplied by
`torch.sparse.mm`); the dropout masks come from a generator seeded alike on
the same device, drawn in the same order and shapes. It imports nothing of
the program. Float32 throughout, with TF32 off unless a caller turns it on
(the control).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BETAS = (0.9, 0.999)
EPS = 1e-8


def parameters(config: dict) -> list:
    """(name, shape, fan_in) of every leaf, in the order the weights are
    drawn; names and (out, in) shapes as the program's state_dict has them."""
    f, h, c = config["feat_dim"], config["hidden_dim"], config["num_classes"]
    out = [("lin_in.weight", (h, f), f), ("lin_in.bias", (h,), f)]
    for i in range(config["hidden_layers"]):
        out += [(f"conv{i}.fc_self.weight", (h, h), h), (f"conv{i}.fc_self.bias", (h,), h),
                (f"conv{i}.fc_neigh.weight", (h, h), h)]
    return out + [("lin_out.weight", (c, h), h), ("lin_out.bias", (c,), h)]


def model_flops(config: dict, traffic: dict, num_nodes: int, live_edges: int) -> float:
    """Model FLOPs of one epoch (train step + evaluation forward), however
    computed: each GEMM at 2·m·n·k, forward and the gradients the model needs
    (the features need none), and each aggregation at 2·E·k under MaxK (the
    k kept entries of a row) or 2·E·H under ReLU, forward and backward.
    Elementwise work, the loss and Adam are not counted."""
    v, f, h, c = num_nodes, config["feat_dim"], config["hidden_dim"], config["num_classes"]
    layers = config["hidden_layers"]
    width = traffic["maxk"] if traffic["nonlinear"] == "maxk" else h
    agg = 2.0 * live_edges * width
    fwd = 2.0 * v * f * h + layers * (2 * 2.0 * v * h * h + agg) + 2.0 * v * h * c
    bwd = 2.0 * v * f * h + layers * (2 * 4.0 * v * h * h + agg) + 4.0 * v * h * c
    return 2 * fwd + bwd  # the train step's forward and backward, the eval forward


class Graph:
    """A (each row divided by its degree) and Aᵀ as CSR tensors, from the raw
    CSR `indptr`, `indices` (every value 1)."""

    def __init__(self, indptr: torch.Tensor, indices: torch.Tensor):
        v = indptr.shape[0] - 1
        deg = torch.diff(indptr.long())
        rows = torch.repeat_interleave(torch.arange(v, device=indptr.device), deg)
        values = (1.0 / deg.clamp_min(1).to(torch.float32))[rows]
        self.a = torch.sparse_csr_tensor(indptr.long(), indices.long(), values, (v, v),
                                         check_invariants=False)
        order = torch.argsort(indices.long(), stable=True)  # by column, rows ascending
        t_ptr = torch.zeros(v + 1, dtype=torch.int64, device=indptr.device)
        t_ptr[1:] = torch.cumsum(torch.bincount(indices.long(), minlength=v), 0)
        self.at = torch.sparse_csr_tensor(t_ptr, rows[order], values[order], (v, v),
                                          check_invariants=False)


class _Aggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, graph):
        ctx.graph = graph
        return torch.sparse.mm(graph.a, x)

    @staticmethod
    def backward(ctx, g):
        return torch.sparse.mm(ctx.graph.at, g.contiguous()), None


def maxk(x: torch.Tensor, k: int) -> torch.Tensor:
    """x where it is among the k largest of its row, else 0."""
    keep = torch.zeros_like(x, dtype=torch.bool).scatter_(1, torch.topk(x, k, dim=1).indices, True)
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))


def forward(p: dict, graph: Graph, x: torch.Tensor, config: dict, traffic: dict,
            gen: torch.Generator = None) -> torch.Tensor:
    """Logits; dropout where `gen` is given (training)."""
    h = F.linear(x, p["lin_in.weight"], p["lin_in.bias"])
    rate = config["dropout"]
    for i in range(config["hidden_layers"]):
        h = maxk(h, traffic["maxk"]) if traffic["nonlinear"] == "maxk" else torch.relu(h)
        if gen is not None and rate > 0:
            keep = 1.0 - rate
            drop = torch.rand(h.shape, generator=gen, device=h.device) < keep
            h = torch.where(drop, h / keep, torch.zeros((), dtype=h.dtype, device=h.device))
        agg = _Aggregate.apply(h, graph)
        h = (F.linear(h, p[f"conv{i}.fc_self.weight"], p[f"conv{i}.fc_self.bias"])
             + F.linear(agg, p[f"conv{i}.fc_neigh.weight"]))
    return F.linear(h, p["lin_out.weight"], p["lin_out.bias"])


def masked_loss(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    nll = -torch.gather(torch.log_softmax(logits, -1), 1, labels.long()[:, None])[:, 0]
    w = mask.to(torch.float32)
    return (nll * w).sum() / w.sum().clamp_min(1.0)


class Adam:
    """Adam with bias correction, eps outside the square root."""

    def __init__(self, params: dict, lr: float):
        self.lr, self.t = lr, 0
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        b1, b2 = BETAS
        self.t += 1
        c1, c2 = 1 - b1**self.t, 1 - b2**self.t
        for n, p in params.items():
            g = grads[n]
            self.m[n] = b1 * self.m[n] + (1 - b1) * g
            self.v[n] = b2 * self.v[n] + (1 - b2) * g * g
            p -= self.lr * (self.m[n] / c1) / (torch.sqrt(self.v[n] / c2) + EPS)


def follow(inputs, config: dict, traffic: dict, dropout_seed: int, steps: int) -> dict:
    """The reference's readings over the first `steps` epochs from the
    initial weights: each step's loss, the first step's gradient norm per
    leaf, each leaf's change after the last step, and each epoch's count of
    correct nodes on the train, val and test masks (after that step)."""
    graph = Graph(inputs.indptr, inputs.indices)
    p = {n: w.clone().requires_grad_(True) for n, w in inputs.weights.items()}
    opt = Adam(p, config["lr"])
    gen = torch.Generator(device=inputs.features.device)
    gen.manual_seed(dropout_seed)
    losses, correct, grad_norms = [], [], None
    for step in range(steps):
        logits = forward(p, graph, inputs.features, config, traffic, gen)
        loss = masked_loss(logits, inputs.labels, inputs.masks[0])
        del logits
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        losses.append(float(loss.detach()))
        if step == 0:
            grad_norms = {n: float(g.norm()) for n, g in grads.items()}
        opt.step(p, grads)
        del grads, loss
        with torch.no_grad():
            pred = forward(p, graph, inputs.features, config, traffic).argmax(-1)
            hit = pred == inputs.labels
            correct.append([int((hit & m).sum()) for m in inputs.masks])
    changes = {n: float((p[n].detach() - inputs.weights[n]).norm()) for n in p}
    return {"losses": losses, "grad_norms": grad_norms, "changes": changes, "correct": correct}
