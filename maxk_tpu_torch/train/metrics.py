"""Evaluation metrics — port of `maxk_tpu/train/metrics.py`.

`compute_micro_f1`: argmax accuracy for single-label tasks, micro-F1 over
`logits > 0` for multilabel ones. `rocauc`: the mean per-class ROC-AUC by
the rank-sum identity (ogbn-proteins). `accuracy`: top-k accuracy in
percent. Ranks and top-k orders come from stable sorts, as `jnp.argsort`'s
do, so tied scores get ordinal ranks in row order, not mid-ranks.
"""

from __future__ import annotations

import torch


def accuracy(logits, labels, topk=(1,)):
    """Top-k accuracy in percent, one value per k of `topk`."""
    top = torch.argsort(-logits, dim=-1, stable=True)[:, : max(topk)]
    correct = top == labels[:, None]
    return [correct[:, :k].any(-1).to(torch.float32).mean() * 100.0 for k in topk]


def compute_micro_f1(logits, labels, mask=None) -> torch.Tensor:
    if mask is None:
        mask = torch.ones(logits.shape[0], dtype=torch.bool, device=logits.device)
    w = mask.to(torch.float32)
    if labels.dim() == 1:
        pred = logits.argmax(-1)
        correct = (pred == labels).to(torch.float32) * w
        return correct.sum() / w.sum().clamp_min(1.0)
    pred = (logits > 0).to(torch.float32) * w[:, None]
    lab = (labels > 0.5).to(torch.float32) * w[:, None]
    tp = (pred * lab).sum()
    fp = (pred * (1 - lab)).sum()
    fn = ((1 - pred) * lab * w[:, None]).sum()
    return 2 * tp / (2 * tp + fp + fn).clamp_min(1.0)


def rocauc(logits, labels, mask=None) -> torch.Tensor:
    """Mean ROC-AUC over the classes that have both positives and negatives
    among the masked rows, by the rank-sum (Mann-Whitney) identity."""
    n, c = logits.shape
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=logits.device)
    w = mask.to(torch.float32)[:, None]
    lab = (labels > 0.5).to(torch.float32)
    # rank only masked rows: unmasked scores sink to the bottom ranks
    # (1..n_unmasked), and that offset is taken off the positives' sum
    scores = torch.where(mask[:, None], logits, torch.full_like(logits, -torch.inf))
    order = torch.argsort(scores, dim=0, stable=True)
    ranks = torch.empty_like(logits).scatter_(
        0, order, torch.arange(1, n + 1, dtype=logits.dtype, device=logits.device)[:, None]
        .expand(n, c).contiguous()
    )
    n_unmasked = (1.0 - mask.to(torch.float32)).sum()
    pos = lab * w
    neg = (1 - lab) * w
    npos = pos.sum(0)
    nneg = neg.sum(0)
    rank_pos = (ranks * pos).sum(0) - npos * n_unmasked
    auc = (rank_pos - npos * (npos + 1) / 2) / (npos * nneg).clamp_min(1.0)
    valid = (npos > 0) & (nneg > 0)
    return torch.where(valid, auc, torch.zeros_like(auc)).sum() / valid.sum().clamp_min(1)
