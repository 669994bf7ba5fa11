"""Evaluation metrics — port of `compute_micro_f1` (`maxk_tpu/train/metrics.py`).

Argmax accuracy for single-label tasks; micro-F1 over `logits > 0` for
multilabel ones. ROC-AUC (ogbn-proteins) is not ported yet.
"""

from __future__ import annotations

import torch


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
