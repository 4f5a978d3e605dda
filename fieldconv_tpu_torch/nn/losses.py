"""Classification losses.

Counterpart of ``cross_entropy`` and ``label_smoothing_loss`` in
``fieldconv_tpu/nn/losses.py`` (reference nn/label_smoothing_loss.py).
Labels below 0 mark padding and are masked; both losses divide by
max(#valid, 1).  The twin loss of the matching task is not ported yet
(ROADMAP Queue 1, matching).
"""

from __future__ import annotations

import torch


def cross_entropy(logits, labels, count=None):
    """Mean cross entropy over valid rows; labels < 0 are masked.
    logits: (..., n_classes); labels: logits.shape[:-1] integers.  count:
    the divisor in place of max(#valid, 1) (a graph-parallel shard's sum
    over the global count, parallel/gp.py)."""
    valid = labels >= 0
    labels_safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels_safe[..., None].long())[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / (valid.sum().clamp(min=1) if count is None else count)


def label_smoothing_loss(logits, labels, n_classes: int,
                         smoothing: float = 0.0, weight=None, count=None):
    """Label-smoothed cross entropy: the target distribution puts
    1 − smoothing on the label and smoothing / (n_classes − 1) on every
    other class; mean over valid rows of Σ −p·log_softmax.  labels < 0 are
    masked; ``weight`` (n_classes,) scales the log-probabilities; ``count``
    as in :func:`cross_entropy`."""
    valid = labels >= 0
    labels_safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits, dim=-1)
    if weight is not None:
        logp = logp * weight[None, :]
    confidence = 1.0 - smoothing
    off = smoothing / (n_classes - 1)
    onehot = torch.nn.functional.one_hot(labels_safe.long(), n_classes)
    true_dist = onehot.to(logp.dtype) * (confidence - off) + off
    per_row = torch.sum(-true_dist * logp, dim=-1)
    per_row = torch.where(valid, per_row, torch.zeros_like(per_row))
    return per_row.sum() / (valid.sum().clamp(min=1) if count is None
                            else count)
