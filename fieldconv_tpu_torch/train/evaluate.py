"""Evaluation matching the reference notebooks' test() functions.

Counterpart of ``fieldconv_tpu/train/evaluate.py`` for classification,
segmentation and correspondence; the matching rates come with the matching
slice (ROADMAP Queue 1 item 3).  Each runs without gradients and with the
net in ``eval()`` (no dropout), restoring its mode afterwards.
"""

from __future__ import annotations

import contextlib

import torch

from ..nn.losses import cross_entropy
from .trainer import batched_apply


@contextlib.contextmanager
def _evaluating(net):
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            yield
    finally:
        net.train(was_training)


def classification_accuracy(net, batches) -> float:
    """Fraction of meshes classified correctly (classification.ipynb cell
    13)."""
    correct = total = 0
    with _evaluating(net):
        for batch in batches:
            pred = batched_apply(net, batch)[:, 0, :].argmax(dim=-1)
            correct += int((pred == batch.labels).sum().item())
            total += len(pred)
    return correct / max(total, 1)


def segmentation_accuracy(net, batches) -> float:
    """Per-vertex accuracy over the valid vertices, labels >= 0
    (segmentation.ipynb cell 14)."""
    correct = total = 0
    with _evaluating(net):
        for batch in batches:
            pred = batched_apply(net, batch).argmax(dim=-1)
            valid = batch.labels >= 0
            correct += int((pred[valid] == batch.labels[valid]).sum().item())
            total += int(valid.sum().item())
    return correct / max(total, 1)


def correspondence_loss(net, batches, n_classes: int) -> float:
    """Mean over batches of the test cross entropy, deterministic: no
    dropout mask, the net in eval() (correspondence.ipynb cell 13)."""
    tot, n = 0.0, 0
    with _evaluating(net):
        for batch in batches:
            logits = batched_apply(net, batch)
            tot += float(cross_entropy(logits.reshape(-1, n_classes),
                                       batch.labels.reshape(-1)).item())
            n += 1
    return tot / max(n, 1)
