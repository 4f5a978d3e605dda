"""Evaluation matching the reference notebooks' test() functions.

Counterpart of ``fieldconv_tpu/train/evaluate.py`` for classification;
the segmentation, correspondence and matching evaluations come with their
slices (ROADMAP Queue 1).
"""

from __future__ import annotations

import torch

from .trainer import batched_apply


@torch.no_grad()
def classification_accuracy(net, batches) -> float:
    """Fraction of meshes classified correctly (classification.ipynb cell
    13)."""
    correct = total = 0
    for batch in batches:
        pred = batched_apply(net, batch)[:, 0, :].argmax(dim=-1)
        correct += int((pred == batch.labels).sum().item())
        total += len(pred)
    return correct / max(total, 1)
