"""Model construction and batch building.

Counterpart of ``build_model`` and ``make_batches`` in
``fieldconv_tpu/train/loop.py``, for the classification task on the dense
banded layout (or the gather path when ``banded_tb`` is None).  The fit
loop is the training slice of the port (ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..data.base import MeshRecord, shared_bucket
from ..models import ClassificationNet
from ..utils.device import resolve_device
from .config import ExperimentConfig
from .trainer import stack_batch


def build_model(config: ExperimentConfig, n_classes: int,
                generator: Optional[torch.Generator] = None,
                device="cuda"):
    if config.task != "classification":
        raise NotImplementedError(
            f"task {config.task!r} is not ported yet: segmentation and "
            "correspondence are ROADMAP Queue 1 (ECHO slice), matching its "
            "next item")
    return ClassificationNet(
        n_classes=n_classes, nf=config.nf, band_limit=config.band_limit,
        n_rings=config.n_rings, ftype=config.ftype, d_chunk=config.d_chunk,
        lift_impl=config.lift_impl, generator=generator, device=device)


def resolve_layout(config: ExperimentConfig, n_pad: int) -> str:
    """'banded' or 'panel' per config.layout ('auto': panel above the
    threshold)."""
    if config.layout != "auto":
        return config.layout
    return "panel" if n_pad > config.panel_threshold else "banded"


def make_batches(records: List[MeshRecord], config: ExperimentConfig,
                 batch_size: int = 1, banded_tb: Optional[int] = None,
                 n_pad=None, d_slots=None, device="cuda"):
    """Group records into same-bucket MeshBatches on ``device``.

    banded_tb: build the dense banded tables (K1 convs) with that
    target-block size, plus the compressed tables of the gather-free lift
    when config.lift_impl == "banded"; None serves the gather path."""
    device = resolve_device(device)
    if config.task != "classification":
        raise NotImplementedError(
            f"make_batches for task {config.task!r} is not ported yet "
            "(ROADMAP Queue 1)")
    if n_pad is None or d_slots is None:
        n_pad, d_slots = shared_bucket(records)
    if banded_tb is not None and resolve_layout(config, n_pad) == "panel":
        raise NotImplementedError(
            f"n_pad={n_pad} resolves to the panel layout, which is not "
            "ported yet (ROADMAP Queue 1: the 100k+-vertex layouts); set "
            "config.layout='banded' to force the dense band")
    need_comp = banded_tb is not None and config.lift_impl == "banded"

    def build_group(group):
        items = []
        for r in group:
            table = r.table(config.band_limit, config.n_rings,
                            n_pad=n_pad, d_slots=d_slots)
            items.append((r.padded_pos(n_pad, center=config.center), table,
                          r.padded_labels(n_pad)))
        batch = stack_batch(items, banded_tb=banded_tb, echo_banded=need_comp)
        return batch.to(device)

    return [build_group(records[lo:lo + batch_size])
            for lo in range(0, len(records), batch_size)]
