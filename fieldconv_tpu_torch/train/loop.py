"""Model construction, batch building and the training loop.

Counterpart of ``build_model``, ``make_batches``, ``fit`` and
``evaluate_task`` in ``fieldconv_tpu/train/loop.py``.  Models and batches
cover classification, segmentation and correspondence: the dense banded
layout, the mixed route (banded convs, panel ECHO and lift) of the ECHO
presets, the pure-panel layout of large meshes (every op over one
PanelTable), the compact route (ECHO and the lift, and optionally the
convs, over one CompactPanelTable), the banded ECHO (ECHO and the lift
over one CompressedBandedTable beside banded convs), or the gather path
when ``banded_tb`` is None.  ``fit`` and ``evaluate_task`` train and evaluate the three of
them on every one of these layouts; matching is ROADMAP Queue 1 item 3.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import List, Optional

import numpy as np
import torch

from ..data.base import MeshRecord, shared_bucket
from ..models import ClassificationNet, CorrespondenceNet, SegmentationNet
from ..utils.device import resolve_device
from . import evaluate
from .checkpoint import CheckpointManager
from .config import ExperimentConfig
from .metrics import MetricsLogger
from .trainer import (draw_dropout_mask, draw_rotate_scale, make_optimizer,
                      make_train_step, stack_batch,
                      stack_panel_batch)


def build_model(config: ExperimentConfig, n_classes: int,
                generator: Optional[torch.Generator] = None,
                device="cuda", graph=None):
    """The task's net.  graph: the graph axis
    (parallel/distributed.py::Axis) of graph-parallel training
    (parallel/gp.py), whose ops run over this rank's shards; the
    parameters are those of the single-process net."""
    kw = dict(band_limit=config.band_limit, n_rings=config.n_rings,
              ftype=config.ftype, d_chunk=config.d_chunk,
              lift_impl=config.lift_impl, generator=generator, device=device,
              graph=graph)
    if config.task == "classification":
        return ClassificationNet(n_classes=n_classes, nf=config.nf, **kw)
    if config.task == "segmentation":
        return SegmentationNet(n_classes=n_classes, nf=config.nf,
                               n_des=config.n_des or config.nf,
                               n_bins=config.n_bins,
                               echo_impl=config.echo_impl, **kw)
    if config.task == "correspondence":
        return CorrespondenceNet(n_classes=n_classes, nf=config.nf,
                                 n_des=config.n_des or 12,
                                 n_bins=config.n_bins,
                                 echo_impl=config.echo_impl, **kw)
    raise NotImplementedError(
        f"task {config.task!r} is not ported yet: matching is ROADMAP "
        "Queue 1 item 3")


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

    banded_tb: the target-block size of the block layouts; None serves the
    gather path.  With banded_tb, a bucket whose layout resolves to
    "panel" (:func:`resolve_layout`: config.layout, or n_pad above
    config.panel_threshold) takes the pure-panel layout, banded_tb serving
    as the panel target-block size: one compressed PanelTable per batch
    for every op (K5 convs, panel ECHO and lift), no banded or compressed
    banded tables.  An ECHO task with config.echo_impl == "compact" adds
    one CompactPanelTable per batch at target-block size min(banded_tb, 32)
    for ECHO (K7) and the lift, and with config.conv_impl == "compact" it
    serves the convs (K6) too, in place of the PanelTable.  Below it the
    dense banded tables (K1 convs) are built; an ECHO task with
    config.echo_impl "panel" / "compact" takes the mixed route (one
    compressed PanelTable / CompactPanelTable at banded_tb per batch for
    ECHO and the lift), otherwise the compressed banded tables are built
    when the ECHO runs on them (echo_impl "banded", ops/echo.py::
    echo_banded) or config.lift_impl == "banded" (the gather-free lift).
    Without banded_tb an ECHO task with echo_impl "panel" / "compact"
    warns and takes the one-hot ECHO, and echo_impl "banded" raises a
    ValueError, as in the JAX package; conv_impl "compact" without the
    compact ECHO warns, as in the JAX package, and runs the other convs."""
    device = resolve_device(device)
    if config.task == "matching":
        raise NotImplementedError(
            "make_batches for task 'matching' is not ported yet (ROADMAP "
            "Queue 1 item 3)")
    echo_task = config.task in ("segmentation", "correspondence")
    if echo_task and banded_tb is None \
            and config.echo_impl in ("panel", "compact"):
        warnings.warn(f"echo_impl={config.echo_impl!r} needs banded_tb; "
                      "falling back to the one-hot ECHO for this run")
        config = dataclasses.replace(config, echo_impl="onehot")
    echo_compact = echo_task and config.echo_impl == "compact"
    if config.conv_impl == "compact" and not echo_compact:
        # the compact convs ride the ECHO/lift CompactPanelTable, which is
        # not built here: say so rather than quietly running other convs
        warnings.warn(
            "conv_impl='compact' requires echo_impl='compact' on an ECHO "
            f"task (task={config.task!r}, echo_impl={config.echo_impl!r}); "
            "the convs will run on the block-panel/banded layout")
    if config.echo_impl == "banded" and echo_task and banded_tb is None:
        raise ValueError(
            "config.echo_impl='banded' requires banded_tb: the gather-free "
            "ECHO path runs on compressed banded tables built per "
            "target-block size (pass banded_tb=, or use echo_impl='onehot')")
    if n_pad is None or d_slots is None:
        n_pad, d_slots = shared_bucket(records)
    panel = (banded_tb is not None
             and resolve_layout(config, n_pad) == "panel")
    echo_panel = (banded_tb is not None and not panel and echo_task
                  and config.echo_impl == "panel")
    # compressed tables feed the banded ECHO and/or the gather-free lift
    need_comp = (banded_tb is not None and not panel and not echo_panel
                 and not echo_compact
                 and ((config.echo_impl == "banded" and echo_task)
                      or config.lift_impl == "banded"))

    def build_group(group):
        items = []
        for r in group:
            table = r.table(config.band_limit, config.n_rings,
                            n_pad=n_pad, d_slots=d_slots)
            items.append((r.padded_pos(n_pad, center=config.center), table,
                          r.padded_labels(n_pad)))
        if panel:
            batch = stack_panel_batch(
                items, banded_tb, echo_compact=echo_compact,
                conv_compact=echo_compact and config.conv_impl == "compact")
        else:
            batch = stack_batch(items, banded_tb=banded_tb,
                                echo_banded=need_comp, echo_panel=echo_panel,
                                echo_compact=echo_compact)
        return batch.to(device)

    return [build_group(records[lo:lo + batch_size])
            for lo in range(0, len(records), batch_size)]


def fit(config: ExperimentConfig, train_records: List[MeshRecord],
        test_records: Optional[List[MeshRecord]] = None, n_classes: int = 30,
        batch_size: int = 1, banded_tb: Optional[int] = None,
        log_path: Optional[str] = None, eval_every: Optional[int] = None,
        seed: int = 0, device="cuda"):
    """Train per the config on ``device``; returns (net, optimizer, final
    test metric or None).  The optimizer (trainer.Adam) carries the step
    count and state.

    Parameters are drawn from a CPU generator seeded with ``seed``, the
    batch order from ``np.random.default_rng(seed + 2)``, the augmentation
    from a CPU generator seeded with ``seed + 1`` and the correspondence
    net's dropout masks from one seeded with ``seed + 3``, so runs on the
    card and on the CPU see the same weights, batches and draws.  The net
    steps in train() mode; evaluation runs it in eval().
    Losses stay on the device and are read back every config.log_every
    steps into the JSONL log.  With config.checkpoint_dir set, the latest
    checkpoint there is restored first (the batch order and augmentation
    streams are advanced past the steps it covers, so a resumed run
    continues as an uninterrupted one would) and one is saved every
    config.checkpoint_every epochs and at the end.

    A bucket on the pure-panel layout trains as the others do: every conv
    runs K5 forward and backward, ECHO K2, over the batch's one
    PanelTable.  On the compact route (an ECHO config with echo_impl
    "compact" and banded_tb set) ECHO runs K7 forward and backward over the
    batch's one CompactPanelTable, and with conv_impl "compact" every conv
    runs K6 forward and backward over it too."""
    device = resolve_device(device)
    net = build_model(config, n_classes,
                      generator=torch.Generator().manual_seed(seed),
                      device=device)
    all_records = train_records + (test_records or [])
    n_pad, d_slots = shared_bucket(all_records)
    train_batches = make_batches(train_records, config, batch_size,
                                 banded_tb, n_pad, d_slots, device=device)
    test_batches = (make_batches(test_records, config, batch_size, banded_tb,
                                 n_pad, d_slots, device=device)
                    if test_records else [])

    steps_per_epoch = len(train_batches)
    opt = make_optimizer(config, net.parameters(), steps_per_epoch)
    start_step = 0
    ckpt = None
    if config.checkpoint_dir:
        ckpt = CheckpointManager(config.checkpoint_dir)
        restored = ckpt.restore(net, opt)
        if restored is not None:
            start_step = restored
            print(f"resumed from step {start_step}")

    step_fn = make_train_step(net, config, n_classes, opt)
    logger = MetricsLogger(log_path)
    aug_gen = torch.Generator().manual_seed(seed + 1)
    order_rng = np.random.default_rng(seed + 2)
    mask_gen = (torch.Generator().manual_seed(seed + 3)
                if config.task == "correspondence" else None)
    edges_per_batch = float(train_batches[0].table.mask.sum().item())
    total_steps = config.epochs * steps_per_epoch
    save_every = config.checkpoint_every * steps_per_epoch

    # (step, issue timestamp, device loss) awaiting the chunked readback;
    # the non-finite guard itself runs on the device (trainer.py)
    pending: list = []

    def flush():
        if not pending:
            return
        vals = torch.stack([loss for _, _, loss in pending]).cpu().numpy()
        for (s, t, _), v in zip(pending, vals):
            v = float(v)
            if not np.isfinite(v):
                print(f"WARNING: non-finite loss at step {s}; the update "
                      "was skipped on device", flush=True)
            logger.log({"loss": v}, edges=edges_per_batch, t=t)
        pending.clear()

    net.train()          # evaluate_task switches to eval() and back
    try:
        step = 0
        while step < total_steps:
            order = order_rng.permutation(steps_per_epoch)
            for bi in order:
                if step >= total_steps:
                    break
                batch = train_batches[bi]
                aug = draw_rotate_scale(aug_gen, batch.pos.shape[0],
                                        config.random_rotate_deg,
                                        config.random_scale)
                mask = (None if mask_gen is None
                        else draw_dropout_mask(mask_gen, net, batch))
                step += 1
                if step <= start_step:          # covered by the checkpoint
                    continue
                loss = step_fn(batch, aug=aug, dropout_mask=mask)
                pending.append((step - 1, time.perf_counter(), loss))
                if len(pending) >= config.log_every:
                    flush()
                if ckpt and save_every and step % save_every == 0:
                    ckpt.save(net, opt, step)
            if eval_every and test_batches and step > start_step and \
                    (step // steps_per_epoch) % eval_every == 0:
                flush()
                m = evaluate_task(net, config, test_batches, n_classes)
                print(f"epoch {step // steps_per_epoch}: eval = {m:.4f}",
                      flush=True)
        flush()

        if ckpt and step > start_step:
            ckpt.save(net, opt, step)
        final = (evaluate_task(net, config, test_batches, n_classes)
                 if test_batches else None)
    finally:
        logger.close()
    return net, opt, final


def evaluate_task(net, config: ExperimentConfig, test_batches,
                  n_classes: int):
    """The task's test metric: accuracy (classification, per-vertex for
    segmentation) or the mean test cross entropy (correspondence), over
    batches of any layout."""
    if config.task == "classification":
        return evaluate.classification_accuracy(net, test_batches)
    if config.task == "segmentation":
        return evaluate.segmentation_accuracy(net, test_batches)
    if config.task == "correspondence":
        return evaluate.correspondence_loss(net, test_batches, n_classes)
    raise NotImplementedError(
        f"evaluation of {config.task!r} is not ported yet: matching is "
        "ROADMAP Queue 1 item 3")
