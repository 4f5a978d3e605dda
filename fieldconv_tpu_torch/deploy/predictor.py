"""Fixed-shape inference over mesh artifacts.

Counterpart of ``fieldconv_tpu/deploy/predictor.py`` for classification,
segmentation and correspondence.  The Predictor batches precomputed
MeshRecords with the same bucket/layout machinery as training
(train/loop.py::make_batches), runs the model (in ``eval()``: dropout off)
over each batch's mesh axis, and maps logits to task outputs.  PyTorch runs
eagerly, so there is no ahead-of-time compile: ``warmup`` runs each new
batch shape signature once (building the CUDA kernels on first use) and
records it, and ``strict_shapes`` refuses signatures that were not warmed
up.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..train.config import ExperimentConfig
from ..train.trainer import MeshBatch, batched_apply
from ..utils.device import resolve_device


def _shape_key(batch: MeshBatch):
    """Hashable signature of a batch: every tensor's shape and dtype plus
    the tables' static fields."""
    def sig(obj):
        if obj is None:
            return None
        if isinstance(obj, torch.Tensor):
            return (tuple(obj.shape), str(obj.dtype))
        if dataclasses.is_dataclass(obj):
            return tuple((f.name, sig(getattr(obj, f.name)))
                         for f in dataclasses.fields(obj))
        return obj
    return sig(batch)


class Predictor:
    """Batched forward for one model.

    Parameters
    ----------
    net : the model (train/loop.py::build_model), holding its weights.
    config : the ExperimentConfig it was built from.
    batch_size : meshes per batch (bucketed like training).
    banded_tb : target-block size of the block layouts (None = gather
        path): the dense band and the mixed route below the config's
        panel threshold, the pure-panel layout above it (one PanelTable
        per batch, every op over it; forward only).
    strict_shapes : when True, a batch whose shape signature was not warmed
        up raises instead of running.
    device : where batches and the model live; "cuda" by default, raising
        without a card.
    """

    def __init__(self, net, config: ExperimentConfig, batch_size: int = 1,
                 banded_tb: Optional[int] = None,
                 strict_shapes: bool = False, device="cuda"):
        if config.task == "matching":
            raise NotImplementedError(
                "serving task 'matching' is not ported yet (ROADMAP Queue 1 "
                "item 3)")
        self.device = resolve_device(device)
        self.net = net.to(self.device).eval()
        self.config = config
        self.batch_size = batch_size
        self.banded_tb = banded_tb
        self.strict_shapes = strict_shapes
        self._warm = set()

    # -- batching ----------------------------------------------------------

    def make_batches(self, records: Sequence, n_pad: Optional[int] = None,
                     d_slots: Optional[int] = None) -> List[MeshBatch]:
        """Bucket + stack records exactly as the trainer does, on the
        Predictor's device.  Pass both n_pad and d_slots to reuse a known
        bucket, or neither."""
        from ..train.loop import make_batches

        if (n_pad is None) != (d_slots is None):
            raise ValueError(
                "pass both n_pad and d_slots (the bucket signature) or "
                "neither — one alone would be silently recomputed")
        return make_batches(list(records), self.config, self.batch_size,
                            self.banded_tb, n_pad, d_slots,
                            device=self.device)

    def place(self, batch: MeshBatch) -> MeshBatch:
        """Move a batch's tensors to the Predictor's device (a no-op for
        batches from make_batches)."""
        return batch.to(self.device)

    # -- warm-up -----------------------------------------------------------

    def warmup(self, batches: Sequence[MeshBatch]) -> int:
        """Run each distinct batch signature once; returns how many new
        signatures were warmed up."""
        built = 0
        for b in batches:
            key = _shape_key(b)
            if key in self._warm:
                continue
            self._forward(b)
            self._warm.add(key)
            built += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return built

    # -- inference ---------------------------------------------------------

    def _forward(self, batch: MeshBatch):
        with torch.inference_mode():
            return batched_apply(self.net, batch)

    def logits(self, batch: MeshBatch):
        """Raw model output for one batch on the device: (B, 1, n_classes)
        for classification, (B, N, n_classes) per vertex otherwise (3.3 GB
        for one correspondence mesh of 163,842 samples)."""
        if self.strict_shapes and _shape_key(batch) not in self._warm:
            raise RuntimeError(
                "batch signature was not warmed up and strict_shapes=True; "
                "call warmup() with a batch of this shape first")
        return self._forward(batch)

    def predict(self, records: Sequence, n_pad: Optional[int] = None,
                d_slots: Optional[int] = None,
                batches: Optional[List[MeshBatch]] = None) -> List[dict]:
        """Task outputs, one dict per input record, in order:

        classification: {"class": int, "logits": (n_classes,)}
        segmentation:   {"labels": (n,) int32, "logits": (n, n_classes)}
        correspondence: {"map": (n,) int32 target-vertex ids, "logits": ...}

        with n the record's true sample count.  batches: the output of
        make_batches(records), to skip rebuilding the tables."""
        records = list(records)
        if batches is None:
            batches = self.make_batches(records, n_pad, d_slots)
        outs: List[dict] = []
        i = 0
        for batch in batches:
            y = self.logits(batch).cpu().numpy()
            for bi in range(y.shape[0]):
                if i >= len(records):
                    break   # trailing pad meshes in the last bucket
                outs.append(self._to_output(y[bi],
                                            records[i].n_samples))
                i += 1
        if i != len(records):
            raise RuntimeError(
                f"batching produced {i} outputs for {len(records)} records")
        return outs

    def _to_output(self, y: np.ndarray, n: int) -> dict:
        """Task output of one mesh from its rows of the batch's logits."""
        task = self.config.task
        if task == "classification":
            logits = y[0]
            return {"class": int(np.argmax(logits)), "logits": logits}
        logits = y[:n]
        key = "labels" if task == "segmentation" else "map"
        return {key: np.argmax(logits, axis=-1).astype(np.int32),
                "logits": logits}
