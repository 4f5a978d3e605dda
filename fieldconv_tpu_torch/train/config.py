"""Typed experiment configuration.

A copy of ``fieldconv_tpu/train/config.py`` (importing that module would
import JAX), so configs and bundle JSON carry the same fields in both
packages.  The routing options name the JAX package's layouts; the port
runs the dense banded layout, the mixed route, the pure-panel layout
(``layout``, ``panel_threshold``), the compact route (``echo_impl`` /
``conv_impl`` "compact"), the banded ECHO (``echo_impl="banded"``) and
the gather path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    task: str = "classification"     # classification|segmentation|correspondence|matching
    # filter hyperparameters
    band_limit: int = 2
    n_rings: int = 6
    ftype: int = 1
    nf: int = 32
    epsilon: float = 0.2
    n_des: Optional[int] = None
    n_bins: int = 3
    # sampling
    sample_n: Optional[int] = None
    max_neighbors: int = 512
    # optimisation
    lr: float = 0.01
    lr_decay_epoch: Optional[int] = None
    lr_decayed: float = 0.001
    epochs: int = 30
    batch_step: int = 1              # gradient accumulation (notebook batch_step)
    smoothing: float = 0.0           # label smoothing
    n_pairs: int = 512               # twin-loss pair draws
    twin_mu: float = 5.0
    seed: int = 0
    # augmentation (reference: RandomScale(0.85,1.15) + ±45° rotations)
    random_scale: Optional[Tuple[float, float]] = (0.85, 1.15)
    random_rotate_deg: float = 45.0
    # per-draw centering before the rotations: the correspondence/matching
    # transform chains start with T.Center() (correspondence.ipynb cell 5,
    # feature_matching.ipynb cell 6); classification/segmentation do not.
    # Center-then-rotate is deterministic-then-random, so it is applied once
    # at batch build time (MeshRecord.padded_pos(center=True)).
    center: bool = False
    # runtime
    d_chunk: int = 128
    # ECHO implementation: "panel" (panel kernel), "compact" (same kernel
    # on the compacted-column panel layout), "onehot" (separable splat), or
    # "banded" (gather-free block window).  "panel"/"compact"/"banded"
    # require banded_tb.
    echo_impl: str = "onehot"
    # Lift (TransField) implementation: "banded" (gather-free, whenever a
    # CompressedBandedTable is available) or "gather" (padded-CSR path;
    # also the route when banded_tb is unset).
    lift_impl: str = "banded"
    # Conv table in the pure-panel (>=panel_threshold) layout: "panel"
    # (block (TB,TB) panels) or "compact" (the gathered-column
    # CompactPanelTable the ECHO/lift kernels use, so one table serves
    # every op).  "compact" requires echo_impl="compact".  Ignored below
    # the panel threshold (the mixed banded-conv route).
    conv_impl: str = "panel"
    # Stencil layout: "banded" (dense ±nh block window, O(N^1.5) memory),
    # "panel" (panel-CSR, memory scales with the (tgt,src)-block panel
    # count), or "auto" (panel above panel_threshold padded vertices,
    # banded below).  The panel layout routes every op through the panel
    # paths.
    layout: str = "auto"
    panel_threshold: int = 20000
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 5
    # metrics readback cadence: device losses are fetched to host in chunks
    # of this many steps so the non-finite guard / logging never serialise
    # dispatch (the guard itself is device-side, trainer.py).
    log_every: int = 50

    def __post_init__(self):
        if self.task not in (
                "classification", "segmentation", "correspondence",
                "matching"):
            raise ValueError(f"unknown task {self.task!r}")
        if self.echo_impl not in ("onehot", "banded", "panel", "compact"):
            raise ValueError(
                f"echo_impl must be 'onehot'/'banded'/'panel'/'compact', "
                f"got {self.echo_impl!r}")
        if self.lift_impl not in ("gather", "banded"):
            raise ValueError(
                f"lift_impl must be 'gather' or 'banded', got "
                f"{self.lift_impl!r}")
        if self.layout not in ("auto", "banded", "panel"):
            raise ValueError(
                f"layout must be 'auto'/'banded'/'panel', got "
                f"{self.layout!r}")
        if self.conv_impl not in ("panel", "compact"):
            raise ValueError(
                f"conv_impl must be 'panel' or 'compact', got "
                f"{self.conv_impl!r}")
        if self.conv_impl == "compact" and self.echo_impl != "compact":
            raise ValueError(
                "conv_impl='compact' runs the whole model off one "
                "CompactPanelTable and requires echo_impl='compact'")
        if self.ftype not in (0, 1, 2):
            raise ValueError(f"ftype must be 0/1/2, got {self.ftype}")


CLASSIFICATION = ExperimentConfig(
    task="classification", band_limit=2, n_rings=6, nf=32, epsilon=0.2,
    lr=0.01, epochs=30,
)   # classification.ipynb cells 3, 10, 15

SEGMENTATION = ExperimentConfig(
    task="segmentation", band_limit=2, n_rings=6, nf=48, epsilon=0.2,
    n_des=48, n_bins=3, sample_n=1024, lr=0.01, epochs=15, smoothing=0.2,
    echo_impl="panel",
)   # segmentation.ipynb cells 4, 11, 16; echo routing: KERNEL_NOTES r4

CORRESPONDENCE = ExperimentConfig(
    task="correspondence", band_limit=1, n_rings=3, nf=32, epsilon=0.0425,
    n_des=12, n_bins=2, lr=0.01, lr_decay_epoch=40, lr_decayed=0.001,
    epochs=60, random_scale=None, center=True, echo_impl="panel",
)   # correspondence.ipynb cells 3, 5 (T.Center), 10, 15

MATCHING = ExperimentConfig(
    task="matching", band_limit=1, n_rings=6, nf=32, epsilon=0.1,
    sample_n=2048, lr=0.001, lr_decay_epoch=40, lr_decayed=0.001,
    epochs=80, n_pairs=512, random_scale=None, center=True,
)   # feature_matching.ipynb cells 4, 6 (T.Center), 11, 17

PRESETS = {
    "classification": CLASSIFICATION,
    "segmentation": SEGMENTATION,
    "correspondence": CORRESPONDENCE,
    "matching": MATCHING,
}
