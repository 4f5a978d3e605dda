"""Human-body segmentation network (reference segmentation.ipynb cell 9).

Counterpart of ``fieldconv_tpu/models/segmentation.py``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.modules import ECHOBlock, FCResNetBlock, LiftBlock
from ..parallel.distributed import Axis
from ..precomp.edge_table import EdgeTable
from ..utils.device import resolve_device


class SegmentationNet(nn.Module):
    """Lift + 4×FCResNet + ECHOBlock(nf→n_classes).

    lift_impl: "auto" (the block-table lift when a CompressedBandedTable
    or PanelTable is passed) or "gather".  echo_impl: the ECHO routing of
    nn.modules.ECHO.  graph: the graph axis of graph-parallel training
    (the ops over this rank's shard, parallel/gp.py).  Parameters are
    drawn from ``generator`` and then moved to ``device``.
    """

    def __init__(self, n_classes: int = 8, nf: int = 48, n_des: int = 48,
                 n_bins: int = 3, band_limit: int = 2, n_rings: int = 6,
                 ftype: int = 1, d_chunk: int = 128, lift_impl: str = "auto",
                 echo_impl: str = "auto",
                 generator: Optional[torch.Generator] = None,
                 device="cuda", graph: Optional[Axis] = None):
        super().__init__()
        device = resolve_device(device)
        self.band_limit, self.lift_impl = band_limit, lift_impl
        kw = dict(band_limit=band_limit, n_rings=n_rings, ftype=ftype,
                  d_chunk=d_chunk, generator=generator, graph=graph)
        self.lift = LiftBlock(3, nf, n_rings=n_rings, ftype=ftype,
                              d_chunk=d_chunk, generator=generator,
                              graph=graph)
        for i in range(1, 5):
            setattr(self, f"resnet{i}", FCResNetBlock(nf, nf, **kw))
        self.echo = ECHOBlock(nf, n_classes, n_des=n_des, n_bins=n_bins,
                              echo_impl=echo_impl, **kw)
        self.to(device)

    def forward(self, pos, table: EdgeTable, banded=None, comp=None):
        """pos: (..., N, 3).  Returns per-vertex logits (..., N, n_classes)."""
        B = self.band_limit
        lift_comp = None if self.lift_impl == "gather" else comp
        x = self.lift(pos, table, (B, B + 1), lift_comp)
        for i in range(1, 5):
            x = getattr(self, f"resnet{i}")(x, table, banded)
        return self.echo(x, table, banded, comp)
