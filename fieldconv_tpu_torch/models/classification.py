"""SHREC11 classification network (reference classification.ipynb cell 8).

Counterpart of ``fieldconv_tpu/models/classification.py``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.modules import FCResNetBlock, FieldConv, LiftBlock
from ..parallel.distributed import Axis, AllReduceSum
from ..precomp.edge_table import EdgeTable
from ..utils import complexops as co
from ..utils.device import resolve_device


class ClassificationNet(nn.Module):
    """Lift + 2×FCResNet + FieldConv→classes + masked mean pool + bias.

    Parity quirk: the notebook passes the *full* stencil to LiftBlock, so
    TransField reads K-columns (0, 1) = frequencies (-B, -B+1) instead of
    (0, +1).  ``legacy_lift_slice`` (default True) reproduces it.

    lift_impl: "auto" (gather-free banded lift when a CompressedBandedTable
    is passed) or "gather" (always the padded-CSR path).

    The mean pool divides by ``table.n_valid``.  A stacked batch carries
    the first mesh's count (train/trainer.py::stack_batch), so every mesh
    of a batch of unequal sizes is divided by mesh 0's count, as in the JAX
    package (ROADMAP Queue 3).

    graph: the graph axis of graph-parallel training: the vertex rows are
    this rank's shard, the tables its shards (BandedTable ``banded``,
    CompressedBandedTable ``comp``), ``table.n_valid`` the GLOBAL count
    (parallel/gp.py::VertexMeta), and the pool's sum is all-reduced over
    the axis (its backward sums the cotangents, JAX's psum).

    Parameters are drawn from ``generator`` and then moved to ``device``.
    """

    def __init__(self, n_classes: int, nf: int = 32, band_limit: int = 2,
                 n_rings: int = 6, ftype: int = 1,
                 legacy_lift_slice: bool = True, d_chunk: int = 128,
                 lift_impl: str = "auto",
                 generator: Optional[torch.Generator] = None,
                 device="cuda", graph: Optional[Axis] = None):
        super().__init__()
        device = resolve_device(device)
        self.n_classes = n_classes
        self.band_limit = band_limit
        self.legacy_lift_slice = legacy_lift_slice
        self.lift_impl = lift_impl
        self.graph = graph
        kw = dict(band_limit=band_limit, n_rings=n_rings, ftype=ftype,
                  d_chunk=d_chunk, generator=generator, graph=graph)
        self.lift = LiftBlock(3, nf, n_rings=n_rings, ftype=ftype,
                              d_chunk=d_chunk, generator=generator,
                              graph=graph)
        self.resnet1 = FCResNetBlock(nf, nf, **kw)
        self.resnet2 = FCResNetBlock(nf, nf, **kw)
        self.conv_out = FieldConv(nf, n_classes, **kw)
        self.bias = nn.Parameter(torch.zeros(1, n_classes))
        self.to(device)

    def forward(self, pos, table: EdgeTable, banded=None, comp=None):
        """pos: (..., N, 3).  Returns logits (..., 1, n_classes)."""
        B = self.band_limit
        lift_cols = (0, 1) if self.legacy_lift_slice else (B, B + 1)
        lift_comp = None if self.lift_impl == "gather" else comp
        x = self.lift(pos, table, lift_cols, lift_comp)
        x = self.resnet1(x, table, banded)
        x = self.resnet2(x, table, banded)
        x = self.conv_out(x, table, banded)

        mags = co.soft_abs(x) * table.vmask[..., :, None]
        summed = torch.sum(mags, dim=-2, keepdim=True)
        if self.graph is not None:
            summed = AllReduceSum.apply(summed, self.graph)
        pooled = summed / table.n_valid
        return pooled + self.bias
