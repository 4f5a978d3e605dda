"""FAUST dense-correspondence network (reference correspondence.ipynb cell 8).

Counterpart of ``fieldconv_tpu/models/correspondence.py``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..nn.modules import (ECHOBlock, FCResNetBlock, LiftBlock, Linear,
                          TangentPerceptron)
from ..parallel.distributed import Axis
from ..precomp.edge_table import EdgeTable
from ..utils.device import resolve_device


class CorrespondenceNet(nn.Module):
    """Lift(3→16) + 8×FCResNet with 4 meta-residuals + ECHOBlock + MLP head.

    Dropout(p) acts before the last layer in training mode; serving runs
    the net in ``eval()``.  ``forward(..., dropout_mask=m)`` applies the
    given keep mask instead (x·m/(1−p)), so tests can feed this net and the
    JAX one the same realisation.  Parameters are drawn from ``generator``
    and then moved to ``device``.

    remat_blocks: recompute each FCResNetBlock in the backward instead of
    keeping its activations (``torch.utils.checkpoint``; the JAX net's
    ``lnn.remat``): at 100k+ vertices the per-conv activations otherwise
    dominate device memory.  return_features: return the 256-wide features
    that enter lin2 (after dropout) instead of the logits, for a caller
    that applies the 4999-way head row-chunked ((N, 4999) logits are 3.3
    GB at 163,842 vertices).  Neither changes the parameters.  graph: the
    graph axis of graph-parallel training (the ops over this rank's shard;
    a keep mask passed in is this rank's rows, parallel/gp.py).
    """

    def __init__(self, n_classes: int = 4999, nf: int = 32, n_des: int = 12,
                 n_bins: int = 2, band_limit: int = 1, n_rings: int = 3,
                 ftype: int = 1, dropout: float = 0.5, d_chunk: int = 128,
                 lift_impl: str = "auto", echo_impl: str = "auto",
                 remat_blocks: bool = False, return_features: bool = False,
                 generator: Optional[torch.Generator] = None,
                 device="cuda", graph: Optional[Axis] = None):
        super().__init__()
        device = resolve_device(device)
        self.band_limit, self.lift_impl, self.p = band_limit, lift_impl, dropout
        self.remat_blocks, self.return_features = remat_blocks, return_features
        kw = dict(band_limit=band_limit, n_rings=n_rings, ftype=ftype,
                  d_chunk=d_chunk, generator=generator, graph=graph)
        g = dict(generator=generator)
        self.lift = LiftBlock(3, 16, n_rings=n_rings, ftype=ftype,
                              d_chunk=d_chunk, generator=generator,
                              graph=graph)
        self.resnet1 = FCResNetBlock(16, nf, **kw)
        self.resnet2 = FCResNetBlock(nf, nf, **kw)
        self.res1 = TangentPerceptron(16, nf, **g)
        self.resnet3 = FCResNetBlock(nf, nf, **kw)
        self.resnet4 = FCResNetBlock(nf, nf, **kw)
        self.res2 = TangentPerceptron(nf, nf, **g)
        self.resnet5 = FCResNetBlock(nf, nf, **kw)
        self.resnet6 = FCResNetBlock(nf, nf, **kw)
        self.res3 = TangentPerceptron(nf, nf, **g)
        self.resnet7 = FCResNetBlock(nf, nf, **kw)
        self.resnet8 = FCResNetBlock(nf, 16, frontload=True, **kw)
        self.res4 = TangentPerceptron(nf, 16, **g)
        self.echo = ECHOBlock(16, nf, n_des=n_des, n_bins=n_bins,
                              echo_impl=echo_impl, **kw)
        self.lin1 = Linear(nf, 256, **g)
        self.dropout = nn.Dropout(dropout)
        self.lin2 = Linear(256, n_classes, **g)
        self.to(device)

    def forward(self, pos, table: EdgeTable, banded=None, comp=None, *,
                dropout_mask=None):
        """pos: (..., N, 3).  Returns per-vertex logits (..., N, n_classes),
        or the (..., N, 256) features with return_features."""
        B = self.band_limit
        lift_comp = None if self.lift_impl == "gather" else comp
        x1 = self.lift(pos, table, (B, B + 1), lift_comp)

        def block(module, x):
            if self.remat_blocks and torch.is_grad_enabled():
                return checkpoint(module, x, table, banded,
                                  use_reentrant=False)
            return module(x, table, banded)

        x = block(self.resnet1, x1)
        x2 = block(self.resnet2, x) + self.res1(x1)
        x = block(self.resnet3, x2)
        x3 = block(self.resnet4, x) + self.res2(x2)
        x = block(self.resnet5, x3)
        x4 = block(self.resnet6, x) + self.res3(x3)
        x = block(self.resnet7, x4)
        x = block(self.resnet8, x) + self.res4(x4)
        x = self.echo(x, table, banded, comp)
        x = torch.relu(self.lin1(x))
        if dropout_mask is not None:
            x = x * dropout_mask / (1.0 - self.p)
        else:
            x = self.dropout(x)
        if self.return_features:
            return x
        return self.lin2(x)
