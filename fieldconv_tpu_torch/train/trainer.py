"""Mesh batches and the batched forward.

Counterpart of the batching half of ``fieldconv_tpu/train/trainer.py``.
Meshes sharing a shape bucket are stacked into a MeshBatch with a leading
mesh axis; the model runs once over the whole batch (the JAX package's
vmap, written out as that axis), so one K1 launch serves every mesh of a
batch.  Training (losses, optimizer, steps) is the next slice of the port
(ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..precomp.banded import (
    R_SENTINEL,
    BandedTable,
    CompressedBandedTable,
    build_banded_table,
    build_compressed_banded,
)
from ..precomp.edge_table import EdgeTable


@dataclasses.dataclass
class MeshBatch:
    """A stack of same-bucket mesh artifacts.

    pos: (B, N, 3) float32 — sampled vertex positions (zero at padded rows)
    table: EdgeTable whose data fields carry a leading batch axis
    labels: (B,) int32 for mesh-level tasks or (B, N) int32 (-1 = padding)
    banded: optional batched BandedTable for the K1 conv path
    comp: optional batched CompressedBandedTable for the gather-free lift
    """

    pos: torch.Tensor
    table: EdgeTable
    labels: torch.Tensor
    banded: Optional[BandedTable] = None
    comp: Optional[CompressedBandedTable] = None

    def to(self, device) -> "MeshBatch":
        return MeshBatch(
            pos=self.pos.to(device), table=self.table.to(device),
            labels=self.labels.to(device),
            banded=None if self.banded is None else self.banded.to(device),
            comp=None if self.comp is None else self.comp.to(device))


def stack_batch(items, banded_tb: Optional[int] = None,
                echo_banded: bool = False) -> MeshBatch:
    """Stack (pos, table, label) triples sharing bucket shapes (CPU).

    banded_tb: when set, also build + stack BandedTables (K1 conv path)
    with that target-block size.
    echo_banded: when set (requires banded_tb), also build the compressed
    banded tables that drive the gather-free lift
    (ops/trans_field.py::trans_field_banded_contrib).

    The stacked table keeps the first mesh's ``n_valid`` (ROADMAP Queue 3).
    """
    poss, tables, labels = zip(*items)
    t0 = tables[0]
    stacked = EdgeTable(
        **{f: torch.stack([getattr(t, f) for t in tables])
           for f in ("src", "mask", "rsten", "fwxp", "ln", "wxp", "vmask")},
        n_valid=t0.n_valid,
        band_limit=t0.band_limit,
        n_rings=t0.n_rings,
    )
    banded = None
    if banded_tb is not None:
        bs = [build_banded_table(t, tb=banded_tb) for t in tables]
        nh = max(b.nh for b in bs)
        bs = [_pad_banded(b, nh) for b in bs]
        banded = BandedTable(
            sten_band=torch.stack([b.sten_band for b in bs]),
            tb=banded_tb, nh=nh, n_pad=bs[0].n_pad,
            band_limit=t0.band_limit, n_rings=t0.n_rings,
        )
    comp = None
    if echo_banded:
        if banded_tb is None:
            raise ValueError("echo_banded requires banded_tb")
        cs = [build_compressed_banded(t, tb=banded_tb) for t in tables]
        nh = max(c.nh for c in cs)
        cs = [_pad_comp(c, nh) for c in cs]
        comp = CompressedBandedTable(
            sten_band=torch.stack([c.sten_band for c in cs]),
            tb=banded_tb, nh=nh, n_pad=cs[0].n_pad,
            band_limit=t0.band_limit, n_rings=t0.n_rings,
        )
    return MeshBatch(
        pos=torch.stack([torch.as_tensor(np.asarray(p, np.float32))
                         for p in poss]),
        table=stacked,
        labels=torch.stack([torch.as_tensor(np.asarray(lab))
                            for lab in labels]),
        banded=banded,
        comp=comp,
    )


def _pad_banded(b: BandedTable, nh: int) -> BandedTable:
    """Widen a banded table to a larger half-window (zero slots)."""
    if b.nh == nh:
        return b
    grow = (nh - b.nh) * b.tb
    return dataclasses.replace(
        b, nh=nh,
        sten_band=torch.nn.functional.pad(b.sten_band, (grow, grow)))


def _pad_comp(c: CompressedBandedTable, nh: int) -> CompressedBandedTable:
    """Widen a compressed banded table to a larger half-window.

    Padded slots get R_SENTINEL in the r plane (kills radial hats) and 0 in
    the phasor/wxp planes (kills votes)."""
    if c.nh == nh:
        return c
    grow = (nh - c.nh) * c.tb
    out = torch.nn.functional.pad(c.sten_band, (grow, grow))
    out[..., 0, :, :grow] = R_SENTINEL
    out[..., 0, :, -grow:] = R_SENTINEL
    return dataclasses.replace(c, nh=nh, sten_band=out)


def batched_apply(net, batch: MeshBatch):
    """Run the model over the batch's mesh axis in one call: the banded
    route (BandedTable convs, plus the compressed lift when ``comp`` is
    set) or, without tables, the padded-CSR gather route."""
    return net(batch.pos, batch.table, batch.banded, batch.comp)
