"""torch.nn modules mirroring fieldconv_tpu/nn/modules.py.

Parameter names and shapes equal the flax modules' (and so the reference
torch modules', except TangentNonLin's bias, (C,) here as in flax), so a
flax params tree ported by utils/port_weights.py::params_from_jax loads
with ``load_state_dict(strict=True)``.  Features are planar complex
(..., N, C, 2) float32 with optional leading mesh-batch axes.  Parameters
are drawn from an explicit ``torch.Generator`` on the CPU; move the built
model with ``.to(device)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops import band_conv as band_ops
from ..ops import echo as echo_ops
from ..ops import field_conv as fc_ops
from ..ops import tangent as tangent_ops
from ..ops import trans_field as tf_ops
from ..ops.echo_panel import echo_panel_fused
from ..parallel.distributed import Axis
from ..parallel.halo import exchange_halos, halo_field_conv
from ..precomp.banded import (CompactPanelTable, CompressedBandedTable,
                              PanelTable)
from ..precomp.edge_table import EdgeTable
from ..utils import complexops as co
from .init import torch_linear_bias, torch_linear_weight, xavier_uniform


def _banded_shard(what, comp):
    """Raise unless ``comp`` is the CompressedBandedTable shard a
    graph-parallel lift or ECHO runs over."""
    if not isinstance(comp, CompressedBandedTable):
        raise NotImplementedError(
            f"graph-parallel {what} takes a CompressedBandedTable shard, got "
            f"{type(comp).__name__}: the panel-sharded path (PanelShards, "
            "CompactShards) is ROADMAP Queue 1 item 8")


class FieldConv(nn.Module):
    """Field convolution layer.  A BandedTable ``banded`` routes the
    contraction to the fused K1 kernel, a CompressedBandedTable to K4, a
    BlockSparseTable to the block-sparse conv K8, a PanelTable to the panel
    conv K5, a CompactPanelTable to the compact conv K6
    (ops/band_conv.py::field_conv_banded); otherwise the padded-CSR gather
    path runs.

    graph: the graph axis of graph-parallel training
    (parallel/distributed.py::Axis).  x then holds this rank's vertex rows
    and ``banded`` must be the BandedTable shard of them: the conv runs
    through K9 with the halo exchange (parallel/halo.py::halo_field_conv).
    """

    def __init__(self, in_channels: int, out_channels: int,
                 band_limit: int = 1, n_rings: int = 6, ftype: int = 1,
                 d_chunk: int = 128,
                 generator: Optional[torch.Generator] = None,
                 graph: Optional[Axis] = None):
        super().__init__()
        O, I, R, B = out_channels, in_channels, n_rings, band_limit
        self.band_limit, self.ftype, self.d_chunk = B, ftype, d_chunk
        self.graph = graph
        self.phase_shape = (O, I, B + 1)
        if ftype in (0, 1):
            self.zonal = nn.Parameter(xavier_uniform((O, I, R), generator))
            self.spherical = nn.Parameter(xavier_uniform((O, I, R, B, 2), generator))
            if ftype == 1:
                self.phase = nn.Parameter(xavier_uniform((O, I, B + 1), generator))
        else:
            self.zonal = nn.Parameter(xavier_uniform((O, I, R, 2), generator))
            self.spherical = nn.Parameter(
                xavier_uniform((O, I, R, 2 * B, 2), generator))

    def _phase(self, x):
        if self.ftype == 1:
            return self.phase
        return torch.zeros(self.phase_shape, dtype=x.dtype, device=x.device)

    def forward(self, x, table: EdgeTable, banded=None):
        phase = self._phase(x)
        if self.graph is not None:
            g = band_ops.rotated_source_tensor_kmajor(x, self.band_limit)
            return halo_field_conv(g, banded, self.zonal, self.spherical,
                                   phase, self.ftype, self.graph)
        if banded is not None:
            return band_ops.field_conv_banded(
                x, banded, self.zonal, self.spherical, phase, self.ftype)
        return fc_ops.field_conv(x, table, self.zonal, self.spherical, phase,
                                 self.ftype, d_chunk=self.d_chunk)


class TransField(nn.Module):
    """Learned gradient lift.  A CompressedBandedTable, PanelTable or
    CompactPanelTable ``comp`` runs the aggregation over its layout.  With
    ``graph`` (graph-parallel), ``comp`` must be the CompressedBandedTable
    shard of x's rows, windowed with the ring neighbours' halo rows."""

    def __init__(self, in_channels: int, out_channels: int, n_rings: int = 6,
                 ftype: int = 1, d_chunk: int = 128,
                 generator: Optional[torch.Generator] = None,
                 graph: Optional[Axis] = None):
        super().__init__()
        O, I, R = out_channels, in_channels, n_rings
        self.ftype, self.d_chunk, self.graph = ftype, d_chunk, graph
        self.zonalAng = nn.Parameter(xavier_uniform((O, I, R), generator))
        self.zonalMag = nn.Parameter(xavier_uniform((O, I, R), generator))
        if ftype == 1:
            self.phase = nn.Parameter(xavier_uniform((O, I), generator))
        self.phase_shape = (O, I)

    def forward(self, x, table: EdgeTable, lift_cols: Tuple[int, int],
                comp=None):
        phase = (self.phase if self.ftype == 1 else
                 torch.zeros(self.phase_shape, dtype=x.dtype, device=x.device))
        halo = None
        if self.graph is not None:
            _banded_shard("TransField", comp)
            halo = exchange_halos(x, comp.nh * comp.tb, self.graph)
        return tf_ops.trans_field(
            x, table, self.zonalAng, self.zonalMag, phase, self.ftype,
            lift_cols=lift_cols, d_chunk=self.d_chunk, comp=comp, halo=halo)


class TangentLin(nn.Module):
    """Bias-free complex linear layer."""

    def __init__(self, in_channels: int, out_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        shape = (out_channels, in_channels)
        self.Re = nn.Parameter(xavier_uniform(shape, generator))
        # imaginary part initialised an order of magnitude smaller
        self.Im = nn.Parameter(xavier_uniform(shape, generator, gain=0.1))

    def forward(self, x):
        return tangent_ops.tangent_lin(x, self.Re, self.Im)


class TangentNonLin(nn.Module):
    """modReLU on the radial component.

    param_width: store a wider bias than the applied channel count (the
    reference's ECHOBlock sizes the bias by its in_channels but applies the
    first n_des entries), so reference state_dicts port 1:1.
    """

    def __init__(self, in_channels: int, param_width: Optional[int] = None):
        super().__init__()
        width = param_width or in_channels
        if width < in_channels:
            raise ValueError(
                f"param_width {width} < applied channels {in_channels}")
        self.in_channels = in_channels
        self.bias = nn.Parameter(torch.zeros(width))

    def forward(self, x):
        return co.modrelu(x, self.bias[: self.in_channels])


class LiftBlock(nn.Module):
    """TransField + modReLU."""

    def __init__(self, in_channels: int, out_channels: int, n_rings: int = 6,
                 ftype: int = 1, d_chunk: int = 128,
                 generator: Optional[torch.Generator] = None,
                 graph: Optional[Axis] = None):
        super().__init__()
        self.field = TransField(in_channels, out_channels, n_rings, ftype,
                                d_chunk, generator=generator, graph=graph)
        self.nonlin = TangentNonLin(out_channels)

    def forward(self, x, table: EdgeTable, lift_cols: Tuple[int, int],
                comp=None):
        return self.nonlin(self.field(x, table, lift_cols, comp))


class TangentPerceptron(nn.Module):
    """TangentLin + modReLU."""

    def __init__(self, in_channels: int, out_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin = TangentLin(in_channels, out_channels, generator=generator)
        self.nonlin = TangentNonLin(out_channels)

    def forward(self, x):
        return self.nonlin(self.lin(x))


class Linear(nn.Module):
    """Dense layer with torch.nn.Linear's default init (weight (out, in),
    bias (out,))."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(
            torch_linear_weight((out_features, in_features), generator))
        self.bias = nn.Parameter(
            torch_linear_bias((out_features,), in_features, generator))

    def forward(self, x):
        return x @ self.weight.T + self.bias


class ECHO(nn.Module):
    """ECHO descriptor op; parameter-free.

    Routing, as in the JAX package: a compressed PanelTable ``comp`` runs
    the panel route through K2, a CompactPanelTable the compact route
    through K7 (ops/echo_panel.py).  A CompressedBandedTable with impl
    "auto", or impl "banded", takes the gather-free banded ECHO
    (ops/echo.py::echo_banded).  Otherwise the one-hot gather route over the
    EdgeTable runs.  With ``graph`` (graph-parallel) ``comp`` must be the
    CompressedBandedTable shard of x's rows: the banded ECHO over them and
    the ring neighbours' halo rows.
    """

    def __init__(self, n_bins: int = 2, d_chunk: int = 128,
                 impl: str = "auto", graph: Optional[Axis] = None):
        super().__init__()
        self.n_bins, self.d_chunk, self.impl = n_bins, d_chunk, impl
        self.graph = graph

    def forward(self, x, table: EdgeTable, comp=None):
        if self.graph is not None:
            _banded_shard("ECHO", comp)
            lead, (N, C) = x.shape[:-3], x.shape[-3:-1]
            halo = exchange_halos(x.reshape(*lead, N, 2 * C),
                                  comp.nh * comp.tb, self.graph)
            return echo_ops.echo_banded(x, comp, self.n_bins, halo=halo)
        if isinstance(comp, (PanelTable, CompactPanelTable)):
            return echo_panel_fused(x, comp, self.n_bins)
        use_banded = (comp is not None) if self.impl == "auto" \
            else self.impl == "banded"
        if use_banded and comp is not None:
            return echo_ops.echo_banded(x, comp, self.n_bins)
        return echo_ops.echo(x, table, self.n_bins, d_chunk=self.d_chunk)


class ECHOBlock(nn.Module):
    """FieldConv → modReLU → ECHO → MLP + residual.

    The reference sizes the modReLU bias by in_channels but applies it to
    the n_des-channel conv output; ``param_width`` keeps that width so its
    weights port."""

    def __init__(self, in_channels: int, out_channels: int,
                 n_des: Optional[int] = None, n_bins: int = 3,
                 band_limit: int = 1, n_rings: int = 6, ftype: int = 1,
                 d_chunk: int = 128, echo_impl: str = "auto",
                 generator: Optional[torch.Generator] = None,
                 graph: Optional[Axis] = None):
        super().__init__()
        n_des = in_channels if n_des is None else n_des
        self.conv = FieldConv(in_channels, n_des, band_limit, n_rings, ftype,
                              d_chunk, generator=generator, graph=graph)
        self.nonlin = TangentNonLin(n_des, param_width=in_channels)
        self.echo = ECHO(n_bins, d_chunk=d_chunk, impl=echo_impl,
                         graph=graph)
        mid = n_des * echo_ops.hist_dim(n_bins)
        self.lin1 = Linear(mid, 128, generator=generator)
        self.lin2 = Linear(128, 64, generator=generator)
        self.lin3 = Linear(64, out_channels, generator=generator)
        self.res = Linear(in_channels, out_channels, generator=generator)

    def forward(self, x, table: EdgeTable, banded=None, comp=None):
        h = self.nonlin(self.conv(x, table, banded))
        h = self.echo(h, table, comp)                      # (..., N, n_des, dS)
        h = h.reshape(*h.shape[:-2], -1)
        h = torch.relu(self.lin1(h))
        h = torch.relu(self.lin2(h))
        h = self.lin3(h)
        return h + self.res(co.soft_abs(x))


class FCResNetBlock(nn.Module):
    """Two field convolutions + residual."""

    def __init__(self, in_channels: int, out_channels: int,
                 band_limit: int = 1, n_rings: int = 6, ftype: int = 1,
                 frontload: bool = False, d_chunk: int = 128,
                 generator: Optional[torch.Generator] = None,
                 graph: Optional[Axis] = None):
        super().__init__()
        iC1, oC2 = in_channels, out_channels
        oC1 = iC2 = in_channels if frontload else out_channels
        kw = dict(band_limit=band_limit, n_rings=n_rings, ftype=ftype,
                  d_chunk=d_chunk, generator=generator, graph=graph)
        self.conv1 = FieldConv(iC1, oC1, **kw)
        self.nonlin1 = TangentNonLin(oC1)
        self.conv2 = FieldConv(iC2, oC2, **kw)
        self.res = TangentLin(iC1, oC2, generator=generator)
        self.nonlin2 = TangentNonLin(oC2)

    def forward(self, x, table: EdgeTable, banded=None):
        h = self.nonlin1(self.conv1(x, table, banded))
        h = self.conv2(h, table, banded)
        return self.nonlin2(self.res(x) + h)
