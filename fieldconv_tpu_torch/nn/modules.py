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
from ..ops import field_conv as fc_ops
from ..ops import tangent as tangent_ops
from ..ops import trans_field as tf_ops
from ..precomp.edge_table import EdgeTable
from ..utils import complexops as co
from .init import xavier_uniform


class FieldConv(nn.Module):
    """Field convolution layer.  A BandedTable routes the contraction to
    the fused K1 kernel (ops/band_conv.py); otherwise the padded-CSR gather
    path runs."""

    def __init__(self, in_channels: int, out_channels: int,
                 band_limit: int = 1, n_rings: int = 6, ftype: int = 1,
                 d_chunk: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        O, I, R, B = out_channels, in_channels, n_rings, band_limit
        self.band_limit, self.ftype, self.d_chunk = B, ftype, d_chunk
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
        if banded is not None:
            return band_ops.field_conv_banded(
                x, banded, self.zonal, self.spherical, phase, self.ftype)
        return fc_ops.field_conv(x, table, self.zonal, self.spherical, phase,
                                 self.ftype, d_chunk=self.d_chunk)


class TransField(nn.Module):
    """Learned gradient lift.  A CompressedBandedTable ``comp`` runs the
    aggregation gather-free over the banded layout."""

    def __init__(self, in_channels: int, out_channels: int, n_rings: int = 6,
                 ftype: int = 1, d_chunk: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        O, I, R = out_channels, in_channels, n_rings
        self.ftype, self.d_chunk = ftype, d_chunk
        self.zonalAng = nn.Parameter(xavier_uniform((O, I, R), generator))
        self.zonalMag = nn.Parameter(xavier_uniform((O, I, R), generator))
        if ftype == 1:
            self.phase = nn.Parameter(xavier_uniform((O, I), generator))
        self.phase_shape = (O, I)

    def forward(self, x, table: EdgeTable, lift_cols: Tuple[int, int],
                comp=None):
        phase = (self.phase if self.ftype == 1 else
                 torch.zeros(self.phase_shape, dtype=x.dtype, device=x.device))
        return tf_ops.trans_field(
            x, table, self.zonalAng, self.zonalMag, phase, self.ftype,
            lift_cols=lift_cols, d_chunk=self.d_chunk, comp=comp)


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
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.field = TransField(in_channels, out_channels, n_rings, ftype,
                                d_chunk, generator=generator)
        self.nonlin = TangentNonLin(out_channels)

    def forward(self, x, table: EdgeTable, lift_cols: Tuple[int, int],
                comp=None):
        return self.nonlin(self.field(x, table, lift_cols, comp))


class FCResNetBlock(nn.Module):
    """Two field convolutions + residual."""

    def __init__(self, in_channels: int, out_channels: int,
                 band_limit: int = 1, n_rings: int = 6, ftype: int = 1,
                 frontload: bool = False, d_chunk: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        iC1, oC2 = in_channels, out_channels
        oC1 = iC2 = in_channels if frontload else out_channels
        kw = dict(band_limit=band_limit, n_rings=n_rings, ftype=ftype,
                  d_chunk=d_chunk, generator=generator)
        self.conv1 = FieldConv(iC1, oC1, **kw)
        self.nonlin1 = TangentNonLin(oC1)
        self.conv2 = FieldConv(iC2, oC2, **kw)
        self.res = TangentLin(iC1, oC2, generator=generator)
        self.nonlin2 = TangentNonLin(oC2)

    def forward(self, x, table: EdgeTable, banded=None):
        h = self.nonlin1(self.conv1(x, table, banded))
        h = self.conv2(h, table, banded)
        return self.nonlin2(self.res(x) + h)
