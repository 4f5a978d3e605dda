"""Tangent-feature pointwise ops: complex linear layer and modReLU.

Counterpart of ``fieldconv_tpu/ops/tangent.py``.
"""

from __future__ import annotations

import torch

from ..utils.complexops import modrelu  # noqa: F401  (re-export)
from .field_conv import cmatmul

__all__ = ["tangent_lin", "modrelu"]


def tangent_lin(x, w_re, w_im):
    """Complex linear map without bias (equivariance-preserving).

    y[n, o] = Σ_i x[n, i] · (w_re + i·w_im)[o, i]

    x: (..., N, C, 2); w_re, w_im: (O, C).  Returns (..., N, O, 2).
    """
    w = torch.stack([w_re.T, w_im.T], dim=-1)  # (C, O, 2)
    return cmatmul(x, w)
