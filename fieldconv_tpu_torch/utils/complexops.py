"""Planar-complex helpers and gradient-safe "soft" math.

Counterpart of ``fieldconv_tpu/utils/complexops.py``.  Complex tensors are a
trailing axis of size 2 holding (real, imag) float32; no ``torch.complex64``.

The "soft" functions mask (near-)origin entries with |re| < EPS and
|im| < EPS cutoffs.  They use the double-where pattern (replace masked
inputs by a safe value before the singular op, then mask the output) so
gradients stay finite at exact zeros.
"""

from __future__ import annotations

import torch

EPS = 1e-7


# ---------------------------------------------------------------------------
# Planar complex construction / destruction
# ---------------------------------------------------------------------------

def cplx(re, im):
    """Stack real and imaginary parts into a planar complex tensor (..., 2)."""
    return torch.stack([re, im], dim=-1)


def creal(z):
    return z[..., 0]


def cimag(z):
    return z[..., 1]


# ---------------------------------------------------------------------------
# Complex arithmetic on planar pairs
# ---------------------------------------------------------------------------

def cmul(a, b):
    """(a.re + i a.im) * (b.re + i b.im), broadcasting leading dims."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return torch.stack([ar * br - ai * bi, ar * bi + ai * br], dim=-1)


def cconj(a):
    return torch.stack([a[..., 0], -a[..., 1]], dim=-1)


def cscale(a, s):
    """Multiply planar complex a by real tensor s (broadcast over last axis)."""
    return a * s[..., None]


def cabs2(a):
    return a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1]


def cpolar(r, theta):
    """r * e^{i theta} as a planar pair; r, theta real tensors."""
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def cexpi(theta):
    """e^{i theta} as a planar pair."""
    return torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)


# ---------------------------------------------------------------------------
# Soft (origin-masked) functions
# ---------------------------------------------------------------------------

def is_zero(x, eps=EPS):
    """|x| < eps elementwise on a real tensor."""
    return (x < eps) & (x > -eps)


def is_origin(z, eps=EPS):
    """Both components within eps of zero. z: (..., 2)."""
    return is_zero(z[..., 0], eps) & is_zero(z[..., 1], eps)


def soft_abs(z, eps=EPS):
    """|z| at non-origin entries, exactly 0 (with zero gradient) at origin
    entries."""
    mask = is_origin(z, eps)
    safe = torch.where(mask[..., None], torch.ones_like(z), z)
    mag = torch.sqrt(safe[..., 0] ** 2 + safe[..., 1] ** 2)
    return torch.where(mask, torch.zeros_like(mag), mag)


def soft_angle(z, eps=EPS):
    """arg(z) at non-origin entries, exactly 0 at origin entries."""
    mask = is_origin(z, eps)
    safe_re = torch.where(mask, torch.ones_like(z[..., 0]), z[..., 0])
    safe_im = torch.where(mask, torch.zeros_like(z[..., 1]), z[..., 1])
    ang = torch.atan2(safe_im, safe_re)
    return torch.where(mask, torch.zeros_like(ang), ang)


def soft_unit(z, eps=EPS):
    """z/|z| at non-origin entries, (0, 0) at origin entries, with finite
    gradients there."""
    mask = is_origin(z, eps)
    safe = torch.where(mask[..., None], torch.ones_like(z), z)
    mag = torch.sqrt(safe[..., 0] ** 2 + safe[..., 1] ** 2)
    unit = safe / mag[..., None]
    return torch.where(mask[..., None], torch.zeros_like(unit), unit)


def soft_absolute(x):
    """Elementwise |x| on a real tensor with subgradient +1 at exactly 0."""
    return torch.where(x < 0, -x, x)


def modrelu(z, bias, eps=EPS):
    """modReLU: ReLU(|z| + b) * e^{i arg z} at non-origin entries; origin
    entries pass through unchanged.

    z: (..., C, 2); bias: broadcastable to (..., C).
    """
    mask = is_origin(z, eps)
    safe = torch.where(mask[..., None], torch.ones_like(z), z)
    mag = torch.sqrt(safe[..., 0] ** 2 + safe[..., 1] ** 2)
    scale = torch.relu(mag + bias) / mag
    out = safe * scale[..., None]
    return torch.where(mask[..., None], z, out)
