"""ECHO descriptors — fixed-shape masked rasterisation + scatter.

Counterpart of ``fieldconv_tpu/ops/echo.py`` (reference nn/echo.py:65-148,
"ECHO: Extended Convolution Histogram of Orientations").  Per (edge,
channel): rotate the edge's log coordinate into the frame of the feature at
the source vertex, bilinearly splat the transported feature value into 4
bins of a rasterised disk, accumulate per target vertex, and return the
magnitude of each bin.  Edges carrying (near-)zero features cast no vote.

The plain-torch route here is :func:`echo`, the separable one-hot splat
over the padded-CSR EdgeTable.  The panel route over a compressed
PanelTable runs through its kernel (K2) in ``ops/echo_panel.py``; the JAX
package's gather-free ``echo_banded`` is not ported yet.
Every function accepts optional leading mesh-batch axes on x.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..precomp.edge_table import EdgeTable
from ..utils.complexops import cconj, cmul, is_origin, soft_abs, soft_unit
from .field_conv import gather_rows, resolve_d_chunk


def disk_map(n_bins: int):
    """Compact disk rasterisation map (echo.py:11-27).

    Returns (dmap, dim): dmap is a (w*w,) int array mapping grid cell
    w*i + j to a compact bin index; cells outside the disk map to 0 (the
    reference initialises the map with zeros — votes clamped outside the
    disk land in bin 0, a quirk reproduced here).  w = 2*n_bins+1.
    """
    w = 2 * n_bins + 1
    ind = []
    for i in range(w):
        for j in range(w):
            if (i - n_bins) ** 2 + (j - n_bins) ** 2 <= (n_bins + 0.25) ** 2:
                ind.append(w * i + j)
    dmap = np.zeros(w * w, dtype=np.int32)
    dmap[np.array(ind)] = np.arange(len(ind), dtype=np.int32)
    return dmap, len(ind)


def hist_dim(n_bins: int) -> int:
    """Descriptor dimensionality ≈ π(n_bins+0.5)² (echo_block.py:10-18)."""
    return disk_map(n_bins)[1]


@functools.lru_cache(maxsize=None)
def _fold_np(n_bins: int) -> np.ndarray:
    """(w², dS) 0/1 matrix folding the w×w grid onto the disk bins."""
    w = 2 * n_bins + 1
    dmap, dS = disk_map(n_bins)
    fold = np.zeros((w * w, dS), dtype=np.float32)
    fold[np.arange(w * w), dmap] = 1.0
    return fold


def fold_matrix(n_bins: int, device) -> torch.Tensor:
    return torch.from_numpy(_fold_np(n_bins)).to(device)


def _splat(p, votes, n_bins: int):
    """Separable one-hot bilinear splat.

    p: (..., S, C, 2) scaled aligned log coordinates; votes (..., S, C, 2)
    masked transported features; S is the axis summed over.  Returns the
    w×w grid (..., C, 2, w, w) with cells (α, β) = (first, second) log-map
    axis: corners (F,F), (C,C), (C,F), (F,C) carry w0..w3."""
    nb = n_bins
    w = 2 * nb + 1
    pC = torch.clamp(torch.ceil(p), -nb, nb)
    pF = torch.clamp(torch.floor(p), -nb, nb)
    w0 = (pC[..., 0] - p[..., 0]) * (pC[..., 1] - p[..., 1])
    w1 = (p[..., 0] - pF[..., 0]) * (p[..., 1] - pF[..., 1])
    w2 = (p[..., 0] - pF[..., 0]) * (pC[..., 1] - p[..., 1])
    w3 = (pC[..., 0] - p[..., 0]) * (p[..., 1] - pF[..., 1])
    iw = torch.arange(w, device=p.device, dtype=p.dtype) - nb
    A_F = (pF[..., 0:1] == iw).to(p.dtype)             # (..., S, C, w)
    A_C = (pC[..., 0:1] == iw).to(p.dtype)
    B_F = (pF[..., 1:2] == iw).to(p.dtype)
    B_C = (pC[..., 1:2] == iw).to(p.dtype)
    BF0 = w0[..., None] * B_F + w3[..., None] * B_C
    BC1 = w2[..., None] * B_F + w1[..., None] * B_C
    # grid[c, p, a, b] = Σ_s votes[s,c,p]·(A_F[s,c,a]·BF0[s,c,b] + A_C·BC1)
    va_f = votes[..., :, None] * A_F[..., None, :]     # (..., S, C, 2, w)
    va_c = votes[..., :, None] * A_C[..., None, :]
    return (torch.einsum("...scpa,...scb->...cpab", va_f, BF0)
            + torch.einsum("...scpa,...scb->...cpab", va_c, BC1))


def echo(x, table: EdgeTable, n_bins: int, d_chunk: int = 128):
    """ECHO descriptors over the padded-CSR table (the gather route), by
    the separable one-hot splat (the JAX package's default method; its
    "masked" A/B variant is not ported).

    x: (..., N, C, 2) planar tangent features; table carries the same
    leading mesh axes.  Returns (..., N, C, dS) descriptor magnitudes."""
    N, C = x.shape[-3], x.shape[-2]
    D = table.d_slots
    w = 2 * n_bins + 1
    fold = fold_matrix(n_bins, x.device)

    unit_conj = cconj(soft_unit(x))                        # (..., N, C, 2)
    nonzero = torch.logical_not(is_origin(x))              # (..., N, C)

    d_chunk = resolve_d_chunk(D, d_chunk)
    hist = None
    for lo in range(0, D, d_chunk):
        sl = slice(lo, lo + d_chunk)
        src_c = table.src[..., sl]                          # (..., N, DB)
        xs = gather_rows(x, src_c)                          # (..., N, DB, C, 2)
        units = gather_rows(unit_conj, src_c)
        valid = gather_rows(nonzero, src_c) \
            & (table.mask[..., sl, None] > 0)               # (..., N, DB, C)
        aligned = cmul(table.ln[..., sl, None, :], units)   # (..., N, DB, C, 2)
        xw = cmul(xs, table.wxp[..., sl, None, :])
        xw = torch.where(valid[..., None], xw, torch.zeros_like(xw))
        grid = _splat(aligned * n_bins, xw, n_bins)         # (..., N, C, 2, w, w)
        part = torch.einsum("...ncpu,us->...ncsp",
                            grid.reshape(*grid.shape[:-2], w * w), fold)
        hist = part if hist is None else hist + part
    return soft_abs(hist)
