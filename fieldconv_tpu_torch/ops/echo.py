"""ECHO descriptors — fixed-shape masked rasterisation + scatter.

Counterpart of ``fieldconv_tpu/ops/echo.py`` (reference nn/echo.py:65-148,
"ECHO: Extended Convolution Histogram of Orientations").  Per (edge,
channel): rotate the edge's log coordinate into the frame of the feature at
the source vertex, bilinearly splat the transported feature value into 4
bins of a rasterised disk, accumulate per target vertex, and return the
magnitude of each bin.  Edges carrying (near-)zero features cast no vote.

The plain-torch routes here are :func:`echo`, the separable one-hot splat
over the padded-CSR EdgeTable, and :func:`echo_banded`, the same splat
over the block window of a CompressedBandedTable (no gather).  The panel
route over a compressed PanelTable runs through its kernel (K2) in
``ops/echo_panel.py``.  Every function accepts optional leading mesh-batch
axes on x.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.utils.checkpoint

from ..precomp.banded import CompressedBandedTable, window_blocks
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
    axis: corners (F,F), (C,C), (C,F), (F,C) carry w0..w3.

    The one-hot factors are written by scatter into zeros, laid out (...,
    C, S, ·) so that the two sums over S run as batched matrix products: the
    votes at cell α (2, w) and the β weights (w) of the (F, ·) and (C, ·)
    corners.  A β cell that two corners share gets both weights added onto
    0, the same float as their sum."""
    nb = n_bins
    w = 2 * nb + 1
    p, votes = p.transpose(-3, -2), votes.transpose(-3, -2)   # (..., C, S, 2)
    pC = torch.clamp(torch.ceil(p), -nb, nb)
    pF = torch.clamp(torch.floor(p), -nb, nb)
    w0 = (pC[..., 0] - p[..., 0]) * (pC[..., 1] - p[..., 1])
    w1 = (p[..., 0] - pF[..., 0]) * (p[..., 1] - pF[..., 1])
    w2 = (p[..., 0] - pF[..., 0]) * (pC[..., 1] - p[..., 1])
    w3 = (pC[..., 0] - p[..., 0]) * (p[..., 1] - pF[..., 1])
    iF, iC = (pF + nb).long(), (pC + nb).long()
    lead = p.shape[:-1]
    rows, S = int(np.prod(lead[:-1])), lead[-1]

    def at_alpha(i):                 # votes at α cell i: (rows, 2w, S)
        return votes.new_zeros(*lead, 2, w).scatter_(
            -1, i[..., None, None].expand(*lead, 2, 1), votes[..., None]) \
            .reshape(rows, S, 2 * w).transpose(1, 2)

    def beta(wF, wC):                # wF at β cell F, wC at C: (rows, S, w)
        return votes.new_zeros(*lead, w).scatter_add_(
            -1, torch.stack([iF[..., 1], iC[..., 1]], -1),
            torch.stack([wF, wC], -1)).reshape(rows, S, w)

    grid = torch.baddbmm(torch.bmm(at_alpha(iF[..., 0]), beta(w0, w3)),
                         at_alpha(iC[..., 0]), beta(w2, w1))
    return grid.reshape(*lead[:-1], 2, w, w)


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


def _blocks_hist(ln, wxp, xs, us, nz, n_bins: int, fold):
    """Histograms (cb, TB, C, dS, 2) of a chunk of target blocks over their
    windows, by :func:`_splat` with the W' window axis summed over: ln /
    wxp (cb, TB, W', 2) the slots' log map and transport weight, xs / us
    (cb, W', C, 2) the window's features and conjugated unit directions, nz
    (cb, W', C) its nonzero mask."""
    w = 2 * n_bins + 1
    aligned = cmul(ln[:, :, :, None], us[:, None])       # (cb, TB, W', C, 2)
    votes = cmul(xs[:, None], wxp[:, :, :, None])
    votes = torch.where(nz[:, None, ..., None], votes, torch.zeros_like(votes))
    grid = _splat(aligned * n_bins, votes, n_bins)        # (cb, TB, C, 2, w, w)
    return torch.einsum("ztcpu,us->ztcsp",
                        grid.reshape(*grid.shape[:-2], w * w), fold)


def echo_banded(x, comp: CompressedBandedTable, n_bins: int,
                block_chunk: int = 1, halo=None):
    """Gather-free ECHO over the banded slot layout: the same descriptors
    as :func:`echo`, with each target block's source features read from
    its ±nh block window of x (``window_blocks``) instead of a gather; the
    W' window axis takes the CSR slot axis's place in the splat, and empty
    slots carry wxp = 0, so their votes vanish.  Counterpart of the JAX
    package's ``echo_banded`` (ops/echo.py).

    x: (..., N, C, 2) with N == comp.n_pad; comp.sten_band (..., nb, 5,
    TB, W') carries the same leading mesh axes.  block_chunk: target
    blocks per step (1 if it does not divide the blocks).  Each step's
    (block_chunk, TB, W', C, w) one-hot and weight tensors are freed after
    it; under autograd the step is checkpointed and recomputed in the
    backward, so only its inputs are kept.  halo: optional (left, right)
    rows (..., nh·TB, 2C) of a graph-parallel shard's ring neighbours (x's
    rows flattened to 2C columns, parallel/halo.py::exchange_halos) in
    place of the zero padding; the unit directions and the origin mask
    are formed on the windowed rows, as in the JAX package.  Returns (...,
    N, C, dS)."""
    sten = comp.sten_band
    nb, _, TB, Wp = sten.shape[-4:]
    lead, (N, C) = x.shape[:-3], x.shape[-3:-1]
    fold = fold_matrix(n_bins, x.device)

    xs = window_blocks(x.reshape(*lead, N, 2 * C), TB, comp.nh, halo)
    xs = xs.reshape(-1, Wp, C, 2)                          # (L·nb, W', C, 2)
    us = cconj(soft_unit(xs))
    nz = torch.logical_not(is_origin(xs))
    sten = sten.reshape(-1, 5, TB, Wp)
    r = sten[:, 0]
    ln = torch.stack([r * sten[:, 1], r * sten[:, 2]], -1)  # (L·nb, TB, W', 2)
    wxp = torch.stack([sten[:, 3], sten[:, 4]], -1)

    if nb % block_chunk:
        block_chunk = 1
    remat = torch.is_grad_enabled() and x.requires_grad
    parts = []
    for lo in range(0, xs.shape[0], block_chunk):
        sl = slice(lo, lo + block_chunk)
        args = (ln[sl], wxp[sl], xs[sl], us[sl], nz[sl], n_bins, fold)
        parts.append(torch.utils.checkpoint.checkpoint(
            _blocks_hist, *args, use_reentrant=False) if remat
            else _blocks_hist(*args))
    hist = torch.cat(parts)                                # (L·nb, TB, C, dS, 2)
    return soft_abs(hist.reshape(*lead, N, C, -1, 2))
