"""Banded stencil tables — the gather-free layout of the field-conv kernel.

Counterpart of the dense-band subset of ``fieldconv_tpu/precomp/banded.py``.
Vertices are re-indexed with reverse Cuthill-McKee so every edge satisfies
|src − tgt| ≤ bandwidth; the factored stencil is then stored in dense
per-target band slots, block-major:

  sten_band: (nb, R+2K, TB, W'), W' = (2nh+1)·TB.  Slot w' of target n holds
  the edge from source s = (n_block − nh)·TB + w'.  Planes 0..R-1 are the
  radial weights, plane R+2k+p is fwxp_k's re (p=0) / im (p=1).

The builders run in numpy and return CPU tensors; stacked batches carry a
leading mesh axis on ``sten_band``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from .edge_table import EdgeTable

R_SENTINEL = 9.0  # kills every radial hat (support ends at the virtual knot 2)


@dataclasses.dataclass
class BandedTable:
    """Block-major packed dense band stencil.

    sten_band: (..., nb, R+2K, TB, W') float32.  Planes 0..R-1 hold the
    radial interpolation weights; plane R+2k+p holds fwxp_k's re (p=0) /
    im (p=1).
    """

    sten_band: torch.Tensor
    tb: int
    nh: int
    n_pad: int
    band_limit: int
    n_rings: int

    def to(self, device) -> "BandedTable":
        return dataclasses.replace(self, sten_band=self.sten_band.to(device))


@dataclasses.dataclass
class CompressedBandedTable:
    """Bandwidth-limited stencil in compressed form: 5 planes instead of
    R + 2K, same slot layout as BandedTable.

      sten_band: (..., nb, 5, TB, W') — planes (r, ph_re, ph_im, wxp_re,
      wxp_im); empty slots hold R_SENTINEL in the r plane and 0 in wxp.
    """

    sten_band: torch.Tensor
    tb: int
    nh: int
    n_pad: int
    band_limit: int
    n_rings: int

    def to(self, device) -> "CompressedBandedTable":
        return dataclasses.replace(self, sten_band=self.sten_band.to(device))


def pack_sten_band(rb: np.ndarray, fb: np.ndarray, tb: int) -> np.ndarray:
    """(R, N, W') + (K, 2, N, W') -> block-major (nb, R+2K, TB, W')."""
    R, N, Wp = rb.shape
    K = fb.shape[0]
    nb = N // tb
    out = np.empty((nb, R + 2 * K, tb, Wp), dtype=np.float32)
    out[:, :R] = np.moveaxis(rb.reshape(R, nb, tb, Wp), 0, 1)
    out[:, R:] = np.moveaxis(fb.reshape(K * 2, nb, tb, Wp), 0, 1)
    return out


def rcm_order(supp_edges: np.ndarray, n_vertices: int) -> np.ndarray:
    """Reverse Cuthill-McKee permutation minimising the graph bandwidth.

    Returns perm (old indices in new order); apply with
    `reorder_precompute`.
    """
    e = np.asarray(supp_edges)
    a = sp.csr_matrix(
        (np.ones(len(e)), (e[:, 0], e[:, 1])), shape=(n_vertices, n_vertices)
    )
    perm = sp.csgraph.reverse_cuthill_mckee(a + a.T, symmetric_mode=True)
    return np.asarray(perm, dtype=np.int64)


def reorder_precompute(perm: np.ndarray, supp_edges: np.ndarray,
                       *vertex_arrays):
    """Apply a vertex permutation: vertex v moves to position inv[v].

    perm: old indices in new order (as returned by rcm_order).
    Returns (new_supp_edges, *reordered_vertex_arrays).
    """
    perm = np.asarray(perm)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    new_edges = inv[np.asarray(supp_edges)]
    outs = tuple(np.asarray(a)[perm] for a in vertex_arrays)
    return (new_edges,) + outs


def _band_slots(table: EdgeTable, tb: int, max_nh: int):
    """(target, CSR slot, band slot) of every real edge, plus nh and W'."""
    src = table.src.numpy()
    mask = table.mask.numpy() > 0
    N = src.shape[0]
    if N % tb:
        raise ValueError(f"n_pad={N} not a multiple of tb={tb}")
    tgt_idx, slot_idx = np.nonzero(mask)
    s = src[tgt_idx, slot_idx]
    bw = int(np.abs(s - tgt_idx).max()) if len(s) else 0
    nh = max(1, -(-bw // tb))
    if nh > max_nh:
        raise ValueError(
            f"graph bandwidth {bw} needs nh={nh} > max_nh={max_nh}; "
            "re-order vertices (rcm_order) or raise max_nh")
    Wp = (2 * nh + 1) * tb
    wp = ((s // tb) - (tgt_idx // tb) + nh) * tb + (s % tb)
    flat = tgt_idx * np.int64(Wp) + wp
    if len(np.unique(flat)) != len(flat):
        # the factored layout stores one (rsten, fwxp) pair per
        # (target, source) slot, so parallel edges cannot be merged exactly
        raise ValueError(
            "parallel edges (duplicate (target, source) pairs) cannot be "
            "represented in the factored band layout; deduplicate the "
            "support graph first")
    return tgt_idx, slot_idx, wp, nh, Wp


def build_banded_table(table: EdgeTable, tb: int = 128,
                       max_nh: int = 4) -> BandedTable:
    """Convert a single-mesh padded-CSR EdgeTable (vertex order already
    bandwidth-minimised) into the dense band layout.

    Requires n_pad % tb == 0 and graph bandwidth ≤ max_nh·tb.
    """
    tgt_idx, slot_idx, wp, nh, Wp = _band_slots(table, tb, max_nh)
    rsten = table.rsten.numpy()
    fwxp = table.fwxp.numpy()
    N = table.n_pad
    R, K = table.n_rings, table.k_width
    rb = np.zeros((R, N, Wp), dtype=np.float32)
    fb = np.zeros((K, 2, N, Wp), dtype=np.float32)
    rb[:, tgt_idx, wp] = rsten[tgt_idx, slot_idx].T
    fb[:, :, tgt_idx, wp] = np.moveaxis(fwxp[tgt_idx, slot_idx], 0, -1)
    return BandedTable(
        sten_band=torch.from_numpy(pack_sten_band(rb, fb, tb)),
        tb=tb, nh=nh, n_pad=N,
        band_limit=table.band_limit, n_rings=table.n_rings,
    )


def build_compressed_banded(table: EdgeTable, tb: int = 128,
                            max_nh: int = 4) -> CompressedBandedTable:
    """Compressed-stencil variant of build_banded_table (same slot layout)."""
    tgt_idx, slot_idx, wp, nh, Wp = _band_slots(table, tb, max_nh)
    ln = table.ln.numpy().astype(np.float64)
    wxp = table.wxp.numpy()
    N = table.n_pad

    lv = ln[tgt_idx, slot_idx]                       # (E, 2)
    rv = np.hypot(lv[:, 0], lv[:, 1])
    with np.errstate(invalid="ignore"):
        ph = lv / np.maximum(rv, 1e-30)[:, None]
    ph[rv < 1e-30] = [1.0, 0.0]                      # θ=0 at r=0 edges

    planes = np.zeros((5, N, Wp), dtype=np.float32)
    planes[0] = R_SENTINEL
    planes[0, tgt_idx, wp] = rv
    planes[1:3, tgt_idx, wp] = ph.T
    planes[3:5, tgt_idx, wp] = wxp[tgt_idx, slot_idx].T
    nb = N // tb
    packed = np.moveaxis(planes.reshape(5, nb, tb, Wp), 0, 1)
    return CompressedBandedTable(
        sten_band=torch.from_numpy(np.ascontiguousarray(packed)),
        tb=tb, nh=nh, n_pad=N,
        band_limit=table.band_limit, n_rings=table.n_rings,
    )


def window_blocks(a: torch.Tensor, tb: int, nh: int) -> torch.Tensor:
    """Window a per-vertex tensor by block shifts: the banded-layout
    replacement for the ``x[src]`` gather.

    a: (..., N, F) with N a multiple of tb.  Returns (..., nb, W', F) with
    win[..., b, j·tb + s, :] = a[..., (b − nh + j)·tb + s, :] for j in
    0..2nh, zero where that row lies outside [0, N) (out-of-range slots
    carry zero stencil).
    """
    Wp = (2 * nh + 1) * tb
    ap = F.pad(a, (0, 0, nh * tb, nh * tb))          # (..., N + 2nh·tb, F)
    return ap.unfold(-2, Wp, tb).transpose(-1, -2)


def unwindow_blocks(win: torch.Tensor, tb: int, nh: int) -> torch.Tensor:
    """Transpose of :func:`window_blocks`: sum each window row back onto
    the vertex row it was read from.

    win: (..., nb, W', F).  Returns (..., N, F), N = nb·tb; window rows that
    lie outside [0, N) are dropped."""
    *lead, nb, Wp, F_ = win.shape
    N = nb * tb
    out = win.new_zeros(*lead, N + 2 * nh * tb, F_)
    for j in range(2 * nh + 1):
        out[..., j * tb:j * tb + N, :] += \
            win[..., j * tb:(j + 1) * tb, :].reshape(*lead, N, F_)
    return out[..., nh * tb:nh * tb + N, :]
