"""Banded stencil tables — the gather-free layouts of the kernels.

Counterpart of the dense-band, block-sparse and panel subset of
``fieldconv_tpu/precomp/banded.py``.
Vertices are re-indexed with reverse Cuthill-McKee so every edge satisfies
|src − tgt| ≤ bandwidth; the factored stencil is then stored in dense
per-target band slots, block-major:

  sten_band: (nb, R+2K, TB, W'), W' = (2nh+1)·TB.  Slot w' of target n holds
  the edge from source s = (n_block − nh)·TB + w'.  Planes 0..R-1 are the
  radial weights, plane R+2k+p is fwxp_k's re (p=0) / im (p=1).

The BlockSparseTable keeps the same planes for an explicit list of NJ
source blocks per target block instead of the ±nh window.
The panel-CSR PanelTable stores only the nonempty (target-block,
source-block) pairs of the same slot layout, as (planes, TB, TB) panels;
the mixed route of the ECHO presets runs ECHO and the lift over it, and
the pure-panel layout of large meshes (vertices in :func:`kd_order`) runs
every op over it.  The CompactPanelTable packs each target block's
distinct sources into dense TS-wide columns instead; the compact route
runs ECHO and the lift (and, with conv_impl="compact", the convs) over it.

The builders run in numpy and return CPU tensors; stacked batches carry a
leading mesh axis on ``sten_band``, and one PanelTable (or
CompactPanelTable) covers a batch (:func:`concat_panel_tables`,
:func:`concat_compact_panel_tables`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from .edge_table import EdgeTable
from .tiled import spatial_tiles

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


def kd_order(points: np.ndarray, tb: int = 128) -> np.ndarray:
    """Vertex ordering by k-d tree leaves of <= tb points (median splits,
    depth-first).  For the panel layout this beats RCM: a TB-row block is a
    compact surface patch, so its ε-ball sources span few other patches.

    Returns perm (old indices in new order); apply with
    `reorder_precompute`."""
    return np.concatenate(spatial_tiles(np.asarray(points, float), tb))


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


@dataclasses.dataclass
class BlockSparseTable:
    """Block-SPARSE band: per target block an explicit list of source
    blocks instead of the contiguous ±nh window, so the stencil holds
    N·(R+2K)·NJ·TB floats with NJ the most source blocks a target block
    touches (constant in N on a surface mesh in kd_order, where the dense
    window grows with the bandwidth).

      sten_band: (..., nb, R+2K, TB, NJ·TB) float32, BandedTable's planes;
        slot j·TB + s of target t holds the edge from source row
        nbr[b, j]·TB + s.
      nbr: (..., nb, NJ) int32 source block of each panel; a padding entry
        points at block b itself and carries all-zero planes.
      inv_ptr, inv_bj: the port's inverse of nbr for the backward, a CSR
        over the meshes' source blocks: the panels that read source block
        s of mesh m are inv_bj[inv_ptr[m·nb + s] : inv_ptr[m·nb + s + 1]],
        each as b·NJ + j, in ascending order; padding entries left out
        (:func:`block_sparse_inverse`).

    Leading mesh axes are joined by :func:`stack_block_sparse_tables`.
    """

    sten_band: torch.Tensor
    nbr: torch.Tensor
    inv_ptr: torch.Tensor
    inv_bj: torch.Tensor
    tb: int
    n_pad: int
    band_limit: int
    n_rings: int

    @property
    def nj(self) -> int:
        return self.nbr.shape[-1]

    @property
    def k_width(self) -> int:
        return 2 * self.band_limit + 1

    def to(self, device) -> "BlockSparseTable":
        return dataclasses.replace(
            self, sten_band=self.sten_band.to(device),
            nbr=self.nbr.to(device), inv_ptr=self.inv_ptr.to(device),
            inv_bj=self.inv_bj.to(device))


def block_sparse_inverse(nbr: np.ndarray, live=None):
    """(inv_ptr, inv_bj) of BlockSparseTable for nbr (n_mesh, nb, NJ): the
    live entries (b, j) of each mesh's source blocks, as b·NJ + j in
    ascending order, a CSR over the n_mesh·nb source blocks.  live: a
    boolean mask of nbr's shape (None: every entry)."""
    nbr = np.asarray(nbr).reshape(-1, *np.shape(nbr)[-2:])
    n_mesh, nb, NJ = nbr.shape
    live = np.ones(nbr.shape, bool) if live is None \
        else np.asarray(live).reshape(nbr.shape)
    m, b, j = np.nonzero(live)                       # ascending (m, b, j)
    key = m.astype(np.int64) * nb + nbr[m, b, j]
    order = np.argsort(key, kind="stable")
    ptr = np.zeros(n_mesh * nb + 1, np.int64)
    np.cumsum(np.bincount(key, minlength=n_mesh * nb), out=ptr[1:])
    bj = (b * NJ + j)[order]
    return (torch.from_numpy(ptr.astype(np.int32)),
            torch.from_numpy(bj.astype(np.int32)))


def build_block_sparse_banded(table: EdgeTable, tb: int = 128,
                              nj_max: int | None = None) -> BlockSparseTable:
    """Build the block-sparse band of one mesh from its padded-CSR
    EdgeTable (vertex order block-local: rcm_order or kd_order); numpy,
    returns CPU tensors.  NJ is the most distinct source blocks any target
    block touches; each block's list is sorted, padding at its end.
    sten_band and nbr equal the JAX builder's bit for bit; the packed
    layout is written directly (no (R, N, W') intermediates: 14.4 GB at
    163,842 vertices)."""
    src = table.src.numpy()
    mask = table.mask.numpy() > 0
    rsten = table.rsten.numpy()
    fwxp = table.fwxp.numpy()
    N = src.shape[0]
    R, K = table.n_rings, table.k_width
    if N % tb:
        raise ValueError(f"n_pad={N} not a multiple of tb={tb}")
    nb = N // tb

    tgt_idx, slot_idx = np.nonzero(mask)
    s = src[tgt_idx, slot_idx]
    tblk = tgt_idx // tb
    sblk = s // tb

    # per target block: sorted unique source blocks
    pair = np.unique(tblk * np.int64(nb) + sblk)
    pb, ps = pair // nb, pair % nb
    counts = np.bincount(pb, minlength=nb)
    NJ = int(counts.max(initial=1))
    if nj_max is not None and NJ > nj_max:
        raise ValueError(f"block-sparse NJ={NJ} exceeds nj_max={nj_max}")
    nbr = np.tile(np.arange(nb, dtype=np.int32)[:, None], (1, NJ))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    nbr[pb, np.arange(len(pair)) - starts[pb]] = ps

    # panel of each edge: its source block's place in nbr[tblk]
    j = np.searchsorted(pair, tblk * np.int64(nb) + sblk) - starts[tblk]
    wp = j * tb + (s % tb)
    Wp = NJ * tb
    flat = tgt_idx * np.int64(Wp) + wp
    if len(np.unique(flat)) != len(flat):
        raise ValueError(
            "parallel edges cannot be represented in the band layout")

    sten = np.zeros((nb, R + 2 * K, tb, Wp), dtype=np.float32)
    tloc = tgt_idx % tb
    sten[tblk, :R, tloc, wp] = rsten[tgt_idx, slot_idx]
    sten[tblk, R:, tloc, wp] = fwxp[tgt_idx, slot_idx].reshape(-1, 2 * K)
    inv_ptr, inv_bj = block_sparse_inverse(
        nbr, np.arange(NJ)[None, :] < counts[:, None])
    return BlockSparseTable(
        sten_band=torch.from_numpy(sten), nbr=torch.from_numpy(nbr),
        inv_ptr=inv_ptr, inv_bj=inv_bj, tb=tb, n_pad=N,
        band_limit=table.band_limit, n_rings=table.n_rings)


def stack_block_sparse_tables(tables) -> BlockSparseTable:
    """One table for a batch of meshes' BlockSparseTables along a leading
    mesh axis (same tb, n_pad, NJ and stencil layout; NJ is not padded, as
    jnp.stack would not pad it); the inverse indices join with mesh m's
    runs after those before it.  A single table comes back as a view with
    the mesh axis added (no copy of its stencil, 14.4 GB at 163,842
    vertices)."""
    t0 = tables[0]
    if len(tables) == 1 and t0.nbr.dim() == 2:
        return dataclasses.replace(t0, sten_band=t0.sten_band[None],
                                   nbr=t0.nbr[None])
    for t in tables:
        if (t.tb, t.n_pad, t.nj, t.band_limit, t.n_rings) != \
                (t0.tb, t0.n_pad, t0.nj, t0.band_limit, t0.n_rings) \
                or t.nbr.dim() != 2:
            raise ValueError(
                "block-sparse tables of one batch must share tb, n_pad, NJ, "
                f"band_limit and n_rings; got NJ {[u.nj for u in tables]}")
    ptrs, live0 = [t0.inv_ptr[:1]], 0
    for t in tables:
        ptrs.append(t.inv_ptr[1:] + live0)
        live0 += t.inv_bj.shape[0]
    return dataclasses.replace(
        t0, sten_band=torch.stack([t.sten_band for t in tables]),
        nbr=torch.stack([t.nbr for t in tables]),
        inv_ptr=torch.cat(ptrs), inv_bj=torch.cat([t.inv_bj for t in tables]))


@dataclasses.dataclass
class PanelTable:
    """Panel-CSR band: a flat list of (target-block, source-block) PANELS.

    Each nonempty (tgt-block, src-block) pair is one (planes, TB, TB) panel;
    panels are sorted by target block, so each target block owns one
    contiguous run of them.

      sten: (P, planes, TB, TB) float32 (or bfloat16, cast_panel_sten)
        with planes = R+2K (dense: radial weights then fwxp_k re/im) or 5
        (compressed: r, e^{iθ} re/im, wxp re/im, with R_SENTINEL in r and
        0 in wxp at empty slots).
      meta: (4, P) int32 rows (tgt, src, first_t, last_t), sorted by
        (tgt, src).
      meta_s: (4, P_s) int32 rows (pid, tgt, src, first_s + 2·last_s), the
        same panels sorted by (src, tgt): the by-source order of the
        backward.

    A batch of meshes is one table (:func:`concat_panel_tables`): mesh m's
    block ids are offset by m·nb, so block b of the table covers rows
    b·TB .. (b+1)·TB of the meshes' features flattened to (n_mesh·n_pad,
    ...).  Every block owns >= 1 panel as target and as source (a missing
    block gets a zero self-panel).
    """

    sten: torch.Tensor
    meta: torch.Tensor
    meta_s: torch.Tensor
    tb: int
    n_pad: int
    band_limit: int
    n_rings: int
    compressed: bool = False
    chunk: int = 1
    n_mesh: int = 1

    @property
    def n_panels(self) -> int:
        return self.meta.shape[1]

    @property
    def k_width(self) -> int:
        return 2 * self.band_limit + 1

    def to(self, device) -> "PanelTable":
        return dataclasses.replace(self, sten=self.sten.to(device),
                                   meta=self.meta.to(device),
                                   meta_s=self.meta_s.to(device))


def _pad_groups(keys: np.ndarray, chunk: int):
    """Positions for padding sorted group runs to multiples of `chunk`.

    keys: (P,) sorted group labels.  Returns (new_P, new_pos (P,), pad_pos,
    pad_key) — old item p moves to new_pos[p]; pad slots (with their group
    label) fill the remainder of each group."""
    uniq, counts = np.unique(keys, return_counts=True)
    padded = -(-counts // chunk) * chunk
    starts = np.concatenate([[0], np.cumsum(padded)[:-1]])
    first_pos = np.concatenate([[0], np.cumsum(counts)[:-1]])
    off = np.arange(len(keys)) - np.repeat(first_pos, counts)
    new_pos = np.repeat(starts, counts) + off
    new_P = int(padded.sum())
    mask = np.zeros(new_P, bool)
    mask[new_pos] = True
    pad_pos = np.nonzero(~mask)[0]
    bounds = np.concatenate([starts, [new_P]])
    pad_key = uniq[np.searchsorted(bounds[1:], pad_pos, side="right")]
    return new_P, new_pos, pad_pos, pad_key


def build_panel_table(table: EdgeTable, tb: int = 128,
                      compressed: bool = False,
                      chunk: int = 1) -> PanelTable:
    """Build the panel-CSR band of one mesh from its padded-CSR EdgeTable
    (numpy; returns CPU tensors).

    chunk > 1 pads every target group (and the by-source groups) to a
    multiple of `chunk` with zero panels."""
    src = table.src.numpy()
    mask = table.mask.numpy() > 0
    N, D = src.shape
    R, K = table.n_rings, table.k_width
    if N % tb:
        raise ValueError(f"n_pad={N} not a multiple of tb={tb}")
    nb = N // tb

    tgt_idx, slot_idx = np.nonzero(mask)
    s = src[tgt_idx, slot_idx]
    key = (tgt_idx // tb) * np.int64(nb) + s // tb
    ukeys = np.unique(key)
    # a panel per block as TARGET and as SOURCE (zero self-panel): a block
    # absent as target would never write its output rows
    miss_t = np.setdiff1d(np.arange(nb), np.unique(ukeys // nb))
    miss_s = np.setdiff1d(np.arange(nb), np.unique(ukeys % nb))
    missing = np.union1d(miss_t, miss_s)
    if len(missing):
        ukeys = np.unique(np.concatenate(
            [ukeys, missing * np.int64(nb) + missing]))
    P0 = len(ukeys)
    tgt0 = (ukeys // nb).astype(np.int32)
    src0 = (ukeys % nb).astype(np.int32)

    if chunk > 1:
        P, new_pos, pad_pos, pad_tgt = _pad_groups(tgt0, chunk)
        pan_tgt = np.empty(P, np.int32)
        pan_src = np.empty(P, np.int32)
        pan_tgt[new_pos], pan_src[new_pos] = tgt0, src0
        pan_tgt[pad_pos] = pad_tgt
        pan_src[pad_pos] = pad_tgt          # self-block: valid source rows
        real = np.zeros(P, bool)
        real[new_pos] = True
        # the by-source view needs >= 1 zero panel for its own pads: when
        # no target group needed padding, append an all-zero chunk group
        src_counts = np.unique(src0, return_counts=True)[1]
        if not len(pad_pos) and (src_counts % chunk).any():
            extra = pan_tgt[-1]
            pan_tgt = np.concatenate(
                [pan_tgt, np.full(chunk, extra, np.int32)])
            pan_src = np.concatenate(
                [pan_src, np.full(chunk, extra, np.int32)])
            real = np.concatenate([real, np.zeros(chunk, bool)])
            pad_pos = np.arange(P, P + chunk)
            P += chunk
    else:
        P, pan_tgt, pan_src = P0, tgt0, src0
        new_pos = np.arange(P0)
        pad_pos = np.zeros(0, np.int64)
        real = np.ones(P, bool)

    first = np.ones(P, np.int32)
    first[1:] = (pan_tgt[1:] != pan_tgt[:-1]).astype(np.int32)
    last = np.ones(P, np.int32)
    last[:-1] = (pan_tgt[:-1] != pan_tgt[1:]).astype(np.int32)
    meta = np.stack([pan_tgt, pan_src, first, last], axis=0)

    # by-source view over the real panels; chunked pads point at a zero
    # panel of the target-side padding
    real_idx = np.nonzero(real)[0].astype(np.int32)
    r_tgt, r_src = pan_tgt[real_idx], pan_src[real_idx]
    order = np.lexsort((r_tgt, r_src))
    s_pid = real_idx[order]
    s_tgt = r_tgt[order]
    s_src = r_src[order]
    if chunk > 1:
        Ps, s_new_pos, s_pad_pos, s_pad_src = _pad_groups(s_src, chunk)
        if len(s_pad_pos) and not len(pad_pos):
            raise AssertionError("src pads need a zero panel to reference")
        pid_a = np.empty(Ps, np.int32)
        tgt_a = np.empty(Ps, np.int32)
        src_a = np.empty(Ps, np.int32)
        pid_a[s_new_pos], tgt_a[s_new_pos], src_a[s_new_pos] = \
            s_pid, s_tgt, s_src
        if len(s_pad_pos):
            pid_a[s_pad_pos] = pad_pos[0]
            tgt_a[s_pad_pos] = 0
            src_a[s_pad_pos] = s_pad_src
    else:
        Ps, pid_a, tgt_a, src_a = P0, s_pid, s_tgt, s_src
    first_s = np.ones(Ps, np.int32)
    first_s[1:] = (src_a[1:] != src_a[:-1]).astype(np.int32)
    last_s = np.ones(Ps, np.int32)
    last_s[:-1] = (src_a[:-1] != src_a[1:]).astype(np.int32)
    meta_s = np.stack([pid_a, tgt_a, src_a, first_s + 2 * last_s], axis=0)

    pid = new_pos[np.searchsorted(ukeys, key)]
    t_loc = tgt_idx % tb
    s_loc = s % tb
    flat = pid * np.int64(tb * tb) + t_loc * tb + s_loc
    if len(np.unique(flat)) != len(flat):
        raise ValueError(
            "parallel edges cannot be represented in the band layout")

    if compressed:
        ln = table.ln.numpy().astype(np.float64)
        wxp = table.wxp.numpy()
        lv = ln[tgt_idx, slot_idx]                       # (E, 2)
        rv = np.hypot(lv[:, 0], lv[:, 1])
        with np.errstate(invalid="ignore"):
            ph = lv / np.maximum(rv, 1e-30)[:, None]
        ph[rv < 1e-30] = [1.0, 0.0]                      # θ=0 at r=0 edges
        sten = np.zeros((P, 5, tb, tb), dtype=np.float32)
        sten[:, 0] = R_SENTINEL
        sten[pid, 0, t_loc, s_loc] = rv
        sten[pid, 1, t_loc, s_loc] = ph[:, 0]
        sten[pid, 2, t_loc, s_loc] = ph[:, 1]
        sten[pid, 3, t_loc, s_loc] = wxp[tgt_idx, slot_idx, 0]
        sten[pid, 4, t_loc, s_loc] = wxp[tgt_idx, slot_idx, 1]
    else:
        rsten = table.rsten.numpy()
        fwxp = table.fwxp.numpy()
        vals = np.concatenate(
            [rsten[tgt_idx, slot_idx],
             fwxp[tgt_idx, slot_idx].reshape(len(tgt_idx), 2 * K)], axis=1)
        sten = np.zeros((P, R + 2 * K, tb, tb), dtype=np.float32)
        sten[pid, :, t_loc, s_loc] = vals

    return PanelTable(
        sten=torch.from_numpy(sten), meta=torch.from_numpy(meta),
        meta_s=torch.from_numpy(meta_s),
        tb=tb, n_pad=N, band_limit=table.band_limit, n_rings=table.n_rings,
        compressed=compressed, chunk=chunk,
    )


def concat_panel_tables(panels) -> PanelTable:
    """One table for a batch of meshes' PanelTables (same tb, n_pad and
    stencil layout): mesh m's block ids are offset by m·nb and its panel
    ids (meta_s row 0) by the panels before it.  Both orders stay sorted,
    so each target block keeps one contiguous run of panels.  A single
    table comes back as it is (no copy of its stencil, 5.5 GB at 163k
    vertices)."""
    p0 = panels[0]
    if len(panels) == 1 and p0.n_mesh == 1:
        return p0
    for p in panels[1:]:
        if (p.tb, p.n_pad, p.compressed, p.chunk, p.n_mesh) != \
                (p0.tb, p0.n_pad, p0.compressed, p0.chunk, 1):
            raise ValueError("panel tables of one batch must share tb, "
                             "n_pad, compressed and chunk")
    nb = p0.n_pad // p0.tb
    metas, metas_s, pid0 = [], [], 0
    for m, p in enumerate(panels):
        meta = p.meta.clone()
        meta[:2] += m * nb
        meta_s = p.meta_s.clone()
        meta_s[0] += pid0
        meta_s[1:3] += m * nb
        metas.append(meta)
        metas_s.append(meta_s)
        pid0 += p.n_panels
    return dataclasses.replace(
        p0, sten=torch.cat([p.sten for p in panels]),
        meta=torch.cat(metas, dim=1), meta_s=torch.cat(metas_s, dim=1),
        n_mesh=len(panels))


def cast_panel_sten(panel, dtype=torch.bfloat16):
    """The table with its panel stencil stored at a narrower dtype (default
    bfloat16; the JAX package's ``cast_panel_sten``): half the stencil
    bytes that K5, K6, K2 and K7 stream and hold (each reads its planes
    back to f32, ops/band_conv.py::_panel_pairs, ops/echo_panel.py::
    _panel_tensors; the kernels through csrc/sten_load.cuh).  Takes a
    PanelTable (compressed or dense) or a CompactPanelTable and casts only
    ``sten``; ``to``, ``concat_panel_tables`` and
    ``concat_compact_panel_tables`` keep the dtype."""
    return dataclasses.replace(panel, sten=panel.sten.to(dtype))


@dataclasses.dataclass
class CompactPanelTable:
    """Compacted panel-CSR: dense TS-wide panels of gathered sources.

    Each target block's DISTINCT source vertices are compacted into
    consecutive columns (padded to a multiple of ``ts`` with dead columns),
    so a panel holds many more occupied slots than a (TB, TB) block panel;
    column j of panel p reads the source row ``src_idx[p, j]``.

      sten: (P, 5, TB, TS) compressed planes (r, e^{iθ} re/im, wxp re/im),
        R_SENTINEL in the r plane at empty slots (PanelTable's compressed
        format), float32 or bfloat16 (cast_panel_sten).
      meta: (4, P) int32 rows (tgt_block, panel_id, first_t, last_t),
        panels sorted by target block; every block owns >= 1 panel.
      src_idx: (P, TS) int32 source row per column; dead columns point at
        the mesh's vertex 0 (their planes are empty, so they add nothing).
      fold_order: (L,) int32 flat columns p·TS + s of the L live columns
        (those holding an occupied slot), stably sorted by source row: the
        inverse of src_idx, with which a backward folds per-column
        gradients onto vertices without atomics (ops/compact_fold.py);
      fold_ptr: (rows + 1,) int32, row v's run fold_order[fold_ptr[v]:
        fold_ptr[v + 1]] (rows = n_mesh·n_pad).

    A batch of meshes is one table (:func:`concat_compact_panel_tables`):
    mesh m's target blocks are offset by m·nb and its source rows by
    m·n_pad, so they index the meshes' features flattened to (n_mesh·n_pad,
    ...).
    """

    sten: torch.Tensor
    meta: torch.Tensor
    src_idx: torch.Tensor
    fold_order: torch.Tensor
    fold_ptr: torch.Tensor
    tb: int
    n_pad: int
    band_limit: int
    n_rings: int
    compressed: bool = True
    ts: int = 128
    n_mesh: int = 1

    @property
    def n_panels(self) -> int:
        return self.meta.shape[1]

    @property
    def k_width(self) -> int:
        return 2 * self.band_limit + 1

    def to(self, device) -> "CompactPanelTable":
        return dataclasses.replace(self, sten=self.sten.to(device),
                                   meta=self.meta.to(device),
                                   src_idx=self.src_idx.to(device),
                                   fold_order=self.fold_order.to(device),
                                   fold_ptr=self.fold_ptr.to(device))


def fold_index(live_cols: np.ndarray, live_src: np.ndarray, rows: int):
    """(fold_order, fold_ptr) of a compact table whose live columns, in
    ascending flat order, are ``live_cols`` reading source rows
    ``live_src``: the columns stably sorted by source row, and each of the
    ``rows`` rows' run in that order."""
    by_src = np.argsort(live_src, kind="stable")
    ptr = np.zeros(rows + 1, np.int64)
    np.cumsum(np.bincount(live_src, minlength=rows), out=ptr[1:])
    return (torch.from_numpy(live_cols[by_src].astype(np.int32)),
            torch.from_numpy(ptr.astype(np.int32)))


def build_compact_panel_table(table: EdgeTable, tb: int = 128,
                              ts: int = 128) -> CompactPanelTable:
    """Build the compacted panel-CSR table of one mesh from its padded-CSR
    EdgeTable (vertex order block-local, e.g. kd_order; numpy, returns CPU
    tensors).  Compressed planes only."""
    src = table.src.numpy()
    mask = table.mask.numpy() > 0
    N, D = src.shape
    if N % tb:
        raise ValueError(f"n_pad={N} not a multiple of tb={tb}")
    nb = N // tb

    tgt_idx, slot_idx = np.nonzero(mask)
    s = src[tgt_idx, slot_idx]
    blk = tgt_idx // tb
    order = np.lexsort((s, blk))
    tgt_o, slot_o, s_o, blk_o = (tgt_idx[order], slot_idx[order], s[order],
                                 blk[order])

    # distinct (block, source) pairs -> one compact column each
    key = blk_o.astype(np.int64) * N + s_o
    uk, inv_k = np.unique(key, return_inverse=True)
    ub = (uk // N).astype(np.int64)
    us = (uk % N).astype(np.int32)
    counts = np.bincount(ub, minlength=nb)           # distinct srcs / block
    padded = np.maximum(-(-counts // ts) * ts, ts)   # >= 1 panel per block
    col_start = np.concatenate([[0], np.cumsum(padded)[:-1]])
    first_of = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(uk)) - first_of[ub]         # rank within block
    gcol = col_start[ub] + rank                      # global column slot
    total_cols = int(padded.sum())
    P = total_cols // ts

    pan_tgt = np.repeat(np.arange(nb, dtype=np.int32), padded // ts)
    first = np.ones(P, np.int32)
    first[1:] = (pan_tgt[1:] != pan_tgt[:-1]).astype(np.int32)
    last = np.ones(P, np.int32)
    last[:-1] = (pan_tgt[:-1] != pan_tgt[1:]).astype(np.int32)
    meta = np.stack([pan_tgt, np.arange(P, dtype=np.int32), first, last],
                    axis=0)

    src_cols = np.zeros(total_cols, np.int32)        # dead columns -> 0
    src_cols[gcol] = us
    src_idx = src_cols.reshape(P, ts)

    # edges -> (panel, target row, compact column)
    edge_gcol = gcol[inv_k]
    pid = edge_gcol // ts
    c_loc = (edge_gcol % ts).astype(np.int64)
    t_loc = (tgt_o % tb).astype(np.int64)
    flat = pid * np.int64(tb * ts) + t_loc * ts + c_loc
    if len(np.unique(flat)) != len(flat):
        raise ValueError(
            "parallel edges cannot be represented in the compact layout")

    ln = table.ln.numpy().astype(np.float64)
    wxp = table.wxp.numpy()
    lv = ln[tgt_o, slot_o]                           # (E, 2)
    rv = np.hypot(lv[:, 0], lv[:, 1])
    with np.errstate(invalid="ignore"):
        ph = lv / np.maximum(rv, 1e-30)[:, None]
    ph[rv < 1e-30] = [1.0, 0.0]                      # θ=0 at r=0 edges
    sten = np.zeros((P, 5, tb, ts), dtype=np.float32)
    sten[:, 0] = R_SENTINEL
    sten[pid, 0, t_loc, c_loc] = rv
    sten[pid, 1, t_loc, c_loc] = ph[:, 0]
    sten[pid, 2, t_loc, c_loc] = ph[:, 1]
    sten[pid, 3, t_loc, c_loc] = wxp[tgt_o, slot_o, 0]
    sten[pid, 4, t_loc, c_loc] = wxp[tgt_o, slot_o, 1]

    # gcol is ascending: the distinct (block, source) pairs in key order
    fold_order, fold_ptr = fold_index(gcol, us, N)
    return CompactPanelTable(
        sten=torch.from_numpy(sten), meta=torch.from_numpy(meta),
        src_idx=torch.from_numpy(src_idx), fold_order=fold_order,
        fold_ptr=fold_ptr, tb=tb, n_pad=N,
        band_limit=table.band_limit, n_rings=table.n_rings, ts=ts)


def concat_compact_panel_tables(tables) -> CompactPanelTable:
    """One table for a batch of meshes' CompactPanelTables (same tb, ts and
    n_pad): mesh m's target blocks (meta row 0) are offset by m·nb, its
    panel ids (meta row 1) by the panels before it and its source rows
    (src_idx) by m·n_pad, its fold index's columns by the columns before it
    and its runs by the live columns before it.  A single table comes back
    as it is (no copy of its stencil)."""
    c0 = tables[0]
    if len(tables) == 1 and c0.n_mesh == 1:
        return c0
    for c in tables[1:]:
        if (c.tb, c.ts, c.n_pad, c.n_mesh) != (c0.tb, c0.ts, c0.n_pad, 1):
            raise ValueError("compact tables of one batch must share tb, ts "
                             "and n_pad")
    nb = c0.n_pad // c0.tb
    metas, idxs, orders, ptrs = [], [], [], [c0.fold_ptr[:1]]
    pid0 = live0 = 0
    for m, c in enumerate(tables):
        meta = c.meta.clone()
        meta[0] += m * nb
        meta[1] += pid0
        metas.append(meta)
        idxs.append(c.src_idx + m * c0.n_pad)
        orders.append(c.fold_order + pid0 * c0.ts)
        ptrs.append(c.fold_ptr[1:] + live0)
        pid0 += c.n_panels
        live0 += c.fold_order.shape[0]
    return dataclasses.replace(
        c0, sten=torch.cat([c.sten for c in tables]),
        meta=torch.cat(metas, dim=1), src_idx=torch.cat(idxs),
        fold_order=torch.cat(orders), fold_ptr=torch.cat(ptrs),
        n_mesh=len(tables))


def window_blocks(a: torch.Tensor, tb: int, nh: int,
                  halo=None) -> torch.Tensor:
    """Window a per-vertex tensor by block shifts: the banded-layout
    replacement for the ``x[src]`` gather.

    a: (..., N, F) with N a multiple of tb.  Returns (..., nb, W', F) with
    win[..., b, j·tb + s, :] = a[..., (b − nh + j)·tb + s, :] for j in
    0..2nh, zero where that row lies outside [0, N) (out-of-range slots
    carry zero stencil).

    halo: optional (left, right) rows (..., nh·tb, F) that take the zero
    padding's place: a graph-parallel shard's ring neighbours' boundary
    rows (parallel/halo.py::exchange_halos), zeros at the ends of the ring.
    """
    Wp = (2 * nh + 1) * tb
    if halo is None:
        ap = F.pad(a, (0, 0, nh * tb, nh * tb))      # (..., N + 2nh·tb, F)
    else:
        ap = torch.cat([halo[0], a, halo[1]], dim=-2)
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
