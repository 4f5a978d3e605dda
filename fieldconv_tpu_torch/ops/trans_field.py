"""TransField — learned "gradient" lifting scalar features to tangent fields.

Counterpart of ``fieldconv_tpu/ops/trans_field.py`` (gather, dense banded,
panel and compact routes).  Two aggregations over the support edges, using two columns
of the stencil:

  contribAng[i,c,r] = -Σ_e (x[j]-x[i]) · sten1[e,r]
  contribMag[i,c,r] =  Σ_e  x[j]       · |sten0[e,r]|

then per-(out,in) zonal banks turn these into an angle and a magnitude that
are recombined as ρ·e^{iφ} and summed over input channels.  Every function
accepts optional leading mesh-batch axes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..precomp.banded import (CompactPanelTable, CompressedBandedTable,
                              PanelTable, window_blocks)
from ..precomp.edge_table import EdgeTable
from ..utils.complexops import cpolar, soft_abs, soft_absolute, soft_angle
from .band_conv import _hats_from_r
from .compact_fold import compact_fold
from .field_conv import gather_rows, resolve_d_chunk


def trans_field_contrib(x, table: EdgeTable, lift_cols=(0, 1),
                        d_chunk: int = 128):
    """Aggregate the angular (complex) and magnitude (real) contributions
    over the padded-CSR table.

    x: (..., N, C) real scalar features.
    lift_cols: indices into the K axis of fwxp selecting the two stencil
      columns ((0, 1) replicates the classification notebook's use of the
      unsliced stencil).
    Returns contribAng (..., N, C, R, 2), contribMag (..., N, C, R).
    """
    k0, k1 = lift_cols

    def chunk(src_c, rsten_c, fw0_c, fw1_c):
        xs = gather_rows(x, src_c)                          # (..., N, DB, C)
        xdiff = xs - x[..., :, None, :]                     # x_j - x_i
        sten1 = rsten_c[..., None] * fw1_c[..., None, :]    # (..., N, DB, R, 2)
        sten0 = rsten_c[..., None] * fw0_c[..., None, :]
        sten0_abs = soft_abs(sten0)                         # (..., N, DB, R)
        ang = -torch.einsum("...ndc,...ndrp->...ncrp", xdiff, sten1)
        mag = torch.einsum("...ndc,...ndr->...ncr", xs, sten0_abs)
        return ang, mag

    D = table.d_slots
    d_chunk = resolve_d_chunk(D, d_chunk)
    ang = mag = None
    for lo in range(0, D, d_chunk):
        sl = slice(lo, lo + d_chunk)
        a, m = chunk(table.src[..., sl], table.rsten[..., sl, :],
                     table.fwxp[..., sl, k0, :], table.fwxp[..., sl, k1, :])
        ang = a if ang is None else ang + a
        mag = m if mag is None else mag + m
    return ang, mag


def trans_field_weight(contrib_ang, contrib_mag, zonal_ang, zonal_mag, phase,
                       ftype):
    """Contract with zonal banks and recombine.

    contrib_ang: (..., N, C, R, 2); contrib_mag: (..., N, C, R)
    zonal_ang, zonal_mag: (O, C, R); phase: (O, C)
    Returns (..., N, O, 2).
    """
    A = torch.einsum("...ncrp,ocr->...nocp", contrib_ang, zonal_ang)
    phi = soft_angle(A)                                    # (..., N, O, C)
    if ftype == 1:
        phi = phi + phase
    M = torch.einsum("...ncr,ocr->...noc", contrib_mag, zonal_mag)
    rho = soft_absolute(M)
    return torch.sum(cpolar(rho, phi), dim=-2)             # sum over in-channels


def _phasor_power(pr, pi, f: int):
    """(pr + i·pi)^f for integer f (|f| small: repeated multiplication)."""
    cr, ci = torch.ones_like(pr), torch.zeros_like(pi)
    qr, qi = (pr, pi) if f >= 0 else (pr, -pi)
    for _ in range(abs(f)):
        cr, ci = cr * qr - ci * qi, cr * qi + ci * qr
    return cr, ci


def trans_field_banded_contrib(x, comp: CompressedBandedTable,
                               lift_cols=(0, 1), halo=None):
    """Gather-free TransField aggregation over the banded slot layout.

    Same math as :func:`trans_field_contrib` with the ``x[src]`` gather
    replaced by block-shift windowing of x over the CompressedBandedTable
    planes.  Stencil columns are rebuilt from the compressed planes: radial
    hats from the r plane, fwxp_k = wxp·e^{ikθ} from phasor powers.  The
    magnitude stencil uses rsten·|wxp|, which differs from the gather
    path's softAbs(rsten⊗fwxp) only on slots whose magnitude is below
    EPS=1e-7.

    x: (..., N, C) real scalars, N == comp.n_pad (a graph-parallel
    shard's rows and its stencil shard); comp.sten_band carries the same
    leading mesh axes.  halo: optional (left, right) rows (..., nh·TB, C)
    of the ring neighbours in place of the zero padding
    (precomp/banded.py::window_blocks; parallel/halo.py::exchange_halos).
    Returns contribAng (..., N, C, R, 2), contribMag (..., N, C, R).
    """
    sten = comp.sten_band                          # (..., nb, 5, TB, W')
    nb, TB = sten.shape[-4], sten.shape[-2]
    nh, B, R = comp.nh, comp.band_limit, comp.n_rings
    N, C = x.shape[-2:]
    lead = x.shape[:-2]

    xs = window_blocks(x, TB, nh, halo)            # (..., nb, W', C)

    rv = sten[..., 0, :, :]                        # (..., nb, TB, W')
    hats = _hats_from_r(rv, R)                     # (R, ..., nb, TB, W')
    pr, pi = sten[..., 1, :, :], sten[..., 2, :, :]
    wr, wi = sten[..., 3, :, :], sten[..., 4, :, :]

    k0, k1 = lift_cols
    e1r, e1i = _phasor_power(pr, pi, k1 - B)
    f1 = torch.stack([wr * e1r - wi * e1i, wr * e1i + wi * e1r], -1)

    # angular: -Σ_w hats[r]·f1[p]·(xs[w,c] − x[t,c])
    #        = -(Σ_w hats·f1·xs[w]  −  x[t]·Σ_w hats·f1)
    s1 = hats[..., None] * f1                      # (R, ..., nb, TB, W', 2)
    part = torch.einsum("r...btwp,...bwc->...btcrp", s1, xs)
    ssum = torch.sum(s1, dim=-2).movedim(0, -2)    # (..., nb, TB, R, 2)
    xt = x.reshape(*lead, nb, TB, C)
    ang = -(part - xt[..., None, None] * ssum[..., None, :, :])

    # magnitude: Σ_w hats[r]·|wxp|·xs[w,c]  (|fwxp_k| = |wxp|)
    wmag = torch.sqrt(wr * wr + wi * wi)           # (..., nb, TB, W')
    sm = hats * wmag                               # (R, ..., nb, TB, W')
    mag = torch.einsum("r...btw,...bwc->...btcr", sm, xs)

    return ang.reshape(*lead, N, C, R, 2), mag.reshape(*lead, N, C, R)


def trans_field_panel_contrib(x, panel: PanelTable, lift_cols=(0, 1),
                              panel_chunk: int = 256):
    """TransField aggregation over the panel-CSR layout (PanelTable).

    Same math as :func:`trans_field_banded_contrib`, organised per
    (target-block, source-block) panel: each panel contributes a (TB, C,
    R, 2) partial from its gathered source block, and the partials are
    summed per target block.  The compressed panels rebuild the radial hats
    and fwxp_k = wxp·e^{ikθ} from their planes, and the magnitude stencil
    uses rsten·|wxp| (as the banded path does); dense panels (R+2K planes)
    read the hats from planes 0..R-1 and fwxp_k1 from planes R+2k1,
    R+2k1+1, and weigh the magnitude by |fwxp_k0|, as the JAX package's
    dense branch does.  The source sums go through :class:`_PanelLiftAggFn`
    (fixed-order sums each way).  A bf16 table (``cast_panel_sten``) forms
    its stencil factors in bf16, as the JAX package's lift does
    (:func:`_lift_stencils`).

    x: (..., N, C) real scalars; the table covers the meshes of x's leading
    axes (precomp.banded.concat_panel_tables).
    Returns contribAng (..., N, C, R, 2), contribMag (..., N, C, R)."""
    R, B, TB = panel.n_rings, panel.band_limit, panel.tb
    lead, N, C = x.shape[:-2], x.shape[-2], x.shape[-1]
    xb = x.reshape(-1, TB, C)                       # (nb, TB, C)
    if xb.shape[0] * TB != panel.n_mesh * panel.n_pad:
        raise ValueError(f"x carries {xb.shape[0] * TB} rows but the panel "
                         f"table covers {panel.n_mesh} mesh(es) of "
                         f"{panel.n_pad}")
    nb = xb.shape[0]
    seg, ssum_seg, mag = _PanelLiftAggFn.apply(
        xb, panel.sten, panel.meta, panel.meta_s,
        (R, B, lift_cols[1], None if panel.compressed else lift_cols[0],
         _table_runs(panel, "tgt", nb, panel_chunk),
         _table_runs(panel, "src", nb, panel_chunk)))
    ang = _lift_angular(seg, ssum_seg, xb)
    return (ang.reshape(*lead, N, C, R, 2), mag.reshape(*lead, N, C, R))


def trans_field_compact_contrib(x, compact: CompactPanelTable,
                                lift_cols=(0, 1), panel_chunk: int = 256):
    """TransField aggregation over the CompactPanelTable layout: the math of
    :func:`trans_field_panel_contrib` with each panel's source columns
    gathered per ``src_idx`` (the row gather written out, ``panel_chunk``
    panels at a time) instead of read as whole blocks.  The source sums go
    through :class:`_CompactLiftAggFn`, the counterpart of the JAX
    package's custom VJP ``_compact_lift_agg``, whose backward folds the
    per-column gradients with one compact_fold; the target-row term is
    ordinary autograd.  A bf16 table is cast to f32 a chunk at a time on
    read, as the JAX package's ``_compact_lift_stencils`` does.

    x: (..., N, C) real scalars; the table covers the meshes of x's leading
    axes (precomp.banded.concat_compact_panel_tables).
    Returns contribAng (..., N, C, R, 2), contribMag (..., N, C, R)."""
    R, TB = compact.n_rings, compact.tb
    lead, N, C = x.shape[:-2], x.shape[-2], x.shape[-1]
    xf = x.reshape(-1, C)
    if xf.shape[0] != compact.n_mesh * compact.n_pad:
        raise ValueError(f"x carries {xf.shape[0]} rows but the compact "
                         f"table covers {compact.n_mesh} mesh(es) of "
                         f"{compact.n_pad}")
    seg, ssum_seg, mag = _CompactLiftAggFn.apply(
        xf, compact.sten, compact.meta, compact.src_idx, compact.fold_order,
        compact.fold_ptr,
        _table_runs(compact, "tgt", xf.shape[0] // TB, panel_chunk),
        (R, compact.band_limit, lift_cols[1], panel_chunk, TB))
    ang = _lift_angular(seg, ssum_seg, xf.reshape(-1, TB, C))
    return (ang.reshape(*lead, N, C, R, 2), mag.reshape(*lead, N, C, R))


def _lift_stencils(sten_c, R: int, B: int, k1: int, k0=None,
                   f32: bool = False):
    """A chunk of panels' lift stencils: the hats (R, cb, TBt, TS), s1 =
    hats ⊗ fwxp_k1 (R, cb, TBt, TS, 2) and sm = hats·|fwxp_k0| (the
    magnitude stencil rsten·|wxp|).  Compressed panels (k0 None) rebuild
    the hats from r and fwxp_k1 = wxp·e^{i(k1−B)θ} from the phasor, with
    |wxp| as |fwxp_k0|; dense panels (R+2K planes) read them from their
    planes.  The factors come in the chunk's dtype, each op rounded to it:
    a bf16 block-panel table forms them in bf16, as the JAX package's panel
    lift does (``fieldconv_tpu/ops/trans_field.py::
    trans_field_panel_contrib`` casts nothing); ``f32`` casts the chunk on
    read first, as its compact lift does (``_compact_lift_stencils``).  The
    products s1 and sm are formed in f32 (exact for bf16 factors), as XLA
    forms them where they feed the f32 contractions and sums.  Returns
    (s1, sm) in f32."""
    if f32:
        sten_c = sten_c.float()
    if k0 is None:
        hats = _hats_from_r(sten_c[:, 0], R)               # (R, cb, TB, TS)
        pr, pi = sten_c[:, 1], sten_c[:, 2]
        wr, wi = sten_c[:, 3], sten_c[:, 4]
        e1r, e1i = _phasor_power(pr, pi, k1 - B)
        f1 = torch.stack([wr * e1r - wi * e1i, wr * e1i + wi * e1r], -1)
    else:
        hats = sten_c[:, :R].movedim(1, 0)                 # (R, cb, TB, TS)
        f1 = sten_c[:, R + 2 * k1:R + 2 * k1 + 2].movedim(1, -1)
        wr, wi = sten_c[:, R + 2 * k0], sten_c[:, R + 2 * k0 + 1]
    wmag = torch.sqrt(wr * wr + wi * wi)
    hats = hats.float()
    return hats[..., None] * f1.float(), hats * wmag.float()


def _runs(keys, n_keys: int, max_items: int):
    """The runs of a sorted key row ``keys`` (P,) (each key in [0,
    n_keys)), cut into chunks of whole runs of at most ``max_items`` items
    (a longer run alone).  Per chunk (k0, k1, i0, i1, idx): keys [k0, k1)
    own items [i0, i1), and idx (k1 − k0, L) (on keys' device) lists each
    key's items as offsets from i0 in order, padded with i1 − i0, so that a
    sum over idx's second axis adds each key's items in a fixed order, with
    no scatter (one host copy of ``keys``: the lifts build it once per
    table, :func:`_table_runs`)."""
    off = np.searchsorted(keys.cpu().numpy(), np.arange(n_keys + 1))
    chunks, k0 = [], 0
    while k0 < n_keys:
        k1 = k0 + 1
        while k1 < n_keys and off[k1 + 1] - off[k0] <= max_items:
            k1 += 1
        i0, i1 = int(off[k0]), int(off[k1])
        lengths = off[k0 + 1:k1 + 1] - off[k0:k1]
        pos = np.arange(max(1, int(lengths.max())))
        idx = np.where(pos < lengths[:, None],
                       (off[k0:k1] - i0)[:, None] + pos, i1 - i0)
        chunks.append((k0, k1, i0, i1, torch.from_numpy(idx).to(keys.device)))
        k0 = k1
    return chunks


def _table_runs(table, row: str, n_keys: int, max_items: int):
    """:func:`_runs` of one of a panel table's sorted key rows, ``row``
    "tgt" (meta row 0: panels by target block, PanelTable and
    CompactPanelTable) or "src" (meta_s row 2: a PanelTable's panels by
    source block).  The runs depend on the table alone, so they are built
    on first use and kept on the table object (outside its fields, so a
    ``dataclasses.replace`` copy such as ``to`` or ``cast_panel_sten``
    builds its own): the lift then makes no host round trip per call."""
    cache = vars(table).setdefault("_lift_runs", {})
    key = (row, n_keys, max_items)
    if key not in cache:
        keys = table.meta[0] if row == "tgt" else table.meta_s[2]
        cache[key] = _runs(keys, n_keys, max_items)
    return cache[key]


def _run_sums(vals, idx):
    """vals (n, ...) summed per key of a chunk of _runs: (k1 − k0, ...),
    each key's items added in a fixed order (padding adds zeros).  A bf16
    tensor is added item by item in its own dtype, each add rounded, as
    the JAX package's segment_sum adds it."""
    pad = vals.new_zeros(1, *vals.shape[1:])
    runs = torch.cat([vals, pad])[idx]                 # (nk, L, ...)
    if vals.dtype == torch.float32:
        return runs.sum(1)
    acc = runs[:, 0]
    for j in range(1, runs.shape[1]):
        acc = acc + runs[:, j]
    return acc


def _fixed_sum(s, dim: int):
    """f32 ``s`` summed over ``dim`` by pairwise halving: elementwise adds,
    so the same order and the same result on every device.  A bf16 lift
    rounds its stencil row sums to bf16 once (the JAX package's jnp.sum
    upcasts them the same way); they then agree bitwise between the CPU and
    the card, where a rounding boundary would otherwise move a sum by a
    whole bf16 ulp."""
    while s.shape[dim] > 1:
        n = s.shape[dim]
        if n % 2:
            s = torch.cat([s, torch.zeros_like(s.narrow(dim, 0, 1))], dim)
            n += 1
        s = s.narrow(dim, 0, n // 2) + s.narrow(dim, n // 2, n // 2)
    return s.squeeze(dim)


def _lift_sums(rows, sten, runs, nb_out: int, C: int, R: int, B: int,
               k1: int, k0=None, f32: bool = False):
    """The lift's source sums over compressed panels sten (P, 5, TBt, TS)
    (or dense ones, (P, R+2K, TBt, TS), with k0 set) whose target-block
    runs are ``runs`` (:func:`_runs` of the sorted target row over nb_out
    blocks), each panel against its source rows ``rows(lo, hi)``
    ((hi − lo, TS, C), one per column): per panel a (TBt, C, R, 2) partial
    of the angular sum s1·x, a (TBt, R, 2) one of s1's row sums and a
    (TBt, C, R) one of the magnitude sum sm·x, each summed per target block
    in panel order, one chunk of ``runs`` at a time (no scatter, so the
    sums repeat bitwise on a card).  The stencil factors as
    :func:`_lift_stencils` forms them (``f32``: cast on read); s1's row
    sums stay in the table's dtype, as in the JAX package
    (:func:`_fixed_sum`, then each target's panels added as
    :func:`_run_sums` adds them).  Returns (seg (nb_out, TBt, C, R, 2),
    ssum_seg (nb_out, TBt, R, 2), mag (nb_out, TBt, C, R))."""
    TB = sten.shape[2]
    f32_out = dict(dtype=torch.float32, device=sten.device)
    sdt = torch.float32 if f32 else sten.dtype     # the factors' dtype
    seg = torch.zeros(nb_out, TB, C, R, 2, **f32_out)
    mag = torch.zeros(nb_out, TB, C, R, **f32_out)
    ssum_seg = torch.zeros(nb_out, TB, R, 2, dtype=sdt, device=sten.device)
    for b0, b1, lo, hi, idx in runs:
        s1, sm = _lift_stencils(sten[lo:hi], R, B, k1, k0, f32)
        xs = rows(lo, hi)                                  # (cb, TS, C)
        part = torch.einsum("rptsj,psc->ptcrj", s1, xs)
        ssum = _fixed_sum(s1, 3).to(sdt).permute(1, 2, 0, 3)  # (cb, TB, R, 2)
        magp = torch.einsum("rpts,psc->ptcr", sm, xs)
        seg[b0:b1] = _run_sums(part, idx)
        ssum_seg[b0:b1] = _run_sums(ssum, idx)
        mag[b0:b1] = _run_sums(magp, idx)
    return seg, ssum_seg, mag


def _lift_angular(seg, ssum_seg, xb):
    """contribAng = −Σ (x_s − x_t)·s1 = −(seg − x_t·ssum), per target row;
    xb (nb_out, TBt, C) the target rows."""
    return -(seg - xb[..., None, None] * ssum_seg[:, :, None])


class _PanelLiftAggFn(torch.autograd.Function):
    """The panel lift's source sums (:func:`_lift_sums` over a PanelTable's
    source blocks) with a hand-written backward, so that both directions
    sum in a fixed order (index_add and the backward of an advanced-index
    gather accumulate in an order that varies between runs on a card).
    Forward: each target block's panels in meta order.  Backward: d_xs =
    s1ᵀ·d_part + smᵀ·d_magp per panel, summed per source block in the
    table's by-source order ``meta_s``.  The stencil sums ``ssum_seg`` take
    no gradient, and neither does the table.  Serves compressed and dense
    tables, of one mesh or a batch; ``statics`` ends with the table's runs
    by target and by source (:func:`_table_runs`)."""

    @staticmethod
    def forward(ctx, xb, sten, meta, meta_s, statics):
        R, B, k1, k0, runs, _ = statics
        ctx.save_for_backward(sten, meta_s)
        ctx.statics = statics
        src = meta[1].long()
        out = _lift_sums(lambda lo, hi: xb[src[lo:hi]], sten, runs,
                         xb.shape[0], xb.shape[2], R, B, k1, k0)
        ctx.mark_non_differentiable(out[1])
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_seg, d_ssum, d_mag):
        sten, meta_s = ctx.saved_tensors
        R, B, k1, k0, _, runs_s = ctx.statics
        nb, TB, C = d_seg.shape[:3]
        pid, tgt = meta_s[0].long(), meta_s[1].long()
        dx = d_seg.new_zeros(nb, TB, C)
        for s0, s1_, lo, hi, idx in runs_s:
            s1, sm = _lift_stencils(sten[pid[lo:hi]], R, B, k1, k0)
            t = tgt[lo:hi]
            d_xs = (torch.einsum("rptsj,ptcrj->psc", s1, d_seg[t])
                    + torch.einsum("rpts,ptcr->psc", sm, d_mag[t]))
            dx[s0:s1_] = _run_sums(d_xs, idx)
        return dx, None, None, None, None


class _CompactLiftAggFn(torch.autograd.Function):
    """The compact lift's source sums (:func:`_lift_sums` over a
    CompactPanelTable's gathered columns) with a hand-written backward: the
    counterpart of the JAX package's ``_compact_lift_agg`` custom VJP.
    Its backward is :func:`_compact_lift_agg_bwd`; the stencil sums
    ``ssum_seg`` take no gradient, and neither does the table.  ``runs``
    are the table's runs by target (:func:`_table_runs`)."""

    @staticmethod
    def forward(ctx, x, sten, meta, src_idx, fold_order, fold_ptr, runs,
                statics):
        R, B, k1, pc, TB = statics
        ctx.save_for_backward(sten, meta, src_idx, fold_order, fold_ptr)
        ctx.statics, ctx.rows = statics, x.shape[0]
        idx = src_idx.long()
        out = _lift_sums(lambda lo, hi: x[idx[lo:hi]], sten, runs,
                         x.shape[0] // TB, x.shape[1], R, B, k1, f32=True)
        ctx.mark_non_differentiable(out[1])
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_seg, d_ssum, d_mag):
        dx = _compact_lift_agg_bwd(d_seg, d_mag, *ctx.saved_tensors,
                                   ctx.statics, ctx.rows)
        return dx, None, None, None, None, None, None, None


def _compact_lift_agg_bwd(d_seg, d_mag, sten, meta, src_idx, fold_order,
                          fold_ptr, statics, rows: int):
    """The transpose of the compact lift's per-panel contraction, as the
    JAX package's ``_compact_lift_agg_bwd`` forms it: per chunk of panels
    d_xs = s1ᵀ·d_part + smᵀ·d_magp (plain torch, where JAX runs XLA), with
    d_part and d_magp each panel's target block's rows of d_seg and d_mag,
    then one compact_fold of the (P·TS, C) column gradients onto x's rows.
    Returns dx (rows, C)."""
    R, B, k1, pc, TB = statics
    tgt = meta[0].long()
    P, TS = src_idx.shape
    C = d_seg.shape[2]
    d_xs = d_seg.new_empty(P, TS, C)
    for lo in range(0, P, pc):
        s1, sm = _lift_stencils(sten[lo:lo + pc], R, B, k1, f32=True)
        tgt_c = tgt[lo:lo + pc]
        d_xs[lo:lo + pc] = (
            torch.einsum("rptsj,ptcrj->psc", s1, d_seg[tgt_c])
            + torch.einsum("rpts,ptcr->psc", sm, d_mag[tgt_c]))
    return compact_fold(d_xs.reshape(P * TS, C), src_idx, fold_order,
                        fold_ptr, rows)


def lift_contribs(x, table, lift_cols=(0, 1), d_chunk: int = 128,
                  comp=None, halo=None):
    """The lift's (contribAng, contribMag) over the layout ``comp`` names:
    a CompressedBandedTable routes the aggregation to the gather-free
    banded path (with ``halo``, a graph-parallel shard's), a PanelTable to
    the panel-CSR path, a CompactPanelTable to the compacted-column path;
    None uses the padded-CSR gather path."""
    if isinstance(comp, CompressedBandedTable):
        return trans_field_banded_contrib(x, comp, lift_cols=lift_cols,
                                          halo=halo)
    if halo is not None:
        raise NotImplementedError(
            "a graph-parallel lift takes a CompressedBandedTable shard; the "
            "panel-sharded path is ROADMAP Queue 1 item 8")
    if isinstance(comp, PanelTable):
        return trans_field_panel_contrib(x, comp, lift_cols=lift_cols)
    if isinstance(comp, CompactPanelTable):
        return trans_field_compact_contrib(x, comp, lift_cols=lift_cols)
    if comp is not None:
        raise NotImplementedError(
            f"the lift over {type(comp).__name__} is not ported")
    return trans_field_contrib(x, table, lift_cols=lift_cols,
                               d_chunk=d_chunk)


def trans_field(x, table, zonal_ang, zonal_mag, phase, ftype,
                lift_cols=(0, 1), d_chunk: int = 128, comp=None, halo=None):
    """TransField lift: :func:`lift_contribs` over the layout ``comp``
    names (and ``halo``), then :func:`trans_field_weight`."""
    ang, mag = lift_contribs(x, table, lift_cols, d_chunk, comp, halo)
    return trans_field_weight(ang, mag, zonal_ang, zonal_mag, phase, ftype)
