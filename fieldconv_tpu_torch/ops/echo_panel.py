"""Panel ECHO with the hand-written kernels: K2 (forward and backward) over
the compressed PanelTable, K7 (forward and backward) over the
CompactPanelTable.

Counterpart of ``fieldconv_tpu/ops/pallas/echo_panel.py``.  The
rasterisation runs in ``csrc/echo_panel_fwd.cu``, which replaces the TPU
kernel ``_fwd_impl`` (body ``_fwd_kernel`` with the helpers
``_panel_tensors``, ``_b_factors`` and ``_a_masks``), its gradient in
``csrc/echo_panel_bwd.cu``, which replaces ``_bwd_impl`` (body
``_bwd_kernel``), and over compact panels in ``csrc/echo_compact_fwd.cu``,
which replaces ``_fwd_impl_compact`` (the same body on gathered columns),
and ``csrc/echo_compact_bwd.cu``, which replaces ``_bwd_impl_compact``
(body ``_bwd_kernel_compact``) with the fold that follows it.  The wrappers
:func:`echo_panel_grid`, :func:`echo_panel_grid_bwd`,
:func:`echo_compact_grid` and :func:`echo_compact_grid_bwd` launch them
for CUDA tensors and run the plain PyTorch versions (``*_reference``) for
CPU tensors; they never move work between devices.  :class:`_EchoPanelFn`
and :class:`_EchoCompactFn` tie each kernel's two directions together for
autograd, as ``jax.custom_vjp`` does in the JAX package.
:func:`echo_panel_fused` does what ``echo_panel_pallas`` does around the
kernels: the (w², dS) disk-map fold and soft_abs.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels
from ..precomp.banded import CompactPanelTable, PanelTable
from ..utils.complexops import EPS, soft_abs
from .band_conv import STEN_DTYPES, _is_bf16
from .compact_fold import compact_fold_reference
from .echo import fold_matrix


def _panel_tensors(sten_c, xs, n_bins: int):
    """The per-(panel, target, source, channel) tensors of ``_fwd_kernel``,
    in its arithmetic.  sten_c (pc, 5, TBt, TBs); xs (pc, TBs, C, 2) the
    panels' source rows.  Returns a dict: ln_re, ln_im, wre, wim (pc, 1,
    TBt, TBs); nzf, inv_r, uR, uI (pc, C, 1, TBs); p1, p2, v_re, v_im (pc,
    C, TBt, TBs).

    1/|x| is 1/sqrt(|x|²) (correctly rounded, where the TPU kernel takes an
    rsqrt), so that the CUDA kernels can form the same p bit for bit: a vote
    whose p lands exactly on an integer gets weight 0, and an ulp apart
    would move the whole vote (csrc/echo_panel_fwd.cu, "Exact p").  The
    chunk is cast to f32 on read (a bf16 table), as the JAX kernel casts
    each plane and as the CUDA kernels read it, so that both form p from
    the same f32 values."""
    sten_c = sten_c.float()
    rv = sten_c[:, 0]
    ln_re = (rv * sten_c[:, 1])[:, None]                 # (pc, 1, TBt, TBs)
    ln_im = (rv * sten_c[:, 2])[:, None]
    wre, wim = sten_c[:, 3, None], sten_c[:, 4, None]
    xre = xs[..., 0].transpose(1, 2)[:, :, None]         # (pc, C, 1, TBs)
    xim = xs[..., 1].transpose(1, 2)[:, :, None]
    nz = (torch.abs(xre) >= EPS) | (torch.abs(xim) >= EPS)
    nzf = nz.to(xs.dtype)
    r2 = xre * xre + xim * xim
    inv_r = 1.0 / torch.sqrt(torch.where(nz, r2, torch.ones_like(r2)))
    uR = xre * inv_r * nzf
    uI = xim * inv_r * nzf
    return dict(ln_re=ln_re, ln_im=ln_im, wre=wre, wim=wim, nzf=nzf,
                inv_r=inv_r, uR=uR, uI=uI,
                p1=n_bins * (ln_re * uR + ln_im * uI),
                p2=n_bins * (-ln_re * uI + ln_im * uR),
                v_re=(xre * wre - xim * wim) * nzf,
                v_im=(xre * wim + xim * wre) * nzf)


def _corners(p1, p2, n_bins: int):
    """The bilinear splat of p: the distances (e1C, e1F, e2C, e2F) of p to
    its ceil and floor corners (clipped to ±n_bins), and per corner k its
    weight w_k and flat cell index a·w + b, in the order of
    ``_b_factors``: w0 at (F1, F2), w1 at (C1, C2), w2 at (C1, F2), w3 at
    (F1, C2)."""
    w = 2 * n_bins + 1
    pC1 = torch.clamp(torch.ceil(p1), -n_bins, n_bins)
    pF1 = torch.clamp(torch.floor(p1), -n_bins, n_bins)
    pC2 = torch.clamp(torch.ceil(p2), -n_bins, n_bins)
    pF2 = torch.clamp(torch.floor(p2), -n_bins, n_bins)
    e1C, e1F, e2C, e2F = pC1 - p1, p1 - pF1, pC2 - p2, p2 - pF2
    weights = (e1C * e2C, e1F * e2F, e1F * e2C, e1C * e2F)
    aF, aC, bF, bC = ((c + n_bins).long() for c in (pF1, pC1, pF2, pC2))
    cells = (aF * w + bF, aC * w + bC, aC * w + bF, aF * w + bC)
    return (e1C, e1F, e2C, e2F), weights, cells


def echo_panel_grid_reference(x, sten, meta, n_bins: int, nb_out: int):
    """Plain PyTorch K2 forward: what ``_fwd_kernel`` computes.

    x: (rows, C, 2) planar source features, rows = nb_out·TB; sten: (P, 5,
    TB, TB) compressed panels; meta: (4, P) int32 (tgt, src, first, last),
    sorted by target.  For each slot (t, s) of each panel and channel c:
    u = conj(x_s/|x_s|), p = n_bins·(r·e^{iθ})·u, the four bilinear weights
    of p's floor/ceil cell corners (clipped to ±n_bins), and the vote
    x_s·wxp (zero where both components of x_s are below EPS).  Each vote
    is added with its weight into cell (a, b) = (corner of p1, corner of
    p2) + n_bins of target t's w×w grid, summed over the slot's source
    axis, then over the target block's panels in meta order.

    Returns grid (nb_out, 2w², C, TB): rows q = a·w + b hold the real
    parts, rows w² + q the imaginary parts.  A target block with no panel
    stays zero.

    The TPU kernel forms every cell's weight with masks (cell (a, b) weighs
    a vote by AF_a·QF_b + AC_a·QC_b, QF_b = w0·BF_b + w3·BC_b, QC_b =
    w2·BF_b + w1·BC_b); the masks select exactly the four corner cells, so
    here each corner's weighted votes are added into its cell directly."""
    TB = sten.shape[-1]
    xb = x.reshape(nb_out, TB, *x.shape[1:])
    meta = meta.long()
    return _grid_reference(lambda lo, hi: xb[meta[1, lo:hi]], x, sten,
                           meta[0], n_bins, nb_out)


def _grid_reference(rows, x, sten, tgt, n_bins: int, nb_out: int):
    """The grid (nb_out, 2w², C, TBt) of K2's (and K7's) plain versions
    over panels sten (P, 5, TBt, TS) of target blocks tgt (P,), each panel
    against its source rows ``rows(lo, hi)`` ((hi − lo, TS, C, 2), one per
    column), 8 panels at a time."""
    C, TBt = x.shape[1], sten.shape[2]
    w = 2 * n_bins + 1
    grid = x.new_zeros(nb_out, 2, w * w, C, TBt)
    pc = 8                     # panels per step: bounds the (pc, C, TBt, TS)
    for lo in range(0, sten.shape[0], pc):
        t = _panel_tensors(sten[lo:lo + pc], rows(lo, lo + pc), n_bins)
        _, weights, cells = _corners(t["p1"], t["p2"], n_bins)
        v = torch.stack([t["v_re"], t["v_im"]], 1)       # (pc, 2, C, TBt, TS)
        part = x.new_zeros(*v.shape[:-1], w * w)         # (pc, 2, C, TBt, w²)
        for cell, wt in zip(cells, weights):
            part = part.scatter_add(-1, cell[:, None].expand_as(v),
                                    wt[:, None] * v)
        grid = grid.index_add(0, tgt[lo:lo + pc], part.permute(0, 1, 4, 2, 3))
    return grid.reshape(nb_out, 2 * w * w, C, TBt)


def echo_panel_grid_bwd_reference(dg, x, sten, meta_s, n_bins: int,
                                  nb_out: int):
    """Plain PyTorch K2 backward, written out (not taken from autograd):
    what ``_bwd_kernel`` computes.

    dg: (nb_out, 2w², C, TB) cotangent of the grid (any strides); x, sten
    as in :func:`echo_panel_grid_reference`; meta_s: (4, P_s) int32 rows
    (pid, tgt, src, first_s + 2·last_s), the panels in by-source order.
    For each slot (t, s) of each panel and channel c, with p, the corners,
    the weights w_k and the vote v recomputed as the forward forms them and
    G_k = dg[tgt, cell_k, c, t] (re and im):

        dv   = Σ_k w_k·G_k                      (the vote's cotangent)
        dW_k = v_re·G_k,re + v_im·G_k,im        (each weight's)
        dp1  = −dW0·e2C + dW1·e2F + dW2·e2C − dW3·e2F
        dp2  = −dW0·e1C + dW1·e1F − dW2·e1F + dW3·e1C
        du   = n_bins·(dp1·ln + dp2·i·ln) summed over the targets t, taken
               through u = x/|x| by (I − ûûᵀ)/|x|
        dx  += conj(wxp)·dv summed over the targets, plus du's share

    Cell masks and floor/ceil corners are piecewise constant (zero
    gradient); a source at the origin (both components below EPS) gets
    none.  Returns dx (rows, C, 2); the rows of a source block with no
    panel in meta_s are zero."""
    C, TB = x.shape[1], sten.shape[-1]
    xb = x.reshape(-1, TB, C, 2)
    dgb = _grid_cells_minor(dg, n_bins)
    meta_s = meta_s.long()
    dx = x.new_zeros(xb.shape)
    pc = 8
    for lo in range(0, meta_s.shape[1], pc):
        pid, tgt, src = (meta_s[i, lo:lo + pc] for i in range(3))
        part = _unvote(sten[pid], xb[src], dgb[tgt], n_bins)
        dx = dx.index_add(0, src, part)
    return dx.reshape(x.shape)


def _grid_cells_minor(dg, n_bins: int):
    """A grid or its cotangent (nb, 2w², C, TBt) (any strides) viewed as
    (nb, 2, C, TBt, w²): re / im, then the cells last."""
    nb, _, C, TBt = dg.shape
    w2 = (2 * n_bins + 1) ** 2
    return dg.reshape(nb, 2, w2, C, TBt).permute(0, 1, 3, 4, 2)


def _unvote(sten_c, xs, dgt, n_bins: int):
    """The transpose of K2's (and K7's) vote over a chunk of panels sten_c
    (pc, 5, TBt, TS) against their source rows xs (pc, TS, C, 2), for the
    cotangents dgt (pc, 2, C, TBt, w²) of their target blocks' grids: per
    slot p, the corners, the weights and the vote recomputed as the
    forward forms them, then

        dv   = Σ_k w_k·G_k,  dW_k = v_re·G_k,re + v_im·G_k,im
        dp1  = −dW0·e2C + dW1·e2F + dW2·e2C − dW3·e2F
        dp2  = −dW0·e1C + dW1·e1F − dW2·e1F + dW3·e1C
        du   = n_bins·(dp1·ln + dp2·i·ln) summed over the targets, taken
               through u = x/|x| by (I − ûûᵀ)/|x|
        dx   = conj(wxp)·dv summed over the targets, plus du's share

    Returns each panel's column gradients (pc, TS, C, 2); a source at the
    origin gets none."""
    t = _panel_tensors(sten_c, xs, n_bins)
    (e1C, e1F, e2C, e2F), weights, cells = _corners(t["p1"], t["p2"],
                                                    n_bins)
    dv = dp1 = dp2 = 0.0
    for k, (cell, wk) in enumerate(zip(cells, weights)):
        gk = torch.gather(dgt, -1, cell[:, None].expand(
            -1, 2, -1, -1, -1))                          # (pc, 2, C, TBt, TS)
        dv = dv + wk[:, None] * gk
        dW = t["v_re"] * gk[:, 0] + t["v_im"] * gk[:, 1]
        dp1 = dp1 + dW * (-e2C, e2F, e2C, -e2F)[k]
        dp2 = dp2 + dW * (-e1C, e1F, -e1F, e1C)[k]
    lr, li = t["ln_re"], t["ln_im"]
    du_re = (n_bins * (dp1 * lr + dp2 * li)).sum(2)      # (pc, C, TS)
    du_im = (n_bins * (dp1 * li - dp2 * lr)).sum(2)
    uR, uI = t["uR"][:, :, 0], t["uI"][:, :, 0]
    dot = uR * du_re + uI * du_im
    scale = (t["inv_r"] * t["nzf"])[:, :, 0]
    nzf = t["nzf"][:, :, 0]
    wre, wim = t["wre"], t["wim"]
    dx_re = ((du_re - uR * dot) * scale
             + (dv[:, 0] * wre + dv[:, 1] * wim).sum(2) * nzf)
    dx_im = ((du_im - uI * dot) * scale
             + (dv[:, 1] * wre - dv[:, 0] * wim).sum(2) * nzf)
    return torch.stack([dx_re, dx_im], -1).transpose(1, 2)


def _check(x, sten, meta, n_bins: int, nb_out: int, name="echo_panel_fwd",
           *more, ts=None):
    """Raise unless the shapes agree and x (float32), sten (float32 or
    bfloat16), meta and the named extra tensors (int32) are contiguous on
    x's device.  Panels are (TB, ts) slots, ts = TB by default (K7's are
    rectangular)."""
    rows, C = x.shape[0], x.shape[1]
    P, TB = sten.shape[0], sten.shape[2]
    ts = TB if ts is None else ts
    if x.dim() != 3 or x.shape[2] != 2 or rows != nb_out * TB \
            or tuple(sten.shape) != (P, 5, TB, ts) \
            or meta.dim() != 2 or meta.shape[0] != 4 \
            or n_bins not in (1, 2, 3, 4):
        raise ValueError(
            f"{name} shapes do not agree: x {tuple(x.shape)}, sten "
            f"{tuple(sten.shape)}, meta {tuple(meta.shape)}, nb_out {nb_out}, "
            f"n_bins {n_bins}")
    for label, t, dtype in (("x", x, torch.float32),
                            ("sten", sten, STEN_DTYPES),
                            ("meta", meta, torch.int32),
                            *((lb, t, torch.int32) for lb, t in more)):
        dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
        if t.device != x.device or t.dtype not in dtypes \
                or not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous {dtype} "
                             f"{label} on {x.device}, got {t.dtype} on "
                             f"{t.device} (contiguous={t.is_contiguous()})")
    if x.storage_offset() % 2:
        raise ValueError(f"{name} reads x as 8-byte (re, im) pairs: its "
                         "storage must start on an 8-byte boundary")


@functools.cache
def _k2_entry():
    fn = kernels.library("echo_panel_fwd").echo_panel_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _echo_panel_fwd_cuda(x, sten, meta, n_bins: int, nb_out: int):
    _check(x, sten, meta, n_bins, nb_out)
    if meta.shape[1] != sten.shape[0]:
        raise ValueError(f"echo_panel_fwd: meta {tuple(meta.shape)} for "
                         f"{sten.shape[0]} panels")
    C, TB = x.shape[1], sten.shape[-1]
    w = 2 * n_bins + 1
    fn = _k2_entry()
    out = torch.empty((nb_out, 2 * w * w, C, TB), dtype=torch.float32,
                      device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), sten.data_ptr(), meta.data_ptr(), out.data_ptr(),
             sten.shape[0], nb_out, C, TB, n_bins, _is_bf16(sten), stream)
    if err != 0:
        raise RuntimeError(f"echo_panel_fwd launch failed: cudaError {err}")
    kernels.launches["echo_panel_fwd"] += 1
    return out


def echo_panel_grid(x, sten, meta, n_bins: int, nb_out: int):
    """K2 forward: the ECHO grid (nb_out, 2w², C, TB) of every target block
    (shapes as in :func:`echo_panel_grid_reference`).

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (building it on first use) or raise."""
    if x.device.type == "cpu":
        return echo_panel_grid_reference(x, sten, meta, n_bins, nb_out)
    if x.device.type == "cuda":
        return _echo_panel_fwd_cuda(x, sten, meta, n_bins, nb_out)
    raise ValueError(f"echo_panel_grid has no kernel for device {x.device}")


@functools.cache
def _k2_bwd_entry():
    fn = kernels.library("echo_panel_bwd").echo_panel_bwd
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 4
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _echo_panel_bwd_cuda(dg, x, sten, meta_s, n_bins: int, nb_out: int):
    name = "echo_panel_bwd"
    _check(x, sten, meta_s, n_bins, nb_out, name)
    C, TB = x.shape[1], sten.shape[-1]
    want = (nb_out, 2 * (2 * n_bins + 1) ** 2, C, TB)
    if tuple(dg.shape) != want or dg.dtype != torch.float32 \
            or dg.device != x.device:
        raise ValueError(f"{name} needs float32 dg of shape {want} on "
                         f"{x.device}, got {tuple(dg.shape)} {dg.dtype} on "
                         f"{dg.device}")
    fn = _k2_bwd_entry()
    dx = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # dg is read through its strides: the gradient autograd hands over is
    # the transpose of the fold's cell-minor layout, taken without a copy
    err = fn(dg.data_ptr(), *dg.stride(), x.data_ptr(), sten.data_ptr(),
             meta_s.data_ptr(), dx.data_ptr(), meta_s.shape[1], nb_out, C,
             TB, n_bins, _is_bf16(sten), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    kernels.launches[name] += 1
    return dx


def echo_panel_grid_bwd(dg, x, sten, meta_s, n_bins: int, nb_out: int):
    """K2 backward: dx (rows, C, 2) for the grid's cotangent dg (shapes as
    in :func:`echo_panel_grid_bwd_reference`).

    The JAX kernel's ``coverage`` argument (a mask for the source blocks a
    graph-parallel shard does not cover) is not ported: it returns with
    the graph-parallel paths (ROADMAP Queue 1 item 8).  Here every source
    block without a panel gets zeros.

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (building it on first use) or raise."""
    if x.device.type == "cpu":
        return echo_panel_grid_bwd_reference(dg, x, sten, meta_s, n_bins,
                                             nb_out)
    if x.device.type == "cuda":
        return _echo_panel_bwd_cuda(dg, x, sten, meta_s, n_bins, nb_out)
    raise ValueError(f"echo_panel_grid_bwd has no kernel for device "
                     f"{x.device}")


class _EchoPanelFn(torch.autograd.Function):
    """K2 with its hand-written backward: the counterpart of the JAX
    package's ``_echo_panel_grid`` custom VJP.  Keeps x, the stencil and
    the by-source order for the backward, not the grid; the gradient goes
    to x only (the stencil takes none, as in the JAX VJP)."""

    @staticmethod
    def forward(ctx, x, sten, meta, meta_s, n_bins: int, nb_out: int):
        ctx.save_for_backward(x, sten, meta_s)
        ctx.n_bins, ctx.nb_out = n_bins, nb_out
        return echo_panel_grid(x, sten, meta, n_bins, nb_out)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dg):
        x, sten, meta_s = ctx.saved_tensors
        dx = echo_panel_grid_bwd(dg, x, sten, meta_s, ctx.n_bins, ctx.nb_out)
        return dx, None, None, None, None, None


# --- K7 forward: plain version, wrapper, kernel launch -----------------------

def echo_compact_grid_reference(x, sten, meta, src_idx, n_bins: int,
                                nb_out: int):
    """Plain PyTorch K7 forward: what ``_echo_compact_grid`` computes, the
    row gather ``x[src_idx]`` written out (8 panels at a time) and then
    ``_fwd_kernel`` over rectangular TBt × TS panels.

    x: (rows, C, 2) planar source features, rows = nb_out·TBt; sten (P, 5,
    TBt, TS) compressed panels of a CompactPanelTable; meta (4, P) int32
    (tgt, panel id, first, last), sorted by target; src_idx (P, TS) int32,
    the source row of each column.  Each slot votes as in
    :func:`echo_panel_grid_reference`, with the source feature of column s
    of panel p at row src_idx[p, s].  Returns grid (nb_out, 2w², C, TBt)."""
    idx = src_idx.long()
    return _grid_reference(lambda lo, hi: x[idx[lo:hi]], x, sten,
                           meta[0].long(), n_bins, nb_out)


@functools.cache
def _k7_entry():
    fn = kernels.library("echo_compact_fwd").echo_compact_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _echo_compact_fwd_cuda(x, sten, meta, src_idx, n_bins: int,
                           nb_out: int):
    name = "echo_compact_fwd"
    P, TBt, TS = sten.shape[0], sten.shape[2], sten.shape[-1]
    _check(x, sten, meta, n_bins, nb_out, name, ("src_idx", src_idx), ts=TS)
    if tuple(meta.shape) != (4, P) or tuple(src_idx.shape) != (P, TS):
        raise ValueError(f"{name}: meta {tuple(meta.shape)}, src_idx "
                         f"{tuple(src_idx.shape)} for {P} panels of {TS} "
                         "columns")
    rows, C = x.shape[0], x.shape[1]
    w = 2 * n_bins + 1
    fn = _k7_entry()
    out = torch.empty((nb_out, 2 * w * w, C, TBt), dtype=torch.float32,
                      device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), sten.data_ptr(), meta.data_ptr(),
             src_idx.data_ptr(), out.data_ptr(), P, nb_out, C, TBt, TS,
             n_bins, rows, _is_bf16(sten), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    kernels.launches[name] += 1
    return out


def echo_compact_grid(x, sten, meta, src_idx, n_bins: int, nb_out: int):
    """K7 forward: the ECHO grid (nb_out, 2w², C, TBt) of every target
    block over a CompactPanelTable (shapes as in
    :func:`echo_compact_grid_reference`).

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (building it on first use) or raise.  Gradients go through
    :class:`_EchoCompactFn`."""
    if x.device.type == "cpu":
        return echo_compact_grid_reference(x, sten, meta, src_idx, n_bins,
                                           nb_out)
    if x.device.type == "cuda":
        return _echo_compact_fwd_cuda(x, sten, meta, src_idx, n_bins, nb_out)
    raise ValueError(f"echo_compact_grid has no kernel for device {x.device}")


# --- K7 backward: plain version, wrapper, kernel launch -----------------------

def echo_compact_grid_bwd_reference(dg, x, sten, meta, src_idx,
                                    n_bins: int):
    """Plain PyTorch K7 backward, written out (not taken from autograd):
    what ``_bwd_impl_compact`` (body ``_bwd_kernel_compact``) returns on
    the gathered columns, 8 panels at a time.

    dg: (nb_out, 2w², C, TBt) cotangent of the grid (any strides); x,
    sten, meta, src_idx as in :func:`echo_compact_grid_reference`.  Each
    panel p of target block meta[0, p] transposes its votes as
    :func:`echo_panel_grid_bwd_reference` does, with the source feature of
    column s at row src_idx[p, s].  Returns the per-column gradients dxg
    (P·TS, C, 2), before the fold onto x's rows
    (:func:`echo_compact_grid_bwd` folds them)."""
    idx, tgt = src_idx.long(), meta[0].long()
    dgb = _grid_cells_minor(dg, n_bins)
    P, TS = src_idx.shape
    dxg = x.new_empty(P, TS, *x.shape[1:])
    pc = 8
    for lo in range(0, P, pc):
        dxg[lo:lo + pc] = _unvote(sten[lo:lo + pc], x[idx[lo:lo + pc]],
                                  dgb[tgt[lo:lo + pc]], n_bins)
    return dxg.reshape(P * TS, *x.shape[1:])


@functools.cache
def _k7_bwd_entry():
    """(kernel entry, floats of scratch it needs for given sizes)."""
    lib = kernels.library("echo_compact_bwd")
    fn = lib.echo_compact_bwd
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 4
                   + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    size = lib.echo_compact_bwd_scratch_floats
    size.argtypes = [ctypes.c_int] * 3
    size.restype = ctypes.c_longlong
    return fn, size


def _echo_compact_bwd_cuda(dg, x, sten, meta, src_idx, fold_order,
                           fold_ptr, n_bins: int):
    name = "echo_compact_bwd"
    P, TBt, TS = sten.shape[0], sten.shape[2], sten.shape[-1]
    rows, C = x.shape[0], x.shape[1]
    nb_out = rows // TBt
    _check(x, sten, meta, n_bins, nb_out, name, ("src_idx", src_idx),
           ("fold_order", fold_order), ("fold_ptr", fold_ptr), ts=TS)
    want = (nb_out, 2 * (2 * n_bins + 1) ** 2, C, TBt)
    if tuple(dg.shape) != want or dg.dtype != torch.float32 \
            or dg.device != x.device:
        raise ValueError(f"{name} needs float32 dg of shape {want} on "
                         f"{x.device}, got {tuple(dg.shape)} {dg.dtype} on "
                         f"{dg.device}")
    if tuple(meta.shape) != (4, P) or tuple(src_idx.shape) != (P, TS) \
            or tuple(fold_ptr.shape) != (rows + 1,):
        raise ValueError(f"{name}: meta {tuple(meta.shape)}, src_idx "
                         f"{tuple(src_idx.shape)} for {P} panels of {TS} "
                         f"columns, fold_ptr {tuple(fold_ptr.shape)} for "
                         f"{rows} rows")
    fn, scratch_floats = _k7_bwd_entry()
    dx = torch.empty_like(x)
    # the per-column gradients, folded onto dx by the kernel's last pass
    scratch = torch.empty((max(1, scratch_floats(P, C, TS)),),
                          dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # dg is read through its strides: the gradient autograd hands over is
    # the transpose of the fold's cell-minor layout, taken without a copy
    err = fn(dg.data_ptr(), *dg.stride(), x.data_ptr(), sten.data_ptr(),
             meta.data_ptr(), src_idx.data_ptr(), fold_order.data_ptr(),
             fold_ptr.data_ptr(), dx.data_ptr(), scratch.data_ptr(), P,
             nb_out, C, TBt, TS, n_bins, rows, _is_bf16(sten), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    kernels.launches[name] += 1
    kernels.launches["compact_fold"] += 1        # its last pass
    return dx


def echo_compact_grid_bwd(dg, x, sten, meta, src_idx, fold_order, fold_ptr,
                          n_bins: int):
    """K7 backward: dx (rows, C, 2) for the grid's cotangent dg (shapes as
    in :func:`echo_compact_grid_bwd_reference`): the per-column gradients
    folded onto x's rows through the table's fold index (``fold_order``,
    ``fold_ptr``).

    CPU tensors run the plain version and the plain fold
    (ops/compact_fold.py); CUDA tensors launch the kernel, whose last pass
    is the fold (building it on first use), or raise.  dg is taken in any
    strides on both devices: contiguous, or cells minor as autograd hands
    it over from :func:`echo_panel_fused`."""
    if x.device.type == "cpu":
        dxg = echo_compact_grid_bwd_reference(dg, x, sten, meta, src_idx,
                                              n_bins)
        return compact_fold_reference(dxg.reshape(dxg.shape[0], -1),
                                      src_idx, x.shape[0]).reshape(x.shape)
    if x.device.type == "cuda":
        return _echo_compact_bwd_cuda(dg, x, sten, meta, src_idx, fold_order,
                                      fold_ptr, n_bins)
    raise ValueError(f"echo_compact_grid_bwd has no kernel for device "
                     f"{x.device}")


class _EchoCompactFn(torch.autograd.Function):
    """K7 with its hand-written backward: the counterpart of the JAX
    package's ``_echo_compact_grid`` custom VJP.  Keeps x, the stencil,
    meta, src_idx and the fold index for the backward, not the grid; the
    gradient goes to x only."""

    @staticmethod
    def forward(ctx, x, sten, meta, src_idx, fold_order, fold_ptr,
                n_bins: int, nb_out: int):
        ctx.save_for_backward(x, sten, meta, src_idx, fold_order, fold_ptr)
        ctx.n_bins = n_bins
        return echo_compact_grid(x, sten, meta, src_idx, n_bins, nb_out)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dg):
        dx = echo_compact_grid_bwd(dg, *ctx.saved_tensors, ctx.n_bins)
        return dx, None, None, None, None, None, None, None


def _check_panel(x, panel):
    if not isinstance(panel, CompactPanelTable) and not (
            isinstance(panel, PanelTable) and panel.compressed):
        raise ValueError("panel ECHO needs a compressed PanelTable "
                         "(build_panel_table(compressed=True)) or a "
                         "CompactPanelTable")
    rows = x[..., 0, 0].numel()
    if rows != panel.n_mesh * panel.n_pad:
        raise ValueError(
            f"x carries {rows} rows but the panel table covers "
            f"{panel.n_mesh} mesh(es) of {panel.n_pad}")


def echo_panel_fused(x, panel, n_bins: int):
    """Panel ECHO: (..., N, C, 2) -> (..., N, C, dS), through K2 over a
    compressed PanelTable or through K7 over a CompactPanelTable.

    panel: a table covering the meshes of x's leading axes (one table and
    one launch serve a whole batch).  The kernel's w×w grid is folded onto
    the disk bins and soft_abs gives the magnitudes, as
    ``echo_panel_pallas`` does."""
    _check_panel(x, panel)
    lead, N, C = x.shape[:-3], x.shape[-3], x.shape[-2]
    TB = panel.tb
    w = 2 * n_bins + 1
    xf = x.reshape(-1, C, 2).contiguous()
    rows = xf.shape[0]
    if isinstance(panel, CompactPanelTable):
        grid = _EchoCompactFn.apply(xf, panel.sten, panel.meta, panel.src_idx,
                                    panel.fold_order, panel.fold_ptr, n_bins,
                                    rows // TB)
    else:
        grid = _EchoPanelFn.apply(xf, panel.sten, panel.meta, panel.meta_s,
                                  n_bins, rows // TB)
    # (nb, 2w², C, TB) -> (rows, C, 2, w²) -> fold -> (rows, C, dS, 2)
    grid4 = grid.permute(0, 3, 2, 1).reshape(rows, C, 2, w * w)
    hist = torch.einsum("ncpu,us->ncsp", grid4,
                        fold_matrix(n_bins, x.device))
    return soft_abs(hist).reshape(*lead, N, C, hist.shape[-2])
