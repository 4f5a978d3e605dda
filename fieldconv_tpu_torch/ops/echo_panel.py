"""Panel ECHO with the hand-written kernel (K2 forward).

Counterpart of ``fieldconv_tpu/ops/pallas/echo_panel.py`` for the
compressed PanelTable.  The rasterisation runs in ``csrc/echo_panel_fwd.cu``,
which replaces the TPU kernel ``_fwd_impl`` (body ``_fwd_kernel`` with the
helpers ``_panel_tensors``, ``_b_factors`` and ``_a_masks``).  The wrapper
:func:`echo_panel_grid` launches it for CUDA tensors and runs the plain
PyTorch version :func:`echo_panel_grid_reference` for CPU tensors; it never
moves work between devices.  :func:`echo_panel_fused` does what
``echo_panel_pallas`` does around the kernel: the (w², dS) disk-map fold and
soft_abs.

The backward (``_bwd_impl``) is not ported yet: on the card the op serves
inference only and raises when a gradient is required.  On the CPU the
plain version is differentiable through autograd.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels
from ..precomp.banded import PanelTable
from ..utils.complexops import EPS, soft_abs
from .echo import fold_matrix


def _panel_tensors(sten_c, xs, n_bins: int):
    """The per-(panel, target, source, channel) tensors of ``_fwd_kernel``,
    in its arithmetic.  sten_c (pc, 5, TBt, TBs); xs (pc, TBs, C, 2) the
    panels' source rows.  Returns p1, p2, v_re, v_im (pc, C, TBt, TBs).

    1/|x| is 1/sqrt(|x|²) (correctly rounded, where the TPU kernel takes an
    rsqrt), so that the CUDA kernel can form the same p bit for bit: a vote
    whose p lands exactly on an integer gets weight 0, and an ulp apart
    would move the whole vote (csrc/echo_panel_fwd.cu, "Exact p")."""
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
    p1 = n_bins * (ln_re * uR + ln_im * uI)
    p2 = n_bins * (-ln_re * uI + ln_im * uR)
    v_re = (xre * wre - xim * wim) * nzf
    v_im = (xre * wim + xim * wre) * nzf
    return p1, p2, v_re, v_im


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
    C, TB = x.shape[1], sten.shape[-1]
    w = 2 * n_bins + 1
    xb = x.reshape(nb_out, TB, C, 2)
    meta = meta.long()
    grid = x.new_zeros(nb_out, 2, w * w, C, TB)
    pc = 8                     # panels per step: bounds the (pc, C, TB, TB)
    for lo in range(0, sten.shape[0], pc):
        tgt, src = meta[0, lo:lo + pc], meta[1, lo:lo + pc]
        p1, p2, v_re, v_im = _panel_tensors(sten[lo:lo + pc],
                                            xb[src], n_bins)
        pC1 = torch.clamp(torch.ceil(p1), -n_bins, n_bins)
        pF1 = torch.clamp(torch.floor(p1), -n_bins, n_bins)
        pC2 = torch.clamp(torch.ceil(p2), -n_bins, n_bins)
        pF2 = torch.clamp(torch.floor(p2), -n_bins, n_bins)
        w0 = (pC1 - p1) * (pC2 - p2)
        w1 = (p1 - pF1) * (p2 - pF2)
        w2 = (p1 - pF1) * (pC2 - p2)
        w3 = (pC1 - p1) * (p2 - pF2)
        aF, aC, bF, bC = ((c + n_bins).long() for c in (pF1, pC1, pF2, pC2))
        v = torch.stack([v_re, v_im], 1)                 # (pc, 2, C, TBt, TBs)
        part = x.new_zeros(*v.shape[:-1], w * w)         # (pc, 2, C, TBt, w²)
        for a, b, wt in ((aF, bF, w0), (aC, bC, w1), (aC, bF, w2),
                         (aF, bC, w3)):
            cell = (a * w + b)[:, None].expand_as(v)
            part = part.scatter_add(-1, cell, wt[:, None] * v)
        grid = grid.index_add(0, tgt, part.permute(0, 1, 4, 2, 3))
    return grid.reshape(nb_out, 2 * w * w, C, TB)


@functools.cache
def _k2_entry():
    fn = kernels.library("echo_panel_fwd").echo_panel_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, sten, meta, n_bins: int, nb_out: int):
    """Raise unless the shapes agree and x, sten (float32) and meta (int32)
    are contiguous on x's device."""
    rows, C = x.shape[0], x.shape[1]
    P, TB = sten.shape[0], sten.shape[-1]
    if x.dim() != 3 or x.shape[2] != 2 or rows != nb_out * TB \
            or tuple(sten.shape) != (P, 5, TB, TB) \
            or tuple(meta.shape) != (4, P) or n_bins not in (1, 2, 3, 4):
        raise ValueError(
            f"echo_panel_fwd shapes do not agree: x {tuple(x.shape)}, sten "
            f"{tuple(sten.shape)}, meta {tuple(meta.shape)}, nb_out {nb_out}, "
            f"n_bins {n_bins}")
    for label, t, dtype in (("x", x, torch.float32),
                            ("sten", sten, torch.float32),
                            ("meta", meta, torch.int32)):
        if t.device != x.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"echo_panel_fwd needs contiguous {dtype} "
                             f"{label} on {x.device}, got {t.dtype} on "
                             f"{t.device} (contiguous={t.is_contiguous()})")
    if x.storage_offset() % 2:
        raise ValueError("echo_panel_fwd reads x as 8-byte (re, im) pairs: "
                         "its storage must start on an 8-byte boundary")


def _echo_panel_fwd_cuda(x, sten, meta, n_bins: int, nb_out: int):
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            "panel ECHO on the card serves inference only: K2's backward "
            "(fieldconv_tpu/ops/pallas/echo_panel.py:443, _bwd_impl) is not "
            "ported yet (ROADMAP slice 4, ECHO training); run under "
            "torch.no_grad() or on the CPU")
    _check(x, sten, meta, n_bins, nb_out)
    C, TB = x.shape[1], sten.shape[-1]
    w = 2 * n_bins + 1
    fn = _k2_entry()
    out = torch.empty((nb_out, 2 * w * w, C, TB), dtype=torch.float32,
                      device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), sten.data_ptr(), meta.data_ptr(), out.data_ptr(),
             sten.shape[0], nb_out, C, TB, n_bins, stream)
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


def _check_panel(x, panel):
    if not isinstance(panel, PanelTable) or not panel.compressed:
        raise ValueError("panel ECHO needs a compressed PanelTable "
                         "(build_panel_table(compressed=True))")
    rows = x[..., 0, 0].numel()
    if rows != panel.n_mesh * panel.n_pad:
        raise ValueError(
            f"x carries {rows} rows but the panel table covers "
            f"{panel.n_mesh} mesh(es) of {panel.n_pad}")


def echo_panel_fused(x, panel: PanelTable, n_bins: int):
    """Panel ECHO through K2: (..., N, C, 2) -> (..., N, C, dS).

    panel: a compressed PanelTable covering the meshes of x's leading axes
    (one table and one launch serve a whole batch).  The kernel's w×w grid
    is folded onto the disk bins and soft_abs gives the magnitudes."""
    _check_panel(x, panel)
    lead, N, C = x.shape[:-3], x.shape[-3], x.shape[-2]
    TB = panel.tb
    w = 2 * n_bins + 1
    xf = x.reshape(-1, C, 2).contiguous()
    rows = xf.shape[0]
    grid = echo_panel_grid(xf, panel.sten, panel.meta, n_bins, rows // TB)
    # (nb, 2w², C, TB) -> (rows, C, 2, w²) -> fold -> (rows, C, dS, 2)
    grid4 = grid.permute(0, 3, 2, 1).reshape(rows, C, 2, w * w)
    hist = torch.einsum("ncpu,us->ncsp", grid4,
                        fold_matrix(n_bins, x.device))
    return soft_abs(hist).reshape(*lead, N, C, hist.shape[-2])
