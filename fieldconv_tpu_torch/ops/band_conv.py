"""Field convolution over the block layouts with the hand-written kernels:
the dense BandedTable (K1 forward and backward, and the unfused contrib K3
each way), the CompressedBandedTable (K4 forward and backward), the
BlockSparseTable (K8 forward and backward), the PanelTable (K5 forward and
backward) and the CompactPanelTable (K6 forward and backward).

Counterpart of ``fieldconv_tpu/ops/pallas/band_conv.py`` for those five
tables.  The contraction runs in hand-written CUDA kernels:
``csrc/band_fused_fwd.cu`` replaces the TPU kernel ``_band_megaw_fwd_impl``
(and its twins ``_band_fused_mega_fwd_impl``, ``_band_fused_fwd_impl``),
``csrc/band_fused_bwd.cu`` replaces ``_band_megaw_bwd_impl`` (and
``_band_fused_mega_bwd_impl``, ``_band_fused_bwd``),
``csrc/band_contrib_fwd.cu`` and ``band_contrib_bwd.cu`` replace
``_band_contrib_fwd_impl`` and ``_band_contrib_bwd`` (with its
``_shift_combine``), ``csrc/band_cfused_fwd.cu`` replaces
``_band_cfused_fwd_impl`` and ``_band_cmega_fwd_impl``,
``csrc/band_cfused_bwd.cu`` replaces ``_band_cfused_bwd`` and
``_band_cmega_bwd_impl``, ``csrc/band_sparse_fwd.cu`` replaces
``_band_sparse_fwd_impl`` and ``_band_sparse_mega_fwd_impl``,
``csrc/band_sparse_bwd.cu`` replaces ``_band_sparse_bwd_impl`` (with its
``_sparse_combine``) and ``_band_sparse_mega_bwd_impl``,
``csrc/band_panel_fwd.cu`` replaces ``_band_panel_fwd_impl`` (both of its
``pallas_call``s, bodies ``_fwd_panel_kernel`` and
``_fwd_panel_chunk_kernel``), ``csrc/band_panel_bwd.cu`` replaces
``_band_panel_bwd_impl`` (bodies ``_bwd_panel_kernel`` and
``_bwd_panel_chunk_kernel``), ``csrc/band_compact_fwd.cu`` replaces
``_band_compact_fwd_impl`` (body ``_fwd_compact_kernel``) and
``csrc/band_compact_bwd.cu`` replaces ``_band_compact_bwd_impl`` (body
``_bwd_compact_kernel``) with the fold that follows it.  The wrappers
(:func:`band_fused_fwd`, :func:`band_contrib_fwd`, :func:`band_cfused_fwd`,
:func:`band_sparse_fwd`, :func:`band_panel_fwd`, :func:`band_compact_fwd`
and their ``*_bwd``)
launch them for CUDA tensors and run the plain PyTorch versions
(``*_reference``) for CPU tensors; they never move work between devices.
:class:`_BandFusedFn`, :class:`_BandContribFn`, :class:`_BandCFusedFn`,
:class:`_BandSparseFn`, :class:`_BandPanelFn` and :class:`_BandCompactFn`
tie each kernel's two
directions together for autograd, as ``jax.custom_vjp`` does in the JAX
package.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import kernels
from ..precomp.banded import (BandedTable, BlockSparseTable,
                              CompactPanelTable, CompressedBandedTable,
                              PanelTable, unwindow_blocks, window_blocks)
from .compact_fold import compact_fold_reference
from .field_conv import (apply_filters, filter_coefficients,
                         rotated_source_tensor)


def rotated_source_tensor_kmajor(x, band_limit):
    """G[n, (k, p, c)] = x[n,c]·e^{-i k φ_{n,c}} flattened k-major for the
    kernel's contiguous per-k column panels. x: (..., N, C, 2) ->
    (..., N, K·2·C)."""
    G = rotated_source_tensor(x, band_limit)              # (..., N, C, K, 2)
    N, C, K, _ = G.shape[-4:]
    return G.movedim(-3, -1).reshape(*G.shape[:-4], N, K * 2 * C)


def filters_to_wmat(coeff):
    """Pack the planar filter bank (O, C, R, K, 2) into per-ring real
    matrices W (R, K·2C, 2O) such that

        [y_re | y_im][t] = Σ_r contrib_r[t] @ W[r]

    with contrib columns k-major as [re C | im C] per k and output columns
    [o_re O | o_im O]; the 1/K normalisation is folded in."""
    O, C, R, K, _ = coeff.shape
    wre = coeff[..., 0].permute(2, 3, 1, 0)               # (R, K, C, O)
    wim = coeff[..., 1].permute(2, 3, 1, 0)
    top = torch.cat([wre, wim], dim=-1)                   # rows p=0 (re)
    bot = torch.cat([-wim, wre], dim=-1)                  # rows p=1 (im)
    w = torch.stack([top, bot], dim=2)                    # (R, K, 2, C, 2O)
    return (w / K).reshape(R, K * 2 * C, 2 * O)


def _ring_knots(R):
    return [math.sqrt(r / (R - 1)) for r in range(R)]


def _hats_from_r(rv, R):
    """Radial interpolation weights from the normalised radius.

    rv: tensor in [0,1] (R_SENTINEL at empty slots).  Returns (R, *rv.shape)
    equal to stencil.radial_interpolant on [0,1]: ring r's weight is the hat
    on knots (s_{r-1}, s_r, s_{r+1}) with virtual knots -1 and 2 at the ends.
    The knots and slopes are rounded to rv's dtype first, as JAX rounds a
    Python float to the dtype of the array it meets (a bf16 block-panel
    lift forms its hats in bf16, from bf16 knots; no change in f32).
    """
    def const(v):
        return torch.tensor(v, dtype=rv.dtype).item()

    s = _ring_knots(R)
    hats = []
    for r in range(R):
        sl = s[r - 1] if r > 0 else -1.0
        sc = s[r]
        sr = s[r + 1] if r < R - 1 else 2.0
        up = (rv - const(sl)) * const(1.0 / (sc - sl))
        dn = (const(sr) - rv) * const(1.0 / (sr - sc))
        hats.append(torch.clamp(torch.minimum(up, dn), 0.0, 1.0))
    return torch.stack(hats, dim=0)


# --- K1 forward: plain version, wrapper, kernel launch ----------------------

def _k1_dims(g, sten_band, wmat):
    n_mesh, N, M = g.shape
    R, _, O2 = wmat.shape
    K = (sten_band.shape[2] - R) // 2
    return n_mesh, N, M, R, K, M // (2 * K), O2


def _contrib_reference(g, sten_band, R, K, C, tb, nh):
    """contrib (n_mesh, nb, R, TB, M) of every target: the window of g
    against S_k = rs ⊙ f_k, k-major columns [re C | im C] per k."""
    return _window_contrib(window_blocks(g, tb, nh), sten_band, R, K, C)


def _window_contrib(gw, sten_band, R, K, C):
    """contrib (n_mesh, nb, R, TB, M) of the targets of blocks whose
    window rows of g are gw (n_mesh, nb, W', M)."""
    rs = sten_band[:, :, :R]                               # (m, nb, R, TB, W')
    parts = []
    for k in range(K):
        fre = sten_band[:, :, R + 2 * k, None]             # (m, nb, 1, TB, W')
        fim = sten_band[:, :, R + 2 * k + 1, None]
        gk = gw[..., k * 2 * C:(k + 1) * 2 * C]            # (m, nb, W', 2C)
        a = torch.einsum("mbrtw,mbwc->mbrtc", rs * fre, gk)
        b = torch.einsum("mbrtw,mbwc->mbrtc", rs * fim, gk)
        parts += [a[..., :C] - b[..., C:], a[..., C:] + b[..., :C]]
    return torch.cat(parts, dim=-1)


def band_fused_fwd_reference(g, sten_band, wmat, tb: int, nh: int):
    """Plain PyTorch K1 forward: window_blocks on g, the stencil products,
    then einsums.

    g: (n_mesh, N, M = K·2C) k-major rotated-source tensor;
    sten_band: (n_mesh, nb, R+2K, TB, W'); wmat: (R, M, O2).
    Returns y (n_mesh, N, O2)."""
    n_mesh, N, M, R, K, C, O2 = _k1_dims(g, sten_band, wmat)
    contrib = _contrib_reference(g, sten_band, R, K, C, tb, nh)
    y = torch.einsum("mbrtj,rjo->mbto", contrib, wmat)
    return y.reshape(n_mesh, N, O2)


def _contrib_transpose_reference(dcon, sten_band, R, K, C, tb, nh):
    """dG (n_mesh, N, M) from the contrib cotangent dcon (n_mesh, nb, R, TB,
    M): the window rows gather S_kᵀ · [d_re | d_im ; d_im | −d_re], S_k =
    rs ⊙ f_k, and the overlapping windows fold back onto g's rows; window
    rows outside [0, N) take no gradient."""
    return unwindow_blocks(_window_transpose(dcon, sten_band, R, K, C), tb,
                           nh)


def _window_transpose(dcon, sten_band, R, K, C):
    """The window rows' dG (n_mesh, nb, W', M) from the contrib cotangent
    dcon (n_mesh, nb, R, TB, M): S_kᵀ · [d_re | d_im ; d_im | −d_re]."""
    rs = sten_band[:, :, :R]

    def st(s, d):                                          # S_kᵀ · d
        return torch.einsum("mbrtw,mbrtc->mbwc", s, d)

    parts = []
    for k in range(K):
        s_re = rs * sten_band[:, :, R + 2 * k, None]       # (m, nb, R, TB, W')
        s_im = rs * sten_band[:, :, R + 2 * k + 1, None]
        d_re = dcon[..., 2 * k * C:(2 * k + 1) * C]        # (m, nb, R, TB, C)
        d_im = dcon[..., (2 * k + 1) * C:(2 * k + 2) * C]
        parts += [st(s_re, d_re) + st(s_im, d_im),
                  st(s_re, d_im) - st(s_im, d_re)]
    return torch.cat(parts, dim=-1)


def band_fused_bwd_reference(dy, g, sten_band, wmat, tb: int, nh: int):
    """Plain PyTorch K1 backward, written out (not taken from autograd):
    contrib is rematerialised as the forward forms it, then

        dW       = Σ_meshes Σ_targets contrib_rᵀ · dy     (W is shared)
        dcontrib = dy · W_rᵀ
        dG window += S_kᵀ · [d_re | d_im ; d_im | −d_re],  S_k = rs ⊙ f_k

    and the overlapping windows fold back onto g's rows; window rows
    outside [0, N) take no gradient.  dy: (n_mesh, N, O2), other shapes as
    in :func:`band_fused_fwd_reference`.  Returns (dg, dw)."""
    n_mesh, N, M, R, K, C, O2 = _k1_dims(g, sten_band, wmat)
    contrib = _contrib_reference(g, sten_band, R, K, C, tb, nh)
    dyb = dy.reshape(n_mesh, N // tb, tb, O2)
    dw = torch.einsum("mbrtj,mbto->rjo", contrib, dyb)
    dcon = torch.einsum("mbto,rjo->mbrtj", dyb, wmat)      # (m, nb, R, TB, M)
    dg = _contrib_transpose_reference(dcon, sten_band, R, K, C, tb, nh)
    return dg, dw


@functools.cache
def _k1_entry():
    """The kernel entry of csrc/band_fused_fwd.cu."""
    fn = kernels.library("band_fused_fwd").band_fused_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _scratch_floats(name: str, device, *sizes) -> int:
    """Floats of scratch the kernel of csrc/<name>.cu takes at these sizes
    (its ``<name>_scratch_floats``, ints) on a device: asked of its library
    once a shape and device, not once a call (the calls of a small request
    or step are host-bound).  Raises (and so caches nothing) where the
    library takes no such shape or cannot read the device."""
    size = getattr(kernels.library(name), f"{name}_scratch_floats")
    size.argtypes = [ctypes.c_int] * len(sizes)
    size.restype = ctypes.c_longlong
    floats = size(*sizes)
    if floats <= 0:
        raise RuntimeError(f"{name} takes no shape {sizes} on device "
                           f"{device}")
    return floats


def _band_check(name, dims, sten_band, tb: int, nh: int, planes: int, K: int,
                *tensors):
    """Raise unless sten_band is (n_mesh, N/tb, planes, tb, W') for dims
    (n_mesh, N, M), with M a multiple of 2K, and every named tensor (label,
    tensor) is contiguous float32 on the first one's device."""
    n_mesh, N, M = dims
    want = (n_mesh, N // tb, planes, tb, (2 * nh + 1) * tb)
    if N % tb or M % (2 * K) or tuple(sten_band.shape) != want:
        raise ValueError(
            f"{name} shapes do not agree: (n_mesh, N, M) {tuple(dims)}, "
            f"sten_band {tuple(sten_band.shape)} (want {want})")
    dev = tensors[0][1].device
    for label, t in tensors:
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous float32 {label} on "
                             f"{dev}, got {t.dtype} on {t.device} "
                             f"(contiguous={t.is_contiguous()})")


def _band_shapes(name, C: int, K: int, R: int):
    """Raise for shapes the banded kernels (K1, K3, K4) have no
    instantiation for: K ≤ 3 with R ≤ 8, or K = 5 with R ≤ 6; C ≤ 256."""
    if K > 5 or R > (8 if K <= 3 else 6) or C > 256:
        raise NotImplementedError(
            f"{name} takes K ≤ 3 with R ≤ 8 or K = 5 with R ≤ 6, and C ≤ "
            f"256; got K={K}, R={R}, C={C}")


def _k1_check(name, g, sten_band, wmat, tb: int, nh: int, *more):
    """Raise unless the shapes agree and every tensor (g, sten_band, wmat
    and the named extra ones) is contiguous float32 on g's device."""
    n_mesh, N, M, R, K, C, O2 = _k1_dims(g, sten_band, wmat)
    if wmat.shape[1] != M:
        raise ValueError(f"{name}: wmat {tuple(wmat.shape)} does not take "
                         f"g's {M} columns")
    _band_check(name, g.shape, sten_band, tb, nh, R + 2 * K, K, ("g", g),
                ("sten_band", sten_band), ("wmat", wmat), *more)


def _band_fused_fwd_cuda(g, sten_band, wmat, tb: int, nh: int):
    _k1_check("band_fused_fwd", g, sten_band, wmat, tb, nh)
    n_mesh, N, M, R, K, C, O2 = _k1_dims(g, sten_band, wmat)
    fn = _k1_entry()
    sizes = (n_mesh, N, C, K, R, tb, nh, O2)
    y = torch.empty((n_mesh, N, O2), dtype=torch.float32, device=g.device)
    # contrib of every target row, which the filter then contracts with W,
    # and the band's occupancy bytes
    floats = _scratch_floats("band_fused_fwd", g.device.index, *sizes)
    scratch = torch.empty((floats,), dtype=torch.float32, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = fn(g.data_ptr(), sten_band.data_ptr(), wmat.data_ptr(),
             y.data_ptr(), scratch.data_ptr(), *sizes, stream)
    if err != 0:
        raise RuntimeError(f"band_fused_fwd launch failed: cudaError {err}")
    kernels.launches["band_fused_fwd"] += 1
    return y


def band_fused_fwd(g, sten_band, wmat, tb: int, nh: int):
    """K1 forward y (n_mesh, N, O2) = Σ_r contrib_r · W_r over the banded
    window (shapes as in :func:`band_fused_fwd_reference`).

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (building it on first use) or raise."""
    if g.device.type == "cpu":
        return band_fused_fwd_reference(g, sten_band, wmat, tb, nh)
    if g.device.type == "cuda":
        return _band_fused_fwd_cuda(g, sten_band, wmat, tb, nh)
    raise ValueError(f"band_fused_fwd has no kernel for device {g.device}")


@functools.cache
def _k1_bwd_entry():
    """The kernel entry of csrc/band_fused_bwd.cu."""
    fn = kernels.library("band_fused_bwd").band_fused_bwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _band_fused_bwd_cuda(dy, g, sten_band, wmat, tb: int, nh: int):
    n_mesh, N, M, R, K, C, O2 = _k1_dims(g, sten_band, wmat)
    if tuple(dy.shape) != (n_mesh, N, O2):
        raise ValueError(f"band_fused_bwd: dy {tuple(dy.shape)}, want "
                         f"{(n_mesh, N, O2)}")
    _k1_check("band_fused_bwd", g, sten_band, wmat, tb, nh, ("dy", dy))
    fn = _k1_bwd_entry()
    sizes = (n_mesh, N, C, K, R, tb, nh, O2)
    f32 = dict(dtype=torch.float32, device=g.device)
    dg = torch.empty((n_mesh, N, M), **f32)
    dw = torch.empty((R, M, O2), **f32)
    # contrib, then dcontrib, of every target, the dW partial sums and the
    # band's occupancy bytes
    floats = _scratch_floats("band_fused_bwd", g.device.index, *sizes)
    scratch = torch.empty((floats,), **f32)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = fn(dy.data_ptr(), g.data_ptr(), sten_band.data_ptr(),
             wmat.data_ptr(), dg.data_ptr(), dw.data_ptr(), scratch.data_ptr(),
             *sizes, stream)
    if err != 0:
        raise RuntimeError(f"band_fused_bwd launch failed: cudaError {err}")
    kernels.launches["band_fused_bwd"] += 1
    return dg, dw


def band_fused_bwd(dy, g, sten_band, wmat, tb: int, nh: int):
    """K1 backward (dg, dw) for the output cotangent dy (n_mesh, N, O2)
    (shapes as in :func:`band_fused_bwd_reference`).

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (building it on first use) or raise."""
    if g.device.type == "cpu":
        return band_fused_bwd_reference(dy, g, sten_band, wmat, tb, nh)
    if g.device.type == "cuda":
        return _band_fused_bwd_cuda(dy, g, sten_band, wmat, tb, nh)
    raise ValueError(f"band_fused_bwd has no kernel for device {g.device}")


class _BandFusedFn(torch.autograd.Function):
    """K1 with its hand-written backward: the counterpart of the JAX
    package's ``_band_fused_megaw`` custom VJP.  Keeps g, wmat and the
    stencil for the backward, which rematerialises contrib; the stencil
    takes no gradient."""

    @staticmethod
    def forward(ctx, g, wmat, sten_band, tb: int, nh: int):
        ctx.save_for_backward(g, wmat, sten_band)
        ctx.tb, ctx.nh = tb, nh
        return band_fused_fwd(g, sten_band, wmat, tb, nh)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        g, wmat, sten_band = ctx.saved_tensors
        dg, dw = band_fused_bwd(dy.contiguous(), g, sten_band, wmat, ctx.tb,
                                ctx.nh)
        return dg, dw, None, None, None


# --- K5 forward: plain version, wrapper, kernel launch -----------------------

def _phasor_pairs(fr, fi, pr, pi, B: int):
    """(column k + B, f_re, f_im) for f_k = wxp·e^{ikθ}, k = -B..B, built by
    repeated multiplication with the unit phasor (pr, pi), in the JAX
    package's order (``_phasor_pairs``)."""
    out = [(B, fr, fi)]
    cp = cm = (fr, fi)
    for kk in range(1, B + 1):
        cp = (cp[0] * pr - cp[1] * pi, cp[0] * pi + cp[1] * pr)
        cm = (cm[0] * pr + cm[1] * pi, cm[1] * pr - cm[0] * pi)
        out += [(B + kk, *cp), (B - kk, *cm)]
    return out


def _panel_pairs(sten_c, R: int, K: int, compressed: bool):
    """Radial hats (R, pc, TB, TB) and the angular factors [(k, f_re,
    f_im)] of a chunk of panels (pc, planes, TB, TB): rebuilt from the r
    and phasor planes of a compressed stencil, read from the planes of a
    dense one.  The chunk is cast to f32 on read (a bf16 table, cast by
    ``precomp/banded.py::cast_panel_sten``), as the JAX package's
    ``_panel_pairs`` casts each plane, and as the kernels read it."""
    sten_c = sten_c.float()
    if compressed:
        hats = _hats_from_r(sten_c[:, 0], R)
        pairs = _phasor_pairs(sten_c[:, 3], sten_c[:, 4], sten_c[:, 1],
                              sten_c[:, 2], K // 2)
    else:
        hats = sten_c[:, :R].movedim(1, 0)
        pairs = [(k, sten_c[:, R + 2 * k], sten_c[:, R + 2 * k + 1])
                 for k in range(K)]
    return hats, pairs


def _panel_contrib_reference(rows, sten, tgt, nb_out: int, M: int, R: int,
                             K: int, compressed: bool):
    """contrib (nb_out, R, TBt, M) of every target over a run of panels
    (P, planes, TBt, TS), 256 panels at a time: panel p of target block
    tgt[p] against its source rows ``rows(lo, hi)`` ((hi − lo, TS, M), one
    per column), S_k = hats_r ⊙ f_k (planar complex):

        contrib[tgt, r, t, k-pair] += Σ_s S_k[r, t, s] ⊗ rows[s, k]
    """
    C = M // (2 * K)
    contrib = sten.new_zeros(nb_out, R, sten.shape[2], M,
                             dtype=torch.float32)
    pc = 256                   # panels per step
    for lo in range(0, sten.shape[0], pc):
        hats, pairs = _panel_pairs(sten[lo:lo + pc], R, K, compressed)
        gs = rows(lo, lo + pc)                             # (pc, TS, M)
        parts = [None] * (2 * K)
        for k, fre, fim in pairs:
            gk = gs[..., k * 2 * C:(k + 1) * 2 * C]
            pa = torch.einsum("rpts,psc->prtc", hats * fre[None], gk)
            pb = torch.einsum("rpts,psc->prtc", hats * fim[None], gk)
            parts[2 * k] = pa[..., :C] - pb[..., C:]
            parts[2 * k + 1] = pa[..., C:] + pb[..., :C]
        contrib.index_add_(0, tgt[lo:lo + pc], torch.cat(parts, dim=-1))
    return contrib


def band_panel_fwd_reference(g, wmat, sten, meta, tb: int, n_rings: int,
                             band_limit: int, compressed: bool,
                             n_out=None):
    """Plain PyTorch K5 forward: what ``_fwd_panel_kernel`` (and its chunked
    twin) computes, 256 panels at a time so that the temporaries stay small
    (~0.3 GB at C = 32, TB = 128).

    g: (N, M = K·2C) k-major rotated-source tensor; wmat: (R, M, O2)
    (filters_to_wmat, 1/K inside); sten: (P, planes, TB, TB) panels, rows
    the target slot t, columns the source slot s, planes 5 (compressed: r,
    e^{iθ} re/im, wxp re/im) or R+2K (dense: hats, then fwxp_k re/im);
    meta: (4, P) int32 rows (tgt, src, first, last), sorted by target.
    For each panel, with S_k = hats_r ⊙ f_k (planar complex):

        contrib[tgt, r, t, k-pair] += Σ_s S_k[r, t, s] ⊗ g[src·TB + s, k]

    then y[tgt·TB + t] = Σ_r contrib[tgt, r, t] · W_r.  Returns y (n_out,
    O2), n_out = N by default; a target block without panels gets zeros."""
    N, M = g.shape
    n_out = N if n_out is None else n_out
    gb = g.reshape(-1, tb, M)
    meta = meta.long()
    contrib = _panel_contrib_reference(
        lambda lo, hi: gb[meta[1, lo:hi]], sten, meta[0], n_out // tb, M,
        n_rings, 2 * band_limit + 1, compressed)
    y = torch.einsum("brtj,rjo->bto", contrib, wmat)
    return y.reshape(n_out, wmat.shape[-1])


@functools.cache
def _k5_entry():
    """(kernel entry, floats of scratch it needs for given sizes)."""
    lib = kernels.library("band_panel_fwd")
    fn = lib.band_panel_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    size = lib.band_panel_fwd_scratch_floats
    size.argtypes = [ctypes.c_int] * 5
    size.restype = ctypes.c_longlong
    return fn, size


STEN_DTYPES = (torch.float32, torch.bfloat16)


def _is_bf16(sten) -> int:
    """The kernels' sten_bf16 flag: 1 for a bf16 panel stencil."""
    return int(sten.dtype == torch.bfloat16)


def _k5_check(name, g, wmat, sten, meta, tb, n_rings, band_limit,
              compressed, n_out, *more, ts=None):
    """Raise unless the shapes agree and g, wmat (float32), sten (float32
    or bfloat16), meta (int32) and the named extra tensors are contiguous
    on g's device, and unless one of the kernel's instantiations takes
    (K, R): K ≤ 5 with R ≤ 6 (K ≤ 3 with R ≤ 3 or ≤ 6, the correspondence
    and MATCHING presets', and K = 5 with R ≤ 6).  Panels are (tb, ts)
    slots, ts = tb by default (K6's are rectangular)."""
    N, M = g.shape
    R, K = n_rings, 2 * band_limit + 1
    planes = 5 if compressed else R + 2 * K
    P = sten.shape[0]
    ts = tb if ts is None else ts
    if M % (2 * K) or tuple(wmat.shape[:2]) != (R, M) \
            or tuple(sten.shape) != (P, planes, tb, ts) \
            or tuple(meta.shape) != (4, P) or n_out % tb or N % tb:
        raise ValueError(
            f"{name} shapes do not agree: g {tuple(g.shape)}, wmat "
            f"{tuple(wmat.shape)}, sten {tuple(sten.shape)} (want "
            f"({P}, {planes}, {tb}, {ts})), meta {tuple(meta.shape)}, "
            f"n_out {n_out}")
    for label, t, dtype in (("g", g, torch.float32),
                            ("wmat", wmat, torch.float32),
                            ("sten", sten, STEN_DTYPES),
                            ("meta", meta, torch.int32), *more):
        dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
        if t.device != g.device or t.dtype not in dtypes \
                or not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous {dtype} {label} on "
                             f"{g.device}, got {t.dtype} on {t.device} "
                             f"(contiguous={t.is_contiguous()})")
    if R > 6 or K > 5:
        raise NotImplementedError(
            f"{name}'s kernel takes K ≤ 5 with R ≤ 6 (the presets' shapes), "
            f"got K={K}, R={R}")


def _band_panel_fwd_cuda(g, wmat, sten, meta, tb, n_rings, band_limit,
                         compressed, n_out):
    _k5_check("band_panel_fwd", g, wmat, sten, meta, tb, n_rings,
              band_limit, compressed, n_out)
    O2 = wmat.shape[-1]
    K = 2 * band_limit + 1
    C = g.shape[1] // (2 * K)
    fn, scratch_floats = _k5_entry()
    y = torch.empty((n_out, O2), dtype=torch.float32, device=g.device)
    # contrib of every target row, which the filter then contracts with W
    scratch = torch.empty(
        (max(1, scratch_floats(n_out // tb, C, K, n_rings, tb)),),
        dtype=torch.float32, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = fn(g.data_ptr(), wmat.data_ptr(), sten.data_ptr(), meta.data_ptr(),
             y.data_ptr(), scratch.data_ptr(), sten.shape[0], n_out // tb, C,
             K, n_rings, tb, O2, int(compressed), g.shape[0] // tb,
             _is_bf16(sten), stream)
    if err != 0:
        raise RuntimeError(f"band_panel_fwd launch failed: cudaError {err}")
    kernels.launches["band_panel_fwd"] += 1
    return y


def band_panel_fwd(g, wmat, sten, meta, tb: int, n_rings: int,
                   band_limit: int, compressed: bool, n_out=None):
    """K5 forward y (n_out, O2) over a PanelTable's panels (shapes as in
    :func:`band_panel_fwd_reference`).

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (building it on first use) or raise.  Gradients go through
    :class:`_BandPanelFn`.  The stencil is float32 or bfloat16
    (``precomp/banded.py::cast_panel_sten``), read as f32 on both
    devices."""
    n_out = g.shape[0] if n_out is None else n_out
    if g.device.type == "cpu":
        return band_panel_fwd_reference(g, wmat, sten, meta, tb, n_rings,
                                        band_limit, compressed, n_out)
    if g.device.type == "cuda":
        return _band_panel_fwd_cuda(g, wmat, sten, meta, tb, n_rings,
                                    band_limit, compressed, n_out)
    raise ValueError(f"band_panel_fwd has no kernel for device {g.device}")


# --- K5 backward: plain version, wrapper, kernel launch ----------------------

def band_panel_bwd_reference(dy, g, wmat, sten, meta_s, tb: int,
                             n_rings: int, band_limit: int,
                             compressed: bool):
    """Plain PyTorch K5 backward, written out (not taken from autograd):
    what ``_bwd_panel_kernel`` (and its chunked twin) computes, walking the
    by-source panel order ``meta_s`` (4, P_s) rows (pid, tgt, src, first_s
    + 2·last_s) 256 panels at a time.  For each panel, with S_k = hats_r ⊙
    f_k of stencil panel pid, target block tgt and source block src:

        dc         = dy[tgt] · W_rᵀ                 (per ring)
        dW        += pcᵀ · dy[tgt],  pc the panel's partial contrib
        dG[src]   += Σ_r Σ_k S_kᵀ · [d_re | d_im ; d_im | −d_re]

    dy: (n_out, O2); other shapes as in :func:`band_panel_fwd_reference`.
    Returns (dg (N, M), dw (R, M, O2)); a source block without panels gets
    zeros in dg (the Pallas kernel leaves it unwritten)."""
    N, M = g.shape
    R, K = n_rings, 2 * band_limit + 1
    gb = g.reshape(-1, tb, M)
    dyb = dy.reshape(-1, tb, dy.shape[-1])
    meta_s = meta_s.long()
    dgb = g.new_zeros(N // tb, tb, M)
    dw = g.new_zeros(wmat.shape)
    pc = 256                   # panels per step
    for lo in range(0, meta_s.shape[1], pc):
        pid, tgt, src = meta_s[:3, lo:lo + pc]
        dys = dyb[tgt]
        dwp, dgp = _panel_bwd_chunk(sten[pid], gb[src], dys, wmat, R, K,
                                    compressed)
        dw += dwp
        dgb.index_add_(0, src, dgp)
    return dgb.reshape(N, M), dw


def _panel_bwd_chunk(sten_c, gs, dys, wmat, R: int, K: int,
                     compressed: bool):
    """One chunk of panels (pc, planes, TBt, TS) of the panel convs' plain
    backwards: each panel against its source rows gs (pc, TS, M) and its
    target rows' cotangent dys (pc, TBt, O2), S_k = hats_r ⊙ f_k:

        dc  = dys · W_rᵀ                                    (per ring)
        dW  = Σ_panels pcᵀ · dys,  pc the panel's partial contrib
        dG  = Σ_r Σ_k S_kᵀ · [d_re | d_im ; d_im | −d_re]   (per panel)

    Returns (dW (R, M, O2), dG (pc, TS, M))."""
    C = gs.shape[-1] // (2 * K)
    hats, pairs = _panel_pairs(sten_c, R, K, compressed)
    dcon = torch.einsum("pto,rjo->prtj", dys, wmat)        # (pc, R, TB, M)
    parts, dparts = [None] * (2 * K), [None] * (2 * K)
    for k, fre, fim in pairs:
        s_re, s_im = hats * fre[None], hats * fim[None]    # (R, pc, T, S)
        gk = gs[..., k * 2 * C:(k + 1) * 2 * C]
        pa = torch.einsum("rpts,psc->prtc", s_re, gk)
        pb = torch.einsum("rpts,psc->prtc", s_im, gk)
        parts[2 * k] = pa[..., :C] - pb[..., C:]
        parts[2 * k + 1] = pa[..., C:] + pb[..., :C]
        d = dcon[..., k * 2 * C:(k + 1) * 2 * C]          # (pc, R, T, 2C)
        p1 = torch.einsum("rpts,prtc->psc", s_re, d)
        p2 = torch.einsum("rpts,prtc->psc", s_im, d)
        dparts[2 * k] = p1[..., :C] + p2[..., C:]
        dparts[2 * k + 1] = p1[..., C:] - p2[..., :C]
    return (torch.einsum("prtj,pto->rjo", torch.cat(parts, dim=-1), dys),
            torch.cat(dparts, dim=-1))


@functools.cache
def _k5_bwd_entry():
    """(kernel entry, floats of scratch it needs for given sizes)."""
    lib = kernels.library("band_panel_bwd")
    fn = lib.band_panel_bwd
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 11
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    size = lib.band_panel_bwd_scratch_floats
    size.argtypes = [ctypes.c_int] * 8
    size.restype = ctypes.c_longlong
    return fn, size


def _band_panel_bwd_cuda(dy, g, wmat, sten, meta, meta_s, tb, n_rings,
                         band_limit, compressed):
    n_out, O2 = dy.shape
    _k5_check("band_panel_bwd", g, wmat, sten, meta, tb, n_rings,
              band_limit, compressed, n_out, ("dy", dy, torch.float32),
              ("meta_s", meta_s, torch.int32))
    if meta_s.dim() != 2 or meta_s.shape[0] != 4 or O2 != wmat.shape[-1]:
        raise ValueError(f"band_panel_bwd: meta_s {tuple(meta_s.shape)}, "
                         f"dy {tuple(dy.shape)}, wmat {tuple(wmat.shape)}")
    N, M = g.shape
    K = 2 * band_limit + 1
    fn, scratch_floats = _k5_bwd_entry()
    sizes = (n_out // tb, N // tb, M // (2 * K), K, n_rings, tb, O2,
             int(compressed))
    f32 = dict(dtype=torch.float32, device=g.device)
    dg = torch.empty((N, M), **f32)
    dw = torch.empty(tuple(wmat.shape), **f32)
    # contrib, then dcontrib, of every target row, and the dW partial sums
    scratch = torch.empty((max(1, scratch_floats(*sizes)),), **f32)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = fn(dy.data_ptr(), g.data_ptr(), wmat.data_ptr(), sten.data_ptr(),
             meta.data_ptr(), meta_s.data_ptr(), dg.data_ptr(), dw.data_ptr(),
             scratch.data_ptr(), sten.shape[0], meta_s.shape[1], *sizes,
             _is_bf16(sten), stream)
    if err != 0:
        raise RuntimeError(f"band_panel_bwd launch failed: cudaError {err}")
    kernels.launches["band_panel_bwd"] += 1
    return dg, dw


def band_panel_bwd(dy, g, wmat, sten, meta, meta_s, tb: int, n_rings: int,
                   band_limit: int, compressed: bool):
    """K5 backward (dg (N, M), dw (R, M, O2)) for the output cotangent dy
    (n_out, O2) (shapes as in :func:`band_panel_bwd_reference`).

    CPU tensors run the plain version, which walks meta_s alone; CUDA
    tensors launch the kernel (building it on first use) or raise.  The
    kernel also takes the table's target order ``meta``, over which it
    rematerialises contrib as the forward forms it."""
    if g.device.type == "cpu":
        return band_panel_bwd_reference(dy, g, wmat, sten, meta_s, tb,
                                        n_rings, band_limit, compressed)
    if g.device.type == "cuda":
        return _band_panel_bwd_cuda(dy, g, wmat, sten, meta, meta_s, tb,
                                    n_rings, band_limit, compressed)
    raise ValueError(f"band_panel_bwd has no kernel for device {g.device}")


class _BandPanelFn(torch.autograd.Function):
    """K5 with its hand-written backward: the counterpart of the JAX
    package's ``_band_panel`` custom VJP.  Keeps g, wmat, the stencil and
    both panel orders for the backward, which rematerialises contrib; the
    stencil and the orders take no gradient."""

    @staticmethod
    def forward(ctx, g, wmat, sten, meta, meta_s, tb: int, n_rings: int,
                band_limit: int, compressed: bool):
        ctx.save_for_backward(g, wmat, sten, meta, meta_s)
        ctx.args = (tb, n_rings, band_limit, compressed)
        return band_panel_fwd(g, wmat, sten, meta, *ctx.args)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        g, wmat, sten, meta, meta_s = ctx.saved_tensors
        dg, dw = band_panel_bwd(dy.contiguous(), g, wmat, sten, meta, meta_s,
                                *ctx.args)
        return dg, dw, None, None, None, None, None, None, None


# --- K6 forward: plain version, wrapper, kernel launch -----------------------

def band_compact_fwd_reference(g, wmat, sten, meta, src_idx, tbt: int,
                               n_rings: int, band_limit: int, n_out=None):
    """Plain PyTorch K6 forward: what ``_band_compact`` computes, the row
    gather ``g[src_idx]`` written out (256 panels at a time) and then
    ``_fwd_compact_kernel``'s contraction (``_panel_accum_rect``).

    g: (N, M = K·2C) k-major rotated-source tensor; wmat: (R, M, O2);
    sten: (P, 5, TBt, TS) compressed panels of a CompactPanelTable, rows
    the target slot t, columns the compact column s; meta: (4, P) int32
    rows (tgt, panel id, first, last), sorted by target; src_idx: (P, TS)
    int32 source row of each column.  For each panel, with S_k = hats_r ⊙
    f_k (planar complex):

        contrib[tgt, r, t, k-pair] += Σ_s S_k[r, t, s] ⊗ g[src_idx[p, s], k]

    then y[tgt·TBt + t] = Σ_r contrib[tgt, r, t] · W_r.  Returns y (n_out,
    O2), n_out = N by default."""
    N, M = g.shape
    n_out = N if n_out is None else n_out
    idx = src_idx.long()
    contrib = _panel_contrib_reference(
        lambda lo, hi: g[idx[lo:hi]], sten, meta[0].long(), n_out // tbt, M,
        n_rings, 2 * band_limit + 1, True)
    y = torch.einsum("brtj,rjo->bto", contrib, wmat)
    return y.reshape(n_out, wmat.shape[-1])


@functools.cache
def _k6_entry():
    """(kernel entry, floats of scratch it needs for given sizes)."""
    lib = kernels.library("band_compact_fwd")
    fn = lib.band_compact_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    size = lib.band_compact_fwd_scratch_floats
    size.argtypes = [ctypes.c_int] * 5
    size.restype = ctypes.c_longlong
    return fn, size


def _band_compact_fwd_cuda(g, wmat, sten, meta, src_idx, tbt, n_rings,
                           band_limit, n_out):
    N, M = g.shape
    P, TS = sten.shape[0], sten.shape[-1]
    _k5_check("band_compact_fwd", g, wmat, sten, meta, tbt, n_rings,
              band_limit, True, n_out, ("src_idx", src_idx, torch.int32),
              ts=TS)
    if tuple(src_idx.shape) != (P, TS):
        raise ValueError(f"band_compact_fwd: src_idx {tuple(src_idx.shape)}"
                         f" for {P} panels of {TS} columns")
    if tbt > 128 or TS > 128:
        raise NotImplementedError(
            f"band_compact_fwd's kernel takes panels of at most 128 × 128 "
            f"slots, got TBt={tbt}, TS={TS}")
    O2 = wmat.shape[-1]
    K = 2 * band_limit + 1
    C = M // (2 * K)
    fn, scratch_floats = _k6_entry()
    y = torch.empty((n_out, O2), dtype=torch.float32, device=g.device)
    # contrib of every target row, which the filter then contracts with W
    scratch = torch.empty(
        (max(1, scratch_floats(n_out // tbt, C, K, n_rings, tbt)),),
        dtype=torch.float32, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = fn(g.data_ptr(), wmat.data_ptr(), sten.data_ptr(), meta.data_ptr(),
             src_idx.data_ptr(), y.data_ptr(), scratch.data_ptr(), P,
             n_out // tbt, C, K, n_rings, tbt, TS, O2, N, _is_bf16(sten),
             stream)
    if err != 0:
        raise RuntimeError(f"band_compact_fwd launch failed: cudaError {err}")
    kernels.launches["band_compact_fwd"] += 1
    return y


def band_compact_fwd(g, wmat, sten, meta, src_idx, tbt: int, n_rings: int,
                     band_limit: int, n_out=None):
    """K6 forward y (n_out, O2) over a CompactPanelTable's panels (shapes as
    in :func:`band_compact_fwd_reference`).

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (building it on first use) or raise.  Gradients go through
    :class:`_BandCompactFn`.  The stencil is float32 or bfloat16, read as
    f32 on both devices."""
    n_out = g.shape[0] if n_out is None else n_out
    if g.device.type == "cpu":
        return band_compact_fwd_reference(g, wmat, sten, meta, src_idx, tbt,
                                          n_rings, band_limit, n_out)
    if g.device.type == "cuda":
        return _band_compact_fwd_cuda(g, wmat, sten, meta, src_idx, tbt,
                                      n_rings, band_limit, n_out)
    raise ValueError(f"band_compact_fwd has no kernel for device {g.device}")


# --- K6 backward: plain version, wrapper, kernel launch ----------------------

def band_compact_bwd_reference(dy, g, wmat, sten, meta, src_idx, tbt: int,
                               n_rings: int, band_limit: int):
    """Plain PyTorch K6 backward, written out (not taken from autograd):
    what ``_band_compact_bwd_impl`` (body ``_bwd_compact_kernel``) returns
    on the gathered rows ``g[src_idx]``, 256 panels at a time.  For each
    panel p of target block b = meta[0, p], with S_k = hats_r ⊙ f_k:

        dc               = dy[b] · W_rᵀ                 (per ring)
        dW              += pcᵀ · dy[b],  pc the panel's partial contrib
        dgg[p·TS + s]    = Σ_r Σ_k S_kᵀ · [d_re | d_im ; d_im | −d_re]

    dy: (n_out, O2); other shapes as in :func:`band_compact_fwd_reference`.
    Returns the per-panel dG blocks dgg (P·TS, M), before the fold onto
    g's rows (:func:`band_compact_bwd` folds them), and dw (R, M, O2)."""
    M = g.shape[1]
    P, TS = sten.shape[0], sten.shape[-1]
    R, K = n_rings, 2 * band_limit + 1
    idx, tgt = src_idx.long(), meta[0].long()
    dyb = dy.reshape(-1, tbt, dy.shape[-1])
    dgg = g.new_empty(P, TS, M)
    dw = g.new_zeros(wmat.shape)
    pc = 256                   # panels per step
    for lo in range(0, P, pc):
        dwp, dgg[lo:lo + pc] = _panel_bwd_chunk(
            sten[lo:lo + pc], g[idx[lo:lo + pc]], dyb[tgt[lo:lo + pc]], wmat,
            R, K, True)
        dw += dwp
    return dgg.reshape(P * TS, M), dw


@functools.cache
def _k6_bwd_entry():
    """(kernel entry, floats of scratch it needs for given sizes)."""
    lib = kernels.library("band_compact_bwd")
    fn = lib.band_compact_bwd
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    size = lib.band_compact_bwd_scratch_floats
    size.argtypes = [ctypes.c_int] * 8
    size.restype = ctypes.c_longlong
    return fn, size


def _band_compact_bwd_cuda(dy, g, wmat, sten, meta, src_idx, fold_order,
                           fold_ptr, tbt, n_rings, band_limit):
    name = "band_compact_bwd"
    n_out, O2 = dy.shape
    N, M = g.shape
    P, TS = sten.shape[0], sten.shape[-1]
    _k5_check(name, g, wmat, sten, meta, tbt, n_rings, band_limit, True,
              n_out, ("dy", dy, torch.float32),
              ("src_idx", src_idx, torch.int32),
              ("fold_order", fold_order, torch.int32),
              ("fold_ptr", fold_ptr, torch.int32), ts=TS)
    if tuple(src_idx.shape) != (P, TS) or O2 != wmat.shape[-1] \
            or tuple(fold_ptr.shape) != (N + 1,):
        raise ValueError(f"{name}: src_idx {tuple(src_idx.shape)} for {P} "
                         f"panels of {TS} columns, dy {tuple(dy.shape)}, "
                         f"wmat {tuple(wmat.shape)}, fold_ptr "
                         f"{tuple(fold_ptr.shape)} for {N} rows")
    if tbt > 32 or TS > 128:
        raise NotImplementedError(
            f"{name}'s kernel takes panels of at most 32 target rows (the "
            f"pure-panel layout's compact convs run at TBt 32) and 128 "
            f"columns, got TBt={tbt}, TS={TS}")
    K = 2 * band_limit + 1
    fn, scratch_floats = _k6_bwd_entry()
    sizes = (P, n_out // tbt, M // (2 * K), K, n_rings, tbt, TS, O2)
    f32 = dict(dtype=torch.float32, device=g.device)
    dg = torch.empty((N, M), **f32)
    dw = torch.empty(tuple(wmat.shape), **f32)
    # contrib, then dc, of every target row, the dW partial sums and the
    # per-panel dG blocks
    scratch = torch.empty((max(1, scratch_floats(*sizes)),), **f32)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = fn(dy.data_ptr(), g.data_ptr(), wmat.data_ptr(), sten.data_ptr(),
             meta.data_ptr(), src_idx.data_ptr(), fold_order.data_ptr(),
             fold_ptr.data_ptr(), dg.data_ptr(), dw.data_ptr(),
             scratch.data_ptr(), *sizes, N, _is_bf16(sten), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    kernels.launches[name] += 1
    kernels.launches["compact_fold"] += 1        # its last pass
    return dg, dw


def band_compact_bwd(dy, g, wmat, sten, meta, src_idx, fold_order, fold_ptr,
                     tbt: int, n_rings: int, band_limit: int):
    """K6 backward (dg (N, M), dw (R, M, O2)) for the output cotangent dy
    (n_out, O2) (shapes as in :func:`band_compact_bwd_reference`): the
    per-panel dG blocks folded onto g's rows through the table's fold index
    (``fold_order``, ``fold_ptr``).

    CPU tensors run the plain version and the plain fold
    (ops/compact_fold.py); CUDA tensors launch the kernel, whose last pass
    is the fold (building it on first use), or raise.  The kernel takes
    TBt ≤ 32."""
    if g.device.type == "cpu":
        dgg, dw = band_compact_bwd_reference(dy, g, wmat, sten, meta, src_idx,
                                             tbt, n_rings, band_limit)
        return compact_fold_reference(dgg, src_idx, g.shape[0]), dw
    if g.device.type == "cuda":
        return _band_compact_bwd_cuda(dy, g, wmat, sten, meta, src_idx,
                                      fold_order, fold_ptr, tbt, n_rings,
                                      band_limit)
    raise ValueError(f"band_compact_bwd has no kernel for device {g.device}")


class _BandCompactFn(torch.autograd.Function):
    """K6 with its hand-written backward: the counterpart of the JAX
    package's ``_band_compact`` custom VJP.  Keeps g, wmat, the stencil,
    meta, src_idx and the fold index for the backward, which
    rematerialises contrib; the table takes no gradient."""

    @staticmethod
    def forward(ctx, g, wmat, sten, meta, src_idx, fold_order, fold_ptr,
                tbt: int, n_rings: int, band_limit: int):
        ctx.save_for_backward(g, wmat, sten, meta, src_idx, fold_order,
                              fold_ptr)
        ctx.args = (tbt, n_rings, band_limit)
        return band_compact_fwd(g, wmat, sten, meta, src_idx, *ctx.args)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        dg, dw = band_compact_bwd(dy.contiguous(), *ctx.saved_tensors,
                                  *ctx.args)
        return dg, dw, None, None, None, None, None, None, None, None


# --- K4: K1 over the compressed banded stencil --------------------------------

def _dense_from_compressed(sten_band, n_rings: int, band_limit: int):
    """The dense band stencil (..., nb, R+2K, TB, W') that a compressed one
    (..., nb, 5, TB, W') stands for: the R radial hats of the r plane
    (:func:`_hats_from_r`), then f_k = wxp·e^{i(k−B)θ} re/im for k = 0..K−1
    (:func:`_phasor_pairs`), in the JAX kernel's order of operations."""
    sten = sten_band.movedim(-3, 0)                        # (5, ..., TB, W')
    hats = _hats_from_r(sten[0], n_rings)
    pairs = sorted(_phasor_pairs(sten[3], sten[4], sten[1], sten[2],
                                 band_limit), key=lambda p: p[0])
    return torch.stack([*hats] + [f for _, fr, fi in pairs for f in (fr, fi)],
                       dim=-3)


def _k4_dims(g, wmat, n_rings: int, band_limit: int):
    n_mesh, N, M = g.shape
    K = 2 * band_limit + 1
    return n_mesh, N, M, n_rings, K, M // (2 * K), wmat.shape[-1]


def band_cfused_reference(g, wmat, sten_band, tb: int, nh: int,
                          n_rings: int, band_limit: int):
    """Plain PyTorch K4 forward: K1's function with the stencil rebuilt
    from the compressed planes (:func:`_dense_from_compressed`).

    g: (n_mesh, N, M = K·2C); wmat: (R, M, O2); sten_band (n_mesh, nb, 5,
    TB, W') of a CompressedBandedTable.  Returns y (n_mesh, N, O2)."""
    dense = _dense_from_compressed(sten_band, n_rings, band_limit)
    return band_fused_fwd_reference(g, dense, wmat, tb, nh)


def band_cfused_bwd_reference(dy, g, wmat, sten_band, tb: int, nh: int,
                              n_rings: int, band_limit: int):
    """Plain PyTorch K4 backward (dg, dw): K1's written-out backward over
    the rebuilt stencil (shapes as in :func:`band_cfused_reference`)."""
    dense = _dense_from_compressed(sten_band, n_rings, band_limit)
    return band_fused_bwd_reference(dy, g, dense, wmat, tb, nh)


def _k4_check(name, g, wmat, sten_band, tb, nh, n_rings, band_limit, *more):
    n_mesh, N, M, R, K, C, O2 = _k4_dims(g, wmat, n_rings, band_limit)
    if tuple(wmat.shape[:2]) != (R, M):
        raise ValueError(f"{name}: wmat {tuple(wmat.shape)}, want ({R}, {M}, "
                         "O2)")
    _band_check(name, g.shape, sten_band, tb, nh, 5, K, ("g", g),
                ("sten_band", sten_band), ("wmat", wmat), *more)
    _band_shapes(name, C, K, R)
    if R > 6:
        raise NotImplementedError(
            f"{name} rebuilds at most R ≤ 6 rings (its ring knots); got "
            f"R={R}")


@functools.cache
def _k4_entry():
    """The kernel entry of csrc/band_cfused_fwd.cu."""
    fn = kernels.library("band_cfused_fwd").band_cfused_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def band_cfused_fwd(g, wmat, sten_band, tb: int, nh: int, n_rings: int,
                    band_limit: int):
    """K4 forward y (n_mesh, N, O2) over a compressed banded stencil
    (shapes as in :func:`band_cfused_reference`).

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (building it on first use) or raise."""
    if g.device.type == "cpu":
        return band_cfused_reference(g, wmat, sten_band, tb, nh, n_rings,
                                     band_limit)
    if g.device.type != "cuda":
        raise ValueError(f"band_cfused_fwd has no kernel for device "
                         f"{g.device}")
    _k4_check("band_cfused_fwd", g, wmat, sten_band, tb, nh, n_rings,
              band_limit)
    n_mesh, N, M, R, K, C, O2 = _k4_dims(g, wmat, n_rings, band_limit)
    fn = _k4_entry()
    sizes = (n_mesh, N, C, K, R, tb, nh, O2)
    y = torch.empty((n_mesh, N, O2), dtype=torch.float32, device=g.device)
    # contrib of every target row, the filter's partial sums and the
    # band's occupancy bytes
    floats = _scratch_floats("band_cfused_fwd", g.device.index, *sizes)
    scratch = torch.empty((floats,), dtype=torch.float32, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = fn(g.data_ptr(), sten_band.data_ptr(), wmat.data_ptr(),
             y.data_ptr(), scratch.data_ptr(), *sizes, stream)
    if err != 0:
        raise RuntimeError(f"band_cfused_fwd launch failed: cudaError {err}")
    kernels.launches["band_cfused_fwd"] += 1
    return y


@functools.cache
def _k4_bwd_entry():
    """The kernel entry of csrc/band_cfused_bwd.cu."""
    fn = kernels.library("band_cfused_bwd").band_cfused_bwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def band_cfused_bwd(dy, g, wmat, sten_band, tb: int, nh: int, n_rings: int,
                    band_limit: int):
    """K4 backward (dg, dw) for the output cotangent dy (n_mesh, N, O2)
    (shapes as in :func:`band_cfused_reference`).

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (building it on first use) or raise."""
    if g.device.type == "cpu":
        return band_cfused_bwd_reference(dy, g, wmat, sten_band, tb, nh,
                                         n_rings, band_limit)
    if g.device.type != "cuda":
        raise ValueError(f"band_cfused_bwd has no kernel for device "
                         f"{g.device}")
    n_mesh, N, M, R, K, C, O2 = _k4_dims(g, wmat, n_rings, band_limit)
    if tuple(dy.shape) != (n_mesh, N, O2):
        raise ValueError(f"band_cfused_bwd: dy {tuple(dy.shape)}, want "
                         f"{(n_mesh, N, O2)}")
    _k4_check("band_cfused_bwd", g, wmat, sten_band, tb, nh, n_rings,
              band_limit, ("dy", dy))
    fn = _k4_bwd_entry()
    sizes = (n_mesh, N, C, K, R, tb, nh, O2)
    f32 = dict(dtype=torch.float32, device=g.device)
    dg = torch.empty((n_mesh, N, M), **f32)
    dw = torch.empty((R, M, O2), **f32)
    # contrib, then dcontrib, of every target, the dW partial sums, W's rows
    # in dc's order and the band's occupancy bytes
    floats = _scratch_floats("band_cfused_bwd", g.device.index, *sizes)
    scratch = torch.empty((floats,), **f32)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = fn(dy.data_ptr(), g.data_ptr(), sten_band.data_ptr(),
             wmat.data_ptr(), dg.data_ptr(), dw.data_ptr(), scratch.data_ptr(),
             *sizes, stream)
    if err != 0:
        raise RuntimeError(f"band_cfused_bwd launch failed: cudaError {err}")
    kernels.launches["band_cfused_bwd"] += 1
    return dg, dw


class _BandCFusedFn(torch.autograd.Function):
    """K4 with its hand-written backward: the counterpart of the JAX
    package's ``_band_cfused`` / ``_band_cmega`` custom VJPs.  Keeps g,
    wmat and the compressed stencil; the backward rematerialises contrib."""

    @staticmethod
    def forward(ctx, g, wmat, sten_band, tb: int, nh: int, n_rings: int,
                band_limit: int):
        ctx.save_for_backward(g, wmat, sten_band)
        ctx.args = (tb, nh, n_rings, band_limit)
        return band_cfused_fwd(g, wmat, sten_band, *ctx.args)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        g, wmat, sten_band = ctx.saved_tensors
        dg, dw = band_cfused_bwd(dy.contiguous(), g, wmat, sten_band,
                                 *ctx.args)
        return dg, dw, None, None, None, None, None


# --- K8: K1 over the block-sparse band ----------------------------------------

_SPARSE_CHUNK = 64         # target blocks per step of the plain versions


def _sparse_axes(g, sten_band, nbr):
    """g (…, N, M), sten_band (…, nb, P, TB, NJ·TB) and nbr (…, nb, NJ)
    with their leading mesh axes flattened into one."""
    return (g.reshape(-1, *g.shape[-2:]),
            sten_band.reshape(-1, *sten_band.shape[-4:]),
            nbr.reshape(-1, *nbr.shape[-2:]))


def _sparse_window(g, nbr, tb: int, lo: int, hi: int):
    """The window rows (n_mesh, hi − lo, NJ·TB, M) of target blocks lo..hi
    of every mesh: panel j of block b holds the rows of source block
    nbr[m, b, j]."""
    n_mesh, N, M = g.shape
    nb = N // tb
    idx = nbr[:, lo:hi].long() + nb * torch.arange(
        n_mesh, device=nbr.device)[:, None, None]
    rows = g.reshape(n_mesh * nb, tb, M)[idx]          # (m, nc, NJ, TB, M)
    return rows.reshape(n_mesh, hi - lo, -1, M)


def band_sparse_reference(g, wmat, sten_band, nbr, tb: int, n_rings: int,
                          k_width: int):
    """Plain PyTorch K8 forward: what ``_band_sparse_fwd_impl`` and
    ``_band_sparse_mega_fwd_impl`` compute, _SPARSE_CHUNK target blocks
    at a time (~0.3 GB of temporaries at C = 32, K = 3, R = 3, NJ = 19).

    g: (…, N, M = K·2C) k-major rotated-source tensor; wmat: (R, M, O2);
    sten_band: (…, nb, R+2K, TB, NJ·TB) and nbr (…, nb, NJ) of a
    BlockSparseTable with g's leading mesh axes.  K1's contraction
    (:func:`band_fused_fwd_reference`) with slot j·TB + s of block b
    reading row nbr[b, j]·TB + s of g.  Returns y (…, N, O2)."""
    lead, (N, M) = g.shape[:-2], g.shape[-2:]
    g3, sten, nbr3 = _sparse_axes(g, sten_band, nbr)
    R, K, C, O2 = n_rings, k_width, M // (2 * k_width), wmat.shape[-1]
    nb = N // tb
    y = g3.new_empty(g3.shape[0], nb, tb, O2)
    for lo in range(0, nb, _SPARSE_CHUNK):
        hi = min(nb, lo + _SPARSE_CHUNK)
        contrib = _window_contrib(_sparse_window(g3, nbr3, tb, lo, hi),
                                  sten[:, lo:hi], R, K, C)
        y[:, lo:hi] = torch.einsum("mbrtj,rjo->mbto", contrib, wmat)
    return y.reshape(*lead, N, O2)


def band_sparse_bwd_reference(dy, g, wmat, sten_band, nbr, tb: int,
                              n_rings: int, k_width: int):
    """Plain PyTorch K8 backward, written out (not taken from autograd):
    the (dg, dw) of ``_band_sparse_bwd_impl`` followed by its
    ``_sparse_combine``, and of ``_band_sparse_mega_bwd_impl``.  Per chunk
    of target blocks contrib is rematerialised as the forward forms it,
    then

        dW        += Σ_meshes Σ_targets contrib_rᵀ · dy
        dcontrib   = dy · W_rᵀ
        part[b, j] = S_kᵀ · [d_re | d_im ; d_im | −d_re]   (panel j of b)

    and each panel's part is added onto source block nbr[b, j] (padding
    panels carry zero planes and add nothing).  dy: (…, N, O2); other
    shapes as in :func:`band_sparse_reference`.  Returns (dg (…, N, M), dw
    (R, M, O2))."""
    lead, (N, M) = g.shape[:-2], g.shape[-2:]
    g3, sten, nbr3 = _sparse_axes(g, sten_band, nbr)
    n_mesh = g3.shape[0]
    R, K, C, O2 = n_rings, k_width, M // (2 * k_width), wmat.shape[-1]
    nb = N // tb
    dyb = dy.reshape(n_mesh, nb, tb, O2)
    offs = nb * torch.arange(n_mesh, device=nbr.device)[:, None, None]
    dg = g3.new_zeros(n_mesh * nb, tb, M)
    dw = g3.new_zeros(wmat.shape)
    for lo in range(0, nb, _SPARSE_CHUNK):
        hi = min(nb, lo + _SPARSE_CHUNK)
        contrib = _window_contrib(_sparse_window(g3, nbr3, tb, lo, hi),
                                  sten[:, lo:hi], R, K, C)
        dw += torch.einsum("mbrtj,mbto->rjo", contrib, dyb[:, lo:hi])
        dcon = torch.einsum("mbto,rjo->mbrtj", dyb[:, lo:hi], wmat)
        parts = _window_transpose(dcon, sten[:, lo:hi], R, K, C)
        dg.index_add_(0, (nbr3[:, lo:hi].long() + offs).reshape(-1),
                      parts.reshape(-1, tb, M))
    return dg.reshape(*lead, N, M), dw


def _k8_check(name, g, wmat, sten_band, nbr, tb, n_rings, k_width, *more):
    """Raise unless sten_band is (n_mesh, N/tb, R+2K, tb, NJ·tb) and nbr
    (n_mesh, N/tb, NJ) for g (n_mesh, N, M), the float32 tensors (g,
    sten_band, wmat and the named extra ones) and the int32 ones (nbr and
    the named extra ones) are contiguous on g's device, and the kernels
    have an instantiation for the shape."""
    n_mesh, N, M = g.shape
    R, K = n_rings, k_width
    nj = nbr.shape[-1]
    want = (n_mesh, N // tb, R + 2 * K, tb, nj * tb)
    if N % tb or M % (2 * K) or tuple(sten_band.shape) != want \
            or tuple(nbr.shape) != (n_mesh, N // tb, nj) or nj < 1 \
            or tuple(wmat.shape[:2]) != (R, M):
        raise ValueError(
            f"{name} shapes do not agree: g {tuple(g.shape)}, sten_band "
            f"{tuple(sten_band.shape)} (want {want}), nbr "
            f"{tuple(nbr.shape)}, wmat {tuple(wmat.shape)}")
    for label, t, dtype in (("g", g, torch.float32),
                            ("sten_band", sten_band, torch.float32),
                            ("wmat", wmat, torch.float32),
                            ("nbr", nbr, torch.int32), *more):
        if t.device != g.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous {dtype} {label} on "
                             f"{g.device}, got {t.dtype} on {t.device} "
                             f"(contiguous={t.is_contiguous()})")
    _band_shapes(name, M // (2 * K), K, R)


@functools.cache
def _k8_entry():
    fn = kernels.library("band_sparse_fwd").band_sparse_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def band_sparse_fwd(g, wmat, sten_band, nbr, tb: int, n_rings: int,
                    k_width: int):
    """K8 forward y (n_mesh, N, O2) over a block-sparse stencil, g (n_mesh,
    N, M), sten_band and nbr with the same mesh axis (as in
    :func:`band_sparse_reference`).

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (building it on first use) or raise."""
    if g.device.type == "cpu":
        return band_sparse_reference(g, wmat, sten_band, nbr, tb, n_rings,
                                     k_width)
    if g.device.type != "cuda":
        raise ValueError(f"band_sparse_fwd has no kernel for device "
                         f"{g.device}")
    _k8_check("band_sparse_fwd", g, wmat, sten_band, nbr, tb, n_rings,
              k_width)
    n_mesh, N, M = g.shape
    O2 = wmat.shape[-1]
    fn = _k8_entry()
    y = torch.empty((n_mesh, N, O2), dtype=torch.float32, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = fn(g.data_ptr(), sten_band.data_ptr(), nbr.data_ptr(),
             wmat.data_ptr(), y.data_ptr(), n_mesh, N, M // (2 * k_width),
             k_width, n_rings, tb, nbr.shape[-1], O2, stream)
    if err != 0:
        raise RuntimeError(f"band_sparse_fwd launch failed: cudaError {err}")
    kernels.launches["band_sparse_fwd"] += 1
    return y


@functools.cache
def _k8_bwd_entry():
    """(kernel entry, floats of scratch it needs for given sizes)."""
    lib = kernels.library("band_sparse_bwd")
    fn = lib.band_sparse_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    size = lib.band_sparse_bwd_scratch_floats
    size.argtypes = [ctypes.c_int] * 8
    size.restype = ctypes.c_longlong
    return fn, size


def band_sparse_bwd(dy, g, wmat, sten_band, nbr, inv_ptr, inv_bj, tb: int,
                    n_rings: int, k_width: int):
    """K8 backward (dg (n_mesh, N, M), dw (R, M, O2)) for the output
    cotangent dy (n_mesh, N, O2) (shapes as in :func:`band_sparse_fwd`).

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (building it on first use) or raise.  The kernel gathers dG by source
    block through the table's inverse index (inv_ptr (n_mesh·nb + 1,),
    inv_bj; BlockSparseTable)."""
    if g.device.type == "cpu":
        return band_sparse_bwd_reference(dy, g, wmat, sten_band, nbr, tb,
                                         n_rings, k_width)
    if g.device.type != "cuda":
        raise ValueError(f"band_sparse_bwd has no kernel for device "
                         f"{g.device}")
    name = "band_sparse_bwd"
    n_mesh, N, M = g.shape
    O2 = wmat.shape[-1]
    _k8_check(name, g, wmat, sten_band, nbr, tb, n_rings, k_width,
              ("dy", dy, torch.float32), ("inv_ptr", inv_ptr, torch.int32),
              ("inv_bj", inv_bj, torch.int32))
    if tuple(dy.shape) != (n_mesh, N, O2) \
            or tuple(inv_ptr.shape) != (n_mesh * (N // tb) + 1,):
        raise ValueError(f"{name}: dy {tuple(dy.shape)}, want "
                         f"{(n_mesh, N, O2)}; inv_ptr "
                         f"{tuple(inv_ptr.shape)} for {n_mesh} mesh(es) of "
                         f"{N // tb} blocks")
    fn, scratch_floats = _k8_bwd_entry()
    sizes = (n_mesh, N, M // (2 * k_width), k_width, n_rings, tb,
             nbr.shape[-1], O2)
    f32 = dict(dtype=torch.float32, device=g.device)
    dg = torch.empty((n_mesh, N, M), **f32)
    dw = torch.empty(tuple(wmat.shape), **f32)
    # contrib, then dcontrib, of every target, the dW partial sums and the
    # band's occupancy bytes
    scratch = torch.empty((max(1, scratch_floats(*sizes)),), **f32)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = fn(dy.data_ptr(), g.data_ptr(), sten_band.data_ptr(),
             nbr.data_ptr(), inv_ptr.data_ptr(), inv_bj.data_ptr(),
             wmat.data_ptr(), dg.data_ptr(), dw.data_ptr(), scratch.data_ptr(),
             *sizes, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    kernels.launches[name] += 1
    return dg, dw


class _BandSparseFn(torch.autograd.Function):
    """K8 with its hand-written backward: the counterpart of the JAX
    package's ``_band_sparse`` custom VJP.  Keeps g, wmat and the table
    (stencil, nbr, inverse index); the backward rematerialises contrib.
    The stencil and nbr take no gradient."""

    @staticmethod
    def forward(ctx, g, wmat, sten_band, nbr, inv_ptr, inv_bj, tb: int,
                n_rings: int, k_width: int):
        ctx.save_for_backward(g, wmat, sten_band, nbr, inv_ptr, inv_bj)
        ctx.args = (tb, n_rings, k_width)
        return band_sparse_fwd(g, wmat, sten_band, nbr, *ctx.args)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        g, wmat, sten_band, nbr, inv_ptr, inv_bj = ctx.saved_tensors
        dg, dw = band_sparse_bwd(dy.contiguous(), g, wmat, sten_band, nbr,
                                 inv_ptr, inv_bj, *ctx.args)
        return dg, dw, None, None, None, None, None, None, None


# --- K3: the unfused banded contrib -------------------------------------------

def band_contrib_reference(g, sten_band, tb: int, nh: int, n_rings: int,
                           k_width: int):
    """Plain PyTorch K3 forward: K1's contrib without the filter step.

    g: (n_mesh, N, M = K·2C); sten_band (n_mesh, nb, R+2K, TB, W').
    Returns contrib (n_mesh, nb·R·TB, M) as the JAX kernel lays it out:
    row (b·R + r)·TB + t holds target t of block b, ring r; columns
    k-major, [re C | im C] per k."""
    n_mesh, N, M = g.shape
    C = M // (2 * k_width)
    con = _contrib_reference(g, sten_band, n_rings, k_width, C, tb, nh)
    return con.reshape(n_mesh, -1, M)


def band_contrib_bwd_reference(dout, sten_band, tb: int, nh: int,
                               n_rings: int, k_width: int):
    """Plain PyTorch K3 backward: dG (n_mesh, N, M) for the contrib
    cotangent dout (n_mesh, nb·R·TB, M), the shifted window partials
    already summed onto their rows (JAX's ``_shift_combine``)."""
    n_mesh, _, M = dout.shape
    nb = sten_band.shape[1]
    C = M // (2 * k_width)
    dcon = dout.reshape(n_mesh, nb, n_rings, tb, M)
    return _contrib_transpose_reference(dcon, sten_band, n_rings, k_width, C,
                                        tb, nh)


def _k3_check(name, dims, sten_band, tb, nh, n_rings, k_width, *tensors):
    _band_check(name, dims, sten_band, tb, nh, n_rings + 2 * k_width,
                k_width, *tensors, ("sten_band", sten_band))
    _band_shapes(name, dims[2] // (2 * k_width), k_width, n_rings)


@functools.cache
def _k3_entry():
    fn = kernels.library("band_contrib_fwd").band_contrib_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def band_contrib_fwd(g, sten_band, tb: int, nh: int, n_rings: int,
                     k_width: int):
    """K3 forward: contrib (n_mesh, nb·R·TB, M) (shapes and layout as in
    :func:`band_contrib_reference`).

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (building it on first use) or raise."""
    if g.device.type == "cpu":
        return band_contrib_reference(g, sten_band, tb, nh, n_rings, k_width)
    if g.device.type != "cuda":
        raise ValueError(f"band_contrib_fwd has no kernel for device "
                         f"{g.device}")
    _k3_check("band_contrib_fwd", g.shape, sten_band, tb, nh, n_rings,
              k_width, ("g", g))
    n_mesh, N, M = g.shape
    fn = _k3_entry()
    out = torch.empty((n_mesh, N * n_rings, M), dtype=torch.float32,
                      device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = fn(g.data_ptr(), sten_band.data_ptr(), out.data_ptr(), n_mesh, N,
             M // (2 * k_width), k_width, n_rings, tb, nh, stream)
    if err != 0:
        raise RuntimeError(f"band_contrib_fwd launch failed: cudaError {err}")
    kernels.launches["band_contrib_fwd"] += 1
    return out


@functools.cache
def _k3_bwd_entry():
    """(kernel entry, floats of scratch it needs for given sizes)."""
    lib = kernels.library("band_contrib_bwd")
    fn = lib.band_contrib_bwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    size = lib.band_contrib_bwd_scratch_floats
    size.argtypes = [ctypes.c_int] * 7
    size.restype = ctypes.c_longlong
    return fn, size


def band_contrib_bwd(dout, sten_band, tb: int, nh: int, n_rings: int,
                     k_width: int):
    """K3 backward: dG (n_mesh, N, M) for the contrib cotangent dout
    (n_mesh, nb·R·TB, M) (as in :func:`band_contrib_bwd_reference`).

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (building it on first use) or raise."""
    if dout.device.type == "cpu":
        return band_contrib_bwd_reference(dout, sten_band, tb, nh, n_rings,
                                          k_width)
    if dout.device.type != "cuda":
        raise ValueError(f"band_contrib_bwd has no kernel for device "
                         f"{dout.device}")
    n_mesh, rows, M = dout.shape
    N = rows // n_rings
    if rows % n_rings:
        raise ValueError(f"band_contrib_bwd: dout {tuple(dout.shape)} is not "
                         f"{n_rings} rings of targets")
    _k3_check("band_contrib_bwd", (n_mesh, N, M), sten_band, tb, nh, n_rings,
              k_width, ("dout", dout))
    fn, scratch_floats = _k3_bwd_entry()
    sizes = (n_mesh, N, M // (2 * k_width), k_width, n_rings, tb, nh)
    f32 = dict(dtype=torch.float32, device=dout.device)
    dg = torch.empty((n_mesh, N, M), **f32)
    # the cotangent in the dG pass's channel-major layout
    scratch = torch.empty((max(1, scratch_floats(*sizes)),), **f32)
    stream = torch.cuda.current_stream(dout.device).cuda_stream
    err = fn(dout.data_ptr(), sten_band.data_ptr(), dg.data_ptr(),
             scratch.data_ptr(), *sizes, stream)
    if err != 0:
        raise RuntimeError(f"band_contrib_bwd launch failed: cudaError {err}")
    kernels.launches["band_contrib_bwd"] += 1
    return dg


class _BandContribFn(torch.autograd.Function):
    """K3 with its hand-written backward: the counterpart of the JAX
    package's ``_band_contrib`` custom VJP.  Keeps the stencil; the
    stencil takes no gradient."""

    @staticmethod
    def forward(ctx, g, sten_band, tb: int, nh: int, n_rings: int,
                k_width: int):
        ctx.save_for_backward(sten_band)
        ctx.args = (tb, nh, n_rings, k_width)
        return band_contrib_fwd(g, sten_band, *ctx.args)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        (sten_band,) = ctx.saved_tensors
        dg = band_contrib_bwd(dout.contiguous(), sten_band, *ctx.args)
        return dg, None, None, None, None, None


def _mesh_stencil(g, banded):
    """g as (n_mesh, N, M) and the table's stencil as (n_mesh, nb, P, TB,
    W'), both contiguous; raises when their mesh counts differ."""
    g = g.reshape(-1, *g.shape[-2:]).contiguous()
    sten = banded.sten_band
    sten = sten.reshape(-1, *sten.shape[-4:]).contiguous()
    if sten.shape[0] != g.shape[0]:
        raise ValueError(f"x carries {g.shape[0]} meshes but the banded "
                         f"table {sten.shape[0]}")
    return g, sten


def band_contrib(g, banded: BandedTable):
    """contrib (..., N, R, C, K, 2) of the rotated-source tensor g (..., N,
    K·2C, k-major; see :func:`rotated_source_tensor_kmajor`) over a
    BandedTable whose sten_band carries g's leading mesh axes: one K3
    launch serves the batch, forward and backward."""
    lead, (N, M) = g.shape[:-2], g.shape[-2:]
    R, K, tb = banded.n_rings, 2 * banded.band_limit + 1, banded.tb
    g3, sten = _mesh_stencil(g, banded)
    out = _BandContribFn.apply(g3, sten, tb, banded.nh, R, K)
    out = out.reshape(-1, N // tb, R, tb, K, 2, M // (2 * K))
    return out.permute(0, 1, 3, 2, 6, 4, 5).reshape(*lead, N, R,
                                                    M // (2 * K), K, 2)


def field_conv_compact(x, comp: CompactPanelTable, zonal, spherical, phase,
                       ftype, precision: str = "f32"):
    """Full field convolution over a CompactPanelTable: (..., N, C, 2) ->
    (..., N, O, 2), one K6 launch for the meshes of x's leading axes (the
    table joins them, precomp.banded.concat_compact_panel_tables)."""
    if not isinstance(comp, CompactPanelTable):
        raise TypeError(f"field_conv_compact needs a CompactPanelTable, got "
                        f"{type(comp).__name__}")
    return field_conv_banded(x, comp, zonal, spherical, phase, ftype,
                             precision)


def field_conv_banded(x, banded, zonal, spherical, phase, ftype,
                      precision: str = "f32", fuse_filters: bool = True):
    """Full field convolution over a block layout: (..., N, C, 2) ->
    (..., N, O, 2).

    banded, as in the JAX package's dispatch:
    - a BandedTable whose sten_band carries the same leading mesh axes as x:
      one K1 launch serves the whole mesh batch, forward and backward
      (gradients flow to x and the filters, not the stencil); with
      fuse_filters=False one K3 launch forms contrib (:func:`band_contrib`)
      and a matrix product applies the filters
      (``ops/field_conv.py::apply_filters``), the JAX package's A/B route;
    - a CompressedBandedTable with the same leading axes: one K4 launch
      each way (:class:`_BandCFusedFn`), whatever fuse_filters says;
    - a PanelTable covering the meshes of x's leading axes: one K5 launch
      each way (:class:`_BandPanelFn`);
    - a CompactPanelTable covering them the same way: one K6 launch each
      way (:class:`_BandCompactFn`);
    - a BlockSparseTable whose sten_band and nbr carry x's leading mesh
      axes: one K8 launch each way (:class:`_BandSparseFn`).
    fuse_filters only selects among the BandedTable kernels."""
    compact = isinstance(banded, CompactPanelTable)
    if not isinstance(banded, (BandedTable, CompressedBandedTable,
                               PanelTable, CompactPanelTable,
                               BlockSparseTable)):
        raise TypeError(
            "field_conv_banded takes a BandedTable, CompressedBandedTable, "
            "PanelTable, CompactPanelTable or BlockSparseTable, got "
            f"{type(banded).__name__}")
    if precision != "f32":
        raise NotImplementedError(
            f"precision={precision!r}: the bf16 operand paths of K1 and K5 "
            "are ROADMAP Queue 2, K1 (bf16)")
    panel = compact or isinstance(banded, PanelTable)
    lead = x.shape[:-3]
    N = x.shape[-3]
    g = rotated_source_tensor_kmajor(x, banded.band_limit)
    coeff = filter_coefficients(zonal, spherical, phase, ftype,
                                banded.band_limit)
    if isinstance(banded, BandedTable) and not fuse_filters:
        return apply_filters(band_contrib(g, banded), coeff)
    wmat = filters_to_wmat(coeff).contiguous()
    if panel:
        g = g.reshape(-1, g.shape[-1]).contiguous()
        if g.shape[0] != banded.n_mesh * banded.n_pad:
            raise ValueError(
                f"x carries {g.shape[0]} rows but the panel table covers "
                f"{banded.n_mesh} mesh(es) of {banded.n_pad}")
        if compact:
            y2 = _BandCompactFn.apply(g, wmat, banded.sten, banded.meta,
                                      banded.src_idx, banded.fold_order,
                                      banded.fold_ptr, banded.tb,
                                      banded.n_rings, banded.band_limit)
        else:
            y2 = _BandPanelFn.apply(g, wmat, banded.sten, banded.meta,
                                    banded.meta_s, banded.tb,
                                    banded.n_rings, banded.band_limit,
                                    banded.compressed)
    else:
        g, sten = _mesh_stencil(g, banded)
        if isinstance(banded, BlockSparseTable):
            nbr = banded.nbr.reshape(-1, *banded.nbr.shape[-2:]).contiguous()
            y2 = _BandSparseFn.apply(g, wmat, sten, nbr, banded.inv_ptr,
                                     banded.inv_bj, banded.tb,
                                     banded.n_rings, banded.k_width)
        elif isinstance(banded, CompressedBandedTable):
            y2 = _BandCFusedFn.apply(g, wmat, sten, banded.tb, banded.nh,
                                     banded.n_rings, banded.band_limit)
        else:
            y2 = _BandFusedFn.apply(g, wmat, sten, banded.tb, banded.nh)
    O = wmat.shape[-1] // 2
    y = torch.stack([y2[..., :O], y2[..., O:]], dim=-1)
    return y.reshape(*lead, N, O, 2)
