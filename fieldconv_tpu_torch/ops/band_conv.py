"""Banded field convolution with the fused kernels (K1 forward and backward).

Counterpart of ``fieldconv_tpu/ops/pallas/band_conv.py`` for the dense
BandedTable.  The contraction runs in hand-written CUDA kernels:
``csrc/band_fused_fwd.cu`` replaces the TPU kernel ``_band_megaw_fwd_impl``
(and its twins ``_band_fused_mega_fwd_impl``, ``_band_fused_fwd_impl``),
``csrc/band_fused_bwd.cu`` replaces ``_band_megaw_bwd_impl`` (and
``_band_fused_mega_bwd_impl``, ``_band_fused_bwd``).  The wrappers
:func:`band_fused_fwd` and :func:`band_fused_bwd` launch them for CUDA
tensors and run the plain PyTorch versions :func:`band_fused_fwd_reference`
and :func:`band_fused_bwd_reference` for CPU tensors; they never move work
between devices.  :class:`_BandFusedFn` ties the two together for autograd,
as ``jax.custom_vjp`` does in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import kernels
from ..precomp.banded import (BandedTable, CompressedBandedTable,
                              unwindow_blocks, window_blocks)
from .field_conv import filter_coefficients, rotated_source_tensor


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
    """
    s = _ring_knots(R)
    hats = []
    for r in range(R):
        sl = s[r - 1] if r > 0 else -1.0
        sc = s[r]
        sr = s[r + 1] if r < R - 1 else 2.0
        up = (rv - sl) * (1.0 / (sc - sl))
        dn = (sr - rv) * (1.0 / (sr - sc))
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
    gw = window_blocks(g, tb, nh)                          # (m, nb, W', M)
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
    dg = unwindow_blocks(torch.cat(parts, dim=-1), tb, nh)
    return dg, dw


@functools.cache
def _k1_entry():
    fn = kernels.library("band_fused_fwd").band_fused_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _k1_check(name, g, sten_band, wmat, tb: int, nh: int, *more):
    """Raise unless the shapes agree and every tensor (g, sten_band, wmat
    and the named extra ones) is contiguous float32 on g's device."""
    n_mesh, N, M, R, K, C, O2 = _k1_dims(g, sten_band, wmat)
    want = (n_mesh, N // tb, R + 2 * K, tb, (2 * nh + 1) * tb)
    if N % tb or M != 2 * K * C or tuple(sten_band.shape) != want \
            or wmat.shape[1] != M:
        raise ValueError(
            f"{name} shapes do not agree: g {tuple(g.shape)}, "
            f"sten_band {tuple(sten_band.shape)} (want {want}), "
            f"wmat {tuple(wmat.shape)}")
    for label, t in (("g", g), ("sten_band", sten_band), ("wmat", wmat),
                     *more):
        if t.device != g.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous float32 {label} on "
                             f"{g.device}, got {t.dtype} on {t.device} "
                             f"(contiguous={t.is_contiguous()})")


def _band_fused_fwd_cuda(g, sten_band, wmat, tb: int, nh: int):
    _k1_check("band_fused_fwd", g, sten_band, wmat, tb, nh)
    n_mesh, N, M, R, K, C, O2 = _k1_dims(g, sten_band, wmat)
    fn = _k1_entry()
    y = torch.empty((n_mesh, N, O2), dtype=torch.float32, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = fn(g.data_ptr(), sten_band.data_ptr(), wmat.data_ptr(),
             y.data_ptr(), n_mesh, N, C, K, R, tb, nh, O2, stream)
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
    """(kernel entry, floats of scratch it needs for given sizes)."""
    lib = kernels.library("band_fused_bwd")
    fn = lib.band_fused_bwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    size = lib.band_fused_bwd_scratch_floats
    size.argtypes = [ctypes.c_int] * 8
    size.restype = ctypes.c_longlong
    return fn, size


def _band_fused_bwd_cuda(dy, g, sten_band, wmat, tb: int, nh: int):
    n_mesh, N, M, R, K, C, O2 = _k1_dims(g, sten_band, wmat)
    if tuple(dy.shape) != (n_mesh, N, O2):
        raise ValueError(f"band_fused_bwd: dy {tuple(dy.shape)}, want "
                         f"{(n_mesh, N, O2)}")
    _k1_check("band_fused_bwd", g, sten_band, wmat, tb, nh, ("dy", dy))
    fn, scratch_floats = _k1_bwd_entry()
    sizes = (n_mesh, N, C, K, R, tb, nh, O2)
    f32 = dict(dtype=torch.float32, device=g.device)
    dg = torch.empty((n_mesh, N, M), **f32)
    dw = torch.empty((R, M, O2), **f32)
    # contrib and dcontrib of every target, and the dW partial sums
    scratch = torch.empty((max(1, scratch_floats(*sizes)),), **f32)
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


def field_conv_banded(x, banded, zonal, spherical, phase, ftype,
                      precision: str = "f32", fuse_filters: bool = True):
    """Full field convolution over the dense banded layout:
    (..., N, C, 2) -> (..., N, O, 2).

    banded: BandedTable whose sten_band carries the same leading mesh axes
    as x.  One K1 launch serves the whole mesh batch, forward and
    backward (gradients flow to x and the filters, not the stencil)."""
    if isinstance(banded, CompressedBandedTable) \
            or not isinstance(banded, BandedTable):
        raise NotImplementedError(
            f"field_conv_banded over {type(banded).__name__} is not ported "
            "yet: the compressed, panel, compact and block-sparse conv "
            "kernels are ROADMAP Queue 2 items K4, K5, K6 and K8")
    if precision != "f32":
        raise NotImplementedError(
            f"precision={precision!r}: the bf16 operand path of K1 is "
            "ROADMAP Queue 2, K1 (bf16)")
    if not fuse_filters:
        raise NotImplementedError(
            "fuse_filters=False runs the unfused contrib kernel, ROADMAP "
            "Queue 2, K3")
    lead = x.shape[:-3]
    N = x.shape[-3]
    g = rotated_source_tensor_kmajor(x, banded.band_limit)
    g = g.reshape(-1, N, g.shape[-1]).contiguous()
    sten = banded.sten_band
    sten = sten.reshape(-1, *sten.shape[-4:]).contiguous()
    if sten.shape[0] != g.shape[0]:
        raise ValueError(f"x carries {g.shape[0]} meshes but the banded "
                         f"table {sten.shape[0]}")
    coeff = filter_coefficients(zonal, spherical, phase, ftype,
                                banded.band_limit)
    wmat = filters_to_wmat(coeff).contiguous()
    y2 = _BandFusedFn.apply(g, wmat, sten, banded.tb, banded.nh)
    O = wmat.shape[-1] // 2
    y = torch.stack([y2[..., :O], y2[..., O:]], dim=-1)
    return y.reshape(*lead, N, O, 2)
