"""Banded field convolution with the fused forward kernel (K1).

Counterpart of ``fieldconv_tpu/ops/pallas/band_conv.py`` for the dense
BandedTable.  The contraction runs in a hand-written CUDA kernel
(``csrc/band_fused_fwd.cu``, which replaces the TPU kernel
``_band_megaw_fwd_impl`` and its twins ``_band_fused_mega_fwd_impl`` and
``_band_fused_fwd_impl``).  :func:`band_fused_fwd` launches it for CUDA
tensors and runs the plain PyTorch version
:func:`band_fused_fwd_reference` for CPU tensors; it never moves work
between devices.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import kernels
from ..precomp.banded import BandedTable, CompressedBandedTable, window_blocks
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


def band_fused_fwd_reference(g, sten_band, wmat, tb: int, nh: int):
    """Plain PyTorch K1 forward: window_blocks on g, the stencil products,
    then einsums.

    g: (n_mesh, N, M = K·2C) k-major rotated-source tensor;
    sten_band: (n_mesh, nb, R+2K, TB, W'); wmat: (R, M, O2).
    Returns y (n_mesh, N, O2)."""
    n_mesh, N, M, R, K, C, O2 = _k1_dims(g, sten_band, wmat)
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
    contrib = torch.cat(parts, dim=-1)                     # (m, nb, R, TB, M)
    y = torch.einsum("mbrtj,rjo->mbto", contrib, wmat)
    return y.reshape(n_mesh, N, O2)


@functools.cache
def _k1_entry():
    fn = kernels.library("band_fused_fwd").band_fused_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _band_fused_fwd_cuda(g, sten_band, wmat, tb: int, nh: int):
    n_mesh, N, M, R, K, C, O2 = _k1_dims(g, sten_band, wmat)
    want = (n_mesh, N // tb, R + 2 * K, tb, (2 * nh + 1) * tb)
    if N % tb or M != 2 * K * C or tuple(sten_band.shape) != want \
            or wmat.shape[1] != M:
        raise ValueError(
            f"band_fused_fwd shapes do not agree: g {tuple(g.shape)}, "
            f"sten_band {tuple(sten_band.shape)} (want {want}), "
            f"wmat {tuple(wmat.shape)}")
    for name, t in (("g", g), ("sten_band", sten_band), ("wmat", wmat)):
        if t.device != g.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"band_fused_fwd needs contiguous float32 "
                             f"{name} on {g.device}, got {t.dtype} on "
                             f"{t.device} (contiguous={t.is_contiguous()})")
    if torch.is_grad_enabled() and (g.requires_grad or wmat.requires_grad):
        raise NotImplementedError(
            "the K1 backward kernel is not ported yet (ROADMAP Queue 2, K1 "
            "bwd); run the CUDA forward under torch.no_grad()")
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


def field_conv_banded(x, banded, zonal, spherical, phase, ftype,
                      precision: str = "f32", fuse_filters: bool = True):
    """Full field convolution over the dense banded layout:
    (..., N, C, 2) -> (..., N, O, 2).

    banded: BandedTable whose sten_band carries the same leading mesh axes
    as x.  One K1 launch serves the whole mesh batch."""
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
    y2 = band_fused_fwd(g, sten, wmat, banded.tb, banded.nh)
    O = wmat.shape[-1] // 2
    y = torch.stack([y2[..., :O], y2[..., O:]], dim=-1)
    return y.reshape(*lead, N, O, 2)
