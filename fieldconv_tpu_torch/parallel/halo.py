"""Graph-parallel field convolution with explicit halo exchange.

Counterpart of ``fieldconv_tpu/parallel/halo.py``.  Each rank of a graph
group owns a contiguous range of every mesh's vertex blocks (the leading
block axis of the banded stencil), so an edge reaches at most nh blocks
away and the only remote rows a rank needs are the nh·TB boundary rows of
its two ring neighbours: the *halo*.  Forward: exchange the boundary rows
of the rotated-source tensor G, run the band kernel over the
halo-extended rows.  Backward: the same kernel's transpose gives the
cotangents of the halo rows too, which go back to their owners and are
added there.

The kernels (K9) are K1's forward and backward over a halo-extended
source array and a range of target blocks (K1's pipelined panel walk,
``csrc/band_pipe.cuh``, on the launch's range): ``csrc/halo_fused_fwd.cu``
replaces the TPU kernels ``_halo_fused_fwd`` and ``_fused_fwd_shard``,
``csrc/halo_fused_bwd.cu`` replaces ``_halo_fused_bwd`` and
``_bwd_fused_shard`` (with their shift combines), ``csrc/halo_contrib_fwd.cu``
``_halo_fwd_impl`` and ``csrc/halo_contrib_bwd.cu`` ``_halo_bwd_impl``.
Their wrappers (:func:`halo_fused_fwd`, :func:`halo_fused_bwd`,
:func:`halo_contrib_fwd`, :func:`halo_contrib_bwd`) launch them for CUDA
tensors and run the plain versions (``*_reference``, built from K1's
window contraction in ops/band_conv.py) for CPU tensors.

:func:`halo_field_conv` picks the JAX package's path: the overlapped one
when a shard holds more than 2·nh blocks (post the exchange, run the
interior blocks, which read no halo row, wait, then the head and tail
blocks; backward: head and tail first, post the return of their halo
cotangents, then the interior), else the serial one.  dG's pieces are
added in one fixed order, so two runs give the same bits.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import kernels
from ..ops.band_conv import (_band_shapes, _scratch_floats, _window_contrib,
                             _window_transpose, filters_to_wmat)
from ..ops.field_conv import filter_coefficients
from ..precomp.banded import BandedTable
from .distributed import Axis, post_ring

# bytes this rank sent, by what: "conv" (the convs' halo rows of G),
# "conv return" (their cotangents), "rows" (the lift's and ECHO's halo
# rows, exchange_halos, and the return's backward) and "rows return"
wire_bytes: collections.Counter = collections.Counter()


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


# --- the exchange and its transpose ------------------------------------------

def _post_exchange(g, hw: int, axis: Axis, what: str):
    """Post the exchange of g's (..., N, F) boundary rows: the first hw to
    the previous rank, the last hw to the next (counted under ``what``).
    ``wait()`` gives (left, right): the previous rank's last hw rows and
    the next rank's first hw, zeros at the ends of the ring."""
    return _post(g[..., :hw, :], g[..., -hw:, :], axis, what)


def _post_return(d_left, d_right, axis: Axis, what: str):
    """Post the halo cotangents back to their owners: d_left (the previous
    rank's rows) to it, d_right to the next.  ``wait()`` gives (from the
    previous rank: our first rows' share, from the next: our last)."""
    return _post(d_left, d_right, axis, f"{what} return")


def _post(to_prev, to_next, axis: Axis, what: str):
    wire_bytes[what] += _nbytes(to_prev) * (axis.rank > 0) \
        + _nbytes(to_next) * (axis.rank < axis.size - 1)
    return post_ring(to_prev, to_next, axis)


def _add_returned(dg, pending, hw: int):
    """dg (…, N, F) plus the returned halo cotangents: the next rank's onto
    the last hw rows, then the previous rank's onto the first hw."""
    from_prev, from_next = pending.wait()
    dg[..., -hw:, :] += from_next
    dg[..., :hw, :] += from_prev
    return dg


class _ExchangeFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, hw: int, axis: Axis):
        ctx.hw, ctx.axis, ctx.shape = hw, axis, g.shape
        return _post_exchange(g, hw, axis, "rows").wait()

    @staticmethod
    def backward(ctx, d_left, d_right):
        local = d_left.new_zeros(ctx.shape)
        pending = _post_return(d_left.contiguous(), d_right.contiguous(),
                               ctx.axis, "rows")
        return _add_returned(local, pending, ctx.hw), None, None


class _ReturnFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dg_ext, hw: int, axis: Axis):
        ctx.hw, ctx.axis = hw, axis
        pending = _post_return(dg_ext[..., :hw, :], dg_ext[..., -hw:, :],
                               axis, "rows")
        return _add_returned(dg_ext[..., hw:-hw, :].clone(), pending, hw)

    @staticmethod
    def backward(ctx, d_local):
        left, right = _post_exchange(d_local.contiguous(), ctx.hw,
                                     ctx.axis, "rows").wait()
        return torch.cat([left, d_local, right], dim=-2), None, None


def exchange_halos(g, hw: int, axis: Axis):
    """(left, right) halo rows of g (..., N_local, F) over the graph axis:
    the previous rank's last hw rows and the next rank's first hw, zeros at
    the ends (the ring does not wrap).  Its backward is
    :func:`return_halos`."""
    return _ExchangeFn.apply(g, hw, axis)


def return_halos(dg_ext, hw: int, axis: Axis):
    """The transpose of :func:`exchange_halos`: dg_ext (..., hw + N_local +
    hw, F) rows of [left halo | local | right halo] -> the local rows with
    the neighbours' halo cotangents of our boundary rows added.  Its
    backward is the exchange."""
    return _ReturnFn.apply(dg_ext, hw, axis)


# --- K9: plain versions ----------------------------------------------------------

def _range_window(g, tb: int, nh: int, blk_off: int, lo: int, hi: int):
    """The window rows (n_mesh, hi − lo, W', M) of target blocks lo..hi−1:
    block b's W' = (2nh+1)·tb rows of g (n_mesh, n_src, M) from source
    block b + blk_off on, zero outside g."""
    n_src = g.shape[-2]
    first = (lo + blk_off) * tb
    span = (hi - lo + 2 * nh) * tb
    pad_lo, pad_hi = max(0, -first), max(0, first + span - n_src)
    gp = F.pad(g, (0, 0, pad_lo, pad_hi))
    rows = gp[..., first + pad_lo:first + pad_lo + span, :]
    return rows.unfold(-2, (2 * nh + 1) * tb, tb).transpose(-1, -2)


def _range_unwindow(win, tb: int, nh: int, n_src: int, blk_off: int,
                    lo: int):
    """Transpose of :func:`_range_window`: each window row of win (n_mesh,
    nr, W', M) summed onto the row of the source array (n_mesh, n_src, M)
    it was read from; rows outside [0, n_src) are dropped."""
    *lead, nr, _, M = win.shape
    span = (nr + 2 * nh) * tb
    acc = win.new_zeros(*lead, span, M)
    for j in range(2 * nh + 1):
        acc[..., j * tb:j * tb + nr * tb, :] += \
            win[..., j * tb:(j + 1) * tb, :].reshape(*lead, nr * tb, M)
    first = (lo + blk_off) * tb
    out = win.new_zeros(*lead, n_src, M)
    a, b = max(0, first), min(n_src, first + span)
    out[..., a:b, :] = acc[..., a - first:b - first, :]
    return out


def _k9_dims(g, sten_band, R: int):
    """(n_mesh, M, R, K, C) of g (n_mesh, n_src, M) and a dense stencil
    (n_mesh, nb, R+2K, TB, W') of R rings."""
    n_mesh, _, M = g.shape
    K = (sten_band.shape[2] - R) // 2
    return n_mesh, M, R, K, M // (2 * K)


def halo_fused_fwd_reference(g, sten_band, wmat, tb: int, nh: int,
                             blk_off: int, lo: int, hi: int):
    """Plain PyTorch K9 forward: K1's contraction
    (ops/band_conv.py::band_fused_fwd_reference) for the target blocks
    lo..hi−1 of a shard's stencil sten_band (n_mesh, nb, R+2K, TB, W'),
    block b's window read from the source array g (n_mesh, n_src, M) at
    source block b + blk_off (zero outside it).  wmat: (R, M, O2).
    Returns the range's rows of y (n_mesh, (hi − lo)·tb, O2)."""
    n_mesh, M, R, K, C = _k9_dims(g, sten_band, wmat.shape[0])
    contrib = _window_contrib(_range_window(g, tb, nh, blk_off, lo, hi),
                              sten_band[:, lo:hi], R, K, C)
    y = torch.einsum("mbrtj,rjo->mbto", contrib, wmat)
    return y.reshape(n_mesh, (hi - lo) * tb, wmat.shape[-1])


def halo_fused_bwd_reference(dy, g, sten_band, wmat, tb: int, nh: int,
                             blk_off: int, lo: int, hi: int):
    """Plain PyTorch K9 backward, written out as K1's
    (ops/band_conv.py::band_fused_bwd_reference) over the range of
    :func:`halo_fused_fwd_reference`: dy (n_mesh, (hi − lo)·tb, O2) the
    range's output cotangent.  Returns (dg (n_mesh, n_src, M): every row of
    the source array, halo rows included; dw (R, M, O2))."""
    n_mesh, M, R, K, C = _k9_dims(g, sten_band, wmat.shape[0])
    sten = sten_band[:, lo:hi]
    contrib = _window_contrib(_range_window(g, tb, nh, blk_off, lo, hi),
                              sten, R, K, C)
    dyb = dy.reshape(n_mesh, hi - lo, tb, wmat.shape[-1])
    dw = torch.einsum("mbrtj,mbto->rjo", contrib, dyb)
    dcon = torch.einsum("mbto,rjo->mbrtj", dyb, wmat)
    dg = _range_unwindow(_window_transpose(dcon, sten, R, K, C), tb, nh,
                         g.shape[-2], blk_off, lo)
    return dg, dw


def halo_contrib_reference(g, sten_band, tb: int, nh: int, n_rings: int,
                           k_width: int, blk_off: int, lo: int, hi: int):
    """Plain PyTorch K9 contrib: K3's (ops/band_conv.py::
    band_contrib_reference) over the range and source array of
    :func:`halo_fused_fwd_reference`.  Returns (n_mesh, (hi − lo)·R·tb, M),
    row ((b − lo)·R + r)·tb + t holding target t of block b, ring r."""
    n_mesh, M = g.shape[0], g.shape[-1]
    con = _window_contrib(_range_window(g, tb, nh, blk_off, lo, hi),
                          sten_band[:, lo:hi], n_rings, k_width,
                          M // (2 * k_width))
    return con.reshape(n_mesh, -1, M)


def halo_contrib_bwd_reference(dout, sten_band, tb: int, nh: int,
                               n_rings: int, k_width: int, n_src: int,
                               blk_off: int, lo: int, hi: int):
    """Plain PyTorch K9 contrib backward: dG (n_mesh, n_src, M) of the
    source array for the contrib cotangent dout (n_mesh, (hi − lo)·R·tb,
    M), the window parts summed onto their rows."""
    n_mesh, _, M = dout.shape
    dcon = dout.reshape(n_mesh, hi - lo, n_rings, tb, M)
    parts = _window_transpose(dcon, sten_band[:, lo:hi], n_rings, k_width,
                              M // (2 * k_width))
    return _range_unwindow(parts, tb, nh, n_src, blk_off, lo)


# --- K9: wrappers and kernel launches ---------------------------------------------

def _k9_check(name, dims, sten_band, tb, nh, R, lo, hi, *tensors):
    """Raise unless a source array of dims (n_mesh, n_src, M) and sten_band
    (n_mesh, nb, R+2K, tb, (2nh+1)·tb) agree, n_src is a multiple of tb,
    0 ≤ lo < hi ≤ nb, sten_band and every named (label, tensor) is
    contiguous float32 on the first one's device and the kernels take the
    shape."""
    n_mesh, n_src, M = dims
    nm, nb, P, tb_, Wp = sten_band.shape
    K = (P - R) // 2
    if nm != n_mesh or tb_ != tb or Wp != (2 * nh + 1) * tb \
            or P != R + 2 * K or M % (2 * K) or n_src % tb \
            or not 0 <= lo < hi <= nb:
        raise ValueError(
            f"{name} shapes do not agree: source {tuple(dims)}, sten_band "
            f"{tuple(sten_band.shape)}, tb {tb}, nh {nh}, R {R}, blocks "
            f"[{lo}, {hi})")
    dev = tensors[0][1].device
    for label, t in (*tensors, ("sten_band", sten_band)):
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous float32 {label} on "
                             f"{dev}, got {t.dtype} on {t.device} "
                             f"(contiguous={t.is_contiguous()})")
    _band_shapes(name, M // (2 * K), K, R)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.cache
def _entry(name: str, n_ptr: int, n_int: int):
    """The C entry of csrc/<name>.cu (n_ptr pointers, n_int ints, the
    stream)."""
    fn = getattr(kernels.library(name), name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launched(name, err):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    kernels.launches[name] += 1


def _cuda_only(name, t):
    if t.device.type != "cuda":
        raise ValueError(f"{name} has no kernel for device {t.device}")


def halo_fused_fwd(g, sten_band, wmat, tb: int, nh: int, blk_off: int,
                   lo: int, hi: int, out=None):
    """K9 forward: the rows of target blocks lo..hi−1 of y (n_mesh, N, O2),
    N = nb·tb, from the source array g (n_mesh, n_src, M) (shapes as in
    :func:`halo_fused_fwd_reference`), written into ``out`` (zeros when
    None; its other rows are left as they are).  Returns out.

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (building it on first use) or raise."""
    n_mesh, nb, O2 = sten_band.shape[0], sten_band.shape[1], wmat.shape[-1]
    if out is None:
        out = g.new_zeros(n_mesh, nb * tb, O2)
    if g.device.type == "cpu":
        out[:, lo * tb:hi * tb] = halo_fused_fwd_reference(
            g, sten_band, wmat, tb, nh, blk_off, lo, hi)
        return out
    name = "halo_fused_fwd"
    _cuda_only(name, g)
    R = wmat.shape[0]
    _k9_check(name, g.shape, sten_band, tb, nh, R, lo, hi, ("g", g),
              ("wmat", wmat), ("out", out))
    M = g.shape[-1]
    K = (sten_band.shape[2] - R) // 2
    if tuple(wmat.shape[:2]) != (R, M) or tuple(out.shape) != (
            n_mesh, nb * tb, O2):
        raise ValueError(f"{name}: wmat {tuple(wmat.shape)}, out "
                         f"{tuple(out.shape)} for g {tuple(g.shape)}")
    fn = _entry(name, 5, 12)
    sizes = (n_mesh, nb * tb, g.shape[1], M // (2 * K), K, R, tb, nh, O2,
             blk_off, lo, hi)
    # contrib of the range's targets, the filter's partial sums and the
    # range's occupancy bytes
    scratch = torch.empty((_scratch_floats(name, g.device.index, *sizes),),
                          dtype=torch.float32, device=g.device)
    err = fn(g.data_ptr(), sten_band.data_ptr(), wmat.data_ptr(),
             out.data_ptr(), scratch.data_ptr(), *sizes, _stream(g))
    _launched(name, err)
    return out


def halo_fused_bwd(dy, g, sten_band, wmat, tb: int, nh: int, blk_off: int,
                   lo: int, hi: int):
    """K9 backward (dg (n_mesh, n_src, M), dw (R, M, O2)) for the range's
    output cotangent dy (n_mesh, (hi − lo)·tb, O2) (shapes as in
    :func:`halo_fused_bwd_reference`).

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (building it on first use) or raise.  Each dG row has one writer that
    sums its target blocks in a fixed order: no atomics."""
    if g.device.type == "cpu":
        return halo_fused_bwd_reference(dy, g, sten_band, wmat, tb, nh,
                                        blk_off, lo, hi)
    name = "halo_fused_bwd"
    _cuda_only(name, g)
    R, M, O2 = wmat.shape
    _k9_check(name, g.shape, sten_band, tb, nh, R, lo, hi, ("g", g),
              ("wmat", wmat), ("dy", dy))
    n_mesh, n_src = g.shape[:2]
    K = (sten_band.shape[2] - R) // 2
    if tuple(dy.shape) != (n_mesh, (hi - lo) * tb, O2) or M != g.shape[-1]:
        raise ValueError(f"{name}: dy {tuple(dy.shape)}, want "
                         f"{(n_mesh, (hi - lo) * tb, O2)}")
    fn = _entry(name, 7, 12)
    sizes = (n_mesh, sten_band.shape[1] * tb, n_src, M // (2 * K), K, R, tb,
             nh, O2, blk_off, lo, hi)
    f32 = dict(dtype=torch.float32, device=g.device)
    dg = torch.empty((n_mesh, n_src, M), **f32)
    dw = torch.empty((R, M, O2), **f32)
    # contrib and dcontrib of the range's targets, the dW partial sums, W's
    # rows in dc's order and the range's occupancy bytes
    scratch = torch.empty((_scratch_floats(name, g.device.index, *sizes),),
                          **f32)
    err = fn(dy.data_ptr(), g.data_ptr(), sten_band.data_ptr(),
             wmat.data_ptr(), dg.data_ptr(), dw.data_ptr(), scratch.data_ptr(),
             *sizes, _stream(g))
    _launched(name, err)
    return dg, dw


def halo_contrib_fwd(g, sten_band, tb: int, nh: int, n_rings: int,
                     k_width: int, blk_off: int, lo: int, hi: int):
    """K9 contrib (n_mesh, (hi − lo)·R·tb, M) (shapes and layout as in
    :func:`halo_contrib_reference`).

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (building it on first use) or raise."""
    if g.device.type == "cpu":
        return halo_contrib_reference(g, sten_band, tb, nh, n_rings, k_width,
                                      blk_off, lo, hi)
    name = "halo_contrib_fwd"
    _cuda_only(name, g)
    _k9_check(name, g.shape, sten_band, tb, nh, n_rings, lo, hi, ("g", g))
    n_mesh, n_src, M = g.shape
    out = torch.empty((n_mesh, (hi - lo) * n_rings * tb, M),
                      dtype=torch.float32, device=g.device)
    fn = _entry(name, 3, 11)
    err = fn(g.data_ptr(), sten_band.data_ptr(), out.data_ptr(), n_mesh,
             sten_band.shape[1] * tb, n_src, M // (2 * k_width), k_width,
             n_rings, tb, nh, blk_off, lo, hi, _stream(g))
    _launched(name, err)
    return out


def halo_contrib_bwd(dout, sten_band, tb: int, nh: int, n_rings: int,
                     k_width: int, n_src: int, blk_off: int, lo: int,
                     hi: int):
    """K9 contrib backward: dG (n_mesh, n_src, M) of the source array for
    the contrib cotangent dout (n_mesh, (hi − lo)·R·tb, M) (as in
    :func:`halo_contrib_bwd_reference`).

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (building it on first use) or raise."""
    if dout.device.type == "cpu":
        return halo_contrib_bwd_reference(dout, sten_band, tb, nh, n_rings,
                                          k_width, n_src, blk_off, lo, hi)
    name = "halo_contrib_bwd"
    _cuda_only(name, dout)
    n_mesh, rows, M = dout.shape
    if rows != (hi - lo) * n_rings * tb:
        raise ValueError(f"{name}: dout {tuple(dout.shape)} is not {n_rings}"
                         f" rings of blocks [{lo}, {hi})")
    _k9_check(name, (n_mesh, n_src, M), sten_band, tb, nh, n_rings, lo, hi,
              ("dout", dout))
    fn = _entry(name, 4, 11)
    sizes = (n_mesh, sten_band.shape[1] * tb, n_src, M // (2 * k_width),
             k_width, n_rings, tb, nh, blk_off, lo, hi)
    f32 = dict(dtype=torch.float32, device=dout.device)
    dg = torch.empty((n_mesh, n_src, M), **f32)
    # the cotangent in the dG pass's channel-major layout
    scratch = torch.empty(
        (_scratch_floats(name, dout.device.index, *sizes),), **f32)
    err = fn(dout.data_ptr(), sten_band.data_ptr(), dg.data_ptr(),
             scratch.data_ptr(), *sizes, _stream(dout))
    _launched(name, err)
    return dg


# --- the sharded convs ------------------------------------------------------------

def shard_conv_fwd(g, wmat, sten_band, tb: int, nh: int, halos,
                   overlap: bool):
    """One shard's fused conv y (n_mesh, N_local, O2) through K9: g
    (n_mesh, N_local, M) its rows, sten_band (n_mesh, nb, R+2K, TB, W') its
    stencil, ``halos()`` the call that gives its (left, right) halo rows
    (n_mesh, nh·TB, M) (the wait of a posted exchange, or the rows
    themselves).  Serial (JAX ``halo_band_fused``): one launch over [left |
    g | right].  Overlapped (JAX ``halo_band_fused_overlap``; needs nb >
    2·nh): the interior blocks nh..nb−nh−1, which read no halo row, over g
    before ``halos()`` is called, then the head blocks over [left | first
    2nh blocks] and the tail over [last 2nh blocks | right], all three into
    one y.  Returns (y, the source arrays :func:`shard_conv_bwd` needs)."""
    hw, nb = nh * tb, sten_band.shape[1]
    if not overlap:
        left, right = halos()
        g_ext = torch.cat([left, g, right], dim=-2)
        return halo_fused_fwd(g_ext, sten_band, wmat, tb, nh, 0, 0,
                              nb), (g_ext,)
    y = halo_fused_fwd(g, sten_band, wmat, tb, nh, -nh, nh, nb - nh)
    left, right = halos()
    g_head = torch.cat([left, g[..., :2 * hw, :]], dim=-2)
    g_tail = torch.cat([g[..., -2 * hw:, :], right], dim=-2)
    halo_fused_fwd(g_head, sten_band, wmat, tb, nh, 0, 0, nh, out=y)
    halo_fused_fwd(g_tail, sten_band, wmat, tb, nh, nh - nb, nb - nh, nb,
                   out=y)
    return y, (g, g_head, g_tail)


def shard_conv_bwd(dy, sources, wmat, sten_band, tb: int, nh: int, send):
    """The backward of :func:`shard_conv_fwd` for the output cotangent dy
    (n_mesh, N_local, O2), ``sources`` its second output.  ``send(d_left,
    d_right)`` gets the cotangents of the halo rows (the neighbours'
    rows) as soon as they are known and returns the call that gives
    (from the previous rank, from the next): the cotangents of this shard's
    first and last nh·TB rows that the neighbours computed.  Serial: one
    K9 backward launch.  Overlapped: the head and tail blocks first, then
    ``send``, then the interior blocks.  dG's pieces are added in one
    order: the interior's, the head's, the tail's, then the next rank's,
    then the previous rank's.  Returns (dg (n_mesh, N_local, M), dw)."""
    hw, nb = nh * tb, sten_band.shape[1]
    if len(sources) == 1:
        dg_ext, dw = halo_fused_bwd(dy, sources[0], sten_band, wmat, tb, nh,
                                    0, 0, nb)
        received = send(dg_ext[..., :hw, :], dg_ext[..., -hw:, :])
        dg = dg_ext[..., hw:-hw, :].clone()
    else:
        g, g_head, g_tail = sources
        dg_h, dw_h = halo_fused_bwd(dy[..., :hw, :].contiguous(), g_head,
                                    sten_band, wmat, tb, nh, 0, 0, nh)
        dg_t, dw_t = halo_fused_bwd(dy[..., -hw:, :].contiguous(), g_tail,
                                    sten_band, wmat, tb, nh, nh - nb,
                                    nb - nh, nb)
        received = send(dg_h[..., :hw, :], dg_t[..., -hw:, :])
        dg, dw_i = halo_fused_bwd(dy[..., hw:-hw, :].contiguous(), g,
                                  sten_band, wmat, tb, nh, -nh, nh, nb - nh)
        dg[..., :2 * hw, :] += dg_h[..., hw:, :]
        dg[..., -2 * hw:, :] += dg_t[..., :2 * hw, :]
        dw = dw_h + dw_t + dw_i
    from_prev, from_next = received()
    dg[..., -hw:, :] += from_next
    dg[..., :hw, :] += from_prev
    return dg, dw


class _HaloConvFn(torch.autograd.Function):
    """The sharded fused conv over the graph axis: :func:`shard_conv_fwd`
    with the exchange posted before the interior launch, and
    :func:`shard_conv_bwd` with the return posted between the boundary and
    interior launches.  Keeps the source arrays (the forward's exchange is
    not repeated)."""

    @staticmethod
    def forward(ctx, g, wmat, sten_band, tb: int, nh: int, axis: Axis,
                overlap: bool):
        pending = _post_exchange(g, nh * tb, axis, "conv")
        y, sources = shard_conv_fwd(g, wmat, sten_band, tb, nh,
                                    pending.wait, overlap)
        ctx.save_for_backward(wmat, sten_band, *sources)
        ctx.args = (tb, nh, axis)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        wmat, sten_band, *sources = ctx.saved_tensors
        tb, nh, axis = ctx.args
        dg, dw = shard_conv_bwd(
            dy.contiguous(), sources, wmat, sten_band, tb, nh,
            lambda d_left, d_right: _post_return(d_left, d_right, axis,
                                                 "conv").wait)
        return dg, dw, None, None, None, None, None


class _HaloContribFn(torch.autograd.Function):
    """The sharded unfused contrib (JAX ``halo_band_contrib``): exchange,
    one K9 contrib launch over the extended rows; backward one K9 contrib
    backward launch, then the return."""

    @staticmethod
    def forward(ctx, g, sten_band, tb: int, nh: int, n_rings: int,
                k_width: int, axis: Axis):
        hw, nb = nh * tb, sten_band.shape[1]
        left, right = _post_exchange(g, hw, axis, "conv").wait()
        g_ext = torch.cat([left, g, right], dim=-2)
        ctx.save_for_backward(sten_band)
        ctx.args = (tb, nh, n_rings, k_width, axis, g_ext.shape[-2])
        return halo_contrib_fwd(g_ext, sten_band, tb, nh, n_rings, k_width,
                                0, 0, nb)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        (sten_band,) = ctx.saved_tensors
        tb, nh, n_rings, k_width, axis, n_ext = ctx.args
        hw, nb = nh * tb, sten_band.shape[1]
        dg_ext = halo_contrib_bwd(dout.contiguous(), sten_band, tb, nh,
                                  n_rings, k_width, n_ext, 0, 0, nb)
        pending = _post_return(dg_ext[..., :hw, :], dg_ext[..., -hw:, :],
                               axis, "conv")
        dg = _add_returned(dg_ext[..., hw:-hw, :].clone(), pending, hw)
        return dg, None, None, None, None, None, None


def _local_stencil(g, banded: BandedTable):
    """g as (n_mesh, N_local, M) and the shard's stencil as (n_mesh, nb,
    R+2K, TB, W'), both contiguous."""
    if not isinstance(banded, BandedTable):
        raise NotImplementedError(
            "the graph-parallel conv takes a shard of a dense BandedTable; "
            f"got {type(banded).__name__} (the panel-sharded path, "
            "PanelShards / CompactShards, is ROADMAP Queue 1 item 8)")
    g3 = g.reshape(-1, *g.shape[-2:]).contiguous()
    sten = banded.sten_band.reshape(-1, *banded.sten_band.shape[-4:])
    if sten.shape[0] != g3.shape[0] or sten.shape[1] * banded.tb \
            != g3.shape[1]:
        raise ValueError(f"g {tuple(g.shape)} and the shard's stencil "
                         f"{tuple(banded.sten_band.shape)} do not agree")
    return g3, sten.contiguous()


def overlaps(nb_local: int, nh: int) -> bool:
    """Whether halo_field_conv takes the overlapped path: the JAX package's
    rule, more than 2·nh local blocks."""
    return nb_local > 2 * nh


def halo_field_conv(g_local, banded_local: BandedTable, zonal, spherical,
                    phase, ftype, axis: Axis, overlap: bool = True):
    """Sharded fused field convolution: g_local (..., N_local, K·2C), the
    k-major rotated-source tensor of this rank's vertex rows
    (ops/band_conv.py::rotated_source_tensor_kmajor), and
    ``banded_local``, the BandedTable shard of the same rows -> local y
    (..., N_local, O, 2).  Filter parameters are replicated: their
    gradients here are this rank's part, which the trainer sums over the
    world (parallel/gp.py).

    overlap=True takes the overlapped path when the shard holds more than
    2·nh blocks (:func:`overlaps`), else the serial one."""
    lead, N = g_local.shape[:-2], g_local.shape[-2]
    coeff = filter_coefficients(zonal, spherical, phase, ftype,
                                banded_local.band_limit)
    g3, sten = _local_stencil(g_local, banded_local)
    wmat = filters_to_wmat(coeff).contiguous()
    y2 = _HaloConvFn.apply(g3, wmat, sten, banded_local.tb, banded_local.nh,
                           axis, overlap and overlaps(sten.shape[1],
                                                      banded_local.nh))
    O = wmat.shape[-1] // 2
    y = torch.stack([y2[..., :O], y2[..., O:]], dim=-1)
    return y.reshape(*lead, N, O, 2)


def halo_contrib(g_local, banded_local: BandedTable, axis: Axis):
    """Sharded counterpart of ops/band_conv.py::band_contrib: g_local
    (..., N_local, K·2C) and the shard's BandedTable -> local contrib
    (..., N_local, R, C, K, 2)."""
    lead, (N, M) = g_local.shape[:-2], g_local.shape[-2:]
    R, K, tb = (banded_local.n_rings, 2 * banded_local.band_limit + 1,
                banded_local.tb)
    g3, sten = _local_stencil(g_local, banded_local)
    out = _HaloContribFn.apply(g3, sten, tb, banded_local.nh, R, K, axis)
    out = out.reshape(-1, N // tb, R, tb, K, 2, M // (2 * K))
    return out.permute(0, 1, 3, 2, 6, 4, 5).reshape(*lead, N, R,
                                                    M // (2 * K), K, 2)
