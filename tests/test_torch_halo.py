"""The port's graph-parallel conv (parallel/halo.py, K9) against the JAX
package's, on the CPU.

K9's plain versions run shard by shard with the halo rows passed in
directly (no process group): ``shard_conv_fwd`` / ``shard_conv_bwd`` over
each shard, the halo cotangents returned to their owners by hand, as the
exchange would.  The JAX side runs ``halo_field_conv`` / ``halo_contrib``
under ``jax.shard_map`` on the conftest's 8-device CPU mesh, its Pallas
kernels interpreted, on tests/test_halo.py's shapes.  Tolerances, each
with its reason:

- the sharded conv (serial and overlapped) and the sharded contrib against
  the JAX ones, values and gradients: atol 2e-5 (the bar of
  tests/test_halo.py's values; f32 sums in another order);
- the shards joined against the port's K1 plain version on the global
  table: y and dG atol 1e-5, dW (summed over shards in another order)
  atol 1e-5 + rtol 1e-5;
- the exchange and the return over 4 gloo ranks: the neighbours' rows
  exactly, zeros at the ends, and the adjoint pair <exchange(g), h> =
  <g, return(h)> summed over ranks to rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torch_gp_worker
from test_band_conv import banded_graph, tables_for
from test_torch_echo import _port_table, _t
from fieldconv_tpu.ops.pallas.band_conv import rotated_source_tensor_kmajor
from fieldconv_tpu.parallel.halo import halo_contrib as jhalo_contrib
from fieldconv_tpu.parallel.halo import halo_field_conv as jhalo_field_conv
from fieldconv_tpu.precomp.banded import BandedTable as JaxBandedTable
from fieldconv_tpu_torch import kernels
from fieldconv_tpu_torch.ops import band_conv as tbc
from fieldconv_tpu_torch.ops.field_conv import (apply_filters,
                                               filter_coefficients)
from fieldconv_tpu_torch.parallel import halo
from fieldconv_tpu_torch.parallel.distributed import Axis, spawn
from fieldconv_tpu_torch.precomp import banded as tbanded

torch.set_num_threads(1)   # one per xdist worker: see test_torch_ops.py

TOL = dict(atol=2e-5, rtol=0)
N_DEV, TB = 4, 8


def _setup(rng, n_vertices, C=3, O=5):
    """tests/test_halo.py's graph (bw 7, so nh = 1 at tb 8), its JAX and
    port banded tables (equal bit for bit), features and filters."""
    gr = banded_graph(rng, n_vertices=n_vertices, tb=TB, bw=7)
    jt, jband = tables_for(gr, tb=TB)
    band = tbanded.build_banded_table(_port_table(jt), tb=TB)
    np.testing.assert_array_equal(band.sten_band.numpy(),
                                  np.asarray(jband.sten_band))
    N, B, R = jt.n_pad, gr["B"], gr["R"]
    x = rng.normal(size=(N, C, 2)).astype(np.float32)
    zr = rng.normal(size=(O, C, R)).astype(np.float32)
    sph = rng.normal(size=(O, C, R, B, 2)).astype(np.float32)
    ph = rng.normal(size=(O, C, B + 1)).astype(np.float32)
    return jband, band, x, (zr, sph, ph)


def _jax_mesh():
    return Mesh(np.array(jax.devices()[:N_DEV]), axis_names=("graph",))


def _jax_local(banded, sten, n):
    return JaxBandedTable(sten_band=sten, tb=banded.tb, nh=banded.nh,
                          n_pad=n, band_limit=banded.band_limit,
                          n_rings=banded.n_rings)


def _jax_conv(jband, x, filters, overlap):
    """y and the gradients of sum(y² + y) w.r.t. x and the three filter
    tensors of the JAX sharded conv."""
    def sharded(x, zr, sph, ph, sten):
        gk = rotated_source_tensor_kmajor(x, jband.band_limit)
        return jhalo_field_conv(gk, _jax_local(jband, sten, x.shape[0]), zr,
                                sph, ph, 1, "graph", overlap=overlap)

    smap = jax.shard_map(sharded, mesh=_jax_mesh(),
                         in_specs=(P("graph"), P(), P(), P(), P("graph")),
                         out_specs=P("graph"), check_vma=False)

    def loss(x, zr, sph, ph):
        y = smap(x, zr, sph, ph, jband.sten_band)
        return jnp.sum(y ** 2 + y), y

    (_, y), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True))(x, *filters)
    return np.asarray(y), [np.asarray(g) for g in grads]


def _shards(band, g):
    """Each shard's (rows of g (1, n, M), stencil (1, nb, P, TB, W'))."""
    n = g.shape[1] // N_DEV
    nb = n // TB
    return [(g[:, d * n:(d + 1) * n],
             band.sten_band[None, d * nb:(d + 1) * nb].contiguous())
            for d in range(N_DEV)]


def _halos(parts, d, hw):
    """Shard d's (left, right) halo rows: its neighbours' boundary rows,
    zeros at the ends."""
    g = parts[d][0]
    left = parts[d - 1][0][:, -hw:] if d > 0 else torch.zeros_like(g[:, :hw])
    right = parts[d + 1][0][:, :hw] if d < N_DEV - 1 \
        else torch.zeros_like(g[:, :hw])
    return left, right


def _port_conv(band, x, filters, overlap):
    """y and the gradients of sum(y² + y) of the port's sharded conv, K9's
    plain versions shard by shard: the shards' dW summed (the trainer's
    all-reduce) and each shard's halo cotangents added onto its neighbours'
    rows (the return)."""
    xt = _t(x).requires_grad_()
    zr, sph, ph = (_t(f).requires_grad_() for f in filters)
    wmat = tbc.filters_to_wmat(filter_coefficients(zr, sph, ph, 1,
                                                   band.band_limit))
    g = tbc.rotated_source_tensor_kmajor(xt, band.band_limit)[None]
    parts = _shards(band, g.detach())
    hw, w = band.nh * TB, wmat.detach().contiguous()
    ys, sources = [], []
    for d, (g_d, sten_d) in enumerate(parts):
        y_d, src = halo.shard_conv_fwd(
            g_d, w, sten_d, TB, band.nh, lambda d=d: _halos(parts, d, hw),
            overlap and halo.overlaps(sten_d.shape[1], band.nh))
        ys.append(y_d)
        sources.append(src)
    y2 = torch.cat(ys, dim=1)
    O = w.shape[-1] // 2
    dy2 = 2 * y2 + 1
    sent = {}

    def send(d):
        def post(d_left, d_right):
            sent[d] = (d_left, d_right)
            return lambda: (torch.zeros_like(d_left),
                            torch.zeros_like(d_right))
        return post

    dgs, dw = [], 0
    n = y2.shape[1] // N_DEV
    for d, (_, sten_d) in enumerate(parts):
        dg_d, dw_d = halo.shard_conv_bwd(
            dy2[:, d * n:(d + 1) * n].contiguous(), sources[d], w, sten_d,
            TB, band.nh, send(d))
        dgs.append(dg_d)
        dw = dw + dw_d
    for d in range(N_DEV):                  # the return, by hand
        if d > 0:
            dgs[d - 1][:, -hw:] += sent[d][0]
        if d < N_DEV - 1:
            dgs[d + 1][:, :hw] += sent[d][1]
    dg = torch.cat(dgs, dim=1)
    torch.autograd.backward([g, wmat], [dg, dw])
    y = torch.stack([y2[..., :O], y2[..., O:]], -1)[0]
    return (y.detach().numpy(),
            [t.grad.numpy() for t in (xt, zr, sph, ph)], (y2, dg, dw, g,
                                                          wmat))


@pytest.mark.parametrize("overlap", [False, True])
def test_k9_plain_matches_jax(rng, overlap):
    """The sharded conv through K9's plain versions (serial, and
    overlapped: 4 blocks a shard > 2·nh) equals the JAX halo_field_conv of
    the same path on 4 devices, y and every gradient."""
    jband, band, x, filters = _setup(rng, 128)
    assert band.nh == 1 and halo.overlaps(128 // N_DEV // TB, 1)
    want_y, want_g = _jax_conv(jband, x, filters, overlap)
    before = dict(kernels.launches)
    y, grads, _ = _port_conv(band, x, filters, overlap)
    assert kernels.launches == before                # CPU: no launch
    np.testing.assert_allclose(y, want_y, **TOL)
    for got, want in zip(grads, want_g):
        assert np.abs(want).max() > 0.1
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("overlap", [False, True])
def test_shards_joined_equal_k1(rng, overlap):
    """The shards' joined y, dG and summed dW equal K1's plain version on
    the global table (band_fused_fwd_reference, band_fused_bwd_reference):
    every window row a shard reads through its halos is the global row."""
    _, band, x, filters = _setup(rng, 96)
    _, _, (y2, dg, dw, g, wmat) = _port_conv(band, x, filters, overlap)
    sten = band.sten_band[None].contiguous()
    w = wmat.detach().contiguous()
    want_y = tbc.band_fused_fwd_reference(g.detach(), sten, w, TB, band.nh)
    want_dg, want_dw = tbc.band_fused_bwd_reference(
        (2 * y2 + 1).detach(), g.detach(), sten, w, TB, band.nh)
    np.testing.assert_allclose(y2.detach().numpy(), want_y.numpy(),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(dg.numpy(), want_dg.numpy(), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(dw.numpy(), want_dw.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_k9_contrib_plain_matches_jax(rng):
    """K9's contrib and its backward (plain versions, shard by shard over
    the halo-extended rows) equal the JAX halo_contrib and the gradient of
    sum(contrib²) through it."""
    jband, band, x, _ = _setup(rng, 128)
    gk = rotated_source_tensor_kmajor(jnp.asarray(x), jband.band_limit)

    def sharded(gk, sten):
        return jhalo_contrib(gk, _jax_local(jband, sten, gk.shape[0]),
                             "graph")

    smap = jax.shard_map(sharded, mesh=_jax_mesh(),
                         in_specs=(P("graph"), P("graph")),
                         out_specs=P("graph"), check_vma=False)
    want_out = np.asarray(jax.jit(smap)(gk, jband.sten_band))
    want_dg = np.asarray(jax.jit(jax.grad(
        lambda gk: jnp.sum(smap(gk, jband.sten_band) ** 2)))(gk))

    R, K, hw = band.n_rings, 2 * band.band_limit + 1, band.nh * TB
    parts = _shards(band, _t(np.asarray(gk))[None])
    outs, dgs, sent = [], [], []
    for d, (g_d, sten_d) in enumerate(parts):
        left, right = _halos(parts, d, hw)
        g_ext = torch.cat([left, g_d, right], dim=1)
        nb = sten_d.shape[1]
        out = halo.halo_contrib_fwd(g_ext, sten_d, TB, band.nh, R, K, 0, 0,
                                    nb)
        dg_ext = halo.halo_contrib_bwd(2 * out, sten_d, TB, band.nh, R, K,
                                       g_ext.shape[1], 0, 0, nb)
        M = g_d.shape[-1]
        view = out.reshape(nb, R, TB, K, 2, M // (2 * K))
        outs.append(view.permute(0, 2, 1, 5, 3, 4).reshape(
            nb * TB, R, M // (2 * K), K, 2))
        dgs.append(dg_ext[0, hw:-hw].clone())
        sent.append((dg_ext[0, :hw], dg_ext[0, -hw:]))
    for d in range(N_DEV):
        if d > 0:
            dgs[d - 1][-hw:] += sent[d][0]
        if d < N_DEV - 1:
            dgs[d + 1][:hw] += sent[d][1]
    np.testing.assert_allclose(torch.cat(outs).numpy(), want_out, **TOL)
    np.testing.assert_allclose(torch.cat(dgs).numpy(), want_dg, **TOL)
    assert np.abs(want_dg).max() > 0.1


def test_window_blocks_halo(rng):
    """window_blocks(halo=) reads the halo rows where it would pad zeros:
    the window of [left | a | right] by block shifts."""
    a = torch.from_numpy(rng.normal(size=(2, 32, 5)).astype(np.float32))
    left, right = (torch.from_numpy(rng.normal(size=(2, 16, 5))
                                    .astype(np.float32)) for _ in range(2))
    got = tbanded.window_blocks(a, 8, 2, halo=(left, right))
    ext = torch.cat([left, a, right], dim=1)
    for b in range(4):
        assert torch.equal(got[:, b], ext[:, b * 8:b * 8 + 40])
    assert torch.equal(tbanded.window_blocks(a, 8, 2),
                       tbanded.window_blocks(a, 8, 2, halo=(
                           torch.zeros_like(left), torch.zeros_like(right))))


def test_exchange_and_return_over_gloo():
    """exchange_halos and return_halos over 4 gloo ranks: each rank gets
    its neighbours' boundary rows (zeros at the ends of the ring), the
    return is the exchange's adjoint (<exchange(g), h> = <g, return(h)>
    summed over ranks), and autograd takes each through the other."""
    world, n, F, hw = 4, 12, 3, 4
    gen = torch.Generator().manual_seed(0)
    g = torch.randn(world, n, F, generator=gen)
    h = torch.randn(world, 2, hw, F, generator=gen)
    u = torch.randn(world, n, F, generator=gen)
    out = spawn(torch_gp_worker.ring, world, args=(g, h, u, hw))
    zero = torch.zeros(hw, F)
    for r, o in enumerate(out):
        want_l = g[r - 1, -hw:] if r > 0 else zero
        want_r = g[r + 1, :hw] if r < world - 1 else zero
        np.testing.assert_array_equal(o["left"], want_l.numpy())
        np.testing.assert_array_equal(o["right"], want_r.numpy())
        # the exchange's backward is the return of the same cotangents
        np.testing.assert_allclose(o["g_grad"], o["back"], atol=1e-6)
        # the return's backward is the exchange: u's neighbours' rows
        # around u
        want_ext = torch.cat([
            u[r - 1, -hw:] if r > 0 else zero, u[r],
            u[r + 1, :hw] if r < world - 1 else zero])
        np.testing.assert_allclose(o["ext_grad"], want_ext.numpy(),
                                   atol=1e-6)
        # the rows others returned land on r's first and last hw rows
        want_back = torch.zeros(n, F)
        if r > 0:
            want_back[:hw] += h[r - 1, 1]
        if r < world - 1:
            want_back[-hw:] += h[r + 1, 0]
        np.testing.assert_allclose(o["back"], want_back.numpy(), atol=1e-6)
    np.testing.assert_allclose(sum(o["lhs"] for o in out),
                               sum(o["rhs"] for o in out), rtol=1e-5)


@pytest.mark.parametrize("fuse_filters", [True, False])
def test_halo_field_conv_one_shard_equals_field_conv_banded(rng,
                                                            fuse_filters):
    """The sharded conv over a graph axis of one rank (no neighbours: the
    halos are zeros and nothing is sent, so no process group is needed)
    equals field_conv_banded on the same table, y and every gradient,
    fused (halo_field_conv: K9, the overlapped path at 12 blocks) and
    unfused (halo_contrib: K9's contrib, then the filter product)."""
    _, band, x, filters = _setup(rng, 96)
    axis = Axis(None, (0,), 0, "gloo")

    def sharded(x_, *f):
        g = tbc.rotated_source_tensor_kmajor(x_, band.band_limit)
        if fuse_filters:
            return halo.halo_field_conv(g, band, *f, 1, axis)
        coeff = filter_coefficients(*f, 1, band.band_limit)
        return apply_filters(halo.halo_contrib(g, band, axis), coeff)

    got, want = [], []
    for out, conv in ((got, sharded),
                      (want, lambda x_, *f: tbc.field_conv_banded(
                          x_, band, *f, 1))):
        args = [_t(a).requires_grad_() for a in (x, *filters)]
        y = conv(*args)
        (y ** 2 + y).sum().backward()
        out += [y.detach()] + [a.grad for a in args]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=0)
