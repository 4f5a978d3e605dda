"""The port's compressed banded layout against the JAX package's, on the CPU.

A CompressedBandedTable holds 5 planes (r, the phasor e^{iθ}, wxp) in the
dense band's slot layout.  Over it the port runs K4 (the compressed banded
conv, forward and backward, ``_BandCFusedFn``) and the banded ECHO
(``ops/echo.py::echo_banded``); over the dense BandedTable it runs K3 (the
unfused contrib, ``_BandContribFn``) for ``fuse_filters=False``.  Here the
kernels' plain versions run; the JAX side runs its Pallas kernels in
interpret mode.  Tolerances, each with its reason:

- K4's and K3's plain versions (both directions) against the interpreted
  ``_band_cfused`` / ``_band_contrib`` and their ``jax.vjp``, and
  ``_BandCFusedFn`` / ``_BandContribFn`` against torch.autograd of their
  plain forwards: atol 3e-5 / rtol 2e-5 (``CONV_TOL``, the bar of the K5
  and K6 plain versions against Pallas: f32 sums over the window, rings and
  frequencies in another order);
- ``field_conv_banded`` over the compressed table, and with
  ``fuse_filters=False``, against the port's K1 route on the dense table:
  values atol 2e-5, gradients atol 3e-4 / rtol 1e-3, the bars
  tests/test_band_conv.py::test_compressed_matches_fused sets the JAX pair;
- ``echo_banded`` against the JAX ``echo_banded``, values and gradients:
  atol 3e-5 / rtol 2e-5 (``ECHO_TOL``, the bar of
  tests/test_band_conv.py::test_echo_banded_matches_xla);
- a two-mesh batch of different nh against each mesh alone: atol 5e-5 /
  rtol 5e-5, the bar of tests/test_banded_models.py::
  test_mixed_nh_batch_comp_parity;
- whole nets (``echo_impl="banded"``, and with the compressed table as the
  conv table) against the JAX gather route (plain XLA): logits rtol 5e-4 /
  atol 5e-5 (``NET_TOL``), every parameter's gradient within 1e-4 of its
  scale (tests/test_torch_train.py::_close_to_scale);
- ``fit`` / ``evaluate_task``: finite losses, and the evaluation of the
  trained net equal to the fit's test metric.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from test_band_conv import banded_graph, tables_for
from test_deploy import _records
from test_torch_echo import (ECHO_TOL, NET_TOL, TB, _features, _jax_params,
                             _port_records, _port_table, _t)
from test_torch_train import _close_to_scale
from fieldconv_tpu.ops import echo as jecho
from fieldconv_tpu.ops.pallas import band_conv as jbc
from fieldconv_tpu.precomp import banded as jbanded
from fieldconv_tpu.train import loop as jloop
from fieldconv_tpu.train import trainer as jtrainer
from fieldconv_tpu.train.config import ExperimentConfig as JaxConfig
from fieldconv_tpu_torch import kernels
from fieldconv_tpu_torch.deploy import Predictor
from fieldconv_tpu_torch.ops import band_conv as tbc
from fieldconv_tpu_torch.ops import echo as techo
from fieldconv_tpu_torch.precomp import banded as tbanded
from fieldconv_tpu_torch.train import loop as tloop
from fieldconv_tpu_torch.train.config import ExperimentConfig
from fieldconv_tpu_torch.train.trainer import (_pad_comp, batched_apply,
                                               stack_batch)

torch.set_num_threads(1)   # one per xdist worker: see test_torch_ops.py

CONV_TOL = dict(atol=3e-5, rtol=2e-5)
GRAD_TOL = dict(atol=3e-4, rtol=1e-3)
SHAPES = pytest.mark.parametrize("B,R", [(2, 6), (1, 3)])


def _setup(rng, B, R, C=4, O=3):
    """One graph's JAX and port tables (the compressed ones equal bit for
    bit), and g, W and dy in the kernels' shapes."""
    gr = banded_graph(rng, n_vertices=32, bw=7, B=B, R=R)
    jt, jband = tables_for(gr)
    jcomp = jbanded.build_compressed_banded(jt, tb=TB)
    tt = _port_table(jt)
    band = tbanded.build_banded_table(tt, tb=TB)
    comp = tbanded.build_compressed_banded(tt, tb=TB)
    np.testing.assert_array_equal(comp.sten_band.numpy(),
                                  np.asarray(jcomp.sten_band))
    N, K = jt.n_pad, 2 * B + 1
    return types.SimpleNamespace(
        B=B, R=R, K=K, C=C, N=N, nh=comp.nh, jcomp=jcomp, jband=jband,
        band=band, comp=comp,
        g=rng.normal(size=(N, K * 2 * C)).astype(np.float32),
        # W scaled as an initialised filter bank: outputs O(1)
        w=(rng.normal(size=(R, K * 2 * C, 2 * O)) / np.sqrt(K * C * R))
        .astype(np.float32),
        dy=rng.normal(size=(N, 2 * O)).astype(np.float32))


def _k4_args(s):
    return (s.comp.sten_band[None].contiguous(), TB, s.nh, s.R, s.B)


# --- K4 ---------------------------------------------------------------------------

@SHAPES
def test_k4_plain_matches_pallas(rng, B, R):
    """band_cfused_reference and band_cfused_bwd_reference (through the
    wrappers, on CPU tensors: no launch) against the interpreted
    ``_band_cfused`` and its jax.vjp, for K = 5, R = 6 and K = 3, R = 3."""
    s = _setup(rng, B, R)
    sten = jnp.asarray(s.jcomp.sten_band)

    @jax.jit
    def run(g, w, dy):
        def f(g, w):
            return jbc._band_cfused(g, w, sten, TB, s.nh, R, B, "f32")
        y, vjp = jax.vjp(f, g, w)
        return (y, *vjp(dy))

    want = run(s.g, s.w, s.dy)
    before = dict(kernels.launches)
    y = tbc.band_cfused_fwd(_t(s.g)[None], _t(s.w), *_k4_args(s))
    dg, dw = tbc.band_cfused_bwd(_t(s.dy)[None], _t(s.g)[None], _t(s.w),
                                 *_k4_args(s))
    assert kernels.launches == before
    for got, w in zip((y[0], dg[0], dw), want):
        assert np.abs(np.asarray(w)).max() > 0.1
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **CONV_TOL)


# --- K3 ---------------------------------------------------------------------------

@SHAPES
def test_k3_plain_matches_pallas(rng, B, R):
    """band_contrib_reference (laid out as the JAX kernel lays it out) and
    band_contrib_bwd_reference (dG after the shift combine) against the
    interpreted ``_band_contrib`` and its jax.vjp."""
    s = _setup(rng, B, R)
    sten = jnp.asarray(s.jband.sten_band)
    dout = rng.normal(size=(s.N * R, s.K * 2 * s.C)).astype(np.float32)

    @jax.jit
    def run(g, dout):
        def f(g):
            return jbc._band_contrib(g, sten, TB, s.nh, R, s.K, "f32")
        out, vjp = jax.vjp(f, g)
        return out, vjp(dout)[0]

    want, want_dg = run(s.g, dout)
    sb = s.band.sten_band[None].contiguous()
    args = (TB, s.nh, R, s.K)
    got = tbc.band_contrib_fwd(_t(s.g)[None], sb, *args)
    dg = tbc.band_contrib_bwd(_t(dout)[None], sb, *args)
    assert got.shape == (1, s.N * R, s.K * 2 * s.C)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), **CONV_TOL)
    np.testing.assert_allclose(dg[0].numpy(), np.asarray(want_dg), **CONV_TOL)
    # band_contrib's (N, R, C, K, 2) view is JAX's band_contrib's
    view = tbc.band_contrib(_t(s.g), s.band)
    jview = jbc.band_contrib(jnp.asarray(s.g), s.jband)
    np.testing.assert_allclose(view.numpy(), np.asarray(jview), **CONV_TOL)


# --- the autograd Functions ----------------------------------------------------------

@pytest.mark.parametrize("kernel", ["k4", "k3"])
def test_functions_match_autograd_of_plain(rng, kernel):
    """_BandCFusedFn and _BandContribFn with their explicit plain backwards
    give what torch.autograd through the plain forwards gives, for two
    meshes at once (the leading mesh axis of one launch)."""
    s = _setup(rng, 2, 6)
    g2 = np.stack([s.g, s.g[::-1]])
    if kernel == "k4":
        sten = s.comp.sten_band.expand(2, -1, -1, -1, -1).contiguous()
        args = (TB, s.nh, s.R, s.B)
        fn = lambda g, w: tbc._BandCFusedFn.apply(g, w, sten, *args)
        plain = lambda g, w: tbc.band_cfused_reference(g, w, sten, *args)
    else:
        sten = s.band.sten_band.expand(2, -1, -1, -1, -1).contiguous()
        args = (TB, s.nh, s.R, s.K)
        fn = lambda g, w: tbc._BandContribFn.apply(g, sten, *args) * w.sum()
        plain = lambda g, w: tbc.band_contrib_reference(g, sten, *args) \
            * w.sum()
    grads = []
    for f in (fn, plain):
        g, w = _t(g2).requires_grad_(), _t(s.w).requires_grad_()
        y = f(g, w)
        cot = torch.from_numpy(
            np.random.default_rng(3).normal(size=y.shape).astype(np.float32))
        (y * cot).sum().backward()
        grads.append((g.grad, w.grad))
    for a, b in zip(*grads):
        assert b.abs().max() > 0
        np.testing.assert_allclose(a.numpy(), b.numpy(), **CONV_TOL)


# --- field_conv_banded ----------------------------------------------------------------

@pytest.mark.parametrize("route", ["compressed", "unfused"])
def test_field_conv_banded_matches_k1_route(rng, route):
    """field_conv_banded over the CompressedBandedTable (K4), and with
    fuse_filters=False (K3, then apply_filters), equals the K1 route over
    the dense BandedTable: values and the gradients of x and every filter
    parameter."""
    s = _setup(rng, 2, 6)
    O = 3
    x = _features(rng, s.N, s.C)
    zr = rng.normal(size=(O, s.C, s.R)).astype(np.float32)
    sph = rng.normal(size=(O, s.C, s.R, s.B, 2)).astype(np.float32)
    ph = rng.normal(size=(O, s.C, s.B + 1)).astype(np.float32)
    table, kw = (s.comp, {}) if route == "compressed" \
        else (s.band, dict(fuse_filters=False))
    out = []
    for tab, more in ((table, kw), (s.band, {})):
        args = [_t(a).requires_grad_() for a in (x, zr, sph, ph)]
        y = tbc.field_conv_banded(args[0], tab, *args[1:], 1, **more)
        torch.sum(y ** 2 + y).backward()
        out.append((y.detach(), [a.grad for a in args]))
    np.testing.assert_allclose(out[0][0].numpy(), out[1][0].numpy(),
                               atol=2e-5)
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)


# --- echo_banded -------------------------------------------------------------------------

@pytest.mark.parametrize("block_chunk,n_bins", [(1, 3), (4, 2)])
def test_echo_banded_matches_jax(rng, block_chunk, n_bins):
    """echo_banded against the JAX echo_banded (origin features included),
    values and the gradient of Σ sin(ECHO); under autograd each block
    chunk is checkpointed.  Zero halo rows give the same descriptors."""
    gr = banded_graph(rng, n_vertices=64, tb=8, bw=14)
    jt, _ = tables_for(gr, tb=8)
    jcomp = jbanded.build_compressed_banded(jt, tb=8)
    comp = tbanded.build_compressed_banded(_port_table(jt), tb=8)
    assert comp.nh == 2
    x = _features(rng, jt.n_pad, 3)

    @jax.jit
    def run(x):
        f = lambda x: jecho.echo_banded(x, jcomp, n_bins,
                                        block_chunk=block_chunk)
        y, vjp = jax.vjp(f, x)
        return y, vjp(jnp.cos(y))[0]

    want, want_dx = run(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    got = techo.echo_banded(xt, comp, n_bins, block_chunk=block_chunk)
    torch.sin(got).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **ECHO_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx),
                               **ECHO_TOL)
    # halo rows take the zero padding's place: zero rows give the unsharded
    # descriptors (graph-parallel shards: tests/test_torch_gp.py)
    zeros = torch.zeros(comp.nh * 8, 2 * xt.shape[-2])
    torch.testing.assert_close(
        techo.echo_banded(xt.detach(), comp, n_bins, block_chunk=block_chunk,
                          halo=(zeros, zeros)), got.detach(), rtol=0, atol=0)


def test_two_mesh_batch_matches_each_mesh(rng):
    """Two meshes of different bandwidth (nh 1 and 2) in one batch: the
    narrow mesh's compressed table is widened with R_SENTINEL slots
    (_pad_comp), and the segmentation net with the banded ECHO gives each
    mesh's outputs alone, on the banded ECHO route and with the compressed
    table as the conv table too (K4)."""
    cfg = ExperimentConfig(task="segmentation", nf=6, n_des=6, n_bins=2,
                           band_limit=2, n_rings=6, echo_impl="banded")
    net = tloop.build_model(cfg, 4, torch.Generator().manual_seed(0),
                            device="cpu").eval()
    items = []
    for bw in (7, 14):
        jt, _ = tables_for(banded_graph(rng, n_vertices=64, tb=8, bw=bw))
        items.append((_t(rng.normal(size=(jt.n_pad, 3))), _port_table(jt),
                      torch.zeros(jt.n_pad, dtype=torch.int64)))
    batch = stack_batch(items, banded_tb=8, echo_banded=True)
    assert batch.comp.nh == 2 and batch.comp.sten_band.shape[0] == 2
    assert (batch.comp.sten_band[0, :, 0, :, :8] == tbanded.R_SENTINEL).all()
    with torch.no_grad():
        for b in (batch, dataclasses.replace(batch, banded=batch.comp)):
            y = batched_apply(net, b)
            for i, item in enumerate(items):
                one = stack_batch([item], banded_tb=8, echo_banded=True)
                if b.banded is b.comp:
                    one = dataclasses.replace(one, banded=one.comp)
                np.testing.assert_allclose(
                    y[i].numpy(), batched_apply(net, one)[0].numpy(),
                    atol=5e-5, rtol=5e-5)
    # the widening itself: sentinel r, zero phasor and wxp
    c1 = tbanded.build_compressed_banded(items[0][1], tb=8)
    wide = _pad_comp(c1, 2)
    assert (wide.sten_band[:, 0, :, :8] == tbanded.R_SENTINEL).all()
    assert (wide.sten_band[:, 1:, :, :8] == 0).all()


# --- whole nets ----------------------------------------------------------------------------

_NETS = {
    "segmentation": dict(nf=4, n_des=4, n_bins=2, band_limit=2, n_rings=6),
    "correspondence": dict(nf=4, n_des=4, n_bins=2, band_limit=1, n_rings=3,
                           center=True),
}


@functools.cache
def _jax_gather(task):
    """The port's net (echo_impl="banded") and the JAX net's logits and
    parameter gradients of Σ logits·cot on its gather route (plain XLA,
    one-hot ECHO), with the port's weights, over a batch of two meshes."""
    kw = dict(task=task, **_NETS[task])
    jcfg, cfg = JaxConfig(**kw), ExperimentConfig(**kw, echo_impl="banded")
    jrecs = _records(np.random.default_rng(7), task, n_meshes=2, N=20,
                     n_classes=3)
    jnet = jloop.build_model(jcfg, 3)
    jb = jloop.make_batches(jrecs, jcfg, 2, None, 24, 8)[0]
    net = tloop.build_model(cfg, 3, torch.Generator().manual_seed(1),
                            device="cpu").eval()
    params = _jax_params(net, jax.eval_shape(
        jnet.init, jax.random.key(1), jb.pos[0],
        jax.tree.map(lambda a: a[0], jb.table)))
    cot = np.random.default_rng(8).normal(size=(2, 24, 3)).astype(np.float32)

    def loss(p):
        y = jtrainer.batched_apply(jnet, p, jb)
        return jnp.sum(y * cot), y

    (_, want), want_g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    from fieldconv_tpu_torch.utils.port_weights import params_from_jax
    want_g = params_from_jax(jax.tree.map(np.asarray, want_g))
    return types.SimpleNamespace(cfg=cfg, net=net, recs=_port_records(jrecs),
                                 want=np.asarray(want), want_g=want_g,
                                 cot=torch.from_numpy(cot))


@pytest.mark.parametrize("task", list(_NETS))
@pytest.mark.parametrize("path", ["banded_echo", "cbanded"])
def test_net_matches_jax_gather(task, path):
    """Path A: make_batches with echo_impl="banded" builds the compressed
    table, and batched_apply runs K1 convs with ECHO and the lift over it;
    path B: the same batch with the compressed table as the conv table too
    (``banded=comp``, every conv through K4).  Logits served by
    Predictor(device="cpu") and every parameter's gradient against the JAX
    gather route; no kernel launches on the CPU."""
    s = _jax_gather(task)
    pred = Predictor(s.net, s.cfg, batch_size=2, banded_tb=TB, device="cpu")
    b = pred.make_batches(s.recs, 24, 8)[0]
    assert isinstance(b.comp, tbanded.CompressedBandedTable)
    assert isinstance(b.banded, tbanded.BandedTable)
    assert b.panel is None and b.compact is None
    if path == "cbanded":
        b = dataclasses.replace(b, banded=b.comp)
    before = dict(kernels.launches)
    got = pred.logits(b).numpy()
    np.testing.assert_allclose(got, s.want, **NET_TOL)
    names, params = zip(*s.net.named_parameters())
    loss = torch.sum(batched_apply(s.net, b) * s.cot)
    for name, g in zip(names, torch.autograd.grad(loss, params)):
        assert s.want_g[name].abs().max() > 0, name
        _close_to_scale(g, s.want_g[name])
    assert kernels.launches == before


@pytest.mark.parametrize("task", list(_NETS))
def test_fit_and_evaluate_banded_echo(rng, task):
    """fit(device="cpu") with echo_impl="banded" trains one epoch on the
    banded ECHO route (finite losses), and evaluate_task over batches built
    apart gives its test metric again."""
    cfg = ExperimentConfig(task=task, **_NETS[task], echo_impl="banded",
                           epochs=1)
    recs = _port_records(_records(rng, task, n_meshes=2, N=20, n_classes=3))
    net, opt, metric = tloop.fit(cfg, recs, recs, n_classes=3, banded_tb=TB,
                                 batch_size=2, device="cpu")
    assert int(opt.step) == 1 and np.isfinite(metric)
    b = tloop.make_batches(recs, cfg, 2, TB, device="cpu")
    assert b[0].comp is not None and b[0].banded is not None
    assert tloop.evaluate_task(net, cfg, b, 3) == metric


# --- CUDA routing --------------------------------------------------------------------------

def test_k3_k4_on_cuda_tensors_need_the_kernels(monkeypatch):
    """On CUDA tensors (fake ones here) each wrapper and each Function's
    backward reaches its kernel's entry, never the plain version; without
    nvcc the build raises; shapes without an instantiation raise before
    the entry."""
    class Entered(Exception):
        pass

    entered = []

    def entry():
        entered.append(True)
        raise Entered

    before = dict(kernels.launches)
    with FakeTensorMode():
        cuda = dict(device="cuda")
        g = torch.zeros(1, 16, 40, **cuda)            # K = 5, C = 4
        w = torch.zeros(6, 40, 6, **cuda)
        csten = torch.zeros(1, 2, 5, 8, 24, **cuda)
        dsten = torch.zeros(1, 2, 16, 8, 24, **cuda)
        dy = torch.zeros(1, 16, 6, **cuda)
        dout = torch.zeros(1, 96, 40, **cuda)
        k4 = (8, 1, 6, 2)
        k3 = (8, 1, 6, 5)
        calls = (lambda: tbc.band_cfused_fwd(g, w, csten, *k4),
                 lambda: tbc.band_cfused_bwd(dy, g, w, csten, *k4),
                 lambda: tbc.band_contrib_fwd(g, dsten, *k3),
                 lambda: tbc.band_contrib_bwd(dout, dsten, *k3))
        for call in calls:
            with pytest.raises(RuntimeError, match="nvcc"):
                call()
        with pytest.raises(NotImplementedError, match="R ≤ 6"):
            tbc.band_cfused_fwd(g, torch.zeros(8, 40, 6, **cuda), csten, 8,
                                1, 8, 2)
        with pytest.raises(NotImplementedError, match="R ≤ 6"):
            tbc.band_contrib_fwd(g, torch.zeros(1, 2, 18, 8, 24, **cuda), 8,
                                 1, 8, 5)
        for name in ("_k4_entry", "_k4_bwd_entry", "_k3_entry",
                     "_k3_bwd_entry"):
            monkeypatch.setattr(tbc, name, entry)
        for call in calls[::2]:
            with pytest.raises(Entered):
                call()
        ctx = types.SimpleNamespace(saved_tensors=(g, w, csten), args=k4)
        with pytest.raises(Entered):
            tbc._BandCFusedFn.backward(ctx, dy)
        ctx = types.SimpleNamespace(saved_tensors=(dsten,), args=k3)
        with pytest.raises(Entered):
            tbc._BandContribFn.backward(ctx, dout)
    assert entered == [True] * 4
    assert kernels.launches == before
