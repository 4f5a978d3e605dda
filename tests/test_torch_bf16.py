"""The port's bf16 panel stencils against the JAX package's, on the CPU.

``cast_panel_sten`` stores a PanelTable's or CompactPanelTable's stencil in
bfloat16 (the JAX 163,842-vertex training casts both of its tables by
default, scripts/train_100k.py).  K5, K6, K2 and K7 and the compact lift
read each plane back to f32; the block-panel lift forms its stencil
factors in bf16 (fieldconv_tpu/ops/trans_field.py::
trans_field_panel_contrib casts nothing), and the port matches that.
Both packages get the same numpy inputs and the same cast tables; the JAX
kernels run interpreted.  Tolerances, each with its reason:

- the cast tables: equal bit for bit (compared as 16-bit integers);
- each kernel's plain version on a bf16 table against the interpreted
  Pallas kernel on the same table, each way: the f32 bars of the existing
  port tests (K5 forward rtol 1e-5 / atol 1e-6; K5 backward, K2, K7 and
  their backwards atol 3e-5 / rtol 2e-5; K6 atol 3e-5 / rtol 2e-5), since
  a bf16 value widens to f32 exactly and both then run the f32 arithmetic;
- the compact lift and its VJP: the f32 bar of tests/test_torch_compact.py
  (``ECHO_TOL``), for the same reason;
- the block-panel lift (compressed and dense) and its VJP: ``ECHO_TOL``
  too.  The JAX lift, compiled with the table as an argument, rounds every
  op that forms a stencil factor to bf16 (the ring knots and slopes
  included: JAX rounds a Python float to the array's dtype), forms the
  products s1 and sm in f32 where they feed its f32 contractions and sums
  (XLA drops the bf16 round trip there), rounds s1's row sums to bf16
  once and adds each target's panels in bf16, one rounding per add; the
  port does the same (ops/trans_field.py::_lift_stencils, _lift_sums) and
  comes within 7e-8 of the JAX lift's scale on these inputs;
- whole correspondence nets on bf16 tables against the JAX net on the same
  cast tables: the loss within 5e-5 and every gradient within 1e-4 of its
  own scale (NET_GRAD_TOL; every op sums in another order);
- bf16 against f32 tables: the JAX test's bars
  (tests/test_band_conv.py::test_panel_bf16_stencil_close: conv 2e-2,
  ECHO 3e-2 of the f32 result's scale).
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_band_conv import _panel_setup
from test_deploy import _records
from test_torch_echo import (ECHO_TOL, TB, _features, _jax_params,
                             _port_records, _port_table, _t)
from fieldconv_tpu.ops import trans_field as jtf
from fieldconv_tpu.ops.pallas import band_conv as jbc
from fieldconv_tpu.ops.pallas import echo_panel as jep
from fieldconv_tpu.precomp import banded as jbanded
from fieldconv_tpu.train import loop as jloop
from fieldconv_tpu.train.config import ExperimentConfig as JaxConfig
from fieldconv_tpu_torch import kernels
from fieldconv_tpu_torch.data.synthetic import sphere_record
from fieldconv_tpu_torch.ops import band_conv as tbc
from fieldconv_tpu_torch.ops import compact_fold as tcf
from fieldconv_tpu_torch.ops import echo_panel as tep
from fieldconv_tpu_torch.ops import trans_field as ttf
from fieldconv_tpu_torch.precomp import banded as tbanded
from fieldconv_tpu_torch.scripts import train_100k
from fieldconv_tpu_torch.train import loop as tloop
from fieldconv_tpu_torch.train import trainer as ttrainer
from fieldconv_tpu_torch.train.config import ExperimentConfig
from fieldconv_tpu_torch.train.trainer import batched_apply

torch.set_num_threads(1)   # one per xdist worker: see test_torch_ops.py

K5_TOL = dict(rtol=1e-5, atol=1e-6)
CONV_TOL = dict(atol=3e-5, rtol=2e-5)
NET_GRAD_TOL = 1e-4
R, B = 3, 1
K = 2 * B + 1


def _cast_both(jtab, ttab):
    """The JAX and the port's cast of one table."""
    return (jbanded.cast_panel_sten(jtab), tbanded.cast_panel_sten(ttab))


def _bits(a):
    """A bf16 array or tensor as int16 bit patterns."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def _compact(jt, tbt=4, ts=8):
    return (jbanded.build_compact_panel_table(jt, tb=tbt, ts=ts),
            tbanded.build_compact_panel_table(_port_table(jt), tb=tbt, ts=ts))


def _panels(rng, compressed=True, chunk=1):
    """A kd-ordered ragged graph's panel tables at tb=8, JAX and port, and
    the JAX EdgeTable."""
    _, jt, jp = _panel_setup(rng, compressed=compressed, chunk=chunk)
    tp = tbanded.build_panel_table(_port_table(jt), tb=TB,
                                   compressed=compressed, chunk=chunk)
    return jt, jp, tp


def _scale_close(got, want, frac):
    """max |got − want| below ``frac`` of max |want|."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() < frac * np.abs(want).max()


# --- the cast tables ------------------------------------------------------------

@pytest.mark.parametrize("kind", ["compressed", "dense", "compact"])
def test_cast_panel_sten_matches_jax_bits(rng, kind):
    """cast_panel_sten gives the JAX package's bf16 stencil bit for bit, and
    casts nothing else; the joined table of two cast meshes is the cast of
    the joined table, and ``to`` keeps bf16."""
    tabs = []
    for _ in range(2):
        if kind == "compact":
            _, jt, _ = _panel_setup(rng, compressed=True)
            j, t = _compact(jt)
        else:
            _, j, t = _panels(rng, compressed=kind == "compressed")
        jh, th = _cast_both(j, t)
        assert th.sten.dtype == torch.bfloat16 and jh.sten.dtype == jnp.bfloat16
        np.testing.assert_array_equal(_bits(th.sten), _bits(jh.sten))
        np.testing.assert_array_equal(th.meta.numpy(), t.meta.numpy())
        assert th.to("cpu").sten.dtype == torch.bfloat16
        tabs.append((t, th))
    concat = (tbanded.concat_compact_panel_tables if kind == "compact"
              else tbanded.concat_panel_tables)
    joined_h = concat([th for _, th in tabs])
    assert joined_h.sten.dtype == torch.bfloat16 and joined_h.n_mesh == 2
    np.testing.assert_array_equal(
        _bits(joined_h.sten),
        _bits(tbanded.cast_panel_sten(concat([t for t, _ in tabs])).sten))


def test_cast_batch_keeps_the_all_compact_table_one_object(rng):
    """train_100k.cast_batch casts an all-compact batch's one table once and
    keeps ``panel is compact``; a batch with block panels and a compact
    table casts both."""
    rec = sphere_record(rng, 300, 7)
    for all_compact in (True, False):
        b = train_100k.build_batch(rec, 32, all_compact, False, "cpu")
        h = train_100k.cast_batch(b)
        assert (h.panel is h.compact) == all_compact
        assert h.panel.sten.dtype == h.compact.sten.dtype == torch.bfloat16
        assert b.panel.sten.dtype == torch.float32


# --- K5 and K6 --------------------------------------------------------------------

def _conv_inputs(rng, n, C=4, O2=6):
    M = K * 2 * C
    g = rng.normal(size=(n, M)).astype(np.float32)
    w = (rng.normal(size=(R, M, O2)) / np.sqrt(R * M)).astype(np.float32)
    dy = rng.normal(size=(n, O2)).astype(np.float32)
    return g, w, dy


@pytest.mark.parametrize("compressed,chunk", [(True, 1), (False, 1),
                                              (True, 4)])
def test_k5_bf16_plain_matches_pallas(rng, compressed, chunk):
    """K5 forward and backward (plain versions, on CPU tensors) on a bf16
    panel table against the interpreted Pallas _band_panel_fwd_impl and
    _band_panel_bwd_impl on the same cast table; and within the JAX test's
    2e-2 of the f32 table's output."""
    jt, jp, tp = _panels(rng, compressed, chunk)
    jh, th = _cast_both(jp, tp)
    g, w, dy = _conv_inputs(rng, jt.n_pad)
    want = jbc._band_panel_fwd_impl(jnp.asarray(g), jnp.asarray(w), jh.sten,
                                    jh.meta, TB, R, B, compressed, "f32",
                                    None, chunk)
    before = dict(kernels.launches)
    got = tbc.band_panel_fwd(_t(g), _t(w), th.sten, th.meta, TB, R, B,
                             compressed)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **K5_TOL)
    y32 = tbc.band_panel_fwd(_t(g), _t(w), tp.sten, tp.meta, TB, R, B,
                             compressed)
    _scale_close(got, y32, 2e-2)
    want_g, want_w = jbc._band_panel_bwd_impl(
        jnp.asarray(dy), jnp.asarray(g), jnp.asarray(w), jh.sten, jh.meta_s,
        None, TB, R, B, compressed, "f32", chunk)
    got_g, got_w = tbc.band_panel_bwd(_t(dy), _t(g), _t(w), th.sten, th.meta,
                                      th.meta_s, TB, R, B, compressed)
    assert kernels.launches == before            # CPU: the plain versions
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **ECHO_TOL)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **ECHO_TOL)


@pytest.mark.parametrize("tbt,ts", [(8, 8), (4, 8)])
def test_k6_bf16_plain_matches_pallas(rng, tbt, ts):
    """K6 forward and backward (plain versions and the plain fold) on a
    bf16 compact table against the interpreted Pallas _band_compact_fwd_impl
    and, through jax.vjp of _band_compact, its backward and segment_sum, on
    the same cast table; and within 2e-2 of the f32 table's output."""
    _, jt, _ = _panel_setup(rng, compressed=True)
    jc, tc = _compact(jt, tbt, ts)
    jh, th = _cast_both(jc, tc)
    N = jt.n_pad
    g, w, dy = _conv_inputs(rng, N)
    src = jh.src_idx.reshape(-1)
    want = jbc._band_compact_fwd_impl(jnp.asarray(g)[src], jnp.asarray(w),
                                      jh.sten, jh.meta, tbt, ts, R, B, True,
                                      "f32", N)
    tab = (th.meta, th.src_idx, tbt, R, B)
    got = tbc.band_compact_fwd(_t(g), _t(w), th.sten, *tab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CONV_TOL)
    _scale_close(got, tbc.band_compact_fwd(_t(g), _t(w), tc.sten, *tab), 2e-2)
    _, vjp = jax.vjp(lambda g_, w_: jbc._band_compact(
        g_, w_, jh.sten, jh.meta, src, tbt, ts, R, B, True, "f32", N),
        jnp.asarray(g), jnp.asarray(w))
    want_g, want_w = vjp(jnp.asarray(dy))
    dg, dw = tbc.band_compact_bwd(_t(dy), _t(g), _t(w), th.sten, th.meta,
                                  th.src_idx, th.fold_order, th.fold_ptr,
                                  tbt, R, B)
    np.testing.assert_allclose(dg.numpy(), np.asarray(want_g), **ECHO_TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_w), **ECHO_TOL)


# --- K2 and K7 --------------------------------------------------------------------

@pytest.mark.parametrize("n_bins", [2, 3])
def test_k2_bf16_plain_matches_pallas(rng, n_bins):
    """K2 forward and backward (plain versions) on a bf16 panel table
    against the interpreted Pallas _fwd_impl and jax.vjp of
    _echo_panel_grid (its backward _bwd_impl) on the same cast table, with
    origin features; the op within the JAX test's 3e-2 of the f32
    table's."""
    jt, jp, tp = _panels(rng)
    jh, th = _cast_both(jp, tp)
    N, C = jt.n_pad, 5
    nb, w2 = N // TB, (2 * n_bins + 1) ** 2
    x = _features(rng, N, C)
    x2t = jnp.concatenate([jnp.asarray(x[..., 0]).T,
                           jnp.asarray(x[..., 1]).T], axis=0)
    want = jep._fwd_impl(x2t, jh.sten, jh.meta, TB, n_bins, 2, nb)
    got = tep.echo_panel_grid(_t(x), th.sten, th.meta, n_bins, nb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ECHO_TOL)
    _scale_close(tep.echo_panel_fused(_t(x), th, n_bins),
                 tep.echo_panel_fused(_t(x), tp, n_bins), 3e-2)
    dg = rng.normal(size=(nb, 2 * w2, C, TB)).astype(np.float32)
    _, vjp = jax.vjp(lambda x_: jep._echo_panel_grid(
        x_, jh.sten, jh.meta, jh.meta_s, None, TB, n_bins, 2, nb), x2t)
    (jdx,) = vjp(jnp.asarray(dg))
    want_dx = np.stack([np.asarray(jdx)[:C].T, np.asarray(jdx)[C:].T], -1)
    dx = tep.echo_panel_grid_bwd(_t(dg), _t(x), th.sten, th.meta_s, n_bins,
                                 nb)
    np.testing.assert_allclose(dx.numpy(), want_dx, **ECHO_TOL)


@pytest.mark.parametrize("tbt,ts", [(8, 8), (4, 8)])
def test_k7_bf16_plain_matches_pallas(rng, tbt, ts):
    """K7 forward and backward (plain versions and the plain fold) on a
    bf16 compact table against the interpreted Pallas _fwd_impl_compact
    and jax.vjp of _echo_compact_grid on the same cast table; the op within
    3e-2 of the f32 table's."""
    _, jt, _ = _panel_setup(rng, compressed=True)
    jc, tc = _compact(jt, tbt, ts)
    jh, th = _cast_both(jc, tc)
    N, C, n_bins = jt.n_pad, 5, 2
    nb, w2 = N // tbt, (2 * n_bins + 1) ** 2
    x = _features(rng, N, C)
    xr = jnp.concatenate([jnp.asarray(x[..., 0]), jnp.asarray(x[..., 1])], 1)
    src = jh.src_idx.reshape(-1)
    want = jep._fwd_impl_compact(xr[src].T, jh.sten, jh.meta, tbt, ts,
                                 n_bins, 2, nb)
    got = tep.echo_compact_grid(_t(x), th.sten, th.meta, th.src_idx, n_bins,
                                nb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ECHO_TOL)
    _scale_close(tep.echo_panel_fused(_t(x), th, n_bins),
                 tep.echo_panel_fused(_t(x), tc, n_bins), 3e-2)
    dg = rng.normal(size=(nb, 2 * w2, C, tbt)).astype(np.float32)
    _, vjp = jax.vjp(lambda xr_: jep._echo_compact_grid(
        xr_, jh.sten, jh.meta, src, tbt, ts, n_bins, C, nb), xr)
    (jdx,) = vjp(jnp.asarray(dg))
    want_dx = np.stack([np.asarray(jdx)[:, :C], np.asarray(jdx)[:, C:]], -1)
    dx = tep.echo_compact_grid_bwd(_t(dg), _t(x), th.sten, th.meta,
                                   th.src_idx, th.fold_order, th.fold_ptr,
                                   n_bins)
    np.testing.assert_allclose(dx.numpy(), want_dx, **ECHO_TOL)


# --- the lifts --------------------------------------------------------------------

def _lift_vjp(jfn, jtab, tfn, x, ca, cm):
    """(JAX, port) gradients of the lift's aggregation with respect to x
    for the cotangents (ca, cm); the JAX one jitted with the table ``jtab``
    as an argument (op by op, JAX would round the stencil products to bf16
    where the compiled lift keeps them in f32)."""
    def grad(x_, tab):
        _, vjp = jax.vjp(lambda y: jfn(y, tab), x_)
        return vjp((jnp.asarray(ca), jnp.asarray(cm)))[0]

    want = jax.jit(grad)(jnp.asarray(x), jtab)
    xa = _t(x).requires_grad_()
    ang, mag = tfn(xa)
    ((ang * _t(ca)).sum() + (mag * _t(cm)).sum()).backward()
    return np.asarray(want), xa.grad.numpy()


@pytest.mark.parametrize("compressed", [True, False])
def test_panel_lift_bf16_matches_jax(rng, compressed):
    """The block-panel lift (compressed and dense) on a bf16 table against
    the JAX lift compiled with the same cast table as an argument (as the
    JAX training passes it), values and the gradient with respect to x
    (_PanelLiftAggFn's backward against jax.vjp): ECHO_TOL; the same on
    the f32 table."""
    jt, jp, tp = _panels(rng, compressed)
    jh, th = _cast_both(jp, tp)
    cols = (1, 2)
    x = rng.normal(size=(jt.n_pad, 3)).astype(np.float32)
    ca = rng.normal(size=(jt.n_pad, 3, R, 2)).astype(np.float32)
    cm = rng.normal(size=(jt.n_pad, 3, R)).astype(np.float32)

    def jlift(x_, tab):
        return jtf.trans_field_panel_contrib(x_, tab, cols, panel_chunk=5)

    for jtab, ttab in ((jh, th), (jp, tp)):
        want = jax.jit(jlift)(jnp.asarray(x), jtab)
        got = ttf.trans_field_panel_contrib(_t(x), ttab, cols, panel_chunk=5)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **ECHO_TOL)
        want_dx, got_dx = _lift_vjp(
            jlift, jtab,
            lambda x_: ttf.trans_field_panel_contrib(x_, ttab, cols,
                                                     panel_chunk=5),
            x, ca, cm)
        assert np.abs(want_dx).max() > 0
        np.testing.assert_allclose(got_dx, want_dx, **ECHO_TOL)


def test_compact_lift_bf16_matches_jax(rng):
    """The compact lift on a bf16 table, and its VJP (_CompactLiftAggFn's
    backward and the plain fold), against the JAX lift on the same cast
    table (both cast each chunk to f32 on read): ECHO_TOL."""
    _, jt, _ = _panel_setup(rng, compressed=True)
    jc, tc = _compact(jt)
    jh, th = _cast_both(jc, tc)
    cols = (1, 2)
    x = rng.normal(size=(jt.n_pad, 3)).astype(np.float32)
    want = jax.jit(lambda x_: jtf.trans_field_compact_contrib(
        x_, jh, cols, panel_chunk=3))(jnp.asarray(x))
    got = ttf.trans_field_compact_contrib(_t(x), th, cols, panel_chunk=3)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **ECHO_TOL)
    ca = rng.normal(size=(jt.n_pad, 3, R, 2)).astype(np.float32)
    cm = rng.normal(size=(jt.n_pad, 3, R)).astype(np.float32)
    want_dx, got_dx = _lift_vjp(
        lambda x_, tab: jtf.trans_field_compact_contrib(x_, tab, cols,
                                                        panel_chunk=3), jh,
        lambda x_: ttf.trans_field_compact_contrib(x_, th, cols,
                                                   panel_chunk=3),
        x, ca, cm)
    np.testing.assert_allclose(got_dx, want_dx, **ECHO_TOL)


def test_panel_lift_sums_repeat_and_match_index_add(rng):
    """The panel lift's fixed-order sums (whole target runs, no scatter):
    two calls agree bitwise, and they equal an index_add over the same
    per-panel partials within f32 rounding."""
    jt, _, tp = _panels(rng)
    x = _t(rng.normal(size=(jt.n_pad, 3)))
    xb = x.reshape(-1, TB, 3)
    src = tp.meta[1].long()
    args = (lambda lo, hi: xb[src[lo:hi]], tp.sten,
            ttf._runs(tp.meta[0], xb.shape[0], 5), xb.shape[0], 3, R, B, 2)
    a, b = ttf._lift_sums(*args), ttf._lift_sums(*args)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    s1, sm = ttf._lift_stencils(tp.sten, R, B, 2)
    part = torch.einsum("rptsj,psc->ptcrj", s1, xb[src])
    seg = torch.zeros_like(a[0]).index_add_(0, tp.meta[0].long(), part)
    np.testing.assert_allclose(a[0].numpy(), seg.numpy(), **ECHO_TOL)


def test_lift_runs_built_once_per_table(rng, monkeypatch):
    """The lifts' run indices (the one host copy of a table's keys) are
    built on a table's first lift and reused after: two forward and
    backward calls of the panel lift build its runs by target and by
    source once, the compact lift its runs by target once, and a cast copy
    of a table builds its own."""
    built = []
    runs = ttf._runs
    monkeypatch.setattr(ttf, "_runs",
                        lambda *a: built.append(a[1:]) or runs(*a))
    jt, _, tp = _panels(rng)
    _, tc = _compact(jt)
    for lift, tab, n_runs in ((ttf.trans_field_panel_contrib, tp, 2),
                              (ttf.trans_field_compact_contrib, tc, 1)):
        for t in (tab, tab, tbanded.cast_panel_sten(tab), tab):
            x = _t(rng.normal(size=(jt.n_pad, 3))).requires_grad_()
            ang, mag = lift(x, t, (1, 2), panel_chunk=5)
            (ang.sum() + mag.sum()).backward()
        assert len(built) == 2 * n_runs, built
        built.clear()


# --- whole nets -------------------------------------------------------------------

@pytest.mark.parametrize("all_compact", [False, True])
def test_correspondence_net_on_bf16_tables_matches_jax(all_compact):
    """A small CorrespondenceNet (nf 4, n_des 4) on the pure-panel layout
    with the compact ECHO, its tables cast to bf16: the block panels (K5)
    and the compact table (K7, the compact lift), or all-compact (K6, K7
    and the compact lift on the one cast table).  The loss (cross entropy
    under one injected dropout mask) and every parameter's gradient
    against the JAX net on the same cast tables (its Pallas kernels
    interpreted): the loss within 5e-5, each gradient within NET_GRAD_TOL
    of its own scale."""
    kw = dict(task="correspondence", nf=4, n_des=4, band_limit=B,
              n_rings=R, n_bins=2, center=True, layout="panel",
              echo_impl="compact",
              **({"conv_impl": "compact"} if all_compact else {}))
    jcfg, tcfg = JaxConfig(**kw), ExperimentConfig(**kw)
    jrecs = _records(np.random.default_rng(5), "correspondence",
                     n_meshes=1, N=20, n_classes=3)
    jb = jloop.make_batches(jrecs, jcfg, 1, TB, 24, 8)[0]
    jcast = [jbanded.cast_panel_sten(c) for c in jb.compact]
    jb = dataclasses.replace(
        jb, compact=jcast, panel=jcast if all_compact else
        [jbanded.cast_panel_sten(p) for p in jb.panel])
    tb_ = train_100k.cast_batch(tloop.make_batches(
        _port_records(jrecs), tcfg, 1, TB, 24, 8, device="cpu")[0])
    assert (tb_.panel is tb_.compact) == all_compact
    assert tb_.compact.sten.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(tb_.panel.sten),
                                  _bits(jb.panel[0].sten))
    net = tloop.build_model(tcfg, 3, torch.Generator().manual_seed(0),
                            device="cpu")
    jnet = jloop.build_model(jcfg, 3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        params = _jax_params(net, jax.eval_shape(
            jnet.init, jax.random.key(0), jb.pos[0], None, jb.panel[0],
            jb.compact[0]))
    mask = (np.random.default_rng(6).random((24, 256)) < 0.5).astype(
        np.float32)
    labels = np.asarray(jb.labels[0])

    def jloss(p):
        logits = jnet.apply(p, jb.pos[0], None, jb.panel[0], jb.compact[0],
                            dropout_mask=jnp.asarray(mask))
        valid = labels >= 0
        lp = jax.nn.log_softmax(logits)
        per = -jnp.take_along_axis(lp, jnp.asarray(np.where(
            valid, labels, 0))[:, None], 1)[:, 0]
        return jnp.sum(jnp.where(valid, per, 0.0)) / valid.sum()

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    want = dict(zip(*_flat(jg)))
    logits = batched_apply(net, tb_, dropout_mask=_t(mask)[None])[0]
    lab = tb_.labels[0].long()
    valid = lab >= 0
    loss = torch.nn.functional.cross_entropy(logits[valid], lab[valid])
    grads = torch.autograd.grad(loss, list(net.parameters()))
    assert abs(loss.item() - float(jl)) <= 5e-5
    for (name, _), g in zip(net.named_parameters(), grads):
        ref = want[name]
        assert np.abs(g.numpy() - ref).max() <= NET_GRAD_TOL * np.abs(
            ref).max(), name


def _flat(tree):
    """(port parameter names, arrays) of a flax params tree."""
    from fieldconv_tpu_torch.utils.port_weights import params_from_jax

    sd = params_from_jax(jax.tree.map(np.asarray, tree))
    return list(sd), [v.numpy() for v in sd.values()]


# --- the 100k training script -----------------------------------------------------

def test_train_100k_steps_on_bf16_tables():
    """fieldconv_tpu_torch.scripts.train_100k on a small sphere, on the CPU
    (the plain versions): the default route (bf16 block panels and compact
    table), all-compact and T100K_COMPACT_TB=0 (K2 and the lift on the bf16
    block panels) each train 2 steps with finite, falling losses and log
    the probe accuracy at steps 0 and 1; the labels are the template
    buckets."""
    rec = sphere_record(np.random.default_rng(3), 600, 7)
    lab = train_100k.template_labels(600, 640)
    assert lab[0, 599] == 4999 * 599 // 600 and (lab[0, 600:] == -1).all()
    for ctb, all_compact in ((32, False), (32, True), (0, False)):
        b = train_100k.build_batch(rec, ctb, all_compact, True, "cpu")
        assert b.panel.sten.dtype == torch.bfloat16
        assert (b.compact is None) == (ctb == 0)
        logged = []
        _, records, losses = train_100k.train(b, 2, log_every=10, seed=0,
                                              emit=logged.append)
        assert logged == records and [r["step"] for r in records] == [0, 1]
        assert np.isfinite(losses).all() and losses[1] < losses[0]
        assert all(0 <= r["probe_acc"] <= 1 for r in records)


def test_train_step_and_evaluation_on_cast_tables():
    """make_train_step and evaluate_task run on a batch whose tables were
    cast (no config option: the caller casts, as the JAX script does): the
    correspondence net on the pure-panel layout with the compact ECHO, on
    the CPU.  The step's loss and the evaluation's cross entropy within
    2e-2 of the f32 tables' (the JAX test's conv bar), the step's
    parameters finite."""
    kw = dict(task="correspondence", nf=4, n_des=4, band_limit=B,
              n_rings=R, n_bins=2, center=True, layout="panel",
              echo_impl="compact")
    cfg = ExperimentConfig(**kw)
    recs = _port_records(_records(np.random.default_rng(7),
                                  "correspondence", n_meshes=1, N=20,
                                  n_classes=3))
    b32 = tloop.make_batches(recs, cfg, 1, TB, 24, 8, device="cpu")[0]
    out = {}
    for name, b in (("f32", b32), ("bf16", train_100k.cast_batch(b32))):
        net = tloop.build_model(cfg, 3, torch.Generator().manual_seed(0),
                                device="cpu")
        step = ttrainer.make_train_step(
            net, cfg, 3, ttrainer.make_optimizer(cfg, net.parameters()))
        loss = step(b, torch.Generator().manual_seed(1)).item()
        assert all(torch.isfinite(p).all() for p in net.parameters())
        out[name] = (loss, tloop.evaluate_task(net, cfg, [b], 3))
    for a, b in zip(out["bf16"], out["f32"]):
        assert np.isfinite(a) and abs(a - b) <= 2e-2 * abs(b)
