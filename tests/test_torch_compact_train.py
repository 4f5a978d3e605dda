"""The port's compact-route training slice against the JAX package's, on the CPU.

Training on the compact route runs ECHO through K7 forward and backward
(``_EchoCompactFn``) over one CompactPanelTable per batch and, with
conv_impl="compact", every conv through K6 forward and backward
(``_BandCompactFn``); both backwards end in the compact fold, which reads
the table's fold index.  Here their plain versions run; the JAX side runs
its Pallas kernels in interpret mode.  Tolerances, each with its reason:

- the fold index and the plain fold: equal, bit for bit (the fold index is
  integer bookkeeping; the plain fold, JAX's segment_sum and the kernel's
  order, a row's live columns in ascending column order from 0, add the
  same f32 values in the same order);
- K6's and K7's plain backwards against the interpreted
  ``_band_compact_bwd_impl`` / ``_bwd_impl_compact`` (before the fold) and
  against ``jax.vjp`` of ``_band_compact`` / ``_echo_compact_grid`` (after
  it), the compact lift's backward against ``jax.vjp`` of
  ``trans_field_compact_contrib``, and ``_BandCompactFn`` /
  ``_EchoCompactFn`` against torch.autograd of their plain forwards:
  atol 3e-5 / rtol 2e-5 (``ECHO_TOL``: f32 sums over a panel's slots,
  rings and targets, and over a row's columns, in another order);
- the 3-step all-compact correspondence trajectory against the JAX gather
  route: losses within 5e-5 and parameters within 1e-4, the bars of
  tests/test_torch_panel_train.py's trajectory;
- the segmentation loss on the mixed compact route against the JAX gather
  route: rtol 1e-5, every parameter's gradient within 1e-4 of its scale
  (tests/test_torch_train.py::_close_to_scale, as the mixed route's own
  test);
- the evaluation after a compact ``fit``: the mean cross entropy within
  rtol 1e-5 of the JAX evaluation, as on the pure-panel layout;
- ``remat_blocks`` on the all-compact route: bitwise equal (the same ops
  run again in the same order).
"""

import json
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_band_conv import _panel_setup
from test_deploy import _records
from test_torch_compact import SHAPES, _compact
from test_torch_echo import (ECHO_TOL, TB, _features, _jax_params,
                             _port_records, _t)
from test_torch_echo_train import _PRESET
from test_torch_panel_train import P_DROP, _masked_net
from test_torch_train import _close_to_scale
from fieldconv_tpu.nn import losses as jlosses
from fieldconv_tpu.ops import trans_field as jtf
from fieldconv_tpu.ops.pallas import band_conv as jbc
from fieldconv_tpu.ops.pallas import echo_panel as jep
from fieldconv_tpu.train import evaluate as jevaluate
from fieldconv_tpu.train import loop as jloop
from fieldconv_tpu.train import trainer as jtrainer
from fieldconv_tpu.train.config import ExperimentConfig as JaxConfig
from fieldconv_tpu_torch import kernels
from fieldconv_tpu_torch.ops import band_conv as tbc
from fieldconv_tpu_torch.ops import compact_fold as tcf
from fieldconv_tpu_torch.ops import echo as techo
from fieldconv_tpu_torch.ops import echo_panel as tep
from fieldconv_tpu_torch.ops import trans_field as ttf
from fieldconv_tpu_torch.precomp import banded as tbanded
from fieldconv_tpu_torch.train import loop as tloop
from fieldconv_tpu_torch.train import trainer as ttrainer
from fieldconv_tpu_torch.train.config import ExperimentConfig
from fieldconv_tpu_torch.utils.complexops import soft_abs
from fieldconv_tpu_torch.utils.port_weights import params_from_jax

torch.set_num_threads(1)   # one per xdist worker: see test_torch_ops.py

C, O2, R, B = 4, 6, 3, 1
K = 2 * B + 1


def _live(table):
    """The live columns of a compact table (any occupied slot), (P·TS,)."""
    return (table.sten[:, 0] != tbanded.R_SENTINEL).any(1).reshape(-1).numpy()


# --- the fold ---------------------------------------------------------------------

def test_fold_index_inverts_src_idx(rng):
    """fold_order is a stable argsort by source row of the live columns'
    flat indices and fold_ptr each row's run, for two meshes' tables and
    their join (columns offset by the panels before, runs by the live
    columns before).  The plain fold equals JAX's segment_sum and the sum
    over the fold index in its order, bit for bit, for per-column values
    whose dead columns are zero."""
    tabs = [_compact(_panel_setup(rng, compressed=True)[1], 4, 8)[1]
            for _ in range(2)]
    joined = tbanded.concat_compact_panel_tables(tabs)
    for t in (*tabs, joined):
        rows = t.n_mesh * t.n_pad
        cols = np.flatnonzero(_live(t))
        src = t.src_idx.numpy().reshape(-1)[cols]
        np.testing.assert_array_equal(t.fold_order.numpy(),
                                      cols[np.argsort(src, kind="stable")])
        np.testing.assert_array_equal(t.fold_ptr.numpy(), np.concatenate(
            [[0], np.cumsum(np.bincount(src, minlength=rows))]))
    P0 = tabs[0].n_panels
    np.testing.assert_array_equal(joined.fold_order.numpy(), np.concatenate(
        [tabs[0].fold_order.numpy(), tabs[1].fold_order.numpy() + P0 * 8]))

    rows = joined.n_mesh * joined.n_pad
    vals = (rng.normal(size=(_live(joined).size, 5))
            * _live(joined)[:, None]).astype(np.float32)
    got = tcf.compact_fold(_t(vals), joined.src_idx, joined.fold_order,
                           joined.fold_ptr, rows).numpy()
    want = jax.ops.segment_sum(jnp.asarray(vals),
                               jnp.asarray(joined.src_idx.numpy().ravel()),
                               num_segments=rows)
    np.testing.assert_array_equal(got, np.asarray(want))
    order, ptr = joined.fold_order.numpy(), joined.fold_ptr.numpy()
    walked = np.zeros_like(got)
    for v in range(rows):
        for i in range(ptr[v], ptr[v + 1]):
            walked[v] = walked[v] + vals[order[i]]
    np.testing.assert_array_equal(got, walked)


# --- K6 backward --------------------------------------------------------------------

def _k6_case(rng, tbt, ts):
    _, jt, _ = _panel_setup(rng, compressed=True)
    jc, tc = _compact(jt, tbt, ts)
    M = K * 2 * C
    g = rng.normal(size=(jt.n_pad, M)).astype(np.float32)
    w = (rng.normal(size=(R, M, O2)) / np.sqrt(R * M)).astype(np.float32)
    dy = rng.normal(size=(jt.n_pad, O2)).astype(np.float32)
    return jc, tc, g, w, dy


@SHAPES
def test_k6_bwd_plain_matches_pallas(rng, tbt, ts):
    """band_compact_bwd_reference against the interpreted Pallas
    _band_compact_bwd_impl on the gathered rows (the per-panel dG blocks
    and dW, before the fold), and band_compact_bwd (on CPU tensors: the
    plain version and the plain fold) against jax.vjp of the JAX custom VJP
    _band_compact, whose backward runs the same kernel and the
    segment_sum."""
    jc, tc, g, w, dy = _k6_case(rng, tbt, ts)
    N = g.shape[0]
    src = jc.src_idx.reshape(-1)
    want_gg, want_w = jbc._band_compact_bwd_impl(
        jnp.asarray(dy), jnp.asarray(g)[src], jnp.asarray(w), jc.sten,
        jc.meta, tbt, ts, R, B, True, "f32")
    before = dict(kernels.launches)
    dgg, dw = tbc.band_compact_bwd_reference(_t(dy), _t(g), _t(w), tc.sten,
                                             tc.meta, tc.src_idx, tbt, R, B)
    assert np.abs(np.asarray(want_gg)).max() > 0.3
    np.testing.assert_allclose(dgg.numpy(), np.asarray(want_gg), **ECHO_TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_w), **ECHO_TOL)

    _, vjp = jax.vjp(lambda g_, w_: jbc._band_compact(
        g_, w_, jc.sten, jc.meta, src, tbt, ts, R, B, True, "f32", N),
        jnp.asarray(g), jnp.asarray(w))
    want_g, want_w = vjp(jnp.asarray(dy))
    dg, dw = tbc.band_compact_bwd(_t(dy), _t(g), _t(w), tc.sten, tc.meta,
                                  tc.src_idx, tc.fold_order, tc.fold_ptr,
                                  tbt, R, B)
    assert kernels.launches == before            # CPU: the plain versions
    np.testing.assert_allclose(dg.numpy(), np.asarray(want_g), **ECHO_TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_w), **ECHO_TOL)


@SHAPES
def test_band_compact_fn_matches_autograd_of_plain(rng, tbt, ts):
    """_BandCompactFn (what field_conv_banded's CompactPanelTable branch
    calls) with its explicit plain backward gives what torch.autograd
    through the plain forward gives: the gradients of g and W, on CPU
    tensors without a kernel launch."""
    _, tc, g, w, dy = _k6_case(rng, tbt, ts)
    table = (tc.sten, tc.meta, tc.src_idx)
    before = dict(kernels.launches)
    ga, wa = _t(g).requires_grad_(), _t(w).requires_grad_()
    y = tbc._BandCompactFn.apply(ga, wa, *table, tc.fold_order, tc.fold_ptr,
                                 tbt, R, B)
    (y * _t(dy)).sum().backward()
    assert kernels.launches == before
    gb, wb = _t(g).requires_grad_(), _t(w).requires_grad_()
    (tbc.band_compact_fwd_reference(gb, wb, *table, tbt, R, B)
     * _t(dy)).sum().backward()
    assert ga.grad.abs().max() > 0
    np.testing.assert_allclose(ga.grad.numpy(), gb.grad.numpy(), **ECHO_TOL)
    np.testing.assert_allclose(wa.grad.numpy(), wb.grad.numpy(), **ECHO_TOL)


# --- K7 backward --------------------------------------------------------------------

@SHAPES
def test_k7_bwd_plain_matches_pallas(rng, tbt, ts):
    """echo_compact_grid_bwd_reference against the interpreted Pallas
    _bwd_impl_compact on the gathered channel-major columns (the per-column
    gradients, before the fold), with origin features; and
    echo_compact_grid_bwd (plain version and fold) against jax.vjp of the
    JAX custom VJP _echo_compact_grid, for a contiguous cotangent and one
    in the layout autograd hands over (cells minor).  Origin features get
    no gradient."""
    _, jt, _ = _panel_setup(rng, compressed=True)
    jc, tc = _compact(jt, tbt, ts)
    N, Ce, n_bins = jt.n_pad, 5, 2
    nb, w2 = N // tbt, (2 * n_bins + 1) ** 2
    x = _features(rng, N, Ce)
    dg = rng.normal(size=(nb, 2 * w2, Ce, tbt)).astype(np.float32)
    xr = jnp.concatenate([jnp.asarray(x[..., 0]), jnp.asarray(x[..., 1])], 1)
    src = jc.src_idx.reshape(-1)
    want = np.asarray(jep._bwd_impl_compact(jnp.asarray(dg), xr[src].T,
                                            jc.sten, jc.meta, tbt, ts,
                                            n_bins, Ce))
    want = np.stack([want[:Ce].T, want[Ce:].T], -1)      # (P·TS, C, 2)
    before = dict(kernels.launches)
    got = tep.echo_compact_grid_bwd_reference(_t(dg), _t(x), tc.sten, tc.meta,
                                              tc.src_idx, n_bins).numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, **ECHO_TOL)

    _, vjp = jax.vjp(lambda xr_: jep._echo_compact_grid(
        xr_, jc.sten, jc.meta, src, tbt, ts, n_bins, Ce, nb), xr)
    (jdx,) = vjp(jnp.asarray(dg))
    want_dx = np.stack([np.asarray(jdx)[:, :Ce], np.asarray(jdx)[:, Ce:]], -1)
    cells_minor = _t(dg).permute(0, 3, 2, 1).contiguous().permute(0, 3, 2, 1)
    for cot in (_t(dg), cells_minor):
        dx = tep.echo_compact_grid_bwd(cot, _t(x), tc.sten, tc.meta,
                                       tc.src_idx, tc.fold_order,
                                       tc.fold_ptr, n_bins).numpy()
        np.testing.assert_allclose(dx, want_dx, **ECHO_TOL)
    assert kernels.launches == before            # CPU: the plain versions
    zero = (x == 0).all(-1)
    assert zero.any() and not dx[zero].any()


@pytest.mark.parametrize("n_bins", [2, 3])
def test_echo_compact_fn_matches_autograd_of_plain(rng, n_bins):
    """echo_panel_fused's gradient over a CompactPanelTable, through
    _EchoCompactFn and the explicit plain backward, equals torch.autograd
    through the plain forward (echo_compact_grid_reference) followed by the
    same fold and soft_abs; on CPU tensors no kernel is launched."""
    _, jt, _ = _panel_setup(rng, compressed=True)
    _, tc = _compact(jt, 4, 8)
    N, Ce, w = jt.n_pad, 4, 2 * n_bins + 1
    x = _features(rng, N, Ce)
    cot = _t(rng.normal(size=(N, Ce, techo.hist_dim(n_bins))))
    before = dict(kernels.launches)
    xa = _t(x).requires_grad_()
    (tep.echo_panel_fused(xa, tc, n_bins) * cot).sum().backward()
    assert kernels.launches == before

    xb = _t(x).requires_grad_()
    grid = tep.echo_compact_grid_reference(xb, tc.sten, tc.meta, tc.src_idx,
                                           n_bins, N // 4)
    grid4 = grid.permute(0, 3, 2, 1).reshape(N, Ce, 2, w * w)
    hist = torch.einsum("ncpu,us->ncsp", grid4,
                        techo.fold_matrix(n_bins, "cpu"))
    (soft_abs(hist) * cot).sum().backward()
    assert xb.grad.abs().max() > 0
    np.testing.assert_allclose(xa.grad.numpy(), xb.grad.numpy(), **ECHO_TOL)


# --- the compact lift ---------------------------------------------------------------

@pytest.mark.parametrize("lift_cols", [(1, 2), (0, 1)])
def test_compact_lift_vjp_matches_jax(rng, lift_cols):
    """The gradient of the compact lift's aggregation with respect to x
    (_CompactLiftAggFn's backward, the plain fold on CPU tensors, plus the
    target-row term by autograd) against jax.vjp of the JAX
    trans_field_compact_contrib (its custom VJP _compact_lift_agg), over a
    rectangular table walked 3 panels at a time."""
    _, jt, _ = _panel_setup(rng, compressed=True, B=1)
    jc, tc = _compact(jt, 4, 8)
    x = rng.normal(size=(jt.n_pad, 3)).astype(np.float32)
    ca = rng.normal(size=(jt.n_pad, 3, jt.n_rings, 2)).astype(np.float32)
    cm = rng.normal(size=(jt.n_pad, 3, jt.n_rings)).astype(np.float32)
    _, vjp = jax.vjp(lambda x_: jtf.trans_field_compact_contrib(
        x_, jc, lift_cols, panel_chunk=3), jnp.asarray(x))
    (want,) = vjp((jnp.asarray(ca), jnp.asarray(cm)))
    before = dict(kernels.launches)
    xa = _t(x).requires_grad_()
    ang, mag = ttf.trans_field_compact_contrib(xa, tc, lift_cols,
                                               panel_chunk=3)
    ((ang * _t(ca)).sum() + (mag * _t(cm)).sum()).backward()
    assert kernels.launches == before
    assert np.abs(np.asarray(want)).max() > 0
    np.testing.assert_allclose(xa.grad.numpy(), np.asarray(want), **ECHO_TOL)


# --- the nets on the compact route against the JAX gather route ---------------------

def _setup(task, seed, n_meshes=1, **more):
    """Records, the JAX net and its flax params holding the port net's init,
    the JAX gather-route batches (plain XLA) and the port's compact batch of
    the first mesh: for correspondence the all-compact pure-panel layout
    (layout="panel", conv_impl="compact": K6 convs, K7 and the compact
    lift), for segmentation the mixed route with the compact ECHO (K1
    convs, K7 and the compact lift)."""
    kw = dict(task=task, nf=4, n_des=4, echo_impl="compact", **_PRESET[task],
              **more)
    port = dict(layout="panel", conv_impl="compact") \
        if task == "correspondence" else {}
    tcfg = ExperimentConfig(**kw, **port)
    # the gather route runs no compact op: conv_impl is moot there, and the
    # JAX config refuses conv_impl="compact" once the batches fall back to
    # the one-hot ECHO
    jcfg = JaxConfig(**kw)
    jrecs = _records(np.random.default_rng(seed), task, n_meshes=n_meshes,
                     N=20, n_classes=3)
    jnet = jloop.build_model(jcfg, 3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")            # the one-hot fallback
        jbs = jloop.make_batches(jrecs, jcfg, 1, None, 24, 8)
    net = tloop.build_model(tcfg, 3, torch.Generator().manual_seed(seed),
                            device="cpu")
    shapes = jax.eval_shape(jnet.init, jax.random.key(seed), jbs[0].pos[0],
                            jax.tree.map(lambda a: a[0], jbs[0].table))
    recs = _port_records(jrecs)
    tb_ = tloop.make_batches(recs[:1], tcfg, 1, TB, 24, 8, device="cpu")[0]
    assert tb_.compact is not None
    assert (tb_.panel is tb_.compact) == (task == "correspondence")
    return types.SimpleNamespace(jcfg=jcfg, tcfg=tcfg, jnet=jnet, jbs=jbs,
                                 net=net, shapes=shapes,
                                 params=_jax_params(net, shapes), tb=tb_,
                                 recs=recs)


def test_correspondence_trajectory_all_compact_matches_jax():
    """3 steps of the port's make_train_step on the all-compact route (K6
    forward and backward, K7 and the compact lift, plain versions) against
    the JAX make_train_step on its gather route, same initial weights, the
    JAX step's rotation and dropout draws injected into the port's step."""
    s = _setup("correspondence", seed=0)
    jopt = jtrainer.make_optimizer(s.jcfg, 1)
    state = jtrainer.TrainState(s.params, jopt.init(s.params),
                                jnp.zeros((), jnp.int32))
    jstep = jtrainer.make_train_step(_masked_net(s.jnet), s.jcfg, 3, jopt)
    topt = ttrainer.make_optimizer(s.tcfg, s.net.parameters())
    tstep = ttrainer.make_train_step(s.net, s.tcfg, 3, topt)
    before = dict(kernels.launches)
    key = jax.random.key(1)
    j_losses, t_losses = [], []
    for _ in range(3):
        key, sub = jax.random.split(key)
        state, metrics = jstep(state, sub, s.jbs[0])
        j_losses.append(float(metrics["loss"]))
        # random_rotate_scale and the dropout both use split(sub)[0]
        kd, _ = jax.random.split(sub)
        deg = s.jcfg.random_rotate_deg
        angles = jax.random.uniform(kd, (1, 3), minval=-deg,
                                    maxval=deg) * (jnp.pi / 180.0)
        mask = jax.random.bernoulli(kd, 1.0 - P_DROP, (24, 256))
        t_losses.append(float(tstep(s.tb, aug=(_t(angles), None),
                                    dropout_mask=_t(mask)[None])))
    assert kernels.launches == before          # CPU: the plain versions
    np.testing.assert_allclose(t_losses, j_losses, atol=5e-5, rtol=0)
    assert len(set(j_losses)) == 3
    want = params_from_jax(jax.tree.map(np.asarray, state.params))
    for name, p in s.net.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-4,
                                   err_msg=name)


def test_remat_blocks_all_compact_is_bitwise_equal():
    """remat_blocks on the all-compact route (each FCResNetBlock's K6 convs
    run again in the backward): the loss and every gradient of a step are
    bitwise those of the same net without it."""
    s = _setup("correspondence", seed=2)
    remat = tloop.build_model(s.tcfg, 3, device="cpu")
    remat.remat_blocks = True
    remat.load_state_dict(s.net.state_dict(), strict=True)
    aug = (torch.zeros(1, 3), None)
    mask = _t(np.random.default_rng(4).random((1, 24, 256)) < 0.5)
    out = []
    for net in (s.net, remat):
        loss = ttrainer.make_loss_fn(net, s.tcfg, 3)(s.tb, aug=aug,
                                                     dropout_mask=mask)
        out.append((loss, torch.autograd.grad(loss, list(net.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_segmentation_compact_grads_match_jax():
    """The port's segmentation loss (label smoothing 0.2) on the mixed route
    with the compact ECHO (K1 convs, K7 and the compact lift, forward and
    backward through the plain versions) and every parameter's gradient,
    against jax.value_and_grad of the JAX net on its gather route, no
    augmentation, one mesh."""
    s = _setup("segmentation", seed=2)
    jb = s.jbs[0]

    def jloss(params):
        logits = jtrainer.batched_apply(s.jnet, params, jb)
        return jlosses.label_smoothing_loss(
            logits.reshape(-1, 3), jb.labels.reshape(-1), 3,
            smoothing=s.jcfg.smoothing)

    want, want_g = jax.jit(jax.value_and_grad(jloss))(s.params)
    want_g = params_from_jax(jax.tree.map(np.asarray, want_g))
    before = dict(kernels.launches)
    got = ttrainer.make_loss_fn(s.net, s.tcfg, 3)(
        s.tb, aug=(torch.zeros(1, 3), None))
    names, params = zip(*s.net.named_parameters())
    grads = torch.autograd.grad(got, params)
    assert kernels.launches == before
    assert s.tb.banded is not None and s.tb.compact.tb == TB
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for name, g in zip(names, grads):
        assert want_g[name].abs().max() > 0, name
        _close_to_scale(g, want_g[name])


def test_fit_all_compact_and_evaluation_match_jax(tmp_path):
    """fit(device="cpu") on a bucket on the all-compact route: one JSONL
    line per step with a finite loss, and its test metric (the mean test
    cross entropy, evaluate_task over compact batches) equals the JAX
    correspondence evaluation of the trained weights on the gather route;
    evaluate_task gives the same metric again on batches built apart."""
    s = _setup("correspondence", seed=3, n_meshes=3, epochs=1)
    log = tmp_path / "fit.jsonl"
    net, opt, metric = tloop.fit(s.tcfg, s.recs[:2], s.recs[2:], n_classes=3,
                                 banded_tb=TB, log_path=str(log), seed=5,
                                 device="cpu")
    lines = [json.loads(line) for line in log.read_text().splitlines()]
    assert int(opt.step) == 2 and [r["step"] for r in lines] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in lines)
    jnet = types.SimpleNamespace(apply=jax.jit(
        s.jnet.apply, static_argnames=("deterministic",)))
    want = jevaluate.correspondence_loss(jnet, _jax_params(net, s.shapes),
                                         s.jbs[2:], 3)
    assert np.isfinite(metric) and metric == pytest.approx(want, rel=1e-5)
    assert net.training
    test = tloop.make_batches(s.recs[2:], s.tcfg, 1, TB, 24, 8, device="cpu")
    assert test[0].panel is test[0].compact
    assert tloop.evaluate_task(net, s.tcfg, test, 3) == metric
    assert net.training
