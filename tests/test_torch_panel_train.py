"""The port's pure-panel training slice against the JAX package's, on the CPU.

Training on the pure-panel layout runs every conv through K5 forward and
backward (the panel conv, ``_BandPanelFn``) and ECHO through K2; here their
plain versions run.  Both packages get the same numpy inputs; the JAX side
runs its Pallas kernels in interpret mode.  Tolerances, each with its
reason:

- K5's plain backward against the interpreted Pallas
  ``_band_panel_bwd_impl``: atol 3e-5 / rtol 2e-5 (``ECHO_TOL``, the bar
  of K2's backward in tests/test_torch_echo_train.py: dg sums over a
  source's panels and slots, dw over every target row, in another order),
  on dg of scale ~1 and dw of scale ~10;
- ``_BandPanelFn`` against torch.autograd of the plain forward: the same
  bar;
- the 3-step correspondence trajectory (port pure-panel route, JAX gather
  route): losses within 5e-5 and parameters within 1e-4, the bars of
  tests/test_torch_echo_train.py's trajectory;
- the evaluation after a pure-panel ``fit``: the mean cross entropy within
  rtol 1e-5; the features of ``return_features``: ``NET_TOL``;
- ``remat_blocks``: bitwise equal (the same ops run again in the same
  order).
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
from test_torch_echo import (ECHO_TOL, NET_TOL, TB, _jax_params,
                             _port_records, _port_table, _t)
from test_torch_echo_train import _configs
from fieldconv_tpu.ops.pallas import band_conv as jbc
from fieldconv_tpu.train import evaluate as jevaluate
from fieldconv_tpu.train import loop as jloop
from fieldconv_tpu.train import trainer as jtrainer
from fieldconv_tpu_torch import kernels
from fieldconv_tpu_torch.ops import band_conv as tbc
from fieldconv_tpu_torch.precomp import banded as tbanded
from fieldconv_tpu_torch.train import loop as tloop
from fieldconv_tpu_torch.train import trainer as ttrainer
from fieldconv_tpu_torch.utils.port_weights import params_from_jax

torch.set_num_threads(1)   # one per xdist worker: see test_torch_ops.py

C, O2, R, B = 4, 6, 3, 1
K = 2 * B + 1


def _k5_case(rng, compressed, chunk):
    """A kd-ordered ragged graph's panel table at tb=8 in both packages, g
    (N, K·2C), a W of an initialised filter bank's scale and dy."""
    _, jt, jp = _panel_setup(rng, compressed=compressed, chunk=chunk)
    tp = tbanded.build_panel_table(_port_table(jt), tb=TB,
                                   compressed=compressed, chunk=chunk)
    M = K * 2 * C
    g = rng.normal(size=(jt.n_pad, M)).astype(np.float32)
    w = (rng.normal(size=(R, M, O2)) / np.sqrt(R * M)).astype(np.float32)
    dy = rng.normal(size=(jt.n_pad, O2)).astype(np.float32)
    return jp, tp, g, w, dy


def _jax_bwd(jp, sten, meta_s, g, w, dy, compressed, chunk):
    dg, dw = jbc._band_panel_bwd_impl(
        jnp.asarray(dy), jnp.asarray(g), jnp.asarray(w), sten,
        jnp.asarray(meta_s), None, TB, R, B, compressed, "f32", chunk)
    return np.asarray(dg), np.asarray(dw)


# --- K5 backward ----------------------------------------------------------------

@pytest.mark.parametrize("compressed,chunk", [(False, 1), (True, 1),
                                              (True, 4)])
def test_k5_bwd_plain_matches_pallas(rng, compressed, chunk):
    """band_panel_bwd (its plain version, on CPU tensors) against the Pallas
    _band_panel_bwd_impl interpreted (coverage None): dense and compressed
    planes, and a chunked table whose source runs are padded with zero
    panels.  Every source block has a panel, so dg is compared whole."""
    jp, tp, g, w, dy = _k5_case(rng, compressed, chunk)
    np.testing.assert_array_equal(tp.meta_s.numpy(), np.asarray(jp.meta_s))
    want_g, want_w = _jax_bwd(jp, jp.sten, jp.meta_s, g, w, dy, compressed,
                              chunk)
    before = dict(kernels.launches)
    got_g, got_w = tbc.band_panel_bwd(_t(dy), _t(g), _t(w), tp.sten, tp.meta,
                                      tp.meta_s, TB, R, B, compressed)
    assert kernels.launches == before            # CPU: the plain version
    assert np.isfinite(want_g).all() and np.abs(want_g).max() > 0.3
    np.testing.assert_allclose(got_g.numpy(), want_g, **ECHO_TOL)
    np.testing.assert_allclose(got_w.numpy(), want_w, **ECHO_TOL)


def test_k5_bwd_uncovered_block_gets_zeros(rng):
    """A table from which every panel with source block 1 is dropped (the
    stencil and both orders renumbered): the port's plain backward gives
    that block's dg rows zeros, where the Pallas kernel never writes them
    (not asserted: its graph-parallel caller masks them with ``coverage``,
    ROADMAP Queue 3); every other row and dw match it."""
    jp, tp, g, w, dy = _k5_case(rng, True, 1)
    meta_s = tp.meta_s.numpy()
    keep = meta_s[2] != 1
    assert (~keep).any()
    kept = np.sort(meta_s[0, keep])
    remap = np.full(tp.n_panels, -1, np.int64)
    remap[kept] = np.arange(len(kept))
    sub_s = meta_s[:, keep].copy()
    sub_s[0] = remap[sub_s[0]]
    meta = tp.meta.numpy()[:, kept]
    want_g, want_w = _jax_bwd(jp, jnp.asarray(np.asarray(jp.sten)[kept]),
                              sub_s, g, w, dy, True, 1)
    got_g, got_w = tbc.band_panel_bwd(
        _t(dy), _t(g), _t(w), tp.sten[torch.from_numpy(kept)],
        torch.from_numpy(meta), torch.from_numpy(sub_s), TB, R, B, True)
    rows = np.arange(len(g)) // TB != 1
    assert np.isfinite(want_g[rows]).all()
    np.testing.assert_allclose(got_g.numpy()[rows], want_g[rows], **ECHO_TOL)
    assert not got_g.numpy()[~rows].any()
    np.testing.assert_allclose(got_w.numpy(), want_w, **ECHO_TOL)


@pytest.mark.parametrize("compressed", [True, False])
def test_band_panel_fn_matches_autograd_of_plain(rng, compressed):
    """_BandPanelFn (what field_conv_banded's PanelTable branch calls) with
    its explicit plain backward gives what torch.autograd through the plain
    forward (band_panel_fwd_reference, the CPU path before it) gives: the
    gradients of g and W, on CPU tensors without a kernel launch."""
    _, tp, g, w, dy = _k5_case(rng, compressed, 1)
    args = (tp.sten, tp.meta, TB, R, B, compressed)
    before = dict(kernels.launches)
    ga, wa = _t(g).requires_grad_(), _t(w).requires_grad_()
    y = tbc._BandPanelFn.apply(ga, wa, tp.sten, tp.meta, tp.meta_s, TB, R, B,
                               compressed)
    (y * _t(dy)).sum().backward()
    assert kernels.launches == before
    gb, wb = _t(g).requires_grad_(), _t(w).requires_grad_()
    (tbc.band_panel_fwd_reference(gb, wb, *args) * _t(dy)).sum().backward()
    assert ga.grad.abs().max() > 0
    np.testing.assert_allclose(ga.grad.numpy(), gb.grad.numpy(), **ECHO_TOL)
    np.testing.assert_allclose(wa.grad.numpy(), wb.grad.numpy(), **ECHO_TOL)


# --- the correspondence net on the pure-panel route -------------------------------

P_DROP = 0.5


def _setup(seed, n_meshes=1, **more):
    """Correspondence records, the JAX net and its flax params holding the
    port net's init, the JAX gather-route batch (plain XLA) and the port's
    pure-panel batch (layout="panel", tb=8: K5 convs, K2 and the panel
    lift) of the first mesh."""
    jcfg, tcfg = _configs("correspondence", layout="panel", **more)
    jrecs = _records(np.random.default_rng(seed), "correspondence",
                     n_meshes=n_meshes, N=20, n_classes=3)
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
    assert tb_.banded is None and tb_.panel is not None
    return types.SimpleNamespace(jcfg=jcfg, tcfg=tcfg, jnet=jnet, jbs=jbs,
                                 net=net, shapes=shapes,
                                 params=_jax_params(net, shapes), tb=tb_,
                                 recs=recs)


def _masked_net(jnet, n_lin1=256):
    """The JAX net with its dropout realised as an explicit keep mask drawn
    from the step's dropout key (bernoulli(kd, 1 − p)), so that the port's
    step can be handed the same mask."""
    def apply(params, pos, table, *a, rngs=None, deterministic=True, **kw):
        if rngs is not None:
            kw["dropout_mask"] = jax.random.bernoulli(
                rngs["dropout"], 1.0 - P_DROP,
                (pos.shape[0], n_lin1)).astype(jnp.float32)
        return jnet.apply(params, pos, table, *a, **kw)
    return types.SimpleNamespace(apply=apply)


def test_correspondence_trajectory_pure_panel_matches_jax():
    """3 steps of the port's make_train_step on the pure-panel route (K5
    forward and backward, K2 and the panel lift, plain versions) against
    the JAX make_train_step on its gather route, same initial weights, the
    JAX step's rotation and dropout draws injected into the port's step."""
    s = _setup(seed=0)
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


def test_fit_panel_bucket_and_evaluation_match_jax(tmp_path):
    """fit(device="cpu") on a bucket forced onto the pure-panel layout: one
    JSONL line per step with a finite loss, and its test metric (the mean
    test cross entropy, evaluate_task over pure-panel batches) equals the
    JAX correspondence evaluation of the trained weights on the gather
    route."""
    s = _setup(seed=3, n_meshes=3, epochs=1)
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


def test_remat_blocks_is_bitwise_equal():
    """remat_blocks recomputes each FCResNetBlock in the backward: the loss
    and every gradient of a pure-panel correspondence step are bitwise
    those of the same net without it, and the parameters are the same."""
    s = _setup(seed=2)
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


def test_return_features_matches_jax():
    """return_features gives the 256-wide features that enter lin2 (in
    eval(): no dropout), equal to the JAX net's clone(return_features=True)
    on the gather route; lin2 of them gives the net's logits."""
    s = _setup(seed=1)
    feat = jax.jit(lambda p, pos, t: s.jnet.clone(return_features=True)
                   .apply(p, pos, t))
    jb = s.jbs[0]
    want = np.asarray(feat(s.params, jb.pos[0],
                           jax.tree.map(lambda a: a[0], jb.table)))
    net = s.net.eval()
    with torch.no_grad():
        logits = ttrainer.batched_apply(net, s.tb)
        net.return_features = True
        got = ttrainer.batched_apply(net, s.tb)
    assert got.shape == (1, 24, 256) and want.shape == (24, 256)
    np.testing.assert_allclose(got[0].numpy(), want, **NET_TOL)
    torch.testing.assert_close(net.lin2(got), logits, rtol=0, atol=0)
