"""The port's ECHO training slice against the JAX package's, on the CPU.

Both packages get the same numpy inputs; the JAX side runs its Pallas
kernels in interpret mode.  Tolerances, each with its reason:

- K2's plain backward against the interpreted Pallas ``_bwd_impl``: atol
  3e-5, rtol 2e-5 (``ECHO_TOL``, the bar of tests/test_torch_echo.py: sums
  over a source's targets and panels in another order);
- the autograd op against autograd of the plain forward: the same bar;
- the 3-step segmentation trajectory: losses within 5e-5 and parameters
  within 1e-4, the bars of tests/test_torch_train.py's trajectory;
- the correspondence loss: rtol 1e-5 (17 convs, ECHO and a head, each
  summing in another order); each parameter's gradient within 1e-4 of its
  largest entry, the bar of the K1 gradients;
- the evaluations: accuracy equal, the mean cross entropy within rtol 1e-5.
"""

import dataclasses
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
from test_torch_echo import (ECHO_TOL, TB, _features, _jax_params,
                             _port_records, _port_table, _t)
from test_torch_train import _close_to_scale, _jax_draws
from fieldconv_tpu.nn import losses as jlosses
from fieldconv_tpu.ops.pallas import echo_panel as jep
from fieldconv_tpu.train import evaluate as jevaluate
from fieldconv_tpu.train import loop as jloop
from fieldconv_tpu.train import trainer as jtrainer
from fieldconv_tpu.train.config import ExperimentConfig as JaxConfig
from fieldconv_tpu_torch import kernels
from fieldconv_tpu_torch.ops import echo as techo
from fieldconv_tpu_torch.ops import echo_panel as tep
from fieldconv_tpu_torch.precomp import banded as tbanded
from fieldconv_tpu_torch.train import evaluate as tevaluate
from fieldconv_tpu_torch.train import loop as tloop
from fieldconv_tpu_torch.train import trainer as ttrainer
from fieldconv_tpu_torch.train.config import ExperimentConfig
from fieldconv_tpu_torch.utils.complexops import soft_abs
from fieldconv_tpu_torch.utils.port_weights import params_from_jax

torch.set_num_threads(1)   # one per xdist worker: see test_torch_ops.py

# each preset's band limit, rings, bins and augmentation at narrow widths
_PRESET = {
    "segmentation": dict(band_limit=2, n_rings=6, n_bins=3, smoothing=0.2),
    "correspondence": dict(band_limit=1, n_rings=3, n_bins=2, center=True,
                           random_scale=None),
}


def _configs(task, **more):
    kw = dict(task=task, nf=4, n_des=4, echo_impl="panel", **_PRESET[task],
              **more)
    return JaxConfig(**kw), ExperimentConfig(**kw)


# --- K2 backward ---------------------------------------------------------------

@pytest.mark.parametrize("n_bins", [2, 3])
def test_k2_bwd_plain_matches_pallas(rng, n_bins):
    """echo_panel_grid_bwd_reference against jax.vjp of the JAX custom VJP
    _echo_panel_grid, whose backward runs the Pallas _bwd_impl interpreted:
    features with origin rows, and a by-source order from which source
    block 1's panels are dropped.  The port gives that block zeros; the TPU
    kernel never writes it (interpret mode leaves it NaN), which its
    graph-parallel caller masks with ``coverage`` (ROADMAP Queue 3)."""
    _, jt, jp = _panel_setup(rng, compressed=True)
    tp = tbanded.build_panel_table(_port_table(jt), tb=TB, compressed=True)
    N, C = jt.n_pad, 5
    nb, w2 = N // TB, (2 * n_bins + 1) ** 2
    x = _features(rng, N, C)
    dg = rng.normal(size=(nb, 2 * w2, C, TB)).astype(np.float32)
    meta_s = np.asarray(jp.meta_s)
    assert (meta_s[2] == 1).any()
    meta_s = meta_s[:, meta_s[2] != 1]

    def grid(x2t):
        return jep._echo_panel_grid(x2t, jp.sten, jp.meta,
                                    jnp.asarray(meta_s), None, TB, n_bins, 2,
                                    nb)

    # the Pallas kernel's (2C, N) layout: re rows, then im rows
    x2t = jnp.concatenate([jnp.asarray(x[..., 0]).T,
                           jnp.asarray(x[..., 1]).T], axis=0)
    _, vjp = jax.vjp(grid, x2t)
    (jdx,) = vjp(jnp.asarray(dg))
    want = np.stack([np.asarray(jdx)[:C].T, np.asarray(jdx)[C:].T], -1)
    got = tep.echo_panel_grid_bwd_reference(
        _t(dg), _t(x), tp.sten, torch.from_numpy(meta_s), n_bins, nb).numpy()
    rows = np.arange(N) // TB != 1
    assert np.isfinite(want[rows]).all() and np.abs(want[rows]).max() > 0
    np.testing.assert_allclose(got[rows], want[rows], **ECHO_TOL)
    assert not got[~rows].any()
    zero = (x == 0).all(-1)                  # origin features: no gradient
    assert zero.any() and not got[zero].any()


def test_k2_bwd_batch_equals_meshes(rng):
    """Two meshes through one joined panel table (meta_s offset by
    concat_panel_tables) give each mesh's own backward, for a cotangent in
    the layout autograd hands over (cells minor) as for a contiguous one."""
    n_bins, C = 2, 3
    tabs = [tbanded.build_panel_table(_port_table(_panel_setup(rng)[1]),
                                      tb=TB, compressed=True)
            for _ in range(2)]
    both = tbanded.concat_panel_tables(tabs)
    nb, w2 = tabs[0].n_pad // TB, (2 * n_bins + 1) ** 2
    x = [_t(_features(rng, tabs[0].n_pad, C)) for _ in tabs]
    dg = [_t(rng.normal(size=(nb, 2 * w2, C, TB))) for _ in tabs]
    alone = [tep.echo_panel_grid_bwd_reference(g, xi, t.sten, t.meta_s,
                                               n_bins, nb)
             for g, xi, t in zip(dg, x, tabs)]
    cat = torch.cat(dg)
    cells_minor = cat.permute(0, 3, 2, 1).contiguous().permute(0, 3, 2, 1)
    for g in (cat, cells_minor):
        got = tep.echo_panel_grid_bwd_reference(g, torch.cat(x), both.sten,
                                                both.meta_s, n_bins, 2 * nb)
        torch.testing.assert_close(got, torch.cat(alone), rtol=0, atol=0)


@pytest.mark.parametrize("n_bins", [2, 3])
def test_echo_panel_fn_matches_autograd_of_plain(rng, n_bins):
    """echo_panel_fused's gradient, through _EchoPanelFn and the explicit
    plain backward, equals torch.autograd through the plain forward
    (echo_panel_grid_reference) followed by the same fold and soft_abs; on
    CPU tensors no kernel is launched."""
    _, jt, _ = _panel_setup(rng, compressed=True)
    tp = tbanded.build_panel_table(_port_table(jt), tb=TB, compressed=True)
    N, C, w = jt.n_pad, 4, 2 * n_bins + 1
    x = _features(rng, N, C)
    cot = _t(rng.normal(size=(N, C, techo.hist_dim(n_bins))))
    before = dict(kernels.launches)
    xa = _t(x).requires_grad_()
    (tep.echo_panel_fused(xa, tp, n_bins) * cot).sum().backward()
    assert kernels.launches == before

    xb = _t(x).requires_grad_()
    grid = tep.echo_panel_grid_reference(xb, tp.sten, tp.meta, n_bins,
                                         N // TB)
    grid4 = grid.permute(0, 3, 2, 1).reshape(N, C, 2, w * w)
    hist = torch.einsum("ncpu,us->ncsp", grid4, techo.fold_matrix(n_bins,
                                                                  "cpu"))
    (soft_abs(hist) * cot).sum().backward()
    assert xb.grad.abs().max() > 0
    np.testing.assert_allclose(xa.grad.numpy(), xb.grad.numpy(), **ECHO_TOL)


# --- losses, steps and evaluations against the JAX package ---------------------

def _setup(task, seed, jax_route="mixed"):
    """One record, the JAX net and its flax params holding the port net's
    init, the port's mixed batch (tb=8: K1 convs, panel ECHO and lift) and
    the JAX batch of ``jax_route``: the same mixed route, or the gather
    route (gather convs and lift, one-hot ECHO: plain XLA, autodiff for
    the gradients), which compiles in seconds where the mixed route's
    interpreted Pallas kernels take about two each."""
    jcfg, tcfg = _configs(task)
    jrecs = _records(np.random.default_rng(seed), task, n_meshes=1, N=20,
                     n_classes=3)
    jnet = jloop.build_model(jcfg, 3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")            # the one-hot fallback
        jb = jloop.make_batches(jrecs, jcfg, 1,
                                TB if jax_route == "mixed" else None, 24, 8)[0]
    assert (jb.panel is not None) == (jax_route == "mixed")
    net = tloop.build_model(tcfg, 3, torch.Generator().manual_seed(seed),
                            device="cpu")
    params = _jax_params(net, jax.eval_shape(
        jnet.init, jax.random.key(seed), jb.pos[0],
        jax.tree.map(lambda a: a[0], jb.table)))
    tb_ = tloop.make_batches(_port_records(jrecs), tcfg, 1, TB, 24, 8,
                             device="cpu")[0]
    assert tb_.panel is not None and tb_.comp is None
    return types.SimpleNamespace(jcfg=jcfg, tcfg=tcfg, jnet=jnet, jb=jb,
                                 net=net, params=params, tb=tb_)


def test_segmentation_trajectory_matches_jax():
    """3 steps of the port's make_train_step (label smoothing 0.2) against
    the JAX make_train_step, both on the mixed route (K1, K2 and the panel
    lift forward and backward), same initial weights, the JAX augmentation
    draws injected into the port's step."""
    s = _setup("segmentation", seed=0)
    jopt = jtrainer.make_optimizer(s.jcfg, 1)
    state = jtrainer.TrainState(s.params, jopt.init(s.params),
                                jnp.zeros((), jnp.int32))
    jstep = jtrainer.make_train_step(s.jnet, s.jcfg, 3, jopt)
    topt = ttrainer.make_optimizer(s.tcfg, s.net.parameters())
    tstep = ttrainer.make_train_step(s.net, s.tcfg, 3, topt)
    before = dict(kernels.launches)
    key = jax.random.key(1)
    j_losses, t_losses = [], []
    for _ in range(3):
        key, sub = jax.random.split(key)
        state, metrics = jstep(state, sub, s.jb)
        j_losses.append(float(metrics["loss"]))
        t_losses.append(float(tstep(s.tb, aug=_jax_draws(sub, 1, s.jcfg))))
    assert kernels.launches == before          # CPU: the plain versions
    np.testing.assert_allclose(t_losses, j_losses, atol=5e-5, rtol=0)
    assert len(set(j_losses)) == 3
    want = params_from_jax(jax.tree.map(np.asarray, state.params))
    for name, p in s.net.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-4,
                                   err_msg=name)


def test_correspondence_loss_and_grads_match_jax():
    """The port's correspondence loss on the mixed route (make_loss_fn with
    an injected keep mask, no augmentation) and every parameter's gradient,
    through K1's, K2's and the panel lift's hand-written backward, against
    jax.value_and_grad of the JAX net on the gather route applied with the
    same dropout_mask and cross_entropy, on one mesh.  A mask left out is
    drawn from the generator, never from torch's global RNG."""
    s = _setup("correspondence", seed=2, jax_route="gather")
    mask = (np.random.default_rng(4).random((24, 256)) < 0.5).astype(
        np.float32)

    def jloss(params):
        logits = jtrainer.batched_apply(s.jnet, params, s.jb,
                                        dropout_mask=jnp.asarray(mask))
        return jlosses.cross_entropy(logits.reshape(-1, 3),
                                     s.jb.labels.reshape(-1))

    want, want_g = jax.jit(jax.value_and_grad(jloss))(s.params)
    want_g = params_from_jax(jax.tree.map(np.asarray, want_g))
    loss_fn = ttrainer.make_loss_fn(s.net, s.tcfg, 3)
    aug = (torch.zeros(1, 3), None)
    got = loss_fn(s.tb, aug=aug, dropout_mask=_t(mask)[None])
    names, params = zip(*s.net.named_parameters())
    grads = torch.autograd.grad(got, params)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for name, g in zip(names, grads):
        assert want_g[name].abs().max() > 0, name
        _close_to_scale(g, want_g[name])

    drawn = ttrainer.draw_dropout_mask(torch.Generator().manual_seed(3),
                                       s.net, s.tb)
    assert drawn.shape == (1, 24, 256) and 0.3 < drawn.mean().item() < 0.7
    state = torch.get_rng_state()
    torch.testing.assert_close(
        loss_fn(s.tb, torch.Generator().manual_seed(3), aug),
        loss_fn(s.tb, aug=aug, dropout_mask=drawn), rtol=0, atol=0)
    assert torch.equal(torch.get_rng_state(), state)
    with pytest.raises(ValueError, match="generator"):
        loss_fn(s.tb, aug=aug)


def _relabelled(jb, tb_, seed):
    """A second batch of the same tables with other labels at the valid
    vertices (one XLA compile serves both)."""
    lab = np.asarray(jb.labels).copy()
    valid = lab >= 0
    lab[valid] = np.random.default_rng(seed).integers(0, 3, valid.sum())
    return (dataclasses.replace(jb, labels=jnp.asarray(lab)),
            dataclasses.replace(tb_, labels=torch.from_numpy(lab)))


@pytest.mark.parametrize("task", ["segmentation", "correspondence"])
def test_evaluations_match_jax(task):
    """segmentation_accuracy / correspondence_loss on the same weights and
    two batches equal the JAX evaluations (the port on the mixed route, the
    JAX net, jitted, on the gather route).  The correspondence evaluation
    is deterministic: the port's net, left in train(), runs in eval() with
    no mask, and its mode is restored."""
    s = _setup(task, seed=1, jax_route="gather")
    jb2, tb2 = _relabelled(s.jb, s.tb, seed=5)
    jnet = types.SimpleNamespace(apply=jax.jit(
        s.jnet.apply, static_argnames=("deterministic",)))
    s.net.train()
    if task == "segmentation":
        want = jevaluate.segmentation_accuracy(jnet, s.params, [s.jb, jb2])
        got = tevaluate.segmentation_accuracy(s.net, [s.tb, tb2])
        assert got == want and 0.0 < got < 1.0
    else:
        want = jevaluate.correspondence_loss(jnet, s.params, [s.jb, jb2], 3)
        got = tevaluate.correspondence_loss(s.net, [s.tb, tb2], 3)
        assert got == pytest.approx(want, rel=1e-5)
        assert got == tevaluate.correspondence_loss(s.net, [s.tb, tb2], 3)
    assert s.net.training


# --- fit --------------------------------------------------------------------------

@pytest.mark.parametrize("task", ["segmentation", "correspondence"])
def test_fit_echo_presets(tmp_path, task):
    """fit on tiny CPU records on the mixed route: one JSONL line per step,
    finite losses, the test metric (per-vertex accuracy or mean test cross
    entropy) returned, a checkpoint at the end, and a second fit with the
    same seed gives the same losses bitwise (weights, batch order,
    augmentation and dropout masks all come from seeded generators).  The
    training path never draws from torch's global RNG."""
    _, cfg = _configs(task, epochs=2, log_every=3,
                      checkpoint_dir=str(tmp_path / "ckpt"))
    recs = _port_records(_records(np.random.default_rng(3), task,
                                  n_meshes=5, N=20, n_classes=3))
    runs = []
    for i, ckpt in enumerate((cfg.checkpoint_dir, None)):
        log = tmp_path / f"fit{i}.jsonl"
        state = torch.get_rng_state()
        net, opt, metric = tloop.fit(
            dataclasses.replace(cfg, checkpoint_dir=ckpt), recs[:4],
            recs[4:], n_classes=3, batch_size=2, banded_tb=TB,
            log_path=str(log), seed=5, device="cpu")
        assert torch.equal(torch.get_rng_state(), state)
        runs.append([json.loads(line) for line in log.read_text()
                     .splitlines()])
        assert int(opt.step) == 4 and net.training
    assert [r["step"] for r in runs[0]] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) and r["edges_per_s"] > 0
               for r in runs[0])
    assert [r["loss"] for r in runs[0]] == [r["loss"] for r in runs[1]]
    if task == "segmentation":
        assert 0.0 <= metric <= 1.0
    else:
        assert np.isfinite(metric) and metric > 0
    assert (tmp_path / "ckpt").exists()
