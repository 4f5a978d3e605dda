"""The port's training slice against the JAX package's, on the CPU.

Both packages get the same numpy inputs; the JAX side runs its Pallas
kernels in interpret mode.  Tolerances, each with its reason:

- K1 backward and field_conv_banded gradients: 1e-4 of the largest
  gradient (f32 contractions summed in another order than XLA's, over up
  to 640 window slots and 180 filter terms);
- augmentation, losses and their gradients: 1e-6 (a handful of f32 ops);
- the optimizer against optax: rtol 1e-6 (the same f32 arithmetic, with
  powers taken by another routine);
- the 5-step training trajectory: losses within 5e-5, the bar of
  tests/test_full_net_parity.py::test_training_trajectory_parity, and
  parameters within 1e-4 (each Adam step moves a parameter by up to lr =
  1e-2, and its direction is m̂/sqrt(v̂), which amplifies gradient
  rounding where a gradient is small).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_band_conv import banded_graph, tables_for
from test_deploy import _records
from test_torch_ops import fill_outside, k1_case
from fieldconv_tpu.nn import losses as jlosses
from fieldconv_tpu.ops.pallas import band_conv as jbc
from fieldconv_tpu.train import loop as jloop
from fieldconv_tpu.train import trainer as jtrainer
from fieldconv_tpu.train.config import ExperimentConfig as JaxConfig
from fieldconv_tpu_torch import kernels
from fieldconv_tpu_torch.data.base import MeshRecord
from fieldconv_tpu_torch.nn import losses as tlosses
from fieldconv_tpu_torch.ops import band_conv as tbc
from fieldconv_tpu_torch.precomp import banded as tbanded
from fieldconv_tpu_torch.precomp.stencil import build_edge_table
from fieldconv_tpu_torch.train import loop as tloop
from fieldconv_tpu_torch.train import trainer as ttrainer
from fieldconv_tpu_torch.train.checkpoint import CheckpointManager
from fieldconv_tpu_torch.train.config import ExperimentConfig
from fieldconv_tpu_torch.utils.port_weights import params_from_jax

torch.set_num_threads(1)   # one per xdist worker: see test_torch_ops.py

_CFG = dict(task="classification", band_limit=2, n_rings=6, nf=8, ftype=1)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _close_to_scale(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


def _port_banded(g, tb=8):
    table = build_edge_table(
        g["edges"], g["log_mag"], g["log_ang"], g["w"], g["xp"],
        g["n_vertices"], g["B"], g["R"], g["epsilon"], n_multiple=tb)
    return tbanded.build_banded_table(table, tb=tb)


# --- K1 backward --------------------------------------------------------------

@pytest.mark.parametrize("bw", [7, 12, "corr", "ends"])
def test_k1_bwd_plain_matches_pallas(rng, bw):
    """band_fused_bwd_reference equals the Pallas backward
    _band_megaw_bwd_impl (interpret mode) on the same inputs, g padded by
    nh blocks on the JAX side as its custom VJP pads it; bw 7 gives nh=1
    and bw 12 nh=2 at tb=8 (test_torch_ops.K1_CASES for the others)."""
    bw, B, R, fill = k1_case(bw)
    g = banded_graph(rng, n_vertices=32, tb=8, bw=bw, B=B, R=R)
    _, jb = tables_for(g)
    nh, tb, K, C, O2 = jb.nh, 8, 2 * B + 1, 4, 6
    assert nh == (1 if bw < 8 else 2)
    sten = np.asarray(jb.sten_band)
    if fill:
        sten = fill_outside(sten, tb, nh, rng)
    N = sten.shape[0] * tb
    gk = rng.normal(size=(N, K * 2 * C)).astype(np.float32)
    wmat = (rng.normal(size=(R, K * 2 * C, O2)) / 10).astype(np.float32)
    dy = rng.normal(size=(N, O2)).astype(np.float32)
    pad = nh * tb
    dgp, dw = jbc._band_megaw_bwd_impl(
        jnp.asarray(dy), jnp.pad(jnp.asarray(gk), ((pad, pad), (0, 0))),
        jnp.asarray(wmat), jnp.asarray(sten), tb, nh, R, K, "f32")
    sten = _t(sten)[None]
    got_g, got_w = tbc.band_fused_bwd_reference(
        _t(dy)[None], _t(gk)[None], sten, _t(wmat), tb, nh)
    _close_to_scale(got_g[0], np.asarray(dgp)[pad:-pad])
    _close_to_scale(got_w, dw)


@pytest.mark.parametrize("ftype,bw", [(0, 7), (1, 12), (2, 7)])
def test_field_conv_banded_grads_match_jax(rng, ftype, bw):
    """Gradients of the port's field_conv_banded (through _BandFusedFn and
    the plain versions) with respect to x and the three filter tensors
    equal jax.grad of the JAX field_conv_banded, whose Pallas kernels run
    interpreted.  ftype 0 and 2 do not use the phase: no gradient reaches
    it in the port, and JAX's is zero."""
    g = banded_graph(rng, n_vertices=32, tb=8, bw=bw)
    jt, jb = tables_for(g)
    tband = _port_banded(g)
    assert tband.nh == jb.nh
    O, C, R, B = 3, 4, 6, 2
    x = rng.normal(size=(jt.n_pad, C, 2)).astype(np.float32)
    if ftype == 2:
        shapes = [(O, C, R, 2), (O, C, R, 2 * B, 2)]
    else:
        shapes = [(O, C, R), (O, C, R, B, 2)]
    filt = [rng.normal(size=s).astype(np.float32) for s in shapes]
    filt.append(rng.normal(size=(O, C, B + 1)).astype(np.float32))
    w = rng.normal(size=(jt.n_pad, O, 2)).astype(np.float32)

    def jloss(x, zr, sph, ph):
        y = jbc.field_conv_banded(x, jb, zr, sph, ph, ftype)
        return jnp.sum(y * jnp.asarray(w))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, *filt)))
    args = [_t(a).requires_grad_() for a in (x, *filt)]
    before = kernels.launches["band_fused_bwd"]
    y = tbc.field_conv_banded(args[0], tband, *args[1:], ftype)
    (y * _t(w)).sum().backward()
    assert kernels.launches["band_fused_bwd"] == before   # CPU: plain path
    for a, b in zip(args, want):
        if a.grad is None:
            assert ftype != 1 and not np.asarray(b).any()
        else:
            _close_to_scale(a.grad, b)


def test_band_fused_fn_gradcheck():
    """_BandFusedFn's hand-written backward against finite differences in
    float64, on a dense random stencil over two meshes with nh=2 (so the
    window reaches past both ends of g)."""
    gen = torch.Generator().manual_seed(0)
    n_mesh, N, tb, nh, R, K, C, O2 = 2, 16, 4, 2, 2, 3, 2, 4
    kw = dict(dtype=torch.float64, generator=gen)
    g = torch.randn(n_mesh, N, 2 * K * C, **kw).requires_grad_()
    wmat = torch.randn(R, 2 * K * C, O2, **kw).requires_grad_()
    sten = torch.randn(n_mesh, N // tb, R + 2 * K, tb, (2 * nh + 1) * tb,
                       **kw)
    assert torch.autograd.gradcheck(
        lambda g, w: tbc._BandFusedFn.apply(g, w, sten, tb, nh), (g, wmat))


# --- augmentation and losses -----------------------------------------------------

def _jax_draws(key, n_mesh, cfg):
    """The angles and scales random_rotate_scale draws from ``key``
    (fieldconv_tpu/train/trainer.py:249-252, 266)."""
    kr, ks = jax.random.split(key)
    deg = cfg.random_rotate_deg
    angles = jax.random.uniform(kr, (n_mesh, 3), minval=-deg,
                                maxval=deg) * (jnp.pi / 180.0)
    lo, hi = cfg.random_scale
    scales = jax.random.uniform(ks, (n_mesh, 1, 1), minval=lo, maxval=hi)
    return _t(angles), _t(scales)


def test_rotate_scale_matches_jax(rng):
    pos = rng.normal(size=(3, 17, 3)).astype(np.float32)
    key = jax.random.key(7)
    want = jtrainer.random_rotate_scale(key, jnp.asarray(pos))
    got = ttrainer.rotate_scale(_t(pos), *_jax_draws(key, 3, JaxConfig()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # the port's own draw: angles within ±45°, scales within the range
    ang, sc = ttrainer.draw_rotate_scale(torch.Generator().manual_seed(0), 64)
    assert ang.shape == (64, 3) and sc.shape == (64, 1, 1)
    assert ang.abs().max() <= np.pi / 4 and 0.85 <= sc.min() <= sc.max() <= 1.15


@pytest.mark.parametrize("kind", ["cross_entropy", "label_smoothing"])
def test_losses_match_jax(rng, kind):
    """Values and logit gradients, with two masked (-1) labels."""
    logits = rng.normal(size=(7, 5)).astype(np.float32) * 3
    labels = rng.integers(0, 5, 7).astype(np.int32)
    labels[[1, 4]] = -1
    weight = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    if kind == "cross_entropy":
        jf, tf = jlosses.cross_entropy, tlosses.cross_entropy
    else:
        def jf(lg, lb):
            return jlosses.label_smoothing_loss(lg, lb, 5, 0.2,
                                                jnp.asarray(weight))

        def tf(lg, lb):
            return tlosses.label_smoothing_loss(lg, lb, 5, 0.2, _t(weight))
    want, want_g = jax.value_and_grad(jf)(jnp.asarray(logits),
                                          jnp.asarray(labels))
    lt = _t(logits).requires_grad_()
    got = tf(lt, torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want_g),
                               atol=1e-6)
    # every label masked: the loss is 0, not a division by zero
    assert tf(lt, torch.full((7,), -1)).item() == 0.0


# --- optimizer against optax ------------------------------------------------------

_OPT_CASES = {
    # config fields, steps per epoch, losses (nan: skipped step)
    "adam": (dict(), 1, [1.0] * 4),
    "decay": (dict(lr_decay_epoch=1, lr_decayed=0.001), 2, [1.0] * 5),
    "multisteps": (dict(batch_step=2, lr_decay_epoch=1, lr_decayed=0.002),
                   2, [1.0] * 7),
    "nan": (dict(batch_step=2), 1, [1.0, np.nan, 1.0, 1.0, np.nan, 1.0]),
}


@pytest.mark.parametrize("case", sorted(_OPT_CASES))
def test_optimizer_matches_optax(rng, case):
    """make_optimizer + _guarded_update against the JAX package's
    (optax.adam, piecewise_constant_schedule, MultiSteps, and the
    non-finite guard) over a few steps: parameters after every step.  A
    non-finite loss leaves parameters and optimizer state bitwise as they
    were; the step counter still counts it."""
    fields, spe, loss_seq = _OPT_CASES[case]
    jcfg, tcfg = JaxConfig(**fields), ExperimentConfig(**fields)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    jopt = jtrainer.make_optimizer(jcfg, spe)
    jparams = jax.tree.map(jnp.asarray, params)
    state = jtrainer.TrainState(jparams, jopt.init(jparams),
                                jnp.zeros((), jnp.int32))
    tparams = [_t(params[k]) for k in shapes]
    topt = ttrainer.make_optimizer(tcfg, tparams, spe)
    for i, lv in enumerate(loss_seq):
        grads = {k: rng.normal(size=s).astype(np.float32)
                 for k, s in shapes.items()}
        if i == 1 and case == "nan":
            grads["a"][0, 0] = np.nan        # a NaN loss brings NaN grads
        state = jtrainer._guarded_update(
            state, jnp.float32(lv), jax.tree.map(jnp.asarray, grads), jopt)
        before = [t.clone() for t in
                  tparams + topt.mu + topt.nu + topt.acc
                  + [topt.count, topt.mini_step]]
        ttrainer._guarded_update(topt, torch.tensor(lv, dtype=torch.float32),
                                 [_t(grads[k]) for k in shapes])
        for t, k in zip(tparams, shapes):
            np.testing.assert_allclose(t.numpy(), np.asarray(state.params[k]),
                                       rtol=1e-6, atol=1e-7)
        after = (tparams + topt.mu + topt.nu + topt.acc
                 + [topt.count, topt.mini_step])
        if not np.isfinite(lv):
            assert all(torch.equal(a, b) for a, b in zip(before, after))
        assert int(topt.step) == int(state.step) == i + 1


# --- the training step and fit --------------------------------------------------------

def test_train_step_trajectory_matches_jax():
    """5 steps of the port's make_train_step against the JAX
    make_train_step on one 2-mesh banded batch (tb=8: K1 convs and the
    gather-free lift), same initial weights, the JAX augmentation draws
    injected into the port's step."""
    jrecs = _records(np.random.default_rng(0), n_meshes=2, N=20,
                     n_classes=4)
    jcfg, tcfg = JaxConfig(**_CFG), ExperimentConfig(**_CFG)
    jnet = jloop.build_model(jcfg, 4)
    jb = jloop.make_batches(jrecs, jcfg, 2, 8)[0]
    params = jax.jit(jnet.init)(jax.random.key(0), jb.pos[0],
                                jax.tree.map(lambda x: x[0], jb.table))
    jopt = jtrainer.make_optimizer(jcfg, 1)
    state = jtrainer.TrainState(params, jopt.init(params),
                                jnp.zeros((), jnp.int32))
    jstep = jtrainer.make_train_step(jnet, jcfg, 4, jopt)

    net = tloop.build_model(tcfg, 4, device="cpu")
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    precs = [MeshRecord(**dataclasses.asdict(r)) for r in jrecs]
    tb = tloop.make_batches(precs, tcfg, 2, 8, device="cpu")[0]
    assert tb.banded is not None and tb.comp is not None
    topt = ttrainer.make_optimizer(tcfg, net.parameters())
    tstep = ttrainer.make_train_step(net, tcfg, 4, topt)

    key = jax.random.key(1)
    j_losses, t_losses = [], []
    for _ in range(5):
        key, sub = jax.random.split(key)
        state, metrics = jstep(state, sub, jb)
        j_losses.append(float(metrics["loss"]))
        t_losses.append(float(tstep(tb, aug=_jax_draws(sub, 2, jcfg))))
    np.testing.assert_allclose(t_losses, j_losses, atol=5e-5, rtol=0)
    want = params_from_jax(jax.tree.map(np.asarray, state.params))
    for name, p in net.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-4,
                                   err_msg=name)


def _fit_records():
    recs = _records(np.random.default_rng(3), n_meshes=5, N=20, n_classes=3)
    return [MeshRecord(**dataclasses.asdict(r)) for r in recs]


def _fit(tmp_path, name, epochs, **kw):
    cfg = ExperimentConfig(task="classification", nf=4, epochs=epochs,
                           log_every=3, checkpoint_every=1,
                           checkpoint_dir=str(tmp_path / f"ckpt_{name}"),
                           **kw)
    recs = _fit_records()
    log = tmp_path / f"{name}.jsonl"
    out = tloop.fit(cfg, recs[:4], recs[4:], n_classes=3, batch_size=2,
                    banded_tb=8, log_path=str(log), seed=5, device="cpu")
    return out, [json.loads(line) for line in log.read_text().splitlines()]


def test_fit_logs_checkpoints_and_resumes(tmp_path):
    """fit on tiny CPU records: it logs one JSONL line per step with
    edges/s, keeps the newest 3 checkpoints, and a run stopped after one
    epoch and resumed from its checkpoint gives the same next losses as an
    uninterrupted run (the batch order and augmentation streams are
    advanced past the restored steps)."""
    (net, opt, acc), full = _fit(tmp_path, "full", epochs=4)
    assert [r["step"] for r in full] == list(range(1, 9))
    assert all(np.isfinite(r["loss"]) and r["edges_per_s"] > 0
               for r in full)
    assert int(opt.step) == 8 and 0.0 <= acc <= 1.0
    ckpt = CheckpointManager(str(tmp_path / "ckpt_full"))
    assert ckpt.latest_step() == 8 and len(ckpt._steps()) == 3

    _, first = _fit(tmp_path, "part", epochs=1)
    # the resumed run appends its steps 3-8 to the same log
    (net2, opt2, _), both = _fit(tmp_path, "part", epochs=4)
    assert len(first) == 2 and len(both) == 8
    np.testing.assert_allclose([r["loss"] for r in both],
                               [r["loss"] for r in full], rtol=1e-6)
    for (k, a), b in zip(net.state_dict().items(),
                         net2.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_unported_tasks_raise():
    """Matching (slice 5) has no loss or evaluation in the port yet; both
    raise and name where it is queued."""
    cfg = ExperimentConfig(task="matching")
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        ttrainer.make_loss_fn(None, cfg, 4)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        tloop.evaluate_task(None, cfg, [], 4)
