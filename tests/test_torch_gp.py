"""The port's graph-parallel training (parallel/gp.py) against the JAX
package's, on the CPU.

Ranks are gloo processes started by the port's spawn helper
(parallel/distributed.py::spawn; their function is in
tests/torch_gp_worker.py, which imports no JAX).  Each run builds the net
with the graph axis, loads the weights the JAX side holds, and returns the
loss and gradients of make_gp_value_and_grad on its shard, then the
losses and parameters of 2 make_gp_train_step steps.  Shapes are
tests/test_gp.py::_setup's (two meshes of 96 vertices, tb 8, nf 6, bw 7:
nh 1, so a shard of 6 or 3 blocks takes the overlapped path), and no
augmentation, except where the correspondence loss draws its own
augmentation and keep mask (test_gp_correspondence_draws_match_single_process:
against the single-process make_loss_fn given the same generators, JAX's
bars).  Bars, each with its reason:

- the loss and every gradient against the JAX graph-parallel
  make_gp_value_and_grad on a (2, 4) mesh (classification), or the JAX
  single-device make_loss_fn on the gather route (segmentation; the
  correspondence loss as the JAX batched_apply with the port's keep mask,
  which the JAX make_loss_fn cannot take): loss rtol 1e-5 / atol 1e-6,
  gradients rtol 1e-4 / atol 2e-5, JAX's own bars (tests/test_gp.py);
- after the 2 steps every rank's parameters equal rank 0's bit for bit,
  and rank 0's are within atol 1e-4 of the single-process port's 2
  make_train_step steps (the bar of tests/test_torch_echo_train.py's
  trajectory: an Adam step moves a parameter whose gradient is near zero
  by up to lr either way), the step losses within rtol 1e-5.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_gp_worker
from test_band_conv import banded_graph, tables_for
from test_torch_echo import _jax_params, _port_table, _t
from fieldconv_tpu.nn import losses as jlosses
from fieldconv_tpu.parallel.gp import gp_batch as jgp_batch
from fieldconv_tpu.parallel.gp import make_gp_value_and_grad as jgp_vag
from fieldconv_tpu.parallel.gp import place_gp_batch as jplace_gp_batch
from fieldconv_tpu.parallel.sharding import make_device_mesh
from fieldconv_tpu.parallel.sharding import replicate as jreplicate
from fieldconv_tpu.train import loop as jloop
from fieldconv_tpu.train import trainer as jtrainer
from fieldconv_tpu.train.config import ExperimentConfig as JaxConfig
from fieldconv_tpu_torch.parallel import gp as tgp
from fieldconv_tpu_torch.parallel import halo
from fieldconv_tpu_torch.parallel import sharding
from fieldconv_tpu_torch.parallel.distributed import (Axis, Layout,
                                                     generator_for, spawn)
from fieldconv_tpu_torch.train import loop as tloop
from fieldconv_tpu_torch.train import trainer as ttrainer
from fieldconv_tpu_torch.train.config import ExperimentConfig
from fieldconv_tpu_torch.utils.port_weights import params_from_jax

torch.set_num_threads(1)   # one per xdist worker: see test_torch_ops.py

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)
PARAM_ATOL = 1e-4
TB, N_CLASSES, STEPS = 8, 5, 2


@functools.cache
def _case(task, bw=7, n_vertices=96):
    """tests/test_gp.py::_setup's two meshes for ``task``: the configs, the
    JAX batch (banded + comp), the port's batch of the same tables, the
    port net's initial weights and the JAX params holding them."""
    rng = np.random.default_rng(0)
    gr = banded_graph(rng, n_vertices=n_vertices, tb=TB, bw=bw)
    jt, _ = tables_for(gr, tb=TB)
    N = jt.n_pad
    kw = dict(task=task, band_limit=gr["B"], n_rings=gr["R"], nf=6,
              n_des=6 if task != "classification" else None, n_bins=2,
              random_rotate_deg=0.0, random_scale=None)
    jcfg, tcfg = JaxConfig(**kw), ExperimentConfig(**kw)
    items = []
    for i in range(2):
        pos = np.asarray(rng.normal(size=(N, 3)), np.float32)
        if task == "classification":
            label = np.int32(i % N_CLASSES)
        else:
            label = rng.integers(0, N_CLASSES, size=N).astype(np.int32)
            label[-8:] = -1          # padding rows masked
        items.append((pos, jt, label))
    jb = jtrainer.stack_batch(items, banded_tb=TB, echo_banded=True)
    # the single-device reference on the gather route (plain XLA: compiles
    # in seconds, where the banded route's interpreted kernels take ~2 s
    # each)
    jb_gather = jtrainer.stack_batch(items)
    port_items = [(p, _port_table(t), l) for p, t, l in items]
    tb_ = ttrainer.stack_batch(port_items, banded_tb=TB, echo_banded=True)
    rows = [ttrainer.stack_batch([it], banded_tb=TB, echo_banded=True)
            for it in port_items]
    np.testing.assert_array_equal(tb_.banded.sten_band.numpy(),
                                  np.asarray(jb.banded.sten_band))
    net = tloop.build_model(tcfg, N_CLASSES,
                            torch.Generator().manual_seed(0), device="cpu")
    jnet = jloop.build_model(jcfg, N_CLASSES)
    params = _jax_params(net, jax.eval_shape(
        jnet.init, jax.random.key(0), jb.pos[0],
        jax.tree.map(lambda a: a[0], jb.table)))
    weights = {k: v.clone() for k, v in net.state_dict().items()}
    mask = None
    if task == "correspondence":
        keep = (np.random.default_rng(4).random((N, 256)) < 0.5).astype(
            np.float32)
        mask = np.broadcast_to(keep, (2, N, 256)).copy()
    return dict(jcfg=jcfg, tcfg=tcfg, jb=jb, jb_gather=jb_gather, tb=tb_,
                rows=rows, jnet=jnet, params=params, weights=weights,
                mask=mask)


@functools.cache
def _jax_want(task):
    """The JAX loss and gradients (as port state_dict names)."""
    c = _case(task)
    key = jax.random.key(42)
    if task == "classification":
        mesh = make_device_mesh(2, 4, jax.devices()[:8])
        netg = jloop.build_model(c["jcfg"], N_CLASSES, axis_name="graph")
        gpb = jplace_gp_batch(jgp_batch(c["jb"]), mesh)
        vag = jgp_vag(netg, c["jcfg"], N_CLASSES, mesh, gpb)
        with mesh:
            loss, grads = jax.jit(vag)(jreplicate(c["params"], mesh), key,
                                       gpb)
    elif task == "segmentation":
        loss_fn = jtrainer.make_loss_fn(c["jnet"], c["jcfg"], N_CLASSES)
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            c["params"], key, c["jb_gather"])
    else:
        def loss_fn(params):
            logits = jtrainer.batched_apply(
                c["jnet"], params, c["jb_gather"],
                dropout_mask=jnp.asarray(c["mask"][0]))
            return jlosses.cross_entropy(logits.reshape(-1, N_CLASSES),
                                         c["jb"].labels.reshape(-1))
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(c["params"])
    return float(loss), params_from_jax(jax.tree.map(np.asarray, grads))


@functools.cache
def _gp(task, n_data, n_graph, bw=7):
    """Each rank's result of torch_gp_worker.gp_run on (n_data, n_graph)
    gloo ranks."""
    c = _case(task, bw)
    mask = None if c["mask"] is None else _t(c["mask"])
    aug = (torch.zeros(2, 3), None)
    return spawn(torch_gp_worker.gp_run, n_data * n_graph,
                 args=(n_data, n_graph, c["tcfg"], N_CLASSES, c["weights"],
                       tgp.gp_batch(c["tb"]), aug, mask, STEPS))


@functools.cache
def _single(task, bw=7):
    """The single-process port: the loss and gradients of make_loss_fn, then
    STEPS make_train_step steps' losses and the parameters after them."""
    c = _case(task, bw)
    net = tloop.build_model(c["tcfg"], N_CLASSES, device="cpu")
    net.load_state_dict(c["weights"])
    kw = dict(aug=(torch.zeros(2, 3), None))
    if c["mask"] is not None:
        kw["dropout_mask"] = _t(c["mask"])
    loss = ttrainer.make_loss_fn(net, c["tcfg"], N_CLASSES)(c["tb"], **kw)
    names, params = zip(*net.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    opt = ttrainer.make_optimizer(c["tcfg"], net.parameters())
    step = ttrainer.make_train_step(net, c["tcfg"], N_CLASSES, opt)
    losses = [step(c["tb"], **kw).item() for _ in range(STEPS)]
    return loss.item(), grads, losses, dict(net.named_parameters())


CASES = pytest.mark.parametrize("task,n_data,n_graph", [
    ("classification", 1, 2), ("classification", 2, 2),
    ("segmentation", 1, 2), ("correspondence", 2, 2)])


@CASES
def test_gp_loss_and_grads_match_jax(task, n_data, n_graph):
    """Every rank's loss and gradients (summed over the world) equal the
    JAX package's: its graph-parallel run on a (2, 4) mesh for
    classification, its single-device banded run otherwise."""
    want, want_g = _jax_want(task)
    out = _gp(task, n_data, n_graph)
    for o in out:
        np.testing.assert_allclose(o["loss"], want, **LOSS_TOL)
        assert set(o["grads"]) == set(want_g)
        for name, g in o["grads"].items():
            np.testing.assert_allclose(g, want_g[name].numpy(), **GRAD_TOL,
                                       err_msg=name)
        assert not o["launches"]              # CPU: the plain versions
        assert o["wire_bytes"]["conv"] > 0 and o["wire_bytes"]["rows"] > 0


@CASES
def test_gp_steps_match_single_process(task, n_data, n_graph):
    """2 make_gp_train_step steps leave every rank's parameters equal to
    rank 0's bit for bit, and equal to the single-process port's 2 steps;
    the step losses agree."""
    out = _gp(task, n_data, n_graph)
    _, _, losses, params = _single(task)
    for o in out[1:]:
        for name, p in o["params"].items():
            np.testing.assert_array_equal(p, out[0]["params"][name],
                                          err_msg=name)
        assert o["losses"] == out[0]["losses"]
    np.testing.assert_allclose(out[0]["losses"], losses, rtol=1e-5)
    for name, p in params.items():
        np.testing.assert_allclose(out[0]["params"][name],
                                   p.detach().numpy(), atol=PARAM_ATOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("n_data", [1, 2])
def test_gp_correspondence_draws_match_single_process(n_data):
    """With neither aug nor dropout_mask given, the graph-parallel
    correspondence loss draws both from generator_for(seed, data rank),
    the keep mask over the data row's global rows: every graph rank of a
    row holds its own rows of that one mask, and the loss and gradients
    equal the single-process make_loss_fn's given each data row's
    generator (one call a row, weighted by the row's valid count; JAX's
    bars).  Rotation and scaling are on, so ranks of a row that rotated
    differently would disagree with it."""
    c = _case("correspondence")
    cfg = dataclasses.replace(c["tcfg"], random_rotate_deg=30.0,
                              random_scale=(0.9, 1.1))
    seed = 3
    out = spawn(torch_gp_worker.gp_draws, 2 * n_data,
                args=(n_data, 2, cfg, N_CLASSES, c["weights"],
                      tgp.gp_batch(c["tb"]), seed))
    net = tloop.build_model(cfg, N_CLASSES, device="cpu")
    net.load_state_dict(c["weights"])
    loss_fn = ttrainer.make_loss_fn(net, cfg, N_CLASSES)
    total, count, masks = 0.0, 0, []
    for d, b in enumerate([c["tb"]] if n_data == 1 else c["rows"]):
        n = int((b.labels >= 0).sum())
        total = total + n * loss_fn(b, generator=generator_for(seed, d))
        count += n
        gen = generator_for(seed, d)
        ttrainer.draw_rotate_scale(gen, b.pos.shape[0],
                                   cfg.random_rotate_deg, cfg.random_scale)
        masks.append(ttrainer.draw_dropout_mask(gen, net, b))
    loss = total / count
    names, params = zip(*net.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    n_local = c["tb"].pos.shape[1] // 2
    for r, o in enumerate(out):
        d, g = divmod(r, 2)
        np.testing.assert_array_equal(
            o["mask"], masks[d][:, g * n_local:(g + 1) * n_local].numpy())
        np.testing.assert_allclose(o["loss"], loss.item(), **LOSS_TOL)
        for name, want in grads.items():
            np.testing.assert_allclose(o["grads"][name], want.numpy(),
                                       **GRAD_TOL, err_msg=name)


def test_gp_serial_path_matches_single_process():
    """Classification at bw 14 (nh 2) over (1, 4) ranks: 3 blocks a shard,
    not more than 2·nh, so every conv takes the serial path; the loss and
    gradients equal the single-process port's (JAX's bars)."""
    c = _case("classification", bw=14)
    assert c["tb"].banded.nh == 2 and not halo.overlaps(96 // 4 // TB, 2)
    out = _gp("classification", 1, 4, bw=14)
    loss, grads, _, _ = _single("classification", bw=14)
    for o in out:
        np.testing.assert_allclose(o["loss"], loss, **LOSS_TOL)
        for name, g in grads.items():
            np.testing.assert_allclose(o["grads"][name], g.numpy(),
                                       **GRAD_TOL, err_msg=name)


def _layout(n_data, n_graph, rank):
    """A Layout of rank ``rank`` without process groups (for sharding)."""
    d, g = divmod(rank, n_graph)

    def axis(ranks, me):
        return Axis(None, tuple(ranks), me, "gloo")

    return Layout(n_data, n_graph,
                  axis(range(d * n_graph, (d + 1) * n_graph), g),
                  axis(range(g, n_data * n_graph, n_graph), d),
                  axis(range(n_data * n_graph), rank))


@pytest.mark.parametrize("task", ["classification", "segmentation"])
def test_shard_batch_tiles_the_batch(task):
    """The (2, 2) ranks' shards tile the batch: meshes by data rank, vertex
    rows and stencil blocks by graph rank, mesh labels by data rank only."""
    gpb = tgp.gp_batch(_case(task)["tb"])
    shards = [sharding.shard_batch(gpb, _layout(2, 2, r)) for r in range(4)]
    for f in ("pos", "vmask", "bsten", "csten"):
        rows = [torch.cat([getattr(shards[2 * d + g], f) for g in range(2)],
                          dim=1) for d in range(2)]
        assert torch.equal(torch.cat(rows), getattr(gpb, f)), f
    if task == "classification":
        assert torch.equal(torch.cat([shards[0].labels, shards[2].labels]),
                           gpb.labels)
        assert torch.equal(shards[0].labels, shards[1].labels)
    else:
        assert shards[1].labels.shape == (1, 48)
    with pytest.raises(ValueError, match="multiple of"):
        sharding.shard_batch(gpb, _layout(1, 8, 0))


def test_spawn_refuses_nccl_without_cards_and_fails_with_a_rank():
    """NCCL with more ranks than cards raises before anything starts (no
    silent fallback to gloo), and a rank that raises fails the run with its
    traceback."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="one card per rank"):
            spawn(torch_gp_worker.ring, 2, backend="nccl")
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        spawn(torch_gp_worker.fail_on, 2, args=(1,))
