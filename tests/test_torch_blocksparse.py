"""The port's block-sparse banded layout against the JAX package's, on the CPU.

A BlockSparseTable keeps the dense band's R + 2K planes for an explicit
list of NJ source blocks per target block (``nbr``).  Over it the port runs
K8 (the block-sparse banded conv, forward and backward, ``_BandSparseFn``);
here the kernels' plain versions run, and the JAX side runs its Pallas
kernels in interpret mode (grid and mega pipelines) or, for whole nets,
its gather route (plain XLA).  Tolerances, each with its reason:

- the builder's ``sten_band`` and ``nbr``: bit for bit (the same numpy
  scatter of the same EdgeTable values);
- K8's plain versions against the interpreted ``_band_sparse_*_impl``
  (both directions, both pipelines): y within 1e-5 of its max-abs scale,
  dg and dw within 1e-4 of theirs (f32 sums over the window, rings and
  frequencies in another order);
- ``field_conv_banded`` over the table against the JAX
  ``field_conv_banded`` and against the port's K1 route on the dense band
  of the same EdgeTable: y within 1e-5 of its scale, the gradients of x and
  the three filter tensors within 1e-4 of theirs; a two-mesh stacked table
  against each mesh alone: atol 5e-5 / rtol 5e-5 (the bar of
  tests/test_banded_models.py::test_mixed_nh_batch_comp_parity);
- whole nets with the table as ``banded`` against the JAX gather route:
  logits rtol 5e-4 / atol 5e-5 (``NET_TOL``), every parameter's gradient
  within 1e-4 of its scale (tests/test_torch_train.py::_close_to_scale);
- the lift over dense panels against the JAX package's dense branch and
  against compressed panels of the same EdgeTable: atol 3e-5 / rtol 2e-5
  (``ECHO_TOL``, the bar of the compressed panel lift's test).
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

from conftest import random_graph
from test_deploy import _records
from test_torch_echo import (ECHO_TOL, NET_TOL, _features, _jax_params,
                             _port_records, _port_table, _t)
from test_torch_train import _close_to_scale
from fieldconv_tpu.ops import trans_field as jtf
from fieldconv_tpu.ops.pallas import band_conv as jbc
from fieldconv_tpu.precomp import banded as jbanded
from fieldconv_tpu.precomp.edge_table import EdgeTable as JaxEdgeTable
from fieldconv_tpu.precomp.stencil import build_edge_table
from fieldconv_tpu.train import loop as jloop
from fieldconv_tpu.train import trainer as jtrainer
from fieldconv_tpu.train.config import ExperimentConfig as JaxConfig
from fieldconv_tpu_torch import kernels
from fieldconv_tpu_torch.data.synthetic import (random_block_sparse,
                                                sphere_record,
                                                synthetic_record)
from fieldconv_tpu_torch.deploy import Predictor
from fieldconv_tpu_torch.ops import band_conv as tbc
from fieldconv_tpu_torch.ops import trans_field as ttf
from fieldconv_tpu_torch.precomp import banded as tbanded
from fieldconv_tpu_torch.train import loop as tloop
from fieldconv_tpu_torch.train.config import ExperimentConfig
from fieldconv_tpu_torch.train.trainer import batched_apply
from fieldconv_tpu_torch.utils.port_weights import params_from_jax

torch.set_num_threads(1)   # one per xdist worker: see test_torch_ops.py

TB = 8


def _scale_close(got, want, rel):
    """got within ``rel`` of want's largest magnitude (which must be > 0)."""
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


def _rcm_graph(rng, B=1, R=3):
    """The ragged RCM-ordered graph of tests/test_band_conv.py::
    test_block_sparse_matches_gather, as a JAX EdgeTable (tb = 8)."""
    g = random_graph(rng, n_vertices=64, avg_deg=5, B=B, R=R, epsilon=0.5)
    perm = jbanded.rcm_order(g["edges"], g["n_vertices"])
    edges_r, w = jbanded.reorder_precompute(perm, g["edges"], g["w"])
    return build_edge_table(edges_r, g["log_mag"], g["log_ang"], w, g["xp"],
                            g["n_vertices"], g["B"], g["R"], g["epsilon"],
                            n_multiple=TB)


def _jax_table(tt):
    """The JAX EdgeTable holding a port EdgeTable's arrays."""
    return JaxEdgeTable(**{f: jnp.asarray(getattr(tt, f).numpy())
                           for f in ("src", "mask", "rsten", "fwxp", "ln",
                                     "wxp", "vmask")},
                        n_valid=tt.n_valid, band_limit=tt.band_limit,
                        n_rings=tt.n_rings)


def _both(jt, tb):
    """The JAX and the port block-sparse tables of one JAX EdgeTable."""
    tt = _port_table(jt)
    return (tt, jbanded.build_block_sparse_banded(jt, tb=tb),
            tbanded.build_block_sparse_banded(tt, tb=tb))


def _inverse_by_hand(nbr, live):
    """(ptr, bj) of block_sparse_inverse for one mesh, by loops."""
    nb, NJ = nbr.shape
    lists = [[] for _ in range(nb)]
    for b in range(nb):
        for j in range(NJ):
            if live[b, j]:
                lists[nbr[b, j]].append(b * NJ + j)
    ptr = np.cumsum([0] + [len(x) for x in lists])
    return ptr, np.asarray(sum(lists, []), np.int64)


# --- (a) the builder ----------------------------------------------------------------

@pytest.mark.parametrize("graph", ["rcm_ragged", "kd_sphere"])
def test_builder_matches_jax_bit_for_bit(rng, graph):
    """sten_band and nbr equal the JAX builder's bit for bit, on the ragged
    RCM graph (tb = 8) and on a kd-ordered Fibonacci sphere of 2048 samples
    (tb = 128); the inverse index lists each source block's live panels in
    ascending order, padding (the trailing entries pointing at the block
    itself) left out."""
    if graph == "rcm_ragged":
        jt, tb = _rcm_graph(rng), TB
    else:
        rec = sphere_record(rng, 2048, 5, tb=128)
        jt, tb = _jax_table(rec.table(1, 3)), 128
    tt, jsp, tsp = _both(jt, tb)
    np.testing.assert_array_equal(tsp.sten_band.numpy(),
                                  np.asarray(jsp.sten_band))
    np.testing.assert_array_equal(tsp.nbr.numpy(), np.asarray(jsp.nbr))
    assert tsp.nbr.dtype == torch.int32 and tsp.sten_band.dtype == torch.float32
    assert (tsp.nj, tsp.k_width, tsp.n_pad) == (jsp.nj, jsp.k_width,
                                                jsp.n_pad)
    nbr = tsp.nbr.numpy()
    nb = nbr.shape[0]
    live = np.ones(nbr.shape, bool)
    for b in range(nb):               # padding: zero planes, pointing at b
        for j in range(tsp.nj):
            if not tsp.sten_band[b, :, :, j * tb:(j + 1) * tb].any():
                assert nbr[b, j] == b
                live[b, j] = False
    ptr, bj = _inverse_by_hand(nbr, live)
    np.testing.assert_array_equal(tsp.inv_ptr.numpy(), ptr)
    np.testing.assert_array_equal(tsp.inv_bj.numpy(), bj)
    if graph == "kd_sphere":
        assert 1 < tsp.nj < nb


def test_builder_errors(rng):
    """The JAX builder's three errors: n_pad not a multiple of tb, NJ above
    nj_max, and parallel edges."""
    jt = _rcm_graph(rng)
    tt = _port_table(jt)
    for build, table in ((jbanded.build_block_sparse_banded, jt),
                         (tbanded.build_block_sparse_banded, tt)):
        with pytest.raises(ValueError, match="not a multiple"):
            build(table, tb=48)
        with pytest.raises(ValueError, match="exceeds nj_max"):
            build(table, tb=TB, nj_max=1)
    src, mask = tt.src.clone(), tt.mask.clone()
    t = int(torch.nonzero(mask.sum(1) >= 2)[0, 0])
    src[t, 1] = src[t, 0]
    mask[t, :2] = 1.0
    bad = dataclasses.replace(tt, src=src, mask=mask)
    jbad = dataclasses.replace(jt, src=jnp.asarray(src.numpy()),
                               mask=jnp.asarray(mask.numpy()))
    with pytest.raises(ValueError, match="parallel edges"):
        jbanded.build_block_sparse_banded(jbad, tb=TB)
    with pytest.raises(ValueError, match="parallel edges"):
        tbanded.build_block_sparse_banded(bad, tb=TB)


# --- (b) K8's plain versions ---------------------------------------------------------

@pytest.mark.parametrize("B,R", [(1, 3), (2, 6)])
def test_k8_plain_matches_pallas(rng, B, R):
    """band_sparse_reference and band_sparse_bwd_reference (through the
    wrappers, on CPU tensors: no launch) against the interpreted
    ``_band_sparse_fwd_impl`` / ``_band_sparse_bwd_impl`` (its parts summed
    by ``_sparse_combine``) and the mega pair."""
    jt = _rcm_graph(rng, B=B, R=R)
    _, jsp, tsp = _both(jt, TB)
    K, C, O = 2 * B + 1, 4, 3
    N = jt.n_pad
    g = rng.normal(size=(N, K * 2 * C)).astype(np.float32)
    w = (rng.normal(size=(R, K * 2 * C, 2 * O)) / np.sqrt(K * C * R)) \
        .astype(np.float32)
    dy = rng.normal(size=(N, 2 * O)).astype(np.float32)
    args = (TB, R, K, "f32")
    sten, nbr = jnp.asarray(jsp.sten_band), jnp.asarray(jsp.nbr)

    @jax.jit
    def run(g, w, dy):
        return (jbc._band_sparse_fwd_impl(g, w, sten, nbr, *args),
                *jbc._band_sparse_bwd_impl(dy, g, w, sten, nbr, *args),
                jbc._band_sparse_mega_fwd_impl(g, w, sten, nbr, *args),
                *jbc._band_sparse_mega_bwd_impl(dy, g, w, sten, nbr, *args))

    want = run(g, w, dy)
    before = dict(kernels.launches)
    sb, nb_ = tsp.sten_band[None], tsp.nbr[None]
    y = tbc.band_sparse_fwd(_t(g)[None], _t(w), sb, nb_, TB, R, K)
    dg, dw = tbc.band_sparse_bwd(_t(dy)[None], _t(g)[None], _t(w), sb, nb_,
                                 tsp.inv_ptr, tsp.inv_bj, TB, R, K)
    assert kernels.launches == before
    for pipe in (want[:3], want[3:]):
        _scale_close(y[0], pipe[0], 1e-5)
        _scale_close(dg[0], pipe[1], 1e-4)
        _scale_close(dw, pipe[2], 1e-4)
    # leading mesh axes: the plain versions take them as the kernels do
    y2 = tbc.band_sparse_reference(_t(g), _t(w), tsp.sten_band, tsp.nbr,
                                   TB, R, K)
    np.testing.assert_array_equal(y2.numpy(), y[0].numpy())


def test_k8_plain_matches_pallas_on_shuffled_lists(rng):
    """The plain versions on a random table of two meshes whose nbr rows
    are shuffled, repeat no block and include padding entries
    (data/synthetic.py::random_block_sparse) against the interpreted grid
    pair, mesh by mesh; the inverse index leaves the padding out."""
    B, R, C, O, tb = 1, 3, 4, 3, 8
    K = 2 * B + 1
    tab = random_block_sparse(rng, 2, 6, 4, R, B, tb)
    nbr = tab.nbr.numpy()
    assert all(len(set(row)) == 4 for row in nbr.reshape(-1, 4))
    assert tab.inv_bj.shape[0] < nbr.size          # some padding left out
    N = 6 * tb
    g = rng.normal(size=(2, N, K * 2 * C)).astype(np.float32)
    w = (rng.normal(size=(R, K * 2 * C, 2 * O)) / np.sqrt(K * C * R)) \
        .astype(np.float32)
    dy = rng.normal(size=(2, N, 2 * O)).astype(np.float32)
    args = (tb, R, K, "f32")
    run = jax.jit(lambda g, w, dy, sten, nbr: (
        jbc._band_sparse_fwd_impl(g, w, sten, nbr, *args),
        *jbc._band_sparse_bwd_impl(dy, g, w, sten, nbr, *args)))
    y = tbc.band_sparse_fwd(_t(g), _t(w), tab.sten_band, tab.nbr, tb, R, K)
    dg, dw = tbc.band_sparse_bwd(_t(dy), _t(g), _t(w), tab.sten_band,
                                 tab.nbr, tab.inv_ptr, tab.inv_bj, tb, R, K)
    dw_want = 0
    for m in range(2):
        want = run(g[m], w, dy[m], jnp.asarray(tab.sten_band[m].numpy()),
                   jnp.asarray(nbr[m]))
        _scale_close(y[m], want[0], 1e-5)
        _scale_close(dg[m], want[1], 1e-4)
        dw_want = dw_want + np.asarray(want[2])
    _scale_close(dw, dw_want, 1e-4)


# --- (c) field_conv_banded -------------------------------------------------------------

def _filters(rng, C, O, R, B):
    return (rng.normal(size=(O, C, R)).astype(np.float32),
            rng.normal(size=(O, C, R, B, 2)).astype(np.float32),
            rng.normal(size=(O, C, B + 1)).astype(np.float32))


def test_field_conv_banded_matches_jax_and_k1(rng):
    """field_conv_banded over the BlockSparseTable (K8 each way through
    _BandSparseFn) against the JAX field_conv_banded over its own table
    (both pipelines) and against the port's K1 route over the dense band
    of the same EdgeTable: values and the gradients of x and the three
    filter tensors of Σ (y² + y)."""
    B, R, C, O = 1, 3, 4, 3
    jt = _rcm_graph(rng, B=B, R=R)
    tt, jsp, tsp = _both(jt, TB)
    band = tbanded.build_banded_table(tt, tb=TB, max_nh=8)
    x = _features(rng, jt.n_pad, C)
    filt = _filters(rng, C, O, R, B)

    def jloss(pipe):
        def f(x, *fl):
            y = jbc.field_conv_banded(x, jsp, *fl, 1, pipeline=pipe)
            return jnp.sum(y * y + y), y
        return jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2, 3),
                                          has_aux=True))

    wants = [jloss(p)(jnp.asarray(x), *map(jnp.asarray, filt))
             for p in ("grid", "mega")]
    out = {}
    for name, tab in (("k8", tsp), ("k1", band)):
        args = [_t(a).requires_grad_() for a in (x, *filt)]
        y = tbc.field_conv_banded(args[0], tab, *args[1:], 1)
        torch.sum(y * y + y).backward()
        out[name] = (y.detach(), [a.grad for a in args])
    for ref in [((y, g)) for (_, y), g in wants] + [out["k1"]]:
        _scale_close(out["k8"][0], ref[0], 1e-5)
        for a, b in zip(out["k8"][1], ref[1]):
            _scale_close(a, b, 1e-4)


def test_two_mesh_table_matches_each_mesh(rng):
    """Two meshes' tables stacked along a leading mesh axis (equal NJ) give
    each mesh's conv alone, values and gradients, through one K8 launch
    each way; tables of different NJ refuse to stack."""
    B, R, C, O = 1, 3, 4, 3
    tabs = [synthetic_record(rng, 64, 3, 6, 8, 0.3, f"m{i}", 0).table(
        B, R, n_multiple=TB) for i in range(2)]
    sps = [tbanded.build_block_sparse_banded(t, tb=TB) for t in tabs]
    assert sps[0].nj == sps[1].nj == 3
    both = tbanded.stack_block_sparse_tables(sps)
    assert both.sten_band.shape[0] == 2 and both.nbr.shape == (2, 8, 3)
    x = np.stack([_features(rng, 64, C) for _ in range(2)])
    filt = _filters(rng, C, O, R, B)
    cot = rng.normal(size=(2, 64, O, 2)).astype(np.float32)

    def run(xs, tab, cot):
        args = [_t(a).requires_grad_() for a in (xs, *filt)]
        y = tbc.field_conv_banded(args[0], tab, *args[1:], 1)
        torch.sum(y * _t(cot)).backward()
        return y.detach(), args[0].grad

    y2, dx2 = run(x, both, cot)
    for i in range(2):
        y1, dx1 = run(x[i], sps[i], cot[i])
        np.testing.assert_allclose(y2[i].numpy(), y1.numpy(), atol=5e-5,
                                   rtol=5e-5)
        np.testing.assert_allclose(dx2[i].numpy(), dx1.numpy(), atol=5e-5,
                                   rtol=5e-5)
    odd = synthetic_record(rng, 64, 3, 6, 16, 0.3, "wide", 0).table(
        B, R, n_multiple=TB)
    wide = tbanded.build_block_sparse_banded(odd, tb=TB)
    assert wide.nj != sps[0].nj
    with pytest.raises(ValueError, match="NJ"):
        tbanded.stack_block_sparse_tables([sps[0], wide])


# --- (d) whole nets ----------------------------------------------------------------------

_NETS = {
    "segmentation": dict(nf=4, n_des=4, n_bins=2, band_limit=2, n_rings=6),
    "correspondence": dict(nf=4, n_des=4, n_bins=2, band_limit=1, n_rings=3,
                           center=True),
}


@functools.cache
def _jax_gather(task):
    """The port's net and the JAX net's logits and parameter gradients of
    Σ logits·cot on its gather route (plain XLA, one-hot ECHO), with the
    port's weights, over a batch of two meshes of 20 samples."""
    kw = dict(task=task, **_NETS[task])
    jcfg, cfg = JaxConfig(**kw), ExperimentConfig(**kw, echo_impl="panel")
    jrecs = _records(np.random.default_rng(11), task, n_meshes=2, N=20,
                     n_classes=3)
    jnet = jloop.build_model(jcfg, 3)
    jb = jloop.make_batches(jrecs, jcfg, 2, None, 24, 8)[0]
    net = tloop.build_model(cfg, 3, torch.Generator().manual_seed(2),
                            device="cpu").eval()
    params = _jax_params(net, jax.eval_shape(
        jnet.init, jax.random.key(1), jb.pos[0],
        jax.tree.map(lambda a: a[0], jb.table)))
    cot = np.random.default_rng(12).normal(size=(2, 24, 3)).astype(
        np.float32)

    def loss(p):
        y = jtrainer.batched_apply(jnet, p, jb)
        return jnp.sum(y * cot), y

    (_, want), want_g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    want_g = params_from_jax(jax.tree.map(np.asarray, want_g))
    return types.SimpleNamespace(cfg=cfg, net=net, recs=_port_records(jrecs),
                                 want=np.asarray(want), want_g=want_g,
                                 cot=torch.from_numpy(cot))


def block_sparse_of(batch, tb):
    """The batch's per-mesh block-sparse tables, built from its stacked
    EdgeTable and stacked again (path D's conv table)."""
    table = batch.table
    return tbanded.stack_block_sparse_tables([
        tbanded.build_block_sparse_banded(dataclasses.replace(table, **{
            f: getattr(table, f)[m] for f in ("src", "mask", "rsten",
                                              "fwxp")}), tb=tb)
        for m in range(batch.pos.shape[0])])


@pytest.mark.parametrize("task,layout", [("segmentation", "auto"),
                                         ("correspondence", "auto"),
                                         ("correspondence", "panel")])
def test_net_block_sparse_matches_jax_gather(task, layout):
    """Path D: the batch's block-sparse table as the conv table
    (``banded=``), as the JAX batched_apply accepts it, on the mixed route
    (the BandedTable replaced; ECHO and the lift over the batch's
    PanelTable) and on the pure-panel layout (the PanelTable kept for ECHO
    and the lift).  Logits served by Predictor(device="cpu") and every
    parameter's gradient against the JAX gather route; no launches."""
    s = _jax_gather(task)
    cfg = dataclasses.replace(s.cfg, layout=layout)
    pred = Predictor(s.net, cfg, batch_size=2, banded_tb=TB, device="cpu")
    b = pred.make_batches(s.recs, 24, 8)[0]
    assert b.panel is not None and (b.banded is None) == (layout == "panel")
    b = dataclasses.replace(b, banded=block_sparse_of(b, TB))
    before = dict(kernels.launches)
    got = pred.logits(b).numpy()
    np.testing.assert_allclose(got, s.want, **NET_TOL)
    names, params = zip(*s.net.named_parameters())
    loss = torch.sum(batched_apply(s.net, b) * s.cot)
    for name, g in zip(names, torch.autograd.grad(loss, params)):
        assert s.want_g[name].abs().max() > 0, name
        _close_to_scale(g, s.want_g[name])
    assert kernels.launches == before


# --- (e) the lift over dense panels --------------------------------------------------------

@pytest.mark.parametrize("lift_cols", [(0, 1), (1, 2)])
def test_dense_panel_lift_matches_jax(rng, lift_cols):
    """trans_field_panel_contrib over a dense PanelTable (R+2K planes)
    against the JAX package's dense branch on the same table, and against
    the port's lift over the compressed panels of the same EdgeTable; its
    gradient against the compressed panels' too."""
    from test_band_conv import _panel_setup

    _, jt, jp = _panel_setup(rng, compressed=False, B=1)
    tt = _port_table(jt)
    dense = tbanded.build_panel_table(tt, tb=TB, compressed=False)
    comp = tbanded.build_panel_table(tt, tb=TB, compressed=True)
    np.testing.assert_array_equal(dense.sten.numpy(), np.asarray(jp.sten))
    x = rng.normal(size=(jt.n_pad, 3)).astype(np.float32)
    want = jax.jit(lambda x: jtf.trans_field_panel_contrib(
        x, jp, lift_cols, panel_chunk=5))(jnp.asarray(x))
    grads = []
    for tab in (dense, comp):
        xt = _t(x).requires_grad_()
        got = ttf.trans_field_panel_contrib(xt, tab, lift_cols,
                                            panel_chunk=5)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       **ECHO_TOL)
        (got[0].sum() + torch.sin(got[1]).sum()).backward()
        grads.append(xt.grad)
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(),
                               **ECHO_TOL)


# --- (f) CUDA routing ------------------------------------------------------------------------

def test_k8_on_cuda_tensors_need_the_kernels(monkeypatch):
    """On CUDA tensors (fake ones here) K8's wrappers and _BandSparseFn's
    backward reach the kernel's entry, never the plain version; without
    nvcc the build raises; shapes without an instantiation, and mismatched
    tables, raise before the entry."""
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
        sten = torch.zeros(1, 2, 16, 8, 24, **cuda)   # NJ = 3
        nbr = torch.zeros(1, 2, 3, dtype=torch.int32, **cuda)
        ptr = torch.zeros(3, dtype=torch.int32, **cuda)
        bj = torch.zeros(6, dtype=torch.int32, **cuda)
        dy = torch.zeros(1, 16, 6, **cuda)
        k8 = (8, 6, 5)
        calls = (lambda: tbc.band_sparse_fwd(g, w, sten, nbr, *k8),
                 lambda: tbc.band_sparse_bwd(dy, g, w, sten, nbr, ptr, bj,
                                             *k8))
        for call in calls:
            with pytest.raises(RuntimeError, match="nvcc"):
                call()
        with pytest.raises(NotImplementedError, match="R ≤ 6"):
            tbc.band_sparse_fwd(g, torch.zeros(8, 40, 6, **cuda),
                                torch.zeros(1, 2, 18, 8, 24, **cuda), nbr, 8,
                                8, 5)
        with pytest.raises(ValueError, match="int32 nbr"):
            tbc.band_sparse_fwd(g, w, sten, nbr.long(), *k8)
        with pytest.raises(ValueError, match="inv_ptr"):
            tbc.band_sparse_bwd(dy, g, w, sten, nbr,
                                torch.zeros(2, dtype=torch.int32, **cuda),
                                bj, *k8)
        monkeypatch.setattr(tbc, "_k8_entry", entry)
        monkeypatch.setattr(tbc, "_k8_bwd_entry", entry)
        for call in calls:
            with pytest.raises(Entered):
                call()
        ctx = types.SimpleNamespace(saved_tensors=(g, w, sten, nbr, ptr, bj),
                                    args=k8)
        with pytest.raises(Entered):
            tbc._BandSparseFn.backward(ctx, dy)
    assert entered == [True] * 3
    assert kernels.launches == before
