"""The port's compact route against the JAX package's, on the same inputs.

The compact route runs ECHO and the lift (and, with conv_impl="compact",
the convs) over one CompactPanelTable per batch: each target block's
distinct sources packed into dense TS-wide columns, read through src_idx.
Its kernels are K6 (the compact conv) and K7 (the compact ECHO), whose
plain versions run here.  Tolerances, each with its reason:

- ``build_compact_panel_table`` and the joined tables: equal, bit for bit;
- K6's plain version against the Pallas ``_band_compact_fwd_impl`` run in
  interpret mode, and against K5's plain version over the same graph's
  PanelTable: atol 3e-5 / rtol 2e-5, the bar of tests/test_band_conv.py::
  test_conv_compact_matches_xla (f32 sums over slots, panels and rings in
  another order);
- K7's plain version against the interpreted ``_fwd_impl_compact``, and the
  compact ECHO op against the port's one-hot ECHO: atol 3e-5 / rtol 2e-5,
  the K2 bar of tests/test_torch_echo.py (``ECHO_TOL``);
- the compact lift against the JAX one (plain XLA): ``ECHO_TOL`` too;
- whole nets against the JAX gather route (plain XLA): rtol 5e-4 / atol
  5e-5 (``NET_TOL`` of tests/test_torch_echo.py: every contraction sums in
  another order, and the JAX gather route takes the one-hot ECHO and the
  gather lift).
"""

import dataclasses
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_band_conv import _panel_setup
from test_deploy import _records
from test_torch_echo import (ECHO_TOL, NET_TOL, TB, _features, _jax_params,
                             _jit, _port_records, _port_table, _t)
from fieldconv_tpu.ops import trans_field as jtf
from fieldconv_tpu.ops.pallas import band_conv as jbc
from fieldconv_tpu.ops.pallas import echo_panel as jep
from fieldconv_tpu.precomp import banded as jbanded
from fieldconv_tpu.train import loop as jloop
from fieldconv_tpu.train import trainer as jtrainer
from fieldconv_tpu.train.config import ExperimentConfig as JaxConfig
from fieldconv_tpu_torch import kernels
from fieldconv_tpu_torch.deploy import Predictor
from fieldconv_tpu_torch.ops import band_conv as tbc
from fieldconv_tpu_torch.ops import compact_fold as tcf
from fieldconv_tpu_torch.ops import echo as techo
from fieldconv_tpu_torch.ops import echo_panel as tep
from fieldconv_tpu_torch.ops import field_conv as tfc
from fieldconv_tpu_torch.ops import trans_field as ttf
from fieldconv_tpu_torch.precomp import banded as tbanded
from fieldconv_tpu_torch.train import loop as tloop
from fieldconv_tpu_torch.train.config import ExperimentConfig

torch.set_num_threads(1)   # one per xdist worker: see test_torch_ops.py

CONV_TOL = dict(atol=3e-5, rtol=2e-5)
# (target block, columns) of the compact tables: square, and the
# rectangular TBt < TS of the pure-panel layout's TBt = 32, TS = 128
SHAPES = pytest.mark.parametrize("tbt,ts", [(8, 8), (4, 8)])


def _compact(jt, tbt, ts):
    return (jbanded.build_compact_panel_table(jt, tb=tbt, ts=ts),
            tbanded.build_compact_panel_table(_port_table(jt), tb=tbt, ts=ts))


# --- tables ----------------------------------------------------------------------

@SHAPES
def test_build_compact_panel_table_equal(rng, tbt, ts):
    """The port's compact table equals the JAX one bit for bit (dead columns
    at vertex 0 included), and both refuse parallel edges."""
    _, jt, _ = _panel_setup(rng, compressed=True)
    jc, tc = _compact(jt, tbt, ts)
    for f in ("sten", "meta", "src_idx"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)))
    assert (tc.tb, tc.ts, tc.n_pad, tc.n_mesh, tc.n_panels) == \
        (tbt, ts, jt.n_pad, 1, jc.n_panels)
    # a second slot of target 0 naming the source of its first slot
    src, mask = np.array(jt.src), np.array(jt.mask)
    src[0, 1], mask[0, :2] = src[0, 0], 1
    jbad = dataclasses.replace(jt, src=jnp.asarray(src), mask=jnp.asarray(mask))
    for build, table in ((jbanded.build_compact_panel_table, jbad),
                         (tbanded.build_compact_panel_table,
                          _port_table(jbad))):
        with pytest.raises(ValueError, match="parallel edges"):
            build(table, tb=tbt, ts=ts)


def test_concat_compact_panel_tables_offsets(rng):
    """Joining two meshes' tables: stencils stacked, target blocks offset
    by m·nb, panel ids by the panels before, source rows by m·n_pad; a
    single table comes back as it is."""
    tabs = [_compact(_panel_setup(rng, compressed=True)[1], 4, 8)[1]
            for _ in range(2)]
    assert tbanded.concat_compact_panel_tables(tabs[:1]) is tabs[0]
    joined = tbanded.concat_compact_panel_tables(tabs)
    n_pad, P0 = tabs[0].n_pad, tabs[0].n_panels
    nb = n_pad // 4
    assert joined.n_mesh == 2 and joined.n_panels == P0 + tabs[1].n_panels
    np.testing.assert_array_equal(
        joined.sten.numpy(), np.concatenate([t.sten.numpy() for t in tabs]))
    meta1 = tabs[1].meta.numpy().copy()
    meta1[0] += nb
    meta1[1] += P0
    np.testing.assert_array_equal(
        joined.meta.numpy(), np.concatenate([tabs[0].meta.numpy(), meta1], 1))
    np.testing.assert_array_equal(
        joined.src_idx.numpy(), np.concatenate(
            [tabs[0].src_idx.numpy(), tabs[1].src_idx.numpy() + n_pad]))


# --- K6 ------------------------------------------------------------------------------

@SHAPES
def test_k6_plain_matches_pallas(rng, tbt, ts):
    """band_compact_fwd_reference (through the wrapper, on CPU tensors)
    against the interpreted Pallas _band_compact_fwd_impl on the gathered
    rows, and against K5's plain version over the same graph's PanelTable;
    a FieldConv-style call through field_conv_banded against the port's
    gather route."""
    _, jt, _ = _panel_setup(rng, compressed=True)
    jc, tc = _compact(jt, tbt, ts)
    N, C, O2, R, K = jt.n_pad, 4, 6, 3, 3
    M = K * 2 * C
    g = rng.normal(size=(N, M)).astype(np.float32)
    w = (rng.normal(size=(R, M, O2)) / np.sqrt(R * M)).astype(np.float32)
    gg = jnp.asarray(g)[jc.src_idx.reshape(-1)]
    want = jbc._band_compact_fwd_impl(gg, jnp.asarray(w), jc.sten, jc.meta,
                                      tbt, ts, R, 1, True, "f32", N)
    before = dict(kernels.launches)
    got = tbc.band_compact_fwd(torch.from_numpy(g), torch.from_numpy(w),
                               tc.sten, tc.meta, tc.src_idx, tbt, R, 1)
    assert kernels.launches == before            # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CONV_TOL)
    tp = tbanded.build_panel_table(_port_table(jt), tb=TB, compressed=True)
    k5 = tbc.band_panel_fwd_reference(torch.from_numpy(g),
                                      torch.from_numpy(w), tp.sten, tp.meta,
                                      TB, R, 1, True)
    np.testing.assert_allclose(got.numpy(), k5.numpy(), **CONV_TOL)

    x = _t(rng.normal(size=(N, C, 2)))
    filt = [_t(rng.normal(size=s)) for s in ((3, C, R), (3, C, R, 1, 2),
                                             (3, C, 2))]
    y = tbc.field_conv_banded(x, tc, *filt, 1)
    ref = tfc.field_conv(x, _port_table(jt), *filt, 1)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), **CONV_TOL)


# --- K7 ------------------------------------------------------------------------------

@SHAPES
def test_k7_plain_matches_pallas(rng, tbt, ts):
    """echo_compact_grid_reference (through the wrapper, on CPU tensors)
    against the interpreted Pallas _fwd_impl_compact on the gathered
    channel-major columns, with origin features; the op (disk fold and
    soft_abs) against the port's one-hot ECHO over the EdgeTable."""
    _, jt, _ = _panel_setup(rng, compressed=True)
    jc, tc = _compact(jt, tbt, ts)
    N, C, n_bins = jt.n_pad, 5, 2
    x = _features(rng, N, C)
    xr = jnp.concatenate([jnp.asarray(x[..., 0]), jnp.asarray(x[..., 1])], 1)
    xg2t = xr[jc.src_idx.reshape(-1)].T
    want = jep._fwd_impl_compact(xg2t, jc.sten, jc.meta, tbt, ts, n_bins, 2,
                                 N // tbt)
    before = dict(kernels.launches)
    grid = tep.echo_compact_grid(_t(x), tc.sten, tc.meta, tc.src_idx, n_bins,
                                 N // tbt)
    np.testing.assert_allclose(grid.numpy(), np.asarray(want), **ECHO_TOL)
    got = tep.echo_panel_fused(_t(x), tc, n_bins)
    assert kernels.launches == before            # CPU: the plain version
    np.testing.assert_allclose(
        got.numpy(), techo.echo(_t(x), _port_table(jt), n_bins).numpy(),
        **ECHO_TOL)


# --- lift ----------------------------------------------------------------------------

@pytest.mark.parametrize("lift_cols", [(1, 2), (0, 1)])
def test_trans_field_compact_matches_jax(rng, lift_cols):
    """The compact lift's aggregation against the JAX one (plain XLA), over
    a rectangular table; the dispatch of trans_field by table type."""
    _, jt, _ = _panel_setup(rng, compressed=True, B=1)
    jc, tc = _compact(jt, 4, 8)
    x = rng.normal(size=(jt.n_pad, 3)).astype(np.float32)
    want = _jit(jtf.trans_field_compact_contrib)(jnp.asarray(x), jc,
                                                 lift_cols, panel_chunk=3)
    got = ttf.trans_field_compact_contrib(_t(x), tc, lift_cols,
                                          panel_chunk=3)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **ECHO_TOL)
    za, zm = (rng.normal(size=(4, 3, 3)).astype(np.float32) for _ in "am")
    ph = rng.normal(size=(4, 3)).astype(np.float32)
    tt = _port_table(jt)
    got = ttf.trans_field(_t(x), tt, _t(za), _t(zm), _t(ph), 1,
                          lift_cols=lift_cols, comp=tc)
    ref = ttf.trans_field(_t(x), tt, _t(za), _t(zm), _t(ph), 1,
                          lift_cols=lift_cols)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=5e-5)


# --- the kernels on CUDA tensors -------------------------------------------------------

def test_k6_k7_on_cuda_tensors_need_the_kernels(monkeypatch):
    """No silent CPU fallback: on CUDA tensors the K6 and K7 wrappers go to
    the kernels' entry points, whose build fails here for want of nvcc
    (patched, the entries record the calls); a gradient reaches K6's and
    K7's backward entries (through each Function's backward, called on a
    stand-in context: autograd records no graph over fake CUDA tensors),
    and the fold (the last step of the lift's backward) its own entry; K =
    3 with R = 6 (the MATCHING preset's shape) reaches both K6 entries, a
    (K, R) that no K6 instantiation takes (K = 7) raises, and so does a K6
    backward over panels of more than 32 target rows."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    from torch._subclasses.fake_tensor import FakeTensorMode

    class Entered(Exception):
        pass

    entered = []

    def entry():
        entered.append(True)
        raise Entered

    before = dict(kernels.launches)
    with FakeTensorMode():
        g = torch.zeros(16, 24, device="cuda")
        w = torch.zeros(3, 24, 6, device="cuda")
        x = torch.zeros(16, 3, 2, device="cuda")
        sten = torch.zeros(2, 5, 8, 8, device="cuda")
        meta = torch.zeros(4, 2, dtype=torch.int32, device="cuda")
        idx = torch.zeros(2, 8, dtype=torch.int32, device="cuda")
        order = torch.zeros(5, dtype=torch.int32, device="cuda")
        ptr = torch.zeros(17, dtype=torch.int32, device="cuda")
        conv = (sten, meta, idx, 8, 3, 1)
        dy = torch.zeros(16, 6, device="cuda")
        dg = torch.zeros(2, 50, 3, 8, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc"):
            tbc.band_compact_fwd(g, w, *conv)
        with pytest.raises(RuntimeError, match="nvcc"):
            tep.echo_compact_grid(x, sten, meta, idx, 2, 2)
        with pytest.raises(RuntimeError, match="nvcc"):
            tbc.band_compact_bwd(dy, g, w, sten, meta, idx, order, ptr, 8, 3,
                                 1)
        g7 = torch.zeros(16, 28, device="cuda")
        w7 = torch.zeros(3, 28, 6, device="cuda")
        with pytest.raises(NotImplementedError, match="presets' shapes"):
            tbc.band_compact_fwd(g7, w7, sten, meta, idx, 8, 3, 3)
        with pytest.raises(NotImplementedError, match="presets' shapes"):
            tbc.band_compact_bwd(dy, g7, w7, sten, meta, idx, order, ptr, 8,
                                 3, 3)
        i32 = dict(dtype=torch.int32, device="cuda")
        with pytest.raises(NotImplementedError, match="at most 32"):
            tbc.band_compact_bwd(
                torch.zeros(64, 6, device="cuda"),
                torch.zeros(64, 24, device="cuda"), w,
                torch.zeros(1, 5, 64, 8, device="cuda"),
                torch.zeros(4, 1, **i32), torch.zeros(1, 8, **i32), order,
                torch.zeros(65, **i32), 64, 3, 1)
        for mod, name in ((tbc, "_k6_entry"), (tep, "_k7_entry"),
                          (tbc, "_k6_bwd_entry"), (tep, "_k7_bwd_entry"),
                          (tcf, "_fold_entry")):
            monkeypatch.setattr(mod, name, entry)
        with pytest.raises(Entered):
            tbc.band_compact_fwd(g, w, *conv)
        with pytest.raises(Entered):
            tep.echo_compact_grid(x, sten, meta, idx, 2, 2)
        ctx = types.SimpleNamespace(
            saved_tensors=(g, w, sten, meta, idx, order, ptr),
            args=(8, 3, 1))
        with pytest.raises(Entered):
            tbc._BandCompactFn.backward(ctx, dy)
        ctx = types.SimpleNamespace(
            saved_tensors=(x, sten, meta, idx, order, ptr), n_bins=2)
        with pytest.raises(Entered):
            tep._EchoCompactFn.backward(ctx, dg)
        with pytest.raises(Entered):
            tcf.compact_fold(torch.zeros(16, 3, device="cuda"), idx, order,
                             ptr, 16)
        w6 = torch.zeros(6, 24, 6, device="cuda")
        with pytest.raises(Entered):
            tbc.band_compact_fwd(g, w6, sten, meta, idx, 8, 6, 1)
        with pytest.raises(Entered):
            tbc.band_compact_bwd(dy, g, w6, sten, meta, idx, order, ptr, 8,
                                 6, 1)
    assert entered == [True] * 7
    assert kernels.launches == before


# --- routing ---------------------------------------------------------------------------

_BASE = dict(nf=4, n_des=4, n_bins=2)
# the three serving paths: (task, config options, layout of the batch)
_PATHS = {
    "corr_panel_compact": ("correspondence",
                           dict(band_limit=1, n_rings=3, center=True,
                                layout="panel", echo_impl="compact")),
    "corr_allcompact": ("correspondence",
                        dict(band_limit=1, n_rings=3, center=True,
                             layout="panel", echo_impl="compact",
                             conv_impl="compact")),
    "seg_mixed_compact": ("segmentation",
                          dict(band_limit=2, n_rings=6, n_bins=3,
                               echo_impl="compact")),
}


def _configs(path):
    task, kw = _PATHS[path]
    kw = dict(task=task, **{**_BASE, **kw})
    return JaxConfig(**kw), ExperimentConfig(**kw)


def test_make_batches_builds_the_jax_compact_tables(rng):
    """make_batches on each compact path builds the JAX package's tables:
    the JAX batch's per-mesh CompactPanelTables (at min(tb, 32) on the
    pure-panel layout, at banded_tb on the mixed route) equal the port's
    joined one, offsets applied; the all-compact batch has no block
    panels.  conv_impl="compact" on a task without ECHO (the one case the
    config lets through) warns in both packages and builds no compact
    table."""
    jrecs = _records(rng, "correspondence", n_meshes=2, N=20)
    recs = _port_records(jrecs)
    for path in _PATHS:
        jcfg, cfg = _configs(path)
        jb = jloop.make_batches(jrecs, jcfg, 2, TB)[0]
        b = tloop.make_batches(recs, cfg, 2, TB, device="cpu")[0]
        jcs = jb.compact if jb.compact is not None else jb.panel
        assert isinstance(b.compact, tbanded.CompactPanelTable)
        assert b.compact.n_mesh == 2 and b.compact.tb == jcs[0].tb == TB
        if path == "corr_allcompact":
            assert b.panel is b.compact and jb.panel is jb.compact
        elif path == "corr_panel_compact":
            assert isinstance(b.panel, tbanded.PanelTable)
        else:
            assert b.banded is not None and b.panel is None and b.comp is None
        n_pad = b.compact.n_pad
        np.testing.assert_array_equal(
            b.compact.sten.numpy(), np.concatenate([c.sten for c in jcs]))
        pid0 = np.cumsum([0] + [c.n_panels for c in jcs])
        np.testing.assert_array_equal(b.compact.meta[:2].numpy(), np.concatenate(
            [np.asarray(c.meta[:2]) + [[m * n_pad // TB], [pid0[m]]]
             for m, c in enumerate(jcs)], axis=1))
        np.testing.assert_array_equal(b.compact.src_idx.numpy(), np.concatenate(
            [np.asarray(c.src_idx) + m * n_pad for m, c in enumerate(jcs)]))
    # the compact convs on a task without ECHO: no compact table to run on
    kw = dict(task="classification", nf=4, band_limit=1, n_rings=3,
              echo_impl="compact", conv_impl="compact")
    crecs = _records(rng, "classification", n_meshes=2, N=20)
    for maker, recs_, c, more in (
            (jloop.make_batches, crecs, JaxConfig(**kw), {}),
            (tloop.make_batches, _port_records(crecs),
             ExperimentConfig(**kw), dict(device="cpu"))):
        with pytest.warns(UserWarning, match="requires echo_impl='compact'"):
            b = maker(recs_, c, 2, TB, **more)[0]
        assert b.compact is None and b.banded is not None


def test_fit_on_compact_batches_raises(rng):
    """fit and evaluate_task on compact batches, which raised before the
    compact route's training was ported, now train and evaluate on the CPU:
    the segmentation preset on the mixed route with the compact ECHO for
    one epoch gives a finite loss and a per-vertex accuracy that
    evaluate_task gives again on the same records' compact batches
    (tests/test_torch_compact_train.py holds the route against JAX).  The
    name is the old behaviour's, kept so that the test's record carries
    on."""
    _, cfg = _configs("seg_mixed_compact")
    recs = _port_records(_records(rng, "segmentation", n_meshes=1, N=20))
    net, opt, metric = tloop.fit(dataclasses.replace(cfg, epochs=1), recs,
                                 recs, n_classes=3, banded_tb=TB,
                                 device="cpu")
    assert int(opt.step) == 1 and 0.0 <= metric <= 1.0
    b = tloop.make_batches(recs, cfg, 1, TB, device="cpu")
    assert b[0].compact is not None and b[0].banded is not None
    assert tloop.evaluate_task(net, cfg, b, 3) == metric


# --- whole nets ------------------------------------------------------------------------

@pytest.mark.parametrize("path", list(_PATHS))
def test_net_compact_matches_jax_gather(rng, path):
    """The port's net served by Predictor(device="cpu") over each compact
    path's batch of two meshes (the plain versions of K7, and of K6 or K5
    or K1, and the compact lift) against the JAX net's gather route (plain
    XLA); the per-record outputs are the batch's rows."""
    jcfg, cfg = _configs(path)
    task = cfg.task
    jrecs = _records(rng, task, n_meshes=2, N=20, n_classes=3)
    jnet = jloop.build_model(jcfg, 3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")           # the onehot fallback
        # (the gather route runs no compact op: conv_impl is moot there, and
        # the fallback's config refuses conv_impl="compact" without
        # echo_impl="compact")
        jb = jloop.make_batches(jrecs, dataclasses.replace(
            jcfg, conv_impl="panel"), 2, None, 24, 8)[0]
    net = tloop.build_model(cfg, 3, torch.Generator().manual_seed(1),
                            device="cpu")
    params = _jax_params(net, jax.eval_shape(
        jnet.init, jax.random.key(1), jb.pos[0],
        jax.tree.map(lambda a: a[0], jb.table)))
    want = np.asarray(jax.jit(lambda p, b: jtrainer.batched_apply(
        jnet, p, b))(params, jb))
    recs = _port_records(jrecs)
    pred = Predictor(net, cfg, batch_size=2, banded_tb=TB, device="cpu")
    b = pred.make_batches(recs, 24, 8)[0]
    assert b.compact is not None and b.compact.n_mesh == 2
    got = pred.logits(b).numpy()
    assert got.shape == want.shape == (2, 24, 3)
    np.testing.assert_allclose(got, want, **NET_TOL)
    key = "labels" if task == "segmentation" else "map"
    for o, r, y in zip(pred.predict(recs, 24, 8), recs, got):
        np.testing.assert_array_equal(o["logits"], y[:r.n_samples])
        np.testing.assert_array_equal(o[key], np.argmax(y[:r.n_samples], -1))
