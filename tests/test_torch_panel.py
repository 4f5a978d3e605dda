"""The port's pure-panel slice against the JAX package's, on the same inputs.

The pure-panel layout serves meshes above the panel threshold: every op runs
over one compressed PanelTable per batch, the convs through K5 (the panel
conv), whose plain version runs here.  Tolerances, each with its reason:

- ``kd_order`` / ``spatial_tiles``: equal, bit for bit;
- K5's plain version against the Pallas ``_band_panel_fwd_impl`` run in
  interpret mode: rtol 1e-5 / atol 1e-6 on outputs of scale ~1 (W scaled as
  an initialised filter bank is; f32 sums over slots, panels and rings in
  another order);
- a FieldConv over a PanelTable against the JAX one: rtol 1e-5 / atol 1e-5
  (the same sums, with the filter expansion in another order);
- whole nets: rtol 5e-4 / atol 5e-5 (``NET_TOL`` of
  tests/test_torch_echo.py: every contraction sums in another order; the
  nets held against the JAX gather route also take the one-hot ECHO and
  the gather lift there).

The JAX segmentation net runs its own pure-panel route (one interpreted
``pallas_call`` per conv and mesh); the correspondence and classification
nets are held against the JAX gather route (plain XLA), as the port's
ECHO tests do for the correspondence net (ROADMAP "Test size").
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
from test_torch_echo import NET_TOL, TB, _jax_params, _port_records, _port_table
from fieldconv_tpu.deploy.predictor import Predictor as JaxPredictor
from fieldconv_tpu.nn.modules import FieldConv as JaxFieldConv
from fieldconv_tpu.ops.pallas import band_conv as jbc
from fieldconv_tpu.precomp import banded as jbanded
from fieldconv_tpu.precomp import tiled as jtiled
from fieldconv_tpu.train import loop as jloop
from fieldconv_tpu.train import trainer as jtrainer
from fieldconv_tpu.train.config import ExperimentConfig as JaxConfig
from fieldconv_tpu_torch import kernels
from fieldconv_tpu_torch.data.synthetic import fibonacci_sphere
from fieldconv_tpu_torch.deploy import Predictor
from fieldconv_tpu_torch.nn.modules import FieldConv
from fieldconv_tpu_torch.ops import band_conv as tbc
from fieldconv_tpu_torch.precomp import banded as tbanded
from fieldconv_tpu_torch.precomp import tiled as ttiled
from fieldconv_tpu_torch.train import loop as tloop
from fieldconv_tpu_torch.train.config import ExperimentConfig
from fieldconv_tpu_torch.train.trainer import batched_apply

torch.set_num_threads(1)   # one per xdist worker: see test_torch_ops.py

K5_TOL = dict(rtol=1e-5, atol=1e-6)
CONV_TOL = dict(rtol=1e-5, atol=1e-5)

# each preset's band limit, rings and bins, at narrow widths, on the
# pure-panel layout
_PRESET = {
    "classification": dict(band_limit=2, n_rings=6),
    "segmentation": dict(band_limit=2, n_rings=6, n_bins=3, n_des=4,
                         echo_impl="panel"),
    "correspondence": dict(band_limit=1, n_rings=3, n_bins=2, n_des=4,
                           center=True, echo_impl="panel"),
}


def _configs(task, **more):
    kw = dict(task=task, nf=4, layout="panel", **_PRESET[task], **more)
    return JaxConfig(**kw), ExperimentConfig(**kw)


# --- vertex order ------------------------------------------------------------------

@pytest.mark.parametrize("points,tb", [
    ("normal", 8), ("normal", 128), ("sphere", 8), ("sphere", 128)])
def test_kd_order_matches_jax(rng, points, tb):
    """The port's kd_order and spatial_tiles give the JAX permutation and
    tiles bit for bit, on random points and on chip_smoke.py's Fibonacci
    sphere (whose ties on the split axis the stable sort must keep)."""
    pts = (rng.normal(size=(1500, 3)) if points == "normal"
           else fibonacci_sphere(1500))
    np.testing.assert_array_equal(tbanded.kd_order(pts, tb=tb),
                                  jbanded.kd_order(pts, tb=tb))
    got, want = ttiled.spatial_tiles(pts, tb), jtiled.spatial_tiles(pts, tb)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# --- K5 ------------------------------------------------------------------------------

def _k5_inputs(rng, jt, C=4, O2=6, R=3, K=3):
    """g (N, K·2C) and a W of an initialised filter bank's scale (y ~ 1)."""
    M = K * 2 * C
    g = rng.normal(size=(jt.n_pad, M)).astype(np.float32)
    w = (rng.normal(size=(R, M, O2)) / np.sqrt(R * M)).astype(np.float32)
    return g, w


@pytest.mark.parametrize("compressed,chunk", [(False, 1), (True, 1),
                                              (True, 4)])
def test_k5_plain_matches_pallas(rng, compressed, chunk):
    """band_panel_fwd_reference (through the wrapper, on CPU tensors)
    against the Pallas _band_panel_fwd_impl interpreted, on a kd-ordered
    ragged graph at tb=8: dense and compressed planes, and a chunked table
    (zero panels padding each target's run)."""
    _, jt, jp = _panel_setup(rng, compressed=compressed, chunk=chunk)
    tp = tbanded.build_panel_table(_port_table(jt), tb=TB,
                                   compressed=compressed, chunk=chunk)
    g, w = _k5_inputs(rng, jt)
    want = jbc._band_panel_fwd_impl(jnp.asarray(g), jnp.asarray(w), jp.sten,
                                    jp.meta, TB, 3, 1, compressed, "f32",
                                    None, chunk)
    before = dict(kernels.launches)
    got = tbc.band_panel_fwd(torch.from_numpy(g), torch.from_numpy(w),
                             tp.sten, tp.meta, TB, 3, 1, compressed)
    assert kernels.launches == before            # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **K5_TOL)


@pytest.mark.parametrize("chunk", [1, 4])
def test_k5_plain_matches_pallas_matching_rings(rng, chunk):
    """The MATCHING preset's shape (K = 3, R = 6), which the port's K5 now
    takes: band_panel_fwd_reference against the Pallas _band_panel_fwd_impl
    interpreted, on a compressed table (its planes do not depend on R)
    read with 6 rings, unchunked and chunked."""
    _, jt, jp = _panel_setup(rng, compressed=True, chunk=chunk)
    tp = tbanded.build_panel_table(_port_table(jt), tb=TB, compressed=True,
                                   chunk=chunk)
    g, w = _k5_inputs(rng, jt, R=6)
    want = jbc._band_panel_fwd_impl(jnp.asarray(g), jnp.asarray(w), jp.sten,
                                    jp.meta, TB, 6, 1, True, "f32", None,
                                    chunk)
    got = tbc.band_panel_fwd(torch.from_numpy(g), torch.from_numpy(w),
                             tp.sten, tp.meta, TB, 6, 1, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **K5_TOL)


@pytest.mark.parametrize("compressed", [True, False])
def test_field_conv_panel_matches_jax(rng, compressed):
    """FieldConv over a PanelTable joining two meshes, the port's weights
    moved into the JAX module: each mesh's rows equal the JAX FieldConv
    over that mesh's own PanelTable (one interpreted K5 each)."""
    setups = [_panel_setup(rng, compressed=compressed) for _ in range(2)]
    joined = tbanded.concat_panel_tables([
        tbanded.build_panel_table(_port_table(jt), tb=TB,
                                  compressed=compressed)
        for _, jt, _ in setups])
    N, C, O = setups[0][1].n_pad, 4, 3
    x = rng.normal(size=(2, N, C, 2)).astype(np.float32)
    conv = FieldConv(C, O, band_limit=1, n_rings=3,
                     generator=torch.Generator().manual_seed(0))
    jconv = JaxFieldConv(C, O, band_limit=1, n_rings=3)
    params = _jax_params(conv, jax.eval_shape(
        jconv.init, jax.random.key(0), jnp.asarray(x[0]), setups[0][1]))

    def run(params):
        return jnp.stack([jconv.apply(params, jnp.asarray(x[i]), jt, jp)
                          for i, (_, jt, jp) in enumerate(setups)])

    want = np.asarray(jax.jit(run)(params))
    with torch.no_grad():
        got = conv(torch.from_numpy(x), None, joined).numpy()
    assert got.shape == want.shape == (2, N, O, 2)
    np.testing.assert_allclose(got, want, **CONV_TOL)


def test_k5_on_cuda_tensors_needs_the_kernel(monkeypatch):
    """No silent CPU fallback: on CUDA tensors the K5 wrappers go to the
    kernels' entry points, whose build fails here for want of nvcc
    (patched, the entries record the calls); a gradient request goes
    through _BandPanelFn, whose forward reaches K5's entry and whose
    backward reaches the entry of K5's backward; K=3 with R=6 reaches both;
    a (K, R) that no kernel instantiation takes (K=7) raises before either
    entry; a bf16
    stencil (cast_panel_sten) reaches both entries too."""
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
        sten = torch.zeros(2, 5, 8, 8, device="cuda")
        meta = torch.zeros(4, 2, dtype=torch.int32, device="cuda")
        dy = torch.zeros(16, 6, device="cuda")
        args = (sten, meta, 8, 3, 1, True)
        with pytest.raises(RuntimeError, match="nvcc"):
            tbc.band_panel_fwd(g, w, *args)
        with pytest.raises(RuntimeError, match="nvcc"):
            tbc.band_panel_bwd(dy, g, w, sten, meta, meta, 8, 3, 1, True)
        monkeypatch.setattr(tbc, "_k5_entry", entry)
        with pytest.raises(Entered):
            tbc.band_panel_fwd(g, w, *args)
        sten16 = sten.to(torch.bfloat16)
        with pytest.raises(Entered):
            tbc.band_panel_fwd(g, w, sten16, *args[1:])
        # the autograd Function, on a context standing in for autograd's
        # (autograd cannot record a graph over fake CUDA tensors in a build
        # without CUDA)
        ctx = types.SimpleNamespace(save_for_backward=lambda *t: None)
        with pytest.raises(Entered):
            tbc._BandPanelFn.forward(ctx, g, w, sten, meta, meta, 8, 3, 1,
                                     True)
        monkeypatch.setattr(tbc, "_k5_bwd_entry", entry)
        ctx = types.SimpleNamespace(saved_tensors=(g, w, sten, meta, meta),
                                    args=(8, 3, 1, True))
        with pytest.raises(Entered):
            tbc._BandPanelFn.backward(ctx, dy)
        with pytest.raises(Entered):
            tbc.band_panel_bwd(dy, g, w, sten16, meta, meta, 8, 3, 1, True)
        # K = 3 with R = 6 (the MATCHING preset's shape) reaches both
        # entries; K = 7 (band limit 3) raises before either
        w6 = torch.zeros(6, 24, 6, device="cuda")
        with pytest.raises(Entered):
            tbc.band_panel_fwd(g, w6, sten, meta, 8, 6, 1, True)
        with pytest.raises(Entered):
            tbc.band_panel_bwd(dy, g, w6, sten, meta, meta, 8, 6, 1, True)
        g7 = torch.zeros(16, 28, device="cuda")
        w7 = torch.zeros(3, 28, 6, device="cuda")
        with pytest.raises(NotImplementedError, match="presets' shapes"):
            tbc.band_panel_fwd(g7, w7, sten, meta, 8, 3, 3, True)
        with pytest.raises(NotImplementedError, match="presets' shapes"):
            tbc.band_panel_bwd(dy, g7, w7, sten, meta, meta, 8, 3, 3, True)
    assert entered == [True] * 7
    assert kernels.launches == before


# --- routing -------------------------------------------------------------------------

def test_make_batches_routes_the_panel_layout(rng):
    """As tests/test_panel_pipeline.py::
    test_make_batches_resolves_panel_layout: layout='auto' takes the panel
    layout above the threshold.  The port's batch joins the meshes'
    compressed tables (equal to the JAX batch's per-mesh ones, block ids
    offset) and builds no banded tables; below the threshold the mixed
    route stays.  The compact options add a joined CompactPanelTable (and
    with conv_impl="compact" it replaces the PanelTable); fit trains a
    panel bucket and evaluate_task evaluates it."""
    jrecs = _records(rng, "segmentation", n_meshes=2, N=20)
    kw = dict(task="segmentation", band_limit=1, n_rings=2, nf=4, n_des=4,
              n_bins=2, echo_impl="panel", panel_threshold=8)
    jcfg, cfg = JaxConfig(**kw), ExperimentConfig(**kw)
    assert tloop.resolve_layout(cfg, 128) == "panel"
    assert tloop.resolve_layout(dataclasses.replace(
        cfg, panel_threshold=10**9), 128) == "banded"
    recs = _port_records(jrecs)
    b = tloop.make_batches(recs, cfg, 2, TB, device="cpu")[0]
    assert b.banded is None and b.comp is None
    assert isinstance(b.panel, tbanded.PanelTable) and b.panel.compressed
    assert (b.panel.n_mesh, b.panel.tb, b.panel.n_pad) == (2, TB, 128)
    jb = jloop.make_batches(jrecs, jcfg, 2, TB)[0]
    assert jb.banded is None and len(jb.panel) == 2
    np.testing.assert_array_equal(
        b.panel.sten.numpy(), np.concatenate([p.sten for p in jb.panel]))
    nb = 128 // TB
    np.testing.assert_array_equal(b.panel.meta[:2].numpy(), np.concatenate(
        [np.asarray(p.meta[:2]) + m * nb for m, p in enumerate(jb.panel)],
        axis=1))
    mixed = tloop.make_batches(recs, dataclasses.replace(
        cfg, panel_threshold=10**9), 2, TB, device="cpu")[0]
    assert mixed.banded is not None and mixed.panel is not None

    for opts in (dict(echo_impl="compact"),
                 dict(echo_impl="compact", conv_impl="compact")):
        cb = tloop.make_batches(recs, dataclasses.replace(cfg, **opts), 2, TB,
                                device="cpu")[0]
        assert cb.banded is None and cb.compact.n_mesh == 2
        assert (cb.panel is cb.compact) == ("conv_impl" in opts)
    net, opt, acc = tloop.fit(dataclasses.replace(cfg, epochs=1), recs, recs,
                              n_classes=3, batch_size=2, banded_tb=TB,
                              device="cpu")
    assert int(opt.step) == 1 and 0.0 <= acc <= 1.0
    assert tloop.evaluate_task(net, cfg, [b], 3) == acc


# --- whole nets on the pure-panel route -----------------------------------------------

def _nets(task, seed, recs):
    """The port's net (init from a seed) and its weights as a flax tree for
    the JAX net, plus the JAX net and config."""
    jcfg, cfg = _configs(task)
    n_classes = 3
    jnet = jloop.build_model(jcfg, n_classes)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")           # the onehot fallback
        b0 = jloop.make_batches(recs[:1], jcfg, 1, None, 24, 8)[0]
    net = tloop.build_model(cfg, n_classes,
                            torch.Generator().manual_seed(seed),
                            device="cpu").eval()
    params = _jax_params(net, jax.eval_shape(
        jnet.init, jax.random.key(seed), b0.pos[0],
        jax.tree.map(lambda a: a[0], b0.table)))
    return jcfg, cfg, jnet, net, params


def test_segmentation_net_matches_jax_pure_panel(rng):
    """The port's SegmentationNet over one joined PanelTable of two meshes
    (K5 convs, K2 and the panel lift, plain versions) against the JAX net on
    its pure-panel route (batched_apply mesh by mesh, the Pallas kernels
    interpreted)."""
    jrecs = _records(rng, "segmentation", n_meshes=2, N=20, n_classes=3)
    jcfg, cfg, jnet, net, params = _nets("segmentation", 0, jrecs)
    jb = jloop.make_batches(jrecs, jcfg, 2, TB, 24, 8)[0]
    assert jb.banded is None and len(jb.panel) == 2
    want = np.asarray(jax.jit(lambda p, b: jtrainer.batched_apply(
        jnet, p, b))(params, jb))
    b = tloop.make_batches(_port_records(jrecs), cfg, 2, TB, 24, 8,
                           device="cpu")[0]
    assert b.banded is None and b.panel.n_mesh == 2
    with torch.no_grad():
        got = batched_apply(net, b).numpy()
    assert got.shape == want.shape == (2, 24, 3)
    np.testing.assert_allclose(got, want, **NET_TOL)


@pytest.mark.parametrize("task", ["correspondence", "classification"])
def test_net_pure_panel_matches_jax_gather(rng, task):
    """The port's net over one joined PanelTable of two meshes against the
    JAX net's gather route (plain XLA), and the Predictor's outputs on the
    CPU: the logits of each record's true rows and their argmax."""
    jrecs = _records(rng, task, n_meshes=2, N=20, n_classes=3)
    jcfg, cfg, jnet, net, params = _nets(task, 1, jrecs)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jb = jloop.make_batches(jrecs, jcfg, 2, None, 24, 8)[0]
    want = np.asarray(jax.jit(lambda p, b: jtrainer.batched_apply(
        jnet, p, b))(params, jb))
    recs = _port_records(jrecs)
    pred = Predictor(net, cfg, batch_size=2, banded_tb=TB, device="cpu")
    b = pred.make_batches(recs, 24, 8)[0]
    assert b.banded is None and b.comp is None and b.panel.n_mesh == 2
    got = pred.logits(b).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **NET_TOL)
    outs = pred.predict(recs, 24, 8)
    for i, (o, r) in enumerate(zip(outs, recs)):
        if task == "classification":
            np.testing.assert_array_equal(o["logits"], got[i, 0])
            assert o["class"] == int(np.argmax(got[i, 0]))
        else:
            np.testing.assert_array_equal(o["logits"], got[i, :r.n_samples])
            np.testing.assert_array_equal(
                o["map"], np.argmax(got[i, :r.n_samples], -1))
    # the outputs as the JAX Predictor forms them from the same logits
    shim = types.SimpleNamespace(config=jcfg)
    jout = JaxPredictor._to_output(shim, got[0], recs[0].n_samples)
    assert set(jout) == set(outs[0])
    for k in jout:
        np.testing.assert_array_equal(outs[0][k], jout[k])
