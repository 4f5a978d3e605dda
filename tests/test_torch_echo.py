"""The port's ECHO slice against the JAX package's, on the same inputs.

Tables are built from the same numpy graphs by both packages and must be
equal bit for bit.  The panel ECHO kernel's plain version is held against
the Pallas kernel run in interpret mode with the bar the JAX package's own
test sets it against its XLA path (tests/test_band_conv.py::
test_echo_panel_pallas_matches_xla: atol 3e-5, rtol 2e-5); the other ECHO
routes and the panel lift are held to the same bar (sums over slots and
panels in another order).  Blocks and nets get the JAX weights through
params_from_jax and are held to rtol 5e-4 / atol 5e-5, the bar of
tests/test_torch_serve.py: every contraction sums in another order.
"""

import dataclasses
import functools
import types
import warnings
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_field
from test_band_conv import _panel_setup
from test_deploy import _records
from fieldconv_tpu.deploy.predictor import Predictor as JaxPredictor
from fieldconv_tpu.nn.modules import ECHOBlock as JaxECHOBlock
from fieldconv_tpu.ops import echo as jecho
from fieldconv_tpu.ops import trans_field as jtf
from fieldconv_tpu.ops.pallas import echo_panel as jep
from fieldconv_tpu.train import loop as jloop
from fieldconv_tpu.train import trainer as jtrainer
from fieldconv_tpu.train.config import ExperimentConfig as JaxConfig
from fieldconv_tpu_torch import kernels
from fieldconv_tpu_torch.data.base import MeshRecord
from fieldconv_tpu_torch.deploy import Predictor
from fieldconv_tpu_torch.nn.modules import ECHO, ECHOBlock
from fieldconv_tpu_torch.ops import echo as techo
from fieldconv_tpu_torch.ops import echo_panel as tep
from fieldconv_tpu_torch.ops import trans_field as ttf
from fieldconv_tpu_torch.precomp import banded as tbanded
from fieldconv_tpu_torch.precomp.edge_table import EdgeTable
from fieldconv_tpu_torch.train import loop as tloop
from fieldconv_tpu_torch.train.config import ExperimentConfig
from fieldconv_tpu_torch.train.trainer import batched_apply, stack_batch
from fieldconv_tpu_torch.utils.port_weights import params_from_jax

torch.set_num_threads(1)   # one per xdist worker: see test_torch_ops.py

ECHO_TOL = dict(atol=3e-5, rtol=2e-5)
NET_TOL = dict(rtol=5e-4, atol=5e-5)
TB = 8


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _jit(fn):
    """fn jitted with its third argument and keywords static: one XLA
    compile costs less than running the JAX op eagerly, op by op."""
    def run(x, table, arg, **kw):
        return jax.jit(lambda x, table: fn(x, table, arg, **kw))(x, table)
    return run


def _port_table(jt) -> EdgeTable:
    """The port's EdgeTable holding a JAX EdgeTable's arrays."""
    return EdgeTable(**{f: torch.from_numpy(np.array(getattr(jt, f)))
                        for f in ("src", "mask", "rsten", "fwxp", "ln", "wxp",
                                  "vmask")},
                     n_valid=jt.n_valid, band_limit=jt.band_limit,
                     n_rings=jt.n_rings)


def _features(rng, N, C):
    """Planar features with exact-zero entries and whole origin rows."""
    z = random_field(rng, N, C)
    x = np.stack([z.real, z.imag], -1).astype(np.float32)
    x[rng.random(N) < 0.2] = 0.0
    return x


def _port_records(jrecs):
    return [MeshRecord(**dataclasses.asdict(r)) for r in jrecs]


def _jax_params(module, shapes):
    """Flax params for a JAX module holding a port module's weights.

    shapes: jax.eval_shape of the JAX module's init (no XLA compile).  Every
    flax leaf must exist in the port's state_dict with its shape, and the
    tree must carry back onto the port with params_from_jax(strict=True)."""
    sd = {k: v.detach().numpy() for k, v in module.state_dict().items()}

    def build(node, prefix):
        out = {}
        for key, val in node.items():
            path = f"{prefix}.{key}" if prefix else key
            if isinstance(val, Mapping):
                out[key] = build(val, path)
            else:
                assert sd[path].shape == tuple(val.shape), path
                out[key] = jnp.asarray(sd[path])
        return out

    params = {"params": build(shapes["params"], "")}
    module.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)),
                           strict=True)
    return params


# --- tables --------------------------------------------------------------------

@pytest.mark.parametrize("compressed,chunk", [(True, 1), (True, 2),
                                              (False, 1), (False, 2)])
def test_build_panel_table_equal(rng, compressed, chunk):
    _, jt, jp = _panel_setup(rng, compressed=compressed, chunk=chunk)
    tp = tbanded.build_panel_table(_port_table(jt), tb=TB,
                                   compressed=compressed, chunk=chunk)
    for f in ("sten", "meta", "meta_s"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    assert (tp.tb, tp.n_pad, tp.band_limit, tp.n_rings, tp.compressed,
            tp.chunk, tp.n_panels) == \
        (jp.tb, jp.n_pad, jp.band_limit, jp.n_rings, jp.compressed,
         jp.chunk, jp.n_panels)


def test_concat_panel_tables_offsets_blocks(rng):
    """Mesh m's block ids move by m·nb and its by-source panel ids by the
    panels before it; both orders stay sorted."""
    tabs = [tbanded.build_panel_table(_port_table(_panel_setup(rng)[1]),
                                      tb=TB, compressed=True)
            for _ in range(2)]
    both = tbanded.concat_panel_tables(tabs)
    nb, P0 = tabs[0].n_pad // TB, tabs[0].n_panels
    assert both.n_mesh == 2 and both.n_panels == P0 + tabs[1].n_panels
    np.testing.assert_array_equal(both.meta[:, P0:][:2].numpy(),
                                  tabs[1].meta[:2].numpy() + nb)
    np.testing.assert_array_equal(both.meta_s[0, P0:].numpy(),
                                  tabs[1].meta_s[0].numpy() + P0)
    assert (np.diff(both.meta[0].numpy()) >= 0).all()
    assert (np.diff(both.meta_s[2].numpy()) >= 0).all()
    torch.testing.assert_close(both.sten[P0:], tabs[1].sten, rtol=0, atol=0)


def test_disk_map_and_hist_dim_equal():
    for n_bins in (1, 2, 3, 4):
        dmap, dS = techo.disk_map(n_bins)
        jmap, jdS = jecho.disk_map(n_bins)
        np.testing.assert_array_equal(dmap, jmap)
        assert dS == jdS == techo.hist_dim(n_bins) == jecho.hist_dim(n_bins)


# --- ECHO ops --------------------------------------------------------------------

@pytest.mark.parametrize("n_bins", [2, 3])
def test_echo_onehot_and_panel_match_jax(rng, n_bins):
    """The gather route against the JAX one and the panel route (the op
    around K2, its plain version on the CPU) against the JAX XLA panel
    route, origin rows included; two meshes through one joined panel table
    equal each mesh alone."""
    _, jt, jp = _panel_setup(rng, compressed=True)
    tt = _port_table(jt)
    tp = tbanded.build_panel_table(tt, tb=TB, compressed=True)
    x = _features(rng, jt.n_pad, 5)
    want = np.asarray(_jit(jecho.echo)(jnp.asarray(x), jt, n_bins,
                                       d_chunk=1024))
    np.testing.assert_allclose(techo.echo(_t(x), tt, n_bins, d_chunk=4)
                               .numpy(), want, **ECHO_TOL)
    want_p = np.asarray(_jit(jecho.echo_panel)(jnp.asarray(x), jp, n_bins,
                                               panel_chunk=5))
    np.testing.assert_allclose(tep.echo_panel_fused(_t(x), tp, n_bins)
                               .numpy(), want_p, **ECHO_TOL)
    x2 = np.stack([x, _features(rng, jt.n_pad, 5)])
    both = tep.echo_panel_fused(_t(x2), tbanded.concat_panel_tables([tp, tp]),
                                n_bins)
    np.testing.assert_allclose(both[0].numpy(), want_p, **ECHO_TOL)
    stacked = dataclasses.replace(
        tt, **{f: torch.stack([getattr(tt, f)] * 2)
               for f in ("src", "mask", "rsten", "fwxp", "ln", "wxp",
                         "vmask")})
    np.testing.assert_allclose(techo.echo(_t(x2), stacked, n_bins)[1].numpy(),
                               both[1].numpy(), **ECHO_TOL)
    # the ECHO module's routes: a PanelTable takes the panel op, a table
    # without block layout the one-hot echo
    for got in (ECHO(n_bins)(_t(x), tt, tp), ECHO(n_bins)(_t(x), tt)):
        np.testing.assert_allclose(got.numpy(), want_p, **ECHO_TOL)


@pytest.mark.parametrize("n_bins", [2, 3])
def test_k2_plain_matches_pallas(rng, n_bins):
    """The K2 plain version against the Pallas _fwd_impl grid (interpret
    mode), the op against the port's own one-hot echo, and (n_bins 2) the
    op against echo_panel_pallas with its CPU gradient against the JAX
    gradient of echo_panel_pallas (its hand-written backward, interpreted).
    At n_bins 3 the op's fold and soft_abs are those checked at n_bins 2
    around a grid checked above, so echo_panel_pallas is not run again."""
    _, jt, jp = _panel_setup(rng, compressed=True)
    tt = _port_table(jt)
    tp = tbanded.build_panel_table(tt, tb=TB, compressed=True)
    N, C = jt.n_pad, 5
    x = _features(rng, N, C)
    x2t = jnp.concatenate([jnp.asarray(x[..., 0]).T,
                           jnp.asarray(x[..., 1]).T], axis=0)
    want_grid = jep._fwd_impl(x2t, jp.sten, jp.meta, TB, n_bins, 2, N // TB)
    before = dict(kernels.launches)
    grid = tep.echo_panel_grid(_t(x), tp.sten, tp.meta, n_bins, N // TB)
    np.testing.assert_allclose(grid.numpy(), np.asarray(want_grid),
                               **ECHO_TOL)

    xt = _t(x).requires_grad_()
    got = tep.echo_panel_fused(xt, tp, n_bins)
    assert kernels.launches == before          # CPU: the plain version
    np.testing.assert_allclose(got.detach().numpy(),
                               techo.echo(_t(x), tt, n_bins).numpy(),
                               **ECHO_TOL)
    if n_bins == 3:
        return
    op = functools.partial(jep.echo_panel_pallas, panel=jp, n_bins=n_bins,
                           cc=2)
    want, vjp = jax.vjp(op, jnp.asarray(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **ECHO_TOL)
    torch.sin(got).sum().backward()
    (jg,) = vjp(jnp.cos(want))         # d/dx Σ sin(echo)
    assert torch.isfinite(xt.grad).all()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), **ECHO_TOL)


def test_k2_on_cuda_tensors_needs_the_kernel(rng, monkeypatch):
    """No silent CPU fallback: on CUDA tensors the K2 wrapper goes to the
    kernel's entry point, whose build fails here for want of nvcc, and a
    gradient request through the op's autograd Function reaches the backward
    kernel's entry point (patched entries record the calls)."""
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
        x = torch.zeros(16, 3, 2, device="cuda")
        sten = torch.zeros(3, 5, 8, 8, device="cuda")
        meta = torch.zeros(4, 3, dtype=torch.int32, device="cuda")
        dg = torch.zeros(2, 50, 3, 8, device="cuda")
        for call in (lambda: tep.echo_panel_grid(x, sten, meta, 2, 2),
                     lambda: tep.echo_panel_grid_bwd(dg, x, sten, meta, 2,
                                                     2)):
            with pytest.raises(RuntimeError, match="nvcc"):
                call()
        monkeypatch.setattr(tep, "_k2_entry", entry)
        with pytest.raises(Entered):
            tep.echo_panel_grid(x, sten, meta, 2, 2)
        assert entered == [True]

        # the autograd Function's backward, on a context holding what its
        # forward saves (autograd cannot record a graph over fake CUDA
        # tensors in a build without CUDA)
        monkeypatch.setattr(tep, "_k2_bwd_entry", entry)
        ctx = types.SimpleNamespace(saved_tensors=(x, sten, meta), n_bins=2,
                                    nb_out=2)
        with pytest.raises(Entered):
            tep._EchoPanelFn.backward(ctx, dg)
    assert entered == [True, True]
    assert kernels.launches == before


# --- lift -------------------------------------------------------------------------

@pytest.mark.parametrize("lift_cols", [(1, 2), (0, 1)])
def test_trans_field_panel_matches_jax(rng, lift_cols):
    _, jt, jp = _panel_setup(rng, compressed=True, B=1)
    tt = _port_table(jt)
    tp = tbanded.build_panel_table(tt, tb=TB, compressed=True)
    x = rng.normal(size=(jt.n_pad, 3)).astype(np.float32)
    want = _jit(jtf.trans_field_panel_contrib)(jnp.asarray(x), jp, lift_cols,
                                               panel_chunk=5)
    got = ttf.trans_field_panel_contrib(_t(x), tp, lift_cols, panel_chunk=5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **ECHO_TOL)
    # the dispatch by table type, against the gather route
    za, zm = (rng.normal(size=(4, 3, 3)).astype(np.float32) for _ in "am")
    ph = rng.normal(size=(4, 3)).astype(np.float32)
    args = (za, zm, ph)
    want = jax.jit(lambda x, t, *a: jtf.trans_field(
        x, t, *a, 1, lift_cols=lift_cols, comp=None))(
            jnp.asarray(x), jt, *map(jnp.asarray, args))
    got = ttf.trans_field(_t(x), tt, *map(_t, args), 1, lift_cols=lift_cols,
                          comp=tp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


def test_trans_field_panel_dense_raises(rng):
    """The lift over a dense PanelTable, once refused here, now computes:
    it equals the lift over the compressed panels of the same EdgeTable
    (tests/test_torch_blocksparse.py holds it against the JAX package's
    dense branch).  The name is the old behaviour's, kept so that the
    test's record carries on."""
    _, jt, _ = _panel_setup(rng, compressed=False, B=1)
    tt = _port_table(jt)
    x = _t(rng.normal(size=(jt.n_pad, 3)))
    dense, comp = (ttf.trans_field_panel_contrib(
        x, tbanded.build_panel_table(tt, tb=TB, compressed=c), (1, 2))
        for c in (False, True))
    for a, b in zip(dense, comp):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **ECHO_TOL)


# --- blocks and nets -----------------------------------------------------------------

# each preset's band limit, rings and bins, at narrow widths
_PRESET = {
    "segmentation": dict(band_limit=2, n_rings=6, n_bins=3),
    "correspondence": dict(band_limit=1, n_rings=3, n_bins=2, center=True),
}


def _configs(task):
    kw = dict(task=task, nf=4, n_des=4, echo_impl="panel", **_PRESET[task])
    return JaxConfig(**kw), ExperimentConfig(**kw)


def test_echo_block_matches_jax(rng, task="correspondence"):
    """ECHOBlock on the mixed route over two meshes: one joined panel table
    and one K1 call in the port, the JAX block applied mesh by mesh (the
    nets below run each preset's block on one mesh)."""
    p = _PRESET[task]
    jrecs = _records(rng, task, n_meshes=2, N=20)
    jconfig, _ = _configs(task)
    items = []
    for r in jrecs:
        t = r.table(p["band_limit"], p["n_rings"], n_pad=24, d_slots=8)
        items.append((r.padded_pos(24), t, r.padded_labels(24)))
    jb = jtrainer.stack_batch(items, banded_tb=TB, echo_panel=True)
    tb_ = stack_batch([(pos, _port_table(t), lab) for pos, t, lab in items],
                      banded_tb=TB, echo_panel=True)
    x = np.stack([_features(rng, 24, 5) for _ in jrecs])
    kw = dict(n_des=4, n_bins=p["n_bins"], band_limit=p["band_limit"],
              n_rings=p["n_rings"], echo_impl="panel")
    jblock = JaxECHOBlock(5, 3, **kw)
    t0 = jax.tree.map(lambda a: a[0], jb.table)
    block = ECHOBlock(5, 3, **kw, generator=torch.Generator().manual_seed(0))
    params = _jax_params(block, jax.eval_shape(
        jblock.init, jax.random.key(0), jnp.asarray(x[0]), t0))

    def run(params):
        return jnp.stack([jblock.apply(
            params, jnp.asarray(x[i]), jax.tree.map(lambda a: a[i], jb.table),
            jax.tree.map(lambda a: a[i], jb.banded), jb.panel[i])
            for i in range(2)])

    want = np.asarray(jax.jit(run)(params))
    with torch.no_grad():
        got = block(_t(x), tb_.table, tb_.banded, tb_.panel).numpy()
    assert got.shape == want.shape == (2, 24, 3)
    np.testing.assert_allclose(got, want, **NET_TOL)


@pytest.fixture(scope="module")
def jax_nets():
    """Per ECHO preset: records, weights (the port's init from a seed, in
    both nets), and the JAX net's logits on a mixed batch built by JAX's
    make_batches (stack_batch(echo_panel=True)), computed once per module
    (the Pallas kernels run interpreted)."""
    out = {}
    for seed, task in enumerate(("segmentation", "correspondence")):
        jconfig, config = _configs(task)
        jrecs = _records(np.random.default_rng(seed), task, n_meshes=1,
                         N=20, n_classes=3)
        net = jloop.build_model(jconfig, 3)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")        # the onehot fallback
            b0 = jloop.make_batches(jrecs, jconfig, 1, None, 24, 8)[0]
        params = _jax_params(
            tloop.build_model(config, 3, torch.Generator().manual_seed(seed),
                              device="cpu"),
            jax.eval_shape(net.init, jax.random.key(seed), b0.pos[0],
                           jax.tree.map(lambda a: a[0], b0.table)))
        jb = jloop.make_batches(jrecs, jconfig, 1, TB, 24, 8)[0]
        assert jb.panel is not None and jb.comp is None
        kw = {}
        if task == "correspondence":
            mask = (np.random.default_rng(9).random((24, 256)) < 0.5)
            kw["dropout_mask"] = mask.astype(np.float32)
        logits = jax.jit(lambda p, b, kw: jtrainer.batched_apply(
            net, p, b, **kw))(params, jb, kw)
        out[task] = dict(recs=jrecs, params=params, logits=np.asarray(logits),
                         config=jconfig, kw=kw)
    return out


def _port_net(params, task):
    _, config = _configs(task)
    net = tloop.build_model(config, 3, device="cpu")
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)),
                        strict=True)
    return config, net.eval()


@pytest.mark.parametrize("task", ["segmentation", "correspondence"])
def test_net_matches_jax_mixed_route(jax_nets, task):
    """The port's net over its mixed batch (K1 convs, panel lift, K2's plain
    version) against the JAX net's over the JAX mixed batch; the
    correspondence net with the same injected dropout mask."""
    side = jax_nets[task]
    config, net = _port_net(side["params"], task)
    tb_ = tloop.make_batches(_port_records(side["recs"]), config, 1, TB, 24,
                             8, device="cpu")[0]
    assert tb_.panel is not None and tb_.comp is None
    kw = {k: torch.from_numpy(v) for k, v in side["kw"].items()}
    with torch.no_grad():
        got = batched_apply(net, tb_, **kw).numpy()
    assert got.shape == side["logits"].shape == (1, 24, 3)
    np.testing.assert_allclose(got, side["logits"], **NET_TOL)


@pytest.mark.parametrize("task", ["segmentation", "correspondence"])
def test_predictor_echo_tasks_match_jax(jax_nets, task, rng):
    """Predictor on the CPU: outputs as the JAX Predictor's _to_output
    forms them from the JAX logits (argmax over the record's true rows),
    and a batch of two meshes equals each mesh served alone."""
    side = jax_nets[task]
    config, net = _port_net(side["params"], task)
    if task == "correspondence":
        # serving is deterministic: no dropout mask, the net in eval()
        net.train()
    recs = _port_records(side["recs"])
    pred = Predictor(net, config, banded_tb=TB, device="cpu")
    assert not net.training
    got = pred.predict(recs, 24, 8)[0]
    full = pred.logits(pred.make_batches(recs, 24, 8)[0])[0].numpy()
    jshim = types.SimpleNamespace(config=side["config"])
    want = JaxPredictor._to_output(jshim, full, 20)
    assert set(got) == set(want) == {"labels" if task == "segmentation"
                                     else "map", "logits"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    if task == "segmentation":              # deterministic: the JAX logits
        np.testing.assert_allclose(got["logits"], side["logits"][0, :20],
                                   **NET_TOL)

    more = recs + _port_records(_records(rng, task, n_meshes=1, N=17,
                                         n_classes=3))
    both = Predictor(net, config, batch_size=2, banded_tb=TB,
                     device="cpu").predict(more, 24, 8)
    alone = pred.predict(more, 24, 8)
    for a, b, r in zip(both, alone, more):
        key = "labels" if task == "segmentation" else "map"
        assert a["logits"].shape == (r.n_samples, 3)
        np.testing.assert_allclose(a["logits"], b["logits"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(a[key], b[key])


# --- routing ------------------------------------------------------------------------

def test_make_batches_echo_routes(rng):
    """Without banded_tb the panel preset warns and takes the one-hot ECHO
    (the JAX semantics); echo_impl="compact" takes the mixed route over a
    CompactPanelTable; echo_impl="banded" builds the compressed banded
    table (under lift_impl="gather" too) and routes ECHO through
    echo_banded, and without banded_tb raises the JAX package's
    ValueError; matching raises."""
    _, config = _configs("segmentation")
    recs = _port_records(_records(rng, "segmentation", n_meshes=1, N=20))
    with pytest.warns(UserWarning, match="one-hot"):
        b = tloop.make_batches(recs, config, 1, None, device="cpu")[0]
    assert b.panel is None and b.banded is None and b.comp is None
    net = tloop.build_model(config, 3, device="cpu").eval()
    with torch.no_grad():
        onehot = batched_apply(net, b)
        mixed = batched_apply(net, tloop.make_batches(
            recs, config, 1, TB, 128, 8, device="cpu")[0])
    np.testing.assert_allclose(onehot.numpy(), mixed.numpy(), **NET_TOL)
    for impl in ("banded", "compact"):
        cfg = dataclasses.replace(config, echo_impl=impl)
        if impl == "compact":        # the mixed route over a compact table
            b = tloop.make_batches(recs, cfg, 1, TB, device="cpu")[0]
            assert b.compact is not None and b.banded is not None
            continue
        cfg = dataclasses.replace(cfg, lift_impl="gather")
        b = tloop.make_batches(recs, cfg, 1, TB, 128, 8, device="cpu")[0]
        assert isinstance(b.comp, tbanded.CompressedBandedTable)
        assert b.banded is not None and b.panel is None
        echo = ECHO(cfg.n_bins, impl="banded")
        x = torch.from_numpy(_features(rng, 128, 3))[None]
        np.testing.assert_allclose(
            echo(x, b.table, b.comp).numpy(),
            techo.echo_banded(x, b.comp, cfg.n_bins).numpy())
        with pytest.raises(ValueError, match="requires banded_tb"):
            tloop.make_batches(recs, cfg, 1, None, device="cpu")
    matching = ExperimentConfig(task="matching")
    with pytest.raises(NotImplementedError, match="matching"):
        tloop.build_model(matching, 3, device="cpu")
    with pytest.raises(NotImplementedError, match="matching"):
        Predictor(net, matching, device="cpu")
