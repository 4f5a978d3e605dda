"""The port's serving path against the JAX package's, end to end.

Both packages get the same numpy records (test_deploy._records) and the
same weights (the JAX init, carried across by params_from_jax).  Logits
are held to rtol 5e-4 / atol 5e-5, the bar tests/test_deploy.py sets the
JAX banded path against its own XLA path: the two frameworks sum the
contractions in different orders.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from test_deploy import _records
from fieldconv_tpu.data.base import ArtifactStore as JaxStore
from fieldconv_tpu.train import loop as jloop
from fieldconv_tpu.train import trainer as jtrainer
from fieldconv_tpu.train.config import ExperimentConfig as JaxConfig
from fieldconv_tpu_torch import kernels
from fieldconv_tpu_torch.data.base import ArtifactStore, MeshRecord
from fieldconv_tpu_torch.deploy import Predictor
from fieldconv_tpu_torch.ops import band_conv as tbc
from fieldconv_tpu_torch.train import loop as tloop
from fieldconv_tpu_torch.train.config import ExperimentConfig
from fieldconv_tpu_torch.train.trainer import batched_apply
from fieldconv_tpu_torch.utils.port_weights import params_from_jax

torch.set_num_threads(1)   # one per xdist worker: see test_torch_ops.py

RTOL, ATOL = 5e-4, 5e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CFG = dict(task="classification", band_limit=2, n_rings=6, nf=8, ftype=1)


def _port_records(jrecs):
    return [MeshRecord(**dataclasses.asdict(r)) for r in jrecs]


def _jax_model(jrecs, n_classes=4, seed=0):
    config = JaxConfig(**_CFG)
    net = jloop.build_model(config, n_classes)
    n_pad, d_slots = jloop.shared_bucket(jrecs)
    b0 = jloop.make_batches(jrecs, config, 1, None, n_pad, d_slots)[0]
    params = jax.jit(net.init)(jax.random.key(seed), b0.pos[0],
                               jax.tree.map(lambda x: x[0], b0.table))
    return config, net, params


def _jax_logits(net, params, batch):
    return np.asarray(jax.jit(
        lambda p, b: jtrainer.batched_apply(net, p, b))(params, batch))


def _port_model(params, n_classes=4):
    config = ExperimentConfig(**_CFG)
    net = tloop.build_model(config, n_classes, device="cpu")
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)),
                        strict=True)
    return config, net


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """One JAX model, its weights, and its outputs on two records: the
    banded route through the JAX Predictor (bundle, banded_tb=8, one batch
    of two) and the gather route.  Shared so the JAX package compiles each
    route once."""
    from fieldconv_tpu.deploy import Predictor as JaxPredictor
    from fieldconv_tpu.deploy import export_bundle

    jrecs = _records(np.random.default_rng(0), n_meshes=2, N=20,
                     n_classes=4)
    jconfig, jnet, params = _jax_model(jrecs)
    path = export_bundle(str(tmp_path_factory.mktemp("bundle")), jconfig,
                         params, 4)
    banded = JaxPredictor(path, batch_size=2, banded_tb=8).predict(jrecs)
    gather = _jax_logits(jnet, params,
                         jloop.make_batches(jrecs, jconfig, 2, None)[0])
    return dict(recs=jrecs, config=jconfig, net=jnet, params=params,
                logits={8: np.stack([o["logits"] for o in banded])[:, None],
                        None: gather},
                predictions=banded)


@pytest.mark.parametrize("banded_tb", [None, 8])
def test_classification_net_matches_jax(jax_side, banded_tb):
    """banded_tb=8: K1 convs + gather-free lift (BandedTable + comp);
    None: the gather route."""
    config, net = _port_model(jax_side["params"])
    tb = tloop.make_batches(_port_records(jax_side["recs"]), config, 2,
                            banded_tb, device="cpu")[0]
    assert (tb.banded is None) == (banded_tb is None)
    assert (tb.comp is None) == (banded_tb is None)
    want = jax_side["logits"][banded_tb]
    with torch.no_grad():
        got = batched_apply(net, tb).numpy()
    assert got.shape == want.shape == (2, 1, 4)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_predictor_matches_jax_predictor(jax_side):
    config, net = _port_model(jax_side["params"])
    pred = Predictor(net, config, batch_size=2, banded_tb=8, device="cpu")
    got = pred.predict(_port_records(jax_side["recs"]))
    want = jax_side["predictions"]
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert set(a) == {"class", "logits"}
        assert a["class"] == b["class"]
        np.testing.assert_allclose(a["logits"], b["logits"],
                                   rtol=RTOL, atol=ATOL)


def test_predictor_warmup_and_strict_shapes(jax_side):
    config, net = _port_model(jax_side["params"])
    pred = Predictor(net, config, banded_tb=8, strict_shapes=True,
                     device="cpu")
    jrecs = jax_side["recs"]
    batches = pred.make_batches(_port_records(jrecs))
    with pytest.raises(RuntimeError, match="not warmed up"):
        pred.logits(batches[0])
    assert len(batches) == 2
    assert pred.warmup(batches) == 1          # one shared bucket signature
    assert pred.warmup(batches) == 0
    assert pred.logits(batches[0]).shape == (1, 1, 4)
    with pytest.raises(ValueError, match="both"):
        pred.make_batches(_port_records(jrecs), n_pad=128)


def test_batch_pool_divides_by_first_mesh_count(jax_side, rng):
    """The stacked table keeps mesh 0's n_valid, so in a batch of meshes
    of unequal sizes mesh 1's mean pool divides by mesh 0's count: its
    logits equal its own-batch logits scaled by n1/n0 (bias is zero at
    init).  The port reproduces the JAX package's quirk (ROADMAP Queue 3)."""
    jrecs = (_records(rng, n_meshes=1, N=20, n_classes=4)
             + _records(rng, n_meshes=1, N=14, n_classes=4))
    jconfig, jnet, params = (jax_side[k] for k in ("config", "net", "params"))
    config, net = _port_model(params)
    precs = _port_records(jrecs)
    together = Predictor(net, config, batch_size=2, device="cpu")
    alone = Predictor(net, config, batch_size=1, device="cpu")
    n_pad, d_slots = tloop.shared_bucket(precs)
    both = together.predict(precs, n_pad, d_slots)
    one = alone.predict(precs, n_pad, d_slots)
    np.testing.assert_allclose(both[0]["logits"], one[0]["logits"],
                               rtol=1e-6)
    np.testing.assert_allclose(both[1]["logits"],
                               one[1]["logits"] * 14 / 20, rtol=1e-5)
    jb = jloop.make_batches(jrecs, jconfig, 2, None, n_pad, d_slots)[0]
    want = _jax_logits(jnet, params, jb)[:, 0]
    np.testing.assert_allclose(np.stack([o["logits"] for o in both]), want,
                               rtol=RTOL, atol=ATOL)


def test_artifact_store_reads_jax_files(rng, tmp_path):
    """An .npz written by the JAX package loads in the port, and one the
    port writes loads in the JAX package, field for field."""
    jrec = _records(rng, n_meshes=1, N=20)[0]
    JaxStore(str(tmp_path)).save("k", jrec)
    store = ArtifactStore(str(tmp_path))
    assert store.has("k")
    back = store.load("k")
    for f in dataclasses.fields(back):
        a, b = getattr(back, f.name), getattr(jrec, f.name)
        if f.name in ("rcm_perm", "sample_idx"):
            b = np.arange(jrec.n_samples)      # the JAX writer's default
        elif f.name == "center_mean":
            b = jrec.pos.mean(axis=0)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), f.name)

    store.save("p", back)
    again = JaxStore(str(tmp_path)).load("p")
    for f in dataclasses.fields(back):
        np.testing.assert_array_equal(np.asarray(getattr(again, f.name)),
                                      np.asarray(getattr(back, f.name)))


def test_port_imports_no_jax():
    """Every module of the port (the scripts under fieldconv_tpu_torch/
    scripts/ included), and chip_smoke.py, import without JAX or the JAX
    package (the pytest process itself has JAX loaded)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import fieldconv_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "assert 'fieldconv_tpu_torch.scripts.train_100k' in mods, mods\n"
        "for m in mods + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'fieldconv_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_cuda_requests_raise_without_a_card(rng):
    """No silent CPU fallback: entry points asked for CUDA, and the K1
    wrappers given CUDA tensors, raise on a machine without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    from torch._subclasses.fake_tensor import FakeTensorMode

    config = ExperimentConfig(**_CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tloop.build_model(config, 4)
    recs = _port_records(_records(rng, n_meshes=1, N=20))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tloop.make_batches(recs, config, 1, 8)
    net = tloop.build_model(config, 4, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(net, config, banded_tb=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tloop.fit(config, recs, n_classes=4, banded_tb=8)

    before = dict(kernels.launches)
    with FakeTensorMode():
        g = torch.zeros(1, 16, 20, device="cuda")
        sten = torch.zeros(1, 2, 16, 8, 24, device="cuda")
        wmat = torch.zeros(6, 20, 4, device="cuda")
        dy = torch.zeros(1, 16, 4, device="cuda")
        with pytest.raises(RuntimeError):
            tbc.band_fused_fwd(g, sten, wmat, 8, 1)
        with pytest.raises(RuntimeError):
            tbc.band_fused_bwd(dy, g, sten, wmat, 8, 1)
    assert kernels.launches == before
