"""The port's ops against the JAX package's on the same numpy inputs.

Tolerances: elementwise ops agree to float32 rounding (rtol 1e-6, atol
1e-6).  Contractions sum in another order than XLA, so they are held to
atol 2e-5 at the O(1)-O(10) magnitudes these inputs produce (the bar
tests/test_band_conv.py sets the Pallas kernel against the XLA path).
The K1 plain version is held against the real Pallas kernel, which runs in
interpret mode on the CPU.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import random_field
from test_band_conv import banded_graph, tables_for
from fieldconv_tpu.ops import field_conv as jfc
from fieldconv_tpu.ops import tangent as jtan
from fieldconv_tpu.ops import trans_field as jtf
from fieldconv_tpu.ops.pallas import band_conv as jbc
from fieldconv_tpu.precomp.banded import build_compressed_banded
from fieldconv_tpu.utils import complexops as jco
from fieldconv_tpu_torch import kernels
from fieldconv_tpu_torch.ops import band_conv as tbc
from fieldconv_tpu_torch.ops import field_conv as tfc
from fieldconv_tpu_torch.ops import tangent as ttan
from fieldconv_tpu_torch.ops import trans_field as ttf
from fieldconv_tpu_torch.precomp import banded as tbanded
from fieldconv_tpu_torch.precomp.stencil import build_edge_table
from fieldconv_tpu_torch.utils import complexops as tco

# Six pytest-xdist workers share the machine's cores.  With torch's
# default of one OpenMP thread per core in each, their threads spin
# against each other and a small CPU fit that takes 1-2 s alone takes
# minutes in the full run; one thread each keeps the port's tests near
# their time alone.  Every port test file sets it (each worker imports
# them all, so any one of them caps the worker).
torch.set_num_threads(1)

ATOL = 2e-5


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol)


def _planar(z):
    return np.stack([z.real, z.imag], -1).astype(np.float32)


def _port_tables(g, tb=8):
    """The port's EdgeTable, BandedTable and CompressedBandedTable for the
    same graph as test_band_conv.tables_for."""
    table = build_edge_table(
        g["edges"], g["log_mag"], g["log_ang"], g["w"], g["xp"],
        g["n_vertices"], g["B"], g["R"], g["epsilon"], n_multiple=tb)
    return (table, tbanded.build_banded_table(table, tb=tb),
            tbanded.build_compressed_banded(table, tb=tb))


# --- complexops --------------------------------------------------------------

_UNARY = ["soft_abs", "soft_angle", "is_origin", "cconj", "cabs2"]


@pytest.mark.parametrize("name", _UNARY)
def test_complexops_values_and_grads(rng, name):
    """Values agree on inputs with exact zeros; for the differentiable ops
    the gradients agree and stay finite there (double-where)."""
    z = _planar(random_field(rng, 40, 5))
    z[:3] = 0.0
    z[3, :, 0] = 5e-8                       # inside the origin cutoff
    jf, tf = getattr(jco, name), getattr(tco, name)
    want = jf(jnp.asarray(z))
    zt = torch.tensor(z, requires_grad=name != "is_origin")
    got = tf(zt)
    if name == "is_origin":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    _close(got, want, atol=1e-6, rtol=1e-6)
    w = rng.normal(size=np.shape(want)).astype(np.float32)
    jg = jax.grad(lambda a: jnp.sum(jf(a) * w))(jnp.asarray(z))
    (got * torch.from_numpy(w)).sum().backward()
    assert torch.isfinite(zt.grad).all()
    # gradients of the angle map scale as 1/|z| and cancel in sums:
    # hold them to float32 rounding of the largest one
    _close(zt.grad, jg, atol=1e-5 * max(1.0, float(np.abs(jg).max())),
           rtol=1e-5)


def test_complexops_modrelu_and_real(rng):
    z = _planar(random_field(rng, 40, 5))
    b = rng.normal(size=(5,)).astype(np.float32)
    zt = torch.tensor(z, requires_grad=True)
    got = tco.modrelu(zt, _t(b))
    _close(got, jco.modrelu(jnp.asarray(z), jnp.asarray(b)), atol=1e-6)
    got.sum().backward()
    jg = jax.grad(lambda a: jnp.sum(jco.modrelu(a, jnp.asarray(b))))(
        jnp.asarray(z))
    _close(zt.grad, jg, atol=1e-5)

    x = rng.normal(size=(50,)).astype(np.float32)
    x[:5] = 0.0
    _close(tco.soft_absolute(_t(x)), jco.soft_absolute(jnp.asarray(x)), 0)
    th = rng.uniform(-np.pi, np.pi, 30).astype(np.float32)
    _close(tco.cpolar(_t(np.abs(x[:30])), _t(th)),
           jco.cpolar(jnp.asarray(np.abs(x[:30])), jnp.asarray(th)), 1e-6)
    _close(tco.cexpi(_t(th)), jco.cexpi(jnp.asarray(th)), atol=1e-6)
    a, c = z[:, :2], z[:, 2:4]
    _close(tco.cmul(_t(a), _t(c)), jco.cmul(jnp.asarray(a), jnp.asarray(c)),
           atol=1e-6)


# --- field conv pieces --------------------------------------------------------

@pytest.mark.parametrize("B", [1, 2])
def test_rotated_source_tensor(rng, B):
    x = _planar(random_field(rng, 24, 3))
    _close(tfc.rotated_source_tensor(_t(x), B),
           jfc.rotated_source_tensor(jnp.asarray(x), B), atol=1e-5)
    _close(tbc.rotated_source_tensor_kmajor(_t(x), B),
           jbc.rotated_source_tensor_kmajor(jnp.asarray(x), B), atol=1e-5)


def _filters(rng, ftype, O=3, C=4, R=6, B=2):
    if ftype == 2:
        zr = rng.normal(size=(O, C, R, 2))
        sph = rng.normal(size=(O, C, R, 2 * B, 2))
    else:
        zr = rng.normal(size=(O, C, R))
        sph = rng.normal(size=(O, C, R, B, 2))
    ph = rng.normal(size=(O, C, B + 1))
    return [np.asarray(a, np.float32) for a in (zr, sph, ph)]


@pytest.mark.parametrize("ftype", [0, 1, 2])
def test_filter_coefficients_and_wmat(rng, ftype):
    zr, sph, ph = _filters(rng, ftype)
    want = jfc.filter_coefficients(*map(jnp.asarray, (zr, sph, ph)), ftype, 2)
    got = tfc.filter_coefficients(_t(zr), _t(sph), _t(ph), ftype, 2)
    _close(got, want, atol=1e-6)
    _close(tbc.filters_to_wmat(got), jbc.filters_to_wmat(want), atol=1e-6)


def test_field_conv_gather_and_tangent_lin(rng):
    g = banded_graph(rng, n_vertices=24, bw=5)
    jt, _ = tables_for(g)
    tt, _, _ = _port_tables(g)
    x = _planar(random_field(rng, jt.n_pad, 4))
    zr, sph, ph = _filters(rng, 1)
    want = jfc.field_conv(jnp.asarray(x), jt, *map(jnp.asarray, (zr, sph, ph)),
                          1, d_chunk=4)
    got = tfc.field_conv(_t(x), tt, _t(zr), _t(sph), _t(ph), 1, d_chunk=4)
    _close(got, want)
    wre, wim = (rng.normal(size=(3, 4)).astype(np.float32) for _ in "ri")
    _close(ttan.tangent_lin(_t(x), _t(wre), _t(wim)),
           jtan.tangent_lin(jnp.asarray(x), jnp.asarray(wre),
                            jnp.asarray(wim)), atol=1e-5)


# --- K1: plain version vs the Pallas kernel (interpret mode) ------------------

# K1's cases beyond the bandwidths: "corr" the correspondence preset's
# shape (band limit 1, 3 rings) at nh = 1; "ends" a window past both ends
# at nh = 2 whose out-of-range slots hold nonzero values (they add
# nothing, in either package).  bw: (bandwidth, band limit, rings, fill)
K1_CASES = {"corr": (7, 1, 3, False), "ends": (12, 2, 6, True)}


def k1_case(bw):
    return K1_CASES.get(bw, (bw, 2, 6, False))


def fill_outside(sten, tb, nh, rng):
    """A copy of the band stencil (nb, P, TB, W') with random values in
    every slot whose source block lies outside [0, nb)."""
    sten = np.array(sten, np.float32)
    nb = sten.shape[0]
    for b in range(nb):
        for j in range(2 * nh + 1):
            if not 0 <= b - nh + j < nb:
                part = sten[b, ..., j * tb:(j + 1) * tb]
                part[...] = rng.normal(size=part.shape)
    return sten


@pytest.mark.parametrize("ftype,bw", [(0, 7), (1, 7), (2, 7), (0, 12),
                                      (1, 12), (2, 12), (1, "corr"),
                                      (2, "ends")])
def test_k1_plain_matches_pallas(rng, ftype, bw):
    """field_conv_banded through the K1 plain version equals the JAX
    package's field_conv_banded, whose Pallas kernel runs interpreted;
    bw 7 gives nh=1 and bw 12 nh=2 at tb=8 (K1_CASES for the others)."""
    bw, B, R, fill = k1_case(bw)
    g = banded_graph(rng, n_vertices=32, tb=8, bw=bw, B=B, R=R)
    jt, jb = tables_for(g)
    _, tb_, _ = _port_tables(g)
    assert tb_.nh == jb.nh == (1 if bw < 8 else 2)
    if fill:
        sten = fill_outside(jb.sten_band, 8, jb.nh, rng)
        assert (sten != np.asarray(jb.sten_band)).any()
        jb = dataclasses.replace(jb, sten_band=jnp.asarray(sten))
        tb_ = dataclasses.replace(tb_, sten_band=_t(sten))
    x = _planar(random_field(rng, jt.n_pad, 4))
    zr, sph, ph = _filters(rng, ftype, R=R, B=B)
    want = jbc.field_conv_banded(jnp.asarray(x), jb,
                                 *map(jnp.asarray, (zr, sph, ph)), ftype)
    before = kernels.launches["band_fused_fwd"]
    got = tbc.field_conv_banded(_t(x), tb_, _t(zr), _t(sph), _t(ph), ftype)
    _close(got, want)
    assert kernels.launches["band_fused_fwd"] == before   # CPU: plain path


def test_k1_batched_one_call_equals_per_mesh(rng):
    """A stacked batch of two meshes (one K1 call) equals each mesh alone
    and the gather path."""
    graphs = [banded_graph(rng, n_vertices=32, bw=bw) for bw in (6, 7)]
    tabs = [_port_tables(g) for g in graphs]
    nh = max(t[1].nh for t in tabs)
    sten = torch.stack([t[1].sten_band for t in tabs])
    bt = tbanded.BandedTable(sten, tb=8, nh=nh, n_pad=32, band_limit=2,
                             n_rings=6)
    x = np.stack([_planar(random_field(rng, 32, 4)) for _ in tabs])
    zr, sph, ph = (_t(a) for a in _filters(rng, 1))
    both = tbc.field_conv_banded(_t(x), bt, zr, sph, ph, 1)
    for i, (table, band, _) in enumerate(tabs):
        one = tbc.field_conv_banded(_t(x[i]), band, zr, sph, ph, 1)
        _close(both[i], one.numpy(), atol=1e-5)
        _close(both[i], tfc.field_conv(_t(x[i]), table, zr, sph, ph, 1)
               .numpy())


def test_k1_unported_routes_raise(rng):
    """The routes this test once pinned as unported now compute: a
    CompressedBandedTable runs K4 and fuse_filters=False runs K3, both equal
    to the K1 route (tests/test_torch_cbanded.py holds them against JAX).
    The bf16 operand path still raises, and a table type field_conv_banded
    does not take (here an EdgeTable) raises a TypeError that names it
    (the K8 table, BlockSparseTable, computes since its port:
    tests/test_torch_blocksparse.py).  The name is the old behaviour's,
    kept so that the test's record carries on."""
    g = banded_graph(rng, n_vertices=16, bw=5)
    table, band, comp = _port_tables(g)
    x = _t(_planar(random_field(rng, 16, 4)))
    f = [_t(a) for a in _filters(rng, 1)]
    want = tbc.field_conv_banded(x, band, *f, 1)
    for tab, kw in ((comp, {}), (band, dict(fuse_filters=False))):
        _close(tbc.field_conv_banded(x, tab, *f, 1, **kw), want.numpy())
    with pytest.raises(NotImplementedError, match="bf16"):
        tbc.field_conv_banded(x, band, *f, 1, precision="bf16")
    with pytest.raises(TypeError, match="got EdgeTable"):
        tbc.field_conv_banded(x, table, *f, 1)


# --- lift -----------------------------------------------------------------------

@pytest.mark.parametrize("lift_cols", [(0, 1), (2, 3)])
def test_trans_field_banded_and_gather(rng, lift_cols):
    g = banded_graph(rng, n_vertices=32, bw=10)
    jt, _ = tables_for(g)
    jc = build_compressed_banded(jt, tb=8)
    tt, _, tc = _port_tables(g)
    x = rng.normal(size=(jt.n_pad, 3)).astype(np.float32)
    want = jtf.trans_field_banded_contrib(jnp.asarray(x), jc, lift_cols)
    got = ttf.trans_field_banded_contrib(_t(x), tc, lift_cols)
    for a, b in zip(got, want):
        _close(a, b)

    za, zm = (rng.normal(size=(5, 3, 6)).astype(np.float32) for _ in "am")
    ph = rng.normal(size=(5, 3)).astype(np.float32)
    for comp_j, comp_t in ((None, None), (jc, tc)):
        want = jtf.trans_field(jnp.asarray(x), jt, jnp.asarray(za),
                               jnp.asarray(zm), jnp.asarray(ph), 1,
                               lift_cols=lift_cols, d_chunk=8, comp=comp_j)
        got = ttf.trans_field(_t(x), tt, _t(za), _t(zm), _t(ph), 1,
                              lift_cols=lift_cols, d_chunk=8, comp=comp_t)
        _close(got, want, atol=5e-5)
