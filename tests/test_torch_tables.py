"""The port's table builders against the JAX package's (exact equality).

Inputs are made with numpy from a seed (conftest.random_graph) and fed to
both builders; every array must be equal bit for bit, since both run the
same float64/float32 numpy arithmetic.
"""

import numpy as np
import pytest
import torch

from conftest import random_graph
from fieldconv_tpu.precomp import banded as jbanded
from fieldconv_tpu.precomp.stencil import build_edge_table as jax_build
from fieldconv_tpu_torch.precomp import banded as tbanded
from fieldconv_tpu_torch.precomp.stencil import (build_edge_table,
                                                 radial_interpolant)

torch.set_num_threads(1)   # one per xdist worker: see test_torch_ops.py

_FIELDS = ("src", "mask", "rsten", "fwxp", "ln", "wxp", "vmask")


def _both_tables(g, **kw):
    args = (g["edges"], g["log_mag"], g["log_ang"], g["w"], g["xp"],
            g["n_vertices"], g["B"], g["R"], g["epsilon"])
    return jax_build(*args, **kw), build_edge_table(*args, **kw)


def _rcm_graph(rng, B=2, R=6):
    """random_graph re-ordered by the JAX package's RCM (both builders
    then see a bandwidth-minimised graph)."""
    g = random_graph(rng, B=B, R=R)
    perm = jbanded.rcm_order(g["edges"], g["n_vertices"])
    g["edges"], g["w"] = jbanded.reorder_precompute(perm, g["edges"], g["w"])
    return g


def test_radial_interpolant_equal(rng):
    r = np.concatenate([[0.0, 1.0], rng.uniform(0, 1, 200)])
    from fieldconv_tpu.precomp.stencil import radial_interpolant as jri

    for R in (2, 3, 6):
        np.testing.assert_array_equal(radial_interpolant(r, R), jri(r, R))


@pytest.mark.parametrize("B,R,kw", [
    (2, 6, {}),
    (1, 3, {"n_multiple": 16, "d_multiple": 4}),
    (2, 6, {"n_pad": 48, "d_slots": 24}),
])
def test_build_edge_table_equal(rng, B, R, kw):
    g = random_graph(rng, B=B, R=R)
    jt, tt = _both_tables(g, **kw)
    for f in _FIELDS:
        want = np.asarray(getattr(jt, f))
        got = getattr(tt, f).numpy()
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=f)
    assert (tt.n_valid, tt.band_limit, tt.n_rings) == \
        (jt.n_valid, jt.band_limit, jt.n_rings)


def test_rcm_order_and_reorder_equal(rng):
    g = random_graph(rng)
    perm_t = tbanded.rcm_order(g["edges"], g["n_vertices"])
    perm_j = jbanded.rcm_order(g["edges"], g["n_vertices"])
    np.testing.assert_array_equal(perm_t, perm_j)
    got = tbanded.reorder_precompute(perm_t, g["edges"], g["w"])
    want = jbanded.reorder_precompute(perm_j, g["edges"], g["w"])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # RCM must actually shrink the bandwidth of a random graph
    assert jbanded.bandwidth(got[0]) < jbanded.bandwidth(g["edges"])


@pytest.mark.parametrize("tb", [8, 16])
def test_build_banded_tables_equal(rng, tb):
    g = _rcm_graph(rng)
    jt, tt = _both_tables(g, n_multiple=tb)
    jb = jbanded.build_banded_table(jt, tb=tb, max_nh=8)
    tbt = tbanded.build_banded_table(tt, tb=tb, max_nh=8)
    assert (tbt.tb, tbt.nh, tbt.n_pad, tbt.band_limit, tbt.n_rings) == \
        (jb.tb, jb.nh, jb.n_pad, jb.band_limit, jb.n_rings)
    np.testing.assert_array_equal(tbt.sten_band.numpy(),
                                  np.asarray(jb.sten_band))

    jc = jbanded.build_compressed_banded(jt, tb=tb, max_nh=8)
    tc = tbanded.build_compressed_banded(tt, tb=tb, max_nh=8)
    assert (tc.tb, tc.nh, tc.n_pad) == (jc.tb, jc.nh, jc.n_pad)
    np.testing.assert_array_equal(tc.sten_band.numpy(),
                                  np.asarray(jc.sten_band))


def test_band_builders_reject_like_jax(rng):
    """Too-wide bandwidth and a ragged n_pad are refused by both."""
    g = random_graph(rng)                   # not RCM-ordered: wide band
    jt, tt = _both_tables(g, n_multiple=8)
    with pytest.raises(ValueError, match="max_nh"):
        jbanded.build_banded_table(jt, tb=4, max_nh=1)
    with pytest.raises(ValueError, match="max_nh"):
        tbanded.build_banded_table(tt, tb=4, max_nh=1)
    with pytest.raises(ValueError, match="multiple"):
        tbanded.build_compressed_banded(tt, tb=7)


@pytest.mark.parametrize("nh", [1, 2])
def test_window_blocks_equal(rng, nh):
    a = rng.normal(size=(40, 3)).astype(np.float32)
    want = np.asarray(jbanded.window_blocks(a, 5, 8, nh))
    got = tbanded.window_blocks(torch.from_numpy(a), 8, nh).numpy()
    np.testing.assert_array_equal(got, want)
    # leading mesh axes window each mesh on its own
    two = torch.from_numpy(np.stack([a, 2 * a]))
    np.testing.assert_array_equal(
        tbanded.window_blocks(two, 8, nh)[1].numpy(), 2 * want)
