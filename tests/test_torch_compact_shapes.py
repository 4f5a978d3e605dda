"""K6 (the compact conv) at the shapes its kernels take beyond the
correspondence preset's K = 3, R = 3, against the JAX package, on the CPU.

K6's kernels take K ≤ 5 with R ≤ 6: the MATCHING preset's K = 3 with R = 6
and the segmentation preset's K = 5 with R = 6 beside K = 3, R = 3, on f32
or bf16 stencils.  Here the plain versions run (CPU tensors: no kernel
launch); the JAX side runs its Pallas kernels in interpret mode.
Tolerances, each with its reason:

- the plain forward against the interpreted ``_band_compact_fwd_impl`` on
  the gathered rows: ``CONV_TOL`` of tests/test_torch_compact.py (f32 sums
  over slots, panels and rings in another order);
- the backward (the plain version and the plain fold) against ``jax.vjp``
  of ``_band_compact``: ``ECHO_TOL``, the bar of
  tests/test_torch_compact_train.py (f32 sums over a panel's slots, rings
  and targets, and over a row's columns, in another order);
- the wrappers' shape check: K = 3 or 5 with R ≤ 6 pass it, K = 7 or R = 7
  raise NotImplementedError before any kernel is reached.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_band_conv import _panel_setup
from test_torch_compact import CONV_TOL, _compact
from test_torch_echo import ECHO_TOL, _t
from fieldconv_tpu.ops.pallas import band_conv as jbc
from fieldconv_tpu.precomp import banded as jbanded
from fieldconv_tpu_torch import kernels
from fieldconv_tpu_torch.ops import band_conv as tbc
from fieldconv_tpu_torch.precomp import banded as tbanded

torch.set_num_threads(1)   # one per xdist worker: see test_torch_ops.py

TBT, TS = 4, 8
C, O2 = 4, 6
# (B, R): the MATCHING preset's K = 3 with R = 6, and the segmentation
# preset's K = 5 with R = 6
KERNEL_SHAPES = pytest.mark.parametrize("B,R", [(1, 6), (2, 6)])
STENCILS = pytest.mark.parametrize("bf16", [False, True],
                                   ids=["f32", "bf16"])


def _case(rng, B, R, bf16):
    """A small graph's JAX and port compact tables at (B, R), cast to bf16
    when asked, and random g, W, dy."""
    _, jt, _ = _panel_setup(rng, compressed=True, B=B, R=R)
    jc, tc = _compact(jt, TBT, TS)
    if bf16:
        jc, tc = jbanded.cast_panel_sten(jc), tbanded.cast_panel_sten(tc)
    M = (2 * B + 1) * 2 * C
    g = rng.normal(size=(jt.n_pad, M)).astype(np.float32)
    w = (rng.normal(size=(R, M, O2)) / np.sqrt(R * M)).astype(np.float32)
    dy = rng.normal(size=(jt.n_pad, O2)).astype(np.float32)
    return jc, tc, g, w, dy


@KERNEL_SHAPES
@STENCILS
def test_k6_plain_matches_pallas_at_kernel_shapes(rng, B, R, bf16):
    """band_compact_fwd on CPU tensors (its plain version) against the
    interpreted Pallas _band_compact_fwd_impl on the gathered rows."""
    jc, tc, g, w, _ = _case(rng, B, R, bf16)
    N = g.shape[0]
    gg = jnp.asarray(g)[jc.src_idx.reshape(-1)]
    want = jbc._band_compact_fwd_impl(gg, jnp.asarray(w), jc.sten, jc.meta,
                                      TBT, TS, R, B, True, "f32", N)
    before = dict(kernels.launches)
    got = tbc.band_compact_fwd(_t(g), _t(w), tc.sten, tc.meta, tc.src_idx,
                               TBT, R, B)
    assert kernels.launches == before            # CPU: the plain version
    assert np.abs(np.asarray(want)).max() > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CONV_TOL)


@KERNEL_SHAPES
@STENCILS
def test_k6_bwd_matches_jax_vjp_at_kernel_shapes(rng, B, R, bf16):
    """band_compact_bwd on CPU tensors (the plain version and the plain
    fold) against jax.vjp of the JAX custom VJP _band_compact, whose
    backward runs the interpreted _band_compact_bwd_impl and the
    segment_sum."""
    jc, tc, g, w, dy = _case(rng, B, R, bf16)
    N = g.shape[0]
    src = jc.src_idx.reshape(-1)
    _, vjp = jax.vjp(lambda g_, w_: jbc._band_compact(
        g_, w_, jc.sten, jc.meta, src, TBT, TS, R, B, True, "f32", N),
        jnp.asarray(g), jnp.asarray(w))
    want_g, want_w = vjp(jnp.asarray(dy))
    before = dict(kernels.launches)
    dg, dw = tbc.band_compact_bwd(_t(dy), _t(g), _t(w), tc.sten, tc.meta,
                                  tc.src_idx, tc.fold_order, tc.fold_ptr,
                                  TBT, R, B)
    assert kernels.launches == before            # CPU: the plain versions
    assert np.abs(np.asarray(want_g)).max() > 0.1
    np.testing.assert_allclose(dg.numpy(), np.asarray(want_g), **ECHO_TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_w), **ECHO_TOL)


@pytest.mark.parametrize("B,R,taken", [(1, 3, True), (1, 6, True),
                                       (2, 6, True), (3, 3, False),
                                       (1, 7, False)])
def test_k6_shape_check(rng, B, R, taken):
    """The check both K6 wrappers make before reaching a kernel, on CPU
    tensors (it compares devices, not the card): K ≤ 5 with R ≤ 6 passes;
    K = 7 or R = 7 raises NotImplementedError from the forward's and the
    backward's CUDA wrappers, before either reaches its kernel's entry."""
    _, jt, _ = _panel_setup(rng, compressed=True)
    tc = _compact(jt, TBT, TS)[1]
    N, M = jt.n_pad, (2 * B + 1) * 2 * C
    g, w = torch.zeros(N, M), torch.zeros(R, M, O2)
    dy = torch.zeros(N, O2)
    i32 = torch.int32
    more = (("dy", dy, torch.float32), ("src_idx", tc.src_idx, i32),
            ("fold_order", tc.fold_order, i32),
            ("fold_ptr", tc.fold_ptr, i32))
    if taken:
        tbc._k5_check("band_compact_bwd", g, w, tc.sten, tc.meta, TBT, R, B,
                      True, N, *more, ts=TS)
        return
    with pytest.raises(NotImplementedError, match="K ≤ 5 with R ≤ 6"):
        tbc._band_compact_fwd_cuda(g, w, tc.sten, tc.meta, tc.src_idx, TBT,
                                   R, B, N)
    with pytest.raises(NotImplementedError, match="K ≤ 5 with R ≤ 6"):
        tbc._band_compact_bwd_cuda(dy, g, w, tc.sten, tc.meta, tc.src_idx,
                                   tc.fold_order, tc.fold_ptr, TBT, R, B)
