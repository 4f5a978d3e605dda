"""CUDA kernels of the port against their plain versions, on the card.

These tests need an NVIDIA card and skip without one.  They import no JAX
(the card's machine has none), so run them there without the JAX-loading
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from fieldconv_tpu_torch import kernels
from fieldconv_tpu_torch.ops import band_conv as tbc
from fieldconv_tpu_torch.precomp.banded import BandedTable

# odd widths with O2 = 10; O2 = 60 as conv_out with 3 meshes; serving
# widths with a window past both ends
SHAPES = pytest.mark.parametrize("C,O,R,B,tb,nh,n_mesh", [
    (3, 5, 2, 1, 8, 1, 1),
    (4, 30, 6, 2, 8, 2, 3),
    (32, 32, 6, 2, 16, 3, 2),
])


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 kernels have no CPU mode")


def _k1_inputs(C, O, R, B, tb, nh, n_mesh):
    """Random g, dense random stencil (every out-of-range slot is
    exercised), W and dy on the card."""
    K, N = 2 * B + 1, 4 * tb
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    g = torch.randn(n_mesh, N, K * 2 * C, device=dev, generator=gen)
    sten = torch.randn(n_mesh, N // tb, R + 2 * K, tb, (2 * nh + 1) * tb,
                       device=dev, generator=gen)
    wmat = torch.randn(R, K * 2 * C, 2 * O, device=dev, generator=gen)
    dy = torch.randn(n_mesh, N, 2 * O, device=dev, generator=gen)
    return g, sten, wmat, dy


@pytest.mark.cuda
@SHAPES
def test_k1_kernel_matches_plain_on_card(C, O, R, B, tb, nh, n_mesh):
    """The CUDA kernel equals its plain version on the card; tolerance 1e-4
    of the output's scale (f32 sums in another order)."""
    _need_card()
    g, sten, wmat, _ = _k1_inputs(C, O, R, B, tb, nh, n_mesh)
    before = kernels.launches["band_fused_fwd"]
    got = tbc.band_fused_fwd(g, sten, wmat, tb, nh)
    torch.cuda.synchronize()
    assert kernels.launches["band_fused_fwd"] == before + 1
    want = tbc.band_fused_fwd_reference(g, sten, wmat, tb, nh)
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), err


@pytest.mark.cuda
@SHAPES
def test_k1_bwd_kernel_matches_plain_on_card(C, O, R, B, tb, nh, n_mesh):
    """The backward kernel equals its plain version on the card (dg and dw
    each to 1e-4 of its scale: f32 sums in another order, dw over every
    target of every mesh), and two calls are bitwise equal (no atomics)."""
    _need_card()
    g, sten, wmat, dy = _k1_inputs(C, O, R, B, tb, nh, n_mesh)
    before = kernels.launches["band_fused_bwd"]
    dg, dw = tbc.band_fused_bwd(dy, g, sten, wmat, tb, nh)
    torch.cuda.synchronize()
    assert kernels.launches["band_fused_bwd"] == before + 1
    want_g, want_w = tbc.band_fused_bwd_reference(dy, g, sten, wmat, tb, nh)
    for got, want in ((dg, want_g), (dw, want_w)):
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), err
    dg2, dw2 = tbc.band_fused_bwd(dy, g, sten, wmat, tb, nh)
    assert torch.equal(dg, dg2) and torch.equal(dw, dw2)


@pytest.mark.cuda
def test_field_conv_banded_backward_card_matches_cpu():
    """One field_conv_banded backward through both K1 kernels on the card
    equals the same on the CPU (plain versions): grads of x and of the
    three filter tensors to 1e-4 of their scale."""
    _need_card()
    rng = np.random.default_rng(0)
    n_mesh, N, tb, nh, C, O, R, B = 2, 32, 8, 2, 4, 3, 6, 2
    K = 2 * B + 1
    sten = rng.normal(size=(n_mesh, N // tb, R + 2 * K, tb, (2 * nh + 1) * tb))
    sten[:, :, :R] *= rng.random(sten[:, :, :R].shape) < 0.2   # sparse rings
    x = rng.normal(size=(n_mesh, N, C, 2))
    filt = [rng.normal(size=s) for s in ((O, C, R), (O, C, R, B, 2),
                                         (O, C, B + 1))]
    dy = rng.normal(size=(n_mesh, N, O, 2))
    grads = {}
    for dev in ("cpu", "cuda"):
        t = [torch.tensor(a, dtype=torch.float32, device=dev,
                          requires_grad=True) for a in (x, *filt)]
        bt = BandedTable(torch.tensor(sten, dtype=torch.float32, device=dev),
                         tb=tb, nh=nh, n_pad=N, band_limit=B, n_rings=R)
        y = tbc.field_conv_banded(t[0], bt, *t[1:], 1)
        y.backward(torch.tensor(dy, dtype=torch.float32, device=dev))
        grads[dev] = [a.grad.cpu() for a in t]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        err = (a - b).abs().max().item()
        assert err <= 1e-4 * b.abs().max().item(), err
