"""CUDA kernels of the port against their plain versions, on the card.

These tests need an NVIDIA card and skip without one.  They import no JAX
(the card's machine has none), so run them there without the JAX-loading
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from fieldconv_tpu_torch import kernels
from fieldconv_tpu_torch.ops import band_conv as tbc


@pytest.mark.cuda
@pytest.mark.parametrize("C,O,R,B,tb,nh,n_mesh", [
    (3, 5, 2, 1, 8, 1, 1),        # odd widths, O2 = 10
    (4, 30, 6, 2, 8, 2, 3),       # O2 = 60 as conv_out, 3 meshes
    (32, 32, 6, 2, 16, 3, 2),     # serving widths, window past both ends
])
def test_k1_kernel_matches_plain_on_card(C, O, R, B, tb, nh, n_mesh):
    """The CUDA kernel equals its plain version on the card, on random
    inputs with a dense stencil (so every out-of-range slot is exercised);
    tolerance 1e-4 of the output's scale (f32 sums in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 kernel has no CPU mode")
    K, N = 2 * B + 1, 4 * tb
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    g = torch.randn(n_mesh, N, K * 2 * C, device=dev, generator=gen)
    sten = torch.randn(n_mesh, N // tb, R + 2 * K, tb, (2 * nh + 1) * tb,
                       device=dev, generator=gen)
    wmat = torch.randn(R, K * 2 * C, 2 * O, device=dev, generator=gen)
    before = kernels.launches["band_fused_fwd"]
    got = tbc.band_fused_fwd(g, sten, wmat, tb, nh)
    torch.cuda.synchronize()
    assert kernels.launches["band_fused_fwd"] == before + 1
    want = tbc.band_fused_fwd_reference(g, sten, wmat, tb, nh)
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), err
