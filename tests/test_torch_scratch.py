"""The port's scratch-size cache (ops/band_conv.py::_scratch_floats), which
the wrappers of K1, K4 and K9 ask before each launch: one question to the
kernel's library a shape and device, and a shape the library refuses
raises and is not cached.  A stand-in library here: the real ones are
built with nvcc on the card's machine."""

import types

import pytest
import torch

from fieldconv_tpu_torch import kernels
from fieldconv_tpu_torch.ops import band_conv as tbc

torch.set_num_threads(1)


@pytest.fixture
def fake_library(monkeypatch):
    """kernels.library returning a stand-in whose
    ``halo_fused_fwd_scratch_floats`` sums its sizes (0 when the first is
    0) and records each call."""
    calls = []

    def size(*sizes):
        calls.append(sizes)
        return 0 if sizes[0] == 0 else sum(sizes)

    lib = types.SimpleNamespace(halo_fused_fwd_scratch_floats=size)
    monkeypatch.setattr(kernels, "library", lambda name: lib)
    tbc._scratch_floats.cache_clear()
    yield calls
    tbc._scratch_floats.cache_clear()


def test_scratch_floats_asks_once_a_shape_and_device(fake_library):
    sizes = (2, 2048, 2304, 48, 5, 6, 128, 1, 96, -1, 1, 15)
    for _ in range(3):
        assert tbc._scratch_floats("halo_fused_fwd", 0, *sizes) == sum(sizes)
    assert fake_library == [sizes]
    tbc._scratch_floats("halo_fused_fwd", 1, *sizes)
    other = sizes[:-1] + (14,)
    tbc._scratch_floats("halo_fused_fwd", 0, *other)
    assert fake_library == [sizes, sizes, other]


def test_scratch_floats_raises_for_a_refused_shape(fake_library):
    refused = (0, 2048, 2304, 48, 5, 6, 128, 1, 96, -1, 1, 15)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="takes no shape"):
            tbc._scratch_floats("halo_fused_fwd", 0, *refused)
    assert fake_library == [refused, refused]
