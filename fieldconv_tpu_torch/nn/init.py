"""Torch-fan parameter initialisers.

Counterpart of ``fieldconv_tpu/nn/init.py``: xavier-uniform with torch's fan
computation for rank>2 tensors (fan_in = d1·prod(rest), fan_out =
d0·prod(rest)) and torch's default ``nn.Linear`` scheme.  Every initialiser
draws from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch


def _torch_fans(shape):
    if len(shape) < 2:
        raise ValueError("xavier init needs >= 2 dims")
    receptive = 1
    for s in shape[2:]:
        receptive *= s
    return shape[1] * receptive, shape[0] * receptive


def _uniform(shape, bound, generator):
    out = torch.empty(shape, dtype=torch.float32)
    return out.uniform_(-bound, bound, generator=generator)


def xavier_uniform(shape, generator, gain: float = 1.0):
    fan_in, fan_out = _torch_fans(shape)
    return _uniform(shape, gain * math.sqrt(6.0 / (fan_in + fan_out)),
                    generator)


def torch_linear_weight(shape, generator):
    """torch.nn.Linear default: U(±1/sqrt(fan_in)); shape (out, in)."""
    return _uniform(shape, 1.0 / math.sqrt(shape[1]), generator)


def torch_linear_bias(shape, fan_in: int, generator):
    return _uniform(shape, 1.0 / math.sqrt(fan_in), generator)
