"""Carry flax params across to the port's modules.

The port's parameter names and shapes equal the flax modules', so a flax
params tree maps onto a ``state_dict`` by joining each leaf's path with
dots, the leading ``params`` collection stripped (as
``fieldconv_tpu/utils/port_weights.py::flax_to_torch_state_dict`` does).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch


def params_from_jax(params) -> Dict[str, torch.Tensor]:
    """Flax params (nested mappings of numpy arrays, with or without the
    top-level ``params`` key) -> a state_dict for
    ``load_state_dict(strict=True)``."""
    if isinstance(params, Mapping) and set(params) == {"params"}:
        params = params["params"]
    out = {}

    def walk(node, prefix):
        for key, val in node.items():
            path = f"{prefix}.{key}" if prefix else str(key)
            if isinstance(val, Mapping):
                walk(val, path)
            else:
                out[path] = torch.from_numpy(
                    np.array(val, dtype=np.float32, copy=True))

    walk(params, "")
    return out
