"""Device selection for the port's entry points.

Entry points default to the card.  Asking for CUDA on a machine without one
is an error, never a silent move to the CPU: the CPU runs only when the
caller says ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises if it names CUDA and no card
    is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
