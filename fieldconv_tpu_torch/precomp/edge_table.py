"""Device-ready padded-CSR edge tables.

Counterpart of ``fieldconv_tpu/precomp/edge_table.py``.  Each target vertex
owns a fixed number of neighbour slots D; the per-edge stencil is stored
factored (``rsten[e, r] * fwxp[e, k]``) and never materialised.  Padded
slots have rsten == 0 and fwxp == 0, so the convolution needs no edge mask.

A table built for one mesh has data fields of shape (N, D, ...); a stacked
batch (train/trainer.py::stack_batch) carries a leading mesh axis.
"""

from __future__ import annotations

import dataclasses

import torch

_DATA_FIELDS = ("src", "mask", "rsten", "fwxp", "ln", "wxp", "vmask")


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class EdgeTable:
    """Padded-CSR support graph + factored convolution stencil.

    Attributes:
      src:   (N, D) int64  — source vertex index per neighbour slot (0 if pad)
      mask:  (N, D) f32    — 1.0 for a real edge, 0.0 for padding
      rsten: (N, D, R) f32 — radial linear-interpolation weights (0 at pads)
      fwxp:  (N, D, K, 2) f32 — e^{i k θ} ⊙ (w_norm · xp); K = 2B+1, k=-B..B
      ln:    (N, D, 2) f32 — log_j(i)/ε as planar complex
      wxp:   (N, D, 2) f32 — w_norm · xp; 0 at pads
      vmask: (N,) f32      — 1.0 for real vertices, 0.0 for padded rows
      n_valid: number of real (sampled) vertices
      band_limit, n_rings: stencil hyperparameters (K = 2*band_limit+1)
    """

    src: torch.Tensor
    mask: torch.Tensor
    rsten: torch.Tensor
    fwxp: torch.Tensor
    ln: torch.Tensor
    wxp: torch.Tensor
    vmask: torch.Tensor
    n_valid: int
    band_limit: int
    n_rings: int

    @property
    def n_pad(self) -> int:
        return self.src.shape[-2]

    @property
    def d_slots(self) -> int:
        return self.src.shape[-1]

    @property
    def k_width(self) -> int:
        return 2 * self.band_limit + 1

    def to(self, device) -> "EdgeTable":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in _DATA_FIELDS})
