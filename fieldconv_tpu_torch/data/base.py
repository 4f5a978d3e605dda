"""Per-mesh precompute artifacts and bucketing.

Counterpart of the record layer of ``fieldconv_tpu/data/base.py``: the
ragged per-mesh precompute (support edges, log map, transport, weights) is
independent of the filter hyperparameters and is cached as one ``.npz`` in
the JAX package's format, so records precomputed there serve here
unchanged.  Padded EdgeTables for a given (B, R, bucket) are built at load
time (numpy).  The mesh-processing pipeline itself is not ported yet
(ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

from ..precomp.edge_table import EdgeTable, round_up
from ..precomp.stencil import build_edge_table


@dataclasses.dataclass
class MeshRecord:
    """Ragged per-mesh artifact (host-side, filter-hyperparameter free)."""

    name: str
    pos: np.ndarray          # (S, 3) sampled positions (normalised, reordered)
    supp_edges: np.ndarray   # (E, 2) (src, tgt) in sampled indices
    log_mag: np.ndarray      # (E,)
    log_ang: np.ndarray      # (E,)
    xp: np.ndarray           # (E, 2) planar transport
    weights: np.ndarray      # (S,)
    labels: np.ndarray       # () mesh label or (S,) per-vertex labels
    epsilon: float
    rcm_perm: np.ndarray = None      # (S,) original sample index per position
    center_mean: np.ndarray = None   # (3,) mean of the full normalised mesh
    sample_idx: np.ndarray = None    # (S,) full-mesh vertex id of each sample

    @property
    def n_samples(self) -> int:
        return len(self.pos)

    def max_degree(self) -> int:
        if len(self.supp_edges) == 0:
            return 1
        return int(np.bincount(self.supp_edges[:, 1]).max())

    def table(self, band_limit: int, n_rings: int,
              n_pad: Optional[int] = None, d_slots: Optional[int] = None,
              n_multiple: int = 128, d_multiple: int = 8) -> EdgeTable:
        return build_edge_table(
            self.supp_edges, self.log_mag, self.log_ang, self.weights,
            self.xp, self.n_samples, band_limit, n_rings, self.epsilon,
            n_pad=n_pad, d_slots=d_slots,
            n_multiple=n_multiple, d_multiple=d_multiple,
        )

    def padded_pos(self, n_pad: int, center: bool = False) -> np.ndarray:
        """Zero-padded sampled positions; center=True subtracts the
        full-mesh mean first.  Padded rows stay zero."""
        out = np.zeros((n_pad, 3), np.float32)
        pos = self.pos
        if center:
            mean = (self.center_mean if self.center_mean is not None
                    else pos.mean(axis=0))
            pos = pos - np.asarray(mean, pos.dtype)
        out[: self.n_samples] = pos
        return out

    def padded_labels(self, n_pad: int) -> np.ndarray:
        lab = np.asarray(self.labels)
        if lab.ndim == 0:
            return lab.astype(np.int32)
        out = np.full(n_pad, -1, np.int32)
        out[: self.n_samples] = lab
        return out


_OPTIONAL = ("rcm_perm", "center_mean", "sample_idx")


class ArtifactStore:
    """npz-per-mesh cache under <root>/processed."""

    def __init__(self, root: str):
        self.dir = os.path.join(root, "processed")
        os.makedirs(self.dir, exist_ok=True)

    def path(self, key: str) -> str:
        return os.path.join(self.dir, key + ".npz")

    def has(self, key: str) -> bool:
        return os.path.exists(self.path(key))

    def save(self, key: str, rec: MeshRecord) -> None:
        """Optional fields that the record lacks are left out of the file
        (``load`` reads them back as None) rather than invented."""
        extra = {f: getattr(rec, f) for f in _OPTIONAL
                 if getattr(rec, f) is not None}
        np.savez_compressed(
            self.path(key),
            name=rec.name, pos=rec.pos, supp_edges=rec.supp_edges,
            log_mag=rec.log_mag, log_ang=rec.log_ang, xp=rec.xp,
            weights=rec.weights, labels=rec.labels, epsilon=rec.epsilon,
            **extra,
        )

    def load(self, key: str) -> MeshRecord:
        with np.load(self.path(key), allow_pickle=False) as z:
            return MeshRecord(
                name=str(z["name"]), pos=z["pos"], supp_edges=z["supp_edges"],
                log_mag=z["log_mag"], log_ang=z["log_ang"], xp=z["xp"],
                weights=z["weights"], labels=z["labels"],
                epsilon=float(z["epsilon"]),
                **{f: (z[f] if f in z else None) for f in _OPTIONAL},
            )


def shared_bucket(records: List[MeshRecord], n_multiple=128, d_multiple=8):
    """(n_pad, d_slots) covering every record — one shape bucket."""
    n_pad = round_up(max(r.n_samples for r in records), n_multiple)
    d_slots = round_up(max(r.max_degree() for r in records), d_multiple)
    return n_pad, d_slots
