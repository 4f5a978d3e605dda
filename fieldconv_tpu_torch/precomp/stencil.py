"""Offline stencil builder (numpy), emitting a padded-CSR EdgeTable.

Counterpart of ``fieldconv_tpu/precomp/stencil.py``, computing the same
arrays bit for bit:
  * radius normalised by ε, edges with r > 1 dropped
  * sqrt-spaced (equi-area) radial ring samples
  * angular frequencies e^{ikθ}, k = -B..B
  * per-target normalisation of integration weights
  * wxp = w_norm * xp, stencil = rsten ⊗ fsten ⊗ wxp (stored factored)
"""

from __future__ import annotations

import numpy as np
import torch

from .edge_table import EdgeTable, round_up


def radial_interpolant(r: np.ndarray, n_rings: int) -> np.ndarray:
    """Linear interpolation weights onto sqrt-spaced ring samples.

    For each radius (already normalised to [0, 1]) find the first ring
    sample >= r ("ceil" ring) and distribute weight linearly between it and
    the previous ring.

    r: (E,) float in [0, 1].  Returns (E, R) float32.
    """
    E = r.shape[0]
    samples = np.sqrt(np.arange(n_rings, dtype=np.float64) / (n_rings - 1))

    diff = samples[None, :] - r[:, None]
    diff[diff < 0] = 1e8
    c_index = np.argmin(diff, axis=1)
    c_index[c_index == 0] = 1
    f_index = c_index - 1

    weights = np.zeros((E, n_rings), dtype=np.float64)
    rng = np.arange(E)
    wc = (r - samples[f_index]) / (samples[c_index] - samples[f_index])
    weights[rng, c_index] = wc
    weights[rng, f_index] = 1.0 - wc
    return weights.astype(np.float32)


def build_edge_table(
    supp_edges: np.ndarray,
    log_mag: np.ndarray,
    log_ang: np.ndarray,
    weights: np.ndarray,
    xp: np.ndarray,
    n_vertices: int,
    band_limit: int,
    n_rings: int,
    epsilon: float,
    d_multiple: int = 8,
    n_multiple: int = 8,
    d_slots: int | None = None,
    n_pad: int | None = None,
) -> EdgeTable:
    """Build the padded-CSR table (CPU tensors) from ragged COO precompute
    outputs.

    Args:
      supp_edges: (E, 2) int — (source j, target i) per edge.
      log_mag, log_ang: (E,) float — polar log map coordinates log_j(i).
      weights: (N,) or (N, 1) float — per-sample integration weights.
      xp: (E,) complex or (E, 2) float — parallel transport e^{iφ_{j→i}}.
      n_vertices: number of sampled vertices N.
      band_limit, n_rings, epsilon: filter hyperparameters.
      d_multiple / n_multiple: pad the slot and vertex axes to these
        multiples (static-shape bucketing).
      d_slots / n_pad: force exact padded sizes (must cover the data), so
        meshes of one bucket share shapes.
    """
    supp_edges = np.asarray(supp_edges, dtype=np.int64)
    log_mag = np.asarray(log_mag, dtype=np.float64)
    log_ang = np.asarray(log_ang, dtype=np.float64)
    weights = np.asarray(weights, dtype=np.float64).reshape(-1)
    xp = np.asarray(xp)
    if xp.ndim == 2:
        xp = xp[:, 0] + 1j * xp[:, 1]
    xp = xp.astype(np.complex128)

    B, R = band_limit, n_rings

    r = log_mag / epsilon
    valid = r <= 1.0
    r, theta = r[valid], log_ang[valid]
    edges = supp_edges[valid]
    xp = xp[valid]
    src, tgt = edges[:, 0], edges[:, 1]
    E = edges.shape[0]

    w_src = weights[src]
    denom = np.zeros(n_vertices, dtype=np.float64)
    np.add.at(denom, tgt, w_src)
    w_norm = w_src / (1e-12 + denom[tgt])

    wxp = w_norm * xp                                      # (E,) complex
    rsten = radial_interpolant(r, R)                       # (E, R)
    freqs = np.arange(-B, B + 1, dtype=np.float64)
    fsten = np.exp(1j * freqs[None, :] * theta[:, None])   # (E, K)
    fwxp = fsten * wxp[:, None]                            # (E, K) complex
    ln = r * np.exp(1j * theta)                            # (E,) complex

    deg = np.zeros(n_vertices, dtype=np.int64)
    np.add.at(deg, tgt, 1)
    max_deg = int(deg.max()) if E else 1
    D = d_slots if d_slots is not None else round_up(max(max_deg, 1), d_multiple)
    N = n_pad if n_pad is not None else round_up(n_vertices, n_multiple)
    if D < max_deg:
        raise ValueError(f"d_slots={D} < max degree {max_deg}")
    if N < n_vertices:
        raise ValueError(f"n_pad={N} < n_vertices {n_vertices}")

    # slot of each edge = its rank among its target's edges, in stable
    # target order (the JAX builder's Python loop, vectorised)
    order = np.argsort(tgt, kind="stable")
    starts = np.concatenate([[0], np.cumsum(deg)[:-1]])
    slot = np.empty(E, dtype=np.int64)
    slot[order] = np.arange(E) - starts[tgt[order]]

    def pack(vals, shape, dtype=np.float32):
        out = np.zeros((N, D) + shape, dtype=dtype)
        out[tgt, slot] = vals
        return torch.from_numpy(out)

    def pack_c(vals_c, shape=()):
        planar = np.stack([vals_c.real, vals_c.imag], axis=-1)
        return pack(planar, shape + (2,))

    return EdgeTable(
        src=pack(src, (), np.int64),
        mask=pack(np.ones(E), ()),
        rsten=pack(rsten, (R,)),
        fwxp=pack_c(fwxp, (2 * B + 1,)),
        ln=pack_c(ln),
        wxp=pack_c(wxp),
        vmask=torch.from_numpy(np.concatenate(
            [np.ones(n_vertices, np.float32),
             np.zeros(N - n_vertices, np.float32)])),
        n_valid=int(n_vertices),
        band_limit=B,
        n_rings=R,
    )
