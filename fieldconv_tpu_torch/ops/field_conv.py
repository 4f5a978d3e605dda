"""Field convolution over the padded-CSR gather layout.

Counterpart of ``fieldconv_tpu/ops/field_conv.py``.  For target i, channel
c, ring r, frequency k:

    contrib[i, c, r, k] = Σ_{e: j→i}  x[j,c] · e^{-i k φ_j,c} · sten[e, r, k]

with φ = softAngle(x) and sten[e,r,k] = rsten[e,r]·fwxp[e,k], followed by a
filter contraction over (c, r, k).  Every function accepts optional leading
mesh-batch axes on x and on the table's data fields.
"""

from __future__ import annotations

import warnings

import torch

from ..precomp.edge_table import EdgeTable
from ..utils.complexops import cconj, cexpi, cmul, is_origin


def resolve_d_chunk(D: int, d_chunk: int) -> int:
    """Largest divisor of D that is <= d_chunk; warns when that collapses
    the chunk (a near-prime slot bucket)."""
    if d_chunk >= D:
        return D
    if D % d_chunk == 0:
        return d_chunk
    best = next(c for c in range(d_chunk, 0, -1) if D % c == 0)
    if best < max(d_chunk // 4, 2):
        warnings.warn(
            f"d_chunk={d_chunk} fell back to {best} (largest divisor of the "
            f"{D}-slot bucket) — the loop now runs {D // best} steps; pad "
            f"the slot bucket to a multiple of a power of two",
            stacklevel=3,
        )
    return best


def cmatmul(a, b):
    """Complex matmul on planar pairs: (..., M, L, 2) x (L, P, 2) -> (..., M, P, 2)."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    re = torch.matmul(ar, br) - torch.matmul(ai, bi)
    im = torch.matmul(ar, bi) + torch.matmul(ai, br)
    return torch.stack([re, im], dim=-1)


def rotated_source_tensor(x, band_limit):
    """G[n, c, k] = x[n,c] · e^{-i k φ_{n,c}}, k = -B..B.

    Transcendental-free: e^{-iφ} = conj(x)/|x| (set to 1 at origin entries,
    where softAngle is 0), powers by repeated complex multiplication.

    x: (..., N, C, 2) planar.  Returns (..., N, C, K, 2).
    """
    mask = is_origin(x)[..., None]
    safe = torch.where(mask, torch.ones_like(x), x)
    mag = torch.sqrt(safe[..., 0] ** 2 + safe[..., 1] ** 2)[..., None]
    unit = torch.cat([torch.ones_like(mag), torch.zeros_like(mag)], dim=-1)
    u = torch.where(mask, unit, cconj(safe) / mag)         # e^{-iφ}
    uc = cconj(u)
    pos, neg = [x], [x]
    for _ in range(band_limit):
        pos.append(cmul(pos[-1], u))                       # x·e^{-ikφ}, k>0
        neg.append(cmul(neg[-1], uc))                      # k<0
    terms = neg[1:][::-1] + [x] + pos[1:]                  # k = -B..B
    return torch.stack(terms, dim=-2)                      # (..., N, C, K, 2)


def gather_rows(a, idx):
    """Per-mesh row gather: a (..., N, *F), idx (..., N, D) int ->
    (..., N, D, *F) with out[..., n, d] = a[..., idx[..., n, d]]."""
    lead = idx.shape[:-2]
    N, D = idx.shape[-2:]
    feat = a.shape[len(lead) + 1:]
    af = a.reshape(-1, a.shape[len(lead)], *feat)
    flat = idx.reshape(af.shape[0], N * D)
    bidx = torch.arange(af.shape[0], device=a.device)[:, None]
    return af[bidx, flat].reshape(*lead, N, D, *feat)


def field_conv_contrib(x, table: EdgeTable, d_chunk: int = 128):
    """Aggregate neighbour contributions.

    x: (..., N, C, 2).  Returns contrib (..., N, R, C, K, 2).
    Padded slots contribute nothing: rsten and fwxp are zero there.
    """
    B = table.band_limit
    D = table.d_slots
    G = rotated_source_tensor(x, B)                        # (..., N, C, K, 2)

    def chunk_contrib(src_c, fwxp_c, rsten_c):
        Gs = gather_rows(G, src_c)                         # (..., N, DB, C, K, 2)
        H = cmul(Gs, fwxp_c[..., None, :, :])              # (..., N, DB, C, K, 2)
        return torch.einsum("...ndr,...ndckp->...nrckp", rsten_c, H)

    d_chunk = resolve_d_chunk(D, d_chunk)
    acc = None
    for lo in range(0, D, d_chunk):
        sl = slice(lo, lo + d_chunk)
        part = chunk_contrib(table.src[..., sl], table.fwxp[..., sl, :, :],
                             table.rsten[..., sl, :])
        acc = part if acc is None else acc + part
    return acc


def filter_coefficients(zonal, spherical, phase, ftype, band_limit):
    """Assemble the (O, C, R, K, 2) planar filter bank.

      ftype 0: real zonal (O,I,R), spherical (O,I,R,B,2); K-axis =
               [flip(conj(spherical)), zonal, spherical]
      ftype 1: ftype 0 with per-(o,i,|k|) phase offsets e^{i·phase} folded
               into the coefficients
      ftype 2: complex zonal (O,I,R,2), spherical (O,I,R,2B,2); K-axis =
               [spherical[..B], zonal, spherical[B..]]
    """
    B = band_limit
    if ftype in (0, 1):
        conj = torch.tensor([1.0, -1.0], dtype=spherical.dtype,
                            device=spherical.device)
        neg = torch.flip(spherical, dims=(3,)) * conj
        zon = torch.stack([zonal, torch.zeros_like(zonal)], dim=-1)[..., None, :]
        coeff = torch.cat([neg, zon, spherical], dim=3)          # (O,I,R,K,2)
        if ftype == 1:
            phases = torch.cat([torch.flip(phase[..., 1:], dims=(-1,)), phase],
                               dim=-1)
            coeff = cmul(coeff, cexpi(phases)[:, :, None, :, :])
        return coeff
    if ftype == 2:
        return torch.cat(
            [spherical[..., :B, :], zonal[..., None, :], spherical[..., B:, :]],
            dim=3)
    raise ValueError(f"unknown ftype {ftype}")


def apply_filters(contrib, coeff):
    """y[n, o] = (1/K) Σ_{c,r,k} contrib[n,r,c,k] · coeff[o,c,r,k].

    contrib: (..., N, R, C, K, 2); coeff: (O, C, R, K, 2).
    Returns (..., N, O, 2).
    """
    N, R, C, K = contrib.shape[-5:-1]
    O = coeff.shape[0]
    lhs = contrib.reshape(*contrib.shape[:-5], N, R * C * K, 2)
    rhs = coeff.permute(2, 1, 3, 0, 4).reshape(R * C * K, O, 2)
    return cmatmul(lhs, rhs) / K


def field_conv(x, table: EdgeTable, zonal, spherical, phase, ftype,
               d_chunk=128):
    """Full field convolution: (..., N, C, 2) -> (..., N, O, 2)."""
    contrib = field_conv_contrib(x, table, d_chunk=d_chunk)
    coeff = filter_coefficients(zonal, spherical, phase, ftype,
                                table.band_limit)
    return apply_filters(contrib, coeff)
