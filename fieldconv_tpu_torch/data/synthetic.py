"""Synthetic mesh records, built with numpy from a seeded generator.

No meshes or precompute ship with the repo, so the card checks and the
tests serve records of the right size and block structure with random log
maps: ``synthetic_record`` in the manner of bench.py's
``build_synthetic_tables`` (unique sources within ±bandwidth of each
target, the locality RCM ordering gives real meshes), and
``sphere_record`` for the large pure-panel meshes (an ε-ball graph on a
Fibonacci sphere in ``kd_order``, the size of scripts/train_100k.py), and
``random_block_sparse`` for block-sparse tables with shuffled lists.
"""

from __future__ import annotations

import numpy as np
import torch

from ..precomp.banded import kd_order
from .base import MeshRecord


def synthetic_record(rng, n, deg_lo, deg_hi, bandwidth, eps, name, label):
    """One record: each target gets a degree in [deg_lo, deg_hi] and unique
    sources within ±bandwidth, radii in [0, ε], unit transports.  label:
    the mesh's class, or an (n,) array of per-vertex labels."""
    offs = np.arange(-bandwidth, bandwidth + 1)
    src = np.arange(n)[:, None] + offs[None, :]
    keys = rng.random(src.shape)
    keys[(src < 0) | (src >= n)] = np.inf            # never pick outside
    order = np.argsort(keys, axis=1)[:, :deg_hi]
    picked = np.take_along_axis(src, order, axis=1)
    deg = rng.integers(deg_lo, deg_hi + 1, n)
    keep = np.arange(deg_hi)[None, :] < deg[:, None]
    tgt = np.broadcast_to(np.arange(n)[:, None], picked.shape)
    edges = np.stack([picked[keep], tgt[keep]], -1).astype(np.int64)
    E = len(edges)
    ang = rng.uniform(-np.pi, np.pi, E)
    return MeshRecord(
        name=name,
        pos=(0.3 * rng.normal(size=(n, 3))).astype(np.float32),
        supp_edges=edges,
        log_mag=rng.uniform(0.0, eps, E).astype(np.float32),
        log_ang=rng.uniform(-np.pi, np.pi, E).astype(np.float32),
        xp=np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32),
        weights=rng.uniform(0.1, 1.0, n).astype(np.float32),
        labels=np.asarray(label, np.int64),
        epsilon=eps,
    )


def fibonacci_sphere(n):
    """n points of the golden-angle (Fibonacci) lattice on the sphere of
    area 1, in lattice order (float64)."""
    i = np.arange(n, dtype=np.float64)
    z = 1.0 - (2.0 * i + 1.0) / n
    rho = np.sqrt(1.0 - z * z)
    theta = np.pi * (3.0 - np.sqrt(5.0)) * i
    pts = np.stack([rho * np.cos(theta), rho * np.sin(theta), z], -1)
    return pts / np.sqrt(4.0 * np.pi)


def sphere_record(rng, n, n_classes, name="sphere", tb=128):
    """One mesh of n samples on the Fibonacci sphere of area 1, vertices in
    kd_order (block size tb), with the ε-ball support graph of
    scripts/train_100k.py: ε = sqrt(64/(πn)) (about 64 neighbours), every
    pair within ε in both directions plus the self edge (scipy's cKDTree).
    Log-map radii in [0, ε], angles and unit transports random as in
    synthetic_record; per-vertex labels random in [0, n_classes)."""
    from scipy.spatial import cKDTree

    pts = fibonacci_sphere(n)
    pts = pts[kd_order(pts, tb=tb)]
    eps = float(np.sqrt(64.0 / (np.pi * n)))
    pairs = cKDTree(pts).query_pairs(eps, output_type="ndarray")
    loop = np.arange(n)
    edges = np.stack([np.concatenate([pairs[:, 0], pairs[:, 1], loop]),
                      np.concatenate([pairs[:, 1], pairs[:, 0], loop])],
                     -1).astype(np.int64)
    E = len(edges)
    ang = rng.uniform(-np.pi, np.pi, E)
    return MeshRecord(
        name=name, pos=pts.astype(np.float32), supp_edges=edges,
        log_mag=rng.uniform(0.0, eps, E).astype(np.float32),
        log_ang=rng.uniform(-np.pi, np.pi, E).astype(np.float32),
        xp=np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32),
        weights=rng.uniform(0.1, 1.0, n).astype(np.float32),
        labels=rng.integers(0, n_classes, n), epsilon=eps)


def random_block_sparse(rng, n_mesh, nb, nj, n_rings, band_limit, tb,
                        fill=0.4):
    """A random BlockSparseTable (CPU tensors) of n_mesh meshes of nb
    blocks, for checking K8 on lists that no builder makes: each nbr row
    holds nj distinct blocks in random order, one of them the block itself,
    and about a third of the rows carry that entry as padding (all-zero
    planes, left out of the inverse index).  Planes are normal random
    values at a fraction ``fill`` of the slots, zero elsewhere."""
    from ..precomp.banded import BlockSparseTable, block_sparse_inverse

    P = n_rings + 2 * (2 * band_limit + 1)
    nbr = np.empty((n_mesh, nb, nj), np.int32)
    live = np.ones(nbr.shape, bool)
    for m in range(n_mesh):
        for b in range(nb):
            others = rng.choice(nb - 1, nj - 1, replace=False)
            row = rng.permutation(np.append(others + (others >= b), b))
            nbr[m, b] = row
            live[m, b] = (row != b) | (rng.random() >= 1 / 3)
    sten = rng.normal(size=(n_mesh, nb, P, tb, nj * tb)).astype(np.float32)
    sten *= rng.random((n_mesh, nb, 1, tb, nj * tb)) < fill
    sten.reshape(n_mesh, nb, P, tb, nj, tb)[
        ~np.broadcast_to(live[:, :, None, None, :, None],
                         (n_mesh, nb, P, tb, nj, tb))] = 0.0
    inv_ptr, inv_bj = block_sparse_inverse(nbr, live)
    return BlockSparseTable(
        sten_band=torch.from_numpy(sten), nbr=torch.from_numpy(nbr),
        inv_ptr=inv_ptr, inv_bj=inv_bj, tb=tb, n_pad=nb * tb,
        band_limit=band_limit, n_rings=n_rings)
