"""Spatial tiling of point sets.

A numpy copy of ``spatial_tiles`` from ``fieldconv_tpu/precomp/tiled.py``
(the rest of that module, the tiled vector-heat precompute, is not ported
yet: ROADMAP Queue 1 item 5).  It gives the same tiles, in the same order.
"""

from __future__ import annotations

import numpy as np


def spatial_tiles(points: np.ndarray, tile_size: int):
    """Recursive median split of point ids into tiles of <= tile_size,
    splitting the widest axis — a k-d tree leaf partition, vectorised."""
    ids = np.arange(len(points))
    out = []
    stack = [ids]
    while stack:
        cur = stack.pop()
        if len(cur) <= tile_size:
            out.append(cur)
            continue
        p = points[cur]
        axis = int(np.argmax(p.max(axis=0) - p.min(axis=0)))
        order = np.argsort(p[:, axis], kind="stable")
        half = len(cur) // 2
        stack.append(cur[order[:half]])
        stack.append(cur[order[half:]])
    return out
