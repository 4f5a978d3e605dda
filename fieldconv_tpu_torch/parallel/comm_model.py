"""Analytic communication model of the graph-parallel conv.

The halo scheme's part of ``fieldconv_tpu/parallel/comm_model.py``
(arithmetic only): the bytes it moves are exact functions of the shapes.
chip_smoke.py prints ``conv_halo_bytes`` beside the bytes the exchange of
parallel/halo.py moved.  The panel and compact schemes' models come with
the panel-sharded path (ROADMAP Queue 1 item 8).

Conventions: bytes are wire bytes per device per collective.  f32 = 4.
"""

from __future__ import annotations


def _k(band_limit: int) -> int:
    return 2 * band_limit + 1


def conv_halo_bytes(nh: int, tb: int, band_limit: int, channels: int,
                    f: int = 4) -> dict:
    """halo_field_conv (parallel/halo.py): two ppermutes (left + right
    boundary windows of g, nh·TB rows each) forward; their transposes move
    the same volume back."""
    m = _k(band_limit) * 2 * channels
    per_dir = nh * tb * m * f
    return {"fwd_ppermute": 2 * per_dir, "bwd_ppermute": 2 * per_dir}
