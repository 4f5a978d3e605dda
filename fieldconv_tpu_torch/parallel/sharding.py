"""Sharding a batch over the (n_data, n_graph) layout, and replicating
parameters.

Counterpart of ``fieldconv_tpu/parallel/sharding.py``: meshes of a batch
go by data rank (pure data parallelism), each mesh's vertex rows, and the
leading block axis of its banded stencils, by graph rank (the mesh analog
of sequence parallelism; the ring neighbours' boundary rows come through
the halo exchange, parallel/halo.py).
"""

from __future__ import annotations

import dataclasses

import torch

from .distributed import Layout, broadcast, process_local_batch_slice


def check_rows(n_pad: int, tb: int, n_graph: int) -> None:
    """Raise unless n_pad vertex rows split into n_graph shards of whole
    blocks of tb rows.  Pad the records to such an n_pad (``n_pad=`` of
    make_batches / shared_bucket); rows are never cut."""
    if n_pad % (n_graph * tb):
        raise ValueError(
            f"n_pad {n_pad} is not a multiple of n_graph·tb = {n_graph}·{tb}"
            f": pad the records to a multiple of {n_graph * tb} rows")


def shard_batch(gpb, layout: Layout):
    """This rank's shard of a whole-batch GPBatch (parallel/gp.py): its
    data row's meshes, and of each its graph rank's vertex rows and stencil
    blocks.  Mesh-level labels (B,) go by data rank only; per-vertex labels
    (B, N) by both.  Views of gpb's tensors, made contiguous."""
    n_pad = gpb.pos.shape[1]
    check_rows(n_pad, gpb.tb, layout.n_graph)
    meshes = process_local_batch_slice(gpb.pos.shape[0], layout)
    n_local = n_pad // layout.n_graph
    rows = slice(layout.graph_rank * n_local,
                 (layout.graph_rank + 1) * n_local)
    blocks = slice(rows.start // gpb.tb, rows.stop // gpb.tb)

    def take(t, *idx):
        return t[(meshes, *idx)].contiguous()

    labels = gpb.labels
    return dataclasses.replace(
        gpb, pos=take(gpb.pos, rows), vmask=take(gpb.vmask, rows),
        labels=take(labels, rows) if labels.ndim > 1 else take(labels),
        bsten=take(gpb.bsten, blocks), csten=take(gpb.csten, blocks))


@torch.no_grad()
def replicate(module: torch.nn.Module, layout: Layout) -> None:
    """Broadcast every parameter and buffer of ``module`` from rank 0 over
    the world, in place."""
    for t in (*module.parameters(), *module.buffers()):
        t.copy_(broadcast(t, 0, layout.world))
