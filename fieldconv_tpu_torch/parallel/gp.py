"""Graph-parallel training: the full model over this rank's shard, with
the halo kernels.

Counterpart of ``fieldconv_tpu/parallel/gp.py`` (without the matching
twin step, ROADMAP Queue 1 item 3).  Layout: ``n_data × n_graph`` ranks
(parallel/distributed.py).  A batch's meshes go by data rank; each mesh's
vertex rows, and the block axis of its banded stencils, by graph rank.
Models built with ``graph=layout.graph`` (train/loop.py::build_model) run
every FieldConv through K9 with the halo exchange, the lift and the banded
ECHO over halo rows, and the classification pool as an all-reduce.

The loss each rank forms is its share of the global loss, so that the
parameters' gradients summed over the world are the gradients of the
single-process loss:
  * per-vertex losses (segmentation, correspondence): the rank's sum over
    its valid rows divided by the valid rows of the whole world (JAX's
    psum(sum) / psum(count));
  * classification: the pooled logits are the same on every graph rank of
    a data row, so the cross entropy counts on graph rank 0 only (JAX's
    mask-to-shard-0; the pool's all-reduce sums the cotangents back to
    every rank's rows) and is divided by n_data (JAX's pmean over data).
The step all-reduces the gradients (one sum over the world, in one
buffer with the loss) and every rank applies the same Adam update, so the
parameters stay equal on every rank, bit for bit.

Augmentation is drawn per data rank from a generator seeded by (seed,
data rank), so every graph rank of a row rotates its meshes alike.
Correspondence dropout keeps the single-process convention: one keep mask
over the data row's global rows, drawn from that generator after the
augmentation, the same on every graph rank, of which each rank takes its
own rows.  With one data rank and the same generator the graph-parallel
loss is the single-process one (train/trainer.py::make_loss_fn); the JAX
step instead decorrelates its dropout draws per graph shard.
"""

from __future__ import annotations

import dataclasses

import torch

from ..nn.losses import cross_entropy, label_smoothing_loss
from ..precomp.banded import BandedTable, CompressedBandedTable
from ..train.config import ExperimentConfig
from ..train.trainer import (Adam, MeshBatch, _guarded_update,
                             draw_rotate_scale, keep_mask, rotate_scale)
from .distributed import Layout, all_reduce_sum, generator_for
from .sharding import shard_batch


@dataclasses.dataclass
class VertexMeta:
    """What the models read of an EdgeTable when every op runs banded: the
    rank's vmask rows and the GLOBAL valid-vertex count (the classification
    pool divides its all-reduced sum by it)."""

    vmask: torch.Tensor
    n_valid: int
    band_limit: int
    n_rings: int


@dataclasses.dataclass
class GPBatch:
    """A MeshBatch flattened to the arrays graph-parallel training shards:
    pos (B, N, 3), vmask (B, N), labels (B,) or (B, N), bsten (B, nb,
    R+2K, TB, W') (the dense band, every conv) and csten (B, nb, 5, TB,
    W') (the compressed band, the lift and ECHO), with the tables' shape
    numbers.  A whole batch, or one rank's shard of it (place_gp_batch)."""

    pos: torch.Tensor
    vmask: torch.Tensor
    labels: torch.Tensor
    bsten: torch.Tensor
    csten: torch.Tensor
    tb: int
    nh: int
    n_valid: int
    band_limit: int
    n_rings: int

    def to(self, device) -> "GPBatch":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device)
                     for f in ("pos", "vmask", "labels", "bsten", "csten")})

    def tables(self):
        """(VertexMeta, BandedTable, CompressedBandedTable) of these rows."""
        n = self.pos.shape[-2]
        shape = dict(tb=self.tb, nh=self.nh, n_pad=n,
                     band_limit=self.band_limit, n_rings=self.n_rings)
        return (VertexMeta(self.vmask, self.n_valid, self.band_limit,
                           self.n_rings),
                BandedTable(sten_band=self.bsten, **shape),
                CompressedBandedTable(sten_band=self.csten, **shape))


def gp_batch(batch: MeshBatch) -> GPBatch:
    """Flatten a stacked MeshBatch that carries both band tables
    (stack_batch(..., banded_tb=TB, echo_banded=True), or make_batches with
    echo_impl "banded")."""
    if batch.banded is None or batch.comp is None:
        raise ValueError(
            "graph-parallel training needs banded + comp tables: build the "
            "batch with stack_batch(..., banded_tb=TB, echo_banded=True)")
    if not isinstance(batch.banded, BandedTable):
        raise NotImplementedError(
            f"graph-parallel training shards a dense BandedTable, got "
            f"{type(batch.banded).__name__} (the panel-sharded path is "
            "ROADMAP Queue 1 item 8)")
    if batch.banded.nh != batch.comp.nh:
        raise ValueError(
            f"banded nh {batch.banded.nh} != comp nh {batch.comp.nh}")
    t = batch.table
    return GPBatch(
        pos=batch.pos, vmask=t.vmask, labels=batch.labels,
        bsten=batch.banded.sten_band, csten=batch.comp.sten_band,
        tb=batch.banded.tb, nh=batch.banded.nh, n_valid=t.n_valid,
        band_limit=t.band_limit, n_rings=t.n_rings)


def place_gp_batch(gpb: GPBatch, layout: Layout, device) -> GPBatch:
    """This rank's shard of the whole batch gpb (parallel/sharding.py::
    shard_batch) on ``device``."""
    return shard_batch(gpb, layout).to(device)


def make_gp_loss_fn(net, config: ExperimentConfig, n_classes: int,
                    layout: Layout):
    """loss(gpb, seed=0, aug=None, dropout_mask=None) -> this rank's share
    of the global loss over its shard ``gpb`` (place_gp_batch); the shares
    sum to the loss over the world (module docstring).  ``net`` is built
    with ``graph=layout.graph``.

    aug: the augmentation of the WHOLE batch (angles (B, 3), scales (B, 1,
    1) or None, as train/trainer.py::draw_rotate_scale draws them), of
    which the rank takes its data row's meshes; None draws the row's from
    generator_for(seed, data rank).  dropout_mask (correspondence): the
    keep mask of the whole batch (B, N, width), of which the rank takes its
    meshes and rows; None draws the data row's mask over its global rows
    from the same generator, after the augmentation."""
    task = config.task
    if task not in ("classification", "segmentation", "correspondence"):
        raise NotImplementedError(
            f"the graph-parallel {task!r} loss is not ported: the twin step "
            "waits for matching (ROADMAP Queue 1 item 3)")

    def loss_fn(gpb: GPBatch, seed: int = 0, aug=None, dropout_mask=None):
        n_mesh, n_local = gpb.pos.shape[:2]
        meshes = slice(layout.data_rank * n_mesh,
                       (layout.data_rank + 1) * n_mesh)
        gen = generator_for(seed, layout.data_rank)
        if aug is None:
            aug = draw_rotate_scale(gen, n_mesh, config.random_rotate_deg,
                                    config.random_scale)
        else:
            aug = tuple(None if a is None else a[meshes] for a in aug)
        pos = rotate_scale(gpb.pos, *aug)
        meta, banded, comp = gpb.tables()
        if task == "classification":
            logits = net(pos, meta, banded, comp)[:, 0, :]
            ce = cross_entropy(logits, gpb.labels)   # the same on the row
            mine = torch.tensor(layout.graph_rank == 0, device=ce.device)
            return torch.where(mine, ce, torch.zeros_like(ce)) \
                / layout.n_data
        labels = gpb.labels.reshape(-1)
        count = all_reduce_sum((labels >= 0).sum().to(torch.float32),
                               layout.world).clamp(min=1)
        if task == "segmentation":
            logits = net(pos, meta, banded, comp)
            return label_smoothing_loss(logits.reshape(-1, n_classes),
                                        labels, n_classes, config.smoothing,
                                        count=count)
        rows = slice(layout.graph_rank * n_local,
                     (layout.graph_rank + 1) * n_local)
        if dropout_mask is None:
            width = net.lin1.weight.shape[0]
            mask = keep_mask(gen, (n_mesh, n_local * layout.n_graph, width),
                             net.p)[:, rows]
        else:
            mask = dropout_mask[meshes, rows]
        logits = net(pos, meta, banded, comp,
                     dropout_mask=mask.to(pos.device))
        return cross_entropy(logits.reshape(-1, n_classes), labels,
                             count=count)

    return loss_fn


def make_gp_value_and_grad(net, config: ExperimentConfig, n_classes: int,
                           layout: Layout):
    """vag(gpb, seed=0, aug=None, dropout_mask=None) -> (the global loss,
    the gradients of net.parameters(), both summed over the world in one
    all-reduce): the same on every rank.  Arguments as make_gp_loss_fn's
    loss."""
    loss_fn = make_gp_loss_fn(net, config, n_classes, layout)
    params = list(net.parameters())

    def value_and_grad(gpb: GPBatch, seed: int = 0, aug=None,
                       dropout_mask=None):
        share = loss_fn(gpb, seed, aug, dropout_mask)
        grads = torch.autograd.grad(share, params, materialize_grads=True)
        flat = all_reduce_sum(torch.cat([share.detach().reshape(1)]
                                        + [g.reshape(-1) for g in grads]),
                              layout.world)
        out, at = [], 1
        for p in params:
            out.append(flat[at:at + p.numel()].view_as(p))
            at += p.numel()
        return flat[0], out

    return value_and_grad


def make_gp_train_step(net, config: ExperimentConfig, n_classes: int,
                       opt: Adam, layout: Layout):
    """step(gpb, seed=0, aug=None, dropout_mask=None) -> the global loss:
    the world's gradients (make_gp_value_and_grad), then the guarded Adam
    update of ``opt`` (whose parameters are net's), the same on every
    rank."""
    vag = make_gp_value_and_grad(net, config, n_classes, layout)

    def step(gpb: GPBatch, seed: int = 0, aug=None, dropout_mask=None):
        loss, grads = vag(gpb, seed, aug, dropout_mask)
        _guarded_update(opt, loss, grads)
        return loss

    return step
