"""Mesh batches, the batched forward, and the training step.

Counterpart of ``fieldconv_tpu/train/trainer.py``.  Meshes sharing a shape
bucket are stacked into a MeshBatch with a leading mesh axis; the model
runs once over the whole batch (the JAX package's vmap, written out as
that axis), so one K1 launch (K5 on the pure-panel layout) serves every
mesh of a batch, forward and backward.

The step follows the JAX one: random rotation and scale of the positions,
the task's loss (classification, segmentation or correspondence; the
matching step is ROADMAP Queue 1 item 3), gradients, then an Adam update
with optax's semantics (:class:`Adam`) that is skipped on the device when
the loss is not finite.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..precomp.banded import (
    R_SENTINEL,
    BandedTable,
    CompactPanelTable,
    CompressedBandedTable,
    PanelTable,
    build_banded_table,
    build_compact_panel_table,
    build_compressed_banded,
    build_panel_table,
    concat_compact_panel_tables,
    concat_panel_tables,
)
from ..nn.losses import cross_entropy, label_smoothing_loss
from ..precomp.edge_table import EdgeTable
from .config import ExperimentConfig


@dataclasses.dataclass
class MeshBatch:
    """A stack of same-bucket mesh artifacts.

    pos: (B, N, 3) float32 — sampled vertex positions (zero at padded rows)
    table: EdgeTable whose data fields carry a leading batch axis
    labels: (B,) int32 for mesh-level tasks or (B, N) int32 (-1 = padding)
    banded: optional batched BandedTable for the K1 conv path
    comp: optional batched CompressedBandedTable for the gather-free lift
    panel: optional compressed PanelTable of every mesh of the batch (one
      table, precomp.banded.concat_panel_tables): ECHO and the lift of the
      mixed route (with ``banded``), or every op of the pure-panel layout
      (``banded`` None); on the all-compact pure-panel layout the same
      object as ``compact``
    compact: optional CompactPanelTable of every mesh of the batch (one
      table, precomp.banded.concat_compact_panel_tables): ECHO and the lift
      of the compact route
    """

    pos: torch.Tensor
    table: EdgeTable
    labels: torch.Tensor
    banded: Optional[BandedTable] = None
    comp: Optional[CompressedBandedTable] = None
    panel: Optional[Union[PanelTable, CompactPanelTable]] = None
    compact: Optional[CompactPanelTable] = None

    def to(self, device) -> "MeshBatch":
        def move(t):
            return None if t is None else t.to(device)

        compact = move(self.compact)
        return MeshBatch(
            pos=self.pos.to(device), table=self.table.to(device),
            labels=self.labels.to(device), banded=move(self.banded),
            comp=move(self.comp),
            panel=compact if self.panel is self.compact else move(self.panel),
            compact=compact)


def _stack_items(items):
    """Stack (pos, table, label) triples sharing bucket shapes: the
    positions, the EdgeTables (with the first mesh's ``n_valid``, ROADMAP
    Queue 3) and the labels, and the meshes' own tables."""
    poss, tables, labels = zip(*items)
    t0 = tables[0]
    stacked = EdgeTable(
        **{f: torch.stack([getattr(t, f) for t in tables])
           for f in ("src", "mask", "rsten", "fwxp", "ln", "wxp", "vmask")},
        n_valid=t0.n_valid,
        band_limit=t0.band_limit,
        n_rings=t0.n_rings,
    )
    pos = torch.stack([torch.as_tensor(np.asarray(p, np.float32))
                       for p in poss])
    lab = torch.stack([torch.as_tensor(np.asarray(v)) for v in labels])
    return pos, stacked, lab, tables


def stack_panel_batch(items, tb: int, echo_compact: bool = False,
                      conv_compact: bool = False) -> MeshBatch:
    """Stack (pos, table, label) triples for the pure-panel layout (CPU):
    each mesh's compressed PanelTable with target-block size ``tb``, joined
    into one that serves every op (K5 convs, panel ECHO and lift).  The
    counterpart of the JAX package's ``_stack_batch_panel``:

    echo_compact: also build each mesh's CompactPanelTable at target-block
      size min(tb, 32), joined into one (``compact``): ECHO (K7) and the
      lift run over it, the convs over the block panels (K5);
    conv_compact (requires echo_compact): the convs run over the compact
      table too (K6); no block-panel table is built, and ``panel`` is the
      same object as ``compact``.

    The batch has ``banded`` and ``comp`` None."""
    if conv_compact and not echo_compact:
        raise ValueError("conv_compact requires echo_compact")
    pos, stacked, lab, tables = _stack_items(items)
    compact = None
    if echo_compact:
        compact = concat_compact_panel_tables(
            [build_compact_panel_table(t, tb=min(tb, 32)) for t in tables])
    if conv_compact:
        panel = compact          # the same object: no duplicate stencil
    else:
        panel = concat_panel_tables(
            [build_panel_table(t, tb=tb, compressed=True) for t in tables])
    return MeshBatch(pos=pos, table=stacked, labels=lab, panel=panel,
                     compact=compact)


def stack_batch(items, banded_tb: Optional[int] = None,
                echo_banded: bool = False,
                echo_panel: bool = False,
                echo_compact: bool = False) -> MeshBatch:
    """Stack (pos, table, label) triples sharing bucket shapes (CPU).

    banded_tb: when set, also build + stack BandedTables (K1 conv path)
    with that target-block size.
    echo_banded: when set (requires banded_tb), also build the compressed
    banded tables (``comp``) that drive the banded ECHO
    (ops/echo.py::echo_banded) and the gather-free lift
    (ops/trans_field.py::trans_field_banded_contrib); passed as ``banded``
    too, the same table serves the convs (K4).
    echo_panel: when set (requires banded_tb), also build each mesh's
    compressed PanelTable and join them into one (the mixed route: K1
    convs, panel ECHO and lift).
    echo_compact: as echo_panel with each mesh's CompactPanelTable at
    target-block size banded_tb (``compact``: K1 convs, compact ECHO and
    lift).  echo_banded, echo_panel and echo_compact exclude each other.

    The stacked table keeps the first mesh's ``n_valid`` (ROADMAP Queue 3).
    """
    pos, stacked, lab, tables = _stack_items(items)
    t0 = tables[0]
    banded = None
    if banded_tb is not None:
        bs = [build_banded_table(t, tb=banded_tb) for t in tables]
        nh = max(b.nh for b in bs)
        bs = [_pad_banded(b, nh) for b in bs]
        banded = BandedTable(
            sten_band=torch.stack([b.sten_band for b in bs]),
            tb=banded_tb, nh=nh, n_pad=bs[0].n_pad,
            band_limit=t0.band_limit, n_rings=t0.n_rings,
        )
    comp = None
    if echo_banded:
        if banded_tb is None:
            raise ValueError("echo_banded requires banded_tb")
        cs = [build_compressed_banded(t, tb=banded_tb) for t in tables]
        nh = max(c.nh for c in cs)
        cs = [_pad_comp(c, nh) for c in cs]
        comp = CompressedBandedTable(
            sten_band=torch.stack([c.sten_band for c in cs]),
            tb=banded_tb, nh=nh, n_pad=cs[0].n_pad,
            band_limit=t0.band_limit, n_rings=t0.n_rings,
        )
    panel = compact = None
    if echo_panel or echo_compact:
        if banded_tb is None or echo_banded + echo_panel + echo_compact > 1:
            raise ValueError("echo_panel and echo_compact require banded_tb; "
                             "pass one of echo_banded, echo_panel and "
                             "echo_compact")
    if echo_panel:
        panel = concat_panel_tables(
            [build_panel_table(t, tb=banded_tb, compressed=True)
             for t in tables])
    if echo_compact:
        compact = concat_compact_panel_tables(
            [build_compact_panel_table(t, tb=banded_tb) for t in tables])
    return MeshBatch(pos=pos, table=stacked, labels=lab, banded=banded,
                     comp=comp, panel=panel, compact=compact)


def _pad_banded(b: BandedTable, nh: int) -> BandedTable:
    """Widen a banded table to a larger half-window (zero slots)."""
    if b.nh == nh:
        return b
    grow = (nh - b.nh) * b.tb
    return dataclasses.replace(
        b, nh=nh,
        sten_band=torch.nn.functional.pad(b.sten_band, (grow, grow)))


def _pad_comp(c: CompressedBandedTable, nh: int) -> CompressedBandedTable:
    """Widen a compressed banded table to a larger half-window.

    Padded slots get R_SENTINEL in the r plane (kills radial hats) and 0 in
    the phasor/wxp planes (kills votes)."""
    if c.nh == nh:
        return c
    grow = (nh - c.nh) * c.tb
    out = torch.nn.functional.pad(c.sten_band, (grow, grow))
    out[..., 0, :, :grow] = R_SENTINEL
    out[..., 0, :, -grow:] = R_SENTINEL
    return dataclasses.replace(c, nh=nh, sten_band=out)


def batched_apply(net, batch: MeshBatch, **kw):
    """Run the model over the batch's mesh axis in one call: the banded
    route (BandedTable convs, plus the compressed lift and, with
    echo_impl "banded", the banded ECHO when ``comp`` is set; a batch whose
    ``banded`` is its ``comp`` runs every conv through K4), the mixed route (BandedTable convs, ECHO and lift over the
    batch's one PanelTable, or over its CompactPanelTable; a
    BlockSparseTable set as ``banded``, on this route or on the pure-panel
    layout, runs every conv through K8 and leaves ECHO and the lift on the
    panels, as the JAX batched_apply takes it), the pure-panel
    route (the PanelTable passed as both ``banded`` and ``comp``: K5 convs,
    ECHO and lift; with a CompactPanelTable, ECHO and the lift over it and
    the convs over ``panel``, which is the compact table itself on the
    all-compact route) or, without tables, the padded-CSR gather route.
    ``kw`` goes to the model (e.g. ``dropout_mask``).

    The JAX package unrolls a batch that carries panels mesh by mesh (its
    panel counts differ); here the meshes' panels form one table, so one
    K5 or K2 launch and one lift serve the batch, as one K1 launch does."""
    comp = next((t for t in (batch.compact, batch.panel, batch.comp)
                 if t is not None), None)
    banded = batch.banded if batch.banded is not None else batch.panel
    return net(batch.pos, batch.table, banded, comp, **kw)


# --- augmentation ------------------------------------------------------------

def draw_rotate_scale(generator: Optional[torch.Generator], n_mesh: int,
                      max_deg: float = 45.0,
                      scale_range: Optional[Tuple[float, float]] = (0.85,
                                                                    1.15)):
    """Per-mesh random angles about the three axes, uniform in ±max_deg
    (returned in radians, (n_mesh, 3)), and uniform scales (n_mesh, 1, 1)
    in scale_range (None when scale_range is None), drawn from
    ``generator`` on its device (classification.ipynb cell 5's transform
    chain)."""
    dev = generator.device if generator is not None else "cpu"
    u = torch.rand((n_mesh, 3), generator=generator, device=dev)
    angles = (u * (2 * max_deg) - max_deg) * (math.pi / 180.0)
    scales = None
    if scale_range is not None:
        lo, hi = scale_range
        scales = torch.rand((n_mesh, 1, 1), generator=generator,
                            device=dev) * (hi - lo) + lo
    return angles, scales


def rotate_scale(pos, angles, scales=None):
    """Rotate each mesh's positions by rz @ ry @ rx of its angles, then
    scale them.  pos: (n_mesh, N, 3); angles: (n_mesh, 3) radians; scales:
    (n_mesh, 1, 1) or None.  As ``fieldconv_tpu/train/trainer.py::
    random_rotate_scale`` applies its draws."""
    angles = angles.to(device=pos.device, dtype=pos.dtype)
    c, s = torch.cos(angles), torch.sin(angles)
    one, zero = torch.ones_like(c[:, 0]), torch.zeros_like(c[:, 0])

    def mats(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    cx, cy, cz = c.unbind(-1)
    sx, sy, sz = s.unbind(-1)
    rx = mats([[one, zero, zero], [zero, cx, -sx], [zero, sx, cx]])
    ry = mats([[cy, zero, sy], [zero, one, zero], [-sy, zero, cy]])
    rz = mats([[cz, -sz, zero], [sz, cz, zero], [zero, zero, one]])
    out = torch.einsum("bij,bnj->bni", rz @ ry @ rx, pos)
    if scales is not None:
        out = out * scales.to(device=pos.device, dtype=pos.dtype)
    return out


def draw_dropout_mask(generator: torch.Generator, net, batch: MeshBatch):
    """A float32 keep mask for the dropout of ``net`` (a CorrespondenceNet)
    over ``batch``: shape (B, N, width of its lin1), each entry 1 with
    probability 1 − net.p, drawn from ``generator`` on its device.  The
    correspondence step feeds it to the net (``dropout_mask=``) instead of
    letting nn.Dropout draw from the global RNG."""
    return keep_mask(generator, (*batch.pos.shape[:2],
                                 net.lin1.weight.shape[0]), net.p)


def keep_mask(generator: torch.Generator, shape, p: float):
    """A float32 keep mask of ``shape``: each entry 1 with probability 1 −
    p, drawn from ``generator`` on its device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (u < 1.0 - p).to(torch.float32)


# --- optimizer ----------------------------------------------------------------

class Adam:
    """``optax.adam(schedule)``, wrapped in ``optax.MultiSteps`` when
    ``every_k > 1``, updating ``params`` in place.

    Moments mu, nu: (1 − b)·g + b·moment; bias correction by the count of
    applied updates; update lr·m̂ / (sqrt(v̂) + eps) subtracted (eps_root
    0).  The learning rate is ``lr`` until ``decay_at`` applied updates
    have been made and ``lr_decayed`` from then on (optax's
    piecewise_constant_schedule).  With every_k > 1 the gradients of
    consecutive calls are averaged (a running mean) and applied on every
    k-th call; the calls in between leave the parameters as they are.

    ``update(grads, ok)`` keeps every parameter and all of this state as it
    was where the boolean tensor ``ok`` is false, without reading it on the
    host.  State tensors live on the parameters' device; ``step`` counts
    every call.
    """

    def __init__(self, params, lr: float, decay_at: Optional[int] = None,
                 lr_decayed: Optional[float] = None, every_k: int = 1,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params: List[torch.Tensor] = list(params)
        dev = self.params[0].device
        self.lr, self.decay_at, self.lr_decayed = lr, decay_at, lr_decayed
        self.every_k, self.b1, self.b2, self.eps = every_k, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if every_k > 1 else [])
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.mini_step = torch.zeros((), dtype=torch.int32, device=dev)
        self.step = torch.zeros((), dtype=torch.int64, device=dev)

    def _lr(self):
        """Learning rate at the current count of applied updates, in
        float32 as optax forms it."""
        f32 = dict(dtype=torch.float32, device=self.count.device)
        lr = torch.tensor(self.lr, **f32)
        if self.decay_at is None:
            return lr
        decayed = lr * torch.tensor(self.lr_decayed / self.lr, **f32)
        return torch.where(self.count >= self.decay_at, decayed, lr)

    @torch.no_grad()
    def update(self, grads, ok) -> None:
        if self.every_k > 1:
            n = self.mini_step.to(torch.float32)
            grads = [a + (g - a) / (n + 1) for a, g in zip(self.acc, grads)]
            emit = self.mini_step == self.every_k - 1
            apply = ok & emit
        else:
            apply = ok
        count = self.count + 1
        c = count.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(self.b1, device=c.device), c)
        bc2 = 1 - torch.pow(torch.tensor(self.b2, device=c.device), c)
        neg_lr = -self._lr()
        for p, m, v, g in zip(self.params, self.mu, self.nu, grads):
            m_new = (1 - self.b1) * g + self.b1 * m
            v_new = (1 - self.b2) * (g * g) + self.b2 * v
            u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + self.eps)
            p.copy_(torch.where(apply, p + u * neg_lr, p))
            m.copy_(torch.where(apply, m_new, m))
            v.copy_(torch.where(apply, v_new, v))
        if self.every_k > 1:
            for a, g in zip(self.acc, grads):
                a.copy_(torch.where(ok, torch.where(emit, 0.0, g), a))
            self.mini_step.copy_(torch.where(
                ok, (self.mini_step + 1) % self.every_k, self.mini_step))
        self.count.copy_(torch.where(apply, count, self.count))
        self.step += 1

    def state_dict(self) -> dict:
        return {"mu": self.mu, "nu": self.nu, "acc": self.acc,
                "count": self.count, "mini_step": self.mini_step,
                "step": self.step}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        for key in ("mu", "nu", "acc"):
            for dst, src in zip(getattr(self, key), state[key], strict=True):
                dst.copy_(src)
        for key in ("count", "mini_step", "step"):
            getattr(self, key).copy_(state[key])


def make_optimizer(config: ExperimentConfig, params,
                   steps_per_epoch: int = 1) -> Adam:
    """The JAX package's optimizer for ``params``: Adam at config.lr,
    decayed to config.lr_decayed after config.lr_decay_epoch epochs of
    applied updates, averaging config.batch_step mini-batches per update."""
    decay_at = (None if config.lr_decay_epoch is None
                else config.lr_decay_epoch * steps_per_epoch)
    return Adam(params, config.lr, decay_at, config.lr_decayed,
                every_k=max(1, config.batch_step))


# --- loss and step -------------------------------------------------------------

def make_loss_fn(net, config: ExperimentConfig, n_classes: int):
    """loss(batch, generator=None, aug=None, dropout_mask=None): rotate and
    scale the batch's positions (drawn from ``generator``, or ``aug =
    (angles, scales)`` as :func:`draw_rotate_scale` returns them), run the
    model, and take the task's loss, as the JAX ``make_loss_fn`` does:

    - classification: the masked cross entropy of the pooled logits;
    - segmentation: the label-smoothed cross entropy over every vertex
      (padding rows carry label −1 and are masked);
    - correspondence: the masked cross entropy over every vertex, with
      dropout active: the keep mask (B, N, 256) is ``dropout_mask`` or, when
      none is given, drawn from ``generator`` (:func:`draw_dropout_mask`;
      without either it raises: never torch's global RNG).
      The JAX step draws it from flax's dropout RNG, which cannot be
      reproduced, so tests inject one mask into both nets."""
    task = config.task
    if task not in ("classification", "segmentation", "correspondence"):
        raise NotImplementedError(
            f"the {task!r} loss is not ported yet: the twin loss of "
            "matching is ROADMAP Queue 1 item 3")

    def loss_fn(batch: MeshBatch, generator=None, aug=None,
                dropout_mask=None):
        if aug is None:
            aug = draw_rotate_scale(generator, batch.pos.shape[0],
                                    config.random_rotate_deg,
                                    config.random_scale)
        pos = rotate_scale(batch.pos, *aug)
        moved = dataclasses.replace(batch, pos=pos)
        if task == "classification":
            return cross_entropy(batched_apply(net, moved)[:, 0, :],
                                 batch.labels)
        if task == "segmentation":
            logits = batched_apply(net, moved)
            return label_smoothing_loss(
                logits.reshape(-1, n_classes), batch.labels.reshape(-1),
                n_classes, config.smoothing)
        if dropout_mask is None:
            if generator is None:
                raise ValueError(
                    "the correspondence loss draws its dropout mask from "
                    "`generator`: pass generator= or dropout_mask=")
            dropout_mask = draw_dropout_mask(generator, net, batch)
        logits = batched_apply(net, moved,
                               dropout_mask=dropout_mask.to(pos.device))
        return cross_entropy(logits.reshape(-1, n_classes),
                             batch.labels.reshape(-1))

    return loss_fn


def _guarded_update(opt: Adam, loss, grads) -> None:
    """Apply the optimizer update, keeping the previous parameters and
    optimizer state when the loss is not finite.  The guard stays on the
    device, so the training loop never waits on a loss readback; the step
    counter goes up either way."""
    opt.update(grads, torch.isfinite(loss))


def make_train_step(net, config: ExperimentConfig, n_classes: int,
                    opt: Adam):
    """step(batch, generator=None, aug=None, dropout_mask=None) -> the
    batch's loss (a device tensor): one forward and backward of ``net`` and
    a guarded update of ``opt``, whose parameters are the net's (the
    arguments as :func:`make_loss_fn`'s)."""
    loss_fn = make_loss_fn(net, config, n_classes)

    def step(batch: MeshBatch, generator=None, aug=None, dropout_mask=None):
        loss = loss_fn(batch, generator, aug, dropout_mask)
        grads = torch.autograd.grad(loss, opt.params, materialize_grads=True)
        _guarded_update(opt, loss, grads)
        return loss.detach()

    return step
