"""Training at the 100k north-star scale: the port of scripts/train_100k.py.

    python -m fieldconv_tpu_torch.scripts.train_100k          # on the card

Trains the full correspondence network (CorrespondenceNet: Lift, 8
FCResNetBlocks of nf 32 with 4 meta-residuals, ECHOBlock with n_des 12 and
n_bins 2, band limit 1, 3 rings, dropout 0.5 and the 4999-way head) on one
mesh of 163,842 vertices, every op over the panel layouts, with the JAX
script's recipe: each vertex's label is its template bucket arange(N)·4999
// N over the kd-ordered surface, Adam at lr 0.01, the head applied
row-chunked (8192 rows a chunk, each under torch.utils.checkpoint) in the
cross entropy, the FCResNetBlocks rematerialised (remat_blocks), and every
T100K_LOG steps the train accuracy on a fixed 8192-row probe slice in eval
mode.

One substitution: the mesh is data/synthetic.py::sphere_record, the
kd-ordered Fibonacci sphere of 10·4^SCALE_SUBDIV + 2 samples (163,842 at
the default 7) with its ε-ball graph and random log maps, in place of the
icosphere whose log maps the JAX script computes with compute_log_xport:
the port has no precompute yet (ROADMAP Queue 1 item 5).

Tables, as in the JAX script: the compressed block panels at TB 128 run the
convs (K5) and, with T100K_COMPACT_TB=0, ECHO (K2) and the lift; a
CompactPanelTable at TBt T100K_COMPACT_TB (32) runs ECHO (K7) and the lift,
and with T100K_CONV_IMPL=compact the convs too (K6), with no block panels.
T100K_BF16=1 (the default) stores both stencils in bfloat16
(precomp/banded.py::cast_panel_sten), which every kernel and the lifts read
back as the JAX package does.

Writes one JSON line per stage and per logged step (step, loss, probe_acc,
ms_step) to stdout, and appends them to the file T100K_OUT when it is set.

Env: T100K_STEPS (150), T100K_LOG (10), T100K_BF16 (1), T100K_COMPACT_TB
(32), T100K_CONV_IMPL (panel | compact), T100K_OUT (unset), SCALE_SUBDIV
(7).  The record and the weights are drawn from seed 0.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..data.synthetic import sphere_record
from ..models import CorrespondenceNet
from ..precomp.banded import (build_compact_panel_table, build_panel_table,
                              cast_panel_sten)
from ..train.trainer import Adam, MeshBatch, batched_apply, draw_dropout_mask

N_CLASSES = 4999
TB = 128
HEAD_ROWS = 8192          # rows of a head chunk, and of the probe slice
LR = 0.01


def template_labels(n: int, n_pad: int):
    """(1, n_pad) int64 labels: vertex i's template bucket i·4999 // n, −1
    at padding rows."""
    lab = torch.full((1, n_pad), -1, dtype=torch.int64)
    lab[0, :n] = torch.arange(n, dtype=torch.int64) * N_CLASSES // n
    return lab


def cast_batch(batch: MeshBatch, dtype=torch.bfloat16) -> MeshBatch:
    """The batch with its PanelTable and CompactPanelTable stencils cast by
    cast_panel_sten; an all-compact batch (``panel is compact``) casts its
    one table once and keeps both names on the cast object."""
    compact = (None if batch.compact is None
               else cast_panel_sten(batch.compact, dtype))
    panel = (compact if batch.panel is batch.compact
             else cast_panel_sten(batch.panel, dtype))
    return dataclasses.replace(batch, panel=panel, compact=compact)


def build_batch(record, compact_tb: int, all_compact: bool, bf16: bool,
                device) -> MeshBatch:
    """The training batch of ``record``: positions (not centred, as the JAX
    script feeds them), template labels, the compressed block panels at TB
    (unless all-compact) and the CompactPanelTable at TBt ``compact_tb``
    (0: none), cast to bf16 on the host when ``bf16``, then placed.  The
    nets read no EdgeTable on these layouts, so the batch carries none."""
    if all_compact and not compact_tb:
        raise ValueError("T100K_CONV_IMPL=compact needs the compact table; "
                         "unset T100K_COMPACT_TB=0")
    table = record.table(1, 3, n_multiple=TB)
    compact = (build_compact_panel_table(table, tb=compact_tb)
               if compact_tb else None)
    panel = (compact if all_compact
             else build_panel_table(table, tb=TB, compressed=True))
    batch = MeshBatch(
        pos=torch.from_numpy(record.padded_pos(table.n_pad))[None],
        table=None, labels=template_labels(record.n_samples, table.n_pad),
        panel=panel, compact=compact)
    if bf16:
        batch = cast_batch(batch)
    compact = None if batch.compact is None else batch.compact.to(device)
    return dataclasses.replace(
        batch, pos=batch.pos.to(device), labels=batch.labels.to(device),
        panel=compact if batch.panel is batch.compact
        else batch.panel.to(device), compact=compact)


def head_chunks(n_pad: int) -> int:
    """The head's chunk count: at least n_pad / HEAD_ROWS, dividing n_pad
    (the JAX script's head_chunks)."""
    nc = -(-n_pad // HEAD_ROWS)
    while n_pad % nc:
        nc += 1
    return nc


def _chunk_ce(feats, labels, weight, bias):
    """Summed cross entropy of one chunk of rows (label −1: left out)."""
    lp = torch.log_softmax(feats @ weight.T + bias, dim=-1)
    valid = labels >= 0
    per = -torch.gather(lp, 1, torch.where(valid, labels, 0)[:, None])[:, 0]
    return torch.sum(torch.where(valid, per, 0.0))


def loss_fn(net, batch: MeshBatch, dropout_mask):
    """The JAX script's loss: the net's 256-wide features (return_features)
    under ``dropout_mask``, then the head and the cross entropy a chunk of
    rows at a time, each chunk recomputed in the backward, averaged over
    the labelled rows."""
    feats = batched_apply(net, batch, dropout_mask=dropout_mask)
    f = feats.reshape(-1, feats.shape[-1])
    lab = batch.labels.reshape(-1)
    rows = f.shape[0] // head_chunks(f.shape[0])
    w, b = net.lin2.weight, net.lin2.bias
    total = sum(checkpoint(_chunk_ce, f[lo:lo + rows], lab[lo:lo + rows], w,
                           b, use_reentrant=False)
                for lo in range(0, f.shape[0], rows))
    return total / torch.clamp((lab >= 0).sum(), min=1)


@torch.no_grad()
def probe_acc(net, batch: MeshBatch) -> float:
    """Train accuracy on the first HEAD_ROWS rows, the net in eval mode."""
    net.eval()
    try:
        feats = batched_apply(net, batch)[0, :HEAD_ROWS]
    finally:
        net.train()
    pred = torch.argmax(net.lin2(feats), dim=-1)
    lab = batch.labels[0, :HEAD_ROWS]
    valid = lab >= 0
    return ((pred == lab) & valid).sum().item() / max(1, valid.sum().item())


def build_net(seed: int, device) -> CorrespondenceNet:
    """The JAX script's net, weights drawn from ``seed``."""
    return CorrespondenceNet(
        n_classes=N_CLASSES, nf=32, n_des=12, n_bins=2, band_limit=1,
        n_rings=3, remat_blocks=True, return_features=True,
        generator=torch.Generator().manual_seed(seed), device=device)


def make_step(net, batch: MeshBatch, seed: int = 0):
    """step() -> loss: one Adam step (lr LR, as optax.adam: no guard) of
    ``net`` on ``batch`` under a dropout mask drawn on the batch's device
    from a generator seeded ``seed + 1``."""
    dev = batch.pos.device
    opt = Adam(net.parameters(), LR)
    always = torch.ones((), dtype=torch.bool, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    def step():
        loss = loss_fn(net, batch, draw_dropout_mask(gen, net, batch))
        opt.update(torch.autograd.grad(loss, opt.params), always)
        return loss.detach()

    return step


def train(batch: MeshBatch, steps: int, log_every: int = 10, seed: int = 0,
          emit=None):
    """``steps`` steps of the JAX script's recipe (:func:`make_step`) on
    ``batch`` (placed, its tables possibly cast) from a net built from
    ``seed``; every ``log_every`` steps and at the last, the probe
    accuracy.  ``emit`` gets each logged record (a dict).  Returns (the
    net, the records, the losses of every step)."""
    net = build_net(seed, batch.pos.device)
    step = make_step(net, batch, seed)
    records, losses = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        losses.append(step().item())
        if i % log_every == 0 or i == steps - 1:
            rec = {"step": i, "loss": round(losses[-1], 4),
                   "probe_acc": round(probe_acc(net, batch), 4),
                   "ms_step": round((time.perf_counter() - t0) * 1e3)}
            records.append(rec)
            if emit is not None:
                emit(rec)
    return net, records, losses


def main() -> int:
    env = os.environ.get
    n = 10 * 4 ** int(env("SCALE_SUBDIV", "7")) + 2
    steps = int(env("T100K_STEPS", "150"))
    log_every = int(env("T100K_LOG", "10"))
    bf16 = env("T100K_BF16", "1") != "0"
    ctb = int(env("T100K_COMPACT_TB", "32"))
    conv_impl = env("T100K_CONV_IMPL", "panel")
    seed = 0
    out_path = env("T100K_OUT")
    if conv_impl == "compact" and not ctb:
        raise SystemExit(
            "T100K_CONV_IMPL=compact needs the compact table; unset "
            "T100K_COMPACT_TB=0 (the all-compact route runs every op off "
            "that one table)")
    fout = open(out_path, "a") if out_path else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if fout is not None:
            fout.write(line + "\n")
            fout.flush()

    if not torch.cuda.is_available():
        raise SystemExit("train_100k runs on a CUDA device")
    emit({"run": {"conv_impl": conv_impl, "compact_tb": ctb, "steps": steps,
                  "bf16": int(bf16), "n": n, "mesh": "sphere_record"}})
    t0 = time.perf_counter()
    record = sphere_record(np.random.default_rng(seed), n, N_CLASSES)
    batch = build_batch(record, ctb, conv_impl == "compact", bf16, "cuda")
    tab = batch.panel
    emit({"stage": "tables", "n_pad": tab.n_pad,
          "n_panels": int(tab.n_panels),
          "all_compact": batch.panel is batch.compact,
          "sten_gb": round(tab.sten.numel() * tab.sten.element_size() / 1e9,
                           2),
          "build_s": round(time.perf_counter() - t0, 1)})
    t_start = time.perf_counter()
    train(batch, steps, log_every, seed, emit)
    total = time.perf_counter() - t_start
    emit({"stage": "done", "steps": steps, "total_s": round(total, 1),
          "s_per_step_incl_probes": round(total / max(1, steps), 2),
          "device": torch.cuda.get_device_name(0)})
    if fout is not None:
        fout.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
