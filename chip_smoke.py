"""Smoke run of the PyTorch port (fieldconv_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root

Phases, any failure exits non-zero:
  1. build every CUDA kernel from csrc/ (one nvcc per source, all at once)
     and print the card's name and power limit;
  2. hold K1's forward and backward kernels (fused banded field conv)
     against their plain PyTorch versions on the card: at the two
     classification serving shapes, on the real stencils of the records
     below, and on a dense random stencil with nh=4 that reaches past both
     ends of g (the backward must also give bitwise-equal results on a
     second call); the forward also at the widths the ECHO nets give it
     (C=48/O2=96, and K=3, R=3 with C=16/32 and O2=24/32/64), and the
     backward at those five widths (bitwise repeatable too);
  3. hold K2's forward and backward (panel ECHO) against their plain
     versions on the records' own panel tables, with features of which
     ~20% of rows are zero, at n_bins 3 (C=48) and 2 (C=12), and bitwise
     against a second call; the backward for a contiguous cotangent and
     for one in the layout autograd hands over (cells minor);
  4. serve the SHREC11 classification network (the CLASSIFICATION preset:
     nf=32, B=2, R=6, ftype=1, 30 classes, random weights from a seed)
     through Predictor(banded_tb=128, device="cuda"): one batch of 8
     SHREC11-sized records (~600 samples, ε=0.2, degree 60-80) and one
     record of 8192 samples with degree 128.  Each batch must launch K1
     five times; classes and logits must match the same Predictor on the
     CPU, which runs the plain versions;
  5. serve the SEGMENTATION preset (nf=48, n_des=48, n_bins=3, B=2, R=6,
     8 classes) on a batch of 4 records of 2048 samples and the
     CORRESPONDENCE preset (nf=32, n_des=12, n_bins=2, B=1, R=3, 4999
     classes, centred) on one record of 5120 samples (ε=0.2 / 0.0425,
     degree 100-128, sources within ±128) through Predictor(banded_tb=128,
     device="cuda") on the mixed route.  A batch must launch K1 9 / 17
     times and K2 once; logits must match the same Predictor on the CPU,
     and labels / maps at every vertex whose top-two logit gap on the CPU
     exceeds 1e-3;
  6. train the classification network with fit(banded_tb=128,
     batch_size=8, device="cuda") on 16 SHREC11-sized records (2 batches)
     for 2 epochs, testing on 8 more, checkpointing into a temporary
     directory.  Each step must launch K1's forward and backward five
     times each, every loss must be finite, and the first epoch's losses
     must match the same fit on the CPU (plain versions);
  7. train the SEGMENTATION preset the same way with batch_size=4 on 8
     records of 2048 samples (2 batches), testing on 4 more, and the
     CORRESPONDENCE preset with batch_size=1 on 2 records of 5120 samples,
     testing on 1 more.  Each step must launch K1's forward and backward
     9 / 17 times each and K2's forward and backward once each, each test
     batch K1's forward 9 / 17 times and K2's once;
  8. time the kernels and their plain versions, each request shape, a
     training step at each training shape, and one forward and backward of
     five convs at bench.py's shape;
  9. print the kernels line, the card line and the result line.

Records are synthetic, built with numpy from --seed in the manner of
bench.py::build_synthetic_tables: unique sources within ±bandwidth of each
target (the locality RCM ordering gives real meshes), log-map radius in
[0, ε], random unit transports.  Nothing of JAX is imported.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from fieldconv_tpu_torch import kernels
from fieldconv_tpu_torch.data.base import MeshRecord, shared_bucket
from fieldconv_tpu_torch.deploy import Predictor
from fieldconv_tpu_torch.ops.band_conv import (band_fused_bwd,
                                               band_fused_bwd_reference,
                                               band_fused_fwd,
                                               band_fused_fwd_reference,
                                               field_conv_banded)
from fieldconv_tpu_torch.ops.echo_panel import (echo_panel_grid,
                                                echo_panel_grid_bwd,
                                                echo_panel_grid_bwd_reference,
                                                echo_panel_grid_reference)
from fieldconv_tpu_torch.train.checkpoint import CheckpointManager
from fieldconv_tpu_torch.train.config import PRESETS
from fieldconv_tpu_torch.train.loop import build_model, fit, make_batches
from fieldconv_tpu_torch.train.trainer import make_train_step
from fieldconv_tpu_torch.utils.complexops import EPS

# H100 SXM data-sheet peaks (dense, 700 W): HBM bytes/s and f32 FLOP/s
# outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
N_CLASSES = 30
TB = 128
# K1 against its plain version: f32 sums in another order over W' ≤ 1152
# slots and R·M = 1920 filter terms; held to 1e-4 of the output's scale.
# The backward's dg and dw each to 1e-4 of their own scale: dw sums over
# every target of every mesh (up to 8192 rows) in another order.
K1_RTOL_SCALE = 1e-4
# K2 against its plain version: f32 sums over a target's panels (and the
# four corners of each vote) in another order, plus FMA contraction after
# p; held to 1e-4 of the grid's scale.  Its backward the same way: dx sums
# over a source's targets and panels in another order, to 1e-4 of dx's
# scale.
K2_RTOL_SCALE = 1e-4
# served logits, card against CPU: every op sums in another order
LOGIT_RTOL, LOGIT_ATOL = 1e-3, 1e-4
# labels / maps are compared where the CPU's top-two logit gap exceeds this
LABEL_GAP = 1e-3
# float operations per (edge, channel whose feature is not at the origin)
# in K2: |x|² and rsqrt 4, unit 2, p1 and p2 8, the four weights 8, the
# vote 6, four complex splats 16
K2_FLOPS_PER_PAIR = 44
# and in K2's backward: p1 and p2 8, the corner distances 4, the weights 4,
# the vote 6, dv over four corners 16, the four dW 12, dp1 and dp2 16, the
# unit vector's and the vote's accumulators 8 each
K2_BWD_FLOPS_PER_PAIR = 82
# training losses, card against CPU.  Step 1 sees the same weights, so it
# differs only by summation order, as the logits do.  Step 2 follows one
# Adam update, whose direction m̂/sqrt(v̂) is ±1 per parameter at step 1:
# a gradient entry near zero whose sign differs between the two devices
# moves its parameter by 2·lr, so that step is held more loosely.  Such a
# parameter's gradient is near zero, so its move barely shows in the next
# loss whatever the task: every preset is held to the same bounds.
LOSS_ATOL_STEP1, LOSS_ATOL_LATER = 2e-4, 2e-3
TRAIN_EPOCHS = 2
# the fits on the card, per shape: (train records, batch size, test
# records), TRAIN_EPOCHS epochs each (4 steps)
TRAIN_FIT = {"shrec11_b8": (16, 8, 8), "seg_n2048_b4": (8, 4, 4),
             "corr_n5120_b1": (2, 1, 1)}
# K1 launches per forward (and per backward) pass of each net
K1_PER_PASS = {"shrec11_b8": 5, "seg_n2048_b4": 9, "corr_n5120_b1": 17}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# --- synthetic records ---------------------------------------------------------

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


def shrec_records(rng, eps):
    return [synthetic_record(rng, int(rng.integers(560, 621)), 60, 80, 200,
                             eps, f"shrec{i}", int(rng.integers(N_CLASSES)))
            for i in range(8)]


def large_record(rng, eps):
    return synthetic_record(rng, 8192, 128, 128, 128, eps, "n8192", 0)


def echo_records(rng, n, count, eps, n_classes, name):
    """The ECHO presets' serving records (scripts/serve_probe.py's N=2048
    and N=5120 with D=128): degree 100-128, sources within ±128, random
    per-vertex labels."""
    return [synthetic_record(rng, n, 100, 128, 128, eps, f"{name}{i}",
                             rng.integers(0, n_classes, n))
            for i in range(count)]


# --- timing ----------------------------------------------------------------------

def time_cuda(fn, iters, reps=5):
    """Median ms per call over `reps` CUDA-event windows of `iters` calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


def request_breakdown(fn, top=6):
    """One call of fn() under torch.profiler: the device time of each
    kernel name, their sum, and that sum's share of the call's wall time
    (which the profiler itself inflates)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = sorted(((e.self_device_time_total / 1e3, e.key, e.count)
                   for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(k[0] for k in kern)
    check(busy > 0, "the profiler saw no device time")
    return wall_ms, busy, kern[:top]


def kernel_name(key):
    """The function name in a profiler key such as
    "void (anonymous namespace)::bwd_dg_kernel<5, 6>(float const*, ...)"."""
    m = re.search(r"(\w+)(?:<[^>(]*>)?\(", key)
    return m.group(1) if m else key


def time_host(fn, reps=5):
    """Median wall ms of fn() (which must end in a device sync)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# --- K1 against its plain version ----------------------------------------------------

def k1_inputs(sten, R, C, O2, gen):
    """Random g and W (scaled so y is O(1)) for a stencil of R rings."""
    n_mesh, nb, P, tb, _ = sten.shape
    K = (P - R) // 2
    dev = sten.device
    g = torch.randn(n_mesh, nb * tb, K * 2 * C, device=dev, generator=gen)
    wmat = torch.randn(R, K * 2 * C, O2, device=dev, generator=gen) / 40.0
    return g, wmat


def _stencil_counts(sten, R):
    """Nonzero radial weights and occupied (target, slot) pairs (any
    nonzero radial weight) of a stencil of R rings."""
    rs = sten[:, :, :R]
    return (int(torch.count_nonzero(rs).item()),
            int((rs != 0).any(dim=2).sum().item()))


def k1_bound(g, sten, wmat):
    """Least time for one forward call: bytes (each input read once, y
    written once) over HBM rate, and the f32 operations this data needs
    over the f32 rate.  The stencil term takes the cheaper of two orders:
    per occupied slot form h_k = f_k·G_k once (6C flops per k) and per
    nonzero radial weight add rs·h_k (4C per k); or per nonzero radial
    weight scale f_k by it (2 per k) and add the complex product (8C per
    k).  Plus the filter contraction 2·N·R·M·O2."""
    n_mesh, N, M = g.shape
    R, _, O2 = wmat.shape
    K = (sten.shape[2] - R) // 2
    C = M // (2 * K)
    nnz, occupied = _stencil_counts(sten, R)
    stencil = min(occupied * K * 6 * C + nnz * K * 4 * C,
                  nnz * K * (8 * C + 2))
    flops = stencil + 2 * n_mesh * N * R * M * O2
    dense = (8 * R * sten.shape[3] * sten.shape[4] * C * K
             * sten.shape[1] * n_mesh + 2 * n_mesh * N * R * M * O2)
    nbytes = 4 * (sten.numel() + g.numel() + wmat.numel() + n_mesh * N * O2)
    return _bound(nbytes, flops, dense_flops=dense,
                  slot_fill=nnz / max(1, R * sten.numel() // sten.shape[2]),
                  rings_per_slot=nnz / max(1, occupied))


def k1_bwd_bound(g, sten, wmat):
    """Least time for one backward call: bytes (dy, g, the stencil and W
    read once, dg and dW written once) over HBM rate, and the f32
    operations this data needs over the f32 rate: the forward's stencil
    term to rematerialise contrib; dW = contribᵀ·dy and dcontrib = dy·Wᵀ
    (2·N·R·M·O2 each); and the transposed stencil term for dG, the cheaper
    of per nonzero radial weight u_k += rs·dcontrib_k (4C per k) plus per
    occupied slot dG += f_k ⊛ u_k (8C per k), or per nonzero radial weight
    scale f_k by it (2 per k) and apply it to dcontrib (8C per k)."""
    n_mesh, N, M = g.shape
    R, _, O2 = wmat.shape
    K = (sten.shape[2] - R) // 2
    C = M // (2 * K)
    nnz, occupied = _stencil_counts(sten, R)
    contrib = min(occupied * K * 6 * C + nnz * K * 4 * C,
                  nnz * K * (8 * C + 2))
    dgrad = min(occupied * K * 8 * C + nnz * K * 4 * C,
                nnz * K * (8 * C + 2))
    flops = contrib + dgrad + 2 * 2 * n_mesh * N * R * M * O2
    nbytes = 4 * (sten.numel() + 2 * g.numel() + 2 * wmat.numel()
                  + n_mesh * N * O2)
    return _bound(nbytes, flops)


def _bound(nbytes, flops, **extra):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops, **extra)


def k1_check(label, g, sten, wmat, tb, nh):
    y = band_fused_fwd(g, sten, wmat, tb, nh)
    torch.cuda.synchronize()
    ref = band_fused_fwd_reference(g, sten, wmat, tb, nh)
    err = (y - ref).abs().max().item()
    scale = ref.abs().max().item()
    check(torch.isfinite(y).all().item(), f"K1 {label}: non-finite output")
    check(err <= K1_RTOL_SCALE * scale,
          f"K1 {label}: max abs err {err} > {K1_RTOL_SCALE} x {scale}")
    row = dict(shape=label, n_mesh=g.shape[0], N=g.shape[1], M=g.shape[2],
               nh=nh, O2=wmat.shape[2], max_abs_err=err,
               max_rel_err=err / scale)
    print(f"K1 {label}: max abs err {err:.3e}, rel {err / scale:.3e} "
          f"(tolerance {K1_RTOL_SCALE} of max |y| = {scale:.3e})")
    return row


def k1_time(row, g, sten, wmat, tb, nh):
    row["ms"] = time_cuda(lambda: band_fused_fwd(g, sten, wmat, tb, nh),
                          iters=20)
    row["plain_ms"] = time_cuda(
        lambda: band_fused_fwd_reference(g, sten, wmat, tb, nh), iters=3)
    row.update(k1_bound(g, sten, wmat))


def k1_bwd_check(label, g, sten, wmat, dy, tb, nh):
    """K1's backward against its plain version, then a second call that
    must give bitwise-equal dg and dw."""
    dg, dw = band_fused_bwd(dy, g, sten, wmat, tb, nh)
    torch.cuda.synchronize()
    ref_g, ref_w = band_fused_bwd_reference(dy, g, sten, wmat, tb, nh)
    row = dict(shape=label, n_mesh=g.shape[0], N=g.shape[1], M=g.shape[2],
               nh=nh, O2=wmat.shape[2])
    for name, got, ref in (("dg", dg, ref_g), ("dw", dw, ref_w)):
        check(torch.isfinite(got).all().item(),
              f"K1 bwd {label}: non-finite {name}")
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        check(err <= K1_RTOL_SCALE * scale,
              f"K1 bwd {label}: {name} max abs err {err} > "
              f"{K1_RTOL_SCALE} x {scale}")
        row[f"{name}_max_abs_err"] = err
        row[f"{name}_max_rel_err"] = err / scale
    dg2, dw2 = band_fused_bwd(dy, g, sten, wmat, tb, nh)
    check(torch.equal(dg, dg2) and torch.equal(dw, dw2),
          f"K1 bwd {label}: two calls differ")
    row["max_abs_err"] = max(row["dg_max_abs_err"], row["dw_max_abs_err"])
    print(f"K1 bwd {label}: dg max abs err {row['dg_max_abs_err']:.3e} "
          f"(rel {row['dg_max_rel_err']:.3e}), dw {row['dw_max_abs_err']:.3e}"
          f" (rel {row['dw_max_rel_err']:.3e}); tolerance {K1_RTOL_SCALE} "
          "of each one's scale; a second call is bitwise equal")
    return row


def k1_bwd_time(row, g, sten, wmat, dy, tb, nh):
    row["ms"] = time_cuda(lambda: band_fused_bwd(dy, g, sten, wmat, tb, nh),
                          iters=10)
    row["plain_ms"] = time_cuda(
        lambda: band_fused_bwd_reference(dy, g, sten, wmat, tb, nh), iters=2)
    row.update(k1_bwd_bound(g, sten, wmat))


# --- K2 against its plain version ----------------------------------------------------

def k2_inputs(panel, C, gen):
    """Random planar features (rows, C, 2) for a panel table, ~20% of the
    rows zero (origin features, which cast no vote)."""
    rows = panel.n_mesh * panel.n_pad
    dev = panel.sten.device
    x = torch.randn(rows, C, 2, device=dev, generator=gen)
    zero = torch.rand(rows, device=dev, generator=gen) < 0.2
    return torch.where(zero[:, None, None], torch.zeros_like(x), x)


def k2_pairs(x, sten, pid, src):
    """Occupied slots (wxp ≠ 0) of the panels ``pid`` whose sources lie in
    the blocks ``src``, and (occupied slot, channel whose source feature is
    not at the origin) pairs: the work K2 does, forward or backward."""
    TB = sten.shape[-1]
    occ = (sten[pid.long(), 3] != 0) | (sten[pid.long(), 4] != 0)
    nzc = (x.abs() >= EPS).any(-1).sum(-1)               # (rows,)
    src_rows = (src.long()[:, None] * TB
                + torch.arange(TB, device=x.device))     # (P, TBs)
    return (int(occ.sum().item()),
            int((occ.sum(1) * nzc[src_rows]).sum().item()),
            occ.numel())


def k2_bound(x, sten, meta, n_bins):
    """Least time for one K2 call: bytes (x, the stencil and meta read
    once, the grid written once) over HBM rate, and the f32 operations this
    data needs over the f32 rate: K2_FLOPS_PER_PAIR per (occupied slot,
    channel whose source feature is not at the origin), plus 2 per
    occupied slot for r·e^{iθ}."""
    rows, C = x.shape[0], x.shape[1]
    edges, pairs, slots = k2_pairs(
        x, sten, torch.arange(sten.shape[0], device=x.device), meta[1])
    w2 = (2 * n_bins + 1) ** 2
    nbytes = 4 * (x.numel() + sten.numel() + meta.numel()
                  + rows * 2 * w2 * C)
    return _bound(nbytes, K2_FLOPS_PER_PAIR * pairs + 2 * edges,
                  edges=edges, pairs=pairs, slot_fill=edges / max(1, slots))


def k2_bwd_bound(dg, x, sten, meta_s):
    """Least time for one K2 backward call: bytes (dg, the stencil, meta_s
    and x read once, dx written once) over HBM rate, and the f32
    operations this data needs over the f32 rate: K2_BWD_FLOPS_PER_PAIR per
    (occupied slot, non-origin channel) of the panels in meta_s, plus 2
    per occupied slot for r·e^{iθ}."""
    edges, pairs, _ = k2_pairs(x, sten, meta_s[0], meta_s[2])
    nbytes = 4 * (dg.numel() + sten.numel() + meta_s.numel()
                  + 2 * x.numel())
    return _bound(nbytes, K2_BWD_FLOPS_PER_PAIR * pairs + 2 * edges,
                  edges=edges, pairs=pairs)


def k2_check(label, x, panel, n_bins):
    """K2 against its plain version, then a second call that must be
    bitwise equal."""
    nb = x.shape[0] // panel.tb
    args = (x, panel.sten, panel.meta, n_bins, nb)
    grid = echo_panel_grid(*args)
    torch.cuda.synchronize()
    ref = echo_panel_grid_reference(*args)
    err = (grid - ref).abs().max().item()
    scale = ref.abs().max().item()
    check(torch.isfinite(grid).all().item(), f"K2 {label}: non-finite grid")
    check(err <= K2_RTOL_SCALE * scale,
          f"K2 {label}: max abs err {err} > {K2_RTOL_SCALE} x {scale}")
    check(torch.equal(grid, echo_panel_grid(*args)),
          f"K2 {label}: two calls differ")
    print(f"K2 {label}: max abs err {err:.3e}, rel {err / scale:.3e} "
          f"(tolerance {K2_RTOL_SCALE} of max |grid| = {scale:.3e}); a "
          "second call is bitwise equal")
    return dict(shape=label, rows=x.shape[0], C=x.shape[1], n_bins=n_bins,
                panels=panel.n_panels, max_abs_err=err,
                max_rel_err=err / scale)


def k2_time(row, x, panel, n_bins):
    args = (x, panel.sten, panel.meta, n_bins, x.shape[0] // panel.tb)
    row["ms"] = time_cuda(lambda: echo_panel_grid(*args), iters=20)
    row["plain_ms"] = time_cuda(lambda: echo_panel_grid_reference(*args),
                                iters=2, reps=3)
    row.update(k2_bound(*args[:4]))


def k2_bwd_inputs(x, n_bins, TB, gen):
    """A random cotangent of K2's grid for features x, contiguous
    (nb, 2w², C, TB), and the same values in the layout autograd hands the
    backward (cells minor: the transpose of the fold's input)."""
    nb, C = x.shape[0] // TB, x.shape[1]
    dg = torch.randn(nb, 2 * (2 * n_bins + 1) ** 2, C, TB, device=x.device,
                     generator=gen)
    return dg, dg.permute(0, 3, 2, 1).contiguous().permute(0, 3, 2, 1)


def k2_bwd_check(label, dg, dg_cells_minor, x, panel, n_bins):
    """K2's backward against its plain version for both cotangent layouts,
    each then against a second call that must be bitwise equal."""
    args = (x, panel.sten, panel.meta_s, n_bins, x.shape[0] // panel.tb)
    ref = echo_panel_grid_bwd_reference(dg, *args)
    scale = ref.abs().max().item()
    err = 0.0
    for g in (dg, dg_cells_minor):
        dx = echo_panel_grid_bwd(g, *args)
        torch.cuda.synchronize()
        check(torch.isfinite(dx).all().item(), f"K2 bwd {label}: non-finite")
        err = max(err, (dx - ref).abs().max().item())
        check(torch.equal(dx, echo_panel_grid_bwd(g, *args)),
              f"K2 bwd {label}: two calls differ")
    check(err <= K2_RTOL_SCALE * scale,
          f"K2 bwd {label}: max abs err {err} > {K2_RTOL_SCALE} x {scale}")
    print(f"K2 bwd {label}: max abs err {err:.3e}, rel {err / scale:.3e} "
          f"(tolerance {K2_RTOL_SCALE} of max |dx| = {scale:.3e}), "
          "contiguous and cells-minor cotangents; a second call is bitwise "
          "equal")
    return dict(shape=label, rows=x.shape[0], C=x.shape[1], n_bins=n_bins,
                panels=panel.meta_s.shape[1], max_abs_err=err,
                max_rel_err=err / scale)


def k2_bwd_time(row, dg, dg_cells_minor, x, panel, n_bins):
    """ms: the cells-minor cotangent (what a training step passes);
    ms_contiguous beside it."""
    args = (x, panel.sten, panel.meta_s, n_bins, x.shape[0] // panel.tb)
    row["ms"] = time_cuda(lambda: echo_panel_grid_bwd(dg_cells_minor, *args),
                          iters=20)
    row["ms_contiguous"] = time_cuda(lambda: echo_panel_grid_bwd(dg, *args),
                                     iters=20)
    row["plain_ms"] = time_cuda(
        lambda: echo_panel_grid_bwd_reference(dg, *args), iters=2, reps=3)
    row.update(k2_bwd_bound(dg, x, panel.sten, panel.meta_s))


def top_two_gap(logits):
    """Per-row gap between the largest and second-largest logit."""
    part = np.partition(logits, -2, axis=-1)
    return part[..., -1] - part[..., -2]


def serve_echo_phase(serve, recs, batches, cpu_nets, configs):
    """The ECHO serving path, counted: each batch launches K1 9 / 17 times
    and K2 once, nothing else; outputs match the same Predictor on the
    CPU.  Returns the path's launch counts."""
    want_k1 = {"seg_n2048_b4": 9, "corr_n5120_b1": 17}
    for k, p in serve.items():
        p.warmup(batches[k])
    kernels.reset_launches()
    served = {}
    for k, p in serve.items():
        before = dict(kernels.launches)
        served[k] = p.predict(recs[k], batches=batches[k])
        grew = {n: kernels.launches[n] - before.get(n, 0)
                for n in kernels.launches}
        grew = {n: c for n, c in grew.items() if c}
        want = {"band_fused_fwd": want_k1[k], "echo_panel_fwd": 1}
        check(grew == want, f"{k}: one batch launched {grew}, want {want}")
    launches = dict(kernels.launches)

    for k, p in serve.items():
        key = "labels" if p.config.task == "segmentation" else "map"
        cpu = Predictor(cpu_nets[k], configs[k], batch_size=p.batch_size,
                        banded_tb=TB, device="cpu").predict(recs[k])
        n_close = n_all = 0
        diff = 0.0
        for a, b, r in zip(served[k], cpu, recs[k]):
            check(a["logits"].shape == b["logits"].shape
                  == (r.n_samples, b["logits"].shape[1])
                  and np.isfinite(a["logits"]).all(),
                  f"{k}: bad logits {a['logits'].shape}")
            np.testing.assert_allclose(a["logits"], b["logits"],
                                       rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
            clear = top_two_gap(b["logits"]) > LABEL_GAP
            check((a[key][clear] == b[key][clear]).all(),
                  f"{k}: {key} differ from the CPU run at a vertex whose "
                  f"top-two gap exceeds {LABEL_GAP}")
            n_close += int((~clear).sum())
            n_all += len(clear)
            diff = max(diff, float(np.abs(a["logits"] - b["logits"]).max()))
        print(f"serve {k}: {key} match the CPU run at every vertex whose "
              f"top-two logit gap exceeds {LABEL_GAP} ({n_close} of {n_all} "
              f"vertices fall below it); max logit diff {diff:.3e} (rtol "
              f"{LOGIT_RTOL}, atol {LOGIT_ATOL})")
    return launches


def print_times(kind, rows, card):
    for r in rows:
        print(f"{kind} {r['shape']}: kernel {r['ms']:.4f} ms/call, plain "
              f"{r['plain_ms']:.4f} ms/call, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}; {r['bytes'] / 1e6:.1f} MB, "
              f"{r['flops'] / 1e9:.2f} GFLOP needed) on {card}")


def read_losses(path):
    with open(path) as f:
        return [json.loads(line)["loss"] for line in f]


def fit_phase(k, cfg, n_classes, recs, dev, seed, tmp):
    """fit ``cfg`` on the card (the main path, counted) for TRAIN_EPOCHS
    epochs and the first epoch of the same fit on the CPU, at training shape
    ``k``: ``recs`` holds the train records then the test records
    (TRAIN_FIT[k]).  Each step must launch K1's forward and backward
    K1_PER_PASS[k] times each and, for the ECHO presets, K2's forward and
    backward once each; each test batch the forward ones.  Returns the card
    run's net and optimizer."""
    n_train, bs, _ = TRAIN_FIT[k]
    train, test = recs[:n_train], recs[n_train:]
    ck = dataclasses.replace(cfg, epochs=TRAIN_EPOCHS, checkpoint_every=1,
                             checkpoint_dir=os.path.join(tmp, f"ck_{k}"))
    before = dict(kernels.launches)
    t0 = time.perf_counter()
    net, opt, metric = fit(ck, train, test, n_classes=n_classes,
                           batch_size=bs, banded_tb=TB,
                           log_path=os.path.join(tmp, f"{k}.jsonl"),
                           seed=seed, device=dev)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    grew = {n: c - before.get(n, 0) for n, c in kernels.launches.items()
            if c != before.get(n, 0)}
    steps = TRAIN_EPOCHS * n_train // bs
    passes = steps + -(-len(test) // bs)           # forward passes
    k1 = K1_PER_PASS[k]
    want = {"band_fused_fwd": k1 * passes, "band_fused_bwd": k1 * steps}
    if cfg.task != "classification":
        want.update(echo_panel_fwd=passes, echo_panel_bwd=steps)
    check(int(opt.step.item()) == steps,
          f"{k}: fit ran {opt.step} steps, want {steps}")
    check(grew == want, f"{k}: fit launched {grew}, want {want}")
    losses = read_losses(os.path.join(tmp, f"{k}.jsonl"))
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"{k}: card losses {losses}")
    latest = CheckpointManager(ck.checkpoint_dir).latest_step()
    check(latest == steps, f"{k}: latest checkpoint {latest}, want {steps}")
    check(np.isfinite(metric), f"{k}: test metric {metric}")

    cpu_cfg = dataclasses.replace(ck, epochs=1, checkpoint_dir=None)
    t0 = time.perf_counter()
    fit(cpu_cfg, train, None, n_classes=n_classes, batch_size=bs,
        banded_tb=TB, log_path=os.path.join(tmp, f"{k}_cpu.jsonl"),
        seed=seed, device="cpu")
    cpu_s = time.perf_counter() - t0
    cpu = read_losses(os.path.join(tmp, f"{k}_cpu.jsonl"))
    diffs = [abs(a - b) for a, b in zip(losses, cpu)]
    check(len(cpu) == steps // TRAIN_EPOCHS, f"{k}: cpu losses {cpu}")
    check(diffs[0] <= LOSS_ATOL_STEP1
          and all(d <= LOSS_ATOL_LATER for d in diffs[1:]),
          f"{k}: card losses {losses} against CPU {cpu}")
    what = ("test cross entropy" if cfg.task == "correspondence"
            else "test accuracy")
    print(f"train {k}: fit on the card, {steps} steps of batch {bs} "
          f"({fit_s:.1f} s with table builds and the test pass), losses "
          f"{losses}, launches {grew}, checkpoint at step {latest}; {what} "
          f"{metric:.4f} (random labels)")
    print(f"train {k}: the first {len(cpu)} losses match the CPU fit ({cpu}, "
          f"{cpu_s:.1f} s): |diff| {diffs} (step 1 within {LOSS_ATOL_STEP1}, "
          f"later within {LOSS_ATOL_LATER})")
    return net, opt


def conv_fwd_bwd(banded, dev, gen, C=32, B=2, R=6, n_convs=5):
    """fn() running forward and backward of n_convs C→C field convolutions
    (ftype 1) over ``banded``, as bench.py times one."""
    N = banded.n_pad
    x = torch.randn(1, N, C, 2, device=dev, generator=gen).requires_grad_()
    shapes = ((C, C, R), (C, C, R, B, 2), (C, C, B + 1))
    filters = [[(0.2 * torch.randn(sh, device=dev, generator=gen))
                .requires_grad_() for sh in shapes] for _ in range(n_convs)]
    dy = torch.randn(1, N, C, 2, device=dev, generator=gen)

    def run():
        ys = [field_conv_banded(x, banded, *f, 1) for f in filters]
        torch.autograd.backward(ys, [dy] * n_convs)

    return run


# --- main ------------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"card: {card}")

    # 1. build
    t0 = time.perf_counter()
    kernels.build_all()
    print(f"built {sorted(kernels.build_logs) or 'nothing (up to date)'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in kernels.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  nvcc {name}: {line.strip()}")

    rng = np.random.default_rng(args.seed)
    config = PRESETS["classification"]
    small = shrec_records(rng, config.epsilon)
    large = large_record(rng, config.epsilon)
    train_recs = shrec_records(rng, config.epsilon) + shrec_records(
        rng, config.epsilon)
    test_recs = shrec_records(rng, config.epsilon)

    net = build_model(config, N_CLASSES,
                      generator=torch.Generator().manual_seed(args.seed),
                      device=dev)
    serve = {
        "shrec11_b8": Predictor(net, config, batch_size=8, banded_tb=TB,
                                device=dev),
        "n8192_b1": Predictor(net, config, batch_size=1, banded_tb=TB,
                              device=dev),
    }
    recs = {"shrec11_b8": small, "n8192_b1": [large]}
    batches = {}
    for k, p in serve.items():
        t0 = time.perf_counter()
        batches[k] = p.make_batches(recs[k])
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        check(len(batches[k]) == 1, f"{k}: expected one batch")
        b = batches[k][0]
        print(f"request {k}: {b.pos.shape[0]} meshes, n_pad {b.pos.shape[1]}"
              f", D {b.table.d_slots}, nh {b.banded.nh}, "
              f"{int(b.table.mask.sum().item())} edges; tables built on the "
              f"host and placed in {build_s:.3f} s")

    # the ECHO presets on the mixed route, random weights from the seed
    echo_cfg = {"seg_n2048_b4": PRESETS["segmentation"],
                "corr_n5120_b1": PRESETS["correspondence"]}
    echo_classes = {"seg_n2048_b4": 8, "corr_n5120_b1": 4999}
    echo_recs = {
        "seg_n2048_b4": echo_records(rng, 2048, 4, echo_cfg[
            "seg_n2048_b4"].epsilon, 8, "seg"),
        "corr_n5120_b1": echo_records(rng, 5120, 1, echo_cfg[
            "corr_n5120_b1"].epsilon, 4999, "corr"),
    }
    # their training records: train then test, per TRAIN_FIT
    echo_train_recs = {
        k: echo_records(rng, n, sum(TRAIN_FIT[k][::2]), echo_cfg[k].epsilon,
                        echo_classes[k], f"{k}_train")
        for k, n in (("seg_n2048_b4", 2048), ("corr_n5120_b1", 5120))}
    echo_nets, echo_cpu_nets, echo_serve, echo_batches = {}, {}, {}, {}
    for i, (k, cfg) in enumerate(echo_cfg.items()):
        echo_nets[k] = build_model(
            cfg, echo_classes[k],
            generator=torch.Generator().manual_seed(args.seed + 10 + i),
            device=dev)
        echo_cpu_nets[k] = build_model(cfg, echo_classes[k], device="cpu")
        echo_cpu_nets[k].load_state_dict(
            {n: v.cpu() for n, v in echo_nets[k].state_dict().items()})
        echo_serve[k] = Predictor(echo_nets[k], cfg,
                                  batch_size=len(echo_recs[k]), banded_tb=TB,
                                  device=dev)
        t0 = time.perf_counter()
        echo_batches[k] = echo_serve[k].make_batches(echo_recs[k])
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        check(len(echo_batches[k]) == 1, f"{k}: expected one batch")
        b = echo_batches[k][0]
        check(b.panel is not None and b.comp is None,
              f"{k}: not the mixed route")
        print(f"request {k}: {b.pos.shape[0]} meshes, n_pad "
              f"{b.pos.shape[1]}, D {b.table.d_slots}, nh {b.banded.nh}, "
              f"{b.panel.n_panels} panels, "
              f"{int(b.table.mask.sum().item())} edges; tables built on the "
              f"host and placed in {build_s:.3f} s")

    # 2. K1 forward and backward against their plain versions at the
    # shapes serving and training give them
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    C, R = config.nf, config.n_rings
    rows, bwd_rows, timed, bwd_timed = [], [], [], []
    for label, key, O2 in (("n8192 (bench.py shape)", "n8192_b1", 2 * C),
                           ("shrec11 b8 (conv_out)", "shrec11_b8",
                            2 * N_CLASSES)):
        bt = batches[key][0].banded
        g, wmat = k1_inputs(bt.sten_band, R, C, O2, gen)
        dy = torch.randn(g.shape[0], g.shape[1], O2, device=dev,
                         generator=gen)
        rows.append(k1_check(label, g, bt.sten_band, wmat, TB, bt.nh))
        timed.append((rows[-1], g, bt.sten_band, wmat, TB, bt.nh))
        bwd_rows.append(k1_bwd_check(label, g, bt.sten_band, wmat, dy, TB,
                                     bt.nh))
        bwd_timed.append((bwd_rows[-1], g, bt.sten_band, wmat, dy, TB,
                          bt.nh))
    dense = torch.rand(8, 5, R + 4 * config.band_limit + 2, TB, 9 * TB,
                       device=dev, generator=gen)
    g, wmat = k1_inputs(dense, R, C, 2 * N_CLASSES, gen)
    dy = torch.randn(8, 5 * TB, 2 * N_CLASSES, device=dev, generator=gen)
    label = "n640 b8 nh=4 dense random stencil"
    rows.append(k1_check(label, g, dense, wmat, TB, 4))
    bwd_rows.append(k1_bwd_check(label, g, dense, wmat, dy, TB, 4))
    del dense, g, wmat, dy
    # K1 forward and backward at the ECHO nets' widths, on their own
    # stencils
    for key, C_, O2 in (("seg_n2048_b4", 48, 96), ("corr_n5120_b1", 16, 64),
                        ("corr_n5120_b1", 32, 32), ("corr_n5120_b1", 16, 24),
                        ("corr_n5120_b1", 32, 64)):
        bt = echo_batches[key][0].banded
        g, wmat = k1_inputs(bt.sten_band, bt.n_rings, C_, O2, gen)
        label = f"{key} C={C_} O2={O2}"
        rows.append(k1_check(label, g, bt.sten_band, wmat, TB, bt.nh))
        dy = torch.randn(g.shape[0], g.shape[1], O2, device=dev,
                         generator=gen)
        bwd_rows.append(k1_bwd_check(label, g, bt.sten_band, wmat, dy, TB,
                                     bt.nh))
        del g, wmat, dy

    # 3. K2 against its plain version on the records' own panels
    k2_rows, k2_timed = [], []
    for key, C_ in (("seg_n2048_b4", 48), ("corr_n5120_b1", 12)):
        panel = echo_batches[key][0].panel
        n_bins = echo_cfg[key].n_bins
        x = k2_inputs(panel, C_, gen)
        k2_rows.append(k2_check(f"{key} C={C_} n_bins={n_bins}", x, panel,
                                n_bins))
        k2_timed.append((k2_rows[-1], x, panel, n_bins))
    k2b_rows, k2b_timed = [], []
    for row, x, panel, n_bins in k2_timed:
        dg, dg_cm = k2_bwd_inputs(x, n_bins, TB, gen)
        k2b_rows.append(k2_bwd_check(row["shape"], dg, dg_cm, x, panel,
                                     n_bins))
        k2b_timed.append((k2b_rows[-1], dg, dg_cm, x, panel, n_bins))

    # 4. serving: the slice-1 path, counted
    for p, bs in zip(serve.values(), batches.values()):
        p.warmup(bs)
    kernels.reset_launches()
    served = {}
    for k, p in serve.items():
        before = kernels.launches["band_fused_fwd"]
        served[k] = p.predict(recs[k], batches=batches[k])
        grew = kernels.launches["band_fused_fwd"] - before
        check(grew == 5, f"{k}: K1 launched {grew} times for one batch, "
                         "want 5")
    serve_launches = dict(kernels.launches)
    check(serve_launches == {"band_fused_fwd": 10},
          f"serving launched {serve_launches}, want 10 K1 forward")

    cpu_net = build_model(config, N_CLASSES, device="cpu")
    cpu_net.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    for k, p in serve.items():
        cpu = Predictor(cpu_net, config, batch_size=p.batch_size,
                        banded_tb=TB, device="cpu").predict(recs[k])
        for a, b in zip(served[k], cpu):
            check(a["logits"].shape == (N_CLASSES,)
                  and np.isfinite(a["logits"]).all(),
                  f"{k}: bad logits {a['logits']}")
            check(a["class"] == b["class"],
                  f"{k}: class {a['class']} on the card, {b['class']} on CPU")
            np.testing.assert_allclose(a["logits"], b["logits"],
                                       rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
        diff = max(float(np.abs(a["logits"] - b["logits"]).max())
                   for a, b in zip(served[k], cpu))
        print(f"serve {k}: classes {[o['class'] for o in served[k]]} match "
              f"the CPU run; max logit diff {diff:.3e} (rtol {LOGIT_RTOL}, "
              f"atol {LOGIT_ATOL})")

    # 5. serving the ECHO presets: the slice-3 path, counted
    echo_launches = serve_echo_phase(echo_serve, echo_recs, echo_batches,
                                     echo_cpu_nets, echo_cfg)

    # 6. and 7. training: the slice-2 path (classification) and the slice-4
    # path (the ECHO presets), each counted
    fits = {"shrec11_b8": (config, N_CLASSES, train_recs + test_recs)}
    fits.update((k, (echo_cfg[k], echo_classes[k], echo_train_recs[k]))
                for k in echo_cfg)
    trained, train_launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for path, keys in (("train", ["shrec11_b8"]),
                           ("train_echo", list(echo_cfg))):
            kernels.reset_launches()
            for k in keys:
                trained[k] = fit_phase(k, *fits[k], dev, args.seed, tmp)
            train_launches[path] = dict(kernels.launches)

    # 8. timing
    for args_ in timed:
        k1_time(*args_)
    for args_ in k2_timed:
        k2_time(*args_)
    print_times("K2", k2_rows, card)
    for r in k2_rows:
        print(f"K2 {r['shape']}: {r['panels']} panels, {r['edges']} edges "
              f"(slot fill {r['slot_fill']:.3f}), {r['pairs']} (edge, "
              "non-origin channel) pairs")
    for args_ in k2b_timed:
        k2_bwd_time(*args_)
    print_times("K2 bwd", k2b_rows, card)
    for r in k2b_rows:
        print(f"K2 bwd {r['shape']}: {r['ms_contiguous']:.4f} ms/call for a "
              f"contiguous cotangent ({r['ms']:.4f} cells minor, as a "
              f"training step passes it) on {card}")
    for args_ in bwd_timed:
        k1_bwd_time(*args_)
    print_times("K1", rows[:2], card)
    for r in rows[:2]:
        print(f"K1 {r['shape']}: {r['dense_flops'] / 1e9:.2f} GFLOP dense, "
              f"slot fill {r['slot_fill']:.3f}, {r['rings_per_slot']:.2f} "
              "nonzero rings per occupied slot")
    print_times("K1 bwd", bwd_rows[:2], card)
    for r, g, sten, wmat, dy, tb, nh in bwd_timed:
        def bwd_synced():
            band_fused_bwd(dy, g, sten, wmat, tb, nh)
            torch.cuda.synchronize()

        _, busy, kern = request_breakdown(bwd_synced, top=8)
        r["passes_ms"] = {kernel_name(name): t for t, name, _ in kern}
        print(f"K1 bwd {r['shape']} by pass under the profiler: "
              f"{r['passes_ms']} (device busy {busy:.3f} ms)")
    requests = [(k, p, recs[k], batches[k], "5 K1 launches")
                for k, p in serve.items()]
    requests += [(k, p, echo_recs[k], echo_batches[k],
                  f"{9 if k.startswith('seg') else 17} K1 + 1 K2 launches")
                 for k, p in echo_serve.items()]
    for k, p, rs_, bs_, what in requests:
        ms = time_host(lambda: p.predict(rs_, batches=bs_))
        print(f"request {k}: {ms:.3f} ms per request (forward over placed "
              f"tables, {what}) on {card}")
        wall, busy, kern = request_breakdown(
            lambda: p.predict(rs_, batches=bs_))
        print(f"request {k} under the profiler: wall {wall:.3f} ms, device "
              f"busy {busy:.3f} ms ({100 * busy / wall:.1f}%) on {card}; "
              "top kernels:")
        for t, name, count in kern:
            print(f"    {t:8.3f} ms  x{count:<4d} {name[:90]}")

    for k, (tnet, topt) in trained.items():
        cfg, n_classes, recs_ = fits[k]
        bs = TRAIN_FIT[k][1]
        n_pad, d_slots = shared_bucket(recs_)
        tbatch = make_batches(recs_[:bs], cfg, bs, TB, n_pad, d_slots,
                              device=dev)[0]
        step = make_train_step(tnet, cfg, n_classes, topt)
        # the augmentation, and the correspondence net's dropout masks
        step_gen = torch.Generator().manual_seed(args.seed + 3)

        def train_step():
            step(tbatch, step_gen)
            torch.cuda.synchronize()

        k1 = K1_PER_PASS[k]
        what = f"{k1} K1 fwd + {k1} K1 bwd" + (
            "" if cfg.task == "classification" else " + 1 K2 fwd + 1 K2 bwd")
        ms = time_host(train_step)
        print(f"train step {k}: {ms:.3f} ms per step (host clock, ending in "
              f"a sync; {what} launches) on {card}")
        wall, busy, kern = request_breakdown(train_step)
        print(f"train step {k} under the profiler: wall {wall:.3f} ms, "
              f"device busy {busy:.3f} ms ({100 * busy / wall:.1f}%) on "
              f"{card}; top kernels:")
        for t, name, count in kern:
            print(f"    {t:8.3f} ms  x{count:<4d} {name[:90]}")

    big = batches["n8192_b1"][0]
    edges = int(big.table.mask.sum().item())
    convs = conv_fwd_bwd(big.banded, dev, gen)
    ms = time_cuda(convs, iters=5)
    print(f"five convs fwd+bwd at bench.py's shape (N=8192, D=128, C=O=32, "
          f"tb=128): {ms:.3f} ms, {5 * edges / (ms / 1e3):.4g} edges/s on "
          f"{card}")

    def convs_synced():
        convs()
        torch.cuda.synchronize()

    wall, busy, kern = request_breakdown(convs_synced)
    print(f"five convs fwd+bwd under the profiler: wall {wall:.3f} ms, "
          f"device busy {busy:.3f} ms ({100 * busy / wall:.1f}%), "
          f"{5 * edges / (busy / 1e3):.4g} edges per device-busy second; "
          "top kernels:")
    for t, name, count in kern:
        print(f"    {t:8.3f} ms  x{count:<4d} {name[:90]}")

    paths = {"serve": serve_launches, "serve_echo": echo_launches,
             **train_launches}

    def entry(name, source, replaces, rs):
        by_path = {k: v.get(name, 0) for k, v in paths.items()}
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": rs[0]["ms"], "plain_ms": rs[0]["plain_ms"],
            "bound_ms": rs[0]["bound_ms"], "bound_by": rs[0]["bound_by"],
            "library_ms": None,
            "shapes": rs,
        }

    line = {"kernels": [
        entry("band_fused_fwd", "fieldconv_tpu_torch/csrc/band_fused_fwd.cu",
              "fieldconv_tpu/ops/pallas/band_conv.py:1609", rows),
        entry("band_fused_bwd", "fieldconv_tpu_torch/csrc/band_fused_bwd.cu",
              "fieldconv_tpu/ops/pallas/band_conv.py:1642", bwd_rows),
        entry("echo_panel_fwd", "fieldconv_tpu_torch/csrc/echo_panel_fwd.cu",
              "fieldconv_tpu/ops/pallas/echo_panel.py:408", k2_rows),
        entry("echo_panel_bwd", "fieldconv_tpu_torch/csrc/echo_panel_bwd.cu",
              "fieldconv_tpu/ops/pallas/echo_panel.py:443", k2b_rows),
    ]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
