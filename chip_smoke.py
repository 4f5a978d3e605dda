"""Smoke run of the PyTorch port (fieldconv_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root
    python3 chip_smoke.py --graph-parallel   # phase 7h alone, every card

Phases, any failure exits non-zero:
  1. build every CUDA kernel from csrc/ (one nvcc per source, all at once)
     and print the card's name and power limit;
  2. hold K1's forward and backward kernels (fused banded field conv, on
     the pipelined panel walk) against their plain PyTorch
     versions on the card: at the two classification serving shapes, on
     the real stencils of the records below, and on a dense random stencil
     with nh=4 that reaches past both ends of g (each way also bitwise
     equal on a second call); both also at the widths the ECHO nets give
     them (C=48/O2=96, and K=3, R=3 with C=16/32 and O2=24/32/64), timed
     in phase 8 at C=48/O2=96 and C=32/O2=64 as at the serving shapes, the
     backward profiled by pass at n8192 and at C=48;
  3. hold K2's forward and backward (panel ECHO) against their plain
     versions on the records' own panel tables, with features of which
     ~20% of rows are zero, at n_bins 3 (C=48) and 2 (C=12, and the
     forward also on the 163,842-sample table below), and bitwise against
     a second call; the backward for a contiguous cotangent and for one in
     the layout autograd hands over (cells minor); then hold K5's forward
     (panel conv) against its plain version and bitwise against a second
     call: on the 163,842-sample table at the correspondence net's four
     widths (C=16/32, O2=24/32/64, K=3, R=3) and at the segmentation
     width (C=48, O2=96, K=5, R=6), on the segmentation records' table
     forced onto the panel layout at that width, and on
     the 5120-sample record's table with dense planes, with chunk=4 and
     read with n_rings=6 (the MATCHING preset's K=3, R=6);
  3c. hold K5's backward (dg and dw) against its plain version and bitwise
     against a second call: on the 163,842-sample table at the four
     correspondence widths, on the forced segmentation table at C=48,
     O2=96, K=5, R=6, and on the 5120-sample tables with dense planes,
     with chunk=4 and read with n_rings=6;
  3d. hold K6's forward (compact conv) and K7's forward (compact ECHO)
     against their plain versions and bitwise against a second call, and
     time them: K6 on the 163,842-sample CompactPanelTable (TBt 32, TS 128)
     at the correspondence net's four widths, on the segmentation
     records' compact table (TBt 128) at C=48, O2=96, K=5, R=6, and on the
     5120-sample all-compact table read with n_rings=6 (K=3, R=6); K7 on
     the 163,842-sample table at C=12, n_bins 2 and on the segmentation
     table at C=48, n_bins 3;
  3e. hold K6's backward (dg after the fold, and dw) against its plain
     version and the plain fold and bitwise against a second call, on the
     163,842-sample compact table at the four correspondence widths, on
     the segmentation records' compact table at TBt 32 (C=48, O2=96, K=5,
     R=6) and on the 5120-sample all-compact table read with n_rings=6;
     K7's backward the same way on the 163,842-sample table (C=12,
     n_bins 2) and on the segmentation batch's mixed-route table (TBt 128,
     C=48, n_bins 3), for a contiguous and a cells-minor cotangent; the
     compact lift's backward (the fold alone) against autograd of its
     plain source sums, and the fold against index_add_; each timed;
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
  5b. serve the CORRESPONDENCE preset on the pure-panel layout (every op
     over one compressed PanelTable, the convs through K5) with the
     correspondence net's weights: the 5120-sample record forced there
     (layout="panel"), held against the CPU, and one
     mesh of 163,842 samples (a Fibonacci sphere of area 1 in kd_order,
     ε-ball graph with ε = sqrt(64/(πN)), the size of scripts/
     train_100k.py) that layout="auto" sends there by itself: logits
     finite, of shape (163842, 4999).  Each request must launch K5 17
     times and K2 once, and K1 never;
  5c. serve the compact route: the 5120-sample record forced onto the
     pure-panel layout with echo_impl="compact" (17 K5 + 1 K7) and with
     conv_impl="compact" too (17 K6 + 1 K7), the segmentation batch on the
     mixed route with echo_impl="compact" (9 K1 + 1 K7), each held against
     the CPU, and the 163,842-sample record both ways (its compact table
     built from the serving batch's EdgeTable at TBt 32): logits finite, of
     shape (163842, 4999), exact launches and no K2;
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
  7b. train the CORRESPONDENCE preset on the pure-panel layout: the 5120
     training records forced there (layout="panel"), held against the CPU
     fit as in 6, then fit(banded_tb=128, batch_size=1, device="cuda") on
     the 163,842-sample record of 5b for 3 steps (the preset's 60 epochs
     cut to 3), testing on 5b's batch of the same record.  Each step must
     launch K5's forward and backward 17 times each, K2's forward and
     backward once each and K1 never; each test batch K5's forward 17
     times and K2's once; losses finite;
  7c. train on the compact route: the 5120 training records forced onto
     the pure-panel layout with echo_impl="compact" (17 K5 + 1 K7, forward
     and backward, per step) and with conv_impl="compact" too (17 K6 + 1
     K7), and the segmentation records on the mixed route with the compact
     ECHO (9 K1 + 1 K7), each held against the CPU fit as in 6, no K2; one
     make_train_step step on the 163,842-sample batch of 5c (17 K5 + 1 K7).
     The fold runs as the last pass of every K6 and K7 backward;
  8. time the kernels and their plain versions (K1 and, below 5 ms a
     call, K5 also by the host's cost to enqueue a call), each request
     shape (at
     163,842 samples also Predictor.logits alone and the peak device
     memory), a training step at each training shape (at 163,842 samples,
     on the block panels and with the compact ECHO, also the peak device
     memory, and one step of a net built with remat_blocks on the block
     panels), and one forward and backward of five convs at bench.py's
     shape; then, once the block-panel table is freed, the all-compact
     163,842-sample request and the rest of 7c (its launches counted into
     7c's): fit all-compact on the 163,842-sample record for 3 steps,
     testing on 5c's batch of the same record (17 K6 + 1 K7 per step),
     and time its step as above, with a remat_blocks step; the profiles
     of that request and step list K6's kernels by pass (contrib, filter,
     dW, dc, dG, fold);
  9. print the kernels line, the card line and the result line.

The compressed banded layout (each phase's checks hold):
  2b. hold K4's forward and backward (compressed banded conv) against their
     plain versions (1e-4 of each output's scale; the backward bitwise
     against a second call) on the compressed tables of the 8192-sample
     record (C=32, O2=64, K=5, R=6), of the segmentation batch (C=48,
     O2=96) and of the correspondence record at its four widths (K=3,
     R=3), each also against K1 on the dense table of the same EdgeTable,
     and on a random compressed table with nh=4 that reaches past both ends
     of g; K3's forward and backward (the unfused contrib) the same way on
     the dense tables; field_conv_banded(fuse_filters=False) against the
     fused conv on y and every gradient; each timed beside its plain
     version and its bound;
  5d. path A: serve the segmentation batch and the correspondence record
     with echo_impl="banded" (9 / 17 K1 launches a request and nothing
     else: the banded ECHO and lift are plain torch over the batch's
     CompressedBandedTable), each against the CPU;
  5e. path B: the same batches with the compressed table as the conv table
     (batch.banded = batch.comp: 9 / 17 K4 launches, no K1), against the
     CPU;
  7d. fit both presets with echo_impl="banded" as in 7 (9 / 17 K1 each way
     per step), the first epoch against the CPU's;
  7e. on the serving batches, the loss and every gradient of paths A and
     B against the CPU's (each within 1e-4 of its own scale, or 10x the
     CPU's path A against its path B where that is larger), then one
     make_train_step step on path B (9 / 17 K4 each way);
  8. also times path A's and path B's requests and steps, and five convs
     unfused at bench.py's shape (path C: 5 K3 each way).

The block-sparse banded layout (each phase's checks hold):
  2c. hold K8's forward and backward (block-sparse banded conv) against
     their plain versions (1e-4 of each output's scale; both directions
     bitwise against a second call) on the block-sparse tables of the
     8192-sample record (C=32, O2=64, K=5, R=6), of the segmentation batch
     (C=48, O2=96) and of the correspondence record at its four widths
     (K=3, R=3), each built from its batch's own EdgeTable and also held
     against K1 on the dense table of the same EdgeTable, and on two random
     tables whose lists are shuffled, repeat no block and carry padding
     entries; each timed beside its plain version and its bound;
  5f. path D: the same serving batches with their block-sparse tables as
     the conv table (batch.banded = the table: 9 / 17 K8 + 1 K2 a request,
     no K1), each against the CPU; then the 163,842-sample request of 5b
     with its block-sparse table, built after the K5 request from the
     serving batch's EdgeTable and first held as in 2c at the four
     correspondence widths: 17 K8 + 1 K2, no K5, its logits held against
     the same request on K5's route on the card;
  7f. on the serving batches, the loss and every gradient of paths A (K1)
     and D (K8) against the CPU's (as in 7e; the lift's zonalMag against
     the CPU's plus the term that the subgradient of |M| gives at the
     entries of the lift's magnitude sum M whose sign differs between the
     card and the CPU, route_check, lift_flip_term), then one
     make_train_step step on path D (9 / 17 K8 + 1 K2 each way); at
     163,842 the first step's
     loss and gradients on path D against K5's route on the card (each
     gradient's bar widened by K5's route against the all-compact route
     on the card, or by the corr_n5120_b1 spread relative to its scale),
     then 3 make_train_step steps (17 K8 + 1 K2 each way a step);
  8. also times path D's requests and steps (at 163,842 with the peak
     device memory) and five convs over n8192's block-sparse table (path
     E: 5 K8 each way), then frees the 163k block-sparse table before the
     all-compact request.

The bf16 panel stencils (precomp/banded.py::cast_panel_sten; each phase's
checks hold):
  3f. K5, K6, K2 and K7, each way, on the cast seg_n2048_b4 tables and on
     the cast corr_n5120_b1 pure-panel and all-compact tables, against
     their plain versions and bitwise against a second call; timed on the
     163,842-sample tables cast on the card (K2 on corr_n5120_b1's), the
     bounds counting the stencil at 2 bytes;
  5g. serve the corr_n5120_b1 record on cast tables, on the mixed route
     (17 K1 + 1 K2, the bf16 panel lift) and with the compact ECHO on the
     pure-panel layout (17 K5 + 1 K7), counted, each against the CPU on the
     same cast tables;
  7g. the pure-panel route's and the mixed route's loss gradients bitwise
     equal across two runs; scripts/train_100k.py's training at 163,842
     samples (fieldconv_tpu_torch/scripts/train_100k.py::train) on the
     cast tables for 3 steps (K5 convs, K7 and the compact lift at TBt 32;
     each step 33 K5 forward with remat_blocks), all-compact for 2 (K6,
     K7) and without the compact table for 1 (K5, K2 and the panel lift
     on the cast block panels), counted, losses finite; each route's step peak above what it
     held no more than on the f32 tables; one cast request on K5's route
     against the all-compact route (logits within the bar of path D's at
     163,842), and its logits against the f32 tables';
  8. also times the cast request and a train_100k step on the f32 and on
     the cast tables.

Graph-parallel training (parallel/; K9, the halo conv; each phase's checks
hold):
  2d. K9 each way against its plain version (1e-4 of each output's scale,
     the backward bitwise against a second call) on the dense bands of the
     segmentation batch (C=48, O2=96) and of the 8192-sample record (C=32,
     O2=64), each split into 2 and into 4 shards whose halo rows are sliced
     from the global g on the card: every launch of the serial path and of
     the overlapped one (interior, head, tail), K9's contrib each way on
     the serial launches, and the shards joined (y, dG with the halo
     cotangents returned, dW summed) against K1 on the global table (1e-5
     of scale; whether bitwise is printed); shard 0 of each 2-way split
     timed beside its plain version and its bound: its serial launch and
     the overlapped path's interior and head launches apart, each with the
     host's µs to enqueue a call;
  7h. graph-parallel training over torch.distributed ranks spawned on the
     card (parallel/distributed.py::spawn; gloo, each halo through host
     memory, unless every rank has a card of its own: then NCCL), 3
     make_gp_train_step steps each from the weights of a single-process
     make_train_step run on the card of the same batch and augmentation:
     the SEGMENTATION preset at full width with the banded ECHO on the
     seg_n2048_b4 serving batch over (n_data, n_graph) = (1, 2) (8 blocks a
     shard: the overlapped path), and the CLASSIFICATION preset with the
     banded lift on the SHREC11-sized batch padded to 768 rows over (2, 2)
     (3 blocks a shard, nh 2: the serial path), then five unfused convs
     over each rank's shard (K9's contrib each way).  Losses within 2e-4
     relative of the single-process run's, the step-1 gradients within
     route_check's bars (the segmentation preset's widened by 7e's rounding
     spread), every rank's parameters bitwise equal after every step, the
     exact K9 launches, the convs' exchanged bytes equal to
     parallel/comm_model.py::conv_halo_bytes for the rank's neighbours;
     step times on the host clock, labelled with the ranks, cards and
     backend (not a scaling figure); one more segmentation step, rank 0's
     under the profiler: its device busy time, K9's share of it by pass,
     the top kernels.

The CPU is the script's bottleneck (8 cores of the host; the plain
versions are slow there), so it computes each CPU reference once and
beside the card's phases:
  - the kernels build (one nvcc per source) in a thread while the records
    and tables are built;
  - the CPU's side of the first-epoch checks of 6-7d (fit(device="cpu"),
    one per preset: the fit of every route of a preset is held against
    its preset's, on the same records, batch size and seed) and of the
    route checks of 7e and 7f (route_cpu) runs in two worker processes,
    started with the records and stopped with the script;
  - every serving route of an ECHO preset at 5-5f is held against one CPU
    run of that preset on its own route (the bf16 tables against their
    own).

Records are synthetic, built with numpy from --seed by
fieldconv_tpu_torch/data/synthetic.py, in the manner of
bench.py::build_synthetic_tables: unique sources within ±bandwidth of each
target (the locality RCM ordering gives real meshes), log-map radius in
[0, ε], random unit transports.  Nothing of JAX is imported.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import multiprocessing as mp
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch

from fieldconv_tpu_torch import kernels
from fieldconv_tpu_torch.data.base import shared_bucket
from fieldconv_tpu_torch.data.synthetic import (random_block_sparse,
                                                sphere_record,
                                                synthetic_record)
from fieldconv_tpu_torch.deploy import Predictor
from fieldconv_tpu_torch.ops.band_conv import (_hats_from_r, _panel_pairs,
                                               band_cfused_bwd,
                                               band_cfused_bwd_reference,
                                               band_cfused_fwd,
                                               band_cfused_reference,
                                               band_compact_bwd,
                                               band_compact_bwd_reference,
                                               band_compact_fwd,
                                               band_compact_fwd_reference,
                                               band_contrib_bwd,
                                               band_contrib_bwd_reference,
                                               band_contrib_fwd,
                                               band_contrib_reference,
                                               band_fused_bwd,
                                               band_fused_bwd_reference,
                                               band_fused_fwd,
                                               band_fused_fwd_reference,
                                               band_panel_bwd,
                                               band_panel_bwd_reference,
                                               band_panel_fwd,
                                               band_panel_fwd_reference,
                                               band_sparse_bwd,
                                               band_sparse_bwd_reference,
                                               band_sparse_fwd,
                                               band_sparse_reference,
                                               field_conv_banded,
                                               rotated_source_tensor_kmajor)
from fieldconv_tpu_torch.ops.compact_fold import (compact_fold,
                                                  compact_fold_reference)
from fieldconv_tpu_torch.ops.echo_panel import (echo_compact_grid,
                                                echo_compact_grid_bwd,
                                                echo_compact_grid_bwd_reference,
                                                echo_compact_grid_reference,
                                                echo_panel_grid,
                                                echo_panel_grid_bwd,
                                                echo_panel_grid_bwd_reference,
                                                echo_panel_grid_reference)
from fieldconv_tpu_torch.ops.field_conv import (apply_filters,
                                                filter_coefficients)
from fieldconv_tpu_torch.precomp.banded import (build_block_sparse_banded,
                                                build_compact_panel_table,
                                                build_compressed_banded,
                                                build_panel_table,
                                                cast_panel_sten,
                                                stack_block_sparse_tables)
from fieldconv_tpu_torch.parallel import comm_model, halo
from fieldconv_tpu_torch.parallel.distributed import make_layout, spawn
from fieldconv_tpu_torch.parallel.gp import (gp_batch, make_gp_train_step,
                                             make_gp_value_and_grad,
                                             place_gp_batch)
from fieldconv_tpu_torch.parallel.sharding import replicate
from fieldconv_tpu_torch.scripts import train_100k
from fieldconv_tpu_torch.ops.trans_field import (_compact_lift_agg_bwd,
                                                 _lift_sums, _runs,
                                                 lift_contribs)
from fieldconv_tpu_torch.train.checkpoint import CheckpointManager
from fieldconv_tpu_torch.train.config import PRESETS
from fieldconv_tpu_torch.train.loop import (build_model, evaluate_task, fit,
                                            make_batches, resolve_layout)
from fieldconv_tpu_torch.train.trainer import (draw_dropout_mask,
                                               draw_rotate_scale,
                                               make_loss_fn, make_optimizer,
                                               make_train_step)
from fieldconv_tpu_torch.utils.complexops import EPS, cpolar, soft_angle

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
# K5 against its plain version: f32 sums over a target's panels and slots
# in another order, and R·M = 576 (2880 at the segmentation width) filter
# terms; held to 1e-4 of the output's scale, and bitwise against a second
# call (one writer per output)
K5_RTOL_SCALE = 1e-4
# K5's backward the same way: dg sums over a source's panels and slots, dw
# over every target row, in another order; each held to 1e-4 of its own
# scale, and bitwise against a second call.  K6 (the compact conv) and K7
# (the compact ECHO) as K5 and K2: 1e-4 of the output's scale, and bitwise
# against a second call
# K4 (the compressed banded conv) and K3 (the unfused contrib) against
# their plain versions as K1: each output to 1e-4 of its scale, and every
# backward bitwise against a second call.  K4 against K1 on the dense table
# of the same EdgeTable: what tests/test_band_conv.py::
# test_compressed_matches_fused allows the JAX pair, y within 2e-5, the
# gradients within 3e-4 + 1e-3·|K1's| (the hats rebuilt from r in f32
# against the table's stored ones, and f32 sums in another order)
K4_RTOL_SCALE = K3_RTOL_SCALE = 1e-4
K4_K1_ATOL, K4_K1_GRAD = 2e-5, (3e-4, 1e-3)
# K8 (the block-sparse banded conv) against its plain version as K1: each
# output to 1e-4 of its scale, the backward bitwise against a second call;
# against K1 on the dense table of the same EdgeTable the same way (the
# same products, summed in another order where a block's list is not its
# window's order)
K8_RTOL_SCALE = 1e-4
# K9 (the halo conv) against its plain version as K1: each output to 1e-4
# of its scale, the backward bitwise against a second call.  The shards
# joined against K1 on the global table: each shard reads the same window
# values as K1 and sums them in K1's order, but a shard's boundary rows
# take dG from up to three launches added in turn, and dW sums over
# shards: 1e-5 of scale (f32 rounding of a few additions)
K9_RTOL_SCALE, K9_JOIN_RTOL = 1e-4, 1e-5
# graph-parallel fits: steps of make_gp_train_step, and their losses
# against the single-process make_train_step on the card (the sums of the
# pool, the loss and dW taken over ranks in another order, then one or two
# Adam updates: LOSS_ATOL_STEP1's rounding, relative)
GP_STEPS, GP_LOSS_RTOL = 3, 2e-4
# the pure-panel request at the repo's north-star size (BASELINE.json
# configs[4]: a correspondence mesh of 163,842 vertices, scripts/
# train_100k.py), under layout="auto"
N_LARGE = 163842
N_CORR_CLASSES = 4999
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
# loss gradients of paths A and B, card against CPU, per parameter: within
# 1e-4 of the parameter's own scale, or within GRAD_SPREAD times the spread
# between the CPU's two routes of the same function (path A's K1 and path
# B's K4 plain versions, whose conv outputs differ by rounding alone),
# whichever is larger.  The ECHO-block conv's gradient is small (~1e-9 at
# the segmentation width) and the two CPU routes already differ there by
# ~6e-3 of it (a likely cause: a rounding difference that moves a vote
# across a cell edge of ECHO's bilinear splat changes the derivative of
# its weights).  No bar may exceed GRAD_BAR_CAP of the parameter's own
# scale, so a gradient that is wrong outright fails.
GRAD_SPREAD, GRAD_BAR_CAP = 10.0, 0.25
# the lift's magnitude sums M (route_check, lift_flip_term): the card's
# within FLIP_GAP_REL of max|M| of the CPU's (f32 sums of C·R products,
# some tens of ulps; 1e-5 is 84 ulps of max|M|, a sign fault in M moves it
# by ~2·max|M|), and at most MAX_FLIPS entries whose sign differs (each
# within that gap of 0, so both devices' |M| there are rounding).  The
# card's runs read gaps of 1.9e-9 to 5.6e-9 and 0 or 1 flips of up to
# 1.18M entries (NVIDIA H100 80GB HBM3, 700.00 W).
FLIP_GAP_REL, MAX_FLIPS = 1e-5, 8

TRAIN_EPOCHS = 2
# the fits on the card, per shape: (train records, batch size, test
# records), TRAIN_EPOCHS epochs each (4 steps; 2 for the correspondence
# shapes), so that the first epoch, held against the CPU, holds 2 steps
TRAIN_FIT = {"shrec11_b8": (16, 8, 8), "seg_n2048_b4": (8, 4, 4),
             "corr_n5120_b1": (2, 1, 1), "corr_n5120_b1_panel": (2, 1, 1),
             "corr_n5120_b1_panel_compact": (2, 1, 1),
             "corr_n5120_b1_panel_allcompact": (2, 1, 1),
             "seg_n2048_b4_compact": (8, 4, 4),
             "seg_n2048_b4_bech": (8, 4, 4), "corr_n5120_b1_bech": (2, 1, 1)}
# conv launches (K1, or K5 on the pure-panel layout, or K6 on the
# all-compact route) per forward (and per backward) pass of each net
CONVS_PER_PASS = {"shrec11_b8": 5, "seg_n2048_b4": 9, "corr_n5120_b1": 17,
                  "corr_n5120_b1_panel": 17, f"corr_n{N_LARGE}_b1": 17,
                  "corr_n5120_b1_panel_compact": 17,
                  "corr_n5120_b1_panel_allcompact": 17,
                  "seg_n2048_b4_compact": 9,
                  f"corr_n{N_LARGE}_b1_compact": 17,
                  f"corr_n{N_LARGE}_b1_allcompact": 17,
                  "seg_n2048_b4_bech": 9, "corr_n5120_b1_bech": 17,
                  "seg_n2048_b4_gp1x2": 9, "shrec11_b8_gp2x2": 5}
# the kernels' short names in the printed lines
SHORT = {"band_fused": "K1", "echo_panel": "K2", "band_panel": "K5",
         "band_compact": "K6", "echo_compact": "K7", "band_cfused": "K4",
         "band_contrib": "K3", "band_sparse": "K8", "halo_fused": "K9",
         "halo_contrib": "K9 contrib"}
# the fit at N_LARGE: the CORRESPONDENCE preset's 60 epochs cut to 3 (one
# record, so 3 steps); nothing else is cut
LARGE_EPOCHS = 3
# the worker processes that run the CPU's side of the training checks
# beside the card's phases, and the torch threads of each (the machine has
# 8 cores; the main process keeps the rest until the workers' last result
# is read)
CPU_WORKERS = 2
CPU_THREADS = 3


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

def time_cuda(fn, iters, reps=5, warmup=2):
    """Median ms per call over `reps` CUDA-event windows of `iters` calls,
    after `warmup` calls."""
    for _ in range(warmup):
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


def request_breakdown(fn, top=6, passes=(), required=True):
    """One call of fn() under torch.profiler: the device time of each
    kernel name, their sum, and that sum's share of the call's wall time
    (which the profiler itself inflates).  The trace holds the device's
    activity only: the host's operator events (tens of thousands a training
    step) took seconds a call to aggregate.  With ``passes`` (kernel
    function names) also {name: (device ms, launches)} of those kernels,
    whether in the top ones or not.  A trace with no device time fails the
    run, or (``required`` false) gives None."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = sorted(((e.self_device_time_total / 1e3, e.key, e.count)
                   for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(k[0] for k in kern)
    if not required and busy == 0:
        return None
    check(busy > 0, "the profiler saw no device time")
    if not passes:
        return wall_ms, busy, kern[:top]
    by = {}
    for t, key, count in kern:
        name = kernel_name(key)
        if name in passes:
            ms, n = by.get(name, (0.0, 0))
            by[name] = (ms + t, n + count)
    return wall_ms, busy, kern[:top], by


# K6's kernels by pass (the forward: contrib, filter; the backward: contrib,
# dW, dc, dG, fold), as the profiler names them; the fold kernel also runs
# after K7's backward and in the compact lift's VJP
K6_PASSES = {"compact_contrib_kernel": "contrib", "filter_kernel": "filter",
             "bwd_dw_partial_kernel": "dW", "bwd_dw_combine": "dW combine",
             "bwd_dc_kernel": "dc", "compact_dg_kernel": "dG",
             "compact_fold_kernel": "fold"}
# K1's backward by pass (csrc/band_fused_bwd.cu): the occupancy bytes, the
# contrib walk, dW, W's rows in dc's order (K = 5), dc, and the dG walk by
# source
K1_BWD_PASSES = {"occ_kernel": "occupancy", "contrib_kernel": "contrib",
                 "bwd_dw_partial_kernel": "dW", "bwd_dw_combine": "dW combine",
                 "cm_w_kernel": "W order", "bwd_dc_kernel": "dc",
                 "dg_kernel": "dG"}
# K9's kernels each way (the same walk's, csrc/band_call.cuh): K1's
# backward passes and the forward's filter; no other kernel of a
# graph-parallel segmentation step has these names
K9_PASSES = {**K1_BWD_PASSES, "filter_kernel": "filter",
             "filter_combine": "filter combine"}


def print_passes(what, by, card, kind="K6", passes=K6_PASSES):
    """A breakdown's kernels of one kind by pass (request_breakdown's
    ``passes``)."""
    print(f"{what}: {kind} by pass under the profiler on {card}: "
          + ", ".join(f"{passes[n]} {by[n][0]:.3f} ms (x{by[n][1]})"
                      for n in passes if n in by)
          + (" (the fold's launches include K7's backward and the lift's "
             "VJP)" if kind == "K6" else ""))


def kernel_name(key):
    """The function name in a profiler key such as
    "void (anonymous namespace)::bwd_dg_kernel<5, 6>(float const*, ...)"."""
    m = re.search(r"(\w+)(?:<[^>(]*>)?\(", key)
    return m.group(1) if m else key


def time_host(fn, reps=5, warmup=True):
    """Median wall ms of fn() (which must end in a device sync), after a
    warm-up call unless the caller's path has just run (warmup=False)."""
    if warmup:
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# host cost a call read at kernel times below this (the small requests and
# steps, which are host-bound; a 163k call's enqueue is not what limits it)
HOST_US_BELOW_MS = 5.0


def enqueue_us(fn, calls=20, reps=5):
    """Median host µs to enqueue one call of fn, over `reps` windows of
    `calls` calls with no sync inside a window (the device runs behind, so
    the window reads the wrapper's and the launches' host cost)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e6 / calls)
        torch.cuda.synchronize()
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


def check_fwd(kind, label, run, plain, tol, what="y"):
    """A forward kernel's ``run()`` against its plain version ``plain()``
    within ``tol`` of the reference's scale, then a second call that must
    be bitwise equal; returns (max abs err, scale)."""
    out = run()
    torch.cuda.synchronize()
    ref = plain()
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    check(torch.isfinite(out).all().item(), f"{kind} {label}: non-finite")
    check(err <= tol * scale,
          f"{kind} {label}: max abs err {err} > {tol} x {scale}")
    check(torch.equal(out, run()), f"{kind} {label}: two calls differ")
    print(f"{kind} {label}: max abs err {err:.3e}, rel {err / scale:.3e} "
          f"(tolerance {tol} of max |{what}| = {scale:.3e}); a second call "
          "is bitwise equal")
    return err, scale


def check_bwd(kind, label, run, plain, tol, names):
    """A backward kernel's ``run()`` (a tuple of outputs named ``names``)
    against its plain version ``plain()``, each within ``tol`` of its own
    scale, then a second call that must be bitwise equal; returns the
    errors as row fields."""
    got = run()
    torch.cuda.synchronize()
    want = plain()
    row = {}
    for name, a, b in zip(names, got, want):
        check(torch.isfinite(a).all().item(), f"{kind} {label}: non-finite "
                                              f"{name}")
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        check(err <= tol * scale,
              f"{kind} {label}: {name} max abs err {err} > {tol} x {scale}")
        row[f"{name}_max_abs_err"] = err
        row[f"{name}_max_rel_err"] = err / scale
    again = run()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{kind} {label}: two calls differ")
    row["max_abs_err"] = max(row[f"{n}_max_abs_err"] for n in names)
    print(f"{kind} {label}: " + ", ".join(
        f"{n} max abs err {row[f'{n}_max_abs_err']:.3e} (rel "
        f"{row[f'{n}_max_rel_err']:.3e})" for n in names)
        + f"; tolerance {tol} of each one's scale; a second call is bitwise "
        "equal")
    return row


def k1_check(label, g, sten, wmat, tb, nh):
    """K1's forward against its plain version (K1_RTOL_SCALE of max |y|),
    then a second call that must be bitwise equal."""
    err, scale = check_fwd(
        "K1", label, lambda: band_fused_fwd(g, sten, wmat, tb, nh),
        lambda: band_fused_fwd_reference(g, sten, wmat, tb, nh),
        K1_RTOL_SCALE)
    return dict(shape=label, n_mesh=g.shape[0], N=g.shape[1], M=g.shape[2],
                nh=nh, O2=wmat.shape[2], max_abs_err=err,
                max_rel_err=err / scale)


def k1_time(row, g, sten, wmat, tb, nh):
    row["ms"] = time_cuda(lambda: band_fused_fwd(g, sten, wmat, tb, nh),
                          iters=20)
    row["host_us"] = enqueue_us(lambda: band_fused_fwd(g, sten, wmat, tb, nh))
    row["plain_ms"] = time_cuda(
        lambda: band_fused_fwd_reference(g, sten, wmat, tb, nh), iters=3)
    row.update(k1_bound(g, sten, wmat))


def k1_bwd_check(label, g, sten, wmat, dy, tb, nh):
    """K1's backward against its plain version (dg and dw each to
    K1_RTOL_SCALE of its own scale), then a second call that must give
    bitwise-equal dg and dw."""
    row = check_bwd(
        "K1 bwd", label, lambda: band_fused_bwd(dy, g, sten, wmat, tb, nh),
        lambda: band_fused_bwd_reference(dy, g, sten, wmat, tb, nh),
        K1_RTOL_SCALE, ("dg", "dw"))
    return dict(shape=label, n_mesh=g.shape[0], N=g.shape[1], M=g.shape[2],
                nh=nh, O2=wmat.shape[2], **row)


def k1_bwd_time(row, g, sten, wmat, dy, tb, nh):
    row["ms"] = time_cuda(lambda: band_fused_bwd(dy, g, sten, wmat, tb, nh),
                          iters=10)
    row["host_us"] = enqueue_us(
        lambda: band_fused_bwd(dy, g, sten, wmat, tb, nh), calls=10)
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


def _slots_per_sector(sten):
    """Stencil slots in a 32-byte sector: 8 of f32, 16 of bf16."""
    return 32 // sten.element_size()


def _sectors(occ, per=8):
    """32-byte sectors (``per`` source slots) of a (P, TB, TS) occupancy
    that hold an occupied slot."""
    return int(occ.reshape(*occ.shape[:2], -1, per).any(-1).sum().item())


def _stencil_bytes(slots, planes, whole, sectors, elem=4):
    """Bytes of a panel stencil of ``elem``-byte elements (4 f32, 2 bf16)
    that a kernel must read: the ``whole`` planes that say which slots are
    occupied (r, or a dense stencil's hat planes) read whole, the other
    planes only in the 32-byte sectors that hold an occupied slot."""
    return elem * whole * slots + 32 * (planes - whole) * sectors


def k2_pairs(x, sten, pid, src):
    """Occupied slots (wxp ≠ 0) of the panels ``pid`` whose sources lie in
    the blocks ``src``, (occupied slot, channel whose source feature is not
    at the origin) pairs: the work K2 does, forward or backward; and the
    bytes of the stencil it must read for them."""
    TB, per = sten.shape[-1], _slots_per_sector(sten)
    check(TB % per == 0, f"the stencil bytes count 32-byte sectors of {per} "
                         "slots")
    occ = (sten[pid.long(), 3] != 0) | (sten[pid.long(), 4] != 0)
    nzc = (x.abs() >= EPS).any(-1).sum(-1)               # (rows,)
    src_rows = (src.long()[:, None] * TB
                + torch.arange(TB, device=x.device))     # (P, TBs)
    return (int(occ.sum().item()),
            int((occ.sum(1) * nzc[src_rows]).sum().item()),
            occ.numel(),
            _stencil_bytes(occ.numel(), sten.shape[1], 1, _sectors(occ, per),
                           sten.element_size()))


def k2_bound(x, sten, meta, n_bins):
    """Least time for one K2 call: bytes (x, the stencil's r plane whole
    and its other planes where a slot is occupied, and meta read once, the
    grid written once) over HBM rate, and the f32 operations this data
    needs over the f32 rate: K2_FLOPS_PER_PAIR per (occupied slot, channel
    whose source feature is not at the origin), plus 2 per occupied slot
    for r·e^{iθ}."""
    rows, C = x.shape[0], x.shape[1]
    edges, pairs, slots, sten_bytes = k2_pairs(
        x, sten, torch.arange(sten.shape[0], device=x.device), meta[1])
    w2 = (2 * n_bins + 1) ** 2
    nbytes = sten_bytes + 4 * (x.numel() + meta.numel() + rows * 2 * w2 * C)
    return _bound(nbytes, K2_FLOPS_PER_PAIR * pairs + 2 * edges,
                  edges=edges, pairs=pairs, slot_fill=edges / max(1, slots))


def k2_bwd_bound(dg, x, sten, meta_s):
    """Least time for one K2 backward call: bytes (dg, the stencil counted
    as in k2_bound, meta_s and x read once, dx written once) over HBM rate,
    and the f32 operations this data needs over the f32 rate:
    K2_BWD_FLOPS_PER_PAIR per (occupied slot, non-origin channel) of the
    panels in meta_s, plus 2 per occupied slot for r·e^{iθ}."""
    edges, pairs, _, sten_bytes = k2_pairs(x, sten, meta_s[0], meta_s[2])
    nbytes = sten_bytes + 4 * (dg.numel() + meta_s.numel() + 2 * x.numel())
    return _bound(nbytes, K2_BWD_FLOPS_PER_PAIR * pairs + 2 * edges,
                  edges=edges, pairs=pairs)


def k2_check(label, x, panel, n_bins):
    """K2 against its plain version, then a second call that must be
    bitwise equal."""
    args = (x, panel.sten, panel.meta, n_bins, x.shape[0] // panel.tb)
    err, scale = check_fwd("K2", label, lambda: echo_panel_grid(*args),
                           lambda: echo_panel_grid_reference(*args),
                           K2_RTOL_SCALE, "grid")
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


def check_echo_bwd(kind, label, run, ref, cotangents):
    """An ECHO backward kernel ``run(dg)`` against its plain version's dx
    ``ref`` for each cotangent layout in ``cotangents`` (contiguous, cells
    minor), within K2_RTOL_SCALE of dx's scale, each then against a second
    call that must be bitwise equal; returns the max abs err and the
    scale."""
    scale = ref.abs().max().item()
    err = 0.0
    for g in cotangents:
        dx = run(g)
        torch.cuda.synchronize()
        check(torch.isfinite(dx).all().item(), f"{kind} {label}: non-finite")
        err = max(err, (dx - ref).abs().max().item())
        check(torch.equal(dx, run(g)), f"{kind} {label}: two calls differ")
    check(err <= K2_RTOL_SCALE * scale,
          f"{kind} {label}: max abs err {err} > {K2_RTOL_SCALE} x {scale}")
    print(f"{kind} {label}: max abs err {err:.3e}, rel {err / scale:.3e} "
          f"(tolerance {K2_RTOL_SCALE} of max |dx| = {scale:.3e}), "
          "contiguous and cells-minor cotangents; a second call is bitwise "
          "equal")
    return err, scale


def k2_bwd_check(label, dg, dg_cells_minor, x, panel, n_bins):
    """K2's backward against its plain version for both cotangent layouts,
    each then against a second call that must be bitwise equal."""
    args = (x, panel.sten, panel.meta_s, n_bins, x.shape[0] // panel.tb)
    err, scale = check_echo_bwd(
        "K2 bwd", label, lambda g: echo_panel_grid_bwd(g, *args),
        echo_panel_grid_bwd_reference(dg, *args), (dg, dg_cells_minor))
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


# --- K5 against its plain version ----------------------------------------------------

def k5_inputs(panel, C, O2, gen):
    """Random g (rows, K·2C) for a panel table and a W (R, K·2C, O2) of an
    initialised filter bank's scale, so that y is O(1)."""
    K, R = 2 * panel.band_limit + 1, panel.n_rings
    M = K * 2 * C
    dev = panel.sten.device
    g = torch.randn(panel.n_mesh * panel.n_pad, M, device=dev, generator=gen)
    wmat = torch.randn(R, M, O2, device=dev, generator=gen) / (R * M) ** 0.5
    return g, wmat


def _k5_args(g, wmat, panel):
    return (g, wmat, panel.sten, panel.meta, panel.tb, panel.n_rings,
            panel.band_limit, panel.compressed)


def _k5_table(panel, R, K, live=None):
    """What a K5 (or K6) call must read and do over a panel table, walked
    256 panels at a time: the nonzero hats, the occupied slots (any nonzero
    hat), and the bytes of the stencil it needs (the planes that say which
    slots are occupied, r or a dense stencil's R hat planes, read whole; the
    other planes, e^{iθ} and wxp or the f_k planes, only in the 32-byte
    sectors that hold an occupied slot).  live: a (P, TS) bool tensor that
    is set where a column holds an occupied slot."""
    per = _slots_per_sector(panel.sten)
    check(panel.sten.shape[-1] % per == 0,
          f"the bounds count 32-byte sectors of {per} slots")
    hats = occupied = sectors = 0
    for lo in range(0, panel.n_panels, 256):
        h, _ = _panel_pairs(panel.sten[lo:lo + 256], R, K, panel.compressed)
        nz = h != 0
        occ = nz.any(0)                                  # (pc, TBt, TS)
        hats += int(nz.sum().item())
        occupied += int(occ.sum().item())
        sectors += _sectors(occ, per)
        if live is not None:
            live[lo:lo + 256] = occ.any(1)
    slots = panel.sten[:, 0].numel()
    stencil_bytes = _stencil_bytes(slots, panel.sten.shape[1],
                                   1 if panel.compressed else R, sectors,
                                   panel.sten.element_size())
    return hats, occupied, slots, stencil_bytes


def k5_bound(g, wmat, panel):
    """Least time for one K5 call: bytes over HBM rate, and the f32
    operations this data needs over the f32 rate.  Bytes: the stencil as
    _k5_table counts it, meta, g and W read once, y written once.
    Operations: the stencil term in the cheaper of k1_bound's two orders,
    from the table's nonzero hats and occupied slots, plus the filter
    contraction 2·N·R·M·O2."""
    N, M = g.shape
    R, O2 = wmat.shape[0], wmat.shape[-1]
    K = 2 * panel.band_limit + 1
    C = M // (2 * K)
    hats, occupied, slots, stencil_bytes = _k5_table(panel, R, K)
    stencil = min(occupied * K * 6 * C + hats * K * 4 * C,
                  hats * K * (8 * C + 2))
    flops = stencil + 2 * N * R * M * O2
    nbytes = stencil_bytes + 4 * (panel.meta.numel() + g.numel()
                                  + wmat.numel() + N * O2)
    return _bound(nbytes, flops, occupied=occupied, hats=hats,
                  slot_fill=occupied / slots, stencil_bytes=stencil_bytes,
                  stencil_bytes_whole=panel.sten.numel()
                  * panel.sten.element_size())


def k5_bwd_bound(g, wmat, dy, panel):
    """Least time for one K5 backward call: bytes (the stencil as _k5_table
    counts it, g, dy, W and meta_s read once, dg and dW written once) over
    HBM rate, and the f32 operations this data needs over the f32 rate: the
    forward's stencil term to rematerialise contrib, the transposed stencil
    term for dG in the cheaper of k1_bwd_bound's two orders, and
    2·N·R·M·O2 each for dc = dy·Wᵀ and dW = contribᵀ·dy."""
    N, M = g.shape
    R, O2 = wmat.shape[0], wmat.shape[-1]
    K = 2 * panel.band_limit + 1
    C = M // (2 * K)
    hats, occupied, _, stencil_bytes = _k5_table(panel, R, K)
    contrib = min(occupied * K * 6 * C + hats * K * 4 * C,
                  hats * K * (8 * C + 2))
    dgrad = min(occupied * K * 8 * C + hats * K * 4 * C,
                hats * K * (8 * C + 2))
    flops = contrib + dgrad + 2 * 2 * dy.shape[0] * R * M * O2
    nbytes = stencil_bytes + 4 * (panel.meta_s.numel() + 2 * g.numel()
                                  + dy.numel() + 2 * wmat.numel())
    return _bound(nbytes, flops, occupied=occupied, hats=hats)


def k5_check(label, g, wmat, panel):
    """K5 against its plain version, then a second call that must be
    bitwise equal."""
    args = _k5_args(g, wmat, panel)
    err, scale = check_fwd("K5", label, lambda: band_panel_fwd(*args),
                           lambda: band_panel_fwd_reference(*args),
                           K5_RTOL_SCALE)
    return dict(shape=label, N=g.shape[0], M=g.shape[1], O2=wmat.shape[-1],
                panels=panel.n_panels, compressed=panel.compressed,
                chunk=panel.chunk, max_abs_err=err, max_rel_err=err / scale)


def k5_time(row, g, wmat, panel):
    args = _k5_args(g, wmat, panel)
    row["ms"] = time_cuda(lambda: band_panel_fwd(*args), iters=10)
    if row["ms"] < HOST_US_BELOW_MS:
        row["host_us"] = enqueue_us(lambda: band_panel_fwd(*args))
    # the plain version ran in its check (k5_check): no warm-up call
    row["plain_ms"] = time_cuda(lambda: band_panel_fwd_reference(*args),
                                iters=1, reps=1, warmup=0)
    row.update(k5_bound(g, wmat, panel))


def _k5_bwd_args(g, wmat, dy, panel):
    return (dy, g, wmat, panel.sten, panel.meta, panel.meta_s, panel.tb,
            panel.n_rings, panel.band_limit, panel.compressed)


def k5_bwd_check(label, g, wmat, dy, panel):
    """K5's backward against its plain version (dg and dw each to
    K5_RTOL_SCALE of its own scale), then a second call that must give
    bitwise-equal dg and dw."""
    args = _k5_bwd_args(g, wmat, dy, panel)
    row = check_bwd(
        "K5 bwd", label, lambda: band_panel_bwd(*args),
        lambda: band_panel_bwd_reference(dy, g, wmat, panel.sten,
                                         panel.meta_s, *args[6:]),
        K5_RTOL_SCALE, ("dg", "dw"))
    return dict(shape=label, N=g.shape[0], M=g.shape[1], O2=wmat.shape[-1],
                panels=panel.meta_s.shape[1], compressed=panel.compressed,
                chunk=panel.chunk, **row)


def k5_bwd_time(row, g, wmat, dy, panel):
    args = _k5_bwd_args(g, wmat, dy, panel)
    row["ms"] = time_cuda(lambda: band_panel_bwd(*args), iters=5)
    if row["ms"] < HOST_US_BELOW_MS:
        row["host_us"] = enqueue_us(lambda: band_panel_bwd(*args), calls=10)
    # the plain version ran in its check (k5_bwd_check): no warm-up call
    row["plain_ms"] = time_cuda(
        lambda: band_panel_bwd_reference(dy, g, wmat, panel.sten,
                                         panel.meta_s, *args[6:]),
        iters=1, reps=1, warmup=0)
    row.update(k5_bwd_bound(g, wmat, dy, panel))


# --- K6 and K7 against their plain versions -------------------------------------------

def _k6_args(g, wmat, comp):
    return (g, wmat, comp.sten, comp.meta, comp.src_idx, comp.tb,
            comp.n_rings, comp.band_limit)


def _live_rows(comp, live):
    """Distinct source rows named by the live columns of a compact table:
    the rows of g (or x) a call must read, each once."""
    return int(torch.unique(comp.src_idx[live]).numel())


def k6_bound(g, wmat, comp):
    """Least time for one K6 call: bytes over HBM rate, and the f32
    operations this data needs over the f32 rate.  Bytes: the stencil as
    _k5_table counts it, meta and src_idx, the rows of g that live columns
    name (each once), W read once, y written once.  Operations: the stencil
    term in the cheaper of k1_bound's two orders, from the table's nonzero
    hats and occupied slots, plus the filter contraction 2·N·R·M·O2."""
    N, M = g.shape
    R, O2 = wmat.shape[0], wmat.shape[-1]
    K = 2 * comp.band_limit + 1
    C = M // (2 * K)
    live = torch.zeros(comp.src_idx.shape, dtype=torch.bool,
                       device=g.device)
    hats, occupied, slots, stencil_bytes = _k5_table(comp, R, K, live)
    rows = _live_rows(comp, live)
    stencil = min(occupied * K * 6 * C + hats * K * 4 * C,
                  hats * K * (8 * C + 2))
    flops = stencil + 2 * N * R * M * O2
    nbytes = stencil_bytes + 4 * (comp.meta.numel() + comp.src_idx.numel()
                                  + rows * M + wmat.numel() + N * O2)
    return _bound(nbytes, flops, occupied=occupied, hats=hats,
                  slot_fill=occupied / slots, stencil_bytes=stencil_bytes,
                  stencil_bytes_whole=comp.sten.numel()
                  * comp.sten.element_size(), live_rows=rows)


def k6_check(label, g, wmat, comp):
    """K6 against its plain version, then a second call that must be
    bitwise equal."""
    args = _k6_args(g, wmat, comp)
    err, scale = check_fwd("K6", label, lambda: band_compact_fwd(*args),
                           lambda: band_compact_fwd_reference(*args),
                           K5_RTOL_SCALE)
    return dict(shape=label, N=g.shape[0], M=g.shape[1], O2=wmat.shape[-1],
                panels=comp.n_panels, tbt=comp.tb, ts=comp.ts,
                max_abs_err=err, max_rel_err=err / scale)


def k6_time(row, g, wmat, comp):
    args = _k6_args(g, wmat, comp)
    row["ms"] = time_cuda(lambda: band_compact_fwd(*args), iters=10)
    row["plain_ms"] = time_cuda(lambda: band_compact_fwd_reference(*args),
                                iters=1, reps=1, warmup=1)
    row.update(k6_bound(g, wmat, comp))


def k7_pairs(x, comp):
    """Occupied slots (wxp ≠ 0) of a compact table, (occupied slot, channel
    whose source feature is not at the origin) pairs, slots, the stencil
    bytes K7 must read (r whole, the other planes where a slot is occupied)
    and the distinct source rows its live columns name."""
    per = _slots_per_sector(comp.sten)
    check(comp.ts % per == 0, "the stencil bytes count 32-byte sectors of "
                              f"{per} slots")
    occ = (comp.sten[:, 3] != 0) | (comp.sten[:, 4] != 0)  # (P, TBt, TS)
    nzc = (x.abs() >= EPS).any(-1).sum(-1)                 # (rows,)
    per_col = occ.sum(1)                                   # (P, TS)
    return (int(occ.sum().item()),
            int((per_col * nzc[comp.src_idx.long()]).sum().item()),
            occ.numel(),
            _stencil_bytes(occ.numel(), 5, 1, _sectors(occ, per),
                           comp.sten.element_size()),
            _live_rows(comp, per_col > 0))


def k7_bound(x, comp, n_bins):
    """Least time for one K7 call: bytes (the stencil as k7_pairs counts it,
    meta and src_idx, the rows of x that live columns name, each once, read
    once; the grid written once) over HBM rate, and the f32 operations this
    data needs over the f32 rate: K2_FLOPS_PER_PAIR per (occupied slot,
    non-origin channel) plus 2 per occupied slot for r·e^{iθ}."""
    C = x.shape[1]
    edges, pairs, slots, sten_bytes, rows = k7_pairs(x, comp)
    w2 = (2 * n_bins + 1) ** 2
    nbytes = sten_bytes + 4 * (comp.meta.numel() + comp.src_idx.numel()
                               + rows * 2 * C + x.shape[0] * 2 * w2 * C)
    return _bound(nbytes, K2_FLOPS_PER_PAIR * pairs + 2 * edges,
                  edges=edges, pairs=pairs, slot_fill=edges / max(1, slots),
                  live_rows=rows)


def _k7_args(x, comp, n_bins):
    return (x, comp.sten, comp.meta, comp.src_idx, n_bins,
            x.shape[0] // comp.tb)


def k7_check(label, x, comp, n_bins):
    """K7 against its plain version, then a second call that must be
    bitwise equal."""
    args = _k7_args(x, comp, n_bins)
    err, scale = check_fwd("K7", label, lambda: echo_compact_grid(*args),
                           lambda: echo_compact_grid_reference(*args),
                           K2_RTOL_SCALE, "grid")
    return dict(shape=label, rows=x.shape[0], C=x.shape[1], n_bins=n_bins,
                panels=comp.n_panels, tbt=comp.tb, ts=comp.ts,
                max_abs_err=err, max_rel_err=err / scale)


def k7_time(row, x, comp, n_bins, plain=(3, 2)):
    """ms of the kernel, and of its plain version over (reps, warm-up
    calls) ``plain``."""
    args = _k7_args(x, comp, n_bins)
    row["ms"] = time_cuda(lambda: echo_compact_grid(*args), iters=10)
    row["plain_ms"] = time_cuda(lambda: echo_compact_grid_reference(*args),
                                iters=1, reps=plain[0], warmup=plain[1])
    row.update(k7_bound(x, comp, n_bins))


def _k6_bwd_args(g, wmat, dy, comp):
    return (dy, g, wmat, comp.sten, comp.meta, comp.src_idx, comp.fold_order,
            comp.fold_ptr, comp.tb, comp.n_rings, comp.band_limit)


def k6_bwd_plain(dy, g, wmat, comp):
    """K6's plain backward and the plain fold: (dg, dw)."""
    dgg, dw = band_compact_bwd_reference(dy, g, wmat, comp.sten, comp.meta,
                                         comp.src_idx, comp.tb, comp.n_rings,
                                         comp.band_limit)
    return compact_fold_reference(dgg, comp.src_idx, g.shape[0]), dw


def k6_bwd_bound(g, wmat, dy, comp):
    """Least time for one K6 backward call: bytes (the stencil as _k5_table
    counts it, meta and src_idx, the rows of g that live columns name, dy
    and W read once, dg and dW written once) over HBM rate, and the f32
    operations this data needs over the f32 rate: the forward's stencil
    term to rematerialise contrib, the transposed stencil term for dG in
    the cheaper of k1_bwd_bound's two orders, and 2·rows·R·M·O2 each for
    dc = dy·Wᵀ and dW = contribᵀ·dy.  The dgg scratch and the contrib / dc
    round trips are this design's cost, not the function's."""
    N, M = g.shape
    R, O2 = wmat.shape[0], wmat.shape[-1]
    K = 2 * comp.band_limit + 1
    C = M // (2 * K)
    live = torch.zeros(comp.src_idx.shape, dtype=torch.bool,
                       device=g.device)
    hats, occupied, _, stencil_bytes = _k5_table(comp, R, K, live)
    rows = _live_rows(comp, live)
    contrib = min(occupied * K * 6 * C + hats * K * 4 * C,
                  hats * K * (8 * C + 2))
    dgrad = min(occupied * K * 8 * C + hats * K * 4 * C,
                hats * K * (8 * C + 2))
    flops = contrib + dgrad + 2 * 2 * dy.shape[0] * R * M * O2
    nbytes = stencil_bytes + 4 * (comp.meta.numel() + comp.src_idx.numel()
                                  + rows * M + dy.numel() + 2 * wmat.numel()
                                  + N * M)
    return _bound(nbytes, flops, occupied=occupied, hats=hats,
                  live_rows=rows)


def k6_bwd_check(label, g, wmat, dy, comp):
    """K6's backward (dg after the fold, and dw) against its plain version
    and the plain fold, each to K5_RTOL_SCALE of its own scale, then a
    second call that must be bitwise equal."""
    args = _k6_bwd_args(g, wmat, dy, comp)
    row = check_bwd("K6 bwd", label, lambda: band_compact_bwd(*args),
                    lambda: k6_bwd_plain(dy, g, wmat, comp), K5_RTOL_SCALE,
                    ("dg", "dw"))
    return dict(shape=label, N=g.shape[0], M=g.shape[1], O2=wmat.shape[-1],
                panels=comp.n_panels, tbt=comp.tb, ts=comp.ts, **row)


def k6_bwd_time(row, g, wmat, dy, comp):
    args = _k6_bwd_args(g, wmat, dy, comp)
    row["ms"] = time_cuda(lambda: band_compact_bwd(*args), iters=5)
    row["plain_ms"] = time_cuda(lambda: k6_bwd_plain(dy, g, wmat, comp),
                                iters=1, reps=1, warmup=1)
    row.update(k6_bwd_bound(g, wmat, dy, comp))


def k7_bwd_plain(dg, x, comp, n_bins):
    """K7's plain backward and the plain fold: dx (rows, C, 2)."""
    dxg = echo_compact_grid_bwd_reference(dg, x, comp.sten, comp.meta,
                                          comp.src_idx, n_bins)
    return compact_fold_reference(dxg.reshape(dxg.shape[0], -1),
                                  comp.src_idx, x.shape[0]).reshape(x.shape)


def k7_bwd_bound(dg, x, comp):
    """Least time for one K7 backward call: bytes (dg, the stencil as
    k7_pairs counts it, meta and src_idx, the rows of x that live columns
    name read once, dx written once) over HBM rate, and the f32 operations
    this data needs over the f32 rate: K2_BWD_FLOPS_PER_PAIR per (occupied
    slot, non-origin channel) plus 2 per occupied slot for r·e^{iθ}.  The
    per-column gradients the fold reads back are this design's cost."""
    C = x.shape[1]
    edges, pairs, _, sten_bytes, rows = k7_pairs(x, comp)
    nbytes = sten_bytes + 4 * (dg.numel() + comp.meta.numel()
                               + comp.src_idx.numel() + rows * 2 * C
                               + x.numel())
    return _bound(nbytes, K2_BWD_FLOPS_PER_PAIR * pairs + 2 * edges,
                  edges=edges, pairs=pairs, live_rows=rows)


def _k7_bwd_args(x, comp, n_bins):
    return (x, comp.sten, comp.meta, comp.src_idx, comp.fold_order,
            comp.fold_ptr, n_bins)


def k7_bwd_check(label, dg, dg_cells_minor, x, comp, n_bins):
    """K7's backward against its plain version and the plain fold for both
    cotangent layouts, each then against a second call that must be
    bitwise equal."""
    args = _k7_bwd_args(x, comp, n_bins)
    err, scale = check_echo_bwd(
        "K7 bwd", label, lambda g: echo_compact_grid_bwd(g, *args),
        k7_bwd_plain(dg, x, comp, n_bins), (dg, dg_cells_minor))
    return dict(shape=label, rows=x.shape[0], C=x.shape[1], n_bins=n_bins,
                panels=comp.n_panels, tbt=comp.tb, ts=comp.ts,
                max_abs_err=err, max_rel_err=err / scale)


def k7_bwd_time(row, dg, dg_cells_minor, x, comp, n_bins, plain=(3, 2)):
    """ms: the cells-minor cotangent (what a training step passes);
    ms_contiguous beside it; the plain version over (reps, warm-up
    calls) ``plain``."""
    args = _k7_bwd_args(x, comp, n_bins)
    row["ms"] = time_cuda(lambda: echo_compact_grid_bwd(dg_cells_minor,
                                                        *args), iters=10)
    row["ms_contiguous"] = time_cuda(lambda: echo_compact_grid_bwd(dg, *args),
                                     iters=10)
    row["plain_ms"] = time_cuda(lambda: k7_bwd_plain(dg, x, comp, n_bins),
                                iters=1, reps=plain[0], warmup=plain[1])
    row.update(k7_bwd_bound(dg, x, comp))


def bf16_checks(gen, k5_cases, k6_cases, k2_cases, k7_cases, card):
    """K5, K6, K2 and K7, each way, on bf16 tables: each case (label,
    table, C, O2 or n_bins) checked against its plain version and bitwise
    against a second call (the kernels' *_check); the first case of each
    kernel is timed beside its plain version and its bound, the stencil
    counted at 2 bytes (*_time).  Returns the rows by kernel."""
    rows = {n: [] for n in ("K5", "K5 bwd", "K6", "K6 bwd", "K2", "K2 bwd",
                            "K7", "K7 bwd")}
    for i, (label, pt, C, O2) in enumerate(k5_cases):
        g, wmat = k5_inputs(pt, C, O2, gen)
        dy = torch.randn(g.shape[0], O2, device=g.device, generator=gen)
        rows["K5"].append(k5_check(f"{label} bf16", g, wmat, pt))
        rows["K5 bwd"].append(k5_bwd_check(f"{label} bf16", g, wmat, dy, pt))
        if i == 0:
            k5_time(rows["K5"][0], g, wmat, pt)
            k5_bwd_time(rows["K5 bwd"][0], g, wmat, dy, pt)
    for i, (label, ct, C, O2) in enumerate(k6_cases):
        g, wmat = k5_inputs(ct, C, O2, gen)
        dy = torch.randn(g.shape[0], O2, device=g.device, generator=gen)
        rows["K6"].append(k6_check(f"{label} bf16", g, wmat, ct))
        rows["K6 bwd"].append(k6_bwd_check(f"{label} bf16", g, wmat, dy,
                                           ct))
        if i == 0:
            k6_time(rows["K6"][0], g, wmat, ct)
            k6_bwd_time(rows["K6 bwd"][0], g, wmat, dy, ct)
    for i, (label, pt, C, n_bins) in enumerate(k2_cases):
        x = k2_inputs(pt, C, gen)
        dg, dg_cm = k2_bwd_inputs(x, n_bins, pt.tb, gen)
        rows["K2"].append(k2_check(f"{label} bf16", x, pt, n_bins))
        rows["K2 bwd"].append(k2_bwd_check(f"{label} bf16", dg, dg_cm, x, pt,
                                           n_bins))
        if i == 0:
            k2_time(rows["K2"][0], x, pt, n_bins)
            k2_bwd_time(rows["K2 bwd"][0], dg, dg_cm, x, pt, n_bins)
    for i, (label, ct, C, n_bins) in enumerate(k7_cases):
        x = k2_inputs(ct, C, gen)
        dg, dg_cm = k2_bwd_inputs(x, n_bins, ct.tb, gen)
        rows["K7"].append(k7_check(f"{label} bf16", x, ct, n_bins))
        rows["K7 bwd"].append(k7_bwd_check(f"{label} bf16", dg, dg_cm, x, ct,
                                           n_bins))
        if i == 0:
            # the plain versions take seconds a call at 163k
            k7_time(rows["K7"][0], x, ct, n_bins, plain=(1, 0))
            k7_bwd_time(rows["K7 bwd"][0], dg, dg_cm, x, ct, n_bins,
                        plain=(1, 0))
    for kind, rs in rows.items():
        print_times(f"{kind} bf16", rs[:1], card)
        r = rs[0]
        if "stencil_bytes" in r:
            print(f"{kind} bf16 {r['shape']}: {r['stencil_bytes'] / 1e9:.3f} "
                  f"GB of the {r['stencil_bytes_whole'] / 1e9:.3f} GB bf16 "
                  "stencil needed")
    return rows


def lift_vjp_check(label, comp, gen):
    """The compact lift's backward as a training step would run it, were
    its input differentiable (_CompactLiftAggFn's: the per-column gradients
    in plain torch, then compact_fold), against torch.autograd through the
    plain source sums (_lift_sums), for random cotangents of the nets'
    lift (positions, C = 3; lift columns (B, B + 1)): within
    K5_RTOL_SCALE of dx's scale, and bitwise equal across two calls."""
    rows, TB, R, B = comp.n_mesh * comp.n_pad, comp.tb, comp.n_rings, \
        comp.band_limit
    dev = comp.sten.device
    statics = (R, B, B + 1, 256, TB)
    x = torch.randn(rows, 3, device=dev, generator=gen).requires_grad_()
    d_seg = torch.randn(rows // TB, TB, 3, R, 2, device=dev, generator=gen)
    d_mag = torch.randn(rows // TB, TB, 3, R, device=dev, generator=gen)

    def run():
        return (_compact_lift_agg_bwd(d_seg, d_mag, comp.sten, comp.meta,
                                      comp.src_idx, comp.fold_order,
                                      comp.fold_ptr, statics, rows),)

    def plain():
        idx = comp.src_idx.long()
        seg, _, mag = _lift_sums(lambda lo, hi: x[idx[lo:hi]], comp.sten,
                                 _runs(comp.meta[0], rows // TB, 256),
                                 rows // TB, 3, R, B, B + 1)
        return torch.autograd.grad((seg, mag), x, (d_seg, d_mag))

    return check_bwd("lift VJP", label, run, plain, K5_RTOL_SCALE, ("dx",))


def fold_check(label, vals, comp):
    """The compact fold against its plain version (index_add_ over every
    column), then a second call that must be bitwise equal; vals holds
    exact zeros at dead columns, as every backward gives them."""
    rows = comp.n_mesh * comp.n_pad
    args = (vals, comp.src_idx, comp.fold_order, comp.fold_ptr, rows)
    err, scale = check_fwd("compact_fold", label,
                           lambda: compact_fold(*args),
                           lambda: compact_fold_reference(vals, comp.src_idx,
                                                          rows),
                           K5_RTOL_SCALE, "out")
    return dict(shape=label, rows=rows, W=vals.shape[1], max_abs_err=err,
                max_rel_err=err / scale)


def fold_time(row, vals, comp):
    """ms of the kernel, of its plain version (zeros, then index_add_), and
    of index_add_ alone into a placed buffer (the library call); bound:
    the live columns' values and src_idx read once, the output written
    once, one add per live value."""
    rows, W = comp.n_mesh * comp.n_pad, vals.shape[1]
    idx = comp.src_idx.reshape(-1).long()
    buf = torch.zeros(rows, W, device=vals.device)
    row["ms"] = time_cuda(lambda: compact_fold(
        vals, comp.src_idx, comp.fold_order, comp.fold_ptr, rows), iters=20)
    row["plain_ms"] = time_cuda(
        lambda: compact_fold_reference(vals, comp.src_idx, rows), iters=20)
    row["library_ms"] = time_cuda(lambda: buf.index_add_(0, idx, vals),
                                  iters=20)
    live = comp.fold_order.numel()
    row.update(_bound(4 * (live * W + comp.src_idx.numel() + rows * W),
                      live * W, live_columns=live))


# --- K3 and K4 against their plain versions ---------------------------------------

def _k4_table(sten, R):
    """What a K4 call needs of a compressed band stencil (n_mesh, nb, 5, TB,
    W'), a mesh at a time: the nonzero hats and occupied slots (any nonzero
    hat) of the stencil it stands for, and the bytes it must read (the r
    plane whole, the phasor and wxp planes only in the 32-byte sectors that
    hold an occupied slot)."""
    check(sten.shape[-1] % 8 == 0,
          "the bounds count 32-byte sectors of 8 slots")
    hats = occupied = sectors = 0
    for m in range(sten.shape[0]):
        nz = _hats_from_r(sten[m, :, 0], R) != 0            # (R, nb, TB, W')
        occ = nz.any(0)
        hats += int(nz.sum().item())
        occupied += int(occ.sum().item())
        sectors += int(occ.reshape(-1, 8).any(-1).sum().item())
        del nz, occ
    slots = sten[:, :, 0].numel()
    return hats, occupied, _stencil_bytes(slots, 5, 1, sectors)


def _stencil_ops(hats, occupied, K, C, transposed=False):
    """The f32 operations of the stencil term in the cheaper of k1_bound's
    (forward) or k1_bwd_bound's (transposed) two orders."""
    per_slot = 8 if transposed else 6
    return min(occupied * K * per_slot * C + hats * K * 4 * C,
               hats * K * (8 * C + 2))


def k4_bound(g, wmat, sten, K):
    """Least time for one K4 call: bytes (the stencil as _k4_table counts
    it, g and W read once, y written once) over HBM rate, and the f32
    operations counted as in k1_bound over the f32 rate: the stencil term
    and the filter contraction 2·N·R·M·O2."""
    n_mesh, N, M = g.shape
    R, _, O2 = wmat.shape
    C = M // (2 * K)
    hats, occupied, sten_bytes = _k4_table(sten, R)
    flops = (_stencil_ops(hats, occupied, K, C)
             + 2 * n_mesh * N * R * M * O2)
    nbytes = sten_bytes + 4 * (g.numel() + wmat.numel() + n_mesh * N * O2)
    return _bound(nbytes, flops, stencil_bytes=sten_bytes,
                  stencil_bytes_whole=4 * sten.numel(),
                  slot_fill=occupied / sten[:, :, 0].numel())


def k4_bwd_bound(g, wmat, dy, sten, K):
    """Least time for one K4 backward call: bytes (the stencil as
    _k4_table counts it, g, dy and W read once, dg and dW written once) and
    the f32 operations counted as in k1_bwd_bound."""
    n_mesh, N, M = g.shape
    R, _, O2 = wmat.shape
    C = M // (2 * K)
    hats, occupied, sten_bytes = _k4_table(sten, R)
    flops = (_stencil_ops(hats, occupied, K, C)
             + _stencil_ops(hats, occupied, K, C, transposed=True)
             + 2 * 2 * n_mesh * N * R * M * O2)
    nbytes = sten_bytes + 4 * (2 * g.numel() + 2 * wmat.numel()
                               + dy.numel())
    return _bound(nbytes, flops)


def k3_bound(g, sten, R, K):
    """Least time for one K3 call: bytes (the dense stencil and g read
    once, contrib, N·R·M floats, written once: it is the function's
    output) over HBM rate, and the stencil term of k1_bound (no filter
    contraction) over the f32 rate."""
    n_mesh, N, M = g.shape
    hats, occupied = _stencil_counts(sten, R)
    flops = _stencil_ops(hats, occupied, K, M // (2 * K))
    nbytes = 4 * (sten.numel() + g.numel() + n_mesh * N * R * M)
    return _bound(nbytes, flops)


def k3_bwd_bound(dout, sten, R, K):
    """Least time for one K3 backward call: bytes (the dense stencil and
    the contrib cotangent read once, dG written once) and the transposed
    stencil term of k1_bwd_bound."""
    n_mesh, rows, M = dout.shape
    hats, occupied = _stencil_counts(sten, R)
    flops = _stencil_ops(hats, occupied, K, M // (2 * K), transposed=True)
    nbytes = 4 * (sten.numel() + dout.numel() + n_mesh * (rows // R) * M)
    return _bound(nbytes, flops)


def k4_check(label, g, wmat, sten, nh, R, B, dy, dense=None):
    """K4 forward and backward against their plain versions (y, dg and dw
    each to K4_RTOL_SCALE of its scale; a second call bitwise equal) and,
    given the dense stencil of the same EdgeTable, against K1's forward and
    backward (values within K4_K1_ATOL, gradients within K4_K1_GRAD of the
    JAX test that holds the same pair).  Returns the forward's and the
    backward's rows."""
    args = (sten, TB, nh, R, B)
    err, scale = check_fwd(
        "K4", label, lambda: band_cfused_fwd(g, wmat, *args),
        lambda: band_cfused_reference(g, wmat, *args), K4_RTOL_SCALE)
    bwd = check_bwd(
        "K4 bwd", label, lambda: band_cfused_bwd(dy, g, wmat, *args),
        lambda: band_cfused_bwd_reference(dy, g, wmat, *args), K4_RTOL_SCALE,
        ("dg", "dw"))
    shape = dict(shape=label, n_mesh=g.shape[0], N=g.shape[1], M=g.shape[2],
                 nh=nh, O2=wmat.shape[2])
    if dense is not None:
        y4, y1 = (band_cfused_fwd(g, wmat, *args),
                  band_fused_fwd(g, dense, wmat, TB, nh))
        verr = (y4 - y1).abs().max().item()
        check(verr <= K4_K1_ATOL, f"K4 {label}: y against K1's, max abs err "
                                  f"{verr} > {K4_K1_ATOL}")
        gerr = 0.0
        for a, b in zip(band_cfused_bwd(dy, g, wmat, *args),
                        band_fused_bwd(dy, g, dense, wmat, TB, nh)):
            excess = ((a - b).abs() - K4_K1_GRAD[1] * b.abs()).max().item()
            check(excess <= K4_K1_GRAD[0],
                  f"K4 bwd {label}: against K1's by {excess} over rtol "
                  f"{K4_K1_GRAD[1]}, atol {K4_K1_GRAD[0]}")
            gerr = max(gerr, (a - b).abs().max().item())
        print(f"K4 {label}: against K1 on the dense table of the same "
              f"EdgeTable: y max abs err {verr:.3e} (atol {K4_K1_ATOL}), dg "
              f"and dw max abs err {gerr:.3e} (atol {K4_K1_GRAD[0]}, rtol "
              f"{K4_K1_GRAD[1]})")
    return (dict(shape, max_abs_err=err, max_rel_err=err / scale),
            dict(shape, **bwd))


def k4_time(row, brow, g, wmat, sten, nh, R, B, dy):
    args = (sten, TB, nh, R, B)
    K = 2 * B + 1
    row["ms"] = time_cuda(lambda: band_cfused_fwd(g, wmat, *args), iters=20)
    row["host_us"] = enqueue_us(lambda: band_cfused_fwd(g, wmat, *args))
    row["plain_ms"] = time_cuda(
        lambda: band_cfused_reference(g, wmat, *args), iters=2, reps=3)
    row.update(k4_bound(g, wmat, sten, K))
    brow["ms"] = time_cuda(lambda: band_cfused_bwd(dy, g, wmat, *args),
                           iters=10)
    brow["host_us"] = enqueue_us(lambda: band_cfused_bwd(dy, g, wmat, *args),
                                 calls=10)
    brow["plain_ms"] = time_cuda(
        lambda: band_cfused_bwd_reference(dy, g, wmat, *args), iters=1,
        reps=3)
    brow.update(k4_bwd_bound(g, wmat, dy, sten, K))


def k3_check(label, g, sten, nh, R, K, dout):
    """K3 forward and backward against their plain versions (contrib and
    dg each to K3_RTOL_SCALE of its scale; a second call bitwise equal).
    Returns the forward's and the backward's rows."""
    args = (sten, TB, nh, R, K)
    err, scale = check_fwd(
        "K3", label, lambda: band_contrib_fwd(g, *args),
        lambda: band_contrib_reference(g, *args), K3_RTOL_SCALE, "contrib")
    bwd = check_bwd(
        "K3 bwd", label, lambda: (band_contrib_bwd(dout, *args),),
        lambda: (band_contrib_bwd_reference(dout, *args),), K3_RTOL_SCALE,
        ("dg",))
    shape = dict(shape=label, n_mesh=g.shape[0], N=g.shape[1], M=g.shape[2],
                 nh=nh)
    return (dict(shape, max_abs_err=err, max_rel_err=err / scale),
            dict(shape, **bwd))


def k3_time(row, brow, g, sten, nh, R, K, dout):
    args = (sten, TB, nh, R, K)
    row["ms"] = time_cuda(lambda: band_contrib_fwd(g, *args), iters=20)
    row["plain_ms"] = time_cuda(lambda: band_contrib_reference(g, *args),
                                iters=2, reps=3)
    row.update(k3_bound(g, sten, R, K))
    brow["ms"] = time_cuda(lambda: band_contrib_bwd(dout, *args), iters=20)
    brow["plain_ms"] = time_cuda(
        lambda: band_contrib_bwd_reference(dout, *args), iters=2, reps=3)
    brow.update(k3_bwd_bound(dout, sten, R, K))


def random_comp(n_mesh, nb, R, nh, gen):
    """A random compressed band stencil (n_mesh, nb, 5, TB, (2nh+1)·TB):
    ~60% empty slots (R_SENTINEL in r, zero wxp), r uniform in [0, 1] at
    the others, unit phasors, random wxp."""
    shape = (n_mesh, nb, TB, (2 * nh + 1) * TB)
    dev = gen.device
    empty = torch.rand(shape, device=dev, generator=gen) < 0.6
    r = torch.rand(shape, device=dev, generator=gen).masked_fill(empty, 9.0)
    th = torch.rand(shape, device=dev, generator=gen) * (2 * np.pi)
    w = torch.randn((2, *shape), device=dev, generator=gen).masked_fill(
        empty, 0.0)
    return torch.stack([r, torch.cos(th), torch.sin(th), w[0], w[1]], dim=2)


def unfused_check(label, banded, dev, gen, C=32):
    """One field_conv_banded with fuse_filters=False (K3 each way, then the
    filter product) against fuse_filters=True (K1 each way) on the same
    card: y and the gradients of x and of the three filter tensors, each
    within K3_RTOL_SCALE of its scale."""
    B, R = banded.band_limit, banded.n_rings
    lead = (banded.sten_band.shape[0], banded.n_pad)
    x = torch.randn(*lead, C, 2, device=dev, generator=gen)
    filt = [0.2 * torch.randn(sh, device=dev, generator=gen)
            for sh in ((C, C, R), (C, C, R, B, 2), (C, C, B + 1))]
    dy = torch.randn(*lead, C, 2, device=dev, generator=gen)
    outs = []
    for fuse in (False, True):
        t = [a.clone().requires_grad_() for a in (x, *filt)]
        y = field_conv_banded(t[0], banded, *t[1:], 1, fuse_filters=fuse)
        y.backward(dy)
        outs.append([y.detach()] + [a.grad for a in t])
    errs = []
    for name, a, b in zip(("y", "dx", "dzonal", "dspherical", "dphase"),
                          *outs):
        err, scale = (a - b).abs().max().item(), b.abs().max().item()
        check(err <= K3_RTOL_SCALE * scale,
              f"unfused {label}: {name} max abs err {err} > {K3_RTOL_SCALE} "
              f"x {scale}")
        errs.append(f"{name} {err / scale:.2e}")
    print(f"unfused conv {label}: fuse_filters=False (K3) against True (K1) "
          f"on the card, rel err {', '.join(errs)} (tolerance "
          f"{K3_RTOL_SCALE} of each one's scale)")


# --- K8 against its plain version -------------------------------------------------

def host_table(table, m=0):
    """Mesh m of a batch's stacked EdgeTable, on the host (the fields the
    block-layout builders read)."""
    return dataclasses.replace(table, **{
        f: getattr(table, f)[m].cpu() for f in ("src", "mask", "rsten",
                                                "fwxp", "ln", "wxp")})


def block_sparse_of(batch):
    """Path D's conv table of a batch: each mesh's BlockSparseTable built on
    the host from the batch's own EdgeTable (tb = TB) and stacked, placed
    on the batch's device, as the JAX package's callers build it."""
    tabs = [build_block_sparse_banded(host_table(batch.table, m), tb=TB)
            for m in range(batch.pos.shape[0])]
    return stack_block_sparse_tables(tabs).to(batch.pos.device)


def as_block_sparse(batches):
    """Path D: each batch with its block-sparse table as the conv table
    (every conv through K8; ECHO and the lift stay on the batch's panels),
    as the JAX batched_apply accepts it."""
    return [dataclasses.replace(b, banded=block_sparse_of(b))
            for b in batches]


def as_compressed(batches):
    """Each banded batch with the compressed band of its own EdgeTable as
    the conv table (K4 convs; ECHO and the lift stay on the batch's
    panels): a third route of the same function, for route_check's CPU
    spread."""
    out = []
    for b in batches:
        tabs = [build_compressed_banded(host_table(b.table, m), tb=TB)
                for m in range(b.pos.shape[0])]
        check(len({t.nh for t in tabs}) == 1, "the meshes' nh differ")
        sten = torch.stack([t.sten_band for t in tabs]).to(b.pos.device)
        out.append(dataclasses.replace(
            b, banded=dataclasses.replace(tabs[0], sten_band=sten)))
    return out


def k8_bound(g, sten, nbr, wmat):
    """Least time for one K8 call: k1_bound over the block-sparse planes
    (each read once, with g and W, y written once; the stencil term from
    this table's nonzero radial weights), plus nbr's bytes."""
    b = k1_bound(g, sten, wmat)
    return _bound(b["bytes"] + 4 * nbr.numel(), b["flops"],
                  slot_fill=b["slot_fill"],
                  rings_per_slot=b["rings_per_slot"])


def k8_bwd_bound(g, sten, nbr, wmat):
    """Least time for one K8 backward call: k1_bwd_bound over the
    block-sparse planes (dG written once, not once per panel), plus nbr's
    bytes."""
    b = k1_bwd_bound(g, sten, wmat)
    return _bound(b["bytes"] + 4 * nbr.numel(), b["flops"])


def k8_check(label, tab, C, O2, gen, dense=None, plain=(2, 3)):
    """K8 forward and backward on BlockSparseTable ``tab`` (on the card)
    against their plain versions (y, dg and dw each to K8_RTOL_SCALE of its
    scale; both directions bitwise against a second call) and, given
    ``dense`` (the BandedTable of the same EdgeTable), against K1's forward
    and backward (each output to K8_RTOL_SCALE of K1's scale); then each
    direction timed beside its plain version (``plain``: iters, reps) and
    its bound.  Returns the forward's and the backward's rows."""
    R, K = tab.n_rings, tab.k_width
    sten = tab.sten_band.reshape(-1, *tab.sten_band.shape[-4:])
    nbr = tab.nbr.reshape(-1, *tab.nbr.shape[-2:])
    n_mesh, N = nbr.shape[0], nbr.shape[1] * TB
    dev = sten.device
    g = torch.randn(n_mesh, N, K * 2 * C, device=dev, generator=gen)
    wmat = torch.randn(R, K * 2 * C, O2, device=dev, generator=gen) / 40.0
    dy = torch.randn(n_mesh, N, O2, device=dev, generator=gen)
    args = (TB, R, K)
    inv = (tab.inv_ptr, tab.inv_bj)

    def fwd():
        return band_sparse_fwd(g, wmat, sten, nbr, *args)

    def bwd():
        return band_sparse_bwd(dy, g, wmat, sten, nbr, *inv, *args)

    err, scale = check_fwd(
        "K8", label, fwd,
        lambda: band_sparse_reference(g, wmat, sten, nbr, *args),
        K8_RTOL_SCALE)
    brow = check_bwd(
        "K8 bwd", label, bwd,
        lambda: band_sparse_bwd_reference(dy, g, wmat, sten, nbr, *args),
        K8_RTOL_SCALE, ("dg", "dw"))
    shape = dict(shape=label, n_mesh=n_mesh, N=N, M=g.shape[2], nj=tab.nj,
                 O2=O2)
    if dense is not None:
        ds = dense.sten_band.reshape(-1, *dense.sten_band.shape[-4:])
        errs = []
        for name, a, b in zip(
                ("y", "dg", "dw"), (fwd(), *bwd()),
                (band_fused_fwd(g, ds, wmat, TB, dense.nh),
                 *band_fused_bwd(dy, g, ds, wmat, TB, dense.nh))):
            e, sc = (a - b).abs().max().item(), b.abs().max().item()
            check(e <= K8_RTOL_SCALE * sc,
                  f"K8 {label}: {name} against K1's, max abs err {e} > "
                  f"{K8_RTOL_SCALE} x {sc}")
            errs.append(f"{name} {e / sc:.2e}")
        print(f"K8 {label}: against K1 on the dense table of the same "
              f"EdgeTable, rel err {', '.join(errs)} (tolerance "
              f"{K8_RTOL_SCALE} of each one's scale)")
    row = dict(shape, max_abs_err=err, max_rel_err=err / scale)
    brow = dict(shape, **brow)
    if plain is not None:
        big = N * n_mesh > 100_000
        row["ms"] = time_cuda(fwd, iters=5 if big else 20)
        row["plain_ms"] = time_cuda(
            lambda: band_sparse_reference(g, wmat, sten, nbr, *args),
            iters=plain[0], reps=plain[1], warmup=1)
        row.update(k8_bound(g, sten, nbr, wmat))
        brow["ms"] = time_cuda(bwd, iters=3 if big else 10)
        brow["plain_ms"] = time_cuda(
            lambda: band_sparse_bwd_reference(dy, g, wmat, sten, nbr, *args),
            iters=plain[0], reps=plain[1], warmup=1)
        brow.update(k8_bwd_bound(g, sten, nbr, wmat))
    return row, brow


def sparse_stats(tab):
    """NJ, the mean live source blocks per target block, and the GB of the
    table's stencil."""
    nb = tab.nbr.numel() // tab.nj
    return (tab.nj, tab.inv_bj.shape[0] / nb,
            4 * tab.sten_band.numel() / 1e9)


def stencil_mb(batch):
    """MB of the dense band stencil and of the compressed one in a banded
    batch."""
    return (4 * batch.banded.sten_band.numel() / 1e6,
            4 * batch.comp.sten_band.numel() / 1e6)


def compact_stats(kind, rows, card):
    """The kernel rows' times, then what each table holds."""
    print_times(kind, rows, card)
    for r in rows:
        print(f"{kind} {r['shape']}: {r['panels']} panels of {r['tbt']} x "
              f"{r['ts']} slots, {r.get('occupied', r.get('edges'))} occupied"
              f" slots (fill {r['slot_fill']:.4f}), {r['live_rows']} source "
              f"rows read, {r['bytes'] / 1e9:.3f} GB needed in all")


def top_two_gap(logits):
    """Per-row gap between the largest and second-largest logit."""
    part = np.partition(logits, -2, axis=-1)
    return part[..., -1] - part[..., -2]


def serve_counted(serve, recs, batches, want):
    """A per-vertex serving path, counted: every batch warmed up, the
    counts set to 0, then each batch of ``serve[k]`` served once and held
    to launch exactly ``want[k]`` (kernel name -> count).  Returns the
    path's launch counts and the outputs by key."""
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
        check(grew == want[k], f"{k}: one batch launched {grew}, want "
                               f"{want[k]}")
    return dict(kernels.launches), served


def as_cbanded(batches):
    """Path B: each banded batch with its compressed table as the conv
    table too (every conv through K4), as the JAX FieldConv and
    batched_apply accept it."""
    return [dataclasses.replace(b, banded=b.comp) for b in batches]


def cpu_predict(p, recs, cpu_net, alt=None):
    """The outputs on ``recs`` of Predictor ``p`` on the CPU, holding
    ``cpu_net`` (plain versions; with ``alt``, on the batches it makes of
    the CPU's)."""
    cpu_p = Predictor(cpu_net, p.config, batch_size=p.batch_size,
                      banded_tb=TB, device="cpu")
    return cpu_p.predict(recs, batches=alt(cpu_p.make_batches(recs))
                         if alt else None)


def match_cpu(k, p, recs, served, cpu, ref=None):
    """The card's outputs ``served`` of Predictor ``p`` against ``cpu``,
    cpu_predict's of the same Predictor or, given ``ref``, of the
    Predictor of that shape (the same preset, weights and records on the
    preset's own route: every route computes the same function): logits
    within LOGIT_RTOL / LOGIT_ATOL, labels / maps equal wherever the CPU's
    top-two logit gap exceeds LABEL_GAP."""
    key = "labels" if p.config.task == "segmentation" else "map"
    n_close = n_all = 0
    diff = 0.0
    for a, b, r in zip(served, cpu, recs):
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
    print(f"serve {k}: {key} match the CPU run"
          f"{f' of {ref}' if ref else ''} at every vertex whose "
          f"top-two logit gap exceeds {LABEL_GAP} ({n_close} of {n_all} "
          f"vertices fall below it); max logit diff {diff:.3e} (rtol "
          f"{LOGIT_RTOL}, atol {LOGIT_ATOL})")


def print_times(kind, rows, card):
    for r in rows:
        print(f"{kind} {r['shape']}: kernel {r['ms']:.4f} ms/call, plain "
              f"{r['plain_ms']:.4f} ms/call, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}; {r['bytes'] / 1e6:.1f} MB, "
              f"{r['flops'] / 1e9:.2f} GFLOP needed)"
              + (f", host {r['host_us']:.1f} us a call to enqueue"
                 if "host_us" in r else "") + f" on {card}")


def time_request(k, p, rs_, bs_, what, card, large=False, passes=False):
    """One request shape of Predictor ``p`` timed: the host clock around
    predict (the forward over placed tables and the output copy), then one
    predict under the profiler (wall, device busy share, top kernels).  A
    large request (N_LARGE) also times Predictor.logits alone and reads the
    peak device memory of one request beside what was allocated before it.
    A large request (2.0-2.8 s) is timed once, with no warm-up call: its
    path ran in the serving phases.  ``passes``: also K6's kernels by
    pass."""
    reps, warm = (1, False) if large else (3, True)
    if large:
        def logits_synced():
            p.logits(bs_[0])
            torch.cuda.synchronize()

        torch.cuda.synchronize()
        base_gb = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        ms = time_host(logits_synced, reps=reps, warmup=warm)
        print(f"request {k}: Predictor.logits {ms:.3f} ms on the placed "
              f"batch (ending in a sync, the logits left on the card), "
              f"peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
              f"({base_gb:.2f} GB allocated before it), on {card}")
    ms = time_host(lambda: p.predict(rs_, batches=bs_), reps=reps,
                   warmup=warm)
    print(f"request {k}: {ms:.3f} ms per request (forward over placed "
          f"tables, {what}) on {card}")
    wall, busy, kern, *by = request_breakdown(
        lambda: p.predict(rs_, batches=bs_), top=8 if large else 6,
        passes=K6_PASSES if passes else ())
    print(f"request {k} under the profiler: wall {wall:.3f} ms, device "
          f"busy {busy:.3f} ms ({100 * busy / wall:.1f}%) on {card}; "
          "top kernels:")
    for t, name, count in kern:
        print(f"    {t:8.3f} ms  x{count:<4d} {name[:90]}")
    if passes:
        print_passes(f"request {k}", by[0], card)


def read_losses(path):
    with open(path) as f:
        return [json.loads(line)["loss"] for line in f]


def path_kernels(cfg, n_pad):
    """The conv and ECHO kernels (launch-count names without _fwd / _bwd)
    that a net of ``cfg`` runs on a bucket of n_pad samples: K1, K5 on the
    pure-panel layout or K6 on the all-compact route; K2, or K7 with the
    compact ECHO, or none with the banded ECHO (plain torch)."""
    panel = resolve_layout(cfg, n_pad) == "panel"
    compact = cfg.task != "classification" and cfg.echo_impl == "compact"
    conv = ("band_compact" if panel and compact and cfg.conv_impl == "compact"
            else "band_panel" if panel else "band_fused")
    if cfg.task == "classification" or cfg.echo_impl == "banded":
        return conv, None
    return conv, "echo_compact" if compact else "echo_panel"


def step_launches(cfg, n_pad, n, steps, passes):
    """The launches of ``steps`` training steps and ``passes`` forward
    passes (the steps' and the test batches') of a net of ``cfg`` with n
    convs per pass.  The fold kernel runs as the last pass of each K6 and
    K7 backward."""
    conv, echo = path_kernels(cfg, n_pad)
    want = {f"{conv}_fwd": n * passes, f"{conv}_bwd": n * steps}
    if echo is not None:
        want.update({f"{echo}_fwd": passes, f"{echo}_bwd": steps})
    if echo == "echo_compact":
        want["compact_fold"] = steps * (1 + (n if conv == "band_compact"
                                             else 0))
    return {name: c for name, c in want.items() if c}


def step_what(cfg, n_pad, n, conv=None):
    """What a step launches, in words (``conv``: the conv kernel when the
    batch's tables do not say it, K4 on path B)."""
    conv_, echo = path_kernels(cfg, n_pad)
    conv = conv or conv_
    what = f"{n} {SHORT[conv]} fwd + {n} {SHORT[conv]} bwd"
    if echo is not None:
        what += f" + 1 {SHORT[echo]} fwd + 1 {SHORT[echo]} bwd"
    return what


def fit_counted(k, cfg, n_classes, train, test, bs, dev, seed, tmp):
    """fit ``cfg`` on the card (the main path, counted) at training shape
    ``k``.  Each step must launch the conv kernel of the bucket's route (K1,
    K5 on the pure-panel layout, K6 on the all-compact route) forward and
    backward CONVS_PER_PASS[k] times each and, for the ECHO presets, the
    ECHO kernel's (K2, or K7 with the compact ECHO) forward and backward
    once each; each test batch the forward ones; the fold as
    step_launches counts it.  Every loss must be finite, and the test
    metric.  Returns the net, the optimizer, the metric, the losses, the
    launches and the fit's seconds."""
    before = dict(kernels.launches)
    t0 = time.perf_counter()
    net, opt, metric = fit(cfg, train, test, n_classes=n_classes,
                           batch_size=bs, banded_tb=TB,
                           log_path=os.path.join(tmp, f"{k}.jsonl"),
                           seed=seed, device=dev)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    grew = {n: c - before.get(n, 0) for n, c in kernels.launches.items()
            if c != before.get(n, 0)}
    steps = cfg.epochs * len(train) // bs
    passes = steps + -(-len(test) // bs)           # forward passes
    want = step_launches(cfg, shared_bucket(train + test)[0],
                         CONVS_PER_PASS[k], steps, passes)
    check(int(opt.step.item()) == steps,
          f"{k}: fit ran {opt.step} steps, want {steps}")
    check(grew == want, f"{k}: fit launched {grew}, want {want}")
    losses = read_losses(os.path.join(tmp, f"{k}.jsonl"))
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"{k}: card losses {losses}")
    check(not test or np.isfinite(metric), f"{k}: test metric {metric}")
    return net, opt, metric, losses, grew, fit_s


def cpu_first_epoch(cfg, train, n_classes, bs, seed):
    """The losses of the first epoch of ``fit(cfg, train, device="cpu")``
    (batch ``bs``, no checkpoints) and its seconds.  fit_phase's CPU
    reference: chip_smoke runs it in a worker process (CPU_THREADS torch
    threads) beside the card's phases."""
    torch.set_num_threads(CPU_THREADS)
    cfg = dataclasses.replace(cfg, epochs=1, checkpoint_every=1,
                              checkpoint_dir=None)
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "cpu.jsonl")
        t0 = time.perf_counter()
        fit(cfg, train, None, n_classes=n_classes, batch_size=bs,
            banded_tb=TB, log_path=log, seed=seed, device="cpu")
        return read_losses(log), time.perf_counter() - t0


def fit_phase(k, cfg, n_classes, recs, dev, seed, tmp, cpu_job, ref):
    """fit_counted for TRAIN_EPOCHS epochs, checkpointing every epoch, and
    the first epoch of the same preset's fit on the CPU (``cpu_job``, the
    future of cpu_first_epoch at shape ``ref``: the same records, batch
    size and seed on the preset's own route), at training shape ``k``:
    ``recs`` holds the train records then the test records (TRAIN_FIT[k]).
    The first epoch's losses must match the CPU's.  Returns the card run's
    net and optimizer."""
    n_train, bs, _ = TRAIN_FIT[k]
    train, test = recs[:n_train], recs[n_train:]
    ck = dataclasses.replace(cfg, epochs=TRAIN_EPOCHS, checkpoint_every=1,
                             checkpoint_dir=os.path.join(tmp, f"ck_{k}"))
    net, opt, metric, losses, grew, fit_s = fit_counted(
        k, ck, n_classes, train, test, bs, dev, seed, tmp)
    steps = len(losses)
    latest = CheckpointManager(ck.checkpoint_dir).latest_step()
    check(latest == steps, f"{k}: latest checkpoint {latest}, want {steps}")

    t0 = time.perf_counter()
    cpu, cpu_s = cpu_job.result()
    wait_s = time.perf_counter() - t0
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
    print(f"train {k}: the first {len(cpu)} losses match the CPU fit of "
          f"{ref} ({cpu}, {cpu_s:.1f} s, waited for {wait_s:.1f} s): |diff| "
          f"{diffs} (step 1 within {LOSS_ATOL_STEP1}, later within "
          f"{LOSS_ATOL_LATER})")
    return net, opt


def fit_large(k, cfg, n_classes, recs, dev, seed, tmp, test_batch):
    """fit_counted at N_LARGE: the one record of ``recs`` trains for
    LARGE_EPOCHS epochs (the preset's count is the one cut); then
    evaluate_task tests it on ``test_batch``, the serving phase's placed
    batch of the same record, counted (forward launches only), rather than
    on a second build of its tables.  No CPU run at this size.  Returns
    the net and optimizer."""
    ck = dataclasses.replace(cfg, epochs=LARGE_EPOCHS)
    net, opt, _, losses, grew, fit_s = fit_counted(
        k, ck, n_classes, recs, [], 1, dev, seed, tmp)
    before = dict(kernels.launches)
    metric = evaluate_task(net, ck, [test_batch], n_classes)
    torch.cuda.synchronize()
    evaluated = {n: c - before.get(n, 0) for n, c in kernels.launches.items()
                 if c != before.get(n, 0)}
    want = step_launches(ck, test_batch.pos.shape[1], CONVS_PER_PASS[k], 0, 1)
    check(evaluated == want,
          f"{k}: evaluate_task launched {evaluated}, want {want}")
    check(np.isfinite(metric), f"{k}: test metric {metric}")
    print(f"train {k}: fit on the card, {len(losses)} steps of batch 1 "
          f"(epochs cut from the preset's {cfg.epochs} to {LARGE_EPOCHS}, "
          f"nothing else cut; {fit_s:.1f} s with the train table build), "
          f"losses {losses}, launches {grew}; evaluate_task on the serving "
          f"batch of the same record launched {evaluated}: test cross "
          f"entropy {metric:.4f} (random labels)")
    return net, opt


def step_counted(k, cfg, n_classes, batch, dev, seed):
    """One make_train_step step, counted, of a net of ``cfg`` with the
    weights fit would draw from ``seed`` on a placed ``batch``: the
    launches step_launches counts and a finite loss.  Returns the net and
    its optimizer."""
    net = build_model(cfg, n_classes,
                      generator=torch.Generator().manual_seed(seed),
                      device=dev)
    opt = make_optimizer(cfg, net.parameters())
    step = make_train_step(net, cfg, n_classes, opt)
    before = dict(kernels.launches)
    loss = step(batch, torch.Generator().manual_seed(seed + 3))
    torch.cuda.synchronize()
    grew = {n: c - before.get(n, 0) for n, c in kernels.launches.items()
            if c != before.get(n, 0)}
    want = step_launches(cfg, batch.pos.shape[1], CONVS_PER_PASS[k], 1, 1)
    check(grew == want, f"{k}: a step launched {grew}, want {want}")
    check(torch.isfinite(loss).item(), f"{k}: loss {loss}")
    print(f"train {k}: one make_train_step step on the serving batch, loss "
          f"{loss.item():.4f}, launches {grew}")
    return net, opt


def grad_bar(own, spread):
    """The bar of a gradient whose largest entry on the CPU is ``own`` and
    whose two CPU routes differ by ``spread`` (GRAD_SPREAD)."""
    return max(K1_RTOL_SCALE * own, GRAD_SPREAD * spread)


def route_grads(net, cfg, n_classes, batch, kw):
    """The loss of ``net`` on ``batch`` (keywords ``kw``), every
    parameter's gradient (on the CPU) and the lift's (call arguments,
    output gradient)."""
    cap = {}
    hook = net.lift.field.register_forward_hook(
        lambda mod, args, o: cap.update(args=args, out=o))
    loss = make_loss_fn(net, cfg, n_classes)(batch, **kw)
    hook.remove()
    grads = torch.autograd.grad(loss, list(net.parameters()) + [cap["out"]])
    return loss.item(), [g.cpu() for g in grads[:-1]], (cap["args"],
                                                         grads[-1])


def cpu_weights(net):
    """``net``'s state as numpy arrays, which cross to a worker process by
    value."""
    return {n: v.detach().cpu().numpy() for n, v in net.state_dict().items()}


def as_tensors(arrays):
    return {n: torch.from_numpy(a) for n, a in arrays.items()}


def route_cpu(cfg, n_classes, weights, recs, seed, alt=as_cbanded, name="B",
              spread_alts=()):
    """route_check's CPU side, which chip_smoke runs in a worker process
    beside the card's phases: the batch of ``recs`` built on the CPU, the
    augmentation and (correspondence) dropout mask drawn, and a net of
    ``cfg`` holding ``weights`` (cpu_weights'): its loss and every gradient
    on path A and on path ``name`` (the batch ``alt`` makes), the lift's
    terms on path A (lift_terms, and the lift output's gradient), and each
    gradient's rounding spread: the largest difference of path A's from
    path ``name``'s and from each route ``spread_alts`` make.  Returns a
    dict of numpy arrays and numbers."""
    torch.set_num_threads(CPU_THREADS)
    batch = make_batches(recs, cfg, len(recs), TB, device="cpu")[0]
    gen = torch.Generator().manual_seed(seed + 3)
    aug = draw_rotate_scale(gen, batch.pos.shape[0], cfg.random_rotate_deg,
                            cfg.random_scale)
    net = build_model(cfg, n_classes, device="cpu")
    net.load_state_dict(as_tensors(weights))
    mask = (draw_dropout_mask(gen, net, batch)
            if cfg.task == "correspondence" else None)
    kw = dict(aug=aug, dropout_mask=mask)
    out = {path: route_grads(net, cfg, n_classes, b, kw)
           for path, b in (("A", batch), (name, alt([batch])[0]))}
    others = [out[name][1]]
    for make in spread_alts:
        loss = make_loss_fn(net, cfg, n_classes)(make([batch])[0], **kw)
        others.append(torch.autograd.grad(loss, list(net.parameters())))
    spread = [max((a - o[i]).abs().max().item() for o in others)
              for i, a in enumerate(out["A"][1])]
    lift_args, lift_gout = out["A"][2]
    return dict(aug=tuple(None if a is None else a.numpy() for a in aug),
                mask=None if mask is None else mask.numpy(),
                loss={p: o[0] for p, o in out.items()},
                grads={p: [g.numpy() for g in o[1]] for p, o in out.items()},
                lift=tuple(t.numpy() for t in (*lift_terms(lift_args),
                                               lift_gout)),
                spread=spread)


def route_check(k, cfg, n_classes, weights, batch, cpu, dev, alt=as_cbanded,
                name="B", conv="K4"):
    """A route's gradient check at shape ``k``: a net of ``cfg`` holding
    ``weights`` (cpu_weights'), its loss and every parameter's gradient on
    the card against the same net's on the CPU (``cpu``: route_cpu's
    result for the same records, weights, seed, ``alt`` and ``name``, or
    its future), with the same augmentation and dropout mask, on ``batch``
    (path A: its own conv table, K1) and on the batch ``alt`` makes of it
    (path ``name``, every conv through ``conv``: path B's compressed
    table, K4, or path D's block-sparse one, K8).  Each loss within
    LOSS_ATOL_STEP1; each gradient within grad_bar of its CPU route's,
    given route_cpu's spread; the lift's zonalMag against the CPU's plus
    lift_flip_term's sign term (the subgradient of |M| at the entries where
    the card's M and the CPU's differ in sign), once M is held to rounding
    (FLIP_GAP_REL, MAX_FLIPS).
    Returns the card's net on path ``name``, a fresh optimizer of it, the
    step's inputs ({dev: the aug and dropout_mask keywords, "cpu_loss": the
    CPU's loss on path ``name``}) and each parameter's rounding spread
    relative to its own scale (the CPU's two routes and the card's path A
    against the CPU's: the larger)."""
    t0 = time.perf_counter()
    if not isinstance(cpu, dict):
        cpu = cpu.result()
    wait_s = time.perf_counter() - t0
    cpu = dict(cpu, grads={p: [torch.from_numpy(g) for g in gs]
                           for p, gs in cpu["grads"].items()},
               lift=tuple(torch.from_numpy(a) for a in cpu["lift"]))
    cpu_net = build_model(cfg, n_classes, device="cpu")
    cpu_net.load_state_dict(as_tensors(weights))
    net = build_model(cfg, n_classes, device=dev)
    net.load_state_dict(as_tensors(weights))
    kw = {dev: dict(aug=tuple(None if a is None else torch.from_numpy(a).to(
                        dev) for a in cpu["aug"]),
                    dropout_mask=None if cpu["mask"] is None
                    else torch.from_numpy(cpu["mask"]).to(dev))}
    out = {path: route_grads(net, cfg, n_classes, b_, kw[dev])
           for path, b_ in (("A", batch), (name, alt([batch])[0]))}
    names = [n for n, _ in cpu_net.named_parameters()]
    flip, n_flips, m_gap, m_flip, m_max = lift_flip_term(
        cpu_net.lift.field, cpu["lift"], out["A"][2][0])
    check(m_gap <= FLIP_GAP_REL * m_max and m_flip <= FLIP_GAP_REL * m_max
          and n_flips <= MAX_FLIPS,
          f"{k}: the lift's M on the card is {m_gap:.3e} from the CPU's "
          f"(max|M| {m_max:.3e}), {n_flips} entries differ in sign, the "
          f"largest |M| among them {m_flip:.3e}: more than rounding "
          f"(FLIP_GAP_REL {FLIP_GAP_REL}, MAX_FLIPS {MAX_FLIPS})")
    adjust = {"lift.field.zonalMag": flip}
    spread = cpu["spread"]
    own = {n: max(b.abs().max().item(), 1e-30)
           for n, b in zip(names, cpu["grads"]["A"])}
    print(f"train {k}: the lift's magnitude sums M (card against CPU within "
          f"{m_gap:.3e}, {m_gap / m_max:.3e} of max|M| {m_max:.3e}) differ "
          f"in sign at {n_flips} entries (|M| <= {m_flip:.3e}); their "
          f"subgradient moves the CPU's zonalMag gradient by "
          f"{flip.abs().max().item() / own['lift.field.zonalMag']:.3e} of "
          "its scale (the sign term, added to the CPU's before it is held; "
          f"the CPU's side waited for {wait_s:.1f} s)")
    for path in ("A", name):
        dloss = abs(out[path][0] - cpu["loss"][path])
        check(dloss <= LOSS_ATOL_STEP1,
              f"{k} path {path}: loss {out[path][0]} on the card, "
              f"{cpu['loss'][path]} on the CPU")
        hold_grads(f"{k} path {path}", names, out[path][1],
                   cpu["grads"][path], spread,
                   f"every conv through {'K1' if path == 'A' else conv}: "
                   f"loss {out[path][0]:.6f} on the card, |diff| "
                   f"{dloss:.3e} from the CPU's (within {LOSS_ATOL_STEP1})",
                   adjust=adjust)
    kw["cpu_loss"] = cpu["loss"][name]
    # each gradient's rounding spread relative to its scale: the CPU's two
    # routes, and the card's path A against the CPU's (sign term added)
    rel = {n: max(s_, (a - b - adjust.get(n, 0.0)).abs().max().item())
           / own[n] for n, s_, a, b in zip(names, spread, out["A"][1],
                                           cpu["grads"]["A"])}
    return net, make_optimizer(cfg, net.parameters()), kw, rel


def lift_terms(args):
    """The lift's (contribAng, contribMag) recomputed from its call
    arguments ``args``, as the lift forms them."""
    x, table, cols, comp = args
    with torch.no_grad():
        return lift_contribs(x.detach(), table, cols, comp=comp)


def lift_flip_term(field, cpu_terms, dev_args):
    """The lift's rho = |M| (M = Σ_r contribMag·zonalMag, ops/trans_field.py
    ::trans_field_weight) takes subgradient +1 at M ≥ 0 and −1 below, so an
    entry whose M lies within rounding of 0 and differs in sign between two
    devices moves zonalMag's gradient by 2·dρ·contribMag, though ρ is the
    same.  ``field``: the CPU net's TransField; ``cpu_terms``: the CPU's
    (contribAng, contribMag, the TransField output's gradient);
    ``dev_args``: the TransField's call arguments on the card.  Recomputes M on each device as the lift forms it and
    returns (the CPU's zonalMag gradient with the card's signs minus the
    same with its own, the entries whose signs differ, max |M_card −
    M_CPU|, the largest |M| of either device at those entries, max
    |M_CPU|); the caller holds the last three to rounding (FLIP_GAP_REL,
    MAX_FLIPS) before it adds the term."""
    def m_of(mag, zm):
        return torch.einsum("...ncr,ocr->...noc", mag, zm)

    ang, mag, gout = cpu_terms
    zm_dev = dev_args[0].new_tensor(field.zonalMag.detach().numpy())
    m_cpu = m_of(mag, field.zonalMag.detach())
    m_dev = m_of(lift_terms(dev_args)[1], zm_dev).cpu()
    signs = [torch.where(m < 0, -1.0, 1.0) for m in (m_cpu, m_dev)]
    A = torch.einsum("...ncrp,ocr->...nocp", ang, field.zonalAng.detach())
    phi = soft_angle(A)
    if field.ftype == 1:
        phi = phi + field.phase.detach()

    def grad_zm(sign):
        zm = field.zonalMag.detach().clone().requires_grad_()
        rho = m_of(mag, zm) * sign
        out = torch.sum(cpolar(rho, phi), dim=-2)
        return torch.autograd.grad(out, zm, gout)[0]

    flips = signs[0] != signs[1]
    m_flip = (torch.maximum(m_cpu.abs(), m_dev.abs())[flips].max().item()
              if flips.any() else 0.0)
    return (grad_zm(signs[1]) - grad_zm(signs[0]), int(flips.sum().item()),
            (m_dev - m_cpu).abs().max().item(), m_flip,
            m_cpu.abs().max().item())


def hold_grads(what, names, got, want, spread, head, adjust=None):
    """Each gradient of ``got`` within grad_bar of ``want``'s (plus
    ``adjust``'s term for the names it holds), given each one's
    ``spread``; no bar above GRAD_BAR_CAP of the gradient's own scale.
    Prints the worst error and the widened bars."""
    adjust = adjust or {}
    worst, widened = (0.0, ""), []
    for name, a, b, s_ in zip(names, got, want, spread):
        own = b.abs().max().item()
        bar = grad_bar(own, s_)
        err = (a - b - adjust.get(name, 0.0)).abs().max().item()
        check(bar <= GRAD_BAR_CAP * own,
              f"{what}: {name}'s routes differ by {s_}, too much to hold "
              f"its gradient (scale {own})")
        check(err <= bar, f"{what}: gradient of {name} max abs err {err} "
                          f"> {bar} (scale {own}, spread {s_})")
        worst = max(worst, (err / max(own, 1e-30), name))
        if bar > K1_RTOL_SCALE * own:
            widened.append(f"{name} (scale {own:.3e}, spread {s_ / own:.3e}"
                           f", card {err / own:.3e})")
    print(f"train {what} ({head}); the largest gradient error is "
          f"{worst[0]:.3e} of its parameter's own scale ({worst[1]}); bar "
          f"{K1_RTOL_SCALE} of the own scale, widened to {GRAD_SPREAD}x the "
          f"spread for {'; '.join(widened) or 'none'}")


def logits_close(a, b, rows=16384):
    """The largest |a − b| of two logit tensors on the card, and the
    largest excess of |a − b| over LOGIT_RTOL·|b| (to be held within
    LOGIT_ATOL), ``rows`` rows at a time; both must be finite."""
    check(torch.isfinite(a).all().item() and torch.isfinite(b).all().item(),
          "non-finite logits")
    worst = excess = 0.0
    for lo in range(0, a.shape[-2], rows):
        d = (a[..., lo:lo + rows, :] - b[..., lo:lo + rows, :]).abs()
        worst = max(worst, d.max().item())
        excess = max(excess, (d - LOGIT_RTOL * b[..., lo:lo + rows, :].abs())
                     .max().item())
    return worst, excess


def large_block_sparse_steps(k, cfg, weights, panel_batch, bsp_batch,
                             compact_batch, rel_spread, dev, seed):
    """Path D's training at N_LARGE: a net of ``cfg`` holding ``weights``,
    its loss and every gradient on ``bsp_batch`` (K8 convs) against the
    same on ``panel_batch`` (K5's route, the same function) on the card,
    with the same augmentation and dropout mask, each gradient within
    grad_bar of K5's.  No CPU run at this size: the spread is K5's route
    against the all-compact route on ``compact_batch`` (K6, K7 and the
    compact lift: a third route of the same function, on the card) or
    ``rel_spread`` (each parameter's rounding spread relative to its own
    scale at corr_n5120_b1, route_check's) times the parameter's scale,
    whichever is larger.  Then LARGE_EPOCHS make_train_step steps on
    ``bsp_batch``, counted (17 K8 + 1 K2 each way a step), each loss
    finite.  Returns ((net, optimizer), the launches)."""
    net = build_model(cfg, N_CORR_CLASSES, device=dev)
    net.load_state_dict(weights)
    gen = torch.Generator().manual_seed(seed + 3)
    aug = draw_rotate_scale(gen, 1, cfg.random_rotate_deg, cfg.random_scale)
    kw = dict(aug=tuple(None if a is None else a.to(dev) for a in aug),
              dropout_mask=draw_dropout_mask(gen, net, bsp_batch).to(dev))
    names = [n for n, _ in net.named_parameters()]
    out = {}
    for path, b in (("K5", panel_batch), ("D", bsp_batch),
                    ("K6", compact_batch)):
        loss = make_loss_fn(net, cfg, N_CORR_CLASSES)(b, **kw)
        grads = torch.autograd.grad(loss, list(net.parameters()))
        out[path] = (loss.item(), [g.cpu() for g in grads])
        del loss, grads
    dloss = abs(out["D"][0] - out["K5"][0])
    check(dloss <= LOSS_ATOL_STEP1, f"{k} path D: loss {out['D'][0]}, on "
                                    f"K5's route {out['K5'][0]}")
    spread = [max(rel_spread[n] * b.abs().max().item(),
                  (b - c).abs().max().item())
              for n, b, c in zip(names, out["K5"][1], out["K6"][1])]
    hold_grads(f"{k} path D", names, out["D"][1], out["K5"][1], spread,
               f"every conv through K8, against K5's route on the card: loss "
               f"{out['D'][0]:.6f}, |diff| {dloss:.3e} (within "
               f"{LOSS_ATOL_STEP1}); spread K5's route against the "
               f"all-compact one on the card, or corr_n5120_b1's scaled")
    opt = make_optimizer(cfg, net.parameters())
    step = make_train_step(net, cfg, N_CORR_CLASSES, opt)
    step_gen = torch.Generator().manual_seed(seed + 3)
    kernels.reset_launches()
    t0 = time.perf_counter()
    losses = [step(bsp_batch, step_gen).item() for _ in range(LARGE_EPOCHS)]
    torch.cuda.synchronize()
    steps_s = time.perf_counter() - t0
    grew = dict(kernels.launches)
    n = CONVS_PER_PASS[k] * LARGE_EPOCHS
    want = {"band_sparse_fwd": n, "band_sparse_bwd": n,
            "echo_panel_fwd": LARGE_EPOCHS, "echo_panel_bwd": LARGE_EPOCHS}
    check(grew == want, f"{k} path D: {LARGE_EPOCHS} steps launched {grew}, "
                        f"want {want}")
    check(all(np.isfinite(losses)), f"{k} path D: losses {losses}")
    print(f"train {k} path D: {LARGE_EPOCHS} make_train_step steps on the "
          f"serving batch ({steps_s:.1f} s), losses {losses}, launches {grew}")
    return (net, opt), grew


def remat_step(k, tnet, cfg, n_classes, batch, dev, seed, card):
    """One training step of ``tnet``'s weights in a net built with
    remat_blocks (each FCResNetBlock recomputed in the backward: its 16
    convs launch the conv kernel's forward once more), through
    make_train_step: its host clock, the launches, a finite loss and the
    peak device memory."""
    rnet = build_model(cfg, n_classes, device=dev)
    rnet.remat_blocks = True
    rnet.load_state_dict(tnet.state_dict())
    step = make_train_step(rnet, cfg, n_classes,
                           make_optimizer(cfg, rnet.parameters()))
    gen = torch.Generator().manual_seed(seed + 3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    before = dict(kernels.launches)
    t0 = time.perf_counter()
    loss = step(batch, gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    grew = {n: c - before.get(n, 0) for n, c in kernels.launches.items()
            if c != before.get(n, 0)}
    n = CONVS_PER_PASS[k]
    want = step_launches(cfg, batch.pos.shape[1], n, 1, 1)
    conv = path_kernels(cfg, batch.pos.shape[1])[0]
    want[f"{conv}_fwd"] = 2 * n - 1
    check(grew == want, f"{k} remat_blocks: a step launched {grew}, want "
                        f"{want}")
    check(torch.isfinite(loss).item(), f"{k} remat_blocks: loss {loss}")
    print(f"train step {k} with remat_blocks: {ms:.3f} ms (host clock, one "
          f"step ending in a sync), loss {loss.item():.4f}, "
          f"launches {grew}, peak device memory {peak_gb:.2f} GB "
          f"({base_gb:.2f} GB allocated before the step) on {card}")


def cast_batches(batches):
    """The batches with their panel stencils cast to bf16
    (scripts/train_100k.py::cast_batch)."""
    return [train_100k.cast_batch(b) for b in batches]


def repeat_check(k, cfg, n_classes, weights, batch, dev, seed):
    """The loss gradient of a net of ``cfg`` holding ``weights`` on the
    placed ``batch``, twice on the card with the same augmentation and
    dropout mask: every parameter's bitwise equal (no sum of the route
    depends on the order in which the card runs its threads)."""
    net = build_model(cfg, n_classes, device=dev)
    net.load_state_dict(weights)
    gen = torch.Generator().manual_seed(seed + 3)
    aug = draw_rotate_scale(gen, batch.pos.shape[0], cfg.random_rotate_deg,
                            cfg.random_scale)
    kw = dict(aug=tuple(None if a is None else a.to(dev) for a in aug))
    if cfg.task == "correspondence":
        kw["dropout_mask"] = draw_dropout_mask(gen, net, batch).to(dev)
    runs = [torch.autograd.grad(make_loss_fn(net, cfg, n_classes)(batch,
                                                                  **kw),
                                list(net.parameters())) for _ in range(2)]
    differ = [n for (n, _), a, b in zip(net.named_parameters(), *runs)
              if not torch.equal(a, b)]
    check(not differ, f"{k}: the loss gradient differs between two runs on "
                      f"the card at {differ}")
    print(f"train {k}: the loss gradient of every parameter is bitwise equal "
          "across two runs on the card")


def t100k_peak(what, batch, seed, card):
    """A train_100k step (scripts/train_100k.py: remat_blocks, the head
    row-chunked) of a fresh net on ``batch`` once to warm up, then once
    more: the peak device memory of that step above what was allocated
    before it (the tables, the net and the optimizer's moments, and
    whatever the script holds), in GB."""
    net = train_100k.build_net(seed, batch.pos.device)
    step = train_100k.make_step(net, batch, seed)
    step()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss = step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check(torch.isfinite(loss).item(), f"{what}: loss {loss}")
    print(f"train {what}: a step's peak device memory {peak / 1e9:.2f} GB, "
          f"{base / 1e9:.2f} GB allocated before it, on {card}")
    del net, step
    return (peak - base) / 1e9


def t100k_counted(what, batch, steps, conv, seed, echo="echo_compact"):
    """train_100k.train on ``batch`` for ``steps`` steps, counted: each step
    launches the conv kernel ``conv`` (K5 or K6) 2·17 − 1 times forward
    (remat_blocks recomputes the 16 FCResNetBlock convs) and 17 times
    backward, the ECHO kernel ``echo`` (K7, or K2 without a compact table)
    once each way and the fold after K7's (and each K6's) backward; each
    probe (steps 0 and the last) one forward (17 convs, one ECHO).  Losses
    finite.  Returns the launches."""
    kernels.reset_launches()
    t0 = time.perf_counter()
    _, records, losses = train_100k.train(batch, steps, log_every=10,
                                          seed=seed)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    grew = dict(kernels.launches)
    n, probes = 17, len(records)
    want = {f"{conv}_fwd": steps * (2 * n - 1) + probes * n,
            f"{conv}_bwd": steps * n, f"{echo}_fwd": steps + probes,
            f"{echo}_bwd": steps}
    if echo == "echo_compact":
        want["compact_fold"] = steps * (1 + (n if conv == "band_compact"
                                             else 0))
    check(grew == want, f"{what}: train_100k launched {grew}, want {want}")
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"{what}: losses {losses}")
    print(f"train {what} train_100k: {steps} steps ({secs:.1f} s with "
          f"{probes} probes), losses {losses}, records {records}, launches "
          f"{grew}")
    return Counter(grew)


def large_bf16_request(k, p_conv, p_compact, batch16, batch16_a, batch32):
    """One request on the bf16 tables at N_LARGE on K5's route with the
    compact ECHO (Predictor ``p_conv``: 17 K5 + 1 K7) and on the
    all-compact route (``p_compact``: 17 K6 + 1 K7), counted: the two
    compute one function from the same cast values, so their logits are
    held to each other within LOGIT_RTOL / LOGIT_ATOL, the bar of path D's
    163k logits against K5's route.  Then the bf16 logits against the f32
    tables' (``batch32``, K5's route): the largest difference and the
    share of rows whose argmax agrees.  Returns the launches."""
    kernels.reset_launches()
    a = p_conv.logits(batch16)
    torch.cuda.synchronize()
    grew = dict(kernels.launches)
    check(grew == {"band_panel_fwd": 17, "echo_compact_fwd": 1},
          f"{k} bf16: a request launched {grew}")
    b = p_compact.logits(batch16_a)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    check(launches == {"band_panel_fwd": 17, "band_compact_fwd": 17,
                       "echo_compact_fwd": 2},
          f"{k} bf16: the two requests launched {launches}")
    worst, excess = logits_close(a, b)
    check(excess <= LOGIT_ATOL,
          f"{k} bf16: K5's route against K6's exceeds rtol {LOGIT_RTOL} by "
          f"{excess} > atol {LOGIT_ATOL}")
    del b
    c = p_conv.logits(batch32)
    n = N_LARGE
    diff, agree = 0.0, 0
    for lo in range(0, n, 16384):
        hi = min(n, lo + 16384)
        diff = max(diff, (a[0, lo:hi] - c[0, lo:hi]).abs().max().item())
        agree += int((a[0, lo:hi].argmax(-1) == c[0, lo:hi].argmax(-1))
                     .sum().item())
    print(f"serve {k} bf16: logits ({n}, {N_CORR_CLASSES}) on K5's route "
          f"against the all-compact route on the same cast values: max abs "
          f"diff {worst:.3e} (rtol {LOGIT_RTOL}, atol {LOGIT_ATOL}); "
          f"against the f32 tables: max abs diff {diff:.3e}, argmax agrees "
          f"at {agree} of {n} vertices ({agree / n:.4f}); launches "
          f"{launches}")
    return Counter(launches)


def time_t100k(what, batch, seed, card):
    """A train_100k step on ``batch`` timed: the host clock (1 step, ending
    in a sync; 7g ran the path), then one under the profiler (wall, device
    busy share, top kernels)."""
    net = train_100k.build_net(seed, batch.pos.device)
    step = train_100k.make_step(net, batch, seed)

    def synced():
        step()
        torch.cuda.synchronize()

    ms = time_host(synced, reps=1, warmup=False)
    print(f"train step {what}: {ms:.3f} ms per step (host clock, ending in "
          f"a sync) on {card}")
    wall, busy, kern = request_breakdown(synced, top=12)
    print(f"train step {what} under the profiler: wall {wall:.3f} ms, device "
          f"busy {busy:.3f} ms ({100 * busy / wall:.1f}%) on {card}; top "
          "kernels:")
    for t, name, count in kern:
        print(f"    {t:8.3f} ms  x{count:<4d} {name[:90]}")


def conv_fwd_bwd(banded, dev, gen, C=32, B=2, R=6, n_convs=5,
                 fuse_filters=True):
    """fn() running forward and backward of n_convs C→C field convolutions
    (ftype 1) over ``banded``, as bench.py times one (fuse_filters=False:
    bench.py's BENCH_FUSE=0 A/B, K3 and the filter product)."""
    N = banded.n_pad
    x = torch.randn(1, N, C, 2, device=dev, generator=gen).requires_grad_()
    shapes = ((C, C, R), (C, C, R, B, 2), (C, C, B + 1))
    filters = [[(0.2 * torch.randn(sh, device=dev, generator=gen))
                .requires_grad_() for sh in shapes] for _ in range(n_convs)]
    dy = torch.randn(1, N, C, 2, device=dev, generator=gen)

    def run():
        ys = [field_conv_banded(x, banded, *f, 1, fuse_filters=fuse_filters)
              for f in filters]
        torch.autograd.backward(ys, [dy] * n_convs)

    return run


# --- K9 against its plain version, and graph-parallel training ----------------

def k9_shards(g, sten, S, nh):
    """The S shards of a global g (n_mesh, N, M) and its dense stencil: per
    shard its rows, its stencil blocks and its left and right halo rows,
    sliced from g on the card (zeros at the ends of the ring)."""
    n, hw = g.shape[1] // S, nh * TB
    nb = n // TB
    zero = g.new_zeros(g.shape[0], hw, g.shape[2])
    return [(g[:, d * n:(d + 1) * n].contiguous(),
             sten[:, d * nb:(d + 1) * nb].contiguous(),
             g[:, d * n - hw:d * n].contiguous() if d else zero,
             g[:, (d + 1) * n:(d + 1) * n + hw].contiguous()
             if d < S - 1 else zero)
            for d in range(S)]


def k9_launches(rows, left, right, nb, nh):
    """(what, source array, blk_off, lo, hi) of each K9 launch over a
    shard: the serial one, and where nb > 2·nh the overlapped path's
    interior, head and tail."""
    hw = nh * TB
    out = [("serial", torch.cat([left, rows, right], 1), 0, 0, nb)]
    if halo.overlaps(nb, nh):
        out += [("interior", rows, -nh, nh, nb - nh),
                ("head", torch.cat([left, rows[:, :2 * hw]], 1), 0, 0, nh),
                ("tail", torch.cat([rows[:, -2 * hw:], right], 1), nh - nb,
                 nb - nh, nb)]
    return out


def k9_bound(src, sten, wmat, lo, hi, bwd=False):
    """Least time for one K9 call over target blocks lo..hi−1, counted as
    k1_bound (forward) or k1_bwd_bound (bwd) count K1's: bytes (the range's
    stencil, its source array, whose rows its windows read, the range's
    local targets and the halo rows, and W read once; y, or dg and dW,
    written once) over HBM rate, and the f32 operations this data needs
    over the f32 rate."""
    n_mesh, n_src, M = src.shape
    R, _, O2 = wmat.shape
    st = sten[:, lo:hi]
    K = (st.shape[2] - R) // 2
    nnz, occupied = _stencil_counts(st, R)
    targets = n_mesh * (hi - lo) * TB
    filt = 2 * targets * R * M * O2
    flops = _stencil_ops(nnz, occupied, K, M // (2 * K)) + filt
    nbytes = 4 * (st.numel() + src.numel() + wmat.numel() + targets * O2)
    if bwd:
        flops += _stencil_ops(nnz, occupied, K, M // (2 * K),
                              transposed=True) + filt
        nbytes += 4 * (src.numel() + wmat.numel())
    return _bound(nbytes, flops)


def k9_contrib_bound(src, sten, R, lo, hi, bwd=False):
    """Least time for one K9 contrib call (as k3_bound / k3_bwd_bound):
    the range's stencil, and the source array and contrib (bwd: the
    contrib cotangent and dG of the source array), each once."""
    n_mesh, n_src, M = src.shape
    st = sten[:, lo:hi]
    K = (st.shape[2] - R) // 2
    nnz, occupied = _stencil_counts(st, R)
    nbytes = 4 * (st.numel() + src.numel()
                  + n_mesh * (hi - lo) * TB * R * M)
    return _bound(nbytes, _stencil_ops(nnz, occupied, K, M // (2 * K),
                                       transposed=bwd))


def k9_check(label, g, sten, wmat, nh, S, gen, timed):
    """K9 over the S shards of a global table on the card.  Every launch a
    shard makes (serial; overlapped interior, head and tail) against its
    plain version each way, and K9's contrib each way on the serial
    launches: each output within K9_RTOL_SCALE of its scale, and a second
    call bitwise equal (every output row has one writer).  Then the
    shards joined, serial and overlapped (halo.shard_conv_fwd /
    shard_conv_bwd, the halo cotangents returned by hand), against K1 on
    the global table: y and dG within K9_JOIN_RTOL of scale, dW summed over
    shards too; whether bitwise is printed.  Shard 0's launches are timed
    (CUDA events, and the host's µs to enqueue a call) where ``timed``
    names them; returns the timed rows (forward, backward, contrib,
    contrib backward)."""
    n_mesh, N, M = g.shape
    R, _, O2 = wmat.shape
    K = (sten.shape[2] - R) // 2
    worst = Counter()
    rows = ([], [], [], [])

    def hold(kind, got, want):
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        check(torch.isfinite(got).all().item(), f"{kind} {label}: non-finite")
        check(err <= K9_RTOL_SCALE * scale,
              f"{kind} {label}: max abs err {err} > {K9_RTOL_SCALE} x {scale}")
        worst[kind] = max(worst[kind], err / scale)
        return err

    shards = k9_shards(g, sten, S, nh)
    for d, (rows_d, st, left, right) in enumerate(shards):
        nb = st.shape[1]
        for what, src, off, lo, hi in k9_launches(rows_d, left, right, nb,
                                                  nh):
            a = (TB, nh, off, lo, hi)
            fwd = lambda: halo.halo_fused_fwd(src, st, wmat, *a)
            y = fwd()[:, lo * TB:hi * TB]
            err = hold("K9", y, halo.halo_fused_fwd_reference(src, st, wmat,
                                                              *a))
            check(torch.equal(y, fwd()[:, lo * TB:hi * TB]),
                  f"K9 {label} {what}: two calls differ")
            dy = torch.randn(n_mesh, (hi - lo) * TB, O2, device=g.device,
                             generator=gen)
            bwd = lambda: halo.halo_fused_bwd(dy, src, st, wmat, *a)
            dg, dw = bwd()
            want_dg, want_dw = halo.halo_fused_bwd_reference(dy, src, st,
                                                             wmat, *a)
            errb = max(hold("K9 bwd", dg, want_dg), hold("K9 bwd", dw,
                                                          want_dw))
            dg2, dw2 = bwd()
            check(torch.equal(dg, dg2) and torch.equal(dw, dw2),
                  f"K9 bwd {label} {what}: two calls differ")
            shape = dict(shape=f"{label}, {S} shards, shard 0 {what}",
                         n_mesh=n_mesh, n_src=src.shape[1], M=M, O2=O2,
                         blocks=hi - lo)
            if d == 0 and what in timed:
                row = dict(shape, max_abs_err=err)
                row["ms"] = time_cuda(fwd, iters=20)
                row["host_us"] = enqueue_us(fwd)
                row["plain_ms"] = time_cuda(
                    lambda: halo.halo_fused_fwd_reference(src, st, wmat, *a),
                    iters=2, reps=3)
                row.update(k9_bound(src, st, wmat, lo, hi))
                rows[0].append(row)
                row = dict(shape, max_abs_err=errb)
                row["ms"] = time_cuda(bwd, iters=10)
                row["host_us"] = enqueue_us(bwd, calls=10)
                row["plain_ms"] = time_cuda(
                    lambda: halo.halo_fused_bwd_reference(dy, src, st, wmat,
                                                          *a),
                    iters=2, reps=3)
                row.update(k9_bound(src, st, wmat, lo, hi, bwd=True))
                rows[1].append(row)
            if what != "serial":
                continue
            ca = (TB, nh, R, K, off, lo, hi)
            cfwd = lambda: halo.halo_contrib_fwd(src, st, *ca)
            out = cfwd()
            errc = hold("K9 contrib", out,
                        halo.halo_contrib_reference(src, st, *ca))
            dout = torch.randn(out.shape, device=g.device, generator=gen)
            ba = (TB, nh, R, K, src.shape[1], off, lo, hi)
            cbwd = lambda: halo.halo_contrib_bwd(dout, st, *ba)
            dgc = cbwd()
            errcb = hold("K9 contrib bwd", dgc,
                         halo.halo_contrib_bwd_reference(dout, st, *ba))
            check(torch.equal(dgc, cbwd()),
                  f"K9 contrib bwd {label}: two calls differ")
            if d == 0 and what in timed:
                for i, (run, plain, err_, bwd_) in enumerate((
                        (cfwd, lambda: halo.halo_contrib_reference(src, st,
                                                                   *ca),
                         errc, False),
                        (cbwd, lambda: halo.halo_contrib_bwd_reference(
                            dout, st, *ba), errcb, True))):
                    row = dict(shape, max_abs_err=err_)
                    row["ms"] = time_cuda(run, iters=20)
                    row["plain_ms"] = time_cuda(plain, iters=2, reps=3)
                    row.update(k9_contrib_bound(src, st, R, lo, hi, bwd_))
                    rows[2 + i].append(row)
    # the shards joined, against K1 on the global table
    dy = torch.randn(n_mesh, N, O2, device=g.device, generator=gen)
    k1_y = band_fused_fwd(g, sten, wmat, TB, nh)
    k1_dg, k1_dw = band_fused_bwd(dy, g, sten, wmat, TB, nh)
    hw, n = nh * TB, N // S
    joined = []
    for overlap in (False, True):
        ys, srcs, sent = [], [], {}
        for rows_d, st, left, right in shards:
            y_d, src = halo.shard_conv_fwd(
                rows_d, wmat, st, TB, nh, lambda l=left, r=right: (l, r),
                overlap and halo.overlaps(st.shape[1], nh))
            ys.append(y_d)
            srcs.append(src)
        dgs, dw = [], 0
        for d, (_, st, _, _) in enumerate(shards):
            def send(d_left, d_right, d=d):
                sent[d] = (d_left, d_right)
                return lambda: (torch.zeros_like(d_left),
                                torch.zeros_like(d_right))
            dg_d, dw_d = halo.shard_conv_bwd(
                dy[:, d * n:(d + 1) * n].contiguous(), srcs[d], wmat, st, TB,
                nh, send)
            dgs.append(dg_d)
            dw = dw + dw_d
        for d in range(S):
            if d > 0:
                dgs[d - 1][:, -hw:] += sent[d][0]
            if d < S - 1:
                dgs[d + 1][:, :hw] += sent[d][1]
        got = (torch.cat(ys, 1), torch.cat(dgs, 1), dw)
        rel = []
        for name, a, b in zip(("y", "dg", "dw"), got, (k1_y, k1_dg, k1_dw)):
            err = (a - b).abs().max().item()
            scale = b.abs().max().item()
            check(err <= K9_JOIN_RTOL * scale,
                  f"K9 {label} {S} shards joined (overlap {overlap}): "
                  f"{name} {err} > {K9_JOIN_RTOL} x {scale} from K1's")
            rel.append(f"{name} {err / scale:.2e}"
                       + (" (bitwise)" if torch.equal(a, b) else ""))
        joined.append(f"{'overlapped' if overlap else 'serial'}: "
                      + ", ".join(rel))
    print(f"K9 {label}, {S} shards (nb {sten.shape[1] // S} a shard, nh "
          f"{nh}): every launch against its plain version, largest error "
          + ", ".join(f"{k} {v:.2e}" for k, v in sorted(worst.items()))
          + f" of scale (tolerance {K9_RTOL_SCALE}); backwards bitwise "
          "across two calls; the shards joined against K1 on the global "
          f"table (tolerance {K9_JOIN_RTOL}): " + "; ".join(joined))
    return rows


def gp_rank(rank, world, n_data, n_graph, cfg, n_classes, weights, gpb,
            augs, unfused, profile=False):
    """One rank of a graph-parallel fit on the card (its own where NCCL
    runs), in its own process (spawn; it loads the kernel libraries the
    parent built): the net of
    ``cfg`` on the rank's graph axis holding ``weights`` (then replicated
    from rank 0), the loss and gradients of make_gp_value_and_grad with
    the first step's augmentation (uncounted), then one make_gp_train_step
    step per entry of ``augs`` (the whole batch's augmentation of that
    step), counted, each timed on the host clock, with the parameters after
    it; with ``profile``, then one more step on every rank, rank 0's under
    torch.profiler (request_breakdown: the top kernels, and K9's by pass);
    with ``unfused``, then five unfused 32→32 convs forward and backward
    over the rank's stencil shard (K9's contrib each way), counted
    apart."""
    dev = torch.device("cuda", torch.cuda.current_device())
    layout = make_layout(n_data, n_graph)
    net = build_model(cfg, n_classes, device=dev, graph=layout.graph)
    net.load_state_dict(weights)
    replicate(net, layout)
    local = place_gp_batch(gpb, layout, dev)

    def on(aug):
        return tuple(None if a is None else a.to(dev) for a in aug)

    loss1, grads1 = make_gp_value_and_grad(net, cfg, n_classes, layout)(
        local, aug=on(augs[0]))
    opt = make_optimizer(cfg, net.parameters())
    step = make_gp_train_step(net, cfg, n_classes, opt, layout)
    torch.cuda.synchronize()
    kernels.reset_launches()
    halo.wire_bytes.clear()
    losses, params, ms = [], [], []
    for aug in augs:
        t0 = time.perf_counter()
        loss = step(local, aug=on(aug))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        params.append(torch.cat([p.detach().reshape(-1)
                                 for p in net.parameters()]))
    out = dict(loss1=loss1.item(), grads1=list(grads1), losses=losses,
               params=params, ms=ms, launches=dict(kernels.launches),
               wire_bytes=dict(halo.wire_bytes))
    if profile:
        def one_step():
            step(local, aug=on(augs[-1]))
            torch.cuda.synchronize()
        if rank == 0:
            out["profile"] = request_breakdown(one_step, top=8,
                                               passes=K9_PASSES,
                                               required=False)
        else:
            one_step()
    if unfused:
        _, banded, _ = local.tables()
        gen = torch.Generator(device=dev).manual_seed(rank)
        x = torch.randn(*local.pos.shape[:2], 32, 2, device=dev,
                        generator=gen).requires_grad_()
        B, R = cfg.band_limit, cfg.n_rings
        shapes = ((32, 32, R), (32, 32, R, B, 2), (32, 32, B + 1))
        filters = [[(0.2 * torch.randn(sh, device=dev, generator=gen))
                    .requires_grad_() for sh in shapes] for _ in range(5)]
        kernels.reset_launches()
        g = rotated_source_tensor_kmajor(x, B)
        ys = [apply_filters(halo.halo_contrib(g, banded, layout.graph),
                            filter_coefficients(*f, 1, banded.band_limit))
              for f in filters]
        torch.autograd.backward(ys, [torch.ones_like(ys[0])] * 5)
        torch.cuda.synchronize()
        check(torch.isfinite(x.grad).all().item(), "unfused convs: dx")
        out["unfused_launches"] = dict(kernels.launches)
    return out


def gp_fit(k, cfg, n_classes, net, batch, n_data, n_graph, seed, spread,
           card, unfused=False, profile=False):
    """A graph-parallel fit on the card: GP_STEPS make_gp_train_step steps
    over (n_data, n_graph) ranks (gp_rank), as processes sharing the cards
    over gloo unless every rank has a card of its own (then NCCL), from
    ``net``'s weights, against a single-process run of make_train_step on
    the same placed ``batch`` with the same augmentation (step 1: the draw
    route_check makes).  Holds the losses within GP_LOSS_RTOL, the step-1
    gradients within grad_bar (``spread``: each gradient's rounding spread
    relative to its scale, from route_check), every rank's parameters
    bitwise equal after every step, the exact K9 launches, and the conv
    exchanges' bytes against comm_model.conv_halo_bytes.  With
    ``profile``, prints rank 0's step under the profiler: its device busy
    time, K9's share of it by pass, the top kernels.  Returns the launches
    summed over the ranks (and the unfused convs' apart)."""
    dev = batch.pos.device
    B, N = batch.pos.shape[:2]
    gen = torch.Generator().manual_seed(seed + 3)
    augs = [draw_rotate_scale(gen, B, cfg.random_rotate_deg,
                              cfg.random_scale) for _ in range(GP_STEPS)]

    def on(aug):
        return tuple(None if a is None else a.to(dev) for a in aug)

    ref = build_model(cfg, n_classes, device=dev)
    ref.load_state_dict(net.state_dict())
    names, params = zip(*ref.named_parameters())
    loss1 = make_loss_fn(ref, cfg, n_classes)(batch, aug=on(augs[0]))
    grads1 = [g.cpu() for g in torch.autograd.grad(loss1, params)]
    opt = make_optimizer(cfg, ref.parameters())
    step = make_train_step(ref, cfg, n_classes, opt)
    single = [step(batch, aug=on(a)).item() for a in augs]
    world = n_data * n_graph
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    nh, n_local = batch.banded.nh, N // n_graph
    nb_local = n_local // TB
    overlap = halo.overlaps(nb_local, nh)
    what = (f"{world} rank(s) on {torch.cuda.device_count()} card(s) over "
            f"{backend}")
    print(f"train {k} graph-parallel: (n_data, n_graph) = ({n_data}, "
          f"{n_graph}), {what} (backend chosen: {backend}, since "
          f"{torch.cuda.device_count()} card(s) for {world} ranks); "
          f"{B // n_data} mesh(es) a rank, {n_local} rows ({nb_local} "
          f"blocks) a shard, nh {nh}: the "
          f"{'overlapped' if overlap else 'serial'} halo path")
    check(not any(kernels._stale(n) for n in kernels.sources()),
          "a kernel library is older than its source: the ranks would build")
    t0 = time.perf_counter()
    out = spawn(gp_rank, world, args=(
        n_data, n_graph, cfg, n_classes,
        {n: v.detach().cpu() for n, v in net.state_dict().items()},
        gp_batch(batch.to("cpu")), augs, unfused, profile), backend=backend)
    spawn_s = time.perf_counter() - t0
    for s in range(GP_STEPS):
        for r, o in enumerate(out):
            check(abs(o["losses"][s] - single[s]) <= GP_LOSS_RTOL
                  * abs(single[s]),
                  f"{k} graph-parallel step {s + 1}, rank {r}: loss "
                  f"{o['losses'][s]}, single-process {single[s]}")
            check(np.array_equal(o["params"][s], out[0]["params"][s]),
                  f"{k} graph-parallel step {s + 1}: rank {r}'s parameters "
                  "differ from rank 0's")
    got = [torch.from_numpy(g) for g in out[0]["grads1"]]
    check(all(np.array_equal(a, b) for o in out
              for a, b in zip(o["grads1"], out[0]["grads1"])),
          f"{k} graph-parallel: the ranks' step-1 gradients differ")
    hold_grads(f"{k} graph-parallel step 1", names, got, grads1,
               [spread.get(n, 0.0) * max(g.abs().max().item(), 1e-30)
                for n, g in zip(names, grads1)],
               f"{what}: loss {out[0]['loss1']:.6f}, single-process "
               f"{loss1.item():.6f}")
    launches = Counter()
    for o in out:
        launches.update(o["launches"])
    per = GP_STEPS * world * CONVS_PER_PASS[k] * (3 if overlap else 1)
    want = {"halo_fused_fwd": per, "halo_fused_bwd": per}
    check(dict(launches) == want,
          f"{k} graph-parallel: {GP_STEPS} steps on {world} ranks launched "
          f"{dict(launches)}, want {want}")
    model = comm_model.conv_halo_bytes(nh, TB, cfg.band_limit, cfg.nf)
    per_conv = model["fwd_ppermute"] * (B // n_data)
    for r, o in enumerate(out):
        g_rank = r % n_graph
        sides = (g_rank > 0) + (g_rank < n_graph - 1)
        sent = o["wire_bytes"].get("conv", 0) / GP_STEPS
        want_b = CONVS_PER_PASS[k] * per_conv * sides / 2
        check(sent == want_b and o["wire_bytes"].get("conv return", 0)
              == sent * GP_STEPS,
              f"{k} graph-parallel rank {r}: the convs' exchanges sent "
              f"{sent} bytes a step, conv_halo_bytes gives {want_b}")
    r_ms = [statistics.median(o["ms"][1:]) for o in out]
    p_diff = np.abs(out[0]["params"][-1] - torch.cat(
        [p.detach().reshape(-1) for p in ref.parameters()]).cpu().numpy()
    ).max()
    print(f"train {k} graph-parallel: {GP_STEPS} make_gp_train_step steps, "
          f"losses {[round(v, 6) for v in out[0]['losses']]} (single-process "
          f"make_train_step {[round(v, 6) for v in single]}, within "
          f"{GP_LOSS_RTOL} relative); parameters bitwise equal on every rank"
          f" after every step, {p_diff:.3e} from the single-process run's "
          f"after step {GP_STEPS}; launches {dict(launches)}; step "
          f"{', '.join(f'{m:.1f}' for m in r_ms)} ms a rank (host clock, "
          f"median of steps 2-{GP_STEPS}; {what}: not a scaling figure); "
          f"{spawn_s:.1f} s with the ranks' start; the convs' halo exchange "
          f"sent {out[0]['wire_bytes'].get('conv', 0) / GP_STEPS:.0f} bytes "
          f"a step on rank 0 ({CONVS_PER_PASS[k]} convs x "
          f"comm_model.conv_halo_bytes {model['fwd_ppermute']} B a mesh for "
          f"a rank with two neighbours x {B // n_data} meshes, halved for "
          f"one), the lift's and ECHO's "
          f"{out[0]['wire_bytes'].get('rows', 0) / GP_STEPS:.0f}; on {card}")
    if profile and out[0]["profile"] is None:
        print(f"train {k} graph-parallel: one more step, rank 0 under the "
              "profiler: not measured (the profiler saw no device time)")
    elif profile:
        wall, busy, top, by = out[0]["profile"]
        k9 = sum(ms for ms, _ in by.values())
        print(f"train {k} graph-parallel: one more step, rank 0 under the "
              f"profiler: wall {wall:.3f} ms, device busy {busy:.3f} ms "
              f"({100 * busy / wall:.1f}%); K9 {k9:.3f} ms "
              f"({100 * k9 / busy:.1f}% of busy) by pass: "
              + ", ".join(f"{K9_PASSES[n]} {by[n][0]:.3f} ms (x{by[n][1]})"
                          for n in K9_PASSES if n in by)
              + "; top kernels: "
              + ", ".join(f"{kernel_name(key)} {t:.3f} ms (x{c})"
                          for t, key, c in top)
              + f" ({what}; on {card})")
    unfused_launches = Counter()
    for o in out:
        unfused_launches.update(o.get("unfused_launches", {}))
    if unfused:
        want = {"halo_contrib_fwd": 5 * world, "halo_contrib_bwd": 5 * world}
        check(dict(unfused_launches) == want,
              f"{k} graph-parallel unfused convs launched "
              f"{dict(unfused_launches)}, want {want}")
        print(f"train {k} graph-parallel: five unfused convs over each "
              f"rank's shard launched {dict(unfused_launches)}")
    return dict(launches), dict(unfused_launches)


def gp_phase(config, net, small, seg_cfg, seg_net, seg_batch, seg_spread,
             dev, seed, card):
    """Phase 7h: gp_fit of the segmentation batch ``seg_batch`` (weights
    of ``seg_net``; ``seg_spread`` its route_check rounding spread) over
    (1, 2), then of the SHREC11-sized records ``small`` with the banded
    lift, padded to a multiple of 2·TB rows, over (2, 2), with the five
    unfused convs.  Returns the launches of the fits' steps and of the
    unfused convs, summed over their ranks."""
    gp_cfg = dataclasses.replace(config, lift_impl="banded")
    n_gp, d_gp = shared_bucket(small, n_multiple=2 * TB)
    gp_cls = make_batches(small, gp_cfg, 8, TB, n_gp, d_gp, device=dev)[0]
    check(gp_cls.comp is not None and gp_cls.pos.shape[1] == n_gp,
          "shrec11_b8_gp2x2: not a banded batch of the padded size")
    train, _ = gp_fit("seg_n2048_b4_gp1x2", seg_cfg, 8, seg_net, seg_batch,
                      1, 2, seed, seg_spread, card, profile=True)
    got, unfused = gp_fit("shrec11_b8_gp2x2", gp_cfg, N_CLASSES, net, gp_cls,
                          2, 2, seed, {}, card, unfused=True)
    return dict(Counter(train) + Counter(got)), unfused


def graph_parallel_only(args) -> int:
    """--graph-parallel: phase 7h alone on the machine's cards (NCCL where
    every rank has a card of its own), its segmentation spread from 7e's
    route check of the same batch, and the kernels' launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}; {torch.cuda.device_count()} card(s)")
    kernels.build_all()
    rng = np.random.default_rng(args.seed)
    config = PRESETS["classification"]
    small = shrec_records(rng, config.epsilon)
    seg_cfg = dataclasses.replace(PRESETS["segmentation"], echo_impl="banded")
    recs = echo_records(rng, 2048, 4, seg_cfg.epsilon, 8, "seg")
    seg_net = build_model(seg_cfg, 8, device=dev,
                          generator=torch.Generator().manual_seed(
                              args.seed + 10))
    batch = make_batches(recs, seg_cfg, 4, TB, device=dev)[0]
    weights = cpu_weights(seg_net)
    _, _, _, rel = route_check(
        "seg_n2048_b4_bech", seg_cfg, 8, weights, batch,
        route_cpu(seg_cfg, 8, weights, recs, args.seed), dev)
    net = build_model(config, N_CLASSES, device=dev,
                      generator=torch.Generator().manual_seed(args.seed))
    train, unfused = gp_phase(config, net, small, seg_cfg, seg_net, batch,
                              rel, dev, args.seed, card)
    print(json.dumps({"train_graph_parallel": train,
                      "unfused_graph_parallel": unfused}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# --- main ------------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--graph-parallel", action="store_true",
                    help="run phase 7h alone, on every card of the machine "
                    "(NCCL where each rank has a card)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if args.graph_parallel:
        return graph_parallel_only(args)
    # the worker processes for the CPU's side of the training checks; on
    # the way out the jobs not started are dropped and the workers stop
    pool = ProcessPoolExecutor(CPU_WORKERS,
                               mp_context=mp.get_context("spawn"))
    try:
        return phases(args, pool)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def phases(args, pool) -> int:
    """The phases of the module docstring; ``pool`` runs the CPU's side
    of the training checks."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    def stamp(what):
        print(f"[{time.perf_counter() - t_start:.0f} s] {what}")

    card = card_line()
    print(f"card: {card}")

    # 1. build, in a thread beside the records and the tables (nothing
    # launches a kernel before the build is read below)
    t_build = time.perf_counter()
    builder = ThreadPoolExecutor(1)
    build = builder.submit(
        lambda: (kernels.build_all(), time.perf_counter() - t_build)[1])

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
    # the CPU's side of the checks of phases 6-7f, in the worker processes
    # beside the card's phases, in the order the phases need them: the
    # first epoch of each preset's fit (every route's fit of that preset
    # is held against it) ...
    ref_fits = {"shrec11_b8": (config, N_CLASSES, train_recs + test_recs)}
    ref_fits.update((k, (echo_cfg[k], echo_classes[k], echo_train_recs[k]))
                    for k in echo_cfg)
    cpu_jobs = {k: pool.submit(cpu_first_epoch, cfg_,
                               recs_[:TRAIN_FIT[k][0]], n_cls,
                               TRAIN_FIT[k][1], args.seed)
                for k, (cfg_, n_cls, recs_) in ref_fits.items()}
    # the ECHO presets with echo_impl="banded" (phases 5d-5e, 7d-7e)
    bech_cfg = {f"{k}_bech": dataclasses.replace(cfg, echo_impl="banded")
                for k, cfg in echo_cfg.items()}
    bech_of = {k: k[:-len("_bech")] for k in bech_cfg}   # the mixed route's
    bech_recs = {k: echo_recs[bech_of[k]] for k in bech_cfg}
    echo_nets, echo_cpu_nets, echo_serve, echo_batches = {}, {}, {}, {}
    route_weights = {}
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
        route_weights[k] = cpu_weights(echo_nets[k])
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
    # ... then the CPU's side of the route checks on the serving batches:
    # paths A and B with the banded ECHO (7e), paths A and D (7f)
    route_jobs = {}
    for k, cfg in bech_cfg.items():
        route_jobs[k, "B"] = pool.submit(
            route_cpu, cfg, echo_classes[bech_of[k]],
            route_weights[bech_of[k]], bech_recs[k], args.seed)
    for k, cfg in echo_cfg.items():
        route_jobs[k, "D"] = pool.submit(
            route_cpu, cfg, echo_classes[k], route_weights[k], echo_recs[k],
            args.seed, alt=as_block_sparse, name="D",
            spread_alts=(as_compressed,))
    torch.set_num_threads(max(1, (os.cpu_count() or 8)
                              - CPU_WORKERS * CPU_THREADS))

    # the pure-panel layout (correspondence weights of the mixed route):
    # the 5120-sample record forced onto it, and one mesh of N_LARGE
    # samples that the threshold of layout="auto" sends there
    corr_cfg = echo_cfg["corr_n5120_b1"]
    big = f"corr_n{N_LARGE}_b1"
    panel_cfg = {"corr_n5120_b1_panel": dataclasses.replace(corr_cfg,
                                                            layout="panel"),
                 big: corr_cfg}
    t0 = time.perf_counter()
    panel_recs = {"corr_n5120_b1_panel": echo_recs["corr_n5120_b1"],
                  big: [sphere_record(rng, N_LARGE, N_CORR_CLASSES,
                                      f"corr_n{N_LARGE}")]}
    print(f"record {big}: Fibonacci sphere, kd_order, ε-ball graph "
          f"(ε={panel_recs[big][0].epsilon:.5f}) and random log maps built "
          f"in {time.perf_counter() - t0:.1f} s")
    panel_serve, panel_batches = {}, {}
    for k, cfg in panel_cfg.items():
        panel_serve[k] = Predictor(echo_nets["corr_n5120_b1"], cfg,
                                   batch_size=1, banded_tb=TB, device=dev)
        t0 = time.perf_counter()
        panel_batches[k] = panel_serve[k].make_batches(panel_recs[k])
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        check(len(panel_batches[k]) == 1, f"{k}: expected one batch")
        b = panel_batches[k][0]
        check(b.banded is None and b.comp is None and b.panel is not None,
              f"{k}: not the pure-panel layout")
        nb = b.panel.n_pad // TB
        print(f"request {k}: {b.pos.shape[0]} mesh, n_pad {b.panel.n_pad}, "
              f"D {b.table.d_slots}, {b.panel.n_panels} panels "
              f"({b.panel.n_panels / nb:.1f} per block), stencil "
              f"{4 * b.panel.sten.numel() / 1e9:.3f} GB, "
              f"{int(b.table.mask.sum().item())} edges; tables built on the "
              f"host and placed in {build_s:.3f} s")
    check(corr_cfg.layout == "auto" and resolve_layout(
        corr_cfg, panel_batches[big][0].panel.n_pad) == "panel",
        f"{big}: layout='auto' did not pick the panel layout")

    # the compact route: the 5120-sample record forced onto the pure-panel
    # layout with the compact ECHO (K5 convs) and all-compact (K6 convs),
    # with the correspondence weights; the segmentation batch on the mixed
    # route with the compact ECHO, with the segmentation weights; and the
    # N_LARGE request of both kinds, whose compact table is built from the
    # serving batch's own EdgeTable, as stack_panel_batch builds it
    seg_cfg = echo_cfg["seg_n2048_b4"]
    big_c, big_a = f"{big}_compact", f"{big}_allcompact"
    ec = dict(echo_impl="compact")
    compact_cfg = {
        "corr_n5120_b1_panel_compact": dataclasses.replace(
            corr_cfg, layout="panel", **ec),
        "corr_n5120_b1_panel_allcompact": dataclasses.replace(
            corr_cfg, layout="panel", conv_impl="compact", **ec),
        "seg_n2048_b4_compact": dataclasses.replace(seg_cfg, **ec),
        big_c: dataclasses.replace(corr_cfg, **ec),
        big_a: dataclasses.replace(corr_cfg, conv_impl="compact", **ec)}
    compact_recs = {k: echo_recs["seg_n2048_b4" if k.startswith("seg")
                                 else "corr_n5120_b1"]
                    for k in compact_cfg}
    compact_recs[big_c] = compact_recs[big_a] = panel_recs[big]
    # the conv kernel and its launches per request of each compact config
    compact_convs = {k: ("band_compact_fwd", 17) if cfg.conv_impl == "compact"
                     else ("band_fused_fwd", 9) if cfg.task == "segmentation"
                     else ("band_panel_fwd", 17)
                     for k, cfg in compact_cfg.items()}

    def compact_what(k):
        conv, n = compact_convs[k]
        short = {"band_compact_fwd": "K6", "band_fused_fwd": "K1",
                 "band_panel_fwd": "K5"}[conv]
        return f"{n} {short} + 1 K7 launches"

    compact_serve, compact_batches = {}, {}
    how = {big_c: "the compact table built from the serving batch's "
                  "EdgeTable", big_a: f"the table of {big_c} reused"}
    for k, cfg in compact_cfg.items():
        net_k = "seg_n2048_b4" if k.startswith("seg") else "corr_n5120_b1"
        compact_serve[k] = Predictor(echo_nets[net_k], cfg,
                                     batch_size=len(compact_recs[k]),
                                     banded_tb=TB, device=dev)
        t0 = time.perf_counter()
        if k == big_c:
            b0 = panel_batches[big][0]
            comp_big = build_compact_panel_table(
                host_table(b0.table), tb=min(TB, 32)).to(dev)
            compact_batches[big_c] = [dataclasses.replace(b0,
                                                          compact=comp_big)]
        elif k == big_a:
            compact_batches[big_a] = [dataclasses.replace(
                panel_batches[big][0], panel=comp_big, compact=comp_big)]
        else:
            compact_batches[k] = compact_serve[k].make_batches(
                compact_recs[k])
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        check(len(compact_batches[k]) == 1, f"{k}: expected one batch")
        b = compact_batches[k][0]
        c = b.compact
        check(c is not None and (b.panel is c) == (cfg.conv_impl == "compact")
              and c.tb == (TB if b.banded is not None else min(TB, 32)),
              f"{k}: not the compact route")
        nb = c.n_mesh * c.n_pad // c.tb
        print(f"request {k}: {b.pos.shape[0]} mesh(es), n_pad {c.n_pad}, "
              f"compact table at TBt {c.tb}, TS {c.ts}: {c.n_panels} panels "
              f"({c.n_panels / nb:.2f} per block), stencil "
              f"{4 * c.sten.numel() / 1e9:.3f} GB, slot fill "
              f"{(c.sten[:, 3:5] != 0).any(1).float().mean().item():.4f}; "
              f"{how.get(k, 'tables built on the host and placed')} in "
              f"{build_s:.3f} s")

    # the compressed banded layout: the ECHO presets with
    # echo_impl="banded" on the mixed route's records and weights.  Path A:
    # K1 convs, and the banded ECHO and lift over the batch's
    # CompressedBandedTable; path B: the same batch with that table as the
    # conv table too (every conv through K4)
    bech_serve, bech_batches, cb_batches = {}, {}, {}
    for k, cfg in bech_cfg.items():
        bech_serve[k] = Predictor(echo_nets[bech_of[k]], cfg,
                                  batch_size=len(bech_recs[k]), banded_tb=TB,
                                  device=dev)
        t0 = time.perf_counter()
        bech_batches[k] = bech_serve[k].make_batches(bech_recs[k])
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        check(len(bech_batches[k]) == 1, f"{k}: expected one batch")
        b = bech_batches[k][0]
        check(b.comp is not None and b.banded is not None and b.panel is None
              and b.compact is None and b.comp.nh == b.banded.nh,
              f"{k}: not the banded ECHO's batch")
        cb_batches[k] = as_cbanded(bech_batches[k])
        dense_mb, comp_mb = stencil_mb(b)
        print(f"request {k}: {b.pos.shape[0]} mesh(es), n_pad "
              f"{b.pos.shape[1]}, nh {b.comp.nh}; stencil bytes: dense band "
              f"{dense_mb:.1f} MB ({b.banded.sten_band.shape[-3]} planes), "
              f"compressed band {comp_mb:.1f} MB (5 planes); tables built on "
              f"the host and placed in {build_s:.3f} s")
    # n8192's compressed table, from its serving batch's EdgeTable
    b8192 = batches["n8192_b1"][0]
    comp8192 = build_compressed_banded(host_table(b8192.table),
                                       tb=TB).to(dev)
    check(comp8192.nh == b8192.banded.nh, "n8192: the two band tables' nh")

    fits = {"shrec11_b8": (config, N_CLASSES, train_recs + test_recs)}
    fits.update((k, (echo_cfg[k], echo_classes[k], echo_train_recs[k]))
                for k in echo_cfg)
    fits["corr_n5120_b1_panel"] = (panel_cfg["corr_n5120_b1_panel"],
                                   N_CORR_CLASSES,
                                   echo_train_recs["corr_n5120_b1"])
    fits[big] = (corr_cfg, N_CORR_CLASSES, panel_recs[big])
    compact_keys = ["corr_n5120_b1_panel_compact",
                    "corr_n5120_b1_panel_allcompact", "seg_n2048_b4_compact"]
    for k in compact_keys:
        net_k = "seg_n2048_b4" if k.startswith("seg") else "corr_n5120_b1"
        fits[k] = (compact_cfg[k], echo_classes[net_k],
                   echo_train_recs[net_k])
    for k in bech_cfg:
        fits[k] = (bech_cfg[k], echo_classes[bech_of[k]],
                   echo_train_recs[bech_of[k]][:sum(TRAIN_FIT[k][::2])])
    fits[big_c] = (compact_cfg[big_c], N_CORR_CLASSES, panel_recs[big])
    fits[big_a] = (compact_cfg[big_a], N_CORR_CLASSES, panel_recs[big])
    # the CPU fit each fit_phase fit is held against: its preset's, on the
    # same training records with the same batch size (the routes' own CPU
    # fits agreed to 1e-6 in earlier runs)
    ref_of = {k: "seg_n2048_b4" if k.startswith("seg") else
              "corr_n5120_b1" if k.startswith("corr") else k
              for k in TRAIN_FIT}
    for k, ref in ref_of.items():
        n_train = TRAIN_FIT[k][0]
        check(TRAIN_FIT[k][:2] == TRAIN_FIT[ref][:2]
              and fits[k][1] == ref_fits[ref][1]
              and all(a is b for a, b in zip(fits[k][2][:n_train],
                                             ref_fits[ref][2][:n_train])),
              f"{k}: not the training records of {ref}'s CPU fit")
    build_s = build.result()
    builder.shutdown()
    print(f"built {sorted(kernels.build_logs) or 'nothing (up to date)'} in "
          f"{build_s:.1f} s, beside the records and tables")
    for name, log in kernels.build_logs.items():
        tag = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                tag = " (bf16 stencil)" if "nv_bfloat16" in line else ""
            if "registers" in line or "spill" in line:
                print(f"  nvcc {name}{tag}: {line.strip()}")
    stamp("tables built")
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
        # timed at the segmentation width and the correspondence one
        # whose request and step profiles lead with K1
        if (C_, O2) in ((48, 96), (32, 64)):
            timed.append((rows[-1], g, bt.sten_band, wmat, TB, bt.nh))
            bwd_timed.append((bwd_rows[-1], g, bt.sten_band, wmat, dy, TB,
                              bt.nh))
        del g, wmat, dy

    # 2b. K4 (compressed banded conv) and K3 (unfused contrib), forward and
    # backward, against their plain versions, each timed here: K4 on the
    # compressed tables of n8192 (C=32, O2=64, K=5, R=6), of the
    # segmentation batch (C=48, O2=96) and of the correspondence batch at
    # its four widths (K=3, R=3), each also against K1 on the dense table
    # of the same EdgeTable, and on a random compressed table with nh=4
    # that reaches past both ends of g; K3 on the dense tables at the same
    # shapes; then field_conv_banded(fuse_filters=False) against True
    k4_rows, k4b_rows, k3_rows, k3b_rows = [], [], [], []
    seg_b = bech_batches["seg_n2048_b4_bech"][0]
    corr_b = bech_batches["corr_n5120_b1_bech"][0]
    for label, ct, bt, C_, O2 in (
            ("n8192", comp8192, b8192.banded, 32, 64),
            ("seg_n2048_b4", seg_b.comp, seg_b.banded, 48, 96),
            ("corr_n5120_b1", corr_b.comp, corr_b.banded, 32, 64),
            ("corr_n5120_b1", corr_b.comp, corr_b.banded, 16, 64),
            ("corr_n5120_b1", corr_b.comp, corr_b.banded, 32, 32),
            ("corr_n5120_b1", corr_b.comp, corr_b.banded, 16, 24)):
        R_, B_ = bt.n_rings, bt.band_limit
        csten = ct.sten_band.reshape(-1, *ct.sten_band.shape[-4:])
        dsten = bt.sten_band
        g, wmat = k1_inputs(dsten, R_, C_, O2, gen)
        dy = torch.randn(g.shape[0], g.shape[1], O2, device=dev,
                         generator=gen)
        label = f"{label} C={C_} O2={O2}"
        rows4 = k4_check(label, g, wmat, csten, ct.nh, R_, B_, dy, dsten)
        k4_time(*rows4, g, wmat, csten, ct.nh, R_, B_, dy)
        k4_rows.append(rows4[0])
        k4b_rows.append(rows4[1])
        dout = torch.randn(g.shape[0], g.shape[1] * R_, g.shape[2],
                           device=dev, generator=gen)
        rows3 = k3_check(label, g, dsten, bt.nh, R_, 2 * B_ + 1, dout)
        k3_time(*rows3, g, dsten, bt.nh, R_, 2 * B_ + 1, dout)
        k3_rows.append(rows3[0])
        k3b_rows.append(rows3[1])
        del g, wmat, dy, dout
    R_, K_, C_, O2 = config.n_rings, 2 * config.band_limit + 1, 32, 60
    label = "n640 b8 nh=4 random stencil"
    csten = random_comp(8, 5, R_, 4, gen)
    g = torch.randn(8, 5 * TB, K_ * 2 * C_, device=dev, generator=gen)
    wmat = torch.randn(R_, K_ * 2 * C_, O2, device=dev, generator=gen) / 40.0
    dy = torch.randn(8, 5 * TB, O2, device=dev, generator=gen)
    rows4 = k4_check(label, g, wmat, csten, 4, R_, config.band_limit, dy)
    k4_rows.append(rows4[0])
    k4b_rows.append(rows4[1])
    dense = torch.rand(8, 5, R_ + 2 * K_, TB, 9 * TB, device=dev,
                       generator=gen)
    dout = torch.randn(8, 5 * TB * R_, K_ * 2 * C_, device=dev,
                       generator=gen)
    rows3 = k3_check(label, g, dense, 4, R_, K_, dout)
    k3_rows.append(rows3[0])
    k3b_rows.append(rows3[1])
    del csten, g, wmat, dy, dense, dout
    unfused_check("n8192", b8192.banded, dev, gen)
    for what, rs_ in (("K4", k4_rows), ("K4 bwd", k4b_rows), ("K3", k3_rows),
                      ("K3 bwd", k3b_rows)):
        print_times(what, rs_[:-1], card)
    for r in k4_rows[:-1]:
        print(f"K4 {r['shape']}: {r['stencil_bytes'] / 1e6:.1f} MB of the "
              f"{r['stencil_bytes_whole'] / 1e6:.1f} MB compressed stencil "
              f"needed (slot fill {r['slot_fill']:.4f})")

    # 2c. K8 (block-sparse banded conv), forward and backward, against its
    # plain versions, each timed here: on the block-sparse tables of n8192
    # (C=32, O2=64, K=5, R=6), of the segmentation batch (C=48, O2=96) and
    # of the correspondence batch at its four widths (K=3, R=3), each built
    # from its batch's own EdgeTable and held against K1 on that batch's
    # dense table too, and on two random tables whose lists are shuffled,
    # repeat no block and carry padding entries (the 163k table's checks
    # come with phase 5f, after the K5 request)
    k8_rows, k8b_rows = [], []
    bsp8192 = block_sparse_of(b8192)
    for label, bsp, bt, C_, O2 in (
            ("n8192", bsp8192, b8192.banded, 32, 64),
            ("seg_n2048_b4", block_sparse_of(echo_batches["seg_n2048_b4"][0]),
             echo_batches["seg_n2048_b4"][0].banded, 48, 96),
            *(("corr_n5120_b1", block_sparse_of(
                echo_batches["corr_n5120_b1"][0]),
               echo_batches["corr_n5120_b1"][0].banded, C_, O2)
              for C_, O2 in ((32, 64), (16, 64), (32, 32), (16, 24)))):
        nj, per_block, gb = sparse_stats(bsp)
        print(f"K8 {label}: NJ {nj}, {per_block:.2f} live source blocks per "
              f"target block, stencil {1e3 * gb:.1f} MB (dense band "
              f"{4e-6 * bt.sten_band.numel():.1f} MB, nh {bt.nh})")
        rows8 = k8_check(f"{label} C={C_} O2={O2}", bsp, C_, O2, gen,
                         dense=bt)
        k8_rows.append(rows8[0])
        k8b_rows.append(rows8[1])
    rng8 = np.random.default_rng(args.seed + 8)
    for B_, R_, C_, O2 in ((2, 6, 32, 60), (1, 3, 16, 24)):
        tab = random_block_sparse(rng8, 2, 10, 6, R_, B_, TB).to(dev)
        rows8 = k8_check(f"random shuffled lists b2 NJ=6 K={2 * B_ + 1} "
                         f"R={R_} C={C_} O2={O2}", tab, C_, O2, gen,
                         plain=None)
        k8_rows.append(rows8[0])
        k8b_rows.append(rows8[1])
    del tab
    print_times("K8", k8_rows[:6], card)
    print_times("K8 bwd", k8b_rows[:6], card)

    # 2d. K9 (the halo conv of graph-parallel training, fused and contrib,
    # each way) against its plain version, on the dense bands of the
    # segmentation batch (C=48, O2=96) and of n8192 (C=32, O2=64), each
    # split into 2 and into 4 shards whose halo rows are sliced from the
    # global g on the card: every launch of the serial and overlapped paths
    # both ways, the contrib both ways, and the shards joined against K1 on
    # the global table; shard 0 of each 2-way split timed: its serial
    # launch, and the overlapped path's interior and head (nh blocks over
    # a source array of 3nh) launches apart
    k9_rows, k9b_rows, k9c_rows, k9cb_rows = [], [], [], []
    for label, bt, C_, O2 in (
            ("seg_n2048_b4", echo_batches["seg_n2048_b4"][0].banded, 48, 96),
            ("n8192", b8192.banded, 32, 64)):
        g, wmat = k1_inputs(bt.sten_band, bt.n_rings, C_, O2, gen)
        for S in (2, 4):
            got = k9_check(f"{label} C={C_} O2={O2}", g, bt.sten_band, wmat,
                           bt.nh, S, gen,
                           ("serial", "interior", "head") if S == 2 else ())
            for acc, rs_ in zip((k9_rows, k9b_rows, k9c_rows, k9cb_rows),
                                got):
                acc.extend(rs_)
        del g, wmat
    for what, rs_ in (("K9", k9_rows), ("K9 bwd", k9b_rows),
                      ("K9 contrib", k9c_rows),
                      ("K9 contrib bwd", k9cb_rows)):
        print_times(what, rs_, card)

    stamp("K1, K3, K4, K8 and K9 checked")
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
    del dg, dg_cm
    # K2 at the 163k request's shape (C = n_des = 12, n_bins 2)
    bigp = panel_batches[big][0].panel
    x = k2_inputs(bigp, 12, gen)
    k2_big = (k2_check(f"{big} C=12 n_bins=2", x, bigp, 2), x, bigp, 2)
    k2_rows.append(k2_big[0])

    # 3b. K5 against its plain version: on the 163k table at every width
    # of the correspondence net's 17 convs and at the segmentation width
    # (C=48, O2=96, K=5, R=6), on a segmentation table forced onto the
    # panel layout at that width, and on the 5120-sample
    # table with dense planes, with chunk=4 and read with n_rings=6 (K=3,
    # R=6)
    k5_rows, k5_timed = [], []
    # the compressed planes do not depend on K or R: the 163k table at the
    # segmentation width is the same stencil read with K=5, R=6
    bigp_seg = dataclasses.replace(bigp, band_limit=seg_cfg.band_limit,
                                   n_rings=seg_cfg.n_rings)
    seg_panel = make_batches(
        echo_recs["seg_n2048_b4"],
        dataclasses.replace(seg_cfg, layout="panel"), 4,
        TB, device=dev)[0].panel
    for label, pt, C_, O2 in (
            (big, bigp, 32, 64), (big, bigp, 16, 64), (big, bigp, 32, 32),
            (big, bigp, 16, 24), (f"{big} seg width", bigp_seg, 48, 96),
            ("seg_n2048_b4 panel", seg_panel, 48, 96)):
        g, wmat = k5_inputs(pt, C_, O2, gen)
        k5_rows.append(k5_check(f"{label} C={C_} O2={O2}", g, wmat, pt))
        k5_timed.append((k5_rows[-1], g, wmat, pt))
    # 3c. K5's backward against its plain version: on the 163k table at
    # the correspondence net's four widths, on the segmentation table
    # forced onto the panel layout at the segmentation width, and (below,
    # with the forward) on the 5120-sample table with dense planes, with
    # chunk=4 and read with n_rings=6
    k5b_rows, k5b_timed = [], []
    for label, pt, C_, O2 in (
            (big, bigp, 32, 64), (big, bigp, 16, 64), (big, bigp, 32, 32),
            (big, bigp, 16, 24), ("seg_n2048_b4 panel", seg_panel, 48, 96)):
        g, wmat = k5_inputs(pt, C_, O2, gen)
        dy = torch.randn(g.shape[0], O2, device=dev, generator=gen)
        k5b_rows.append(k5_bwd_check(f"{label} C={C_} O2={O2}", g, wmat, dy,
                                     pt))
        k5b_timed.append((k5b_rows[-1], g, wmat, dy, pt))
    # the compressed planes do not depend on R: the 5120-sample table read
    # with n_rings=6 is the MATCHING preset's shape (K = 3, R = 6)
    corr_table = echo_recs["corr_n5120_b1"][0].table(1, 3)
    for label, kw, rings in (("dense planes", dict(compressed=False), 3),
                             ("chunk=4", dict(compressed=True, chunk=4), 3),
                             ("n_rings=6", dict(compressed=True), 6)):
        pt = build_panel_table(corr_table, tb=TB, **kw).to(dev)
        pt = dataclasses.replace(pt, n_rings=rings)
        g, wmat = k5_inputs(pt, 32, 64, gen)
        label = f"corr_n5120_b1 {label} C=32 O2=64"
        k5_rows.append(k5_check(label, g, wmat, pt))
        dy = torch.randn(g.shape[0], 64, device=dev, generator=gen)
        k5b_rows.append(k5_bwd_check(label, g, wmat, dy, pt))
    del pt, g, wmat, dy, corr_table

    # 3d. K6 and K7 (the compact route's conv and ECHO) against their plain
    # versions: K6 on the 163k compact table (TBt 32) at the correspondence
    # net's four widths, on the segmentation batch's compact table (TBt
    # 128) at C=48, O2=96, K=5, R=6, and on the 5120-sample all-compact
    # table read with n_rings=6 (the MATCHING preset's K=3, R=6); K7 on the
    # 163k table at C=12, n_bins 2 and on the segmentation table at C=48,
    # n_bins 3.  Each is timed here, so that the 163k table can go before
    # the training phases.
    seg_comp = compact_batches["seg_n2048_b4_compact"][0].compact
    # the compressed planes do not depend on R
    corr_a6 = dataclasses.replace(compact_batches[
        "corr_n5120_b1_panel_allcompact"][0].compact, n_rings=6)
    k6_rows, k7_rows = [], []
    for label, ct, C_, O2 in (
            (big_c, comp_big, 32, 64), (big_c, comp_big, 16, 64),
            (big_c, comp_big, 32, 32), (big_c, comp_big, 16, 24),
            ("seg_n2048_b4_compact", seg_comp, 48, 96),
            ("corr_n5120_b1_panel_allcompact n_rings=6", corr_a6, 32, 64)):
        g, wmat = k5_inputs(ct, C_, O2, gen)
        k6_rows.append(k6_check(f"{label} C={C_} O2={O2}", g, wmat, ct))
        k6_time(k6_rows[-1], g, wmat, ct)
    for label, ct, C_, n_bins in ((big_c, comp_big, 12, 2),
                                  ("seg_n2048_b4_compact", seg_comp, 48, 3)):
        x = k2_inputs(ct, C_, gen)
        k7_rows.append(k7_check(f"{label} C={C_} n_bins={n_bins}", x, ct,
                                n_bins))
        # the plain version takes seconds a call at 163k
        k7_time(k7_rows[-1], x, ct, n_bins,
                plain=(1, 0) if ct is comp_big else (3, 2))
    del g, wmat, x

    # 3e. K6's and K7's backwards and the compact fold against their plain
    # versions, each timed here too: K6 bwd on the 163k compact table (TBt
    # 32) at the correspondence net's four widths, on the segmentation
    # records' compact table at TBt 32 (forced onto the pure-panel layout
    # with conv_impl="compact") at C=48, O2=96, K=5, R=6, and on the
    # 5120-sample all-compact table read with n_rings=6; K7 bwd on the 163k
    # table at C=12, n_bins 2 and on the segmentation batch's mixed-route
    # table (TBt 128) at C=48, n_bins 3, for both cotangent layouts; the
    # compact lift's VJP and the fold alone on the 163k table
    seg_comp32 = make_batches(
        echo_recs["seg_n2048_b4"], dataclasses.replace(
            seg_cfg, layout="panel", echo_impl="compact",
            conv_impl="compact"), 4, TB, device=dev)[0].compact
    k6b_rows, k7b_rows = [], []
    for label, ct, C_, O2 in (
            (big_c, comp_big, 32, 64), (big_c, comp_big, 16, 64),
            (big_c, comp_big, 32, 32), (big_c, comp_big, 16, 24),
            ("seg_n2048_b4 compact TBt 32", seg_comp32, 48, 96),
            ("corr_n5120_b1_panel_allcompact n_rings=6", corr_a6, 32, 64)):
        g, wmat = k5_inputs(ct, C_, O2, gen)
        dy = torch.randn(g.shape[0], O2, device=dev, generator=gen)
        k6b_rows.append(k6_bwd_check(f"{label} C={C_} O2={O2}", g, wmat, dy,
                                     ct))
        k6_bwd_time(k6b_rows[-1], g, wmat, dy, ct)
    del g, wmat, dy, corr_a6
    for label, ct, C_, n_bins in ((big_c, comp_big, 12, 2),
                                  ("seg_n2048_b4_compact", seg_comp, 48, 3)):
        x = k2_inputs(ct, C_, gen)
        dg, dg_cm = k2_bwd_inputs(x, n_bins, ct.tb, gen)
        label = f"{label} C={C_} n_bins={n_bins}"
        k7b_rows.append(k7_bwd_check(label, dg, dg_cm, x, ct, n_bins))
        # the plain version takes seconds a call at 163k
        k7_bwd_time(k7b_rows[-1], dg, dg_cm, x, ct, n_bins,
                    plain=(1, 0) if ct is comp_big else (3, 2))
    del x, dg, dg_cm
    lift_vjp_check(f"{big_c} C=3", comp_big, gen)
    g, wmat = k5_inputs(comp_big, 32, 64, gen)
    dy = torch.randn(g.shape[0], 64, device=dev, generator=gen)
    vals, _ = band_compact_bwd_reference(
        dy, g, wmat, comp_big.sten, comp_big.meta, comp_big.src_idx,
        comp_big.tb, comp_big.n_rings, comp_big.band_limit)
    del g, wmat, dy
    fold_rows = [fold_check(f"{big_c} W=192 (K6 bwd's dG blocks at C=32)",
                            vals, comp_big)]
    fold_time(fold_rows[0], vals, comp_big)
    del vals
    print_times("K6 bwd", k6b_rows, card)
    print_times("K7 bwd", k7b_rows, card)
    for r in k7b_rows:
        print(f"K7 bwd {r['shape']}: {r['ms_contiguous']:.4f} ms/call for a "
              f"contiguous cotangent ({r['ms']:.4f} cells minor, as a "
              f"training step passes it) on {card}")
    print_times("compact_fold", fold_rows, card)
    print(f"compact_fold {fold_rows[0]['shape']}: index_add_ alone "
          f"{fold_rows[0]['library_ms']:.4f} ms/call on {card}")

    # 3f. the bf16 panel stencils (cast_panel_sten), each kernel each way
    # against its plain version (1e-4 of each output's scale) and bitwise
    # against a second call: on the cast seg_n2048_b4 tables (K5 on the
    # forced panel table, K2 on the mixed route's, K6 on the compact table
    # at TBt 32, K7 on the mixed route's compact table) and on the cast
    # corr_n5120_b1 pure-panel (K5, K2) and all-compact (K6, K7) tables;
    # then timed: K5, K6 and K7 on the 163k tables cast on the card (the
    # shapes of train_100k), K2 on the corr_n5120_b1 mixed route's table
    # (the f32 K2's first row)
    bigp16, comp16 = cast_panel_sten(bigp), cast_panel_sten(comp_big)
    corr_p16 = cast_panel_sten(panel_batches["corr_n5120_b1_panel"][0].panel)
    corr_a16 = cast_panel_sten(compact_batches[
        "corr_n5120_b1_panel_allcompact"][0].compact)
    b16 = bf16_checks(
        gen, ((f"{big} C=32 O2=64", bigp16, 32, 64),
              ("seg_n2048_b4 panel C=48 O2=96", cast_panel_sten(seg_panel),
               48, 96),
              ("corr_n5120_b1_panel C=32 O2=64", corr_p16, 32, 64)),
        ((f"{big_c} C=32 O2=64", comp16, 32, 64),
         ("seg_n2048_b4 compact TBt 32 C=48 O2=96",
          cast_panel_sten(seg_comp32), 48, 96),
         ("corr_n5120_b1_panel_allcompact C=32 O2=64", corr_a16, 32, 64)),
        (("corr_n5120_b1 C=12 n_bins=2", cast_panel_sten(
            echo_batches["corr_n5120_b1"][0].panel), 12, 2),
         ("seg_n2048_b4 C=48 n_bins=3", cast_panel_sten(
             echo_batches["seg_n2048_b4"][0].panel), 48, 3),
         ("corr_n5120_b1_panel C=12 n_bins=2", corr_p16, 12, 2)),
        ((f"{big_c} C=12 n_bins=2", comp16, 12, 2),
         ("seg_n2048_b4_compact C=48 n_bins=3", cast_panel_sten(seg_comp),
          48, 3),
         ("corr_n5120_b1_panel_allcompact C=12 n_bins=2", corr_a16, 12, 2)),
        card)
    del seg_comp32, corr_p16, corr_a16

    stamp("K2, K5, K6 and K7 checked")
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
    echo_launches, served = serve_counted(
        echo_serve, echo_recs, echo_batches,
        {k: {"band_fused_fwd": CONVS_PER_PASS[k], "echo_panel_fwd": 1}
         for k in echo_serve})
    # the CPU's outputs of each ECHO preset on its own route: every route
    # of that preset below is held against them
    cpu_ref = {k: cpu_predict(p, echo_recs[k], echo_cpu_nets[k])
               for k, p in echo_serve.items()}
    for k, p in echo_serve.items():
        match_cpu(k, p, echo_recs[k], served[k], cpu_ref[k])

    # 5b. pure-panel serving: the slice-5 path, counted.  Each request
    # launches K5 17 times and K2 once, K1 never.  The forced-panel request
    # matches the CPU; the 163k one is checked for shape and finiteness
    # (its plain run on the CPU would take minutes).
    panel_launches, served = serve_counted(
        panel_serve, panel_recs, panel_batches,
        {k: {"band_panel_fwd": CONVS_PER_PASS["corr_n5120_b1"],
             "echo_panel_fwd": 1} for k in panel_serve})
    small_k = "corr_n5120_b1_panel"
    match_cpu(small_k, panel_serve[small_k], panel_recs[small_k],
              served[small_k], cpu_ref["corr_n5120_b1"], "corr_n5120_b1")
    out = served[big][0]
    check(out["logits"].shape == (N_LARGE, N_CORR_CLASSES)
          and out["map"].shape == (N_LARGE,)
          and np.isfinite(out["logits"]).all(),
          f"{big}: bad output {out['logits'].shape}")
    print(f"serve {big}: logits {out['logits'].shape} finite, map in "
          f"[{out['map'].min()}, {out['map'].max()}]; launches "
          f"{panel_launches} for both pure-panel requests")
    del out, served

    # 5c. compact serving: the slice-7 path, counted.  The forced-panel 5120
    # requests and the segmentation one match the CPU; the 163k ones are
    # checked for shape and finiteness
    want = {k: {conv: n, "echo_compact_fwd": 1}
            for k, (conv, n) in compact_convs.items()}
    compact_launches, served = serve_counted(
        compact_serve, compact_recs, compact_batches, want)
    for k, p in compact_serve.items():
        if k in (big_c, big_a):
            out = served[k][0]
            check(out["logits"].shape == (N_LARGE, N_CORR_CLASSES)
                  and out["map"].shape == (N_LARGE,)
                  and np.isfinite(out["logits"]).all(),
                  f"{k}: bad output {out['logits'].shape}")
            print(f"serve {k}: logits {out['logits'].shape} finite, map in "
                  f"[{out['map'].min()}, {out['map'].max()}]")
        else:
            ref = "seg_n2048_b4" if k.startswith("seg") else "corr_n5120_b1"
            match_cpu(k, p, compact_recs[k], served[k], cpu_ref[ref], ref)
    print(f"serve compact: launches {compact_launches} for the "
          f"{len(compact_serve)} compact requests")
    del out, served, b0
    # 5g. serving on bf16 tables (train_100k.cast_batch: each batch's
    # PanelTable and CompactPanelTable cast by cast_panel_sten), counted:
    # the corr_n5120_b1 record on the mixed route (17 K1 + 1 K2 and the
    # bf16 panel lift) and forced onto the pure-panel layout with the
    # compact ECHO (17 K5 + 1 K7 and the compact lift), each against the
    # same Predictor on the CPU on its own cast tables
    bf16_serve = {"corr_n5120_b1_bf16": echo_serve["corr_n5120_b1"],
                  "corr_n5120_b1_panel_compact_bf16": compact_serve[
                      "corr_n5120_b1_panel_compact"]}
    bf16_recs = {k: echo_recs["corr_n5120_b1"] for k in bf16_serve}
    bf16_batches = {
        "corr_n5120_b1_bf16": cast_batches(echo_batches["corr_n5120_b1"]),
        "corr_n5120_b1_panel_compact_bf16": cast_batches(
            compact_batches["corr_n5120_b1_panel_compact"])}
    bf16_launches, served = serve_counted(
        bf16_serve, bf16_recs, bf16_batches,
        {"corr_n5120_b1_bf16": {"band_fused_fwd": 17, "echo_panel_fwd": 1},
         "corr_n5120_b1_panel_compact_bf16": {"band_panel_fwd": 17,
                                              "echo_compact_fwd": 1}})
    for k, p in bf16_serve.items():
        match_cpu(k, p, bf16_recs[k], served[k], cpu_predict(
            p, bf16_recs[k], echo_cpu_nets["corr_n5120_b1"],
            alt=cast_batches))
    del served
    # 5d. path A: the banded ECHO over the batch's compressed table with K1
    # convs, counted (9 / 17 K1 a request and nothing else: the banded ECHO
    # and lift are plain torch), each request against the CPU
    bech_launches, served = serve_counted(
        bech_serve, bech_recs, bech_batches,
        {k: {"band_fused_fwd": CONVS_PER_PASS[k]} for k in bech_serve})
    for k, p in bech_serve.items():
        match_cpu(k, p, bech_recs[k], served[k], cpu_ref[bech_of[k]],
                  bech_of[k])
    # 5e. path B: the same batches with the compressed table as the conv
    # table, counted (9 / 17 K4 a request, no K1), against the CPU
    cb_launches, served = serve_counted(
        bech_serve, bech_recs, cb_batches,
        {k: {"band_cfused_fwd": CONVS_PER_PASS[k]} for k in bech_serve})
    for k, p in bech_serve.items():
        match_cpu(f"{k} path B", p, bech_recs[k], served[k],
                  cpu_ref[bech_of[k]], bech_of[k])
    del served

    # 5f. path D: each batch's block-sparse table as the conv table (every
    # conv through K8; ECHO and the lift stay on the batch's panels),
    # counted (9 / 17 K8 + 1 K2 a request, no K1 or K5): the segmentation
    # batch and the correspondence record on the mixed route, each against
    # the CPU, and the 163k record on the pure-panel layout, held against
    # the same request on K5's route on the card.  The 163k table is built
    # now, from the serving batch's EdgeTable, and checked first (phase
    # 2c's checks at its four widths)
    t0 = time.perf_counter()
    bsp_big = block_sparse_of(panel_batches[big][0])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    nj, per_block, gb = sparse_stats(bsp_big)
    print(f"request {big} path D: block-sparse table NJ {nj}, "
          f"{per_block:.2f} live source blocks per target block, stencil "
          f"{gb:.3f} GB (the block panels: "
          f"{4 * bigp.sten.numel() / 1e9:.3f} GB); built on the host from "
          f"the serving batch's EdgeTable and placed in {build_s:.1f} s")
    # checked at the four widths, timed at the first (each 163k timing
    # takes ~3 s of the run; K8 serves no entry point)
    for i, (C_, O2) in enumerate(((32, 64), (16, 64), (32, 32), (16, 24))):
        rows8 = k8_check(f"{big} C={C_} O2={O2}", bsp_big, C_, O2, gen,
                         plain=(1, 1) if i == 0 else None)
        k8_rows.append(rows8[0])
        k8b_rows.append(rows8[1])
    print_times("K8", k8_rows[-4:-3], card)
    print_times("K8 bwd", k8b_rows[-4:-3], card)
    bsp_serve = {**echo_serve, big: panel_serve[big]}
    bsp_recs = {**echo_recs, big: panel_recs[big]}
    bsp_batches = {k: as_block_sparse(echo_batches[k]) for k in echo_serve}
    bsp_batches[big] = [dataclasses.replace(panel_batches[big][0],
                                            banded=bsp_big)]
    bsp_launches, served = serve_counted(
        bsp_serve, bsp_recs, bsp_batches,
        {k: {"band_sparse_fwd": CONVS_PER_PASS[k], "echo_panel_fwd": 1}
         for k in bsp_serve})
    for k in echo_serve:
        match_cpu(f"{k} path D", bsp_serve[k], bsp_recs[k], served[k],
                  cpu_ref[k], k)
    out = served[big][0]
    check(out["logits"].shape == (N_LARGE, N_CORR_CLASSES)
          and np.isfinite(out["logits"]).all(),
          f"{big} path D: bad output {out['logits'].shape}")
    del out, served
    worst, excess = logits_close(
        panel_serve[big].logits(bsp_batches[big][0]),
        panel_serve[big].logits(panel_batches[big][0]))
    check(excess <= LOGIT_ATOL,
          f"{big} path D: logits against K5's route exceed rtol "
          f"{LOGIT_RTOL} by {excess} > atol {LOGIT_ATOL}")
    print(f"serve {big} path D: logits ({N_LARGE}, {N_CORR_CLASSES}) finite, "
          f"against K5's route on the card: max abs diff {worst:.3e} (rtol "
          f"{LOGIT_RTOL}, atol {LOGIT_ATOL}); launches {bsp_launches} for the "
          f"three path-D requests")

    # the 163k compact-ECHO and all-compact batches, each built once above,
    # serve 7c and phase 8 too
    batch_c, batch_a = compact_batches[big_c][0], compact_batches[big_a][0]

    stamp("served")
    # 6., 7. and 7b. training: the slice-2 path (classification), the
    # slice-4 path (the ECHO presets on the mixed route) and the slice-6
    # path (the correspondence preset on the pure-panel layout: the 5120
    # training records forced there and held against the CPU, then the
    # N_LARGE record of the serving phase that layout="auto" sends there),
    # each counted
    trained, train_launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for path, keys in (("train", ["shrec11_b8"]),
                           ("train_echo", list(echo_cfg)),
                           ("train_panel", ["corr_n5120_b1_panel", big])):
            kernels.reset_launches()
            for k in keys:
                trained[k] = (fit_large(k, *fits[k], dev, args.seed, tmp,
                                        panel_batches[big][0])
                              if k == big else
                              fit_phase(k, *fits[k], dev, args.seed, tmp,
                                        cpu_jobs[ref_of[k]], ref_of[k]))
            train_launches[path] = dict(kernels.launches)

        # 7c. training on the compact route: the slice-8 path, counted.  The
        # 5120 training records forced onto the pure-panel layout with the
        # compact ECHO (K5 convs) and all-compact (K6 convs), and the
        # segmentation records on the mixed route with the compact ECHO (K1
        # convs), each held against the CPU's first epoch; one step of the
        # compact-ECHO route on phase 5c's 163k batch.  The all-compact fit
        # on the N_LARGE record comes at the end of phase 8, once the
        # block-panel table is freed, and its launches count here too
        kernels.reset_launches()
        for k in compact_keys:
            trained[k] = fit_phase(k, *fits[k], dev, args.seed, tmp,
                                   cpu_jobs[ref_of[k]], ref_of[k])
        trained[big_c] = step_counted(big_c, *fits[big_c][:2], batch_c, dev,
                                      args.seed)
        train_launches["train_compact"] = dict(kernels.launches)

        # 7d. path A training: fit with the banded ECHO (K1 convs each way,
        # the banded ECHO and lift in plain torch), counted, each held
        # against the CPU's first epoch
        kernels.reset_launches()
        for k in bech_cfg:
            trained[k] = fit_phase(k, *fits[k], dev, args.seed, tmp,
                                   cpu_jobs[ref_of[k]], ref_of[k])
        train_launches["train_banded_echo"] = dict(kernels.launches)

    stamp("trained")
    # 7e. path B training: on each preset's serving batch, the loss and
    # every gradient on paths A and B against the CPU's on the same batch
    # (uncounted), then one make_train_step step with the compressed table
    # as the conv table, counted: 9 / 17 K4 each way, nothing else
    cb_trained, cb_train, bech_rel = {}, Counter(), {}
    for k, cfg in bech_cfg.items():
        n_classes = echo_classes[bech_of[k]]
        net_, opt_, kw, bech_rel[k] = route_check(
            k, cfg, n_classes, route_weights[bech_of[k]],
            bech_batches[k][0], route_jobs[k, "B"], dev)
        step = make_train_step(net_, cfg, n_classes, opt_)
        kernels.reset_launches()
        loss = step(cb_batches[k][0], **kw[dev])
        torch.cuda.synchronize()
        grew = dict(kernels.launches)
        n = CONVS_PER_PASS[k]
        check(grew == {"band_cfused_fwd": n, "band_cfused_bwd": n},
              f"{k} path B: a step launched {grew}, want {n} K4 each way")
        check(abs(loss.item() - kw["cpu_loss"]) <= LOSS_ATOL_STEP1,
              f"{k} path B: the step's loss {loss.item()} against the CPU's "
              f"{kw['cpu_loss']}")
        print(f"train {k} path B: one make_train_step step, loss "
              f"{loss.item():.6f} (CPU {kw['cpu_loss']:.6f}), launches {grew}")
        cb_train.update(grew)
        cb_trained[k] = (net_, opt_)
    train_launches["train_cbanded"] = dict(cb_train)

    stamp("path B trained")
    # 7h. graph-parallel training (parallel/gp.py; every conv through K9),
    # as the module docstring sets out
    gp_train, gp_unfused = gp_phase(
        config, net, small, bech_cfg["seg_n2048_b4_bech"],
        echo_nets["seg_n2048_b4"], bech_batches["seg_n2048_b4_bech"][0],
        bech_rel["seg_n2048_b4_bech"], dev, args.seed, card)
    train_launches["train_graph_parallel"] = gp_train
    stamp("graph-parallel trained")
    # 7f. path D training: on each preset's serving batch the loss and every
    # gradient of paths A (K1 convs) and D (K8 convs) against the CPU's
    # (uncounted), then one make_train_step step on path D, counted (9 / 17
    # K8 + 1 K2 each way); then LARGE_EPOCHS steps on the 163k path-D batch,
    # counted, the first step's gradients held against K5's route
    bsp_trained, bsp_train, rel_spread = {}, Counter(), {}
    for k, cfg in echo_cfg.items():
        n_classes = echo_classes[k]
        net_, opt_, kw, rel_spread[k] = route_check(
            k, cfg, n_classes, route_weights[k], echo_batches[k][0],
            route_jobs[k, "D"], dev, alt=as_block_sparse, name="D",
            conv="K8")
        step = make_train_step(net_, cfg, n_classes, opt_)
        kernels.reset_launches()
        loss = step(bsp_batches[k][0], **kw[dev])
        torch.cuda.synchronize()
        grew = dict(kernels.launches)
        n = CONVS_PER_PASS[k]
        want = {"band_sparse_fwd": n, "band_sparse_bwd": n,
                "echo_panel_fwd": 1, "echo_panel_bwd": 1}
        check(grew == want, f"{k} path D: a step launched {grew}, want "
                            f"{want}")
        check(abs(loss.item() - kw["cpu_loss"]) <= LOSS_ATOL_STEP1,
              f"{k} path D: the step's loss {loss.item()} against the CPU's "
              f"{kw['cpu_loss']}")
        print(f"train {k} path D: one make_train_step step, loss "
              f"{loss.item():.6f} (CPU {kw['cpu_loss']:.6f}), launches {grew}")
        bsp_train.update(grew)
        bsp_trained[k] = (net_, opt_)
    torch.set_num_threads(os.cpu_count() or 8)   # the workers are done
    bsp_trained[big], grew = large_block_sparse_steps(
        big, corr_cfg, echo_nets["corr_n5120_b1"].state_dict(),
        panel_batches[big][0], bsp_batches[big][0], batch_a,
        rel_spread["corr_n5120_b1"], dev, args.seed)
    bsp_train.update(grew)
    train_launches["train_block_sparse"] = dict(bsp_train)

    stamp("path D trained")
    # 7g. the pure-panel route's gradient (K5, K2 and the panel lift, every
    # sum in a fixed order) and the mixed route's (K1, K2, the lift),
    # bitwise equal across two runs; then the bf16 panel stencils at
    # N_LARGE: scripts/train_100k.py's training (K5 convs on the bf16 block
    # panels, K7 and the compact lift on the bf16 compact table at TBt 32,
    # remat_blocks) for LARGE_EPOCHS steps and all-compact (K6 and K7 on
    # the bf16 compact table) for 2, on the tables built above, cast on the
    # card, counted; each route's step peak beside the same route's on the
    # f32 tables; one bf16 request on K5's route against K6's
    for k_, cfg_, b_ in (("corr_n5120_b1_panel",
                          panel_cfg["corr_n5120_b1_panel"],
                          panel_batches["corr_n5120_b1_panel"][0]),
                         ("seg_n2048_b4", seg_cfg,
                          echo_batches["seg_n2048_b4"][0])):
        net_k = "seg_n2048_b4" if k_.startswith("seg") else "corr_n5120_b1"
        repeat_check(k_, cfg_, echo_classes[net_k],
                     echo_nets[net_k].state_dict(), b_, dev, args.seed)
    lab100 = train_100k.template_labels(N_LARGE, bigp.n_pad).to(dev)
    t100 = {"f32": dataclasses.replace(batch_c, labels=lab100),
            "bf16": dataclasses.replace(batch_c, labels=lab100, panel=bigp16,
                                        compact=comp16),
            "f32 all-compact": dataclasses.replace(batch_a, labels=lab100),
            "bf16 all-compact": dataclasses.replace(
                batch_a, labels=lab100, panel=comp16, compact=comp16)}
    transient = {w: t100k_peak(f"{big} train_100k {w}", b_, args.seed, card)
                 for w, b_ in t100.items()}
    for w in ("bf16", "bf16 all-compact"):
        f32w = w.replace("bf16", "f32")
        check(transient[w] <= transient[f32w],
              f"{big} train_100k {w}: a step's peak above what it held "
              f"{transient[w]:.3f} GB, above the f32 tables' "
              f"{transient[f32w]:.3f} GB")
    print(f"train {big} train_100k: a step's peak above what it held, bf16 "
          f"tables {transient['bf16']:.3f} GB (f32 {transient['f32']:.3f}), "
          f"all-compact {transient['bf16 all-compact']:.3f} GB (f32 "
          f"{transient['f32 all-compact']:.3f}): no f32 copy of a table")
    t100k_launches = t100k_counted(f"{big} bf16", t100["bf16"], LARGE_EPOCHS,
                                   "band_panel", args.seed)
    t100k_launches.update(t100k_counted(
        f"{big} bf16 all-compact", t100["bf16 all-compact"], 2,
        "band_compact", args.seed))
    # T100K_COMPACT_TB=0: K2 and the panel lift on the bf16 block panels
    t100k_launches.update(t100k_counted(
        f"{big} bf16 T100K_COMPACT_TB=0", dataclasses.replace(
            t100["bf16"], compact=None), 1, "band_panel", args.seed,
        echo="echo_panel"))
    req16 = {big_c: t100["bf16"], big_a: t100["bf16 all-compact"]}
    large_bf16_launches = large_bf16_request(
        big, compact_serve[big_c], compact_serve[big_a], req16[big_c],
        req16[big_a], batch_c)

    stamp("bf16 tables at 163k trained and served")
    # 8. timing
    for args_ in timed:
        k1_time(*args_)
    for args_ in k2_timed:
        k2_time(*args_)
    print_times("K2", k2_rows[:len(k2_timed)], card)
    row, x, bigp, n_bins = k2_big
    args_ = (x, bigp.sten, bigp.meta, n_bins, x.shape[0] // TB)
    row["ms"] = time_cuda(lambda: echo_panel_grid(*args_), iters=10)
    row.update(k2_bound(*args_[:4]))
    print(f"K2 {row['shape']}: kernel {row['ms']:.4f} ms/call, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}; "
          f"{row['bytes'] / 1e6:.1f} MB, {row['flops'] / 1e9:.2f} GFLOP "
          f"needed; plain version not timed at this size) on {card}")
    for r in k2_rows:
        print(f"K2 {r['shape']}: {r['panels']} panels, {r['edges']} edges "
              f"(slot fill {r['slot_fill']:.3f}), {r['pairs']} (edge, "
              "non-origin channel) pairs")
    for args_ in k5_timed:
        k5_time(*args_)
    print_times("K5", k5_rows[:len(k5_timed)], card)
    for r in k5_rows[:len(k5_timed)]:
        print(f"K5 {r['shape']}: {r['panels']} panels, {r['occupied']} "
              f"occupied slots (fill {r['slot_fill']:.4f}), "
              f"{r['hats'] / r['occupied']:.2f} nonzero hats per slot; "
              f"{r['stencil_bytes'] / 1e9:.3f} GB of the "
              f"{r['stencil_bytes_whole'] / 1e9:.3f} GB stencil needed, "
              f"{r['bytes'] / 1e9:.3f} GB in all")
    compact_stats("K6", k6_rows, card)
    compact_stats("K7", k7_rows, card)
    for args_ in k5b_timed:
        k5_bwd_time(*args_)
    print_times("K5 bwd", k5b_rows[:len(k5b_timed)], card)
    for args_ in k2b_timed:
        k2_bwd_time(*args_)
    print_times("K2 bwd", k2b_rows, card)
    for r in k2b_rows:
        print(f"K2 bwd {r['shape']}: {r['ms_contiguous']:.4f} ms/call for a "
              f"contiguous cotangent ({r['ms']:.4f} cells minor, as a "
              f"training step passes it) on {card}")
    for args_ in bwd_timed:
        k1_bwd_time(*args_)
    print_times("K1", [a[0] for a in timed], card)
    for r, *_ in timed:
        print(f"K1 {r['shape']}: {r['dense_flops'] / 1e9:.2f} GFLOP dense, "
              f"slot fill {r['slot_fill']:.3f}, {r['rings_per_slot']:.2f} "
              "nonzero rings per occupied slot")
    print_times("K1 bwd", [a[0] for a in bwd_timed], card)
    # the backward by pass at n8192 and at the segmentation width
    for r, g, sten, wmat, dy, tb, nh in bwd_timed:
        if not r["shape"].startswith(("n8192", "seg_n2048_b4")):
            continue

        def bwd_synced():
            band_fused_bwd(dy, g, sten, wmat, tb, nh)
            torch.cuda.synchronize()

        _, busy, _, by = request_breakdown(bwd_synced, top=8,
                                           passes=K1_BWD_PASSES)
        r["passes_ms"] = {K1_BWD_PASSES[n]: by[n][0] for n in by}
        print_passes(f"K1 bwd {r['shape']}", by, card, "K1",
                     K1_BWD_PASSES)
        print(f"K1 bwd {r['shape']}: device busy {busy:.3f} ms")
    requests = [(k, p, recs[k], batches[k], "5 K1 launches")
                for k, p in serve.items()]
    requests += [(k, p, echo_recs[k], echo_batches[k],
                  f"{9 if k.startswith('seg') else 17} K1 + 1 K2 launches")
                 for k, p in echo_serve.items()]
    requests += [(k, p, panel_recs[k], panel_batches[k],
                  "17 K5 + 1 K2 launches") for k, p in panel_serve.items()]
    requests += [(k, p, compact_recs[k], compact_batches[k], compact_what(k))
                 for k, p in compact_serve.items() if k != big_a]
    requests += [(k, p, bech_recs[k], bech_batches[k],
                  f"{CONVS_PER_PASS[k]} K1 launches and the banded ECHO")
                 for k, p in bech_serve.items()]
    requests += [(f"{bech_of[k]}_cbanded", p, bech_recs[k], cb_batches[k],
                  f"{CONVS_PER_PASS[k]} K4 launches and the banded ECHO")
                 for k, p in bech_serve.items()]
    for k, p, rs_, bs_, what in requests:
        time_request(k, p, rs_, bs_, what, card, large=k in (big, big_c))
    stamp("requests timed")

    # the serving phases' batches: the same record, config and batch size
    # as the 163k fits'
    large_steps = {big: panel_batches[big][0], big_c: batch_c,
                   big_a: batch_a}

    # the serving batch of each training shape below N_LARGE (the shapes of
    # the fit's batches): its steps are timed there, no table built again
    step_batches = {"shrec11_b8": batches["shrec11_b8"][0],
                    "corr_n5120_b1_panel":
                        panel_batches["corr_n5120_b1_panel"][0],
                    **{k: b[0] for k, b in echo_batches.items()},
                    **{k: compact_batches[k][0] for k in compact_keys},
                    **{k: b[0] for k, b in bech_batches.items()}}

    def time_step(k, tnet, topt, cbanded=False, batch=None, conv=None):
        """Time one training step of the fitted ``tnet`` at training shape
        ``k`` on the serving batch of that shape (with ``cbanded``, on path
        B's batch: the compressed table as the conv table; given ``batch``,
        on that batch, whose conv kernel is ``conv``): host clock, the
        profiler's breakdown and, at N_LARGE, the peak device memory and
        (block panels, all-compact) a remat_blocks step."""
        cfg, n_classes, _ = fits[k]
        large = k in large_steps
        n_convs = CONVS_PER_PASS[k]
        if batch is not None:
            tbatch = batch
            k = f"{k}_bsp"
        elif large:
            tbatch = large_steps[k]
        elif cbanded:
            tbatch = cb_batches[k][0]
            k = f"{bech_of[k]}_cbanded"
        else:
            tbatch = step_batches[k]
        step = make_train_step(tnet, cfg, n_classes, topt)
        # the augmentation, and the correspondence net's dropout masks
        step_gen = torch.Generator().manual_seed(args.seed + 3)

        def train_step():
            step(tbatch, step_gen)
            torch.cuda.synchronize()

        what = step_what(cfg, tbatch.pos.shape[1], n_convs,
                         conv="band_cfused" if cbanded else conv)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_gb = torch.cuda.memory_allocated() / 1e9
        # a large step takes 0.7-2.3 s on the host clock (timed once, no
        # warm-up: the fit just ran its path), the banded ECHO's ~0.6 s
        ms = time_host(train_step, reps=1 if large or cfg.echo_impl ==
                       "banded" else 3, warmup=not large)
        print(f"train step {k}: {ms:.3f} ms per step (host clock, ending in "
              f"a sync; {what} launches) on {card}")
        if large:
            print(f"train step {k}: peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
                  f"({base_gb:.2f} GB allocated before the steps: tables, "
                  f"nets and the kernel checks' inputs) on {card}")
        wall, busy, kern, *by = request_breakdown(
            train_step, top=12 if large else 6,
            passes=K6_PASSES if k == big_a else ())
        print(f"train step {k} under the profiler: wall {wall:.3f} ms, "
              f"device busy {busy:.3f} ms ({100 * busy / wall:.1f}%) on "
              f"{card}; top kernels:")
        for t, name, count in kern:
            print(f"    {t:8.3f} ms  x{count:<4d} {name[:90]}")
        if by:
            print_passes(f"train step {k}", by[0], card)
        if k in (big, big_a):
            remat_step(k, tnet, cfg, n_classes, tbatch, dev, args.seed, card)

    for k, (tnet, topt) in trained.items():
        time_step(k, tnet, topt)
    for k, (tnet, topt) in cb_trained.items():
        time_step(k, tnet, topt, cbanded=True)
    # the bf16 request at N_LARGE (K5's route with the compact ECHO) and a
    # train_100k step on the f32 and on the bf16 tables
    time_request(f"{big_c}_bf16", compact_serve[big_c], compact_recs[big_c],
                 [req16[big_c]], "17 K5 + 1 K7 launches, bf16 tables", card,
                 large=True)
    for w in ("f32", "bf16"):
        time_t100k(f"{big} train_100k {w}", t100[w], args.seed, card)
    stamp("steps timed")

    b8192 = batches["n8192_b1"][0]
    edges = int(b8192.table.mask.sum().item())
    convs = conv_fwd_bwd(b8192.banded, dev, gen)
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
    # path C: the same five convs unfused (bench.py's BENCH_FUSE=0 A/B),
    # counted: 5 K3 each way, nothing else
    convs_u = conv_fwd_bwd(b8192.banded, dev, gen, fuse_filters=False)
    kernels.reset_launches()
    convs_u()
    torch.cuda.synchronize()
    unfused_launches = dict(kernels.launches)
    check(unfused_launches == {"band_contrib_fwd": 5, "band_contrib_bwd": 5},
          f"the five unfused convs launched {unfused_launches}, want 5 K3 "
          "each way")
    ms_u = time_cuda(convs_u, iters=5)
    print(f"five convs fwd+bwd unfused (fuse_filters=False: K3, then the "
          f"filter product): {ms_u:.3f} ms, {5 * edges / (ms_u / 1e3):.4g} "
          f"edges/s on {card} (fused {ms:.3f} ms); launches "
          f"{unfused_launches}")

    def convs_u_synced():
        convs_u()
        torch.cuda.synchronize()

    wall, busy, kern = request_breakdown(convs_u_synced)
    print(f"five convs fwd+bwd unfused under the profiler: wall {wall:.3f} "
          f"ms, device busy {busy:.3f} ms ({100 * busy / wall:.1f}%); top "
          "kernels:")
    for t, name, count in kern:
        print(f"    {t:8.3f} ms  x{count:<4d} {name[:90]}")
    del convs_u

    # path D timed: its requests (at 163k also Predictor.logits alone and
    # the peak device memory) and a make_train_step step at each shape (at
    # 163k the peak memory); then path E: five convs fwd+bwd over n8192's
    # block-sparse table, counted (5 K8 each way) and timed beside the five
    # K1 convs above
    for k, p in bsp_serve.items():
        time_request(f"{k}_bsp", p, bsp_recs[k], bsp_batches[k],
                     f"{CONVS_PER_PASS[k]} K8 + 1 K2 launches", card,
                     large=k == big)
    for k, (tnet, topt) in bsp_trained.items():
        time_step(k, tnet, topt, batch=bsp_batches[k][0], conv="band_sparse")
    convs_s = conv_fwd_bwd(bsp8192, dev, gen)
    kernels.reset_launches()
    convs_s()
    torch.cuda.synchronize()
    convs_launches = dict(kernels.launches)
    check(convs_launches == {"band_sparse_fwd": 5, "band_sparse_bwd": 5},
          f"the five block-sparse convs launched {convs_launches}, want 5 K8 "
          "each way")
    ms_s = time_cuda(convs_s, iters=5)
    print(f"five convs fwd+bwd over the block-sparse table (path E, N=8192, "
          f"NJ {bsp8192.nj}): {ms_s:.3f} ms, {5 * edges / (ms_s / 1e3):.4g} "
          f"edges/s on {card} (K1 over the dense band {ms:.3f} ms); launches "
          f"{convs_launches}")

    def convs_s_synced():
        convs_s()
        torch.cuda.synchronize()

    wall, busy, kern = request_breakdown(convs_s_synced)
    print(f"five block-sparse convs fwd+bwd under the profiler: wall "
          f"{wall:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f}%); top kernels:")
    for t, name, count in kern:
        print(f"    {t:8.3f} ms  x{count:<4d} {name[:90]}")
    del convs_s
    stamp("paths D and E timed")

    # the all-compact 163k request and fit last, once the block-panel and
    # block-sparse tables and everything that holds them are freed: their
    # device memory is their own.  The fit is the rest of 7c's path:
    # counted from 0, its launches join 7c's
    del (panel_batches, requests, bs_, k5_timed, k5b_timed, k2_big, bigp,
         bigp_seg, compact_batches[big_c], batch_c, args_, large_steps[big],
         large_steps[big_c], bsp_big, bsp_batches, bsp_trained[big], bigp16,
         comp16, t100, req16)
    gc.collect()
    torch.cuda.empty_cache()
    time_request(big_a, compact_serve[big_a], compact_recs[big_a],
                 compact_batches[big_a], compact_what(big_a), card,
                 large=True, passes=True)
    with tempfile.TemporaryDirectory() as tmp:
        kernels.reset_launches()
        trained[big_a] = fit_large(big_a, *fits[big_a], dev, args.seed, tmp,
                                   batch_a)
        train_launches["train_compact"] = dict(
            kernels.launches + Counter(train_launches["train_compact"]))
    time_step(big_a, *trained[big_a])

    stamp("timed")
    paths = {"serve": serve_launches, "serve_echo": echo_launches,
             "serve_panel": panel_launches, "serve_compact": compact_launches,
             "serve_banded_echo": bech_launches, "serve_cbanded": cb_launches,
             "unfused": unfused_launches, "serve_block_sparse": bsp_launches,
             "convs_block_sparse": convs_launches, **train_launches,
             "serve_bf16": bf16_launches,
             "serve_163k_bf16": large_bf16_launches,
             "train_100k_bf16": t100k_launches,
             "unfused_graph_parallel": gp_unfused}
    # the paths whose panel stencils are bf16, and the kernels that read
    # one: such a kernel's launches there count under its bf16 entry
    bf16_paths = ("serve_bf16", "serve_163k_bf16", "train_100k_bf16")
    bf16_kernels = tuple(f"{k}_{d}" for k in ("band_panel", "band_compact",
                                              "echo_panel", "echo_compact")
                         for d in ("fwd", "bwd"))

    def entry(name, source, replaces, rs, bf16=False):
        by_path = {k: v.get(name, 0) for k, v in paths.items()
                   if name not in bf16_kernels or (k in bf16_paths) == bf16}
        return {
            "name": f"{name}_bf16" if bf16 else name, "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": rs[0]["ms"], "plain_ms": rs[0]["plain_ms"],
            "bound_ms": rs[0]["bound_ms"], "bound_by": rs[0]["bound_by"],
            "library_ms": rs[0].get("library_ms"),
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
        entry("band_panel_fwd", "fieldconv_tpu_torch/csrc/band_panel_fwd.cu",
              "fieldconv_tpu/ops/pallas/band_conv.py:2187", k5_rows),
        entry("band_panel_bwd", "fieldconv_tpu_torch/csrc/band_panel_bwd.cu",
              "fieldconv_tpu/ops/pallas/band_conv.py:2293", k5b_rows),
        entry("band_compact_fwd",
              "fieldconv_tpu_torch/csrc/band_compact_fwd.cu",
              "fieldconv_tpu/ops/pallas/band_conv.py:2042", k6_rows),
        entry("echo_compact_fwd",
              "fieldconv_tpu_torch/csrc/echo_compact_fwd.cu",
              "fieldconv_tpu/ops/pallas/echo_panel.py:310", k7_rows),
        entry("band_compact_bwd",
              "fieldconv_tpu_torch/csrc/band_compact_bwd.cu",
              "fieldconv_tpu/ops/pallas/band_conv.py:2084", k6b_rows),
        entry("echo_compact_bwd",
              "fieldconv_tpu_torch/csrc/echo_compact_bwd.cu",
              "fieldconv_tpu/ops/pallas/echo_panel.py:342", k7b_rows),
        entry("band_cfused_fwd", "fieldconv_tpu_torch/csrc/band_cfused_fwd.cu",
              "fieldconv_tpu/ops/pallas/band_conv.py:1427 and :1176", k4_rows),
        entry("band_cfused_bwd", "fieldconv_tpu_torch/csrc/band_cfused_bwd.cu",
              "fieldconv_tpu/ops/pallas/band_conv.py:1462 and :1209",
              k4b_rows),
        entry("band_contrib_fwd",
              "fieldconv_tpu_torch/csrc/band_contrib_fwd.cu",
              "fieldconv_tpu/ops/pallas/band_conv.py:153", k3_rows),
        entry("band_contrib_bwd",
              "fieldconv_tpu_torch/csrc/band_contrib_bwd.cu",
              "fieldconv_tpu/ops/pallas/band_conv.py:196", k3b_rows),
        entry("band_sparse_fwd", "fieldconv_tpu_torch/csrc/band_sparse_fwd.cu",
              "fieldconv_tpu/ops/pallas/band_conv.py:839 and :979", k8_rows),
        entry("band_sparse_bwd", "fieldconv_tpu_torch/csrc/band_sparse_bwd.cu",
              "fieldconv_tpu/ops/pallas/band_conv.py:881 and :1012",
              k8b_rows),
        entry("halo_fused_fwd", "fieldconv_tpu_torch/csrc/halo_fused_fwd.cu",
              "fieldconv_tpu/parallel/halo.py:192 and :283", k9_rows),
        entry("halo_fused_bwd", "fieldconv_tpu_torch/csrc/halo_fused_bwd.cu",
              "fieldconv_tpu/parallel/halo.py:225 and :312", k9b_rows),
        entry("halo_contrib_fwd",
              "fieldconv_tpu_torch/csrc/halo_contrib_fwd.cu",
              "fieldconv_tpu/parallel/halo.py:61", k9c_rows),
        entry("halo_contrib_bwd",
              "fieldconv_tpu_torch/csrc/halo_contrib_bwd.cu",
              "fieldconv_tpu/parallel/halo.py:80", k9cb_rows),
        entry("compact_fold", "fieldconv_tpu_torch/csrc/compact_fold.cuh",
              "the XLA segment_sums at fieldconv_tpu/ops/pallas/band_conv.py"
              ":2118, fieldconv_tpu/ops/pallas/echo_panel.py:378 and "
              "fieldconv_tpu/ops/trans_field.py:408", fold_rows),
        *(entry(name, f"fieldconv_tpu_torch/csrc/{name}.cu",
                f"fieldconv_tpu/ops/pallas/{where} (bf16 stencil)",
                b16[kind], bf16=True)
          for name, where, kind in (
              ("band_panel_fwd", "band_conv.py:2187", "K5"),
              ("band_panel_bwd", "band_conv.py:2293", "K5 bwd"),
              ("band_compact_fwd", "band_conv.py:2042", "K6"),
              ("band_compact_bwd", "band_conv.py:2084", "K6 bwd"),
              ("echo_panel_fwd", "echo_panel.py:408", "K2"),
              ("echo_panel_bwd", "echo_panel.py:443", "K2 bwd"),
              ("echo_compact_fwd", "echo_panel.py:310", "K7"),
              ("echo_compact_bwd", "echo_panel.py:342", "K7 bwd"))),
    ]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
