"""Smoke run of the PyTorch port (fieldconv_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root

Phases, any failure exits non-zero:
  1. build every CUDA kernel from csrc/ and print the card's name and
     power limit;
  2. hold the K1 kernel (fused banded field-conv forward) against its plain
     PyTorch version on the card: at the two serving shapes, on the real
     stencils of the records below, and on a dense random stencil with
     nh=4 that reaches past both ends of g;
  3. serve the SHREC11 classification network (the CLASSIFICATION preset:
     nf=32, B=2, R=6, ftype=1, 30 classes, random weights from a seed)
     through Predictor(banded_tb=128, device="cuda"): one batch of 8
     SHREC11-sized records (~600 samples, ε=0.2, degree 60-80) and one
     record of 8192 samples with degree 128.  Each batch must launch K1
     five times; classes and logits must match the same Predictor on the
     CPU, which runs the plain versions;
  4. time K1, its plain version and each request shape;
  5. print the kernels line, the card line and the result line.

Records are synthetic, built with numpy from --seed in the manner of
bench.py::build_synthetic_tables: unique sources within ±bandwidth of each
target (the locality RCM ordering gives real meshes), log-map radius in
[0, ε], random unit transports.  Nothing of JAX is imported.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from fieldconv_tpu_torch import kernels
from fieldconv_tpu_torch.data.base import MeshRecord
from fieldconv_tpu_torch.deploy import Predictor
from fieldconv_tpu_torch.ops.band_conv import (band_fused_fwd,
                                               band_fused_fwd_reference)
from fieldconv_tpu_torch.train.config import PRESETS
from fieldconv_tpu_torch.train.loop import build_model

# H100 SXM data-sheet peaks (dense, 700 W): HBM bytes/s and f32 FLOP/s
# outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
N_CLASSES = 30
TB = 128
# K1 against its plain version: f32 sums in another order over W' ≤ 1152
# slots and R·M = 1920 filter terms; held to 1e-4 of the output's scale
K1_RTOL_SCALE = 1e-4
# served logits, card against CPU: every op sums in another order
LOGIT_RTOL, LOGIT_ATOL = 1e-3, 1e-4


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
    sources within ±bandwidth, radii in [0, ε], unit transports."""
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
        labels=np.int64(label),
        epsilon=eps,
    )


def shrec_records(rng, eps):
    return [synthetic_record(rng, int(rng.integers(560, 621)), 60, 80, 200,
                             eps, f"shrec{i}", int(rng.integers(N_CLASSES)))
            for i in range(8)]


def large_record(rng, eps):
    return synthetic_record(rng, 8192, 128, 128, 128, eps, "n8192", 0)


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


def k1_bound(g, sten, wmat):
    """Least time for one call: bytes (each input read once, y written
    once) over HBM rate, and the f32 operations this data needs over the
    f32 rate.  The stencil term takes the cheaper of two orders: per
    occupied slot (any nonzero radial weight of target t at slot w) form
    h_k = f_k·G_k once (6C flops per k) and per nonzero radial weight
    add rs·h_k (4C per k); or per nonzero radial weight scale f_k by it
    (2 per k) and add the complex product (8C per k).  Plus the filter
    contraction 2·N·R·M·O2."""
    n_mesh, N, M = g.shape
    R, _, O2 = wmat.shape
    K = (sten.shape[2] - R) // 2
    C = M // (2 * K)
    rs = sten[:, :, :R]
    nnz = int(torch.count_nonzero(rs).item())
    occupied = int((rs != 0).any(dim=2).sum().item())
    stencil = min(occupied * K * 6 * C + nnz * K * 4 * C,
                  nnz * K * (8 * C + 2))
    flops = stencil + 2 * n_mesh * N * R * M * O2
    dense = (8 * R * sten.shape[3] * sten.shape[4] * C * K
             * sten.shape[1] * n_mesh + 2 * n_mesh * N * R * M * O2)
    nbytes = 4 * (sten.numel() + g.numel() + wmat.numel() + n_mesh * N * O2)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops, dense_flops=dense,
                slot_fill=nnz / max(1, R * sten.numel() // sten.shape[2]),
                rings_per_slot=nnz / max(1, occupied))


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

    # 2. K1 against its plain version at the shapes serving gives it
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    C, R = config.nf, config.n_rings
    rows, timed = [], []
    for label, key, O2 in (("n8192 (bench.py shape)", "n8192_b1", 2 * C),
                           ("shrec11 b8 (conv_out)", "shrec11_b8",
                            2 * N_CLASSES)):
        bt = batches[key][0].banded
        g, wmat = k1_inputs(bt.sten_band, R, C, O2, gen)
        rows.append(k1_check(label, g, bt.sten_band, wmat, TB, bt.nh))
        timed.append((rows[-1], g, bt.sten_band, wmat, TB, bt.nh))
    dense = torch.rand(8, 5, R + 4 * config.band_limit + 2, TB, 9 * TB,
                       device=dev, generator=gen)
    g, wmat = k1_inputs(dense, R, C, 2 * N_CLASSES, gen)
    rows.append(k1_check("n640 b8 nh=4 dense random stencil", g, dense, wmat,
                         TB, 4))
    del dense, g, wmat

    # 3. serving: the main path, counted
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
    main_launches = dict(kernels.launches)
    check(main_launches.get("band_fused_fwd", 0) > 0,
          "the main path launched no K1")

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

    # 4. timing
    for args_ in timed:
        k1_time(*args_)
    for r in rows[:2]:
        print(f"K1 {r['shape']}: kernel {r['ms']:.4f} ms/call, plain "
              f"{r['plain_ms']:.4f} ms/call, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}; {r['bytes'] / 1e6:.1f} MB, "
              f"{r['flops'] / 1e9:.2f} GFLOP needed, "
              f"{r['dense_flops'] / 1e9:.2f} GFLOP dense, slot fill "
              f"{r['slot_fill']:.3f}, {r['rings_per_slot']:.2f} nonzero "
              f"rings per occupied slot) on {card}")
    for k, p in serve.items():
        ms = time_host(lambda: p.predict(recs[k], batches=batches[k]))
        print(f"request {k}: {ms:.3f} ms per request (forward over placed "
              f"tables, 5 K1 launches) on {card}")
        wall, busy, kern = request_breakdown(
            lambda: p.predict(recs[k], batches=batches[k]))
        print(f"request {k} under the profiler: wall {wall:.3f} ms, device "
              f"busy {busy:.3f} ms ({100 * busy / wall:.1f}%); top kernels:")
        for t, name, count in kern:
            print(f"    {t:8.3f} ms  x{count:<4d} {name[:90]}")

    k1 = rows[0]
    line = {"kernels": [{
        "name": "band_fused_fwd",
        "route": "cuda",
        "source": "fieldconv_tpu_torch/csrc/band_fused_fwd.cu",
        "replaces": "fieldconv_tpu/ops/pallas/band_conv.py:1609",
        "launches": main_launches.get("band_fused_fwd", 0),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": None,
        "shapes": rows,
    }]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
