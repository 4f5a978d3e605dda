"""How close a loss gradient on the card comes to the CPU's, per parameter.

The card tests hold one correspondence loss backward on the card against the
same on the CPU (plain versions), each parameter's gradient within 1e-4 of
its largest entry.  This script reads that margin over several inputs on
three routes, and two yardsticks of f32 summation order beside it: the
same gradients on the CPU on a compact route against the pure-panel route
(one function, two layouts, plain versions only), and the card against
itself (a second run).  Needs a card.

    python -m fieldconv_tpu_torch.train.grad_margin --cases 8

Each case draws a 200-vertex record (16 sources per target within ±40, radii
in [0, 0.05]), the CORRESPONDENCE preset at nf=8, n_des=4 on the pure-panel
layout, 6 classes, and a dropout mask and augmentation, all from its seeds;
case "test" is the card test's own draw.  Routes: "panel" (K5 convs, K2),
"compact" (K5 convs, K7) and "allcompact" (K6 convs, K7).
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from fieldconv_tpu_torch.data.base import MeshRecord
from fieldconv_tpu_torch.train.config import PRESETS
from fieldconv_tpu_torch.train.loop import build_model, make_batches
from fieldconv_tpu_torch.train.trainer import draw_rotate_scale, make_loss_fn

ROUTES = {"panel": {},
          "compact": {"echo_impl": "compact"},
          "allcompact": {"echo_impl": "compact", "conv_impl": "compact"}}


def record(rng, n=200, deg=16, bw=40, eps=0.05):
    """A mesh record whose targets have ``deg`` unique sources within ±bw,
    radii in [0, ε], unit transports and 6 per-vertex classes (drawn
    first)."""
    labels = rng.integers(0, 6, n)
    src = np.arange(n)[:, None] + np.arange(-bw, bw + 1)[None, :]
    keys = rng.random(src.shape)
    keys[(src < 0) | (src >= n)] = np.inf
    picked = np.take_along_axis(src, np.argsort(keys, 1)[:, :deg], 1)
    edges = np.stack([picked.ravel(), np.repeat(np.arange(n), deg)], -1)
    E = len(edges)
    ang = rng.uniform(-np.pi, np.pi, E)
    return MeshRecord(
        name="r", pos=rng.normal(size=(n, 3)).astype(np.float32),
        supp_edges=edges.astype(np.int64),
        log_mag=rng.uniform(0, eps, E).astype(np.float32),
        log_ang=rng.uniform(-np.pi, np.pi, E).astype(np.float32),
        xp=np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32),
        weights=rng.uniform(0.1, 1.0, n).astype(np.float32),
        labels=labels, epsilon=eps)


def grads(route, seeds):
    """The loss gradient of every parameter on the CPU and twice on the card
    for one case; ``seeds`` = (record, weights, augmentation, dropout
    mask).  Returns the parameter names and {"cpu" / "cuda" / "cuda2":
    [gradient, on the CPU]}."""
    s_rec, s_net, s_aug, s_mask = seeds
    config = dataclasses.replace(PRESETS["correspondence"], nf=8, n_des=4,
                                 layout="panel", **ROUTES[route])
    recs = [record(np.random.default_rng(s_rec))]
    net = build_model(config, 6, torch.Generator().manual_seed(s_net),
                      device="cpu")
    names = [n for n, _ in net.named_parameters()]
    aug = draw_rotate_scale(torch.Generator().manual_seed(s_aug), 1, 45.0,
                            None)
    out = {}
    for run in ("cpu", "cuda", "cuda2"):
        dev = "cpu" if run == "cpu" else "cuda"
        batch = make_batches(recs, config, 1, 32, device=dev)[0]
        mask = torch.from_numpy((np.random.default_rng(s_mask).random(
            (1, batch.pos.shape[1], 256)) < 0.5).astype(np.float32))
        net = net.to(dev)
        loss = make_loss_fn(net, config, 6)(batch, aug=aug,
                                            dropout_mask=mask.to(dev))
        out[run] = [g.cpu() for g in torch.autograd.grad(
            loss, list(net.parameters()))]
    return names, out


def rel(a, b):
    """max|a - b| over max|b|, in units of the card tests' 1e-4 bar."""
    return ((a - b).abs().max() / b.abs().max()).item() / 1e-4


def worst(names, ga, gb):
    """The parameters sorted by rel(ga, gb), worst first."""
    return sorted(((rel(a, b), n) for n, a, b in zip(names, ga, gb)),
                  reverse=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cases", type=int, default=8,
                    help="random cases besides the card test's own")
    ap.add_argument("--routes", nargs="+", default=list(ROUTES))
    ap.add_argument("--top", type=int, default=3,
                    help="parameters printed per case, worst first")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("grad_margin needs a CUDA device")
    cases = [("test", (2, 0, 1, 3))] + [
        (str(c), (100 + c, 200 + c, 300 + c, 400 + c))
        for c in range(args.cases)]
    print("each reading is max|a - b| / max|b| of one parameter's gradient "
          "over 1e-4: above 1 fails the card tests' bar")
    summary = {}
    for label, seeds in cases:
        g = {}
        for route in args.routes:
            names, g[route] = grads(route, seeds)
        for route in args.routes:
            rows = worst(names, g[route]["cuda"], g[route]["cpu"])
            again = worst(names, g[route]["cuda2"], g[route]["cuda"])[0]
            line = (f"{route} case {label}: card - CPU " + ", ".join(
                f"{n} {r:.4f}" for r, n in rows[:args.top])
                + f"; card - card {again[0]:.4f}")
            summary.setdefault((route, "card - CPU"), []).append(rows[0][0])
            summary.setdefault((route, "card - card"), []).append(again[0])
            if route != "panel" and "panel" in g:
                r, n = worst(names, g[route]["cpu"], g["panel"]["cpu"])[0]
                line += f"; CPU, this route - panel route {n} {r:.4f}"
                summary.setdefault((route, "CPU, this route - panel route"),
                                   []).append(r)
            print(line)
    for (route, what), rs in summary.items():
        print(f"{route}, {what}: worst parameter per case, sorted: "
              + " ".join(f"{r:.4f}" for r in sorted(rs)))


if __name__ == "__main__":
    main()
