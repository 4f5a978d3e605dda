"""CUDA kernels of the port against their plain versions, on the card.

These tests need an NVIDIA card and skip without one.  They import no JAX
(the card's machine has none), so run them there without the JAX-loading
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from fieldconv_tpu_torch import kernels
from fieldconv_tpu_torch.data.base import MeshRecord
from fieldconv_tpu_torch.data.synthetic import (random_block_sparse,
                                                sphere_record,
                                                synthetic_record)
from fieldconv_tpu_torch.ops import band_conv as tbc
from fieldconv_tpu_torch.ops import compact_fold as tcf
from fieldconv_tpu_torch.ops import echo_panel as tep
from fieldconv_tpu_torch.precomp.banded import (BandedTable,
                                                build_banded_table,
                                                build_block_sparse_banded,
                                                build_panel_table,
                                                concat_panel_tables,
                                                stack_block_sparse_tables)
from fieldconv_tpu_torch.train.config import PRESETS
from fieldconv_tpu_torch.train.loop import build_model, make_batches
from fieldconv_tpu_torch.train.trainer import (batched_apply,
                                               draw_rotate_scale,
                                               make_loss_fn)

# odd widths with O2 = 10; O2 = 60 as conv_out with 3 meshes; serving
# widths with a window past both ends; the segmentation width (C = 48,
# O2 = 96) and the correspondence ones (K = 3, R = 3, O2 = 24, 32, 64)
_SHAPES = [
    (3, 5, 2, 1, 8, 1, 1),
    (4, 30, 6, 2, 8, 2, 3),
    (32, 32, 6, 2, 16, 3, 2),
    (48, 48, 6, 2, 16, 1, 2),
    (16, 12, 3, 1, 16, 2, 1),
    (32, 16, 3, 1, 16, 1, 1),
    (32, 32, 3, 1, 16, 2, 1),
]
SHAPES = pytest.mark.parametrize("C,O,R,B,tb,nh,n_mesh", _SHAPES)
# K4's walk (csrc/band_pipe.cuh, the compressed slot mode): K = 1 with R =
# 3 and 6, K = 3 with R = 6, K = 5 with R = 3, 4 and 5 (slots narrower than
# the instantiation's), TB = 256 (two virtual blocks of 128) at K = 5 and K
# = 3, TB = 12 (rows of 12 slots: no float4 copy of r, padded slab rows),
# nh = 0 and 3, C = 1 and 256
K4_EDGE = [
    (16, 12, 3, 0, 16, 1, 2),
    (3, 10, 6, 0, 8, 2, 1),
    (32, 32, 6, 1, 16, 1, 2),
    (48, 48, 3, 2, 16, 1, 2),
    (16, 24, 4, 2, 8, 2, 1),
    (32, 64, 5, 2, 16, 3, 3),
    (32, 32, 6, 2, 256, 1, 1),
    (16, 24, 3, 1, 256, 1, 2),
    (8, 16, 3, 1, 12, 1, 2),
    (1, 4, 6, 1, 16, 0, 1),
    (256, 16, 6, 2, 16, 1, 1),
]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")


def _k1_inputs(C, O, R, B, tb, nh, n_mesh):
    """Random g, dense random stencil (every out-of-range slot is
    exercised), W and dy on the card."""
    K, N = 2 * B + 1, 4 * tb
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    g = torch.randn(n_mesh, N, K * 2 * C, device=dev, generator=gen)
    sten = torch.randn(n_mesh, N // tb, R + 2 * K, tb, (2 * nh + 1) * tb,
                       device=dev, generator=gen)
    wmat = torch.randn(R, K * 2 * C, 2 * O, device=dev, generator=gen)
    dy = torch.randn(n_mesh, N, 2 * O, device=dev, generator=gen)
    return g, sten, wmat, dy


@pytest.mark.cuda
@SHAPES
def test_k1_kernel_matches_plain_on_card(C, O, R, B, tb, nh, n_mesh):
    """The CUDA kernel equals its plain version on the card; tolerance 1e-4
    of the output's scale (f32 sums in another order)."""
    _need_card()
    g, sten, wmat, _ = _k1_inputs(C, O, R, B, tb, nh, n_mesh)
    before = kernels.launches["band_fused_fwd"]
    got = tbc.band_fused_fwd(g, sten, wmat, tb, nh)
    torch.cuda.synchronize()
    assert kernels.launches["band_fused_fwd"] == before + 1
    want = tbc.band_fused_fwd_reference(g, sten, wmat, tb, nh)
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), err


@pytest.mark.cuda
@SHAPES
def test_k1_bwd_kernel_matches_plain_on_card(C, O, R, B, tb, nh, n_mesh):
    """The backward kernel equals its plain version on the card (dg and dw
    each to 1e-4 of its scale: f32 sums in another order, dw over every
    target of every mesh), and two calls are bitwise equal (no atomics)."""
    _need_card()
    g, sten, wmat, dy = _k1_inputs(C, O, R, B, tb, nh, n_mesh)
    before = kernels.launches["band_fused_bwd"]
    dg, dw = tbc.band_fused_bwd(dy, g, sten, wmat, tb, nh)
    torch.cuda.synchronize()
    assert kernels.launches["band_fused_bwd"] == before + 1
    want_g, want_w = tbc.band_fused_bwd_reference(dy, g, sten, wmat, tb, nh)
    for got, want in ((dg, want_g), (dw, want_w)):
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), err
    dg2, dw2 = tbc.band_fused_bwd(dy, g, sten, wmat, tb, nh)
    assert torch.equal(dg, dg2) and torch.equal(dw, dw2)


@pytest.mark.cuda
def test_field_conv_banded_backward_card_matches_cpu():
    """One field_conv_banded backward through both K1 kernels on the card
    equals the same on the CPU (plain versions): grads of x and of the
    three filter tensors to 1e-4 of their scale."""
    _need_card()
    rng = np.random.default_rng(0)
    n_mesh, N, tb, nh, C, O, R, B = 2, 32, 8, 2, 4, 3, 6, 2
    K = 2 * B + 1
    sten = rng.normal(size=(n_mesh, N // tb, R + 2 * K, tb, (2 * nh + 1) * tb))
    sten[:, :, :R] *= rng.random(sten[:, :, :R].shape) < 0.2   # sparse rings
    x = rng.normal(size=(n_mesh, N, C, 2))
    filt = [rng.normal(size=s) for s in ((O, C, R), (O, C, R, B, 2),
                                         (O, C, B + 1))]
    dy = rng.normal(size=(n_mesh, N, O, 2))
    grads = {}
    for dev in ("cpu", "cuda"):
        t = [torch.tensor(a, dtype=torch.float32, device=dev,
                          requires_grad=True) for a in (x, *filt)]
        bt = BandedTable(torch.tensor(sten, dtype=torch.float32, device=dev),
                         tb=tb, nh=nh, n_pad=N, band_limit=B, n_rings=R)
        y = tbc.field_conv_banded(t[0], bt, *t[1:], 1)
        y.backward(torch.tensor(dy, dtype=torch.float32, device=dev))
        grads[dev] = [a.grad.cpu() for a in t]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        err = (a - b).abs().max().item()
        assert err <= 1e-4 * b.abs().max().item(), err


def _k4_stencil(R, B, tb, nh, n_mesh):
    """A random compressed stencil on the card: r uniform in [0, 1] with
    ~60% empty slots (R_SENTINEL), unit phasors, random wxp (zero at empty
    slots, as build_compressed_banded leaves it)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    shape = (n_mesh, 4, tb, (2 * nh + 1) * tb)
    dev = torch.device("cuda")
    empty = torch.rand(shape, device=dev, generator=gen) < 0.6
    r = torch.rand(shape, device=dev, generator=gen).masked_fill(empty, 9.0)
    th = torch.rand(shape, device=dev, generator=gen) * 6.2831853
    w = torch.randn((2, *shape), device=dev, generator=gen).masked_fill(
        empty, 0.0)
    return torch.stack([r, torch.cos(th), torch.sin(th), w[0], w[1]], dim=2)


@pytest.mark.cuda
@pytest.mark.parametrize("C,O,R,B,tb,nh,n_mesh", _SHAPES + K4_EDGE)
def test_k4_kernel_matches_plain_on_card(C, O, R, B, tb, nh, n_mesh):
    """K4 (compressed stencil) forward and backward equal their plain
    versions on the card (y, dg and dw each to 1e-4 of its scale: f32 sums
    in another order), one launch each, and two backward calls are bitwise
    equal (no atomics).  The stencil's slots past both ends of g hold
    values too, which the kernel must not read."""
    _need_card()
    g, _, wmat, dy = _k1_inputs(C, O, R, B, tb, nh, n_mesh)
    sten = _k4_stencil(R, B, tb, nh, n_mesh)
    args = (sten, tb, nh, R, B)
    before = dict(kernels.launches)
    y = tbc.band_cfused_fwd(g, wmat, *args)
    dg, dw = tbc.band_cfused_bwd(dy, g, wmat, *args)
    torch.cuda.synchronize()
    assert kernels.launches["band_cfused_fwd"] == \
        before.get("band_cfused_fwd", 0) + 1
    assert kernels.launches["band_cfused_bwd"] == \
        before.get("band_cfused_bwd", 0) + 1
    want = (tbc.band_cfused_reference(g, wmat, *args),
            *tbc.band_cfused_bwd_reference(dy, g, wmat, *args))
    for got, w in zip((y, dg, dw), want):
        err = (got - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item(), err
    dg2, dw2 = tbc.band_cfused_bwd(dy, g, wmat, *args)
    assert torch.equal(dg, dg2) and torch.equal(dw, dw2)
    assert torch.equal(y, tbc.band_cfused_fwd(g, wmat, *args))


@pytest.mark.cuda
@SHAPES
def test_k3_kernel_matches_plain_on_card(C, O, R, B, tb, nh, n_mesh):
    """K3 (the unfused contrib) forward and backward equal their plain
    versions on the card (contrib and dg to 1e-4 of their scale), one
    launch each, and two backward calls are bitwise equal."""
    _need_card()
    g, sten, _, _ = _k1_inputs(C, O, R, B, tb, nh, n_mesh)
    K = 2 * B + 1
    args = (sten, tb, nh, R, K)
    dout = torch.randn(n_mesh, g.shape[1] * R, g.shape[2], device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(2))
    before = dict(kernels.launches)
    out = tbc.band_contrib_fwd(g, *args)
    dg = tbc.band_contrib_bwd(dout, *args)
    torch.cuda.synchronize()
    assert kernels.launches["band_contrib_fwd"] == \
        before.get("band_contrib_fwd", 0) + 1
    assert kernels.launches["band_contrib_bwd"] == \
        before.get("band_contrib_bwd", 0) + 1
    for got, w in ((out, tbc.band_contrib_reference(g, *args)),
                   (dg, tbc.band_contrib_bwd_reference(dout, *args))):
        err = (got - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item(), err
    assert torch.equal(dg, tbc.band_contrib_bwd(dout, *args))


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["banded_echo", "cbanded"])
def test_banded_echo_loss_backward_card_matches_cpu(path):
    """One segmentation loss backward with echo_impl="banded" (the banded
    ECHO and lift over the compressed table; K1 convs, or with the
    compressed table as the conv table K4 convs) on the card against the
    same on the CPU: every parameter's gradient within 1e-4 of its scale,
    with exactly 9 launches of the conv kernel each way and no other."""
    _need_card()
    rng = np.random.default_rng(3)
    config = dataclasses.replace(PRESETS["segmentation"], nf=8, n_des=8,
                                 echo_impl="banded")
    recs = [_record(rng, 200 - 30 * i, 16, 40, 0.2,
                    labels=rng.integers(0, 4, 200 - 30 * i))
            for i in range(2)]
    net = build_model(config, 4, torch.Generator().manual_seed(0),
                      device="cpu")
    aug = draw_rotate_scale(torch.Generator().manual_seed(1), 2)
    grads = {}
    conv = "band_cfused" if path == "cbanded" else "band_fused"
    for dev in ("cpu", "cuda"):
        batch = make_batches(recs, config, 2, 32, device=dev)[0]
        if path == "cbanded":
            batch = dataclasses.replace(batch, banded=batch.comp)
        net = net.to(dev)
        before = dict(kernels.launches)
        loss = make_loss_fn(net, config, 4)(batch, aug=aug)
        grads[dev] = [g.cpu() for g in torch.autograd.grad(
            loss, list(net.parameters()))]
        grew = {k: v - before.get(k, 0) for k, v in kernels.launches.items()
                if v != before.get(k, 0)}
        assert grew == ({} if dev == "cpu" else {
            f"{conv}_fwd": 9, f"{conv}_bwd": 9}), grew
    for (name, _), a, b in zip(net.named_parameters(), grads["cuda"],
                               grads["cpu"]):
        err = (a - b).abs().max().item()
        assert err <= 1e-4 * b.abs().max().item(), (name, err)


@pytest.mark.cuda
def test_field_conv_banded_unfused_card_matches_fused():
    """field_conv_banded(fuse_filters=False) on the card (K3 both ways,
    then the filter product) equals the fused route (K1 both ways) on the
    same card: y and the grads of x and the three filter tensors to 1e-4 of
    their scale."""
    _need_card()
    rng = np.random.default_rng(0)
    n_mesh, N, tb, nh, C, O, R, B = 2, 32, 8, 2, 4, 3, 6, 2
    K = 2 * B + 1
    sten = rng.normal(size=(n_mesh, N // tb, R + 2 * K, tb, (2 * nh + 1) * tb))
    sten[:, :, :R] *= rng.random(sten[:, :, :R].shape) < 0.2   # sparse rings
    x = rng.normal(size=(n_mesh, N, C, 2))
    filt = [rng.normal(size=s) for s in ((O, C, R), (O, C, R, B, 2),
                                         (O, C, B + 1))]
    dy = rng.normal(size=(n_mesh, N, O, 2))
    bt = BandedTable(torch.tensor(sten, dtype=torch.float32, device="cuda"),
                     tb=tb, nh=nh, n_pad=N, band_limit=B, n_rings=R)
    outs = []
    for fuse in (False, True):
        t = [torch.tensor(a, dtype=torch.float32, device="cuda",
                          requires_grad=True) for a in (x, *filt)]
        before = dict(kernels.launches)
        y = tbc.field_conv_banded(t[0], bt, *t[1:], 1, fuse_filters=fuse)
        y.backward(torch.tensor(dy, dtype=torch.float32, device="cuda"))
        grew = {k: v - before.get(k, 0) for k, v in kernels.launches.items()
                if v != before.get(k, 0)}
        name = "band_fused" if fuse else "band_contrib"
        assert grew == {f"{name}_fwd": 1, f"{name}_bwd": 1}, grew
        outs.append([y.detach().cpu()] + [a.grad.cpu() for a in t])
    for a, b in zip(*outs):
        err = (a - b).abs().max().item()
        assert err <= 1e-4 * b.abs().max().item(), err


def _record(rng, n, deg, bw, eps, labels=None):
    """A mesh record whose targets have `deg` unique sources within ±bw,
    radii in [0, ε] and unit transports (chip_smoke.py's generator)."""
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
        labels=np.int64(0) if labels is None else labels, epsilon=eps)


def _k2_panel(rng, C, n_mesh, tb=16):
    """A joined panel table of records with degree 12-16 and features with
    ~20% origin rows, on the card."""
    tabs = [build_panel_table(_record(rng, 96, 14, 24, 0.2).table(
        1, 3, n_multiple=tb), tb=tb, compressed=True) for _ in range(n_mesh)]
    panel = concat_panel_tables(tabs).to("cuda")
    rows = n_mesh * panel.n_pad
    x = rng.normal(size=(rows, C, 2)).astype(np.float32)
    x[rng.random(rows) < 0.2] = 0.0
    return panel, torch.from_numpy(x).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("n_bins", [2, 3])
@pytest.mark.parametrize("C", [3, 12, 48])
@pytest.mark.parametrize("n_mesh", [1, 2])
def test_k2_kernel_matches_plain_on_card(n_bins, C, n_mesh):
    """K2 against its plain version on the card, over the panels of
    records with degree 12-16 at tb=16 and features with origin rows:
    tolerance 1e-4 of the grid's scale (f32 sums over a target's panels in
    another order, and FMA).  A second call is bitwise equal (one writer
    per output, no atomics)."""
    _need_card()
    rng = np.random.default_rng(C + n_bins)
    panel, x = _k2_panel(rng, C, n_mesh)
    nb = x.shape[0] // panel.tb
    before = kernels.launches["echo_panel_fwd"]
    got = tep.echo_panel_grid(x, panel.sten, panel.meta, n_bins, nb)
    torch.cuda.synchronize()
    assert kernels.launches["echo_panel_fwd"] == before + 1
    want = tep.echo_panel_grid_reference(x, panel.sten, panel.meta, n_bins,
                                         nb)
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), err
    again = tep.echo_panel_grid(x, panel.sten, panel.meta, n_bins, nb)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("n_bins", [2, 3])
@pytest.mark.parametrize("C", [3, 12, 48])
@pytest.mark.parametrize("n_mesh", [1, 2])
def test_k2_bwd_kernel_matches_plain_on_card(n_bins, C, n_mesh):
    """K2's backward against its plain version on the card, for a
    contiguous cotangent and for one in the layout autograd hands over
    (cells minor): dx to 1e-4 of its scale (f32 sums over a source's
    targets and panels in another order, and FMA after p).  A second call
    is bitwise equal (one writer per output, no atomics)."""
    _need_card()
    rng = np.random.default_rng(10 * C + n_bins)
    panel, x = _k2_panel(rng, C, n_mesh)
    nb = x.shape[0] // panel.tb
    w2 = (2 * n_bins + 1) ** 2
    dg = torch.from_numpy(rng.normal(size=(nb, 2 * w2, C, panel.tb)).astype(
        np.float32)).cuda()
    cells_minor = dg.permute(0, 3, 2, 1).contiguous().permute(0, 3, 2, 1)
    want = tep.echo_panel_grid_bwd_reference(dg, x, panel.sten, panel.meta_s,
                                             n_bins, nb)
    for g in (dg, cells_minor):
        before = kernels.launches["echo_panel_bwd"]
        got = tep.echo_panel_grid_bwd(g, x, panel.sten, panel.meta_s, n_bins,
                                      nb)
        torch.cuda.synchronize()
        assert kernels.launches["echo_panel_bwd"] == before + 1
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), err
        again = tep.echo_panel_grid_bwd(g, x, panel.sten, panel.meta_s,
                                        n_bins, nb)
        assert torch.equal(got, again)
    assert not got[(x == 0).all(-1)].any()


@pytest.mark.cuda
def test_segmentation_loss_backward_card_matches_cpu():
    """One segmentation loss backward on the mixed route (K1 and K2
    forward and backward on the card) against the same on the CPU: every
    parameter's gradient within 1e-4 of its scale (every op sums in
    another order)."""
    _need_card()
    rng = np.random.default_rng(1)
    config = dataclasses.replace(PRESETS["segmentation"], nf=8, n_des=8)
    recs = [_record(rng, 200 - 30 * i, 16, 40, 0.2,
                    labels=rng.integers(0, 4, 200 - 30 * i))
            for i in range(2)]
    net = build_model(config, 4, torch.Generator().manual_seed(0),
                      device="cpu")
    aug = draw_rotate_scale(torch.Generator().manual_seed(1), 2)
    grads = {}
    for dev in ("cpu", "cuda"):
        batch = make_batches(recs, config, 2, 32, device=dev)[0]
        net = net.to(dev)
        before = dict(kernels.launches)
        loss = make_loss_fn(net, config, 4)(batch, aug=aug)
        grads[dev] = [g.cpu() for g in torch.autograd.grad(
            loss, list(net.parameters()))]
        grew = {k: v - before.get(k, 0) for k, v in kernels.launches.items()
                if v != before.get(k, 0)}
        assert grew == ({} if dev == "cpu" else {
            "band_fused_fwd": 9, "band_fused_bwd": 9, "echo_panel_fwd": 1,
            "echo_panel_bwd": 1}), grew
    for (name, _), a, b in zip(net.named_parameters(), grads["cuda"],
                               grads["cpu"]):
        err = (a - b).abs().max().item()
        assert err <= 1e-4 * b.abs().max().item(), (name, err)


@pytest.mark.cuda
def test_segmentation_forward_card_matches_cpu():
    """One SegmentationNet forward on the mixed route (K1 and K2 on the
    card) against the same on the CPU: logits within rtol 1e-3 / atol
    1e-4 (every op sums in another order)."""
    _need_card()
    rng = np.random.default_rng(0)
    config = dataclasses.replace(PRESETS["segmentation"], nf=8, n_des=8)
    recs = [_record(rng, 200 - 30 * i, 16, 40, 0.2,
                    labels=rng.integers(0, 4, 200 - 30 * i))
            for i in range(2)]
    net = build_model(config, 4, torch.Generator().manual_seed(0),
                      device="cpu").eval()
    out = {}
    for dev in ("cpu", "cuda"):
        batch = make_batches(recs, config, 2, 32, device=dev)[0]
        assert batch.panel is not None
        with torch.no_grad():
            out[dev] = batched_apply(net.to(dev), batch).cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-3, atol=1e-4)


# the widths of the correspondence net's convs (K = 3, R = 3) and of the
# segmentation net's (K = 5, R = 6)
K5_SHAPES = pytest.mark.parametrize("C,O2,B,R", [
    (16, 64, 1, 3), (16, 24, 1, 3), (32, 32, 1, 3), (48, 96, 2, 6)])


@pytest.mark.cuda
@K5_SHAPES
@pytest.mark.parametrize("compressed,chunk", [(True, 1), (False, 1),
                                              (True, 4), (False, 4)])
def test_k5_kernel_matches_plain_on_card(C, O2, B, R, compressed, chunk):
    """K5 against its plain version on the card, over the panel table of a
    kd-ordered sphere of 1500 samples (ε-ball graph, ~13 panels per block
    at tb=32), compressed and dense planes, unchunked and chunked:
    tolerance 1e-4 of the output's scale (f32 sums over a target's panels
    and slots in another order).  A second call is bitwise equal (one
    writer per output, no atomics)."""
    _need_card()
    rng = np.random.default_rng(C + R)
    tb = 32
    table = sphere_record(rng, 1500, 4).table(B, R, n_multiple=tb)
    panel = build_panel_table(table, tb=tb, compressed=compressed,
                              chunk=chunk).to("cuda")
    M = (2 * B + 1) * 2 * C
    gen = torch.Generator(device="cuda").manual_seed(0)
    g = torch.randn(panel.n_pad, M, device="cuda", generator=gen)
    wmat = torch.randn(R, M, O2, device="cuda", generator=gen) / (R * M) ** .5
    args = (g, wmat, panel.sten, panel.meta, tb, R, B, compressed)
    before = kernels.launches["band_panel_fwd"]
    got = tbc.band_panel_fwd(*args)
    torch.cuda.synchronize()
    assert kernels.launches["band_panel_fwd"] == before + 1
    want = tbc.band_panel_fwd_reference(*args)
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), err
    assert torch.equal(got, tbc.band_panel_fwd(*args))


@pytest.mark.cuda
@K5_SHAPES
@pytest.mark.parametrize("compressed,chunk", [(True, 1), (False, 1),
                                              (True, 4), (False, 4)])
def test_k5_bwd_kernel_matches_plain_on_card(C, O2, B, R, compressed, chunk):
    """K5's backward against its plain version on the card, on the tables
    of test_k5_kernel_matches_plain_on_card: dg and dw each within 1e-4 of
    their scale (f32 sums over a source's panels and slots, and dw's over
    every target row, in another order).  A second call is bitwise equal
    (one writer per output, no atomics)."""
    _need_card()
    rng = np.random.default_rng(C + R)
    tb = 32
    table = sphere_record(rng, 1500, 4).table(B, R, n_multiple=tb)
    panel = build_panel_table(table, tb=tb, compressed=compressed,
                              chunk=chunk).to("cuda")
    M = (2 * B + 1) * 2 * C
    gen = torch.Generator(device="cuda").manual_seed(1)
    g = torch.randn(panel.n_pad, M, device="cuda", generator=gen)
    wmat = torch.randn(R, M, O2, device="cuda", generator=gen) / (R * M) ** .5
    dy = torch.randn(panel.n_pad, O2, device="cuda", generator=gen)
    args = (dy, g, wmat, panel.sten, panel.meta, panel.meta_s, tb, R, B,
            compressed)
    before = kernels.launches["band_panel_bwd"]
    dg, dw = tbc.band_panel_bwd(*args)
    torch.cuda.synchronize()
    assert kernels.launches["band_panel_bwd"] == before + 1
    want = tbc.band_panel_bwd_reference(dy, g, wmat, panel.sten,
                                        panel.meta_s, tb, R, B, compressed)
    for got, ref in zip((dg, dw), want):
        err = (got - ref).abs().max().item()
        assert err <= 1e-4 * ref.abs().max().item(), err
    dg2, dw2 = tbc.band_panel_bwd(*args)
    assert torch.equal(dg, dg2) and torch.equal(dw, dw2)


def _k5_edge_table(case, B, R, compressed, chunk, tb=32):
    """A kd-ordered sphere's panel table (CPU tensors) for one edge case
    of K5's pipelined walk: "one panel" keeps only the edges within a
    block, so that every run is one panel; "no panel" drops the panels of
    target block 1 and of source block 2, so that y's rows of block 1 and
    dg's rows of block 2 are zeros; otherwise the table as built (~13
    panels a run, more than the walk's slab stages)."""
    rng = np.random.default_rng(11)
    rec = sphere_record(rng, 1500, 4)
    if case == "one panel":
        e = rec.supp_edges
        keep = e[:, 0] // tb == e[:, 1] // tb
        rec = dataclasses.replace(rec, supp_edges=e[keep],
                                  log_mag=rec.log_mag[keep],
                                  log_ang=rec.log_ang[keep], xp=rec.xp[keep])
    panel = build_panel_table(rec.table(B, R, n_multiple=tb), tb=tb,
                              compressed=compressed, chunk=chunk)
    if case == "no panel":
        meta, meta_s = panel.meta, panel.meta_s
        keep = (meta[0] != 1) & (meta[1] != 2)
        new_id = torch.cumsum(keep.int(), 0) - 1
        keep_s = keep[meta_s[0].long()]
        meta_s = meta_s[:, keep_s].clone()
        meta_s[0] = new_id[meta_s[0].long()].int()
        panel = dataclasses.replace(panel, sten=panel.sten[keep].contiguous(),
                                    meta=meta[:, keep].contiguous(),
                                    meta_s=meta_s.contiguous())
    return panel


# K5's walk (csrc/panel_pipe.cuh): runs of one panel, runs longer than its
# slab stages, target and source blocks with no panel, a chunked table's
# all-zero panels, tiles that overhang TB (C=48 at K=3: 20 targets a tile;
# C=48 at K=5: 5; by source 20), C=16 and C=48, K=3 with R=6, bf16
# stencils and dense planes; an odd C (rows of g copied 8 bytes at a time)
# and bf16 panels of 4 × 4 slots (rows too short for bulk copies: the slab
# copied by plain loads)
K5_EDGE_CASES = pytest.mark.parametrize(
    "case,C,O2,B,R,compressed,chunk,bf16,tb", [
        ("one panel", 32, 64, 1, 3, True, 1, False, 32),
        ("one panel", 48, 96, 2, 6, True, 1, True, 32),
        ("long runs", 16, 64, 1, 3, True, 1, False, 32),
        ("long runs", 48, 96, 1, 3, True, 1, False, 32),
        ("long runs", 32, 64, 1, 6, True, 1, False, 32),
        ("long runs", 32, 64, 1, 6, True, 1, True, 32),
        ("long runs", 32, 64, 1, 6, False, 1, False, 32),
        ("long runs", 48, 96, 2, 6, False, 1, False, 32),
        ("long runs", 3, 10, 1, 2, True, 1, False, 32),
        ("long runs", 16, 24, 1, 3, True, 1, True, 4),
        ("no panel", 32, 64, 1, 3, True, 1, False, 32),
        ("no panel", 48, 96, 2, 6, True, 1, False, 32),
        ("chunk=4", 32, 64, 1, 3, True, 4, False, 32),
        ("chunk=4", 16, 24, 1, 3, True, 4, True, 32),
    ])


@pytest.mark.cuda
@K5_EDGE_CASES
def test_k5_walk_edge_cases_on_card(case, C, O2, B, R, compressed, chunk,
                                    bf16, tb):
    """K5's forward and backward on each edge case of the pipelined walk
    against their plain versions on the card: each output within 1e-4 of
    its scale (f32 sums in another order), a second call bitwise equal,
    and one launch of each counted per call."""
    _need_card()
    panel = _k5_edge_table(case, B, R, compressed, chunk, tb)
    if bf16:
        panel = _bf16(panel)
    panel = panel.to("cuda")
    tb = panel.tb
    runs = torch.bincount(panel.meta[0].long(), minlength=panel.n_pad // tb)
    if case == "one panel":
        assert int(runs.max()) == 1
    if case == "long runs":
        assert int(runs.max()) > 3
    if case == "no panel":
        assert int(runs[1]) == 0
        assert not bool((panel.meta_s[2] == 2).any())
    M = (2 * B + 1) * 2 * C
    gen = torch.Generator(device="cuda").manual_seed(3)
    g = torch.randn(panel.n_pad, M, device="cuda", generator=gen)
    wmat = torch.randn(R, M, O2, device="cuda", generator=gen) / (R * M) ** .5
    dy = torch.randn(panel.n_pad, O2, device="cuda", generator=gen)
    args = (g, wmat, panel.sten, panel.meta, tb, R, B, compressed)
    bargs = (dy, g, wmat, panel.sten, panel.meta, panel.meta_s, tb, R, B,
             compressed)
    before = dict(kernels.launches)
    y = tbc.band_panel_fwd(*args)
    torch.cuda.synchronize()
    assert kernels.launches["band_panel_fwd"] == before.get(
        "band_panel_fwd", 0) + 1
    dg, dw = tbc.band_panel_bwd(*bargs)
    torch.cuda.synchronize()
    assert kernels.launches["band_panel_bwd"] == before.get(
        "band_panel_bwd", 0) + 1
    _held((y,), (tbc.band_panel_fwd_reference(*args),), f"K5 {case}")
    _held((dg, dw), tbc.band_panel_bwd_reference(
        dy, g, wmat, panel.sten, panel.meta_s, tb, R, B, compressed),
        f"K5 bwd {case}")
    if case == "no panel":
        assert not bool(y[tb:2 * tb].any())
        assert not bool(dg[2 * tb:3 * tb].any())
    assert torch.equal(y, tbc.band_panel_fwd(*args))
    dg2, dw2 = tbc.band_panel_bwd(*bargs)
    assert torch.equal(dg, dg2) and torch.equal(dw, dw2)


@pytest.mark.cuda
def test_k5_gradient_on_card_matches_cpu():
    """A field_conv_banded backward over a PanelTable on the card goes
    through _BandPanelFn (one K5 forward and one K5 backward launch) and
    equals the same on the CPU (plain versions): grads of x and of the
    three filter tensors to 1e-4 of their scale."""
    _need_card()
    rng = np.random.default_rng(0)
    table = sphere_record(rng, 600, 4).table(1, 3, n_multiple=32)
    panel = build_panel_table(table, tb=32, compressed=True)
    x = rng.normal(size=(1, panel.n_pad, 4, 2))
    filt = [rng.normal(size=s) for s in ((3, 4, 3), (3, 4, 3, 1, 2),
                                         (3, 4, 2))]
    dy = rng.normal(size=(1, panel.n_pad, 3, 2))
    grads = {}
    for dev in ("cpu", "cuda"):
        t = [torch.tensor(a, dtype=torch.float32, device=dev,
                          requires_grad=True) for a in (x, *filt)]
        before = dict(kernels.launches)
        y = tbc.field_conv_banded(t[0], panel.to(dev), *t[1:], 1)
        y.backward(torch.tensor(dy, dtype=torch.float32, device=dev))
        grew = {k: v - before.get(k, 0) for k, v in kernels.launches.items()
                if v != before.get(k, 0)}
        assert grew == ({} if dev == "cpu" else {
            "band_panel_fwd": 1, "band_panel_bwd": 1}), grew
        grads[dev] = [a.grad.cpu() for a in t]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        err = (a - b).abs().max().item()
        assert err <= 1e-4 * b.abs().max().item(), err


@pytest.mark.cuda
def test_correspondence_pure_panel_loss_backward_card_matches_cpu():
    """One correspondence loss backward on the pure-panel layout (K5 forward
    and backward 17 times each, K2 forward and backward once, no K1) with
    an injected dropout mask, against the same on the CPU: every
    parameter's gradient within 1e-4 of its scale (every op sums in
    another order)."""
    _need_card()
    rng = np.random.default_rng(2)
    config = dataclasses.replace(PRESETS["correspondence"], nf=8, n_des=4,
                                 layout="panel")
    recs = [_record(rng, 200, 16, 40, 0.05, labels=rng.integers(0, 6, 200))]
    net = build_model(config, 6, torch.Generator().manual_seed(0),
                      device="cpu")
    aug = draw_rotate_scale(torch.Generator().manual_seed(1), 1, 45.0, None)
    grads = {}
    for dev in ("cpu", "cuda"):
        batch = make_batches(recs, config, 1, 32, device=dev)[0]
        assert batch.banded is None and batch.panel is not None
        mask = torch.from_numpy((np.random.default_rng(3).random(
            (1, batch.pos.shape[1], 256)) < 0.5).astype(np.float32))
        net = net.to(dev)
        before = dict(kernels.launches)
        loss = make_loss_fn(net, config, 6)(batch, aug=aug,
                                            dropout_mask=mask.to(dev))
        grads[dev] = [g.cpu() for g in torch.autograd.grad(
            loss, list(net.parameters()))]
        grew = {k: v - before.get(k, 0) for k, v in kernels.launches.items()
                if v != before.get(k, 0)}
        assert grew == ({} if dev == "cpu" else {
            "band_panel_fwd": 17, "band_panel_bwd": 17, "echo_panel_fwd": 1,
            "echo_panel_bwd": 1}), grew
    for (name, _), a, b in zip(net.named_parameters(), grads["cuda"],
                               grads["cpu"]):
        err = (a - b).abs().max().item()
        assert err <= 1e-4 * b.abs().max().item(), (name, err)


@pytest.mark.cuda
def test_segmentation_pure_panel_forward_card_matches_cpu():
    """One SegmentationNet forward on the pure-panel layout (K5 and K2 on
    the card, 9 and 1 launches, no K1) against the same on the CPU: logits
    within rtol 1e-3 / atol 1e-4 (every op sums in another order)."""
    _need_card()
    rng = np.random.default_rng(0)
    config = dataclasses.replace(PRESETS["segmentation"], nf=8, n_des=8,
                                 layout="panel")
    recs = [_record(rng, 200 - 30 * i, 16, 40, 0.2,
                    labels=rng.integers(0, 4, 200 - 30 * i))
            for i in range(2)]
    net = build_model(config, 4, torch.Generator().manual_seed(0),
                      device="cpu").eval()
    out = {}
    for dev in ("cpu", "cuda"):
        batch = make_batches(recs, config, 2, 32, device=dev)[0]
        assert batch.banded is None and batch.panel.n_mesh == 2
        before = dict(kernels.launches)
        with torch.no_grad():
            out[dev] = batched_apply(net.to(dev), batch).cpu()
        grew = {k: v - before.get(k, 0) for k, v in kernels.launches.items()
                if v != before.get(k, 0)}
        assert grew == ({} if dev == "cpu" else {
            "band_panel_fwd": 9, "echo_panel_fwd": 1}), grew
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-3, atol=1e-4)


# --- the compact route: K6 and K7 forward ----------------------------------------

# (target block, columns) of the compact tables: the pure-panel layout's
# TBt = 32 by TS = 128, and the mixed route's 128 × 128
COMPACT_SHAPES = pytest.mark.parametrize("tbt,ts", [(32, 128), (128, 128)])


def _compact_table(rng, B, R, tbt, ts):
    """The compact table of a kd-ordered sphere of 1500 samples (ε-ball
    graph), on the card."""
    from fieldconv_tpu_torch.precomp.banded import build_compact_panel_table

    table = sphere_record(rng, 1500, 4).table(B, R, n_multiple=128)
    return build_compact_panel_table(table, tb=tbt, ts=ts).to("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("C,O2,B,R", [(16, 24, 1, 3), (32, 64, 1, 3),
                                      (32, 64, 1, 6), (48, 96, 2, 6)])
@COMPACT_SHAPES
def test_k6_kernel_matches_plain_on_card(C, O2, B, R, tbt, ts):
    """K6 against its plain version on the card, at its three
    instantiations (K = 3 with R = 3 and R = 6, the correspondence and
    MATCHING presets' shapes, and K = 5, R = 6) and both panel shapes:
    tolerance 1e-4
    of the output's scale (f32 sums over a target's panels and slots in
    another order).  A second call is bitwise equal (one writer per output,
    no atomics).  K6's backward (dg after the fold, and dw) the same way,
    each to 1e-4 of its own scale and bitwise repeatable, at TBt 32; over
    128-row panels it raises."""
    _need_card()
    rng = np.random.default_rng(C + R + tbt)
    comp = _compact_table(rng, B, R, tbt, ts)
    M = (2 * B + 1) * 2 * C
    gen = torch.Generator(device="cuda").manual_seed(0)
    g = torch.randn(comp.n_pad, M, device="cuda", generator=gen)
    wmat = torch.randn(R, M, O2, device="cuda", generator=gen) / (R * M) ** .5
    args = (g, wmat, comp.sten, comp.meta, comp.src_idx, tbt, R, B)
    before = kernels.launches["band_compact_fwd"]
    got = tbc.band_compact_fwd(*args)
    torch.cuda.synchronize()
    assert kernels.launches["band_compact_fwd"] == before + 1
    want = tbc.band_compact_fwd_reference(*args)
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), err
    assert torch.equal(got, tbc.band_compact_fwd(*args))

    dy = torch.randn(comp.n_pad, O2, device="cuda", generator=gen)
    bargs = (dy, g, wmat, comp.sten, comp.meta, comp.src_idx,
             comp.fold_order, comp.fold_ptr, tbt, R, B)
    if tbt > 32:
        with pytest.raises(NotImplementedError, match="at most 32"):
            tbc.band_compact_bwd(*bargs)
        return
    before = kernels.launches["band_compact_bwd"]
    dg, dw = tbc.band_compact_bwd(*bargs)
    torch.cuda.synchronize()
    assert kernels.launches["band_compact_bwd"] == before + 1
    dgg, want_w = tbc.band_compact_bwd_reference(*bargs[:6], tbt, R, B)
    want_g = tcf.compact_fold_reference(dgg, comp.src_idx, comp.n_pad)
    for got_, want_ in ((dg, want_g), (dw, want_w)):
        err = (got_ - want_).abs().max().item()
        assert err <= 1e-4 * want_.abs().max().item(), err
    dg2, dw2 = tbc.band_compact_bwd(*bargs)
    assert torch.equal(dg, dg2) and torch.equal(dw, dw2)


@pytest.mark.cuda
@pytest.mark.parametrize("n_bins,C", [(2, 12), (3, 48)])
@COMPACT_SHAPES
def test_k7_kernel_matches_plain_on_card(n_bins, C, tbt, ts):
    """K7 against its plain version on the card, on both panel shapes, with
    ~20% origin rows: tolerance 1e-4 of the grid's scale (f32 sums over a
    target's panels in another order, and FMA).  A second call is bitwise
    equal.  K7's backward the same way, to 1e-4 of dx's scale (dx sums over
    a column's targets and a row's columns in another order) and bitwise
    repeatable, for a contiguous cotangent and one in the layout autograd
    hands over (cells minor)."""
    _need_card()
    rng = np.random.default_rng(C + tbt)
    comp = _compact_table(rng, 1, 3, tbt, ts)
    x = rng.normal(size=(comp.n_pad, C, 2)).astype(np.float32)
    x[rng.random(comp.n_pad) < 0.2] = 0.0
    x = torch.from_numpy(x).cuda()
    args = (x, comp.sten, comp.meta, comp.src_idx, n_bins, comp.n_pad // tbt)
    before = kernels.launches["echo_compact_fwd"]
    got = tep.echo_compact_grid(*args)
    torch.cuda.synchronize()
    assert kernels.launches["echo_compact_fwd"] == before + 1
    want = tep.echo_compact_grid_reference(*args)
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), err
    assert torch.equal(got, tep.echo_compact_grid(*args))

    gen = torch.Generator(device="cuda").manual_seed(1)
    dg = torch.randn(got.shape, device="cuda", generator=gen)
    cells_minor = dg.permute(0, 3, 2, 1).contiguous().permute(0, 3, 2, 1)
    bargs = (x, comp.sten, comp.meta, comp.src_idx, comp.fold_order,
             comp.fold_ptr, n_bins)
    want = tcf.compact_fold_reference(
        tep.echo_compact_grid_bwd_reference(dg, *args[:5]).reshape(
            -1, 2 * C), comp.src_idx, comp.n_pad).reshape(x.shape)
    for cot in (dg, cells_minor):
        before = kernels.launches["echo_compact_bwd"]
        dx = tep.echo_compact_grid_bwd(cot, *bargs)
        torch.cuda.synchronize()
        assert kernels.launches["echo_compact_bwd"] == before + 1
        err = (dx - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), err
        assert torch.equal(dx, tep.echo_compact_grid_bwd(cot, *bargs))


@pytest.mark.cuda
@pytest.mark.parametrize("W", [3, 24, 192])
def test_compact_fold_kernel_matches_plain_on_card(W):
    """The compact fold on the card against its plain version (index_add
    over every column on the CPU), for per-column values whose dead columns
    are zero, as every backward gives them: equal bit for bit (both sum a
    row's live columns in ascending column order from 0), and bitwise
    repeatable."""
    _need_card()
    rng = np.random.default_rng(W)
    comp = _compact_table(rng, 1, 3, 32, 128)
    live = (comp.sten[:, 3:5] != 0).any(1).any(1).reshape(-1)
    vals = torch.from_numpy(rng.normal(size=(live.numel(), W)).astype(
        np.float32)).cuda() * live[:, None]
    before = kernels.launches["compact_fold"]
    got = tcf.compact_fold(vals, comp.src_idx, comp.fold_order,
                           comp.fold_ptr, comp.n_pad)
    torch.cuda.synchronize()
    assert kernels.launches["compact_fold"] == before + 1
    want = tcf.compact_fold_reference(vals.cpu(), comp.src_idx.cpu(),
                                      comp.n_pad)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, tcf.compact_fold(vals, comp.src_idx,
                                             comp.fold_order, comp.fold_ptr,
                                             comp.n_pad))


@pytest.mark.cuda
@pytest.mark.parametrize("conv_impl", ["panel", "compact"])
def test_correspondence_compact_forward_card_matches_cpu(conv_impl):
    """One CorrespondenceNet forward on the pure-panel layout with the
    compact ECHO (K5 convs, or K6 with conv_impl="compact", and K7) against
    the same on the CPU: logits within rtol 1e-3 / atol 1e-4 (every op sums
    in another order), exact launches."""
    _need_card()
    rng = np.random.default_rng(1)
    config = dataclasses.replace(PRESETS["correspondence"], nf=8, n_des=8,
                                 layout="panel", echo_impl="compact",
                                 conv_impl=conv_impl)
    recs = [sphere_record(rng, 1500, 5)]
    net = build_model(config, 5, torch.Generator().manual_seed(0),
                      device="cpu").eval()
    conv = "band_compact_fwd" if conv_impl == "compact" else "band_panel_fwd"
    out = {}
    for dev in ("cpu", "cuda"):
        batch = make_batches(recs, config, 1, 128, device=dev)[0]
        assert batch.compact.tb == 32 and batch.banded is None
        before = dict(kernels.launches)
        with torch.no_grad():
            out[dev] = batched_apply(net.to(dev), batch).cpu()
        grew = {k: v - before.get(k, 0) for k, v in kernels.launches.items()
                if v != before.get(k, 0)}
        assert grew == ({} if dev == "cpu" else {
            conv: 17, "echo_compact_fwd": 1}), grew
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("conv_impl", ["panel", "compact"])
def test_correspondence_compact_loss_backward_card_matches_cpu(conv_impl):
    """One correspondence loss backward on the compact route (K7 forward
    and backward once, and K5 or, with conv_impl="compact", K6 forward and
    backward 17 times each; no K2) with an injected dropout mask, against
    the same on the CPU: every parameter's gradient within 1e-4 of its
    scale (every op sums in another order)."""
    _need_card()
    rng = np.random.default_rng(2)
    config = dataclasses.replace(PRESETS["correspondence"], nf=8, n_des=4,
                                 layout="panel", echo_impl="compact",
                                 conv_impl=conv_impl)
    recs = [_record(rng, 200, 16, 40, 0.05, labels=rng.integers(0, 6, 200))]
    net = build_model(config, 6, torch.Generator().manual_seed(0),
                      device="cpu")
    aug = draw_rotate_scale(torch.Generator().manual_seed(1), 1, 45.0, None)
    conv = "band_compact" if conv_impl == "compact" else "band_panel"
    grads = {}
    for dev in ("cpu", "cuda"):
        batch = make_batches(recs, config, 1, 32, device=dev)[0]
        assert batch.compact.tb == 32 and batch.banded is None
        mask = torch.from_numpy((np.random.default_rng(3).random(
            (1, batch.pos.shape[1], 256)) < 0.5).astype(np.float32))
        net = net.to(dev)
        before = dict(kernels.launches)
        loss = make_loss_fn(net, config, 6)(batch, aug=aug,
                                            dropout_mask=mask.to(dev))
        grads[dev] = [g.cpu() for g in torch.autograd.grad(
            loss, list(net.parameters()))]
        grew = {k: v - before.get(k, 0) for k, v in kernels.launches.items()
                if v != before.get(k, 0)}
        # the fold kernel: the last pass of each K6 and K7 backward
        folds = 18 if conv_impl == "compact" else 1
        assert grew == ({} if dev == "cpu" else {
            f"{conv}_fwd": 17, f"{conv}_bwd": 17, "echo_compact_fwd": 1,
            "echo_compact_bwd": 1, "compact_fold": folds}), grew
    for (name, _), a, b in zip(net.named_parameters(), grads["cuda"],
                               grads["cpu"]):
        err = (a - b).abs().max().item()
        assert err <= 1e-4 * b.abs().max().item(), (name, err)


# --- K8: the block-sparse banded conv ----------------------------------------

def _k8_check(tab, C, O2, seed, dense=None):
    """K8 forward and backward on ``tab`` (a BlockSparseTable on the card)
    against their plain versions (y, dg and dw each to 1e-4 of its scale:
    f32 sums in another order), one launch each, two backward calls bitwise
    equal; given ``dense`` (the BandedTable of the same EdgeTable, on the
    card), also against K1 (1e-4 of each output's scale)."""
    R, K = tab.n_rings, tab.k_width
    sten = tab.sten_band.reshape(-1, *tab.sten_band.shape[-4:])
    nbr = tab.nbr.reshape(-1, *tab.nbr.shape[-2:])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_mesh, nb = nbr.shape[:2]
    N = nb * tab.tb
    g = torch.randn(n_mesh, N, K * 2 * C, device="cuda", generator=gen)
    wmat = torch.randn(R, K * 2 * C, O2, device="cuda", generator=gen) / 40
    dy = torch.randn(n_mesh, N, O2, device="cuda", generator=gen)
    args = (tab.tb, R, K)
    before = dict(kernels.launches)
    y = tbc.band_sparse_fwd(g, wmat, sten, nbr, *args)
    dg, dw = tbc.band_sparse_bwd(dy, g, wmat, sten, nbr, tab.inv_ptr,
                                 tab.inv_bj, *args)
    torch.cuda.synchronize()
    for name in ("band_sparse_fwd", "band_sparse_bwd"):
        assert kernels.launches[name] == before.get(name, 0) + 1
    want = (tbc.band_sparse_reference(g, wmat, sten, nbr, *args),
            *tbc.band_sparse_bwd_reference(dy, g, wmat, sten, nbr, *args))
    for got, w in zip((y, dg, dw), want):
        err = (got - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item(), err
    dg2, dw2 = tbc.band_sparse_bwd(dy, g, wmat, sten, nbr, tab.inv_ptr,
                                   tab.inv_bj, *args)
    assert torch.equal(dg, dg2) and torch.equal(dw, dw2)
    if dense is not None:
        ds = dense.sten_band.reshape(-1, *dense.sten_band.shape[-4:])
        k1 = (tbc.band_fused_fwd(g, ds, wmat, dense.tb, dense.nh),
              *tbc.band_fused_bwd(dy, g, ds, wmat, dense.tb, dense.nh))
        for got, w in zip((y, dg, dw), k1):
            err = (got - w).abs().max().item()
            assert err <= 1e-4 * w.abs().max().item(), err


# the block-sparse tables of chip_smoke.py's phase 2c but 163,842: the
# 8192-sample record (K = 5, R = 6), the 4 x 2048 segmentation batch and
# the 5120-sample record at the correspondence net's four widths
K8_RECORDS = pytest.mark.parametrize("n,n_mesh,B,R,C,O2", [
    (8192, 1, 2, 6, 32, 64),
    (2048, 4, 2, 6, 48, 96),
    (5120, 1, 1, 3, 32, 64),
    (5120, 1, 1, 3, 16, 64),
    (5120, 1, 1, 3, 32, 32),
    (5120, 1, 1, 3, 16, 24),
])


@pytest.mark.cuda
@K8_RECORDS
def test_k8_kernel_matches_plain_on_card(n, n_mesh, B, R, C, O2):
    """K8 each way on the block-sparse tables of records of the serving
    sizes (sources within ±128, so NJ ≤ 3) against its plain versions and
    against K1 on the dense band of the same EdgeTable."""
    _need_card()
    rng = np.random.default_rng(n + C + O2)
    tabs = [_record(rng, n, 100, 128, 0.05).table(B, R)
            for _ in range(n_mesh)]
    sps = [build_block_sparse_banded(t, tb=128) for t in tabs]
    bands = [build_banded_table(t, tb=128) for t in tabs]
    assert {sp.nj for sp in sps} == {3} and {b.nh for b in bands} == {1}
    dense = BandedTable(torch.stack([b.sten_band for b in bands]).cuda(),
                        tb=128, nh=1, n_pad=bands[0].n_pad, band_limit=B,
                        n_rings=R)
    _k8_check(stack_block_sparse_tables(sps).to("cuda"), C, O2, seed=n,
              dense=dense)


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,C,O2", [(2, 6, 32, 60), (1, 3, 16, 24)])
def test_k8_kernel_on_shuffled_lists_on_card(B, R, C, O2):
    """K8 each way on random tables whose nbr rows are shuffled, repeat no
    block and include padding entries (two meshes, tb = 128)."""
    _need_card()
    tab = random_block_sparse(np.random.default_rng(C), 2, 10, 6, R, B, 128)
    _k8_check(tab.to("cuda"), C, O2, seed=C)


# --- bf16 panel stencils (cast_panel_sten): K5, K6, K2, K7 ---------------------

BF16_CONV_SHAPES = pytest.mark.parametrize("C,O2,B,R", [(16, 24, 1, 3),
                                                        (48, 96, 2, 6)])


def _bf16(table):
    from fieldconv_tpu_torch.precomp.banded import cast_panel_sten

    out = cast_panel_sten(table)
    assert out.sten.dtype == torch.bfloat16
    return out


def _held(got, want, label):
    """Each of ``got`` within 1e-4 of its plain version's scale (f32 sums
    in another order over the same bf16 values, read exactly as f32)."""
    for a, b in zip(got, want):
        err = (a - b).abs().max().item()
        assert err <= 1e-4 * b.abs().max().item(), (label, err)


@pytest.mark.cuda
@BF16_CONV_SHAPES
def test_k5_bf16_kernel_matches_plain_on_card(C, O2, B, R):
    """K5 forward and backward on a bf16 compressed panel table against
    their plain versions on the card (which cast each chunk to f32 on
    read): within 1e-4 of each output's scale, and bitwise repeatable."""
    _need_card()
    rng = np.random.default_rng(C + R + 5)
    tb = 32
    table = sphere_record(rng, 1500, 4).table(B, R, n_multiple=tb)
    panel = _bf16(build_panel_table(table, tb=tb, compressed=True)).to("cuda")
    assert panel.sten.dtype == torch.bfloat16
    M = (2 * B + 1) * 2 * C
    gen = torch.Generator(device="cuda").manual_seed(0)
    g = torch.randn(panel.n_pad, M, device="cuda", generator=gen)
    wmat = torch.randn(R, M, O2, device="cuda", generator=gen) / (R * M) ** .5
    dy = torch.randn(panel.n_pad, O2, device="cuda", generator=gen)
    args = (g, wmat, panel.sten, panel.meta, tb, R, B, True)
    before = dict(kernels.launches)
    y = tbc.band_panel_fwd(*args)
    bargs = (dy, g, wmat, panel.sten, panel.meta, panel.meta_s, tb, R, B,
             True)
    dg, dw = tbc.band_panel_bwd(*bargs)
    torch.cuda.synchronize()
    assert kernels.launches["band_panel_fwd"] == before.get(
        "band_panel_fwd", 0) + 1
    assert kernels.launches["band_panel_bwd"] == before.get(
        "band_panel_bwd", 0) + 1
    _held((y,), (tbc.band_panel_fwd_reference(*args),), "K5")
    _held((dg, dw), tbc.band_panel_bwd_reference(
        dy, g, wmat, panel.sten, panel.meta_s, tb, R, B, True), "K5 bwd")
    assert torch.equal(y, tbc.band_panel_fwd(*args))
    dg2, dw2 = tbc.band_panel_bwd(*bargs)
    assert torch.equal(dg, dg2) and torch.equal(dw, dw2)


@pytest.mark.cuda
@pytest.mark.parametrize("C,O2,B,R", [(16, 24, 1, 3), (32, 64, 1, 6),
                                      (48, 96, 2, 6)])
def test_k6_bf16_kernel_matches_plain_on_card(C, O2, B, R):
    """K6 forward and backward (TBt 32) on a bf16 compact table against
    their plain versions and the plain fold on the card: within 1e-4 of
    each output's scale, and bitwise repeatable."""
    _need_card()
    rng = np.random.default_rng(C + R + 6)
    comp = _bf16(_compact_table(rng, B, R, 32, 128))
    M = (2 * B + 1) * 2 * C
    gen = torch.Generator(device="cuda").manual_seed(0)
    g = torch.randn(comp.n_pad, M, device="cuda", generator=gen)
    wmat = torch.randn(R, M, O2, device="cuda", generator=gen) / (R * M) ** .5
    dy = torch.randn(comp.n_pad, O2, device="cuda", generator=gen)
    args = (g, wmat, comp.sten, comp.meta, comp.src_idx, 32, R, B)
    bargs = (dy, g, wmat, comp.sten, comp.meta, comp.src_idx,
             comp.fold_order, comp.fold_ptr, 32, R, B)
    y = tbc.band_compact_fwd(*args)
    dg, dw = tbc.band_compact_bwd(*bargs)
    torch.cuda.synchronize()
    _held((y,), (tbc.band_compact_fwd_reference(*args),), "K6")
    dgg, want_w = tbc.band_compact_bwd_reference(*bargs[:6], 32, R, B)
    _held((dg, dw), (tcf.compact_fold_reference(dgg, comp.src_idx,
                                                 comp.n_pad), want_w),
          "K6 bwd")
    assert torch.equal(y, tbc.band_compact_fwd(*args))
    dg2, dw2 = tbc.band_compact_bwd(*bargs)
    assert torch.equal(dg, dg2) and torch.equal(dw, dw2)


def _k6_edge_tables(case, B, R, tbt, ts):
    """(the kernels' table, the plain versions' table), CPU tensors, for one
    edge case of K6's walks, from a kd-ordered sphere's compact table:
    "one panel" keeps only the edges within a target block, so that every
    run is one panel; "long runs" (TS below a block's distinct sources)
    gives runs longer than the walk's slab stages; "no panel" drops the
    panels of target block 1, so that its rows of y are zeros (the fold
    index rebuilt for the panels kept); "dead columns" has every dead
    column and every 7th live one read a row outside [0, n_g) in the
    kernels' table, and those live columns emptied (r = R_SENTINEL, out of
    the fold index) in the plain versions' one, so that the two compute
    the same function; otherwise the table as built."""
    from fieldconv_tpu_torch.precomp.banded import (R_SENTINEL,
                                                    build_compact_panel_table,
                                                    fold_index)

    rng = np.random.default_rng(13)
    rec = sphere_record(rng, 1500, 4)
    if case == "one panel":
        e = rec.supp_edges
        keep = e[:, 0] // tbt == e[:, 1] // tbt
        rec = dataclasses.replace(rec, supp_edges=e[keep],
                                  log_mag=rec.log_mag[keep],
                                  log_ang=rec.log_ang[keep], xp=rec.xp[keep])
    comp = build_compact_panel_table(rec.table(B, R, n_multiple=128),
                                     tb=tbt, ts=ts)

    def refold(table, live):
        cols = np.flatnonzero(live.reshape(-1).numpy())
        order, ptr = fold_index(
            cols, table.src_idx.reshape(-1).numpy()[cols], table.n_pad)
        return dataclasses.replace(table, fold_order=order, fold_ptr=ptr)

    if case == "no panel":
        keep = comp.meta[0] != 1
        meta = comp.meta[:, keep].clone()
        meta[1] = torch.arange(meta.shape[1], dtype=torch.int32)
        comp = dataclasses.replace(
            comp, sten=comp.sten[keep].contiguous(), meta=meta.contiguous(),
            src_idx=comp.src_idx[keep].contiguous())
        comp = refold(comp, (comp.sten[:, 0] != R_SENTINEL).any(1))
    if case != "dead columns":
        return comp, comp
    live = (comp.sten[:, 0] != R_SENTINEL).any(1)            # (P, TS)
    cut = torch.zeros(live.numel(), dtype=torch.bool)
    cut[torch.nonzero(live.reshape(-1))[::7, 0]] = True
    cut = cut.reshape(live.shape)
    src = comp.src_idx.clone()
    src[~live] = comp.n_pad + 5
    src[cut] = torch.where(torch.arange(int(cut.sum())) % 2 == 0,
                           comp.n_pad, -1).int()
    sten = comp.sten.clone()
    sten[:, 0].masked_fill_(cut[:, None, :], R_SENTINEL)
    plain = refold(dataclasses.replace(comp, sten=sten), live & ~cut)
    return dataclasses.replace(plain, sten=comp.sten, src_idx=src), plain


# K6's walks (csrc/panel_pipe.cuh by target, band_compact_bwd.cu's dG):
# runs of one panel and runs longer than the slab stages, a target block
# with no panel, dead columns reading rows outside [0, n_g), TS not a
# multiple of 32 (bf16 rows of 36 slots too short for bulk copies), TBt 16,
# 32 and 128 (the backward takes TBt ≤ 32 and raises above), C = 3, 16, 32
# and 48, K = 3 with R = 2, 3 and 6 and K = 5 with R = 6, f32 and bf16
K6_EDGE_CASES = pytest.mark.parametrize("case,C,O2,B,R,tbt,ts,bf16", [
    ("one panel", 32, 64, 1, 3, 32, 128, False),
    ("one panel", 48, 96, 2, 6, 32, 128, True),
    ("long runs", 16, 64, 1, 3, 32, 40, False),
    ("long runs", 32, 64, 1, 6, 32, 40, True),
    ("long runs", 3, 10, 1, 2, 16, 36, True),
    ("long runs", 48, 96, 2, 6, 16, 64, False),
    ("no panel", 32, 64, 1, 3, 32, 128, False),
    ("no panel", 48, 96, 2, 6, 32, 128, True),
    ("dead columns", 32, 64, 1, 3, 32, 128, False),
    ("dead columns", 16, 24, 1, 6, 32, 100, True),
    ("as built", 32, 64, 1, 6, 128, 128, False),
    ("as built", 48, 96, 2, 6, 128, 128, True),
    ("as built", 3, 10, 1, 3, 128, 40, False),
    ("as built", 16, 24, 1, 3, 16, 128, False),
])


@pytest.mark.cuda
@K6_EDGE_CASES
def test_k6_walk_edge_cases_on_card(case, C, O2, B, R, tbt, ts, bf16):
    """K6's forward and backward (dg after the fold, and dw) on each edge
    case of its walks against their plain versions on the card: each
    output within 1e-4 of its scale (f32 sums in another order), a second
    call bitwise equal, and exactly one launch of each counted per call;
    over panels of more than 32 target rows the backward raises."""
    _need_card()
    comp, plain = _k6_edge_tables(case, B, R, tbt, ts)
    if bf16:
        comp, plain = _bf16(comp), _bf16(plain)
    comp, plain = comp.to("cuda"), plain.to("cuda")
    runs = torch.bincount(comp.meta[0].long(),
                          minlength=comp.n_pad // tbt)
    if case == "one panel":
        assert int(runs.max()) == 1
    if case == "long runs":
        assert int(runs.max()) > 3
    if case == "no panel":
        assert int(runs[1]) == 0
    if case == "dead columns":
        bad = (comp.src_idx < 0) | (comp.src_idx >= comp.n_pad)
        assert bool((bad & (comp.sten[:, 0] < 2).any(1)).any())
    M = (2 * B + 1) * 2 * C
    gen = torch.Generator(device="cuda").manual_seed(4)
    g = torch.randn(comp.n_pad, M, device="cuda", generator=gen)
    wmat = torch.randn(R, M, O2, device="cuda", generator=gen) / (R * M) ** .5
    dy = torch.randn(comp.n_pad, O2, device="cuda", generator=gen)
    args = (g, wmat, comp.sten, comp.meta, comp.src_idx, tbt, R, B)
    before = dict(kernels.launches)
    y = tbc.band_compact_fwd(*args)
    torch.cuda.synchronize()
    assert kernels.launches["band_compact_fwd"] == before.get(
        "band_compact_fwd", 0) + 1
    _held((y,), (tbc.band_compact_fwd_reference(
        g, wmat, plain.sten, plain.meta, plain.src_idx, tbt, R, B),),
        f"K6 {case}")
    if case == "no panel":
        assert not bool(y[tbt:2 * tbt].any())
    assert torch.equal(y, tbc.band_compact_fwd(*args))
    bargs = (dy, g, wmat, comp.sten, comp.meta, comp.src_idx,
             comp.fold_order, comp.fold_ptr, tbt, R, B)
    if tbt > 32:
        with pytest.raises(NotImplementedError, match="at most 32"):
            tbc.band_compact_bwd(*bargs)
        return
    before = dict(kernels.launches)
    dg, dw = tbc.band_compact_bwd(*bargs)
    torch.cuda.synchronize()
    for name in ("band_compact_bwd", "compact_fold"):
        assert kernels.launches[name] == before.get(name, 0) + 1, name
    dgg, want_w = tbc.band_compact_bwd_reference(
        dy, g, wmat, plain.sten, plain.meta, plain.src_idx, tbt, R, B)
    _held((dg, dw), (tcf.compact_fold_reference(dgg, plain.src_idx,
                                                 plain.n_pad), want_w),
          f"K6 bwd {case}")
    dg2, dw2 = tbc.band_compact_bwd(*bargs)
    assert torch.equal(dg, dg2) and torch.equal(dw, dw2)


def _echo_bf16_check(fwd, fwd_ref, bwd, bwd_ref, x, nb_shape):
    """An ECHO kernel pair on bf16 stencils: the forward against its plain
    version, the backward for a contiguous and a cells-minor cotangent,
    each within 1e-4 of its scale and bitwise repeatable."""
    got = fwd()
    torch.cuda.synchronize()
    _held((got,), (fwd_ref(),), "forward")
    assert torch.equal(got, fwd())
    gen = torch.Generator(device="cuda").manual_seed(1)
    dg = torch.randn(got.shape, device="cuda", generator=gen)
    want = bwd_ref(dg)
    for cot in (dg, dg.permute(0, 3, 2, 1).contiguous().permute(0, 3, 2, 1)):
        dx = bwd(cot)
        torch.cuda.synchronize()
        _held((dx,), (want,), "backward")
        assert torch.equal(dx, bwd(cot))


@pytest.mark.cuda
@pytest.mark.parametrize("n_bins,C", [(2, 12), (3, 48)])
def test_k2_bf16_kernel_matches_plain_on_card(n_bins, C):
    """K2 forward and backward on a bf16 panel table of two meshes against
    their plain versions on the card (both form p from the same f32
    values): within 1e-4 of the scale, bitwise repeatable."""
    _need_card()
    rng = np.random.default_rng(C + n_bins + 2)
    panel, x = _k2_panel(rng, C, 2)
    panel = _bf16(panel)
    nb = x.shape[0] // panel.tb
    before = dict(kernels.launches)
    _echo_bf16_check(
        lambda: tep.echo_panel_grid(x, panel.sten, panel.meta, n_bins, nb),
        lambda: tep.echo_panel_grid_reference(x, panel.sten, panel.meta,
                                              n_bins, nb),
        lambda dg: tep.echo_panel_grid_bwd(dg, x, panel.sten, panel.meta_s,
                                           n_bins, nb),
        lambda dg: tep.echo_panel_grid_bwd_reference(
            dg, x, panel.sten, panel.meta_s, n_bins, nb), x, nb)
    assert kernels.launches["echo_panel_fwd"] > before.get(
        "echo_panel_fwd", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_bins,C", [(2, 12), (3, 48)])
def test_k7_bf16_kernel_matches_plain_on_card(n_bins, C):
    """K7 forward and backward (with the fold) on a bf16 compact table
    (TBt 32) against their plain versions on the card: within 1e-4 of the
    scale, bitwise repeatable."""
    _need_card()
    rng = np.random.default_rng(C + n_bins + 7)
    comp = _bf16(_compact_table(rng, 1, 3, 32, 128))
    x = rng.normal(size=(comp.n_pad, C, 2)).astype(np.float32)
    x[rng.random(comp.n_pad) < 0.2] = 0.0
    x = torch.from_numpy(x).cuda()
    args = (x, comp.sten, comp.meta, comp.src_idx, n_bins, comp.n_pad // 32)
    bargs = (x, comp.sten, comp.meta, comp.src_idx, comp.fold_order,
             comp.fold_ptr, n_bins)
    _echo_bf16_check(
        lambda: tep.echo_compact_grid(*args),
        lambda: tep.echo_compact_grid_reference(*args),
        lambda dg: tep.echo_compact_grid_bwd(dg, *bargs),
        lambda dg: tcf.compact_fold_reference(
            tep.echo_compact_grid_bwd_reference(dg, *args[:5]).reshape(
                -1, 2 * C), comp.src_idx, comp.n_pad).reshape(x.shape),
        x, None)


@pytest.mark.cuda
@pytest.mark.parametrize("echo_impl", ["panel", "compact"])
def test_predictor_logits_bf16_card_matches_cpu(echo_impl):
    """Predictor.logits of a correspondence net on the pure-panel layout
    whose tables were cast to bf16 (block panels for K5, and K2 or the
    compact table for K7) against the same Predictor on the CPU on the same
    cast tables: within rtol 1e-3 / atol 1e-4, exact launches."""
    _need_card()
    from fieldconv_tpu_torch.deploy import Predictor
    from fieldconv_tpu_torch.scripts.train_100k import cast_batch

    rng = np.random.default_rng(4)
    config = dataclasses.replace(PRESETS["correspondence"], nf=8, n_des=8,
                                 layout="panel", echo_impl=echo_impl)
    recs = [sphere_record(rng, 1500, 5)]
    net = build_model(config, 5, torch.Generator().manual_seed(0),
                      device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        p = Predictor(net, config, banded_tb=128, device=dev)
        batch = cast_batch(p.make_batches(recs)[0])
        before = dict(kernels.launches)
        out[dev] = p.logits(batch).cpu()
        grew = {k: v - before.get(k, 0) for k, v in kernels.launches.items()
                if v != before.get(k, 0)}
        echo = "echo_compact_fwd" if echo_impl == "compact" else \
            "echo_panel_fwd"
        assert grew == ({} if dev == "cpu" else {
            "band_panel_fwd": 17, echo: 1}), grew
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
def test_pure_panel_loss_gradient_repeats_on_card():
    """The pure-panel route's loss gradient (K5, K2 and the panel lift,
    whose sums run in a fixed order each way) is bitwise equal across two
    runs on the card."""
    _need_card()
    rng = np.random.default_rng(2)
    config = dataclasses.replace(PRESETS["correspondence"], nf=8, n_des=4,
                                 layout="panel")
    recs = [_record(rng, 200, 16, 40, 0.05, labels=rng.integers(0, 6, 200))]
    net = build_model(config, 6, torch.Generator().manual_seed(0),
                      device="cuda")
    aug = tuple(None if a is None else a.cuda() for a in draw_rotate_scale(
        torch.Generator().manual_seed(1), 1, 45.0, None))
    batch = make_batches(recs, config, 1, 32, device="cuda")[0]
    mask = torch.from_numpy((np.random.default_rng(3).random(
        (1, batch.pos.shape[1], 256)) < 0.5).astype(np.float32)).cuda()
    runs = [torch.autograd.grad(make_loss_fn(net, config, 6)(
        batch, aug=aug, dropout_mask=mask), list(net.parameters()))
        for _ in range(2)]
    for (name, _), a, b in zip(net.named_parameters(), *runs):
        assert torch.equal(a, b), name


def _k9_ranges(nb, nh):
    """K9's launches over a shard of nb blocks: (what, blk_off, lo, hi,
    source blocks) of the serial path, and of the overlapped one's
    interior, head and tail where nb > 2·nh."""
    out = [("serial", 0, 0, nb, nb + 2 * nh)]
    if nb > 2 * nh:
        out += [("interior", -nh, nh, nb - nh, nb),
                ("head", 0, 0, nh, 3 * nh),
                ("tail", nh - nb, nb - nh, nb, 3 * nh)]
    return out


# K9's walk (csrc/band_pipe.cuh on the launch's range): every range of a
# shard with several meshes, K = 1, K = 3 with R = 6, K = 5 with R = 3-5
# (slots narrower than the instantiation's), shards of nb ≤ 2nh blocks
# (serial only: nb = 3 with nh = 2, nb = 2 with nh = 1), TB = 256 (two
# virtual blocks of 128), C = 1
@pytest.mark.cuda
@pytest.mark.parametrize("C,O,R,B,tb,nh,n_mesh,nb", [
    (3, 5, 2, 1, 8, 1, 1, 4),
    (4, 30, 6, 2, 8, 2, 3, 3),
    (48, 48, 6, 2, 16, 1, 2, 4),
    (32, 32, 3, 1, 16, 2, 1, 5),
    (16, 12, 3, 0, 16, 1, 2, 4),
    (32, 32, 6, 1, 16, 1, 3, 5),
    (32, 32, 3, 2, 16, 1, 2, 4),
    (16, 24, 4, 2, 8, 2, 2, 5),
    (48, 48, 5, 2, 16, 1, 3, 3),
    (32, 64, 6, 2, 16, 1, 2, 2),
    (8, 16, 3, 1, 256, 1, 2, 3),
    (1, 4, 6, 1, 16, 1, 1, 4),
])
def test_k9_kernels_match_plain_on_card(C, O, R, B, tb, nh, n_mesh, nb):
    """K9 (parallel/halo.py) each way over every range a shard launches,
    serial and overlapped, against its plain version on the card (1e-4 of
    each output's scale): the forward writes only its range's rows of y,
    the backward gives dG of every source row and dW, bitwise equal across
    two calls; the contrib each way over the serial range the same way."""
    from fieldconv_tpu_torch.parallel import halo

    _need_card()
    K = 2 * B + 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    sten = torch.randn(n_mesh, nb, R + 2 * K, tb, (2 * nh + 1) * tb,
                       device=dev, generator=gen)
    wmat = torch.randn(R, K * 2 * C, 2 * O, device=dev, generator=gen)

    def close(got, want):
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), err

    for what, off, lo, hi, n_src in _k9_ranges(nb, nh):
        g = torch.randn(n_mesh, n_src * tb, K * 2 * C, device=dev,
                        generator=gen)
        dy = torch.randn(n_mesh, (hi - lo) * tb, 2 * O, device=dev,
                         generator=gen)
        args = (tb, nh, off, lo, hi)
        before = dict(kernels.launches)
        y = halo.halo_fused_fwd(g, sten, wmat, *args)
        dg, dw = halo.halo_fused_bwd(dy, g, sten, wmat, *args)
        torch.cuda.synchronize()
        for name in ("halo_fused_fwd", "halo_fused_bwd"):
            assert kernels.launches[name] == before.get(name, 0) + 1, what
        close(y[:, lo * tb:hi * tb],
              halo.halo_fused_fwd_reference(g, sten, wmat, *args))
        assert not y[:, :lo * tb].any() and not y[:, hi * tb:].any(), what
        want_dg, want_dw = halo.halo_fused_bwd_reference(dy, g, sten, wmat,
                                                         *args)
        close(dg, want_dg)
        close(dw, want_dw)
        again = halo.halo_fused_bwd(dy, g, sten, wmat, *args)
        assert torch.equal(dg, again[0]) and torch.equal(dw, again[1]), what
        if what == "serial":
            cargs = (tb, nh, R, K, off, lo, hi)
            out = halo.halo_contrib_fwd(g, sten, *cargs)
            close(out, halo.halo_contrib_reference(g, sten, *cargs))
            dout = torch.randn(out.shape, device=dev, generator=gen)
            bargs = (tb, nh, R, K, g.shape[1], off, lo, hi)
            dgc = halo.halo_contrib_bwd(dout, sten, *bargs)
            close(dgc, halo.halo_contrib_bwd_reference(dout, sten, *bargs))
            assert torch.equal(dgc, halo.halo_contrib_bwd(dout, sten, *bargs))


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,tb,nh,nb,n_src,blk_off,lo,hi", [
    (2, 6, 16, 1, 4, 8, 1, 0, 4),
    (1, 3, 16, 2, 5, 12, 2, 1, 4),
    (0, 3, 8, 1, 4, 7, -1, 2, 4),
])
def test_k9_unread_source_rows_get_zero_dg_on_card(B, R, tb, nh, nb, n_src,
                                                   blk_off, lo, hi):
    """K9 over a source array (two meshes) with blocks that no window of the
    range reads: dG there is exactly zero, every other row within 1e-4 of
    the plain version's scale, y outside the range untouched."""
    from fieldconv_tpu_torch.parallel import halo

    _need_card()
    C, O2, n_mesh, K = 16, 24, 2, 2 * B + 1
    gen = torch.Generator(device="cuda").manual_seed(4)
    dev = torch.device("cuda")
    sten = torch.randn(n_mesh, nb, R + 2 * K, tb, (2 * nh + 1) * tb,
                       device=dev, generator=gen)
    wmat = torch.randn(R, K * 2 * C, O2, device=dev, generator=gen)
    g = torch.randn(n_mesh, n_src * tb, K * 2 * C, device=dev, generator=gen)
    dy = torch.randn(n_mesh, (hi - lo) * tb, O2, device=dev, generator=gen)
    args = (tb, nh, blk_off, lo, hi)
    read = range(max(0, lo + blk_off), min(n_src, hi + blk_off + 2 * nh))
    assert len(read) < n_src
    y = halo.halo_fused_fwd(g, sten, wmat, *args,
                            out=torch.full((n_mesh, nb * tb, O2), 7.0,
                                           device=dev))
    dg, dw = halo.halo_fused_bwd(dy, g, sten, wmat, *args)
    torch.cuda.synchronize()
    assert bool((y[:, :lo * tb] == 7.0).all())
    assert bool((y[:, hi * tb:] == 7.0).all())
    _held((y[:, lo * tb:hi * tb],),
          (halo.halo_fused_fwd_reference(g, sten, wmat, *args),), "K9")
    _held((dg, dw), halo.halo_fused_bwd_reference(dy, g, sten, wmat, *args),
          "K9 bwd")
    for s in range(n_src):
        if s not in read:
            assert not bool(dg[:, s * tb:(s + 1) * tb].any()), s


def _rewindow(sten, tb, nh, nh2):
    """The band stencil (…, nb, P, TB, W') of window ±nh laid out with
    window ±nh2: zero panels added at both ends, or (nh2 < nh) the outer
    panels cut, which must hold no slot."""
    if nh2 >= nh:
        pad = (nh2 - nh) * tb
        return torch.nn.functional.pad(sten, (pad, pad))
    cut = (nh - nh2) * tb
    assert not sten[..., :cut].any() and not sten[..., -cut:].any()
    return sten[..., cut:sten.shape[-1] - cut].contiguous()


def _k1_edge_band(case, B, R, tb, nh, n_mesh, n):
    """(n_mesh, nb, R+2K, tb, W') band stencil from the port's builder
    (build_banded_table) for one edge case of K1's walk, each mesh a
    synthetic record of n samples, degrees 8-16 within about nh·tb (at
    least 16), laid
    out at window ±nh: "no edges in a block" drops every edge to or from
    block 1; "last panel only" keeps in block 1 one slot, in row tb − 1 of
    its last panel; "past both ends" fills every slot whose source lies
    outside [0, n) with random values; "within blocks" keeps the edges
    inside a block."""
    rng = np.random.default_rng(17)
    gen = torch.Generator().manual_seed(5)
    bands = []
    for i in range(n_mesh):
        rec = synthetic_record(rng, n, 8, 16, max(16, nh * tb - tb // 4),
                               0.1, f"edge{i}", 0)
        e = rec.supp_edges
        keep = np.ones(len(e), bool)
        if case == "no edges in a block":
            keep = (e[:, 0] // tb != 1) & (e[:, 1] // tb != 1)
        if case == "within blocks":
            keep = e[:, 0] // tb == e[:, 1] // tb
        rec = dataclasses.replace(rec, supp_edges=e[keep],
                                  log_mag=rec.log_mag[keep],
                                  log_ang=rec.log_ang[keep], xp=rec.xp[keep])
        band = build_banded_table(rec.table(B, R, n_pad=n, n_multiple=tb),
                                  tb=tb, max_nh=max(nh, 1))
        bands.append(_rewindow(band.sten_band, tb, band.nh, nh))
    sten = torch.stack(bands)
    nb = n // tb
    if case == "last panel only":
        sten[:, 1] = 0
        sten[:, 1, :, tb - 1, 2 * nh * tb + 5] = torch.rand(
            n_mesh, sten.shape[2], generator=gen) + 0.5
    if case == "past both ends":
        for b in range(nb):
            for j in range(2 * nh + 1):
                if not 0 <= b - nh + j < nb:
                    sten[:, b, ..., j * tb:(j + 1) * tb] = torch.randn(
                        sten[:, b, ..., j * tb:(j + 1) * tb].shape,
                        generator=gen)
    return sten.contiguous()


# K1's walk (csrc/band_pipe.cuh on panel_pipe.cuh): a block with no edges,
# a tile whose one occupied slot lies in its last panel, windows past both
# ends holding nonzero values, nh = 0 and 4, TB = 8, 48, 128 and 256 (two
# virtual blocks of 128), R = 6 and 8 at K = 3, C = 1, 3, 48 and 256, three
# meshes; K = 3 runs the warp-specialized walk, K = 5 the other.  Also the
# shapes whose slots are narrower than their instantiation's: K = 5 with R
# = 3, 4 and 5 (the contrib walk's and dG's word-by-word reads, dc laid out
# after the rest of the scratch) and K = 1 with R = 3, 6 and 8
K1_EDGE_CASES = pytest.mark.parametrize(
    "case,C,O2,B,R,tb,nh,n_mesh,n", [
        ("no edges in a block", 32, 64, 2, 6, 128, 1, 1, 512),
        ("no edges in a block", 32, 64, 1, 3, 48, 2, 1, 288),
        ("last panel only", 32, 64, 1, 3, 48, 2, 1, 288),
        ("last panel only", 48, 96, 2, 6, 128, 1, 1, 512),
        ("past both ends", 32, 64, 2, 6, 128, 1, 2, 384),
        ("past both ends", 32, 64, 1, 3, 8, 2, 3, 64),
        ("within blocks", 16, 24, 1, 3, 48, 0, 1, 192),
        ("as built", 32, 64, 1, 3, 48, 4, 1, 480),
        ("past both ends", 32, 64, 2, 6, 256, 1, 1, 1024),
        ("as built", 3, 10, 1, 3, 256, 2, 2, 1280),
        ("as built", 32, 64, 1, 8, 48, 1, 3, 192),
        ("as built", 16, 24, 1, 6, 48, 1, 1, 192),
        ("as built", 1, 4, 1, 3, 16, 1, 1, 64),
        ("past both ends", 3, 10, 2, 6, 16, 1, 1, 64),
        ("as built", 48, 96, 1, 3, 48, 1, 1, 192),
        ("as built", 256, 16, 2, 6, 16, 1, 1, 64),
        ("past both ends", 256, 16, 1, 8, 16, 1, 1, 64),
        ("as built", 32, 64, 2, 3, 128, 1, 1, 512),
        ("past both ends", 32, 64, 2, 4, 16, 1, 2, 64),
        ("as built", 48, 96, 2, 5, 48, 1, 1, 192),
        ("as built", 32, 64, 0, 3, 48, 1, 1, 192),
        ("past both ends", 16, 24, 0, 6, 16, 2, 1, 64),
        ("as built", 3, 10, 0, 8, 16, 1, 1, 64),
    ])


@pytest.mark.cuda
@K1_EDGE_CASES
def test_k1_walk_edge_cases_on_card(case, C, O2, B, R, tb, nh, n_mesh, n):
    """K1's forward and backward on each edge case of its panel walk
    against their plain versions on the card: each output within 1e-4 of
    its scale (f32 sums in another order), a second call bitwise equal,
    and one launch of each counted per call."""
    _need_card()
    sten = _k1_edge_band(case, B, R, tb, nh, n_mesh, n).to("cuda")
    K = 2 * B + 1
    M = K * 2 * C
    gen = torch.Generator(device="cuda").manual_seed(3)
    g = torch.randn(n_mesh, n, M, device="cuda", generator=gen)
    wmat = torch.randn(R, M, O2, device="cuda", generator=gen) / (R * M) ** .5
    dy = torch.randn(n_mesh, n, O2, device="cuda", generator=gen)
    before = dict(kernels.launches)
    y = tbc.band_fused_fwd(g, sten, wmat, tb, nh)
    torch.cuda.synchronize()
    dg, dw = tbc.band_fused_bwd(dy, g, sten, wmat, tb, nh)
    torch.cuda.synchronize()
    for name in ("band_fused_fwd", "band_fused_bwd"):
        assert kernels.launches[name] == before.get(name, 0) + 1, name
    _held((y,), (tbc.band_fused_fwd_reference(g, sten, wmat, tb, nh),),
          f"K1 {case}")
    _held((dg, dw), tbc.band_fused_bwd_reference(dy, g, sten, wmat, tb, nh),
          f"K1 bwd {case}")
    if case == "no edges in a block":
        assert not bool(y[:, tb:2 * tb].any())
        assert not bool(dg[:, tb:2 * tb].any())
    if case == "last panel only":
        assert not bool(y[:, tb:2 * tb - 1].any())
        assert bool(y[:, 2 * tb - 1].any())
    assert torch.equal(y, tbc.band_fused_fwd(g, sten, wmat, tb, nh))
    dg2, dw2 = tbc.band_fused_bwd(dy, g, sten, wmat, tb, nh)
    assert torch.equal(dg, dg2) and torch.equal(dw, dw2)
