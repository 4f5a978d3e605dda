"""Rank functions of the port's graph-parallel tests, run by
fieldconv_tpu_torch/parallel/distributed.py::spawn in child processes.

Not a test module: a child imports it to find its function, and it
imports nothing of JAX, so a child starts in torch's time alone.
"""

import torch

from fieldconv_tpu_torch import kernels
from fieldconv_tpu_torch.parallel import halo
from fieldconv_tpu_torch.parallel.distributed import make_layout
from fieldconv_tpu_torch.parallel.gp import (make_gp_train_step,
                                             make_gp_value_and_grad,
                                             place_gp_batch)
from fieldconv_tpu_torch.parallel.sharding import replicate
from fieldconv_tpu_torch.train.loop import build_model
from fieldconv_tpu_torch.train.trainer import make_optimizer


def ring(rank, world, g, h, u, hw):
    """exchange_halos and return_halos over a graph axis of ``world``
    ranks: this rank's rows g[rank] (n, F), halo cotangents h[rank] (2, hw,
    F) and local cotangent u[rank].  Returns the exchanged rows, the
    returned rows of (h_left | 0 | h_right), this rank's terms of the
    adjoint pair (<exchange(g), h> and <g, return(h)>), the gradient that
    autograd gives g through the exchange and the one it gives (h_left |
    u | h_right) through the return."""
    layout = make_layout(1, world)
    g_loc = g[rank].clone().requires_grad_()
    h_left, h_right = h[rank, 0], h[rank, 1]
    left, right = halo.exchange_halos(g_loc, hw, layout.graph)
    lhs = (left * h_left).sum() + (right * h_right).sum()
    lhs.backward()
    d_ext = torch.cat([h_left, torch.zeros_like(g[rank]), h_right],
                      dim=-2).requires_grad_()
    back = halo.return_halos(d_ext, hw, layout.graph)
    rhs = (g[rank] * back).sum()
    (back * u[rank]).sum().backward()
    return dict(left=left.detach(), right=right.detach(),
                back=back.detach(), lhs=lhs.item(), rhs=rhs.item(),
                g_grad=g_loc.grad, ext_grad=d_ext.grad)


def gp_run(rank, world, n_data, n_graph, config, n_classes, weights, gpb,
           aug, mask, steps):
    """Graph-parallel training on the CPU over gloo: a net of ``config``
    with graph=the rank's graph axis, holding ``weights`` (then
    replicated from rank 0); the loss and gradients of
    make_gp_value_and_grad on this rank's shard of the whole batch
    ``gpb`` (aug and mask: the whole batch's augmentation and keep mask,
    or None), then ``steps`` make_gp_train_step steps.  Returns the loss,
    the gradients by parameter name, the step losses, the parameters after
    the steps, K9's plain-version launches (none on the CPU) and the
    bytes the exchanges sent."""
    torch.manual_seed(1234 + rank)        # nothing may draw from it
    layout = make_layout(n_data, n_graph)
    net = build_model(config, n_classes, device="cpu", graph=layout.graph)
    net.load_state_dict(weights)
    replicate(net, layout)
    local = place_gp_batch(gpb, layout, "cpu")
    names = [n for n, _ in net.named_parameters()]
    kw = dict(aug=aug, dropout_mask=mask)
    loss, grads = make_gp_value_and_grad(net, config, n_classes, layout)(
        local, **kw)
    opt = make_optimizer(config, net.parameters())
    step = make_gp_train_step(net, config, n_classes, opt, layout)
    losses = [step(local, **kw).item() for _ in range(steps)]
    return dict(loss=loss.item(), grads=dict(zip(names, grads)),
                losses=losses,
                params={n: p.detach() for n, p in net.named_parameters()},
                launches=dict(kernels.launches),
                wire_bytes=dict(halo.wire_bytes))


def gp_draws(rank, world, n_data, n_graph, config, n_classes, weights,
             gpb, seed):
    """The loss and gradients of make_gp_value_and_grad on this rank's
    shard with neither aug nor dropout_mask given, so that the loss draws
    both from generator_for(seed, data rank).  Returns them with the keep
    mask the net was given (this rank's rows)."""
    layout = make_layout(n_data, n_graph)
    net = build_model(config, n_classes, device="cpu", graph=layout.graph)
    net.load_state_dict(weights)
    seen = []
    net.register_forward_pre_hook(
        lambda mod, args, kwargs: seen.append(kwargs["dropout_mask"]),
        with_kwargs=True)
    local = place_gp_batch(gpb, layout, "cpu")
    names = [n for n, _ in net.named_parameters()]
    loss, grads = make_gp_value_and_grad(net, config, n_classes, layout)(
        local, seed)
    return dict(loss=loss.item(), grads=dict(zip(names, grads)),
                mask=seen[0].detach())


def fail_on(rank, world, bad):
    """Raise on rank ``bad``; the others return."""
    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    return rank
