"""Process groups of graph-parallel training, their collectives, and a
helper that runs a function on N ranks.

Counterpart of ``fieldconv_tpu/parallel/distributed.py`` and the device
mesh of ``fieldconv_tpu/parallel/sharding.py``.  JAX lays its devices out
as a ('data', 'graph') mesh; here ``world = n_data × n_graph`` ranks of
``torch.distributed`` take those places: graph rank = rank % n_graph, data
rank = rank // n_graph.  Each data row (the n_graph ranks that share a
data rank) is one graph group: its ranks hold the vertex rows of the same
meshes and exchange halo rows.  Each graph column is one data group.
An :class:`Axis` carries one group, the rank's place in it and its size;
ops and modules take the graph :class:`Axis` where the JAX package takes
``axis_name='graph'``.

Transport.  NCCL needs one card per rank; :func:`spawn` refuses it with
fewer cards than ranks.  On a gloo group a CUDA tensor crosses through
host memory: :func:`_wire` copies it to the host before the collective and
the result goes back to the card after it, in every collective here.
Nothing picks another backend than the one the caller names.
"""

from __future__ import annotations

import dataclasses
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("gloo", "nccl")
RANK_THREADS = 1        # torch threads of each spawned rank
RANK_TIMEOUT_S = 900.0  # longest wait for a rank's result


@dataclasses.dataclass(frozen=True)
class Axis:
    """One process group of the layout: ``ranks`` (global ranks, in group
    order), this process's ``rank`` in it (its index in ``ranks``), its
    ``size`` and the group's ``backend``."""

    group: Optional[dist.ProcessGroup]
    ranks: tuple
    rank: int
    backend: str

    @property
    def size(self) -> int:
        return len(self.ranks)


@dataclasses.dataclass(frozen=True)
class Layout:
    """A rank's place in the (n_data, n_graph) layout: its graph group
    (the ranks of its data row), its data group (the ranks of its graph
    column) and the whole world."""

    n_data: int
    n_graph: int
    graph: Axis
    data: Axis
    world: Axis

    @property
    def graph_rank(self) -> int:
        return self.graph.rank

    @property
    def data_rank(self) -> int:
        return self.data.rank


def initialize(backend: str, init_method: str, rank: int,
               world: int) -> None:
    """Start this process's default group: ``backend`` ("gloo" or
    "nccl"), rendezvous at ``init_method`` (``file://...`` or
    ``tcp://localhost:<port>``), global ``rank`` of ``world``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)


def make_layout(n_data: int, n_graph: int) -> Layout:
    """The (n_data, n_graph) layout over the initialised world.  Every rank
    must call it (each group is created by all ranks, in one order)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data * n_graph != world:
        raise ValueError(f"layout {n_data}x{n_graph} != {world} ranks")
    backend = dist.get_backend()

    def axis(ranks_of):
        mine = None
        for members in ranks_of:
            members = tuple(members)
            group = dist.new_group(list(members)) if len(members) < world \
                else dist.group.WORLD
            if rank in members:
                mine = Axis(group, members, members.index(rank), backend)
        return mine

    graph = axis([range(d * n_graph, (d + 1) * n_graph)
                  for d in range(n_data)])
    data = axis([range(g, world, n_graph) for g in range(n_graph)])
    return Layout(n_data, n_graph, graph, data,
                  Axis(dist.group.WORLD, tuple(range(world)), rank, backend))


def process_local_batch_slice(n_items: int, layout: Layout) -> slice:
    """The meshes of a global batch of ``n_items`` that this rank's data
    row holds: a contiguous 1/n_data of them."""
    if n_items % layout.n_data:
        raise ValueError(f"batch {n_items} not divisible by the data axis "
                         f"{layout.n_data}")
    per = n_items // layout.n_data
    return slice(layout.data_rank * per, (layout.data_rank + 1) * per)


# --- collectives ---------------------------------------------------------------

def _wire(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """A fresh contiguous copy of t for a collective of ``axis`` to move:
    on a gloo group a CUDA tensor's copy is made in host memory (gloo moves
    host memory).  The one place where a CUDA tensor is staged."""
    if axis.backend == "gloo" and t.is_cuda:
        return t.detach().to("cpu")
    return t.detach().clone(memory_format=torch.contiguous_format)


def all_reduce_sum(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Σ of t over the ranks of ``axis`` (a new tensor on t's device; t is
    left as it is)."""
    w = _wire(t, axis)
    if axis.size > 1:
        dist.all_reduce(w, group=axis.group)
    return w.to(t.device)


def broadcast(t: torch.Tensor, src: int, axis: Axis) -> torch.Tensor:
    """t of the rank ``src`` of ``axis`` (an index into the group), on
    every rank, on t's device."""
    w = _wire(t, axis)
    if axis.size > 1:
        dist.broadcast(w, src=axis.ranks[src], group=axis.group)
    return w.to(t.device)


class AllReduceSum(torch.autograd.Function):
    """Σ over the ranks of an axis whose backward is the Σ of the
    cotangents (JAX's psum under shard_map): each rank's input receives
    the sum of every rank's output cotangent."""

    @staticmethod
    def forward(ctx, t, axis: Axis):
        ctx.axis = axis
        return all_reduce_sum(t, axis)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.axis), None


class Pending:
    """Ring messages posted by :func:`post_ring`; ``wait()`` returns
    (rows from the previous rank, rows from the next rank), each on the
    sent tensors' device, zeros where the ring ends."""

    def __init__(self, ops, reqs, bufs, like_prev, like_next):
        # the ops hold the sent copies, alive until the wait
        self._ops, self._reqs, self._bufs = ops, reqs, bufs
        self._like = (like_prev, like_next)

    def wait(self):
        for r in self._reqs:
            r.wait()
        out = []
        for buf, like in zip(self._bufs, self._like):
            out.append(torch.zeros_like(like) if buf is None
                       else buf.to(like.device))
        return tuple(out)


def post_ring(to_prev: torch.Tensor, to_next: torch.Tensor,
              axis: Axis) -> Pending:
    """Send ``to_prev`` to the previous rank of ``axis`` and ``to_next`` to
    the next one, and receive theirs, without waiting.  The ring does not
    wrap: rank 0 has no previous rank and the last no next one, and their
    missing messages read as zeros.  Received rows have the shape of the
    rows sent the other way."""
    ops, bufs = [], [None, None]
    for i, (peer, out) in enumerate(((axis.rank - 1, to_prev),
                                     (axis.rank + 1, to_next))):
        if not 0 <= peer < axis.size:
            continue
        w = _wire(out, axis)
        buf = torch.empty_like(w)
        bufs[i] = buf
        ops += [dist.P2POp(dist.isend, w, axis.ranks[peer], axis.group),
                dist.P2POp(dist.irecv, buf, axis.ranks[peer], axis.group)]
    reqs = dist.batch_isend_irecv(ops) if ops else []
    return Pending(ops, reqs, bufs, to_next, to_prev)


# --- running N ranks -------------------------------------------------------------

def _host(value):
    """value with every tensor in it as a numpy array (results cross the
    process boundary by value)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, dict):
        return {k: _host(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_host(v) for v in value)
    return value


def _rank_main(rank, world, backend, init_method, fn, args, results):
    try:
        torch.set_num_threads(RANK_THREADS)
        if torch.cuda.is_available():
            # gloo ranks share the cards round-robin; NCCL has one each
            torch.cuda.set_device(rank % torch.cuda.device_count())
        initialize(backend, init_method, rank, world)
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, _host(out)))
    except BaseException:                     # reported to the parent
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, world: int, args: Sequence = (),
          backend: str = "gloo") -> list:
    """Run ``fn(rank, world, *args)`` on ``world`` new processes (the spawn
    start method), each with its default group initialised over
    ``backend`` through a ``file://`` rendezvous, and return each rank's
    result (tensors as numpy arrays), in rank order.

    ``fn`` must be importable (a module-level function) and must not need
    a card of its own for gloo: gloo ranks share the cards round-robin.
    NCCL needs one card per rank and raises here with fewer.  CPU tensors
    in ``args`` reach the children through shared memory.  Each rank runs
    RANK_THREADS torch threads.  If a rank fails, or has not answered in
    RANK_TIMEOUT_S seconds, every rank is stopped and this raises with the
    failing rank's traceback."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend == "nccl" and n_cards < world:
        raise RuntimeError(
            f"nccl needs one card per rank: {world} ranks, {n_cards} "
            "card(s); use backend='gloo' (halo rows then cross through "
            "host memory)")
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="fieldconv_rdzv_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, backend, init_method, fn,
                               tuple(args), results), daemon=True)
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        out, deadline = {}, time.monotonic() + RANK_TIMEOUT_S
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} of {world} died (exit code "
                        f"{procs[dead[0]].exitcode}) before reporting")
                if time.monotonic() > deadline:
                    late = sorted(set(range(world)) - set(out))
                    raise RuntimeError(f"ranks {late} of {world} did not "
                                       f"finish in {RANK_TIMEOUT_S} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=60)
        return [out[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)


def generator_for(seed: int, data_rank: int) -> torch.Generator:
    """A CPU generator seeded by (seed, data rank): every graph rank of a
    data row draws the same numbers, different rows different ones."""
    state = np.random.SeedSequence([seed, data_rank]).generate_state(1)
    return torch.Generator().manual_seed(int(state[0]))
