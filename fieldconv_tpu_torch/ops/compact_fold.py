"""The fold of a CompactPanelTable's per-column gradients onto vertices.

Counterpart of the ``jax.ops.segment_sum`` calls that close the JAX
package's compact VJPs (``fieldconv_tpu/ops/pallas/band_conv.py:2118``,
``ops/pallas/echo_panel.py:378``, ``ops/trans_field.py:408``).  The kernel
lives in ``csrc/compact_fold.cuh``: K6's and K7's backward kernels run it
as their last pass, and ``csrc/compact_fold.cu`` exports it alone for the
compact lift's backward.  It reads the table's fold index (``fold_order``,
``fold_ptr``, built once with the table by
``precomp/banded.py::build_compact_panel_table``), so that every output has
one writer: no atomics, and two calls agree bitwise.  ``kernels.launches
["compact_fold"]`` counts every launch of the fold kernel: the last pass of
each K6 and K7 backward launch, and each call of :func:`compact_fold` on
CUDA tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels


def compact_fold_reference(vals, src_idx, rows: int):
    """Plain PyTorch fold: out (rows, W) with out[v] = Σ vals[j] over the
    flat columns j = p·TS + s whose src_idx is v, by index_add over every
    column in flat order (on the CPU the order of JAX's segment_sum).
    vals: (P·TS, W); src_idx: (P, TS)."""
    out = vals.new_zeros(rows, vals.shape[1])
    return out.index_add_(0, src_idx.reshape(-1).long(), vals)


@functools.cache
def _fold_entry():
    fn = kernels.library("compact_fold").compact_fold
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _compact_fold_cuda(vals, fold_order, fold_ptr, rows: int):
    name = "compact_fold"
    for label, t, dtype in (("vals", vals, torch.float32),
                            ("fold_order", fold_order, torch.int32),
                            ("fold_ptr", fold_ptr, torch.int32)):
        if t.device != vals.device or t.dtype != dtype \
                or not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous {dtype} {label} on "
                             f"{vals.device}, got {t.dtype} on {t.device} "
                             f"(contiguous={t.is_contiguous()})")
    if vals.dim() != 2 or tuple(fold_ptr.shape) != (rows + 1,):
        raise ValueError(f"{name}: vals {tuple(vals.shape)}, fold_ptr "
                         f"{tuple(fold_ptr.shape)} for {rows} rows")
    fn = _fold_entry()
    out = torch.empty((rows, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    err = fn(vals.data_ptr(), fold_order.data_ptr(), fold_ptr.data_ptr(),
             out.data_ptr(), rows, vals.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    kernels.launches[name] += 1
    return out


def compact_fold(vals, src_idx, fold_order, fold_ptr, rows: int):
    """The fold (rows, W) of per-column values vals (P·TS, W) of a
    CompactPanelTable (its src_idx and fold index): the sum of every column
    that reads row v, at row v.

    CPU tensors run the plain version (over src_idx); CUDA tensors launch
    the kernel (over the fold index, building it on first use) or raise."""
    if vals.device.type == "cpu":
        return compact_fold_reference(vals, src_idx, rows)
    if vals.device.type == "cuda":
        return _compact_fold_cuda(vals, fold_order, fold_ptr, rows)
    raise ValueError(f"compact_fold has no kernel for device {vals.device}")
