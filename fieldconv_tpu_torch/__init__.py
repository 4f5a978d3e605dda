"""PyTorch + CUDA port of fieldconv_tpu (field convolutions on surfaces).

Module paths mirror the JAX package: ``fieldconv_tpu.ops.field_conv`` is
``fieldconv_tpu_torch.ops.field_conv`` here.  The hot contraction of the
banded layout runs in hand-written CUDA kernels for Hopper (``csrc/``,
built on first use by :mod:`fieldconv_tpu_torch.kernels`); every other op is
plain PyTorch.  Complex values stay planar ``(..., 2)`` float32, and every
op accepts optional leading mesh-batch axes.  The panel ECHO of the
segmentation and correspondence nets runs in a second hand-written kernel.

Entry points take ``device=`` (default ``"cuda"``) and raise without a card
unless the caller asks for ``device="cpu"``.  Kernel wrappers run their
plain PyTorch version only for CPU tensors; a CUDA tensor launches the
kernel or raises.

This package imports no JAX and nothing of ``fieldconv_tpu``.
"""
