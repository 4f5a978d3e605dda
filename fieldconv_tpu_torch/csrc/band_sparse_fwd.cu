// Block-sparse banded field-conv forward (K8) for Hopper, sm_90a.
//
// Replaces the TPU kernels fieldconv_tpu/ops/pallas/band_conv.py::
// _band_sparse_fwd_impl (grid pipeline, body _fwd_sparse_kernel) and its
// single-step twin _band_sparse_mega_fwd_impl (body
// _fwd_sparse_mega_kernel).  Python wrapper and plain PyTorch version:
// fieldconv_tpu_torch/ops/band_conv.py (band_sparse_fwd,
// band_sparse_reference).
//
// What it computes: K1's forward (band_fused_fwd.cu) over a
// BlockSparseTable, whose slot w of target block b reads source row
// s = nbr[b, w / TB]·TB + w % TB (w < W' = NJ·TB) instead of the ±nh
// window's (b − nh)·TB + w:
//
//   h_k[w, c]  = f_k[n, w] · G_k[s, c]             (complex product)
//   contrib[n, r, k·2C + c]     = Σ_w rs_r[n, w] · Re h_k[w, c]
//   contrib[n, r, k·2C + C + c] = Σ_w rs_r[n, w] · Im h_k[w, c]
//   y[n, o] = Σ_r Σ_j contrib[n, r, j] · W[r, j, o]
//
// with sten_band (n_mesh, nb, R+2K, TB, NJ·TB), nbr (n_mesh, nb, NJ)
// int32, g (n_mesh, N, M = K·2C) and W (R, M, O2).  A padding entry of nbr
// points at block b and carries all-zero planes: it adds nothing.
//
// Design.  K1's kernel (band_fwd.cuh) with the window walk's source-row
// policy switched (band_window.cuh, SPARSE): the walk stages kChunk slots
// at a time as before, each slot's g row read from the block its panel
// names; everything else (a CTA per tile of 8 targets at C = 32, a thread
// per (target, channel) with all K·R accumulators in registers, cp.async
// double buffering, chunks without a radial weight skipped, the filter
// contraction from shared memory) is K1's.  The TPU kernel fetches the NJ
// source blocks through scalar-prefetch index maps; here each CTA reads
// its block's NJ entries of nbr itself (L1-cached).
//
// What bounds it.  As K1: the stencil stream (R+2K planes of NJ·TB slots a
// target, 14.4 GB at 163,842 vertices with NJ = 19, correspondence widths)
// and the operations its edges need; chip_smoke.py::k8_bound counts both
// from the run's table.  Only ~13 of the NJ panels of a block hold edges
// on average and each holds few, so most staged chunks are skipped after
// their vote, but their stencil bytes are still read: the bytes decide.

#include "band_fwd.cuh"

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for shapes the kernel does not take (K1's: K > 5;
// R > 8, or R > 6 with K > 3; C > 256).
extern "C" int band_sparse_fwd(const float* g, const float* sten,
                               const int* nbr, const float* wmat, float* y,
                               int n_mesh, int N, int C, int K, int R, int TB,
                               int nj, int O2, void* stream)
{
    if (nj < 1) return (int)cudaErrorInvalidValue;
    return band::fused_fwd(g, sten, wmat, y, n_mesh, N, C, K, R, TB, nj, O2,
                           (cudaStream_t)stream, nbr);
}
