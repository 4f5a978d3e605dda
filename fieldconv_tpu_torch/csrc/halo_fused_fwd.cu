// Graph-parallel fused field-conv forward (K9 fwd) for Hopper, sm_90a.
//
// Replaces the TPU kernels fieldconv_tpu/parallel/halo.py::_halo_fused_fwd
// (the serial shard: every local target over the halo-extended G) and
// _fused_fwd_shard (a range of target blocks with a stencil offset: the
// overlapped path's interior, head and tail).  Python wrapper and plain
// PyTorch version: fieldconv_tpu_torch/parallel/halo.py (halo_fused_fwd,
// halo_fused_fwd_reference).
//
// What it computes: K1's forward (band_fused_fwd.cu) for the target blocks
// b = lo .. hi − 1 of one shard (stencil sten (n_mesh, nb, R+2K, TB, W'),
// nb = N / TB local blocks), each reading its window from a source array g
// (n_mesh, n_src, M = K·2C) whose block b + blk_off is the window's first:
//
//   s = (b + blk_off)·TB + w  for window slot w < W' = (2nh+1)·TB
//   h_k[w, c]  = f_k[n, w] · G_k[s, c]             (complex product)
//   contrib[n, r, k·2C + c]     = Σ_w rs_r[n, w] · Re h_k[w, c]
//   contrib[n, r, k·2C + C + c] = Σ_w rs_r[n, w] · Im h_k[w, c]
//   y[n, o] = Σ_r Σ_j contrib[n, r, j] · W[r, j, o]
//
// into rows b·TB .. b·TB + TB − 1 of y (n_mesh, N, O2); the other rows of
// y are left as they are.  Source rows outside [0, n_src) count zero.  g is
// the shard's rows with nh·TB halo rows of each ring neighbour on either
// side (blk_off = 0, the serial path), the shard's own rows (blk_off = −nh,
// the interior blocks nh .. nb − nh − 1, which read no halo row), or a
// piece of the extended array (the head [left halo | first 2nh blocks],
// blk_off = 0, blocks 0 .. nh − 1; the tail [last 2nh blocks | right
// halo], blk_off = nh − nb, blocks nb − nh .. nb − 1).
//
// Design.  K1's kernel (band_fwd.cuh) with the window walk's source policy
// HALO (band_window.cuh, HaloRange): the launch covers hi − lo blocks,
// each CTA takes its window from row (b + blk_off)·TB of g and its stencil
// from block b, and writes y at block b, so the overlapped path's three
// launches fill one y without a concatenation.  Everything else (a CTA per
// tile of 8 targets at C = 32, a thread per (target, channel), cp.async
// double buffering, empty chunks skipped, the filter contraction from
// shared memory) is K1's.  The TPU kernels read g through NJ BlockSpecs
// shifted by j blocks; here the window is staged kChunk slots at a time.
//
// What bounds it.  As K1 over the shard: the stencil of its hi − lo blocks,
// its window's rows of g (local targets plus 2nh·TB halo rows when the
// range reaches an end) and W, and the operations the stencil's edges need
// (chip_smoke.py::k9_bound counts both from the run's data).

#include "band_fwd.cuh"

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for shapes the kernel does not take (K1's: K > 5;
// R > 8, or R > 6 with K > 3; C > 256; and n_src a positive multiple of
// TB, 0 ≤ lo < hi ≤ N / TB).
extern "C" int halo_fused_fwd(const float* g, const float* sten,
                              const float* wmat, float* y, int n_mesh, int N,
                              int n_src, int C, int K, int R, int TB, int nh,
                              int O2, int blk_off, int lo, int hi,
                              void* stream)
{
    return band::fused_fwd<false, false, true>(
        g, sten, wmat, y, n_mesh, N, C, K, R, TB, nh, O2,
        (cudaStream_t)stream, nullptr,
        band::HaloRange{n_src, blk_off, lo, hi});
}
