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
// Design.  K1's pipeline (band_fused_fwd.cu) on the launch's range: the
// band's run policy (band_pipe.cuh::BandRun) takes the range and the
// source array, so block b of the range walks the panels of source blocks
// max(0, b + blk_off) .. min(n_src / TB − 1, b + blk_off + 2nh), and K1 is
// the range [0, nb) over g with blk_off = −nh.  Three kernels on a scratch
// buffer the caller owns (halo_fused_fwd_scratch_floats; band_call.cuh):
// the occupancy bytes of the range's blocks (panel-major rows of 16 bytes,
// laid out from the range's first block, so their alignment does not
// depend on lo or blk_off); contrib of the range's targets by
// panel_pipe.cuh's pipelined walk (g rows staged by bulk copy, one a row:
// aligned wherever the range starts, since a row is M floats); the filter
// GEMM split over j, whose rows land in rows lo·TB .. hi·TB of each mesh's
// y (panel_gemm.cuh's rows a mesh and mesh stride), so the overlapped
// path's three launches fill one y without a copy or a concatenation.
// Every output has one writer and a fixed sum order: no atomics, two
// calls agree bitwise.  The TPU kernels read g through NJ BlockSpecs
// shifted by j blocks; here the walk stages each g row once a tile and
// panel.
//
// What bounds it.  As K1 over the shard: the stencil of its hi − lo
// blocks, its window's rows of g (local targets plus 2nh·TB halo rows
// when the range reaches an end) and W, and the operations the stencil's
// edges need (chip_smoke.py::k9_bound counts both from the run's data).
// Measured on an H100, the serial seg_n2048_b4 shard (C = 48, O2 = 96)
// and the head and tail ranges of nh blocks: PERF.md (chip_smoke.py).

#include "band_call.cuh"

// Floats of the scratch buffer halo_fused_fwd needs for these sizes (0 for
// sizes it does not take).
extern "C" long long halo_fused_fwd_scratch_floats(int n_mesh, int N,
                                                   int n_src, int C, int K,
                                                   int R, int TB, int nh,
                                                   int O2, int blk_off,
                                                   int lo, int hi)
{
    if (!bandpipe::shapes_supported(n_mesh, N, C, K, R, TB, nh, O2)
        || !bandpipe::range_supported(N, TB, n_src, lo, hi))
        return 0;
    return bandcall::fwd_scratch_floats(
        n_mesh, C, K, R, O2,
        bandpipe::range_geo(bandpipe::band_geo(N, TB, nh, R + 2 * K), n_src,
                            blk_off, lo, hi));
}

// Launches the three kernels on `stream` and returns cudaGetLastError() (0
// on success), or cudaErrorInvalidValue for shapes they do not take (K1's:
// K > 5; R > 8, or R > 6 with K > 3; C > 256; and n_src a positive
// multiple of TB, 0 ≤ lo < hi ≤ N / TB).  scratch holds
// halo_fused_fwd_scratch_floats floats, owned by the caller.
extern "C" int halo_fused_fwd(const float* g, const float* sten,
                              const float* wmat, float* y, float* scratch,
                              int n_mesh, int N, int n_src, int C, int K,
                              int R, int TB, int nh, int O2, int blk_off,
                              int lo, int hi, void* stream)
{
    if (!bandpipe::shapes_supported(n_mesh, N, C, K, R, TB, nh, O2)
        || !bandpipe::range_supported(N, TB, n_src, lo, hi))
        return (int)cudaErrorInvalidValue;
    return bandcall::fused_fwd<false>(
        g, sten, wmat, y, scratch, n_mesh, C, K, R, O2,
        bandpipe::range_geo(bandpipe::band_geo(N, TB, nh, R + 2 * K), n_src,
                            blk_off, lo, hi),
        (cudaStream_t)stream);
}
