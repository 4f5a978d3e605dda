// Graph-parallel fused field-conv backward (K9 bwd) for Hopper, sm_90a.
//
// Replaces the TPU kernels fieldconv_tpu/parallel/halo.py::_halo_fused_bwd
// (the serial shard's backward, with the XLA shift combine of its
// per-(block, shift) dG parts) and _bwd_fused_shard (a range of target
// blocks: the overlapped path's head, tail and interior).  Python wrapper
// and plain PyTorch version: fieldconv_tpu_torch/parallel/halo.py
// (halo_fused_bwd, halo_fused_bwd_reference).
//
// What it computes: K1's backward (band_fused_bwd.cu) over the launch of
// halo_fused_fwd.cu (target blocks lo .. hi − 1, source array g (n_mesh,
// n_src, M), window of block b from source block b + blk_off): for the
// cotangent dy (n_mesh, (hi − lo)·TB, O2) of the range's targets,
//
//   dW[r, j, o]  = Σ_m Σ_n contrib[m, n, r, j] · dy[m, n, o]
//   dc[n, r, j]  = Σ_o dy[n, o] · W[r, j, o]
//   dG_k[s]     += Σ_r S_k,r[n, w] ⊛ dc[n, r, k]   for every slot w of
//                  target n whose source row is s = (b + blk_off)·TB + w
//
// Outputs dg (n_mesh, n_src, M), every row of the source array (its halo
// rows too: their gradient belongs to the ring neighbours, and
// parallel/halo.py returns it to them), and dw (R, M, O2), f32.
//
// Design.  K1's backward pipeline (band_fused_bwd.cu) on the launch's
// range (band_pipe.cuh::BandRun takes the range and the source array, as
// in halo_fused_fwd.cu), on one scratch buffer the caller owns
// (halo_fused_bwd_scratch_floats; band_call.cuh): the occupancy bytes of
// the range's blocks; contrib of the range's targets by the forward's
// walk; dW as slice partials and their combine (dw_rows.cuh); dc = dy·Wᵀ
// (panel_gemm.cuh; channel-major a frequency at K = 5); dG by source over
// the n_src / TB blocks of the source array: a CTA owns a tile of source
// rows of block e and walks the target blocks b = e − blk_off − 2nh ..
// e − blk_off inside [lo, hi) whose windows read it, ascending, staging
// their dc rows by bulk copy; a block that no target of the range reads
// writes zeros.  The TPU kernels write a (nb·NJ·TB, M) tensor of
// per-(block, shift) parts and add them into dG_ext with XLA; here each dG
// row has one writer that sums its blocks in a fixed order: no parts
// tensor, no atomics, and two calls give bitwise-equal outputs.
//
// What bounds it.  As K1's backward over the range's blocks and their
// source rows: the operations of contrib, dc, dW and dG against the
// stencil, which both walks read at their occupied slots
// (chip_smoke.py::k9_bound, bwd, counts it once).

#include "band_call.cuh"

// Floats of the scratch buffer halo_fused_bwd needs for these sizes (0 for
// sizes it does not take).
extern "C" long long halo_fused_bwd_scratch_floats(int n_mesh, int N,
                                                   int n_src, int C, int K,
                                                   int R, int TB, int nh,
                                                   int O2, int blk_off,
                                                   int lo, int hi)
{
    if (!bandpipe::shapes_supported(n_mesh, N, C, K, R, TB, nh, O2)
        || !bandpipe::range_supported(N, TB, n_src, lo, hi))
        return 0;
    return bandcall::bwd_scratch_floats(
        n_mesh, C, K, R, O2,
        bandpipe::range_geo(bandpipe::band_geo(N, TB, nh, R + 2 * K), n_src,
                            blk_off, lo, hi));
}

// Launches the six kernels (seven at K = 5) on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for shapes
// they do not take (as the forward's).  scratch holds
// halo_fused_bwd_scratch_floats floats, owned by the caller.
extern "C" int halo_fused_bwd(const float* dy, const float* g,
                              const float* sten, const float* wmat,
                              float* dg, float* dw, float* scratch,
                              int n_mesh, int N, int n_src, int C, int K,
                              int R, int TB, int nh, int O2, int blk_off,
                              int lo, int hi, void* stream)
{
    if (!bandpipe::shapes_supported(n_mesh, N, C, K, R, TB, nh, O2)
        || !bandpipe::range_supported(N, TB, n_src, lo, hi))
        return (int)cudaErrorInvalidValue;
    return bandcall::fused_bwd<false>(
        dy, g, sten, wmat, dg, dw, scratch, n_mesh, C, K, R, O2,
        bandpipe::range_geo(bandpipe::band_geo(N, TB, nh, R + 2 * K), n_src,
                            blk_off, lo, hi),
        (cudaStream_t)stream);
}
