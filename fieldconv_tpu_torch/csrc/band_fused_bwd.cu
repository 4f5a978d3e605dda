// Fused banded field-conv backward (K1 bwd) for Hopper, sm_90a.
//
// Replaces the TPU kernel fieldconv_tpu/ops/pallas/band_conv.py::
// _band_megaw_bwd_impl (body _bwd_megaw_kernel) and its same-math pipeline
// twins _band_fused_mega_bwd_impl and _band_fused_bwd.  Python wrapper and
// plain PyTorch version: fieldconv_tpu_torch/ops/band_conv.py
// (band_fused_bwd, band_fused_bwd_reference).
//
// What it computes.  With contrib, G, S and W as in the forward
// (band_fused_fwd.cu): S_k = rs ⊙ f_k per ring, dy (n_mesh, N, O2) the
// output cotangent,
//
//   dW[r, j, o]     = Σ_m Σ_n contrib[m, n, r, j] · dy[m, n, o]    (W is shared)
//   dc[n, r, j]     = Σ_o dy[n, o] · W[r, j, o]
//   dG_k[s, re|im]  = Σ_n Σ_r S_k,r[n, w] ⊛ dc[n, r, k]  with s = (n/TB - nh)·TB + w,
//                     [S_re·d_re + S_im·d_im | S_re·d_im − S_im·d_re]
//
// Window slots whose source row lies outside [0, N) take no gradient.
// Outputs dg (n_mesh, N, M) and dw (R, M, O2), f32.
//
// Design.  The TPU kernel walks target blocks in order and read-modify-
// writes each block's overlapping dG window in one VMEM buffer, and sums dW
// in a revisited output block; both rely on its sequential grid.  Here the
// blocks run in parallel, so every sum has one owner and runs in a fixed
// order: no atomics, and two calls on the same inputs give bitwise-equal
// outputs.  One call launches six kernels on the stream (seven at K = 5;
// band_call.cuh), with one scratch buffer owned by the caller
// (band_fused_bwd_scratch_floats):
//
//   0. the occupancy bytes of the band's slots, as the forward's
//      (band_pipe.cuh::occ_kernel), read by both walks;
//   1. contrib of every target row, rematerialised exactly as the forward
//      forms it (band_pipe.cuh's walk by target; only g, W and the stencil
//      are kept from the forward, as in JAX), written to scratch as (rows,
//      R·M);
//   2. dW = Σ_rows contribᵀ·dy: per-slice partials and a combine in slice
//      order (dw_rows.cuh, K5's and K6's);
//   3. dc = dy·Wᵀ, a tiled product (panel_gemm.cuh, K5's and K6's) written
//      over contrib: in contrib's layout at K ≤ 3; at K = 5 with W's rows
//      first reordered (band_pipe.cuh::cm_w_kernel) so that dc is
//      channel-major a frequency, [k][c][r][re|im];
//   4. dG by source (band_pipe.cuh::dg_kernel, panel_pipe.cuh's walk,
//      warp-specialized as K5's pass 4): a CTA owns a tile of up to 32
//      sources of one source block (and at K = 5 one frequency), one
//      consumer thread per (source, channel) with its complex dG sums in
//      registers, and four producer warps that walk the target blocks whose
//      window holds the block (b = s − nh .. s + nh inside [0, nb)),
//      staging per panel the tile's columns of the occupancy bytes, then in
//      passes the dc rows (at K = 5 the frequency's C·12 floats of them) of
//      the target rows any of its sources needs (a bulk copy a row: each
//      read once per tile and panel) and the occupied slots' planes.  Per
//      slot a consumer forms u_k = Σ_r rs_r·dc[t, r, k] (at K = 5 from
//      float4s of two rings each, skipping a pair whose hats are both
//      zero) and adds f_k ⊛ u_k.  dG is written once per row.
//
// What bounds it.  At the serving shape N=8192, TB=128, nh=1, C=O=32, K=5,
// R=6 a call must move ~225 MB (stencil 201 MB, g, dg, dy, W, dW: 0.067 ms
// at 3.35 TB/s) and needs ~9 GFLOP f32 (contrib ~2.4, dW 2, dc 2, dG ~2.6:
// 0.135 ms at 67 TFLOP/s), so it is bound by operations (chip_smoke.py
// counts both from the run's stencil).  This version also writes and reads
// back contrib and dc (63 MB each), reads the stencil twice (once per
// walk) and its hat planes once more (occupancy), and stages each dc row
// once per source tile, panel and frequency; its walks stay bound by their
// consumers' per-slot sums (with its consumers left out, dG over a
// ring-major dc ran 0.30 of its 0.79 ms at that shape) and the latency of
// their per-panel steps.  Measured on an H100 at that shape:
// 1.09 ms, dG 0.51 of it, contrib 0.30, dW 0.13, dc 0.09 (chip_smoke.py;
// PERF.md).

#include "band_call.cuh"

// Floats of the scratch buffer band_fused_bwd needs for these sizes (0 for
// sizes it does not take).
extern "C" long long band_fused_bwd_scratch_floats(int n_mesh, int N, int C,
                                                   int K, int R, int TB,
                                                   int nh, int O2)
{
    if (!bandpipe::shapes_supported(n_mesh, N, C, K, R, TB, nh, O2))
        return 0;
    return bandcall::bwd_scratch_floats(
        n_mesh, C, K, R, O2, bandpipe::band_geo(N, TB, nh, R + 2 * K));
}

// Launches the six kernels on `stream` and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for shapes they do not take (as the
// forward's).  scratch holds band_fused_bwd_scratch_floats floats, owned by
// the caller.
extern "C" int band_fused_bwd(const float* dy, const float* g,
                              const float* sten, const float* wmat,
                              float* dg, float* dw, float* scratch,
                              int n_mesh, int N, int C, int K, int R, int TB,
                              int nh, int O2, void* stream)
{
    if (!bandpipe::shapes_supported(n_mesh, N, C, K, R, TB, nh, O2))
        return (int)cudaErrorInvalidValue;
    return bandcall::fused_bwd<false>(
        dy, g, sten, wmat, dg, dw, scratch, n_mesh, C, K, R, O2,
        bandpipe::band_geo(N, TB, nh, R + 2 * K), (cudaStream_t)stream);
}
