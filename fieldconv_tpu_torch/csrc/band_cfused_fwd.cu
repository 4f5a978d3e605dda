// Compressed banded field-conv forward (K4) for Hopper, sm_90a.
//
// Replaces the TPU kernels fieldconv_tpu/ops/pallas/band_conv.py::
// _band_cfused_fwd_impl (body _fwd_cfused_kernel) and its single-step
// pipeline twin _band_cmega_fwd_impl (body _fwd_cmega_kernel).  Python
// wrapper and plain PyTorch version: fieldconv_tpu_torch/ops/band_conv.py
// (band_cfused_fwd, band_cfused_reference).
//
// What it computes: K1's function (band_fused_fwd.cu) over a
// CompressedBandedTable, whose stencil (n_mesh, nb, 5, TB, W') holds per
// slot rv = r, the unit phasor (pr, pi) = e^{iθ} and wxp (fr, fi) in the
// dense band's slot layout; the slot's stencil is rebuilt from them:
//
//   rs_r = clamp(min((rv − s_{r−1})·1/(s_r − s_{r−1}),
//                    (s_{r+1} − rv)·1/(s_{r+1} − s_r)), 0, 1)
//          on knots s_r = sqrt(r/(R−1)), virtual knots −1 and 2;
//   f_B = wxp, f_{B±k} by repeated multiplication with the unit phasor.
//
// Empty slots hold R_SENTINEL (9.0) in r, so every hat is 0 there.
//
// Design.  K1's pipeline (band_fused_fwd.cu: the band's panels walked by
// panel_pipe.cuh, then the filter GEMM split over j) on the compressed
// planes (band_pipe.cuh, band_call.cuh; COMP): three kernels on a scratch
// buffer the caller owns (band_cfused_fwd_scratch_floats):
//
//   1. K1's occupancy bytes, written from the r plane: a slot is occupied
//      where r_lo < r < r_hi on the outermost ring knots (every slot with a
//      nonzero hat; one whose hats are all 0 adds exact zeros; R_SENTINEL
//      lies outside);
//   2. contrib by panel_pipe.cuh's walk with that slab: an occupied slot's
//      image copies its 5 words (e^{iθ}, wxp, r) by cp.async; once a pass
//      has landed, the CTA expands each of its slots in place, once, into
//      K1's dense image: the R hats (panel_walk.cuh's hat) and the K
//      factors f_k (panel_pipe.cuh::phasors), uncontracted and correctly
//      rounded in the plain version's order (band_pipe.cuh::expand_pass),
//      so K1's consumers sum exactly the stencil the plain version
//      rebuilds;
//   3. the filter.
//
// Why the slab is K1's occupancy bytes.  Two ways were open: the r plane
// as the slab (one kernel fewer, but the plane's rows lie W' apart
// where a slab stage is one bulk copy, so a panel-major copy of r is
// needed anyway), or occupancy bytes from r.  The r copy (4 bytes a slot)
// was built and measured: a source tile's slab stages grew 4x and the
// building threads formed the hats into wider images, leaving dG 10 far
// rows a pass where K1 has 19.  The bytes cost one more word copied a
// slot (r) and the hats formed in the expansion.
//
// Why the expansion.  Forming the f_k in each consumer (K5's compressed
// consume, panel_pipe.cuh::slot_coefs) repeats the phasor products once a
// slot and channel: so built, K4 ran 1.4x K1's time on the same graph each
// way (H100, K = 5, R = 6; band_pipe.cuh says what else was measured).
//
// Shapes.  K ≤ 3 with R ≤ 6, and K = 5 with R ≤ 6 (the ring knots hold 6
// rings, panel_walk.cuh); TB > 128 through the walk's virtual blocks.
// nvcc -Xptxas -v reports the kernels' registers and spills
// (chip_smoke.py prints them).
//
// What bounds it.  At seg_n2048_b4 (4 × 2048 targets, TB 128, nh 1, C 48,
// K = 5, R = 6) the compressed stencil is 63 MB where the dense one is
// 201 MB; the work per occupied slot grows by the hats (once a slot) and
// the phasor powers (once a slot and consumer).  chip_smoke.py::k4_bound
// counts the bytes and operations the run's stencil needs.

#include "band_call.cuh"

// Floats of the scratch buffer band_cfused_fwd needs for these sizes (0 for
// sizes it does not take).
extern "C" long long band_cfused_fwd_scratch_floats(int n_mesh, int N, int C,
                                                    int K, int R, int TB,
                                                    int nh, int O2)
{
    if (!bandpipe::shapes_supported(n_mesh, N, C, K, R, TB, nh, O2, true))
        return 0;
    return bandcall::fwd_scratch_floats(
        n_mesh, C, K, R, O2, bandpipe::band_geo(N, TB, nh, 5));
}

// Launches the three kernels on `stream` and returns cudaGetLastError() (0
// on success), or cudaErrorInvalidValue for shapes they do not take (K > 5;
// R > 6; C > 256).  scratch holds band_cfused_fwd_scratch_floats floats,
// owned by the caller.
extern "C" int band_cfused_fwd(const float* g, const float* sten,
                               const float* wmat, float* y, float* scratch,
                               int n_mesh, int N, int C, int K, int R, int TB,
                               int nh, int O2, void* stream)
{
    if (!bandpipe::shapes_supported(n_mesh, N, C, K, R, TB, nh, O2, true))
        return (int)cudaErrorInvalidValue;
    return bandcall::fused_fwd<true>(
        g, sten, wmat, y, scratch, n_mesh, C, K, R, O2,
        bandpipe::band_geo(N, TB, nh, 5), (cudaStream_t)stream);
}
