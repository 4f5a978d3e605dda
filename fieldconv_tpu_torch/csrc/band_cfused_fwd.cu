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
// Design.  K1's kernel (band_fwd.cuh) with the stencil staged as 5 planes
// instead of R + 2K: after each window chunk lands, one thread per (target,
// slot) of the tile forms the slot's R hats and K factors once, correctly
// rounded in the plain version's order (panel_walk.cuh's hat and
// phasor_powers, as K5 does), into a dense chunk in shared memory that the
// tile's channel threads then contract exactly as K1's do; a slot whose
// hats are all 0 is skipped, which is exact.  Instantiations are K1's
// (K ≤ 3 with R ≤ 6, K = 5 with R ≤ 6: the ring knots hold 6 rings).
//
// What bounds it.  At seg_n2048_b4 (4 × 2048 targets, TB 128, nh 1, C 48,
// K = 5, R = 6) the compressed stencil is 63 MB where the dense one is
// 201 MB; the work per occupied slot grows by the hats and phasor powers
// (~R + 2K operations per slot, shared by the tile's C channel threads).
// K1 is far from its byte bound (PERF.md), so the smaller stencil need not
// make K4 faster; chip_smoke.py measures both.

#include "band_fwd.cuh"

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for shapes the kernel does not take (K > 5; R > 6;
// C > 256).
extern "C" int band_cfused_fwd(const float* g, const float* sten,
                               const float* wmat, float* y,
                               int n_mesh, int N, int C, int K, int R, int TB,
                               int nh, int O2, void* stream)
{
    return band::fused_fwd<true>(g, sten, wmat, y, n_mesh, N, C, K, R, TB,
                                 nh, O2, (cudaStream_t)stream);
}
