// Compressed banded field-conv backward (K4 bwd) for Hopper, sm_90a.
//
// Replaces the TPU kernels fieldconv_tpu/ops/pallas/band_conv.py::
// _band_cfused_bwd (body _bwd_cfused_kernel) and its single-step pipeline
// twin _band_cmega_bwd_impl (body _bwd_cmega_kernel).  Python wrapper and
// plain PyTorch version: fieldconv_tpu_torch/ops/band_conv.py
// (band_cfused_bwd, band_cfused_bwd_reference).
//
// What it computes: K1's backward (band_fused_bwd.cu) over the stencil a
// CompressedBandedTable stands for, (dG, dW) for the output cotangent dy,
// with the slot's hats and phasor powers rebuilt as in K4's forward
// (band_cfused_fwd.cu).
//
// Design.  K1's five passes (band_bwd.cuh), no atomics, every sum in a
// fixed order, so two calls give bitwise-equal outputs: (1) contrib is
// rematerialised by the forward's window walk, (2) dc = dy·Wᵀ, (3-4) dW as
// slice partials and their combine (dw_rows.cuh), (5) dG gathered by
// source block.  Passes 1 and 5 stage the 5 compressed planes and expand
// each (target, slot) once into R hats and K factors in shared memory
// (panel_walk.cuh's hat and phasor_powers, correctly rounded in the plain
// version's order), which the channel threads then read as K1's read the
// dense planes.  One caller-owned scratch buffer
// (band_cfused_bwd_scratch_floats) holds contrib, dc and the dW partials.
//
// What bounds it.  As K1's backward, it is bound by operations (contrib,
// dc, dW and dG each ~2 GFLOP at the serving shapes); the stencil it reads
// twice is 5 planes instead of R + 2K, and each staged slot costs the R
// hats and 2B complex products once more per pass.

#include "band_bwd.cuh"

extern "C" long long band_cfused_bwd_scratch_floats(int n_mesh, int N, int C,
                                                    int K, int R, int TB,
                                                    int nh, int O2)
{
    return band::fused_bwd_scratch_floats(n_mesh, N, C, K, R, TB, nh, O2,
                                          true);
}

// Launches the five kernels on `stream` and returns cudaGetLastError() (0
// on success), or cudaErrorInvalidValue for shapes they do not take (K > 5;
// R > 6; C > 256).  scratch holds band_cfused_bwd_scratch_floats floats,
// owned by the caller.
extern "C" int band_cfused_bwd(const float* dy, const float* g,
                               const float* sten, const float* wmat,
                               float* dg, float* dw, float* scratch,
                               int n_mesh, int N, int C, int K, int R, int TB,
                               int nh, int O2, void* stream)
{
    return band::fused_bwd<true>(dy, g, sten, wmat, dg, dw, scratch, n_mesh,
                                 N, C, K, R, TB, nh, O2,
                                 (cudaStream_t)stream);
}
