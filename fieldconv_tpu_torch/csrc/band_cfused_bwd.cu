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
// Design.  K1's backward pipeline (band_fused_bwd.cu) on the compressed
// planes, as K4's forward (band_cfused_fwd.cu): the occupancy bytes from
// r, contrib rematerialised by the forward's walk, dW (dw_rows.cuh), dc =
// dy·Wᵀ (panel_gemm.cuh; channel-major a frequency at K = 5), then dG by
// source (band_pipe.cuh::dg_kernel): each landed pass's slots expanded
// once into K1's dense image by the consumer warps (expand_pass; at K = 5,
// where a CTA covers one frequency k, f_k alone, by |k − B| products in
// phasors' order), then K1's consumers.  No atomics, every sum in a fixed
// order: two calls give bitwise-equal outputs.  One caller-owned scratch
// buffer (band_cfused_bwd_scratch_floats; band_call.cuh) holds contrib,
// dc, the dW partials, W's rows in dc's order and the occupancy bytes.
//
// What bounds it.  As K1's backward, it is bound by operations (contrib,
// dc, dW and dG each ~2 GFLOP at the serving shapes); both walks read the
// compressed planes at occupied slots only (chip_smoke.py::k4_bwd_bound).

#include "band_call.cuh"

extern "C" long long band_cfused_bwd_scratch_floats(int n_mesh, int N, int C,
                                                    int K, int R, int TB,
                                                    int nh, int O2)
{
    if (!bandpipe::shapes_supported(n_mesh, N, C, K, R, TB, nh, O2, true))
        return 0;
    return bandcall::bwd_scratch_floats(
        n_mesh, C, K, R, O2, bandpipe::band_geo(N, TB, nh, 5));
}

// Launches the six kernels (seven at K = 5) on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for shapes
// they do not take (K > 5; R > 6; C > 256).  scratch holds
// band_cfused_bwd_scratch_floats floats, owned by the caller.
extern "C" int band_cfused_bwd(const float* dy, const float* g,
                               const float* sten, const float* wmat,
                               float* dg, float* dw, float* scratch,
                               int n_mesh, int N, int C, int K, int R, int TB,
                               int nh, int O2, void* stream)
{
    if (!bandpipe::shapes_supported(n_mesh, N, C, K, R, TB, nh, O2, true))
        return (int)cudaErrorInvalidValue;
    return bandcall::fused_bwd<true>(
        dy, g, sten, wmat, dg, dw, scratch, n_mesh, C, K, R, O2,
        bandpipe::band_geo(N, TB, nh, 5), (cudaStream_t)stream);
}
