// Fused banded field-conv forward (K1) for Hopper, sm_90a.
//
// Replaces the TPU kernel fieldconv_tpu/ops/pallas/band_conv.py::
// _band_megaw_fwd_impl and its same-math pipeline twins
// _band_fused_mega_fwd_impl and _band_fused_fwd_impl.  Python wrapper and
// plain PyTorch version: fieldconv_tpu_torch/ops/band_conv.py.
//
// What it computes, for mesh m, target n in block b = n / TB, ring r,
// frequency k and channel c (all float32, complex values planar):
//
//   s = (b - nh)·TB + w  for window slot w < W' = (2nh+1)·TB
//   h_k[w, c]  = f_k[n, w] · G_k[s, c]             (complex product)
//   contrib[n, r, k·2C + c]     = Σ_w rs_r[n, w] · Re h_k[w, c]
//   contrib[n, r, k·2C + C + c] = Σ_w rs_r[n, w] · Im h_k[w, c]
//   y[n, o] = Σ_r Σ_j contrib[n, r, j] · W[r, j, o]
//
// with rs_r = plane r and f_k = planes (R+2k, R+2k+1) of sten_band
// (n_mesh, nb, R+2K, TB, W'), G the k-major rotated-source tensor g
// (n_mesh, N, M = K·2C) and W = filters_to_wmat (R, M, O2), 1/K included.
// Slots whose source row s lies outside [0, N) contribute nothing; the
// kernel never reads outside g, nor the stencil of those slots.
//
// Design.  The TPU kernel keeps a whole block's contrib (R·TB × M, ~1 MB at
// the serving shape) and all of g in VMEM.  Here the band is walked as
// panels (band_pipe.cuh): panel j of block b is its window's j-th TB × TB
// square, reading source block b − nh + j, visited only when that block
// exists.  Three kernels (band_call.cuh), on a scratch buffer the caller
// owns (band_fused_fwd_scratch_floats):
//
//   1. occupancy: one byte a slot (any radial weight nonzero), written
//      panel by panel with 16-byte aligned rows (band_pipe.cuh::occ_kernel);
//   2. contrib of every target row by panel_pipe.cuh's pipelined walk: a CTA
//      owns a tile of targets of one block (32 at C = 32, K = 3, R = 3; 8 at
//      K = 5, R = 6, C = 32; 5 at C = 48), walks its 2nh+1 panels with the
//      next panels' occupancy rows arriving by bulk copy (cp.async.bulk, one
//      a stage), and per panel stages each g row that any of its targets
//      needs once (a bulk copy a row), numbers the occupied slots so that
//      every lane builds one (its R + 2K planes copied at that slot only, 4
//      bytes each by cp.async from the band's strided rows), and sums in
//      registers, reading each slot's planes back as float4s.  At K ≤ 3
//      the walk is warp-specialized (512 consumers of two channels each,
//      four producer warps, one CTA an SM, as K6's); at K = 5 every thread
//      builds, then consumes (two CTAs an SM, as K5's: the K·R complex sums
//      leave no registers for more targets);
//   3. the filter y = contrib · W, a tiled product that reads W once per 128
//      rows (panel_gemm.cuh, K5's and K6's), split over j into slices that
//      fill one wave of two CTAs an SM, their partial sums added in slice
//      order by a second kernel (64 row tiles at the serving shape would
//      leave half the SMs idle).
//
// Every output has one writer and every sum a fixed order (panels in window
// order, sources ascending, j ascending): no atomics, two calls agree
// bitwise.  f32 FMA only, f32 sums.
//
// What bounds it.  At the serving shape N=8192, TB=128, nh=1, C=O=32, K=5,
// R=6 one call moves ~214 MB (stencil 201 MB, g 10.5 MB, W 0.5 MB, y 2 MB:
// 0.064 ms at 3.35 TB/s).  The work the data needs is 4.36 GFLOP: only
// D/W' = 1/3 of the slots hold an edge, each with two nonzero radial
// weights; h_k is formed once per occupied slot (6C flops per k) and added
// once per nonzero ring (4C per k), plus 2 GFLOP for W: 0.065 ms at 67
// TFLOP/s f32, so the bound is operations, barely above the bytes (counted
// by chip_smoke.py::k1_bound from the run's stencil).  This version also
// reads the hat planes twice (occupancy, then at occupied slots), writes
// and reads back contrib (63 MB at that shape), and its walk stays bound by
// its consumers' per-slot sums (every ring of the instantiation, RMAX FMAs
// a slot and k; only two hats are nonzero) and the latency of its
// per-panel steps.  Measured on an H100 at that shape: 0.42 ms, the walk
// 0.30 of it, the filter 0.09 (chip_smoke.py; PERF.md).

#include "band_call.cuh"

// Floats of the scratch buffer band_fused_fwd needs for these sizes (0 for
// sizes it does not take).
extern "C" long long band_fused_fwd_scratch_floats(int n_mesh, int N, int C,
                                                   int K, int R, int TB,
                                                   int nh, int O2)
{
    if (!bandpipe::shapes_supported(n_mesh, N, C, K, R, TB, nh, O2))
        return 0;
    return bandcall::fwd_scratch_floats(
        n_mesh, C, K, R, O2, bandpipe::band_geo(N, TB, nh, R + 2 * K));
}

// Launches the three kernels on `stream` and returns cudaGetLastError() (0
// on success), or cudaErrorInvalidValue for shapes they do not take (K > 5,
// i.e. band limit > 2; R > 8, or R > 6 with K > 3; C > 256; N not a
// multiple of TB).  scratch holds band_fused_fwd_scratch_floats floats,
// owned by the caller.
extern "C" int band_fused_fwd(const float* g, const float* sten,
                              const float* wmat, float* y, float* scratch,
                              int n_mesh, int N, int C, int K, int R, int TB,
                              int nh, int O2, void* stream)
{
    if (!bandpipe::shapes_supported(n_mesh, N, C, K, R, TB, nh, O2))
        return (int)cudaErrorInvalidValue;
    return bandcall::fused_fwd<false>(
        g, sten, wmat, y, scratch, n_mesh, C, K, R, O2,
        bandpipe::band_geo(N, TB, nh, R + 2 * K), (cudaStream_t)stream);
}
