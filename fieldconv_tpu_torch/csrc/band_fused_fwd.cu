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
// kernel never reads outside g.
//
// Design.  The TPU kernel keeps a whole block's contrib (R·TB × M, ~1 MB at
// the serving shape) and all of g in VMEM.  Here one CTA owns a tile of
// T = 256 / C targets (8 at C = 32) of one block of one mesh, and one
// thread owns one (target, channel) item with all K·R complex accumulators
// of that item in registers: per window slot it loads the R radial weights
// once and, per k, forms h_k once and applies it to every ring.  The window
// streams through shared memory in chunks of kChunk slots (the chunk's g
// rows, zero-filled outside [0, N), and the tile's stencil planes),
// double-buffered with cp.async so the next chunk loads while this one is
// computed (band_window.cuh, shared with the backward in
// band_fused_bwd.cu).  A chunk whose radial weights are all zero for the
// tile is skipped, and so is a slot whose radial weights are all zero for
// the thread's target (no edge there).  The filter contraction then reads the
// tile's contrib from shared memory (the staging buffers reused) against
// W, which is read once per CTA from L2, split over thread groups and
// reduced through shared memory.  f32 FMA only, f32 accumulation.  The kernel lives
// in band_fwd.cuh, which K4 (band_cfused_fwd.cu) shares.
//
// What bounds it.  At the serving shape N=8192, TB=128, nh=1, C=O=32, K=5,
// R=6 one call moves ~214 MB (stencil 201 MB, g 10.5 MB, W 0.5 MB, y 2 MB:
// 0.064 ms at 3.35 TB/s).  The dense window would cost ~24 GFLOP plus ~2
// for W (0.39 ms at 67 TFLOP/s f32).  The work the data needs is 4.36
// GFLOP: only D/W' = 1/3 of the slots hold an edge, each with two nonzero
// radial weights; h_k is formed once per occupied slot (6C flops per k)
// and added once per nonzero ring (4C per k), plus 2 GFLOP for W: 0.065
// ms, so the bound is operations, barely above the bytes (counted by
// chip_smoke.py::k1_bound from the run's stencil).  The kernel still
// stages every slot of a non-empty chunk and re-reads the window's g rows
// once per tile of targets; staging only occupied rows and moving the
// contraction onto tensor cores are left to later work.

#include "band_fwd.cuh"

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for shapes the kernel does not take (K > 5, i.e.
// band limit > 2; R > 8, or R > 6 with K > 3; C > 256).
extern "C" int band_fused_fwd(const float* g, const float* sten,
                              const float* wmat, float* y,
                              int n_mesh, int N, int C, int K, int R, int TB,
                              int nh, int O2, void* stream)
{
    return band::fused_fwd<false>(g, sten, wmat, y, n_mesh, N, C, K, R, TB,
                                  nh, O2, (cudaStream_t)stream);
}
