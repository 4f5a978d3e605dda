// Panel field-conv forward (K5) for Hopper, sm_90a.
//
// Replaces the TPU kernel fieldconv_tpu/ops/pallas/band_conv.py::
// _band_panel_fwd_impl (pallas_call at :2187, body _fwd_panel_kernel, and at
// :2162 for chunked tables, body _fwd_panel_chunk_kernel; helpers
// _panel_pairs, _panel_accum, _apply_w).  Python wrapper and plain PyTorch
// version: fieldconv_tpu_torch/ops/band_conv.py.
//
// What it computes (float32, complex values planar; the stencil float32
// or bfloat16, each element read as f32, sten_load.cuh).  Inputs: the
// k-major rotated-source tensor g (N, M = K·2C), columns k·2C + [re C | im C];
// W = filters_to_wmat (R, M, O2), 1/K inside; the panel stencil sten
// (P, planes, TB, TB), rows the target slot t, columns the source slot s;
// meta (4, P) int32 rows (tgt, src, first, last), sorted by target.  The
// planes are compressed (5: r, e^{iθ} re/im, wxp re/im, r = R_SENTINEL at
// empty slots) or dense (R+2K: the R radial hats, then fwxp_k re/im).  For
// every panel p of target block b, slot (t, s), ring r, k and channel c:
//
//   hats_r(t, s)  from r (the hat on the ring knots, _hats_from_r) or read
//   f_k(t, s)     = wxp·e^{i(k−B)θ} by repeated multiplication with the unit
//                   phasor (_phasor_pairs), or read
//   h = f_k ⊗ g[src·TB + s, k, c]                     (complex product)
//   contrib[b, r, t, k, c] += hats_r · h              over the block's panels
//
// and at the end of the block's run y[b·TB + t, o] = Σ_r Σ_j contrib[b, r, t,
// j]·W[r, j, o].  Chunked tables (chunk > 1) only add all-zero panels to a
// target's run, so the one kernel serves both pallas_calls.  A target block
// with no panel gets zeros.
//
// Design.  Two kernels.  (1) contrib of every target row by the pipelined
// panel walk of panel_pipe.cuh, written to a scratch buffer the caller
// owns (rows, R·M): a CTA owns a tile of targets of one block (16 at
// C = 32, K = 3, R = 3, two a thread; 32 at C = 16; 5 at the segmentation
// width C = 48, K = 5, R = 6), walks the block's run with the next panels'
// r rows arriving by bulk copy, and per panel stages each source row of g
// that any of its targets needs once (a bulk copy a row), then the
// coefficients of the occupied slots (hats from the staged r, the other
// planes copied at those slots only), and sums in registers.  (2) The
// filter, y = contrib · W, a tiled product that reads W once per 128 rows
// (panel_gemm.cuh::filter_kernel, shared with K6).  Every output has one
// writer and every sum a fixed order (panels in run order, sources
// ascending, j ascending): no atomics, two calls agree bitwise.  The hats and phasor powers are formed
// with uncontracted, correctly rounded operations in the plain version's
// order.
//
// The first version of this kernel (a CTA of 8 targets, one warp
// compacting each target row per panel behind two barriers, g gathered
// from L2 once per slot and target, the filter in the CTA) was latency
// bound on that chain.  Dropped on the way here, each measured slower on
// an H100: the filter kept in the CTA (W streamed from L2 per tile of
// targets, even through shared memory: it dominated at K = 5, R = 6), 4
// targets a thread (spills at 128 registers), 512 threads and one CTA an
// SM, three pass buffers, and the walk warp-specialized for this
// direction (its consumers spill at 85 registers).
//
// What bounds it.  The function needs the r plane (or the hat planes)
// whole and the other planes only in the 32-byte sectors that hold an
// occupied slot, plus g, W and y once; its operations are the occupied-slot
// work and 2·N·R·M·O2 for the filter (chip_smoke.py::k5_bound counts both
// from the run's table).  This version also writes and reads back contrib
// (0.38 GB at 163,968 rows, C = 32, K = 3, R = 3), and the walk stays bound
// by the latency of its per-panel steps (masks, numbering, staging), not by
// bytes or operations.
//
// Registers and spills (-Xptxas -v, sm_90a, two CTAs of 256 threads an
// SM): contrib_kernel <K, R, targets a thread> <3,3,2> and <3,3,1> 128
// registers, no spills; <3,6,2> 128, 12 bytes of spill stores (f32) and 40
// (bf16); <3,6,1> 123, none; <5,6,1> 128, none; filter_kernel 127, none,
// 25.5 KB of static shared memory.  The walk's dynamic shared memory is
// planned per call within 113 KB (panel_pipe.cuh::fit_plan).

#include "panel_gemm.cuh"
#include "panel_pipe.cuh"

#include <cstddef>

// Floats of the scratch buffer band_panel_fwd needs (contrib of every
// target row).
extern "C" long long band_panel_fwd_scratch_floats(int nb_out, int C, int K,
                                                   int R, int TB)
{
    return (long long)nb_out * TB * R * 2 * K * C;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for shapes the kernel does not take (K even or
// > 5, i.e. band limit > 2; R > 6; R < 2 with compressed planes; C > 256;
// TB > 128; a walk above the shared memory a CTA can have).  y: (nb_out·
// TB, O2); g: (nb_g·TB, M); scratch holds band_panel_fwd_scratch_floats
// floats, owned by the caller; sten float32, or bfloat16 when sten_bf16 is
// set.
extern "C" int band_panel_fwd(const float* g, const float* wmat,
                              const void* sten, const int* meta, float* y,
                              float* scratch, int P, int nb_out, int C, int K,
                              int R, int TB, int O2, int compressed, int nb_g,
                              int sten_bf16, void* stream)
{
    if (P < 1 || nb_out < 1 || nb_g < 1 || C < 1 || C > pipe::kThreads
        || K < 1 || K % 2 == 0 || K > 5 || R < (compressed ? 2 : 1)
        || R > 6 || TB < 1 || TB > pipe::kMaxTB || O2 < 1)
        return (int)cudaErrorInvalidValue;
    int dev = 0, limit = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    pipe::Plan pl;
    if (!pipe::contrib_plan(C, K, R, TB, TB, compressed, sten_bf16 ? 2 : 4,
                            g, sten, limit, &pl))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    err = sten_bf16
        ? pipe::launch_contrib(g, static_cast<const __nv_bfloat16*>(sten),
                               meta, scratch, P, nb_out, C, K, R, TB,
                               compressed, nb_g, pl, s)
        : pipe::launch_contrib(g, static_cast<const float*>(sten), meta,
                               scratch, P, nb_out, C, K, R, TB, compressed,
                               nb_g, pl, s);
    if (err != cudaSuccess) return (int)err;
    return (int)panel::launch_filter(scratch, wmat, y, nb_out * TB,
                                     R * 2 * K * C, O2, s);
}
