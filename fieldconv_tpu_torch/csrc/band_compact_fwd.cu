// Compact field-conv forward (K6) for Hopper, sm_90a.
//
// Replaces the TPU kernel fieldconv_tpu/ops/pallas/band_conv.py::
// _band_compact_fwd_impl (pallas_call at :2042, body _fwd_compact_kernel
// at :1953 with _panel_accum_rect and _apply_w; the row gather g[src_idx]
// of _band_compact, :2097, is done in place, see below).  Python wrapper
// and plain PyTorch version: fieldconv_tpu_torch/ops/band_conv.py
// (band_compact_fwd, band_compact_fwd_reference).
//
// What it computes (float32, complex values planar; the stencil float32
// or bfloat16, each element read as f32).  Inputs: the k-major
// rotated-source tensor g (n_g, M = K·2C); W = filters_to_wmat (R, M,
// O2), 1/K inside; the compact panel stencil sten (P, 5, TBt, TS), rows
// the target slot t, columns the compact column s, planes r, e^{iθ}
// re/im, wxp re/im (r = R_SENTINEL at empty slots and dead columns); meta
// (4, P) int32 rows (tgt, panel id, first, last), sorted by target, panel
// p's planes at sten[p]; src_idx (P, TS) int32, the source row of each
// column.  For every panel p of target block b, slot (t, s), ring r, k and
// channel c, with v = src_idx[p, s]:
//
//   contrib[b, r, t, k, c] += hats_r(t, s) · (f_k(t, s) ⊗ g[v, k, c])
//   y[b·TBt + t, o] = Σ_r Σ_j contrib[b, r, t, j] · W[r, j, o]
//
// A column whose source row lies outside [0, n_g) adds nothing; a target
// block with no panel gets zeros.
//
// Design.  K5's forward (band_panel_fwd.cu) with a gathered far side: two
// kernels.  (1) contrib of every target row by panel_pipe.cuh's by-target
// walk with GATHER (compact_contrib_kernel), written to a scratch buffer
// the caller owns (rows, R·M).  A CTA owns a tile of targets of one block
// and walks the block's run of panels (meta's target row).  The tile's
// rows of a panel's r plane (T rows of TS contiguous slots) arrive by one
// bulk copy on the stage ring ahead of use; each column's word of occupied
// target rows is formed from it (a column reading a row outside [0, n_g)
// none); then in passes of up to 32 columns, each far row of g (src_idx's
// row of a column any of the tile's targets uses) is staged once per tile
// and panel by a bulk copy, the pass's occupied slots are numbered so that
// every lane builds one (hats from the staged r, e^{iθ} and wxp copied at
// that slot only), and each (target, channels) thread sums in registers.
// At K ≤ 3 the walk is warp-specialized, one CTA an SM: four producer
// warps build the passes while 512 consumer threads sum them, a tile is a
// whole 32-row block at C = 32 (each panel walked once), and a consumer
// thread sums two channels (float2 reads of g) on an f32 stencil at even
// C ≥ 32; at K = 5 it is K5's walk, every thread building and summing in
// turn, two CTAs of 256 threads an SM.  The JAX package's gathered copy gg
// (P·TS, M) is never formed.  (2) The filter, y = contrib · W
// (panel_gemm.cuh::filter_kernel, K5's), a tiled product that reads W once
// per 128 rows.  Every output has one writer and every sum a fixed order
// (panels in run order, columns ascending, j ascending): no atomics, two
// calls agree bitwise.  Hats and phasor powers are formed uncontracted and
// correctly rounded in the plain version's order.
//
// The version before this one ran the walk K5 dropped as latency bound: a
// CTA of 8 targets, one warp compacting each target row per panel behind
// two barriers, every (target, channel) thread reading its channel of g
// from L2 once per slot (a source row read once per target that uses it:
// ~8 GB of L2 reads a call at 163,842 samples, C = 32), and the filter in
// the CTA, which read all of W from L2 for every tile of 8 targets (~3 GB
// a call).  Staging each far row once per tile and panel, and the filter
// as a GEMM, remove both.  Measured slower on an H100 at 163,842 samples
// and dropped: K5's walk as it is at K = 3 (two CTAs an SM, 16-target
// tiles: 2.42 against 2.24 ms of contrib at C = 32, f32), and on it a pass
// step forming each slot's f_k once before the sums (faster on f32, 0.4 ms
// slower on bf16), 32-target tiles of 512 threads, 4 targets a thread,
// three pass buffers, two slots a step; warp-specialized at K = 5 (its
// 5-target tiles: 3.4x slower than K5's walk); two channels a thread at
// C = 16 or on bf16.  The walk's speed moves with the consumer's code
// form (panel_pipe.cuh::consume_compact, kept for bf16 stencils).
//
// What bounds it.  The function needs the r plane whole and the other
// planes only in the 32-byte sectors that hold an occupied slot, src_idx,
// the rows of g that live columns name, W, meta and y once; its operations
// are the occupied-slot work and the filter contraction 2·N·R·M·O2
// (chip_smoke.py::k6_bound counts both from the run's table).  This
// version also writes and reads back contrib (0.38 GB at 163,968 rows, C =
// 32, K = 3, R = 3), and the walk stays bound by the latency of its
// per-panel steps (masks, numbering, staging), not by bytes or operations.
//
// Registers and spills (-Xptxas -v, sm_90a): compact_contrib_kernel <K,
// R, targets a thread, channels a thread>, warp-specialized (640 threads,
// one CTA an SM, at most 102 registers): f32 <3,3,1,2> 82 registers and
// <3,6,1,2> 96 with 20 bytes of spill stores (the two-channel forms, C =
// 32 to 62), <3,3,1,1> 84, <3,3,2,1> 82, <3,6,1,1> 84, none, <3,6,2,1> 96
// with 32 bytes; bf16 <3,3,1,1> 84, <3,3,2,1> 86, <3,6,1,1> 84, none,
// <3,6,2,1> 96 with 116 bytes; K5's walk at K = 5 (two CTAs of 256
// threads an SM) <5,6,1,1> 126 (f32) and 128 (bf16), none; filter_kernel
// 127, none.  The walk's dynamic shared memory is planned per call
// (panel_pipe.cuh::contrib_plan: within 227 KB warp-specialized, 113 KB
// at K = 5).

#include "panel_gemm.cuh"
#include "panel_pipe.cuh"

#include <cstddef>

// Floats of the scratch buffer band_compact_fwd needs (contrib of every
// target row).
extern "C" long long band_compact_fwd_scratch_floats(int nb_out, int C,
                                                     int K, int R, int TBt)
{
    return (long long)nb_out * TBt * R * 2 * K * C;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for shapes the kernels do not take (K even or
// > 5; R < 2 or > 6; C > 256; TBt or TS > 128; n_g not a multiple of TBt;
// a walk above the shared memory a CTA can have).  y: (nb_out·TBt, O2);
// g: (n_g, M); scratch holds band_compact_fwd_scratch_floats floats, owned
// by the caller; sten float32, or bfloat16 when sten_bf16 is set.
extern "C" int band_compact_fwd(const float* g, const float* wmat,
                                const void* sten, const int* meta,
                                const int* src_idx, float* y, float* scratch,
                                int P, int nb_out, int C, int K, int R,
                                int TBt, int TS, int O2, int n_g,
                                int sten_bf16, void* stream)
{
    if (P < 1 || nb_out < 1 || C < 1 || C > pipe::kThreads || K < 1
        || K % 2 == 0 || K > 5 || R < 2 || R > panel::kMaxRings || TBt < 1
        || TBt > pipe::kMaxTB || TS < 1 || TS > pipe::kMaxTB || O2 < 1
        || n_g < TBt || n_g % TBt)
        return (int)cudaErrorInvalidValue;
    int dev = 0, limit = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    pipe::Plan pl;
    if (!pipe::contrib_plan(C, K, R, TBt, TS, 1, sten_bf16 ? 2 : 4, g, sten,
                            limit, &pl, true))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    err = sten_bf16
        ? pipe::launch_contrib<__nv_bfloat16, true>(
              g, static_cast<const __nv_bfloat16*>(sten), meta, scratch, P,
              nb_out, C, K, R, TBt, 1, n_g, pl, s, src_idx)
        : pipe::launch_contrib<float, true>(
              g, static_cast<const float*>(sten), meta, scratch, P, nb_out,
              C, K, R, TBt, 1, n_g, pl, s, src_idx);
    if (err != cudaSuccess) return (int)err;
    return (int)panel::launch_filter(scratch, wmat, y, nb_out * TBt,
                                     R * 2 * K * C, O2, s);
}
