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
// with no panel gets zeros (build_panel_table gives every block one).
//
// Design.  The TPU kernel keeps a block's contrib (R·TB × M, 295 KB at the
// correspondence widths) in VMEM across its panels and applies W at the
// last one.  That does not fit a CTA's shared memory, so here a CTA owns a
// tile of T = min(8, 256 / C) targets of one block, one thread per (target,
// channel) with its K·R complex sums in registers (K1's forward design,
// band_fused_fwd.cu), and walks the block's contiguous run of panels, whose
// bounds it finds by binary search in meta's tgt row.  The pure-panel table
// of a large mesh is ~4% occupied (10.7M edges in 16,941·128² slots at
// 163,842 vertices), so per panel one warp per target row compacts the
// row's occupied slots (any radial hat nonzero: skipping the others is
// exact) into shared memory, once for all channels: the R hats, the K
// complex f_k and the source slot.  Only the r plane (or the hat planes) is
// read for every slot; the other planes only where a slot is occupied.  Each
// thread then walks its target's list, reads its channel of the source row
// of g (coalesced across the channels of a warp, through L2) and accumulates
// 2K·(3 + 2R) flops per slot.  The filter contraction then reads the tile's
// contrib from shared memory against W, as K1's does.  Each output has one
// writer and every sum a fixed order, so two calls agree bitwise (no
// atomics).  The hats and the phasor powers are formed with uncontracted,
// correctly rounded operations in the plain version's order.  The panel
// walk and the filter stage live in panel_walk.cuh: K5's backward
// (band_panel_bwd.cu) rematerialises contrib with the walk, and K6's
// forward (band_compact_fwd.cu) runs both over gathered columns.
//
// What bounds it.  The function needs the r plane (or the hat planes) whole
// and the other planes only in the 32-byte sectors that hold an occupied
// slot, plus g, W and y once; its operations are the occupied-slot work
// and the filter contraction.  chip_smoke.py::k5_bound counts both from
// the run's table: bytes bound it at the correspondence widths, operations
// at the segmentation width.  The kernel reads what the function needs;
// its own cost beyond that is the dependent gather of g per slot (one L2
// round trip per slot and thread), the per-panel compaction behind two
// barriers, and W, read from L2 once per tile of targets.  It makes no use
// of tensor cores.

#include "panel_walk.cuh"

#include <algorithm>
#include <cstddef>

namespace {

using panel::kMaxThreads;
using panel::kTile;
using panel::Knots;

// MINB: CTAs per SM the register budget is cut for.  Two instantiations
// serve the presets: K = 3, R = 3 (correspondence) and K = 5, R = 6
// (segmentation, classification).  The kernel is bound by the latency of
// its loads, so at the correspondence widths (18 complex sums a thread) it
// takes 5 CTAs of 48 registers; an unrolled slot or compaction loop, with
// fewer CTAs or spills, measured slower at 163,842 samples.
template <int KMAX, int RMAX, int MINB, typename ST>
__global__ void __launch_bounds__(kMaxThreads, MINB)
band_panel_fwd_kernel(const float* __restrict__ g,
                      const float* __restrict__ wmat,
                      const ST* __restrict__ sten,
                      const int* __restrict__ meta,
                      float* __restrict__ y,
                      int P, int C, int K, int R, int TB, int O2,
                      int compressed, int nb_g, int T, Knots kn)
{
    const int tiles = (TB + T - 1) / T;
    const int blk = blockIdx.x / tiles;
    const int t0 = (blockIdx.x % tiles) * T;
    const int nt = min(T, TB - t0);
    const int tid = threadIdx.x;
    const bool active = tid < nt * C;
    const int it = active ? tid / C : 0;     // (target, channel) of a thread
    const int ic = active ? tid % C : 0;

    extern __shared__ __align__(16) float smem[];
    float are[KMAX][RMAX], aim[KMAX][RMAX];
    panel::panel_contrib<KMAX, RMAX, false, ST>(
        are, aim, smem, g, sten, meta, P, C, K, R, TB, compressed, nb_g, T,
        blk, t0, nt, active, it, ic, kn);

    panel::filter_tile<KMAX, RMAX>(are, aim, smem, wmat, y, blk, TB, t0, C,
                                   K, R, O2, T, nt, active, it, ic);
}

template <int KMAX, int RMAX, int MINB, typename ST>
int launch(const float* g, const float* wmat, const ST* sten,
           const int* meta, float* y, int P, int nb_out, int C, int K, int R,
           int TB, int O2, int compressed, int nb_g, int T, int nthr,
           size_t smem, const Knots& kn, cudaStream_t stream)
{
    auto kernel = band_panel_fwd_kernel<KMAX, RMAX, MINB, ST>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long grid = (long)nb_out * ((TB + T - 1) / T);
    kernel<<<(unsigned)grid, nthr, smem, stream>>>(
        g, wmat, sten, meta, y, P, C, K, R, TB, O2, compressed, nb_g, T, kn);
    return (int)cudaGetLastError();
}

// The instantiation for (K, R): K ≤ 3 with R ≤ 3, or K = 5 with R ≤ 6.
template <typename ST>
int launch_for(const float* g, const float* wmat, const void* sten,
               const int* meta, float* y, int P, int nb_out, int C, int K,
               int R, int TB, int O2, int compressed, int nb_g, int T,
               int nthr, size_t smem, const Knots& kn, cudaStream_t s)
{
    const ST* st = static_cast<const ST*>(sten);
    if (K <= 3)
        return launch<3, 3, 5>(g, wmat, st, meta, y, P, nb_out, C, K, R, TB,
                               O2, compressed, nb_g, T, nthr, smem, kn, s);
    return launch<5, 6, 2>(g, wmat, st, meta, y, P, nb_out, C, K, R, TB, O2,
                           compressed, nb_g, T, nthr, smem, kn, s);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for shapes the kernel does not take (K even or
// > 5, i.e. band limit > 2; R > 3 with K ≤ 3, or R > 6 with K = 5: the
// presets' shapes are K = 3, R = 3 and K = 5, R = 6; R < 2 with compressed
// planes; C > 256; lists or the filter stage above the shared memory a CTA
// can have).  y: (nb_out·TB, O2); g: (nb_g·TB, M); sten float32, or
// bfloat16 when sten_bf16 is set.
extern "C" int band_panel_fwd(const float* g, const float* wmat,
                              const void* sten, const int* meta, float* y,
                              int P, int nb_out, int C, int K, int R, int TB,
                              int O2, int compressed, int nb_g, int sten_bf16,
                              void* stream)
{
    if (P < 1 || nb_out < 1 || nb_g < 1 || C < 1 || C > kMaxThreads
        || K < 1 || K % 2 == 0 || K > 5 || R < (compressed ? 2 : 1)
        || R > (K <= 3 ? 3 : 6) || TB < 1 || O2 < 1)
        return (int)cudaErrorInvalidValue;
    int dev = 0, limit = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    const int T = std::min(kTile, std::max(1, kMaxThreads / C));
    const int nthr = panel::threads_for(T, C);
    const size_t smem = panel::fwd_smem_bytes(C, K, R, TB, O2, T, nthr);
    if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
    const Knots kn = compressed ? panel::ring_knots(R) : Knots{};
    cudaStream_t s = (cudaStream_t)stream;
    if (sten_bf16)
        return launch_for<__nv_bfloat16>(g, wmat, sten, meta, y, P, nb_out,
                                         C, K, R, TB, O2, compressed, nb_g, T,
                                         nthr, smem, kn, s);
    return launch_for<float>(g, wmat, sten, meta, y, P, nb_out, C, K, R, TB,
                             O2, compressed, nb_g, T, nthr, smem, kn, s);
}
