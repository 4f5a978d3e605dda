// Compact field-conv backward (K6 bwd) for Hopper, sm_90a.
//
// Replaces the TPU kernel fieldconv_tpu/ops/pallas/band_conv.py::
// _band_compact_bwd_impl (pallas_call at :2084, body _bwd_compact_kernel)
// and the segment_sum that folds its per-panel dG blocks onto vertices in
// _band_compact's VJP (:2118).  Python wrapper and plain PyTorch version:
// fieldconv_tpu_torch/ops/band_conv.py (band_compact_bwd,
// band_compact_bwd_reference).
//
// What it computes.  With g (n_g, M), W, the compact stencil (P, 5, TBt,
// TS), meta and src_idx as in the forward (band_compact_fwd.cu), S_k =
// hats_r ⊙ f_k per ring, contrib the forward's sum (R·M per target row),
// dy (nb_out·TBt, O2) the output cotangent, and for panel p of target
// block b = meta[0, p] whose column s reads row v = src_idx[p, s]:
//
//   dc[b·TBt + t]  = dy[b·TBt + t] · W_rᵀ                      (per ring r)
//   dW            += contrib[b·TBt + t]ᵀ · dy[b·TBt + t]        (all rows)
//   dgg[p·TS + s]  = Σ_t Σ_r Σ_k S_k[r, t, s]ᵀ ⊛ dc[b·TBt + t, r, k]
//                    re  S_re·d_re + S_im·d_im,  im  S_re·d_im − S_im·d_re
//   dg[v]          = Σ_{(p, s) : src_idx[p, s] = v} dgg[p·TS + s]    (fold)
//
// Outputs dg (n_g, M) and dw (R, M, O2), f32; a row that no live column
// reads gets zeros.  The stencil is f32 or bf16, each element read as f32
// (sten_load.cuh).
//
// Design.  Five passes over one scratch buffer owned by the caller
// (band_compact_bwd_scratch_floats), every sum with one owner and a fixed
// order (no atomics: two calls on the same inputs agree bitwise):
//
//   1. contrib of every target row, rematerialised as K6's forward forms
//      it (panel_walk.cuh's walk with GATHER; panel_bwd.cuh, shared with
//      K5's backward), written as (rows, R·M);
//   2. dW = Σ_rows contribᵀ·dy (dw_rows.cuh's slice partials and combine);
//   3. dc = dy·Wᵀ written over contrib (panel_bwd.cuh);
//   4. dG per panel.  Each panel owns its columns, so their dgg rows are
//      written once each, where K5 walks panels by source and gathers dc
//      per slot through L2.  A CTA takes one target block and a slice of
//      cs ≤ 32 channels (all C where the stage fits) and stages the dc
//      rows of the block's ≤ 32 target rows (its slice of channels) in
//      shared memory once for the block's run of panels (~2.3 at 163k);
//      then each warp walks its own columns of those panels with no
//      barrier between them: lane t forms the hats of target slot t in one
//      ballot, and where occupied its f_k (the other planes read only
//      there) into the warp's shared rows, once for all channels; the
//      lanes, 32 / cs groups of cs channels, take the occupied rows in
//      turn, form u_k = Σ_r hats_r·dc[t, r, k] from the stage and add f_k
//      ⊛ u_k, and the groups' sums are added in group order.  At TBt 32,
//      K = 3, R = 3, C = 32 the stage is 73.7 KB; at K = 5, R = 6, C = 48
//      the channels are cut into slices of 12 (92 KB each);
//   5. the fold of dgg onto dg (compact_fold.cuh): one thread per (row,
//      channel) sums its row's run of the table's fold index in ascending
//      column order.
//
// Panels: TBt ≤ 32 (a column's targets in one ballot; the pure-panel
// layout's compact convs run at TBt 32, TS 128), any TS.  Hats and phasor
// powers are formed uncontracted and correctly rounded in the plain
// version's order, as in K5.
//
// What bounds it.  The function needs the r plane whole and the other
// planes only in the 32-byte sectors that hold an occupied slot, src_idx,
// the rows of g that live columns read, dy, W, and dg and dW written once;
// its operations are the occupied-slot work of contrib and of dG and
// 2·rows·R·M·O2 each for dc and dW (chip_smoke.py::k6_bwd_bound counts
// both from the run's table).  This version also writes and reads back
// contrib and dc (0.38 GB each at 163,968 rows, C = 32, K = 3, R = 3) and
// dgg (P·TS·M floats, 1.18 GB at 11,975 panels and M = 192), and reads the
// stencil twice; tensor cores, TMA and fusing the passes are left to
// later work.

#include "compact_fold.cuh"
#include "dw_rows.cuh"
#include "panel_bwd.cuh"
#include "panel_walk.cuh"

#include <algorithm>
#include <cstddef>

namespace {

using panel::kMaxThreads;
using panel::Knots;

constexpr int kMaxTargets = 32;          // a panel's target rows: one ballot
constexpr size_t kStageFloats = 24576;   // staged dc per CTA (96 KB)

// --- pass 4: dG per panel -------------------------------------------------------------

// One occupied slot of a thread's column: its channel of the staged dc
// row d ([r][k][re, im][cs]), u_k = Σ_r hats_r·dc[r, k], and dG_k += f_k ⊛
// u_k.
template <int KMAX, int RMAX>
__device__ __forceinline__ void dg_slot(
    float (&gre)[KMAX], float (&gim)[KMAX], const float* d, const float* cf,
    int K, int R, int cs)
{
    float hs[RMAX];
#pragma unroll
    for (int r = 0; r < RMAX; ++r) hs[r] = r < R ? cf[r] : 0.f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
        if (k < K) {
            float ur = 0.f, ui = 0.f;
#pragma unroll
            for (int r = 0; r < RMAX; ++r) {
                if (r < R) {
                    const float* dk = d + ((size_t)(r * K + k) * 2) * cs;
                    ur = fmaf(hs[r], dk[0], ur);
                    ui = fmaf(hs[r], dk[cs], ui);
                }
            }
            const float fr = cf[R + 2 * k];
            const float fi = cf[R + 2 * k + 1];
            gre[k] = fmaf(fr, ur, fmaf(fi, ui, gre[k]));
            gim[k] = fmaf(fr, ui, fmaf(-fi, ur, gim[k]));
        }
    }
}

// A CTA per (target block, channel slice of cs ≤ 32 channels), THREADS
// threads.  It stages the block's dc rows once for its run of panels (by
// cp.async, all in flight at once); then each warp walks its own columns
// of those panels, j = warp, warp + nwarps, ... over the run, with no
// barrier between them: lane t takes target row t of the column (TBt ≤
// 32: one ballot), forms its slot's coefficients where occupied into the
// warp's rows of shared memory, and the warp's lanes, nsub = 32 / cs
// groups of cs channels, then share out the occupied rows in ascending
// order (group g takes the g-th of every nsub) and add the groups' sums
// in group order at the end.  smem as make_plan counts it (smem4).
template <int KMAX, int RMAX, int THREADS, int MINB, typename ST>
__global__ void __launch_bounds__(THREADS, MINB)
compact_dg_kernel(const float* __restrict__ dc,
                  const ST* __restrict__ sten,
                  const int* __restrict__ meta,
                  float* __restrict__ dgg,
                  int P, int C, int K, int R, int TBt, int TS, int cs,
                  Knots kn)
{
    const int M = 2 * K * C;
    const int RM = R * M;
    const int NC = R + 2 * K;                // coefficients per occupied slot
    const int KP = 2 * K;                    // (k, re / im) pairs of a ring
    const int row_floats = R * KP * cs;      // a staged target row
    const int blk = blockIdx.x;
    const int c0 = blockIdx.y * cs;
    const int ncs = min(cs, C - c0);         // channels of this slice
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    constexpr int kWarps = THREADS / 32;
    const int nsub = 32 / cs;
    const int sub = lane / cs, cl = lane % cs;
    const bool active = sub < nsub && cl < ncs;

    extern __shared__ __align__(16) float smem[];
    float* dcs = smem;                                       // [TBt][R][K][2][cs]
    float* cfw = dcs + (size_t)TBt * row_floats + (size_t)warp * 32 * NC;

    const int p_lo = panel::lower_bound(meta, P, blk);
    const int p_hi = panel::lower_bound(meta, P, blk + 1);
    if (p_lo == p_hi) return;                // no panel: nothing to write
    // the block's dc rows, this slice of channels, a run of cs channels a
    // warp at a time
    for (int q = warp; q < TBt * R * KP; q += kWarps) {     // (t·R + r)·KP + kp
        const int t = q / (R * KP), r = (q / KP) % R, kp = q % KP;
        const float* src = dc + ((size_t)blk * TBt + t) * RM + r * M
                           + kp * C + c0;
        for (int c = lane; c < cs; c += 32)
            band::copy_async<4>(dcs + (size_t)q * cs + c,
                                c < ncs ? src + c : dc, c < ncs);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();

    const size_t plane = (size_t)TBt * TS;
    for (int j = warp; j < (p_hi - p_lo) * TS; j += kWarps) {
        const int p = p_lo + j / TS, s = j % TS;
        const ST* sp = sten + (size_t)p * 5 * plane;
        const int t = lane;
        float h[RMAX];
        const float rv = t < TBt ? load_sten(sp, (size_t)t * TS + s) : 0.f;
        bool occ = false;
#pragma unroll
        for (int r = 0; r < RMAX; ++r) {
            h[r] = (r < R && t < TBt) ? panel::hat(rv, r, kn) : 0.f;
            occ |= h[r] != 0.f;
        }
        if (occ)
            panel::slot_coefs<RMAX, ST>(cfw + t * NC, h, sp,
                                        (size_t)t * TS + s, plane, R, K, 1);
        unsigned left = __ballot_sync(0xffffffffu, occ);
        __syncwarp();                        // the coefficients are written
        float gre[KMAX], gim[KMAX];
#pragma unroll
        for (int k = 0; k < KMAX; ++k) { gre[k] = 0.f; gim[k] = 0.f; }
        while (left) {
            int mine = -1;                   // this group's next row
            for (int g = 0; g < nsub && left; ++g) {
                const int tt = __ffs(left) - 1;
                left &= left - 1;
                if (g == sub) mine = tt;
            }
            if (active && mine >= 0)
                dg_slot<KMAX, RMAX>(gre, gim,
                                    dcs + (size_t)mine * row_floats + cl,
                                    cfw + mine * NC, K, R, cs);
        }
        for (int g = 1; g < nsub; ++g) {
#pragma unroll
            for (int k = 0; k < KMAX; ++k) {
                const float are = __shfl_sync(0xffffffffu, gre[k], cl + g * cs);
                const float aim = __shfl_sync(0xffffffffu, gim[k], cl + g * cs);
                if (sub == 0) { gre[k] += are; gim[k] += aim; }
            }
        }
        if (active && sub == 0) {
            float* o = dgg + ((size_t)p * TS + s) * M + c0 + cl;
#pragma unroll
            for (int k = 0; k < KMAX; ++k)
                if (k < K) {
                    o[k * 2 * C] = gre[k];
                    o[k * 2 * C + C] = gim[k];
                }
        }
        __syncwarp();                        // the coefficients are read
    }
}

// --- launch ------------------------------------------------------------------------

size_t round4(size_t n) { return (n + 3) / 4 * 4; }

// How one call is cut up, and where its scratch lies in the buffer the
// caller owns (floats, 16-byte aligned): contrib, then dc over it; the dW
// partials; dgg.
struct Plan {
    int T, nthr1, cs, slices;
    band::DwSlices dws;
    size_t smem1, smem4, part_at, dgg_at, floats;
};

// pass 4's threads: 16 warps at K ≤ 3 (64 registers a thread, two CTAs
// an SM), 8 at K = 5
constexpr int dg_threads(int K) { return K <= 3 ? 512 : 256; }

bool shapes_supported(int P, int nb_out, int C, int K, int R, int TBt,
                      int TS, int O2)
{
    return P >= 1 && nb_out >= 1 && C >= 1 && C <= kMaxThreads && K >= 1
        && K % 2 == 1 && K <= 5 && R >= 2 && R <= (K <= 3 ? 3 : 6)
        && TBt >= 1 && TBt <= kMaxTargets && TS >= 1 && O2 >= 1;
}

cudaError_t make_plan(int P, int nb_out, int C, int K, int R, int TBt,
                      int TS, int O2, Plan* pl)
{
    int dev = 0, limit = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return err;
    pl->T = std::min(panel::kTile, std::max(1, kMaxThreads / C));
    pl->nthr1 = panel::threads_for(pl->T, C);
    pl->smem1 = panel::list_floats(K, R, TS, pl->T) * sizeof(float);
    // pass 4: the fewest slices of at most 32 channels whose staged dc
    // fits kStageFloats
    const size_t per_channel = (size_t)TBt * R * 2 * K;
    int slices = (C + 31) / 32;
    while ((C + slices - 1) / slices > 1
           && per_channel * ((C + slices - 1) / slices) > kStageFloats)
        ++slices;
    pl->cs = (C + slices - 1) / slices;
    pl->slices = (C + pl->cs - 1) / pl->cs;
    pl->smem4 = (per_channel * pl->cs + (size_t)dg_threads(K) * (R + 2 * K))
                * sizeof(float);
    if (pl->smem1 > (size_t)limit || pl->smem4 > (size_t)limit)
        return cudaErrorInvalidValue;
    const long long rows = (long long)nb_out * TBt;
    const int RM = R * 2 * K * C;
    pl->dws = band::dw_slices(rows, RM, O2, sms);
    pl->part_at = round4((size_t)rows * RM);
    pl->dgg_at = round4(pl->part_at + (size_t)pl->dws.slices * RM * O2);
    pl->floats = pl->dgg_at + (size_t)P * TS * 2 * K * C;
    return cudaSuccess;
}

template <int KMAX, int RMAX, int MINB, typename ST>
int launch(const float* dy, const float* g, const float* wmat,
           const ST* sten, const int* meta, const int* src_idx,
           const int* fold_order, const int* fold_ptr, float* dg, float* dw,
           float* scratch, int P, int nb_out, int C, int K, int R, int TBt,
           int TS, int O2, int n_g, const Plan& pl, cudaStream_t stream)
{
    const Knots kn = panel::ring_knots(R);
    const int rows = nb_out * TBt;
    const int M = 2 * K * C;
    const int RM = R * M;
    const int tiles = (TBt + pl.T - 1) / pl.T;
    float* contrib = scratch;                // then dc, same layout
    float* part = scratch + pl.part_at;
    float* dgg = scratch + pl.dgg_at;

    auto k1 = panel::bwd_contrib_kernel<KMAX, RMAX, MINB, true, ST>;
    cudaError_t err = cudaFuncSetAttribute(
        k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem1);
    if (err != cudaSuccess) return (int)err;
    k1<<<(unsigned)((long)nb_out * tiles), pl.nthr1, pl.smem1, stream>>>(
        g, sten, meta, contrib, P, C, K, R, TBt, 1, n_g / TBt, pl.T, kn,
        src_idx, TS);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

    err = band::launch_dw(contrib, dy, part, dw, rows, RM, O2, pl.dws,
                          stream);
    if (err != cudaSuccess) return (int)err;

    err = panel::launch_dc(dy, wmat, contrib, rows, RM, O2, stream);
    if (err != cudaSuccess) return (int)err;

    constexpr int kThreads4 = dg_threads(KMAX);
    auto k4 = compact_dg_kernel<KMAX, RMAX, kThreads4, KMAX <= 3 ? 2 : 1,
                                ST>;
    err = cudaFuncSetAttribute(
        k4, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem4);
    if (err != cudaSuccess) return (int)err;
    k4<<<dim3((unsigned)nb_out, (unsigned)pl.slices), kThreads4, pl.smem4,
         stream>>>(contrib, sten, meta, dgg, P, C, K, R, TBt, TS, pl.cs, kn);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

    return (int)fold::launch_fold(dgg, fold_order, fold_ptr, dg, n_g, M,
                                  stream);
}

// The instantiation for (K, R): K ≤ 3 with R ≤ 3, or K = 5 with R ≤ 6.
template <typename ST>
int launch_for(const float* dy, const float* g, const float* wmat,
               const void* sten, const int* meta, const int* src_idx,
               const int* fold_order, const int* fold_ptr, float* dg,
               float* dw, float* scratch, int P, int nb_out, int C, int K,
               int R, int TBt, int TS, int O2, int n_g, const Plan& pl,
               cudaStream_t s)
{
    const ST* st = static_cast<const ST*>(sten);
    if (K <= 3)
        return launch<3, 3, 5>(dy, g, wmat, st, meta, src_idx, fold_order,
                               fold_ptr, dg, dw, scratch, P, nb_out, C, K, R,
                               TBt, TS, O2, n_g, pl, s);
    return launch<5, 6, 2>(dy, g, wmat, st, meta, src_idx, fold_order,
                           fold_ptr, dg, dw, scratch, P, nb_out, C, K, R, TBt,
                           TS, O2, n_g, pl, s);
}

}  // namespace

// Floats of the scratch buffer band_compact_bwd needs for these sizes (0
// for sizes it does not take).
extern "C" long long band_compact_bwd_scratch_floats(int P, int nb_out,
                                                     int C, int K, int R,
                                                     int TBt, int TS, int O2)
{
    Plan pl;
    if (!shapes_supported(P, nb_out, C, K, R, TBt, TS, O2)
        || make_plan(P, nb_out, C, K, R, TBt, TS, O2, &pl) != cudaSuccess)
        return 0;
    return (long long)pl.floats;
}

// Launches the five passes (six kernels) on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for shapes
// they do not take (the forward's: K odd ≤ 5, R ≤ 3 with K ≤ 3 or R ≤ 6
// with K = 5, R ≥ 2, C ≤ 256; and TBt ≤ 32; n_g a multiple of TBt; or
// lists above the shared memory a CTA can have).  dy: (nb_out·TBt, O2);
// g, dg: (n_g, M); fold_order and fold_ptr (n_g + 1) the table's fold
// index; scratch holds band_compact_bwd_scratch_floats floats, owned by
// the caller; sten float32, or bfloat16 when sten_bf16 is set.
extern "C" int band_compact_bwd(const float* dy, const float* g,
                                const float* wmat, const void* sten,
                                const int* meta, const int* src_idx,
                                const int* fold_order, const int* fold_ptr,
                                float* dg, float* dw, float* scratch, int P,
                                int nb_out, int C, int K, int R, int TBt,
                                int TS, int O2, int n_g, int sten_bf16,
                                void* stream)
{
    if (!shapes_supported(P, nb_out, C, K, R, TBt, TS, O2) || n_g < TBt
        || n_g % TBt)
        return (int)cudaErrorInvalidValue;
    Plan pl;
    const cudaError_t err = make_plan(P, nb_out, C, K, R, TBt, TS, O2, &pl);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = (cudaStream_t)stream;
    if (sten_bf16)
        return launch_for<__nv_bfloat16>(dy, g, wmat, sten, meta, src_idx,
                                         fold_order, fold_ptr, dg, dw,
                                         scratch, P, nb_out, C, K, R, TBt, TS,
                                         O2, n_g, pl, s);
    return launch_for<float>(dy, g, wmat, sten, meta, src_idx, fold_order,
                             fold_ptr, dg, dw, scratch, P, nb_out, C, K, R,
                             TBt, TS, O2, n_g, pl, s);
}
