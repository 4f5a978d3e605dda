// Panel field-conv backward (K5 bwd) for Hopper, sm_90a.
//
// Replaces the TPU kernel fieldconv_tpu/ops/pallas/band_conv.py::
// _band_panel_bwd_impl (pallas_call at :2293, body _bwd_panel_kernel, and at
// :2252 for chunked tables, body _bwd_panel_chunk_kernel).  Python wrapper
// and plain PyTorch version: fieldconv_tpu_torch/ops/band_conv.py
// (band_panel_bwd, band_panel_bwd_reference).
//
// What it computes.  With g, W, the panel stencil and its slot
// coefficients as in the forward (band_panel_fwd.cu, panel_walk.cuh):
// S_k = hats_r ⊙ f_k per ring, contrib the forward's sum (R·M per target
// row), dy (nb_out·TB, O2) the output cotangent, and per panel of target
// block t and source block s:
//
//   dc[t]  = dy[t] · W_rᵀ                           (per ring r)
//   dW    += contrib[t]ᵀ · dy[t]                    (summed over targets)
//   dG[s] += Σ_r Σ_k S_kᵀ ⊛ dc[t]:  re  S_re·d_re + S_im·d_im,
//                                   im  S_re·d_im − S_im·d_re
//
// Outputs dg (nb_g·TB, M) and dw (R, M, O2), f32; the stencil is f32 or
// bf16, each element read as f32 (sten_load.cuh).  A source block with no
// panel in meta_s gets zeros in dg (the TPU kernel leaves it unwritten).
// Chunked tables (chunk > 1) only pad source runs with all-zero panels, so
// one kernel serves both pallas_calls.
//
// Design.  The TPU kernel walks meta_s (the panels sorted by source) in
// order, rebuilds each panel's partial contrib and dc of its target block,
// accumulates dG of the source block in VMEM until its last panel, and sums
// dW in a revisited output block: both sums rely on its sequential grid.
// Here blocks run in parallel, so every sum has one owner and a fixed order
// (no atomics: two calls on the same inputs agree bitwise), and the call is
// four passes over one scratch buffer owned by the caller
// (band_panel_bwd_scratch_floats):
//
//   1. contrib of every target row, rematerialised exactly as the forward
//      forms it (panel_walk.cuh over meta, the target order; only g, W and
//      the stencil are kept from the forward, as in JAX), written to
//      scratch as (rows, R·M) (panel_bwd.cuh, shared with K6's backward);
//   2. dW = Σ_rows contribᵀ·dy: per-slice partials and a combine in slice
//      order (dw_rows.cuh, K1's backward passes 3-4);
//   3. dc = dy·Wᵀ, a tiled product written over contrib, same layout
//      (panel_bwd.cuh);
//   4. dG by source: a CTA owns a tile of T = min(8, 256 / C) source rows
//      of one source block, one thread per (source, channel) with its K
//      complex dG sums in registers, and walks the block's run of meta_s
//      (bounds by binary search on its src row).  Per panel it stages the
//      r plane's (or the hat planes') columns of its sources through shared
//      memory, whole rows of 32-byte sectors, then one warp per source
//      column compacts the occupied target slots of that column once for
//      all channels (hats, f_k from the other planes only where occupied,
//      target slot).  Each thread walks its column's list: per slot it
//      forms u_k = Σ_r hats_r·dc[t, r, k] from its channel of the target's
//      dc row (coalesced across the channels of a warp) and adds f_k ⊛ u_k.
//      dG is written once per row.
//
// What bounds it.  The function needs the r plane (or the hat planes)
// whole and the other planes only in the 32-byte sectors that hold an
// occupied slot, plus g, dy, W, meta_s, dg and dW once; its operations are
// the occupied-slot work of contrib and of dG and 2·rows·R·M·O2 each for
// dc and dW (chip_smoke.py::k5_bwd_bound counts both from the run's
// table).  This version also writes and reads back contrib and dc (0.38 GB
// each at 163,968 rows, C = 32, K = 3, R = 3), reads the stencil twice
// (once per order), and per occupied slot and channel gathers 2·K·R floats
// of dc through L2 (K times R the forward's gather of g); tensor cores, TMA
// and fusing the passes are left to later work.

#include "dw_rows.cuh"
#include "panel_bwd.cuh"
#include "panel_walk.cuh"

#include <algorithm>
#include <cstddef>

namespace {

using panel::bwd_contrib_kernel;
using panel::kMaxThreads;
using panel::Knots;

// --- pass 4: dG gathered by source ----------------------------------------------------

// Compacts target slot t = t0 + lane of source column c (source slot s) of
// panel sp into the column's list; every lane of the warp calls it with
// its own t.  slab holds the column's whole planes: [q][TB][T].
template <int RMAX, typename ST>
__device__ __forceinline__ int compact_column(
    float* ct, int* st, int base, const float* slab,
    const ST* __restrict__ sp, int t, int s, int c, size_t plane, int TB,
    int T, int R, int K, int compressed, const Knots& kn)
{
    float h[RMAX];
    const float rv = (compressed && t < TB) ? slab[t * T + c] : 0.f;
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
        float v = 0.f;
        if (r < R && t < TB)
            v = compressed ? panel::hat(rv, r, kn)
                           : slab[((size_t)r * TB + t) * T + c];
        h[r] = v;
    }
    return panel::append_slot<RMAX, false, ST>(ct, st, base, h, sp,
                                               (size_t)t * TB + s, t, plane,
                                               R, K, compressed);
}

// One occupied slot of a thread's source: its channel of the target row dr
// of dc, u_k = Σ_r hats_r · dc[r, k], and dG_k += f_k ⊛ u_k.
template <int KMAX, int RMAX>
__device__ __forceinline__ void dg_slot(
    float (&gre)[KMAX], float (&gim)[KMAX], const float* __restrict__ dr,
    const float* cf, int C, int K, int R, int M)
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
                    const float* d = dr + r * M + k * 2 * C;
                    ur = fmaf(hs[r], __ldg(d), ur);
                    ui = fmaf(hs[r], __ldg(d + C), ui);
                }
            }
            const float fr = cf[R + 2 * k];
            const float fi = cf[R + 2 * k + 1];
            gre[k] = fmaf(fr, ur, fmaf(fi, ui, gre[k]));
            gim[k] = fmaf(fr, ui, fmaf(-fi, ur, gim[k]));
        }
    }
}

template <int KMAX, int RMAX, int MINB, typename ST>
__global__ void __launch_bounds__(kMaxThreads, MINB)
bwd_dg_kernel(const float* __restrict__ dc,
              const ST* __restrict__ sten,
              const int* __restrict__ meta_s,
              float* __restrict__ dg,
              int Ps, int C, int K, int R, int TB, int compressed,
              int nb_out, int T, Knots kn)
{
    const int M = 2 * K * C;
    const int RM = R * M;
    const int NC = R + 2 * K;                // coefficients per occupied slot
    const int planes = compressed ? 5 : NC;
    const int whole = compressed ? 1 : R;    // planes staged for every slot
    const int tiles = (TB + T - 1) / T;
    const int blk = blockIdx.x / tiles;      // source block
    const int s0 = (blockIdx.x % tiles) * T;
    const int ns = min(T, TB - s0);
    const int tid = threadIdx.x;
    const int nthr = blockDim.x;             // a multiple of 32
    const bool active = tid < ns * C;
    const int is = active ? tid / C : 0;     // (source, channel) of a thread
    const int ic = active ? tid % C : 0;

    extern __shared__ __align__(16) float smem[];
    float* slab = smem;                                      // [whole][TB][T]
    float* coef = slab + (size_t)whole * TB * T;             // [T][TB][NC]
    int* tidx = reinterpret_cast<int*>(coef + (size_t)T * TB * NC);  // [T][TB]
    int* cnt = tidx + T * TB;                                // [T]

    float gre[KMAX], gim[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) { gre[k] = 0.f; gim[k] = 0.f; }

    const int* src_row = meta_s + 2 * (size_t)Ps;
    const int p_lo = panel::lower_bound(src_row, Ps, blk);
    const int p_hi = panel::lower_bound(src_row, Ps, blk + 1);
    const size_t plane = (size_t)TB * TB;
    const int warp = tid >> 5, lane = tid & 31, nwarps = nthr >> 5;

    for (int p = p_lo; p < p_hi; ++p) {
        const int pid = __ldg(meta_s + p);
        const int tgt = __ldg(meta_s + Ps + p);
        const ST* sp = sten + (size_t)pid * planes * plane;
        __syncthreads();                     // the last panel's lists are read
        for (int i = tid; i < whole * TB * ns; i += nthr) {
            const int sl = i % ns, qt = i / ns;          // qt = q·TB + t
            slab[(size_t)qt * T + sl] =
                load_sten(sp, (size_t)qt * TB + s0 + sl);
        }
        __syncthreads();
        for (int c = warp; c < ns; c += nwarps) {
            float* ct = coef + (size_t)c * TB * NC;
            int* st = tidx + c * TB;
            int base = 0;
            for (int t0 = 0; t0 < TB; t0 += 32)
                base = compact_column<RMAX, ST>(ct, st, base, slab, sp,
                                                t0 + lane, s0 + c, c, plane,
                                                TB, T, R, K, compressed, kn);
            if (lane == 0) cnt[c] = base;
        }
        __syncthreads();
        if (!active || tgt < 0 || tgt >= nb_out) continue;
        const int n = cnt[is];
        const float* cf = coef + (size_t)is * TB * NC;
        const int* ti = tidx + is * TB;
        const float* db = dc + (size_t)tgt * TB * RM + ic;
        for (int j = 0; j < n; ++j)
            dg_slot<KMAX, RMAX>(gre, gim, db + (size_t)ti[j] * RM,
                                cf + j * NC, C, K, R, M);
    }
    if (!active) return;
    float* o = dg + ((size_t)blk * TB + s0 + is) * M;
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
        if (k < K) {
            o[k * 2 * C + ic] = gre[k];
            o[k * 2 * C + C + ic] = gim[k];
        }
}

// --- launch ------------------------------------------------------------------------

size_t round4(size_t n) { return (n + 3) / 4 * 4; }

// How one call is cut up, and where its scratch lies in the buffer the
// caller owns (floats, 16-byte aligned): contrib, then dc over it, and the
// dW partials after it.
struct Plan {
    int T, nthr;
    band::DwSlices dws;
    size_t smem1, smem4, part_at, floats;
};

bool shapes_supported(int nb_out, int nb_g, int C, int K, int R, int TB,
                      int O2, int compressed)
{
    return nb_out >= 1 && nb_g >= 1 && C >= 1 && C <= kMaxThreads && K >= 1
        && K % 2 == 1 && K <= 5 && R >= (compressed ? 2 : 1)
        && R <= (K <= 3 ? 3 : 6) && TB >= 1 && O2 >= 1;
}

cudaError_t make_plan(int nb_out, int C, int K, int R, int TB, int O2,
                      int compressed, Plan* pl)
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
    pl->nthr = panel::threads_for(pl->T, C);
    const size_t lists = panel::list_floats(K, R, TB, pl->T);
    pl->smem1 = lists * sizeof(float);
    pl->smem4 = (lists + (size_t)(compressed ? 1 : R) * TB * pl->T)
        * sizeof(float);
    if (pl->smem4 > (size_t)limit) return cudaErrorInvalidValue;
    const long long rows = (long long)nb_out * TB;
    const int RM = R * 2 * K * C;
    pl->dws = band::dw_slices(rows, RM, O2, sms);
    pl->part_at = round4((size_t)rows * RM);
    pl->floats = pl->part_at + (size_t)pl->dws.slices * RM * O2;
    return cudaSuccess;
}

template <int KMAX, int RMAX, int MINB, typename ST>
int launch(const float* dy, const float* g, const float* wmat,
           const ST* sten, const int* meta, const int* meta_s, float* dg,
           float* dw, float* scratch, int P, int Ps, int nb_out, int nb_g,
           int C, int K, int R, int TB, int O2, int compressed,
           const Plan& pl, cudaStream_t stream)
{
    const Knots kn = compressed ? panel::ring_knots(R) : Knots{};
    const int rows = nb_out * TB;
    const int RM = R * 2 * K * C;
    const int tiles = (TB + pl.T - 1) / pl.T;
    float* contrib = scratch;                // then dc, same layout
    float* part = scratch + pl.part_at;

    auto k1 = bwd_contrib_kernel<KMAX, RMAX, MINB, false, ST>;
    cudaError_t err = cudaFuncSetAttribute(
        k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem1);
    if (err != cudaSuccess) return (int)err;
    k1<<<(unsigned)((long)nb_out * tiles), pl.nthr, pl.smem1, stream>>>(
        g, sten, meta, contrib, P, C, K, R, TB, compressed, nb_g, pl.T, kn,
        nullptr, TB);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

    err = band::launch_dw(contrib, dy, part, dw, rows, RM, O2, pl.dws,
                          stream);
    if (err != cudaSuccess) return (int)err;

    err = panel::launch_dc(dy, wmat, contrib, rows, RM, O2, stream);
    if (err != cudaSuccess) return (int)err;

    auto k4 = bwd_dg_kernel<KMAX, RMAX, MINB, ST>;
    err = cudaFuncSetAttribute(
        k4, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem4);
    if (err != cudaSuccess) return (int)err;
    k4<<<(unsigned)((long)nb_g * tiles), pl.nthr, pl.smem4, stream>>>(
        contrib, sten, meta_s, dg, Ps, C, K, R, TB, compressed, nb_out, pl.T,
        kn);
    return (int)cudaGetLastError();
}

// The instantiation for (K, R): K ≤ 3 with R ≤ 3, or K = 5 with R ≤ 6.
template <typename ST>
int launch_for(const float* dy, const float* g, const float* wmat,
               const void* sten, const int* meta, const int* meta_s,
               float* dg, float* dw, float* scratch, int P, int Ps,
               int nb_out, int nb_g, int C, int K, int R, int TB, int O2,
               int compressed, const Plan& pl, cudaStream_t s)
{
    const ST* st = static_cast<const ST*>(sten);
    if (K <= 3)
        return launch<3, 3, 5>(dy, g, wmat, st, meta, meta_s, dg, dw,
                               scratch, P, Ps, nb_out, nb_g, C, K, R, TB, O2,
                               compressed, pl, s);
    return launch<5, 6, 2>(dy, g, wmat, st, meta, meta_s, dg, dw, scratch, P,
                           Ps, nb_out, nb_g, C, K, R, TB, O2, compressed, pl,
                           s);
}

}  // namespace

// Floats of the scratch buffer band_panel_bwd needs for these sizes (0 for
// sizes it does not take).
extern "C" long long band_panel_bwd_scratch_floats(int nb_out, int nb_g,
                                                   int C, int K, int R,
                                                   int TB, int O2,
                                                   int compressed)
{
    Plan pl;
    if (!shapes_supported(nb_out, nb_g, C, K, R, TB, O2, compressed)
        || make_plan(nb_out, C, K, R, TB, O2, compressed, &pl) != cudaSuccess)
        return 0;
    return (long long)pl.floats;
}

// Launches the four passes (five kernels) on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for shapes
// they do not take (those of the forward: K odd ≤ 5, R ≤ 3 with K ≤ 3 or
// R ≤ 6 with K = 5, R ≥ 2 when compressed, C ≤ 256; or lists above the
// shared memory a CTA can have).  dy: (nb_out·TB, O2); g, dg: (nb_g·TB, M);
// meta (4, P) by target, meta_s (4, Ps) by source; scratch holds
// band_panel_bwd_scratch_floats floats, owned by the caller; sten float32,
// or bfloat16 when sten_bf16 is set.
extern "C" int band_panel_bwd(const float* dy, const float* g,
                              const float* wmat, const void* sten,
                              const int* meta, const int* meta_s, float* dg,
                              float* dw, float* scratch, int P, int Ps,
                              int nb_out, int nb_g, int C, int K, int R,
                              int TB, int O2, int compressed, int sten_bf16,
                              void* stream)
{
    if (P < 1 || Ps < 1
        || !shapes_supported(nb_out, nb_g, C, K, R, TB, O2, compressed))
        return (int)cudaErrorInvalidValue;
    Plan pl;
    const cudaError_t err = make_plan(nb_out, C, K, R, TB, O2, compressed,
                                      &pl);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = (cudaStream_t)stream;
    if (sten_bf16)
        return launch_for<__nv_bfloat16>(dy, g, wmat, sten, meta, meta_s, dg,
                                         dw, scratch, P, Ps, nb_out, nb_g, C,
                                         K, R, TB, O2, compressed, pl, s);
    return launch_for<float>(dy, g, wmat, sten, meta, meta_s, dg, dw, scratch,
                             P, Ps, nb_out, nb_g, C, K, R, TB, O2, compressed,
                             pl, s);
}
