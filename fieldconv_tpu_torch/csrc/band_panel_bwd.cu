// Panel field-conv backward (K5 bwd) for Hopper, sm_90a.
//
// Replaces the TPU kernel fieldconv_tpu/ops/pallas/band_conv.py::
// _band_panel_bwd_impl (pallas_call at :2293, body _bwd_panel_kernel, and at
// :2252 for chunked tables, body _bwd_panel_chunk_kernel).  Python wrapper
// and plain PyTorch version: fieldconv_tpu_torch/ops/band_conv.py
// (band_panel_bwd, band_panel_bwd_reference).
//
// What it computes.  With g, W, the panel stencil and its slot
// coefficients as in the forward (band_panel_fwd.cu, panel_pipe.cuh):
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
//      forms it (panel_pipe.cuh's contrib_kernel over meta, the target
//      order; only g, W and the stencil are kept from the forward, as in
//      JAX), written to scratch as (rows, R·M);
//   2. dW = Σ_rows contribᵀ·dy: per-slice partials and a combine in slice
//      order (dw_rows.cuh, K1's backward passes 3-4);
//   3. dc = dy·Wᵀ, a tiled product written over contrib, same layout
//      (panel_gemm.cuh, shared with K6's backward);
//   4. dG by source: panel_pipe.cuh's walk over meta_s, warp-specialized.
//      A CTA owns a tile of up to 32 sources of one source block (4 a
//      thread at C = 32), one consumer thread per (source, channel) with
//      its K complex dG sums in registers, and four producer warps that
//      stage, per panel, the tile's columns of the r plane, then in passes
//      the dc rows of the target rows any of its sources needs (a bulk copy
//      a row: each read once per tile and panel) and the occupied slots'
//      coefficients.  Per slot a consumer forms u_k = Σ_r hats_r·dc[t, r, k]
//      over the rings whose hat is nonzero (at most two: the hats are
//      triangles on the knots; skipping the others is exact) and adds
//      f_k ⊛ u_k.  dG is written once per row.
//
// dc = dy·Wᵀ was kept as its own pass: forming dc rows inside pass 4 would
// redo dy·Wᵀ for every tile that stages a target row, several times the
// pass's products.  Dropped on the way here, each measured slower on an
// H100: pass 4 with every thread building and consuming in turn (about a
// quarter slower at 163,842 samples), three or four CTAs an SM (spills),
// 16-source tiles, and slots carrying their two rings' index and weights
// instead of the hats (a longer dependent chain per slot).
//
// What bounds it.  The function needs the r plane (or the hat planes)
// whole and the other planes only in the 32-byte sectors that hold an
// occupied slot, plus g, dy, W, meta_s, dg and dW once; its operations are
// the occupied-slot work of contrib and of dG and 2·rows·R·M·O2 each for
// dc and dW (chip_smoke.py::k5_bwd_bound counts both from the run's
// table).  This version also writes and reads back contrib and dc (0.38 GB
// each at 163,968 rows, C = 32, K = 3, R = 3) and reads the stencil twice
// (once per order); its walks stay bound by the latency of their per-panel
// steps, not by bytes or operations.
//
// Registers and spills (-Xptxas -v, sm_90a): contrib_kernel as in
// band_panel_fwd.cu; bwd_dg_kernel <K, R, sources a thread> 80 registers
// (two CTAs of 384 threads an SM), <·,·,1> no spills, <·,·,2> and <·,·,4>
// 40 to 56 bytes of spill stores; bwd_dw_partial_kernel 95 and 80,
// bwd_dc_kernel 48, none.

#include "dw_rows.cuh"
#include "panel_gemm.cuh"
#include "panel_pipe.cuh"

#include <algorithm>
#include <cstddef>

namespace {

using panel::Knots;
using pipe::Plan;

// By source (pass 4): 32 sources a tile, up to 4 a thread (K complex sums
// each).
constexpr pipe::Inst kDgInst = {32, 4};
// its threads: the consumers' and the producers' (panel_pipe.cuh::walk,
// warp-specialized)
inline int dg_threads(const Plan& p)
{
    return p.nthr + 32 * pipe::kProducerWarps;
}

// --- pass 4: dG by source ----------------------------------------------------------------

template <int KMAX, int RMAX, int MT, typename ST>
__global__ void __launch_bounds__(
    pipe::kThreads + 32 * pipe::kProducerWarps, 2)
bwd_dg_kernel(const float* __restrict__ dc, const ST* __restrict__ sten,
              const int* __restrict__ meta_s, float* __restrict__ dg,
              int Ps, int C, int K, int R, int TB, int compressed, int nb_out,
              Plan pl, Knots kn)
{
    const int M = 2 * K * C;
    const int tiles = (TB + pl.T - 1) / pl.T;
    const int blk = blockIdx.x / tiles;      // source block
    const int l0 = (blockIdx.x % tiles) * pl.T;
    const int nt = min(pl.T, TB - l0);
    const int tid = threadIdx.x;
    const bool active = tid < pl.NQ * C;
    const int qi = active ? tid / C : 0;     // (source group, channel)
    const int ic = active ? tid % C : 0;

    extern __shared__ __align__(16) unsigned char smem[];
    float gre[MT][KMAX], gim[MT][KMAX];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int k = 0; k < KMAX; ++k) { gre[m][k] = 0.f; gim[m][k] = 0.f; }
    pipe::MetaRun<true> run{meta_s, Ps, nb_out, TB, TB, (size_t)TB * TB,
                            compressed ? 5 : R + 2 * K};
    pipe::walk<true, true, RMAX, ST>(
        smem, pl, sten, sten, run, dc, R, K, compressed, blk, l0, nt, kn,
        [&](int b) {
            pipe::consume_dg<KMAX, RMAX, MT, ST>(gre, gim, smem, pl, b, C, K,
                                                 R, compressed, nt, active,
                                                 qi, ic);
        });
    if (!active) return;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
        const int l = qi + pl.NQ * m;
        if (l >= nt) continue;
        float* o = dg + ((size_t)blk * TB + l0 + l) * M;
#pragma unroll
        for (int k = 0; k < KMAX; ++k)
            if (k < K) {
                o[k * 2 * C + ic] = gre[m][k];
                o[k * 2 * C + C + ic] = gim[m][k];
            }
    }
}

// --- launch ------------------------------------------------------------------------

size_t round4(size_t n) { return (n + 3) / 4 * 4; }

// How one call is cut up, and where its scratch lies in the buffer the
// caller owns (floats, 16-byte aligned): contrib, then dc over it, and the
// dW partials after it.
struct CallPlan {
    Plan p1, p4;
    band::DwSlices dws;
    size_t part_at, floats;
};

bool shapes_supported(int nb_out, int nb_g, int C, int K, int R, int TB,
                      int O2, int compressed)
{
    return nb_out >= 1 && nb_g >= 1 && C >= 1 && C <= pipe::kThreads
        && K >= 1 && K % 2 == 1 && K <= 5 && R >= (compressed ? 2 : 1)
        && R <= 6 && TB >= 1 && TB <= pipe::kMaxTB && O2 >= 1;
}

// The scratch alone needs no pointers (band_panel_bwd_scratch_floats); a
// launch also plans both walks (g, scratch and sten given).
cudaError_t make_plan(int nb_out, int C, int K, int R, int TB, int O2,
                      int compressed, int elem, const void* g,
                      const void* scratch, const void* sten, CallPlan* pl)
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
    const long long rows = (long long)nb_out * TB;
    const int RM = R * 2 * K * C;
    pl->dws = band::dw_slices(rows, RM, O2, sms);
    pl->part_at = round4((size_t)rows * RM);
    pl->floats = pl->part_at + (size_t)pl->dws.slices * RM * O2;
    // each walk's tile, or a narrower one where its slabs (a dense
    // stencil's R planes) leave no room
    if (!pipe::contrib_plan(C, K, R, TB, TB, compressed, elem, g, sten, limit,
                            &pl->p1))
        return cudaErrorInvalidValue;
    bool fits = false;
    for (int mt = kDgInst.mt_max; mt >= 1 && !fits; mt /= 2)
        fits = pipe::tile_plan(1, C, K, R, TB, TB, compressed, elem,
                               kDgInst.t_target, mt, RM, scratch, sten,
                               &pl->p4)
            && pipe::fit_plan(&pl->p4, elem, limit);
    return fits ? cudaSuccess : cudaErrorInvalidValue;
}

template <int KMAX, int RMAX, int MT4, typename ST>
int launch(const float* dy, const float* g, const float* wmat,
           const ST* sten, const int* meta, const int* meta_s, float* dg,
           float* dw, float* scratch, int P, int Ps, int nb_out, int nb_g,
           int C, int K, int R, int TB, int O2, int compressed,
           const CallPlan& pl, cudaStream_t stream)
{
    const int rows = nb_out * TB;
    const int RM = R * 2 * K * C;
    float* contrib = scratch;                // then dc, same layout
    float* part = scratch + pl.part_at;

    cudaError_t err = pipe::launch_contrib(g, sten, meta, contrib, P, nb_out,
                                           C, K, R, TB, compressed, nb_g,
                                           pl.p1, stream);
    if (err != cudaSuccess) return (int)err;

    err = band::launch_dw(contrib, dy, part, dw, rows, RM, O2, pl.dws,
                          stream);
    if (err != cudaSuccess) return (int)err;

    err = panel::launch_dc(dy, wmat, contrib, rows, RM, O2, stream);
    if (err != cudaSuccess) return (int)err;

    auto k4 = bwd_dg_kernel<KMAX, RMAX, MT4, ST>;
    err = pipe::set_smem(k4, pl.p4);
    if (err != cudaSuccess) return (int)err;
    const Knots kn = compressed ? panel::ring_knots(R) : Knots{};
    const long g4 = (long)nb_g * ((TB + pl.p4.T - 1) / pl.p4.T);
    k4<<<(unsigned)g4, dg_threads(pl.p4), pl.p4.bytes, stream>>>(
        contrib, sten, meta_s, dg, Ps, C, K, R, TB, compressed, nb_out, pl.p4,
        kn);
    return (int)cudaGetLastError();
}

// The instantiation for (K, R) and pass 4's sources a thread.
template <int KMAX, int RMAX, typename ST>
int launch_mt(const float* dy, const float* g, const float* wmat,
              const ST* st, const int* meta, const int* meta_s, float* dg,
              float* dw, float* scratch, int P, int Ps, int nb_out, int nb_g,
              int C, int K, int R, int TB, int O2, int compressed,
              const CallPlan& pl, cudaStream_t s)
{
#define K5_BWD(MT4)                                                           \
    return launch<KMAX, RMAX, MT4, ST>(dy, g, wmat, st, meta, meta_s, dg, dw, \
                                       scratch, P, Ps, nb_out, nb_g, C, K, R, \
                                       TB, O2, compressed, pl, s)
    if (pl.p4.MT == 4) K5_BWD(4);
    if (pl.p4.MT == 2) K5_BWD(2);
    K5_BWD(1);
#undef K5_BWD
}

template <typename ST>
int launch_for(const float* dy, const float* g, const float* wmat,
               const void* sten, const int* meta, const int* meta_s,
               float* dg, float* dw, float* scratch, int P, int Ps,
               int nb_out, int nb_g, int C, int K, int R, int TB, int O2,
               int compressed, const CallPlan& pl, cudaStream_t s)
{
    const ST* st = static_cast<const ST*>(sten);
    if (K <= 3 && R <= 3)
        return launch_mt<3, 3, ST>(dy, g, wmat, st, meta, meta_s, dg, dw,
                                   scratch, P, Ps, nb_out, nb_g, C, K, R, TB,
                                   O2, compressed, pl, s);
    if (K <= 3)
        return launch_mt<3, 6, ST>(dy, g, wmat, st, meta, meta_s, dg, dw,
                                   scratch, P, Ps, nb_out, nb_g, C, K, R, TB,
                                   O2, compressed, pl, s);
    return launch_mt<5, 6, ST>(dy, g, wmat, st, meta, meta_s, dg, dw,
                               scratch, P, Ps, nb_out, nb_g, C, K, R, TB, O2,
                               compressed, pl, s);
}

}  // namespace

// Floats of the scratch buffer band_panel_bwd needs for these sizes (0 for
// sizes it does not take).
extern "C" long long band_panel_bwd_scratch_floats(int nb_out, int nb_g,
                                                   int C, int K, int R,
                                                   int TB, int O2,
                                                   int compressed)
{
    CallPlan pl;
    if (!shapes_supported(nb_out, nb_g, C, K, R, TB, O2, compressed)
        || make_plan(nb_out, C, K, R, TB, O2, compressed, 4, nullptr,
                     nullptr, nullptr, &pl) != cudaSuccess)
        return 0;
    return (long long)pl.floats;
}

// Launches the four passes (five kernels) on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for shapes
// they do not take (those of the forward: K odd ≤ 5, R ≤ 6, R ≥ 2 when
// compressed, C ≤ 256, TB ≤ 128; or walks above the shared memory a CTA
// can have).  dy: (nb_out·TB, O2); g, dg: (nb_g·TB, M); meta (4, P) by
// target, meta_s (4, Ps) by source; scratch holds
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
    CallPlan pl;
    const cudaError_t err = make_plan(nb_out, C, K, R, TB, O2, compressed,
                                      sten_bf16 ? 2 : 4, g, scratch, sten,
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
