// Compact field-conv backward (K6 bwd) for Hopper, sm_90a.
//
// Replaces the TPU kernel fieldconv_tpu/ops/pallas/band_conv.py::
// _band_compact_bwd_impl (pallas_call at :2084, body _bwd_compact_kernel
// at :1972) and the segment_sum that folds its per-panel dG blocks onto
// vertices in _band_compact's VJP (:2118).  Python wrapper and plain
// PyTorch version: fieldconv_tpu_torch/ops/band_conv.py (band_compact_bwd,
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
// reads gets zeros.  The stencil is f32 or bf16, each element read as f32.
//
// Design.  Five passes over one scratch buffer owned by the caller
// (band_compact_bwd_scratch_floats), every sum with one owner and a fixed
// order (no atomics: two calls on the same inputs agree bitwise):
//
//   1. contrib of every target row, rematerialised as K6's forward forms
//      it (panel_pipe.cuh's compact_contrib_kernel), written as (rows,
//      R·M);
//   2. dW = Σ_rows contribᵀ·dy (dw_rows.cuh's slice partials and combine);
//   3. dc = dy·Wᵀ written over contrib (panel_gemm.cuh);
//   4. dG per compact column (compact_dg_kernel below).  Each panel owns
//      its columns, so their dgg rows are written once each.  A CTA takes
//      one target block and a slice of its channels (all C where the stage
//      fits: at TBt 32 every correspondence width, and C = 48 at K = 5,
//      R = 6 in three slices) and stages the dc rows of the block's ≤ 32
//      target rows once for the block's run of panels (one bulk copy of
//      the block's rows when the slice is all of C).  It is
//      warp-specialized: an eighth of its warps produce, the rest sum,
//      with two pass buffers between them on full and empty mbarriers and
//      no barrier across the CTA.  The producers walk the run: per panel
//      its five planes (TBt × TS contiguous slots each) arrive by one bulk
//      copy ahead of use (the r plane alone, on a ring of two stages, where
//      the five leave too little shared memory; e^{iθ} and wxp are then
//      read at the occupied slots), each column's word of occupied target
//      rows is formed from r, the words are counted and scanned, and the
//      occupied slots of a pass (columns whose slots fit the image buffer:
//      a whole panel, mostly, at 163,842 samples) are numbered column by
//      column so that every producer thread builds one: its hats and its
//      f_k, formed once for all channels.  Each consumer (column, channel)
//      thread walks its column's word in ascending target order, forms
//      u_k = Σ_r hats_r·dc[t, r, k] over the rings whose hat is nonzero
//      (skipping the others is exact) and adds f_k ⊛ u_k, and writes its
//      column's row (zeros for an empty column); a column group with many
//      slots in one pass catches up in the next;
//   5. the fold of dgg onto dg (compact_fold.cuh): one thread per (row,
//      channel) sums its row's run of the table's fold index in ascending
//      column order.
//
// Panels: TBt ≤ 32 (a column's target rows in one word; the pure-panel
// layout's compact convs, the only ones a path trains, run at TBt 32, TS
// 128), TS ≤ 128.  Hats and phasor powers are formed uncontracted and
// correctly rounded in the plain version's order, as in K5.
//
// The version before this one ran pass 1 as the forward's former walk
// (panel_bwd.cuh's bwd_contrib_kernel: a CTA of 8 targets, a warp per
// target row compacting its slots, g read from L2 once per slot and
// target) and pass 4 as a serial chain per column: a warp took one column
// at a time, lane t read its slot's r with a stride of TS (one sector a
// lane) and formed its coefficients, and groups of channels took the
// occupied rows in turn.  Measured slower on an H100 at 163,842 samples
// (C = 32) and dropped: pass 4 with every thread building and then
// summing, a CTA barrier a pass (2.57 against 2.28 ms), or with each
// consumer forming a slot's f_k itself; two channels a consumer thread
// (float2 reads of dc); two CTAs of 512 threads an SM with the channels
// in two slices; three pass buffers; 12 producer warps.  Folding dG into
// pass 4 was not taken: a source row's ~9 columns each lie in another
// target block, so a fused fold would gather that block's dc per column.
//
// What bounds it.  The function needs the r plane whole and the other
// planes only in the 32-byte sectors that hold an occupied slot, src_idx,
// the rows of g that live columns read, dy, W, and dg and dW written once;
// its operations are the occupied-slot work of contrib and of dG and
// 2·rows·R·M·O2 each for dc and dW (chip_smoke.py::k6_bwd_bound counts
// both from the run's table).  This version also writes and reads back
// contrib and dc (0.38 GB each at 163,968 rows, C = 32, K = 3, R = 3) and
// dgg (P·TS·M floats, 1.18 GB at 11,975 panels and M = 192), and reads the
// stencil twice; its walks stay bound by the latency of their per-panel
// steps, not by bytes or operations.
//
// Registers and spills (-Xptxas -v, sm_90a): compact_contrib_kernel as in
// band_compact_fwd.cu; compact_dg_kernel <K, R> at 1024 threads, one CTA
// an SM (K = 3: at most 64 registers) <3,3> 56 and <3,6> 55, at 512
// threads <5,6> 72, f32 or bf16, none spilled; bwd_dw_partial_kernel 80 and
// 95, bwd_dc_kernel 48, compact_fold_kernel 32, none.

#include "compact_fold.cuh"
#include "dw_rows.cuh"
#include "panel_gemm.cuh"
#include "panel_pipe.cuh"
#include "sten_load.cuh"

#include <algorithm>
#include <cstddef>
#include <cstdint>

namespace {

using panel::Knots;

constexpr int kMaxTargets = 32;          // a column's target rows: one word
constexpr int kMinImage = 512;           // slots an image buffer holds at least

// pass 4's threads: 32 warps at K ≤ 3 (64 registers a thread), 16 at K = 5,
// an eighth of them producers; its pass buffers
constexpr int dg_threads(int K) { return K <= 3 ? 1024 : 512; }
__host__ __device__ constexpr int dg_producers(int threads)
{
    return threads / 256;
}
constexpr int kDgBufs = 2;

// --- pass 4: dG per compact column ----------------------------------------------------

// A slot's image in pass 4, v[NW]: its RMAX hats (from r, zero from R on),
// then f_k re/im for k < KMAX (zero from K on), formed once per slot from
// e^{iθ} (pr, pi) and wxp (fr, fi) as panel_pipe.cuh::slot_coefs forms them.
template <int KMAX, int RMAX, int NW>
__device__ __forceinline__ void build_slot(float (&v)[NW], float pr, float pi,
                                           float fr, float fi, float rv,
                                           int R, int K, const Knots& kn)
{
    float fre[KMAX], fim[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) { fre[k] = 0.f; fim[k] = 0.f; }
    if (K == 5) {
        if constexpr (KMAX >= 5)
            pipe::phasors<2, KMAX>(fre, fim, pr, pi, fr, fi);
    } else if (K == 3) {
        pipe::phasors<1, KMAX>(fre, fim, pr, pi, fr, fi);
    } else {
        pipe::phasors<0, KMAX>(fre, fim, pr, pi, fr, fi);
    }
#pragma unroll
    for (int w = 0; w < NW; ++w) v[w] = 0.f;
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
        if (r < R) v[r] = panel::hat(rv, r, kn);
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
        v[RMAX + 2 * k] = fre[k];
        v[RMAX + 2 * k + 1] = fim[k];
    }
}

// One occupied slot (image v) of a (column, channel) thread: u_k = Σ_r
// hats_r·dc[t, r, k] over the rings whose hat is nonzero (skipping the
// others is exact), then dG_k += conj(f_k)·u_k; d is the thread's channel
// of the staged dc row [r][k][re, im][cs].
template <int KMAX, int RMAX, int NW>
__device__ __forceinline__ void dg_slot(float (&gre)[KMAX], float (&gim)[KMAX],
                                        const float (&v)[NW], const float* d,
                                        int K, int R, int cs)
{
    float ur[KMAX], ui[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) { ur[k] = 0.f; ui[k] = 0.f; }
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
        const float h = v[r];
        if (r < R && h != 0.f) {
            const float* dr = d + r * 2 * K * cs;
#pragma unroll
            for (int k = 0; k < KMAX; ++k)
                if (k < K) {
                    ur[k] = fmaf(h, dr[2 * k * cs], ur[k]);
                    ui[k] = fmaf(h, dr[(2 * k + 1) * cs], ui[k]);
                }
        }
    }
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
        if (k < K) {
            const float fr = v[RMAX + 2 * k], fi = v[RMAX + 2 * k + 1];
            gre[k] = fmaf(fr, ur[k], fmaf(fi, ui[k], gre[k]));
            gim[k] = fmaf(fr, ui[k], fmaf(-fi, ur[k], gim[k]));
        }
}

// Words of a slot's image in pass 4: its hats, then its f_k re/im pairs.
__host__ __device__ constexpr int img_words(int RMAX, int KMAX)
{
    return (RMAX + 2 * KMAX + 3) / 4 * 4;
}

// How pass 4 cuts its CTAs and its shared memory (bytes from the start of
// the dynamic shared memory; the first 64 hold the mbarriers: the slab
// stages', the dc stage's, and each pass buffer's full and empty ones).
// A pass buffer holds the pass's panel and columns, their words of
// occupied rows and first slot numbers, and its slots' images.
struct DgPlan {
    int cs, slices;        // channels a CTA, CTAs a target block
    int G;                 // row groups of the mask pass
    int NIMG;              // words of a slot's image (a multiple of 4)
    int SCAP;              // slots a pass
    int bulk;              // slabs by bulk copy (16-byte rows)
    int planes, stages;    // planes a slab (1: r, 5: all), slabs in flight
    int dc_bulk;           // the block's dc rows by one bulk copy
    float r_lo, r_hi;      // a slot is occupied for r_lo < r < r_hi
    unsigned plane_bytes, slab_bytes, off_slab, off_mask, off_excl, off_part,
        off_dc, off_buf, buf_bytes, buf_mask, buf_excl, buf_img, bytes;
};

// The plan of pass 4 at `threads` threads a CTA, within `limit` bytes of
// shared memory: a slab of all five planes (one stage) where that needs
// no more channel slices than a slab of the r plane (two stages), the
// fewest slices whose staged dc leaves room for kMinImage slots a pass
// buffer, and the rest of the limit for the images.  False when nothing
// fits.
bool dg_plan(int C, int K, int R, int TBt, int TS, int elem, int threads,
             const void* sten, const void* dc, int limit, DgPlan* d)
{
    *d = DgPlan{};
    // the instantiation's RMAX hats and KMAX f_k pairs, whole float4s
    d->NIMG = img_words(K <= 3 && R <= 3 ? 3 : 6, K <= 3 ? 3 : 5);
    d->G = std::min(TBt, std::max(1, dg_producers(threads) * 32 / TS));
    d->plane_bytes = (unsigned)((size_t)TBt * TS * elem);
    d->bulk = d->plane_bytes % 16 == 0 && (uintptr_t)sten % 16 == 0;
    const Knots kn = panel::ring_knots(R);
    d->r_lo = kn.lo[0];
    d->r_hi = kn.hi[R - 1];
    const size_t per_channel = (size_t)TBt * R * 2 * K * 4;
    const size_t img_min =
        (size_t)kDgBufs * std::min(TBt * TS, kMinImage) * d->NIMG * 4;
    const unsigned bm = 32, be = bm + pipe::align16((size_t)TS * 4),
                   bi = be + pipe::align16((size_t)(TS + 1) * 4);
    // bytes before the images for a slab of `planes` planes and `slices`
    // channel slices
    auto fixed = [&](int planes, int slices) {
        const int stages = planes == 5 ? 1 : pipe::kStages;
        size_t at = 64 + (size_t)stages
            * pipe::align16((size_t)planes * d->plane_bytes);
        at += pipe::align16((size_t)TS * 4)
            + pipe::align16((size_t)(TS + 1) * 4)
            + pipe::align16((size_t)d->G * TS * 4);
        at += pipe::align16(per_channel * ((C + slices - 1) / slices));
        return at + (size_t)kDgBufs * bi;
    };
    auto fewest = [&](int planes) {
        int slices = 1;
        while (slices <= C && fixed(planes, slices) + img_min > (size_t)limit)
            ++slices;
        return slices;
    };
    const int s1 = fewest(1), s5 = d->bulk ? fewest(5) : C + 1;
    d->planes = s5 <= s1 ? 5 : 1;
    const int slices = d->planes == 5 ? s5 : s1;
    if (slices > C) return false;
    d->stages = d->planes == 5 ? 1 : pipe::kStages;
    d->cs = (C + slices - 1) / slices;
    d->slices = (C + d->cs - 1) / d->cs;
    size_t at = 64;
    d->slab_bytes = pipe::align16((size_t)d->planes * d->plane_bytes);
    d->off_slab = (unsigned)at;
    at += (size_t)d->stages * d->slab_bytes;
    d->off_mask = (unsigned)at;
    at += pipe::align16((size_t)TS * 4);
    d->off_excl = (unsigned)at;
    at += pipe::align16((size_t)(TS + 1) * 4);
    d->off_part = (unsigned)at;
    at += pipe::align16((size_t)d->G * TS * 4);
    d->off_dc = (unsigned)at;
    at += pipe::align16(per_channel * d->cs);
    d->off_buf = (unsigned)at;
    d->buf_mask = bm;
    d->buf_excl = be;
    d->buf_img = bi;
    d->SCAP = (int)std::min<size_t>(
        (size_t)TBt * TS,
        ((size_t)limit - at - (size_t)kDgBufs * bi) / (kDgBufs * d->NIMG * 4));
    d->buf_bytes = bi + (unsigned)((size_t)d->SCAP * d->NIMG * 4);
    at += (size_t)kDgBufs * d->buf_bytes;
    d->bytes = (unsigned)at;
    const size_t RM = (size_t)R * 2 * K * C;
    d->dc_bulk = d->slices == 1 && (TBt * RM) % 4 == 0
        && (uintptr_t)dc % 16 == 0;
    return at <= (size_t)limit;
}

// A CTA per (target block, channel slice of cs channels), THREADS threads,
// warp-specialized: the last dg_producers warps walk the block's run of
// panels and build its passes (the panel's words of occupied rows and
// their numbering, then the slots of at most SCAP at a time, whole
// columns) into kDgBufs pass buffers, publishing each on its full
// mbarrier; the other warps, once the block's dc rows are staged, sum the
// columns of each pass (column group q, channel cl: columns ca + q, ca + q
// + NQ, ...) and free its buffer on its empty mbarrier.  No barrier spans
// the CTA, so a pass is built while the one before is summed, and a
// column group with many slots in one pass catches up in the next.  smem
// as dg_plan lays it out.
template <int KMAX, int RMAX, int THREADS, typename ST>
__global__ void __launch_bounds__(THREADS, 1)
compact_dg_kernel(const float* __restrict__ dc, const ST* __restrict__ sten,
                  const int* __restrict__ meta, float* __restrict__ dgg,
                  int P, int C, int K, int R, int TBt, int TS, DgPlan pl,
                  Knots kn)
{
    constexpr int NPT = dg_producers(THREADS) * 32;  // producers
    constexpr int NCT = THREADS - NPT;       // consumer threads
    constexpr int NW = img_words(RMAX, KMAX);
    const int M = 2 * K * C;
    const int RM = R * M;
    const int KP = 2 * K;                    // (k, re / im) pairs of a ring
    const int cs = pl.cs;
    const int row_floats = R * KP * cs;      // a staged target row
    const int blk = blockIdx.x;
    const int c0 = blockIdx.y * cs;
    const int ncs = min(cs, C - c0);         // channels of this slice
    const int tid = threadIdx.x;

    extern __shared__ __align__(16) unsigned char smem[];
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
    uint64_t* dcbar = bars + pl.stages;
    uint64_t* full = dcbar + 1;
    uint64_t* empty = full + kDgBufs;
    float* dcs = reinterpret_cast<float*>(smem + pl.off_dc);
    auto buffer = [&](int b) {
        return smem + pl.off_buf + (size_t)b * pl.buf_bytes;
    };

    const int p_lo = panel::lower_bound(meta, P, blk);
    const int n = panel::lower_bound(meta, P, blk + 1) - p_lo;
    if (n == 0) return;                      // no panel: no column to write
    const size_t plane = (size_t)TBt * TS;
    auto slab = [&](int k) {
        return reinterpret_cast<ST*>(smem + pl.off_slab
                                     + (size_t)(k % pl.stages) * pl.slab_bytes);
    };
    // the run's k-th panel's slab planes, by one thread
    auto start_slab = [&](int k) {
        uint64_t* bar = bars + k % pl.stages;
        pipe::mbar_expect_tx(bar, pl.planes * pl.plane_bytes);
        pipe::bulk_copy(slab(k), sten + (size_t)(p_lo + k) * 5 * plane,
                        pl.planes * pl.plane_bytes, bar);
    };
    if (tid == 0) {
        for (int s = 0; s <= pl.stages; ++s) pipe::mbar_init(bars + s, 1);
        for (int b = 0; b < kDgBufs; ++b) {
            pipe::mbar_init(full + b, NPT);
            pipe::mbar_init(empty + b, NCT / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    // the block's dc rows, this slice of channels: [t][r][k][re, im][cs]
    if (pl.dc_bulk) {
        if (tid == 0) {
            const unsigned bytes = (unsigned)((size_t)TBt * RM * 4);
            pipe::mbar_expect_tx(dcbar, bytes);
            pipe::bulk_copy(dcs, dc + (size_t)blk * TBt * RM, bytes, dcbar);
        }
    } else {
        for (int i = tid; i < TBt * R * KP * cs; i += THREADS) {
            const int c = i % cs, qr = i / cs;   // qr = t·R·KP + r·KP + kp
            const int t = qr / (R * KP), rk = qr - t * (R * KP);
            if (c < ncs)
                __pipeline_memcpy_async(
                    dcs + i,
                    dc + ((size_t)blk * TBt + t) * RM + rk * C + c0 + c, 4);
        }
        __pipeline_commit();
        __pipeline_wait_prior(0);
        __syncthreads();
    }

    if (tid >= NCT) {
        // --- producers: panels, their words and numbering, passes
        const int ptid = tid - NCT, pwarp = ptid >> 5, lane = tid & 31;
        auto psync = [&]() {
            asm volatile("bar.sync 1, %0;\n" :: "r"(NPT) : "memory");
        };
        uint32_t* mask = reinterpret_cast<uint32_t*>(smem + pl.off_mask);
        int* excl = reinterpret_cast<int*>(smem + pl.off_excl);
        uint32_t* part = reinterpret_cast<uint32_t*>(smem + pl.off_part);
        const float r_lo = pl.r_lo, r_hi = pl.r_hi;
        const int G = pl.G;
        if (ptid == 0 && pl.bulk)
            for (int k = 0; k < n && k < pl.stages; ++k) start_slab(k);
        int np = 0;                          // passes built
        // the buffer of pass np, once its last use is summed
        auto claim = [&]() {
            const int b = np % kDgBufs;
            if (np >= kDgBufs)
                pipe::mbar_wait(empty + b, (np / kDgBufs - 1) & 1);
            return b;
        };
        for (int k = 0; k < n; ++k) {
            const int p = p_lo + k;
            ST* sl = slab(k);
            if (pl.bulk) {
                pipe::mbar_wait(bars + k % pl.stages, (k / pl.stages) & 1);
            } else {
                const ST* src = sten + (size_t)p * 5 * plane;
                for (int i = ptid; i < (int)plane; i += NPT) sl[i] = src[i];
                psync();
            }
            // each column's word of occupied target rows: G groups of rows
            // first, then their union, counts and exclusive scan (warp 0)
            for (int i = ptid; i < G * TS; i += NPT) {
                const int s = i % TS, gq = i / TS;
                uint32_t m = 0;
                for (int t = gq; t < TBt; t += G) {
                    const float rv = pipe::slab_value(sl[(size_t)t * TS + s]);
                    if (rv > r_lo && rv < r_hi) m |= 1u << t;
                }
                part[i] = m;
            }
            psync();
            if (pwarp == 0) {
                int carry = 0;
                for (int s0 = 0; s0 < TS; s0 += 32) {
                    const int s = s0 + lane;
                    uint32_t m = 0;
                    if (s < TS)
                        for (int gq = 0; gq < G; ++gq) m |= part[gq * TS + s];
                    const int cnt = __popc(m);
                    int incl = cnt;
#pragma unroll
                    for (int o = 1; o < 32; o <<= 1) {
                        const int v = __shfl_up_sync(0xffffffffu, incl, o);
                        if (lane >= o) incl += v;
                    }
                    if (s < TS) {
                        mask[s] = m;
                        excl[s] = carry + incl - cnt;
                    }
                    carry += __shfl_sync(0xffffffffu, incl, 31);
                }
                if (lane == 0) excl[TS] = carry;
            }
            psync();
            for (int ca = 0; ca < TS;) {
                // the pass: columns ca .. cb − 1, the most whose slots fit
                const int e0 = excl[ca];
                int cb = ca + 1;
                for (int hi = TS; cb < hi;) {
                    const int mid = (cb + hi + 1) >> 1;
                    if (excl[mid] - e0 <= pl.SCAP) cb = mid;
                    else hi = mid - 1;
                }
                const int ns = excl[cb] - e0;
                const int b = claim();
                unsigned char* buf = buffer(b);
                int* info = reinterpret_cast<int*>(buf);
                uint32_t* bmask =
                    reinterpret_cast<uint32_t*>(buf + pl.buf_mask);
                int* bexcl = reinterpret_cast<int*>(buf + pl.buf_excl);
                float4* img = reinterpret_cast<float4*>(buf + pl.buf_img);
                if (ptid == 0) {
                    info[0] = p;
                    info[1] = ca;
                    info[2] = cb;
                    info[3] = e0;
                    info[4] = 0;             // not the end
                }
                for (int s = ca + ptid; s < cb; s += NPT) {
                    bmask[s] = mask[s];
                    bexcl[s] = excl[s];
                }
                // build: the pass's j-th slot lies in column s (the last
                // whose first number is ≤ j), row t (the (j − excl[s])-th
                // set bit)
                for (int jj = ptid; jj < ns; jj += NPT) {
                    const int j = e0 + jj;
                    int s = ca;
                    for (int hi = cb - 1; s < hi;) {
                        const int mid = (s + hi + 1) >> 1;
                        if (excl[mid] <= j) s = mid;
                        else hi = mid - 1;
                    }
                    const int t = pipe::nth_bit(mask[s], j - excl[s]);
                    const size_t o = (size_t)t * TS + s;
                    const size_t e = (size_t)p * 5 * plane + o;
                    // e^{iθ} and wxp from the slab (all planes) or the
                    // stencil
                    auto raw = [&](int q) {
                        return pl.planes == 5
                            ? pipe::slab_value(sl[q * plane + o])
                            : load_sten(sten, e + q * plane);
                    };
                    float v[NW];
                    build_slot<KMAX, RMAX>(v, raw(1), raw(2), raw(3), raw(4),
                                           pipe::slab_value(sl[o]), R, K, kn);
#pragma unroll
                    for (int w = 0; w < NW / 4; ++w)
                        img[(size_t)jj * (NW / 4) + w] = make_float4(
                            v[4 * w], v[4 * w + 1], v[4 * w + 2], v[4 * w + 3]);
                }
                pipe::mbar_arrive(full + b);  // publish the pass
                ++np;
                ca = cb;
            }
            psync();                         // the slab and the words are read
            if (ptid == 0 && pl.bulk && k + pl.stages < n)
                start_slab(k + pl.stages);
        }
        const int b = claim();               // the end: an empty pass
        if (ptid == 0) reinterpret_cast<int*>(buffer(b))[4] = 1;
        pipe::mbar_arrive(full + b);
        return;
    }

    // --- consumers: the columns of each pass
    const int NQ = NCT / cs;                 // column groups
    const int q = tid / cs, cl = tid % cs;
    const bool active = q < NQ && cl < ncs;
    if (pl.dc_bulk) pipe::mbar_wait(dcbar, 0);
    for (int nc = 0;; ++nc) {
        const int b = nc % kDgBufs;
        pipe::mbar_wait(full + b, (nc / kDgBufs) & 1);
        const unsigned char* buf = buffer(b);
        const int* info = reinterpret_cast<const int*>(buf);
        if (info[4]) break;
        const int p = info[0], ca = info[1], cb = info[2], e0 = info[3];
        const uint32_t* bmask =
            reinterpret_cast<const uint32_t*>(buf + pl.buf_mask);
        const int* bexcl = reinterpret_cast<const int*>(buf + pl.buf_excl);
        const float4* img = reinterpret_cast<const float4*>(buf + pl.buf_img);
        if (active) {
            for (int s = ca + q; s < cb; s += NQ) {
                float gre[KMAX], gim[KMAX];
#pragma unroll
                for (int k = 0; k < KMAX; ++k) { gre[k] = 0.f; gim[k] = 0.f; }
                uint32_t bits = bmask[s];
                const float4* slot = img + (size_t)(bexcl[s] - e0) * (NW / 4);
                while (bits) {
                    const int t = __ffs(bits) - 1;
                    bits &= bits - 1;
                    float v[NW];
#pragma unroll
                    for (int w = 0; w < NW / 4; ++w) {
                        const float4 x = slot[w];
                        v[4 * w] = x.x; v[4 * w + 1] = x.y;
                        v[4 * w + 2] = x.z; v[4 * w + 3] = x.w;
                    }
                    slot += NW / 4;
                    dg_slot<KMAX, RMAX>(gre, gim, v,
                                        dcs + (size_t)t * row_floats + cl, K,
                                        R, cs);
                }
                float* o = dgg + ((size_t)p * TS + s) * M + c0 + cl;
#pragma unroll
                for (int k = 0; k < KMAX; ++k)
                    if (k < K) {
                        o[k * 2 * C] = gre[k];
                        o[k * 2 * C + C] = gim[k];
                    }
            }
        }
        __syncwarp();
        if ((tid & 31) == 0) pipe::mbar_arrive(empty + b);  // pass summed
    }
}

// --- launch ------------------------------------------------------------------------

size_t round4(size_t n) { return (n + 3) / 4 * 4; }

// How one call is cut up, and where its scratch lies in the buffer the
// caller owns (floats, 16-byte aligned): contrib, then dc over it; the dW
// partials; dgg.
struct CallPlan {
    pipe::Plan p1;
    DgPlan p4;
    band::DwSlices dws;
    size_t part_at, dgg_at, floats;
};

bool shapes_supported(int P, int nb_out, int C, int K, int R, int TBt,
                      int TS, int O2)
{
    return P >= 1 && nb_out >= 1 && C >= 1 && C <= pipe::kThreads && K >= 1
        && K % 2 == 1 && K <= 5 && R >= 2 && R <= panel::kMaxRings
        && TBt >= 1 && TBt <= kMaxTargets && TS >= 1 && TS <= pipe::kMaxTB
        && O2 >= 1;
}

// The scratch alone needs no pointers (band_compact_bwd_scratch_floats); a
// launch also plans both walks (g, scratch and sten given).
cudaError_t make_plan(int P, int nb_out, int C, int K, int R, int TBt,
                      int TS, int O2, int elem, const void* g,
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
    const long long rows = (long long)nb_out * TBt;
    const int RM = R * 2 * K * C;
    pl->dws = band::dw_slices(rows, RM, O2, sms);
    pl->part_at = round4((size_t)rows * RM);
    pl->dgg_at = round4(pl->part_at + (size_t)pl->dws.slices * RM * O2);
    pl->floats = pl->dgg_at + (size_t)P * TS * 2 * K * C;
    if (!pipe::contrib_plan(C, K, R, TBt, TS, 1, elem, g, sten, limit,
                            &pl->p1, true)
        || !dg_plan(C, K, R, TBt, TS, elem, dg_threads(K), sten, scratch,
                    limit, &pl->p4))
        return cudaErrorInvalidValue;
    return cudaSuccess;
}

template <int KMAX, int RMAX, typename ST>
int launch(const float* dy, const float* g, const float* wmat,
           const ST* sten, const int* meta, const int* src_idx,
           const int* fold_order, const int* fold_ptr, float* dg, float* dw,
           float* scratch, int P, int nb_out, int C, int K, int R, int TBt,
           int TS, int O2, int n_g, const CallPlan& pl, cudaStream_t stream)
{
    const int rows = nb_out * TBt;
    const int M = 2 * K * C;
    const int RM = R * M;
    float* contrib = scratch;                // then dc, same layout
    float* part = scratch + pl.part_at;
    float* dgg = scratch + pl.dgg_at;

    cudaError_t err = pipe::launch_contrib<ST, true>(
        g, sten, meta, contrib, P, nb_out, C, K, R, TBt, 1, n_g, pl.p1,
        stream, src_idx);
    if (err != cudaSuccess) return (int)err;

    err = band::launch_dw(contrib, dy, part, dw, rows, RM, O2, pl.dws,
                          stream);
    if (err != cudaSuccess) return (int)err;

    err = panel::launch_dc(dy, wmat, contrib, rows, RM, O2, stream);
    if (err != cudaSuccess) return (int)err;

    constexpr int kThreads4 = dg_threads(KMAX);
    auto k4 = compact_dg_kernel<KMAX, RMAX, kThreads4, ST>;
    err = cudaFuncSetAttribute(
        k4, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.p4.bytes);
    if (err != cudaSuccess) return (int)err;
    k4<<<dim3((unsigned)nb_out, (unsigned)pl.p4.slices), kThreads4,
         pl.p4.bytes, stream>>>(contrib, sten, meta, dgg, P, C, K, R, TBt,
                                TS, pl.p4, panel::ring_knots(R));
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

    return (int)fold::launch_fold(dgg, fold_order, fold_ptr, dg, n_g, M,
                                  stream);
}

// The instantiation for (K, R): K ≤ 3 with R ≤ 3, K ≤ 3 with R ≤ 6, or
// K = 5 with R ≤ 6.
template <typename ST>
int launch_for(const float* dy, const float* g, const float* wmat,
               const void* sten, const int* meta, const int* src_idx,
               const int* fold_order, const int* fold_ptr, float* dg,
               float* dw, float* scratch, int P, int nb_out, int C, int K,
               int R, int TBt, int TS, int O2, int n_g, const CallPlan& pl,
               cudaStream_t s)
{
    const ST* st = static_cast<const ST*>(sten);
#define K6_BWD(KM, RMX)                                                       \
    return launch<KM, RMX, ST>(dy, g, wmat, st, meta, src_idx, fold_order,   \
                               fold_ptr, dg, dw, scratch, P, nb_out, C, K, R, \
                               TBt, TS, O2, n_g, pl, s)
    if (K <= 3 && R <= 3) K6_BWD(3, 3);
    if (K <= 3) K6_BWD(3, 6);
    K6_BWD(5, 6);
#undef K6_BWD
}

}  // namespace

// Floats of the scratch buffer band_compact_bwd needs for these sizes (0
// for sizes it does not take).
extern "C" long long band_compact_bwd_scratch_floats(int P, int nb_out,
                                                     int C, int K, int R,
                                                     int TBt, int TS, int O2)
{
    CallPlan pl;
    if (!shapes_supported(P, nb_out, C, K, R, TBt, TS, O2)
        || make_plan(P, nb_out, C, K, R, TBt, TS, O2, 4, nullptr, nullptr,
                     nullptr, &pl) != cudaSuccess)
        return 0;
    return (long long)pl.floats;
}

// Launches the five passes (six kernels) on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for shapes
// they do not take (K odd ≤ 5, 2 ≤ R ≤ 6, C ≤ 256, TBt ≤ 32, TS ≤ 128;
// n_g a multiple of TBt; or walks above the shared memory a CTA can
// have).  dy: (nb_out·TBt, O2); g, dg: (n_g, M); fold_order and fold_ptr
// (n_g + 1) the table's fold index; scratch holds
// band_compact_bwd_scratch_floats floats, owned by the caller; sten
// float32, or bfloat16 when sten_bf16 is set.
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
    CallPlan pl;
    const cudaError_t err = make_plan(P, nb_out, C, K, R, TBt, TS, O2,
                                      sten_bf16 ? 2 : 4, g, scratch, sten,
                                      &pl);
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
