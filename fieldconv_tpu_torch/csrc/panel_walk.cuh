// The panel walk of K6's forward (band_compact_fwd.cu, GATHER) and of the
// contrib pass of K6's backward (panel_bwd.cuh): the per-slot coefficients
// of a panel stencil, their compaction into lists of occupied slots, the
// contrib accumulation over a target block's run of panels, and the
// forward's filter stage.  K4 (band_window.cuh, band_bwd.cuh) rebuilds its
// compressed slots with ring_knots, hat and phasor_powers; K5 (since its
// redesign, panel_pipe.cuh) uses only Knots, ring_knots, hat and
// lower_bound from here, so the non-GATHER paths below are K5's former
// walk and serve no kernel now.
//
// A panel stencil (P, planes, TB, TS) holds rows the target slot t and
// columns the source slot s.  K5's panels are square (TS = TB) and column s
// of a panel whose source block is b reads g's row b·TB + s; K6's compact
// panels (GATHER) are TB × TS and column s of panel p reads g's row
// src_idx[p·TS + s].  Its planes are compressed (5: r, e^{iθ}
// re/im, wxp re/im, r = R_SENTINEL at empty slots) or dense (R+2K: the R
// radial hats, then fwxp_k re/im).  A slot's NC = R + 2K coefficients are
// its R radial hats (from r: the hat on the ring knots, ops/band_conv.py::
// _hats_from_r) and its K complex factors f_k = wxp·e^{i(k−B)θ} (built by
// repeated multiplication with the unit phasor in _phasor_pairs' order), or
// the dense planes read as they are.  A slot is occupied when any radial
// hat is nonzero there; skipping the others is exact.  Hats and phasor
// powers are formed with uncontracted, correctly rounded operations in the
// plain version's order.  The stencil is f32 or bf16 (ST, read through
// sten_load.cuh::load_sten as f32).

#pragma once

#include "sten_load.cuh"

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace panel {

constexpr int kMaxThreads = 256;
constexpr int kTile = 8;          // most targets (or sources) per CTA
constexpr int kMaxRings = 6;

// ring r's hat of a compressed slot: clamp(min((rv − lo)·up, (hi − rv)·dn),
// 0, 1), knots as ops/band_conv.py::_hats_from_r forms them
struct Knots {
    float lo[kMaxRings], hi[kMaxRings], up[kMaxRings], dn[kMaxRings];
};

inline Knots ring_knots(int R)
{
    // knots sqrt(r / (R − 1)) with virtual knots −1 and 2 at the ends, the
    // slopes' reciprocals taken in double and rounded once
    Knots kn{};
    for (int r = 0; r < R; ++r) {
        const double sc = std::sqrt((double)r / (R - 1));
        const double sl = r > 0 ? std::sqrt((double)(r - 1) / (R - 1)) : -1.0;
        const double sr = r < R - 1 ? std::sqrt((double)(r + 1) / (R - 1))
                                    : 2.0;
        kn.lo[r] = (float)sl;
        kn.hi[r] = (float)sr;
        kn.up[r] = (float)(1.0 / (sc - sl));
        kn.dn[r] = (float)(1.0 / (sr - sc));
    }
    return kn;
}

// Threads of a CTA holding T rows × C channels, in whole warps.
inline int threads_for(int T, int C)
{
    return (T * C + 31) / 32 * 32;
}

// Floats of shared memory of T lists of occupied slots (coefficients,
// slot indices, lengths) over TB slots each.
inline size_t list_floats(int K, int R, int TB, int T)
{
    return (size_t)T * TB * (R + 2 * (size_t)K + 1) + T;
}

__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n,
                                           int v)
{
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(a + mid) < v) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

__device__ __forceinline__ float hat(float rv, int r, const Knots& kn)
{
    const float a = __fmul_rn(__fsub_rn(rv, kn.lo[r]), kn.up[r]);
    const float b = __fmul_rn(__fsub_rn(kn.hi[r], rv), kn.dn[r]);
    return fminf(fmaxf(fminf(a, b), 0.f), 1.f);
}

// f_k = wxp·e^{i(k−B)θ} re/im for k = 0..2B into cf[2k·stride] and
// cf[(2k+1)·stride], from the unit phasor (pr, pi) and wxp (fr, fi): built
// by repeated multiplication in _phasor_pairs' order and rounding (also
// used by K4, band_window.cuh).
__device__ __forceinline__ void phasor_powers(float* cf, int stride, float pr,
                                              float pi, float fr, float fi,
                                              int B)
{
    float cpr = fr, cpi = fi, cmr = fr, cmi = fi;
    cf[2 * B * stride] = cpr;
    cf[(2 * B + 1) * stride] = cpi;
    for (int kk = 1; kk <= B; ++kk) {
        const float npr = __fsub_rn(__fmul_rn(cpr, pr), __fmul_rn(cpi, pi));
        const float npi = __fadd_rn(__fmul_rn(cpr, pi), __fmul_rn(cpi, pr));
        const float nmr = __fadd_rn(__fmul_rn(cmr, pr), __fmul_rn(cmi, pi));
        const float nmi = __fsub_rn(__fmul_rn(cmi, pr), __fmul_rn(cmr, pi));
        cpr = npr; cpi = npi; cmr = nmr; cmi = nmi;
        cf[2 * (B + kk) * stride] = cpr;
        cf[(2 * (B + kk) + 1) * stride] = cpi;
        cf[2 * (B - kk) * stride] = cmr;
        cf[(2 * (B - kk) + 1) * stride] = cmi;
    }
}

// The coefficients of the occupied slot at offset `at` of panel sp's
// planes: its hats h, then f_k re/im for k = 0..K−1 (f_k, k = −B..B, built
// by phasor_powers when compressed, read when dense).
template <int RMAX, typename ST = float>
__device__ __forceinline__ void slot_coefs(
    float* cf, const float (&h)[RMAX], const ST* __restrict__ sp, size_t at,
    size_t plane, int R, int K, int compressed)
{
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
        if (r < R) cf[r] = h[r];
    if (compressed) {
        const float pr = load_sten(sp, plane + at);
        const float pi = load_sten(sp, 2 * plane + at);
        const float fr = load_sten(sp, 3 * plane + at);
        const float fi = load_sten(sp, 4 * plane + at);
        phasor_powers(cf + R, 1, pr, pi, fr, fi, K / 2);
    } else {
        for (int q = 0; q < 2 * K; ++q)
            cf[R + q] = load_sten(sp, (R + q) * plane + at);
    }
}

// Appends the slot held by this lane (hats h, offset `at` in the planes,
// index `idx` in its list) to a warp's list (coefficients ct[j][NC],
// indices st[j]) if it is occupied; every lane of the warp calls it.  The
// list keeps lane order.  Returns the list's new length.  GATHER: the index
// kept is the column's source row srow[idx], and a slot whose source row
// lies outside [0, n_rows) counts as empty.
template <int RMAX, bool GATHER = false, typename ST = float>
__device__ __forceinline__ int append_slot(
    float* ct, int* st, int base, const float (&h)[RMAX],
    const ST* __restrict__ sp, size_t at, int idx, size_t plane, int R,
    int K, int compressed, const int* __restrict__ srow = nullptr,
    int n_rows = 0)
{
    bool occ = false;
#pragma unroll
    for (int r = 0; r < RMAX; ++r) occ |= h[r] != 0.f;
    if (GATHER && occ) {
        idx = __ldg(srow + idx);
        occ = (unsigned)idx < (unsigned)n_rows;
    }
    const int lane = threadIdx.x & 31;
    const unsigned m = __ballot_sync(0xffffffffu, occ);
    if (occ) {
        const int j = base + __popc(m & ((1u << lane) - 1u));
        slot_coefs<RMAX, ST>(ct + (size_t)j * (R + 2 * K), h, sp, at, plane,
                             R, K, compressed);
        st[j] = idx;
    }
    return base + __popc(m);
}

// Compacts slot s = s0 + lane of one target row of panel sp (TS columns)
// into the row's list; every lane of the warp calls it with its own s.
// GATHER: the list keeps each slot's source row srow[s] (append_slot).
template <int RMAX, bool GATHER = false, typename ST = float>
__device__ __forceinline__ int compact_chunk(
    float* ct, int* st, int base, const ST* __restrict__ sp, size_t row,
    int s, size_t plane, int TS, int R, int K, int compressed,
    const Knots& kn, const int* __restrict__ srow = nullptr, int n_rows = 0)
{
    float h[RMAX];
    const float rv = (compressed && s < TS) ? load_sten(sp, row + s) : 0.f;
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
        float v = 0.f;
        if (r < R && s < TS)
            v = compressed ? hat(rv, r, kn)
                           : load_sten(sp, r * plane + row + s);
        h[r] = v;
    }
    return append_slot<RMAX, GATHER, ST>(ct, st, base, h, sp, row + s, s,
                                         plane, R, K, compressed, srow,
                                         n_rows);
}

// One occupied slot of a thread's target: its channel of the source row gr
// of g (k-major, re then im), times f_k, added with each ring's hat.
template <int KMAX, int RMAX>
__device__ __forceinline__ void accumulate_slot(
    float (&are)[KMAX][RMAX], float (&aim)[KMAX][RMAX],
    const float* __restrict__ gr, const float* cf, int C, int K, int R)
{
    float hs[RMAX];
#pragma unroll
    for (int r = 0; r < RMAX; ++r) hs[r] = r < R ? cf[r] : 0.f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
        if (k < K) {
            const float xr = __ldg(gr + k * 2 * C);
            const float xi = __ldg(gr + k * 2 * C + C);
            const float fr = cf[R + 2 * k];
            const float fi = cf[R + 2 * k + 1];
            const float hr = fr * xr - fi * xi;
            const float hi = fr * xi + fi * xr;
#pragma unroll
            for (int r = 0; r < RMAX; ++r) {
                are[k][r] = fmaf(hs[r], hr, are[k][r]);
                aim[k][r] = fmaf(hs[r], hi, aim[k][r]);
            }
        }
    }
}

// contrib of one (target, channel) thread over target block blk's run of
// panels in meta (4, P) rows (tgt, src, first, last), sorted by target:
//
//   are[k][r] + i·aim[k][r] = Σ_panels Σ_s hats_r(t, s)·f_k(t, s)·g[src·TB + s, k, c]
//
// for target t = t0 + it of a tile of nt ≤ T and channel c = ic.  Every
// thread of the CTA must call it (it synchronises); inactive threads keep
// zero sums.  smem: list_floats(K, R, TS, T) floats, free again on return.
// Per panel one warp per target row compacts the row's occupied slots into
// shared memory, once for all channels; only the r plane (or the hat
// planes) is read for every slot, the other planes only where a slot is
// occupied.  Panels whose source block lies outside [0, nb_g) add nothing.
// GATHER (K6: meta's second row is the panel id, panels TB × TS): column s
// of panel p reads g's row src_idx[p·TS + s] in place of src·TB + s, and a
// slot whose row lies outside [0, nb_g·TB) adds nothing.
template <int KMAX, int RMAX, bool GATHER = false, typename ST = float>
__device__ __forceinline__ void panel_contrib(
    float (&are)[KMAX][RMAX], float (&aim)[KMAX][RMAX], float* smem,
    const float* __restrict__ g, const ST* __restrict__ sten,
    const int* __restrict__ meta, int P, int C, int K, int R, int TB,
    int compressed, int nb_g, int T, int blk, int t0, int nt, bool active,
    int it, int ic, const Knots& kn,
    const int* __restrict__ src_idx = nullptr, int TS_ = 0)
{
    const int TS = GATHER ? TS_ : TB;        // columns of a panel
    const int M = 2 * K * C;
    const int NC = R + 2 * K;                // coefficients per occupied slot
    const int planes = compressed ? 5 : NC;
    float* coef = smem;                                      // [T][TS][NC]
    int* sidx = reinterpret_cast<int*>(coef + (size_t)T * TS * NC);  // [T][TS]
    int* cnt = sidx + T * TS;                                // [T]

#pragma unroll
    for (int k = 0; k < KMAX; ++k)
#pragma unroll
        for (int r = 0; r < RMAX; ++r) { are[k][r] = 0.f; aim[k][r] = 0.f; }

    const int p_lo = lower_bound(meta, P, blk);
    const int p_hi = lower_bound(meta, P, blk + 1);
    const size_t plane = (size_t)TB * TS;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;

    for (int p = p_lo; p < p_hi; ++p) {
        const int sblk = GATHER ? 0 : __ldg(meta + P + p);
        const int* srow = GATHER ? src_idx + (size_t)p * TS : nullptr;
        const ST* sp = sten + (size_t)p * planes * plane;
        __syncthreads();                     // the last panel's lists are read
        for (int t = warp; t < nt; t += nwarps) {
            const size_t row = (size_t)(t0 + t) * TS;
            float* ct = coef + (size_t)t * TS * NC;
            int* st = sidx + t * TS;
            int base = 0;
            for (int s0 = 0; s0 < TS; s0 += 32)
                base = compact_chunk<RMAX, GATHER, ST>(
                    ct, st, base, sp, row, s0 + lane, plane, TS, R, K,
                    compressed, kn, srow, nb_g * TB);
            if (lane == 0) cnt[t] = base;
        }
        __syncthreads();
        if (!active || (!GATHER && (sblk < 0 || sblk >= nb_g))) continue;
        const int n = cnt[it];
        const float* cf = coef + (size_t)it * TS * NC;
        const int* si = sidx + it * TS;
        const float* gb = g + (size_t)sblk * TB * M + ic;
        for (int j = 0; j < n; ++j)
            accumulate_slot<KMAX, RMAX>(are, aim, gb + (size_t)si[j] * M,
                                        cf + j * NC, C, K, R);
    }
    __syncthreads();                         // the lists are free again
}

// Bytes of shared memory of the forward (K5's and K6's): the panel walk's
// lists over TS columns, then the filter stage's staged contrib and
// partial sums.
inline size_t fwd_smem_bytes(int C, int K, int R, int TS, int O2, int T,
                             int nthr)
{
    const size_t M = 2 * (size_t)K * C;
    const size_t JG = nthr / O2 > 1 ? nthr / O2 : 1;
    const size_t lists = list_floats(K, R, TS, T);
    const size_t filter = (size_t)R * M * kTile + JG * (size_t)T * O2;
    return (lists > filter ? lists : filter) * sizeof(float);
}

// The forward's filter stage over a tile of nt ≤ T targets t0.. of target
// block blk (TB rows): each active (target it, channel ic) thread's contrib
// (are, aim) is staged in shared memory, then y[blk·TB + t0 + t, o] =
// Σ_j contrib[t, j]·W[j, o].  Every thread of the CTA must call it (it
// synchronises) after panel_contrib; smem as fwd_smem_bytes counts it.
// The output row is formed from blk, TB and t0 at the store: a pointer to
// the tile's rows passed in instead made K5's forward 3.4% slower at
// K = 5, R = 6 on an H100 (same registers, same results).
template <int KMAX, int RMAX>
__device__ __forceinline__ void filter_tile(
    const float (&are)[KMAX][RMAX], const float (&aim)[KMAX][RMAX],
    float* smem, const float* __restrict__ wmat, float* __restrict__ y,
    int blk, int TB, int t0, int C, int K, int R, int O2, int T, int nt,
    bool active, int it, int ic)
{
    const int M = 2 * K * C;
    const int RM = R * M;
    const int tid = threadIdx.x;
    const int nthr = blockDim.x;             // a multiple of 32
    // contrib[j][t] with j = r·M + k·2C + (p·C + c), targets padded to kTile
    float* contrib = smem;                   // [R·M][kTile]
    float* red = smem + (size_t)RM * kTile;  // [JG][T][O2]
    if (active) {
#pragma unroll
        for (int k = 0; k < KMAX; ++k)
#pragma unroll
            for (int r = 0; r < RMAX; ++r)
                if (k < K && r < R) {
                    const int j = r * M + k * 2 * C + ic;
                    contrib[j * kTile + it] = are[k][r];
                    contrib[(j + C) * kTile + it] = aim[k][r];
                }
    }
    __syncthreads();

    // y[t, o] = Σ_j contrib[j][t] · W[j, o]: thread (o, jg) sums j ≡ jg
    // (mod JG) for every target of the tile, so W is read once per CTA;
    // the JG partials are reduced through `red` in a fixed order.
    const int JG = max(1, nthr / O2);
    for (int u = tid; u < O2 * JG; u += nthr) {
        const int o = u % O2, jg = u / O2;
        float acc[kTile];
#pragma unroll
        for (int t = 0; t < kTile; ++t) acc[t] = 0.f;
#pragma unroll 4
        for (int j = jg; j < RM; j += JG) {
            const float wv = __ldg(wmat + (size_t)j * O2 + o);
            const float4 a = *reinterpret_cast<const float4*>(contrib + j * kTile);
            const float4 b = *reinterpret_cast<const float4*>(contrib + j * kTile + 4);
            acc[0] = fmaf(a.x, wv, acc[0]);
            acc[1] = fmaf(a.y, wv, acc[1]);
            acc[2] = fmaf(a.z, wv, acc[2]);
            acc[3] = fmaf(a.w, wv, acc[3]);
            acc[4] = fmaf(b.x, wv, acc[4]);
            acc[5] = fmaf(b.y, wv, acc[5]);
            acc[6] = fmaf(b.z, wv, acc[6]);
            acc[7] = fmaf(b.w, wv, acc[7]);
        }
#pragma unroll
        for (int t = 0; t < kTile; ++t)
            if (t < nt) red[(jg * T + t) * O2 + o] = acc[t];
    }
    __syncthreads();
    for (int u = tid; u < nt * O2; u += nthr) {
        const int o = u % O2, t = u / O2;
        float acc = 0.f;
        for (int jg = 0; jg < JG; ++jg) acc += red[(jg * T + t) * O2 + o];
        y[((size_t)blk * TB + t0 + t) * O2 + o] = acc;
    }
}

}  // namespace panel
