// The panel walk shared by K5's forward (band_panel_fwd.cu) and backward
// (band_panel_bwd.cu): the per-slot coefficients of a panel stencil, their
// compaction into lists of occupied slots, and the forward's contrib
// accumulation over a target block's run of panels.
//
// A panel stencil (P, planes, TB, TB) holds rows the target slot t and
// columns the source slot s.  Its planes are compressed (5: r, e^{iθ}
// re/im, wxp re/im, r = R_SENTINEL at empty slots) or dense (R+2K: the R
// radial hats, then fwxp_k re/im).  A slot's NC = R + 2K coefficients are
// its R radial hats (from r: the hat on the ring knots, ops/band_conv.py::
// _hats_from_r) and its K complex factors f_k = wxp·e^{i(k−B)θ} (built by
// repeated multiplication with the unit phasor in _phasor_pairs' order), or
// the dense planes read as they are.  A slot is occupied when any radial
// hat is nonzero there; skipping the others is exact.  Hats and phasor
// powers are formed with uncontracted, correctly rounded operations in the
// plain version's order.

#pragma once

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

// The coefficients of the occupied slot at offset `at` of panel sp's
// planes: its hats h, then f_k re/im for k = 0..K−1 (f_k, k = −B..B, built
// in _phasor_pairs' order and rounding when compressed, read when dense).
template <int RMAX>
__device__ __forceinline__ void slot_coefs(
    float* cf, const float (&h)[RMAX], const float* __restrict__ sp,
    size_t at, size_t plane, int R, int K, int compressed)
{
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
        if (r < R) cf[r] = h[r];
    if (compressed) {
        const int B = K / 2;
        const float pr = __ldg(sp + plane + at);
        const float pi = __ldg(sp + 2 * plane + at);
        float cpr = __ldg(sp + 3 * plane + at);
        float cpi = __ldg(sp + 4 * plane + at);
        float cmr = cpr, cmi = cpi;
        cf[R + 2 * B] = cpr;
        cf[R + 2 * B + 1] = cpi;
        for (int kk = 1; kk <= B; ++kk) {
            const float npr = __fsub_rn(__fmul_rn(cpr, pr),
                                        __fmul_rn(cpi, pi));
            const float npi = __fadd_rn(__fmul_rn(cpr, pi),
                                        __fmul_rn(cpi, pr));
            const float nmr = __fadd_rn(__fmul_rn(cmr, pr),
                                        __fmul_rn(cmi, pi));
            const float nmi = __fsub_rn(__fmul_rn(cmi, pr),
                                        __fmul_rn(cmr, pi));
            cpr = npr; cpi = npi; cmr = nmr; cmi = nmi;
            cf[R + 2 * (B + kk)] = cpr;
            cf[R + 2 * (B + kk) + 1] = cpi;
            cf[R + 2 * (B - kk)] = cmr;
            cf[R + 2 * (B - kk) + 1] = cmi;
        }
    } else {
        for (int q = 0; q < 2 * K; ++q)
            cf[R + q] = __ldg(sp + (R + q) * plane + at);
    }
}

// Appends the slot held by this lane (hats h, offset `at` in the planes,
// index `idx` in its list) to a warp's list (coefficients ct[j][NC],
// indices st[j]) if it is occupied; every lane of the warp calls it.  The
// list keeps lane order.  Returns the list's new length.
template <int RMAX>
__device__ __forceinline__ int append_slot(
    float* ct, int* st, int base, const float (&h)[RMAX],
    const float* __restrict__ sp, size_t at, int idx, size_t plane, int R,
    int K, int compressed)
{
    bool occ = false;
#pragma unroll
    for (int r = 0; r < RMAX; ++r) occ |= h[r] != 0.f;
    const int lane = threadIdx.x & 31;
    const unsigned m = __ballot_sync(0xffffffffu, occ);
    if (occ) {
        const int j = base + __popc(m & ((1u << lane) - 1u));
        slot_coefs<RMAX>(ct + (size_t)j * (R + 2 * K), h, sp, at, plane, R, K,
                         compressed);
        st[j] = idx;
    }
    return base + __popc(m);
}

// Compacts slot s = s0 + lane of one target row of panel sp into the row's
// list; every lane of the warp calls it with its own s.
template <int RMAX>
__device__ __forceinline__ int compact_chunk(
    float* ct, int* st, int base, const float* __restrict__ sp, size_t row,
    int s, size_t plane, int TB, int R, int K, int compressed,
    const Knots& kn)
{
    float h[RMAX];
    const float rv = (compressed && s < TB) ? __ldg(sp + row + s) : 0.f;
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
        float v = 0.f;
        if (r < R && s < TB)
            v = compressed ? hat(rv, r, kn) : __ldg(sp + r * plane + row + s);
        h[r] = v;
    }
    return append_slot<RMAX>(ct, st, base, h, sp, row + s, s, plane, R, K,
                             compressed);
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
// zero sums.  smem: list_floats(K, R, TB, T) floats, free again on return.
// Per panel one warp per target row compacts the row's occupied slots into
// shared memory, once for all channels; only the r plane (or the hat
// planes) is read for every slot, the other planes only where a slot is
// occupied.  Panels whose source block lies outside [0, nb_g) add nothing.
template <int KMAX, int RMAX>
__device__ __forceinline__ void panel_contrib(
    float (&are)[KMAX][RMAX], float (&aim)[KMAX][RMAX], float* smem,
    const float* __restrict__ g, const float* __restrict__ sten,
    const int* __restrict__ meta, int P, int C, int K, int R, int TB,
    int compressed, int nb_g, int T, int blk, int t0, int nt, bool active,
    int it, int ic, const Knots& kn)
{
    const int M = 2 * K * C;
    const int NC = R + 2 * K;                // coefficients per occupied slot
    const int planes = compressed ? 5 : NC;
    float* coef = smem;                                      // [T][TB][NC]
    int* sidx = reinterpret_cast<int*>(coef + (size_t)T * TB * NC);  // [T][TB]
    int* cnt = sidx + T * TB;                                // [T]

#pragma unroll
    for (int k = 0; k < KMAX; ++k)
#pragma unroll
        for (int r = 0; r < RMAX; ++r) { are[k][r] = 0.f; aim[k][r] = 0.f; }

    const int p_lo = lower_bound(meta, P, blk);
    const int p_hi = lower_bound(meta, P, blk + 1);
    const size_t plane = (size_t)TB * TB;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;

    for (int p = p_lo; p < p_hi; ++p) {
        const int sblk = __ldg(meta + P + p);
        const float* sp = sten + (size_t)p * planes * plane;
        __syncthreads();                     // the last panel's lists are read
        for (int t = warp; t < nt; t += nwarps) {
            const size_t row = (size_t)(t0 + t) * TB;
            float* ct = coef + (size_t)t * TB * NC;
            int* st = sidx + t * TB;
            int base = 0;
            for (int s0 = 0; s0 < TB; s0 += 32)
                base = compact_chunk<RMAX>(ct, st, base, sp, row, s0 + lane,
                                           plane, TB, R, K, compressed, kn);
            if (lane == 0) cnt[t] = base;
        }
        __syncthreads();
        if (!active || sblk < 0 || sblk >= nb_g) continue;
        const int n = cnt[it];
        const float* cf = coef + (size_t)it * TB * NC;
        const int* si = sidx + it * TB;
        const float* gb = g + (size_t)sblk * TB * M + ic;
        for (int j = 0; j < n; ++j)
            accumulate_slot<KMAX, RMAX>(are, aim, gb + (size_t)si[j] * M,
                                        cf + j * NC, C, K, R);
    }
    __syncthreads();                         // the lists are free again
}

}  // namespace panel
