// The banded convs on the pipelined panel walk (panel_pipe.cuh): K1 (the
// dense band), K9 (a shard's range of it over a halo-extended source
// array) and K4 (the compressed band): the forward's contrib and the
// backward's pass 1 (by target), and the backward's dG (by source).
// band_call.cuh runs them as a call; band_fused_fwd.cu and band_fused_bwd.cu
// say what they compute and why the design is so.
//
// A dense band is (2nh+1) square TB × TB panels a target block: panel j of
// block b is sten_band[m, b, :, :, j·TB:(j+1)·TB], R+2K planes whose rows
// lie W' = (2nh+1)·TB elements apart, reading source block b − nh + j.  A
// band of TB > 128 (panel_pipe.cuh's kMaxTB: four mask words) is walked in
// virtual blocks of TBv = TB / np rows (np the fewest pieces for which TBv
// ≤ 128 divides TB): virtual target block (b, h) reads the virtual source
// blocks of b's window, each a TBv × TBv piece of the band.  Panels whose
// source block lies outside the source array are never visited.
//
// A launch's range (BandGeo).  K9 launches target blocks lo .. hi − 1 of
// a shard's band, block b's window starting at block b + boff of a source
// array of nsb blocks a mesh; K1 is lo = 0, hi = nb, boff = −nh over g
// itself, and runs the same code.  contrib, dc and dy hold the range's
// rows; dG every row of the source array, a source block that no target
// of the range reads getting zeros.
//
// Occupancy.  The walk finds a panel's occupied slots in a slab that it
// copies ahead of the panel.  K5's dense mode stages the R hat planes
// whole; at K1's tiles that is R·32·128·4 bytes a stage by target and
// R·128·48·4 by source (98 KB at R = 6), which leaves no room for passes.
// So a first kernel (occ_kernel) reads the hat planes once and writes one
// byte a slot (any hat nonzero) into a panel-major array: virtual panel
// (tv, jv), jv = the source's virtual block − tv's window start, as TBv
// rows of TBvp = TBv rounded up to 16 bytes.  The slab is then one byte
// plane (4 KB by target, 6 KB by source at T = 32), each stage one bulk
// copy (cp.async.bulk) by target and 16-byte cp.async copies of the
// tile's short rows by source; every copy is 16-byte aligned by the
// padding, whatever TB is.  A slot's image copies its R + 2K planes (hats
// too) at occupied slots only, 4 bytes each by cp.async from the band's
// strided rows, and the consumers read it back as float4s.
//
// A compressed band (K4: 5 planes r, e^{iθ}, wxp) runs the same walks: the
// first kernel writes K1's occupancy bytes from the r plane, a slot
// occupied where r_lo < r < r_hi on the outermost ring knots (every slot
// with a nonzero hat; one whose hats are all 0 adds exact zeros;
// R_SENTINEL lies outside), a slot's image copies its 5 words, and once a
// pass has landed its slots are expanded into K1's dense image (hats,
// f_k), which K1's consumers read (expand_pass; band_cfused_fwd.cu).
//
// dG at K = 5.  The dc rows a source tile stages hold R·M floats (7.7 KB
// at C = 32, R = 6), which left one CTA an SM and its consumers a branch a
// ring and k.  So a CTA there covers one frequency (blockIdx.y), over dc
// laid out channel-major a frequency (its rows are dy·W'ᵀ, W' = W's rows
// reordered, cm_w_kernel): a frequency's row is C·12 floats, two CTAs fit
// an SM, and a consumer reads its channel's rings as three float4s, a pair
// of rings whose hats are both zero skipped.

#pragma once

#include "panel_pipe.cuh"

#include <algorithm>
#include <atomic>
#include <cstddef>
#include <cstdint>

namespace bandpipe {

using pipe::Plan;

// The band's shape, its virtual blocks, and the launch's range: target
// blocks lo .. lo + nr − 1 of each mesh's nb, block b's window starting at
// source block b + boff of a source array of nsb blocks a mesh (K1: the
// whole band over g itself, lo = 0, nr = nb, boff = −nh, nsb = nb; K9: a
// shard's range over its halo-extended rows).
struct BandGeo {
    int nb;          // stencil blocks of a mesh (N / TB)
    int nh, TB, Wp;  // W' = (2nh+1)·TB
    int P;           // planes: R + 2K, or 5 (compressed)
    int np, TBv;     // pieces a block, rows a virtual block (TB / np)
    int TBvp;        // slab row: TBv rounded up to 16 elements
    int Jv;          // virtual panels a window: (2nh+1)·np
    int lo, nr;      // the launch's target blocks
    int boff, nsb;   // window start − target block; source blocks a mesh
};

inline BandGeo band_geo(int N, int TB, int nh, int P)
{
    BandGeo g;
    g.nb = N / TB;
    g.nh = nh;
    g.TB = TB;
    g.Wp = (2 * nh + 1) * TB;
    g.P = P;
    g.np = (TB + pipe::kMaxTB - 1) / pipe::kMaxTB;
    while (TB % g.np) ++g.np;
    g.TBv = TB / g.np;
    g.TBvp = (g.TBv + 15) / 16 * 16;
    g.Jv = (2 * nh + 1) * g.np;
    g.lo = 0;
    g.nr = g.nb;
    g.boff = -nh;
    g.nsb = g.nb;
    return g;
}

// The band of a K9 launch: target blocks [lo, hi) over a source array of
// n_src rows a mesh whose block b + blk_off starts block b's window.
inline BandGeo range_geo(BandGeo g, int n_src, int blk_off, int lo, int hi)
{
    g.nsb = n_src / g.TB;
    g.boff = blk_off;
    g.lo = lo;
    g.nr = hi - lo;
    return g;
}

// Bytes of the occupancy array of n_mesh meshes (the launch's target
// blocks).
inline size_t occ_bytes(int n_mesh, const BandGeo& g)
{
    return (size_t)n_mesh * g.nr * g.np * g.Jv * g.TBv * g.TBvp;
}

// The occupancy array, panel-major: slot (row t = h·TBv + t' of target
// block b, window slot w = jv·TBv + s') at [((tv·Jv + jv)·TBv + t')·TBvp +
// s'], tv = (m·nr + b − lo)·np + h, 1 where any of the R hat planes is
// nonzero (COMP, a compressed band: where r_lo < r < r_hi, r its plane 0).
// V slots a thread (4 where rows and pieces allow float4 loads).
template <int V, bool COMP>
__global__ void __launch_bounds__(256)
occ_kernel(const float* __restrict__ sten, unsigned char* __restrict__ occ,
           long long items, int R, BandGeo g, float r_lo, float r_hi)
{
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= items) return;
    const int wv = g.Wp / V;
    const long long row = i / wv;            // (m·nr + b − lo)·TB + t
    const int w = (int)(i - row * wv) * V;
    const long long rb = row / g.TB;         // m·nr + b − lo
    const int t = (int)(row - rb * g.TB);
    long long gb = rb;                       // m·nb + b (the whole band: rb)
    if (g.nr != g.nb) {
        const long long m = rb / g.nr;
        gb = m * g.nb + g.lo + (rb - m * g.nr);
    }
    const float* s = sten + ((size_t)gb * g.P * g.TB + t) * g.Wp + w;
    const long long tv = rb * g.np + t / g.TBv;
    const int jv = w / g.TBv;
    unsigned char* o = occ
        + (((size_t)tv * g.Jv + jv) * g.TBv + t % g.TBv) * g.TBvp + w % g.TBv;
    const size_t plane = (size_t)g.TB * g.Wp;
    bool nz[V];
#pragma unroll
    for (int v = 0; v < V; ++v) nz[v] = false;
    auto occupied = [&](float x) {
        return COMP ? x > r_lo && x < r_hi : x != 0.f;
    };
    for (int r = 0; r < (COMP ? 1 : R); ++r) {
        if constexpr (V == 4) {
            const float4 x =
                __ldg(reinterpret_cast<const float4*>(s + r * plane));
            nz[0] |= occupied(x.x);
            nz[1] |= occupied(x.y);
            nz[2] |= occupied(x.z);
            nz[3] |= occupied(x.w);
        } else {
            nz[0] |= occupied(__ldg(s + r * plane));
        }
    }
    if constexpr (V == 4)
        *reinterpret_cast<uchar4*>(o) = make_uchar4(nz[0], nz[1], nz[2], nz[3]);
    else
        *o = nz[0];
}

template <bool COMP>
cudaError_t launch_occ(const float* sten, unsigned char* occ, int n_mesh,
                       int R, const BandGeo& g, cudaStream_t stream)
{
    const bool vec = g.TBv % 4 == 0 && (uintptr_t)sten % 16 == 0;
    const long long slots = (long long)n_mesh * g.nr * g.TB * g.Wp;
    const long long items = vec ? slots / 4 : slots;
    const unsigned blocks = (unsigned)((items + 255) / 256);
    // the outermost ring knots (compressed)
    const panel::Knots kn = COMP ? panel::ring_knots(R) : panel::Knots{};
    const float r_lo = kn.lo[0], r_hi = COMP ? kn.hi[R - 1] : 0.f;
    if (vec)
        occ_kernel<4, COMP><<<blocks, 256, 0, stream>>>(sten, occ, items, R,
                                                         g, r_lo, r_hi);
    else
        occ_kernel<1, COMP><<<blocks, 256, 0, stream>>>(sten, occ, items, R,
                                                         g, r_lo, r_hi);
    return cudaGetLastError();
}

// --- compressed slots -----------------------------------------------------------------------
//
// A compressed band's slot image, as the walk builds it, is [e^{iθ} re,
// im, wxp re, im, r] (BandRun::kRawR).  Once a pass has landed, the
// consuming group rewrites each occupied slot of it in place, once
// (expand_pass), into the dense image [R hats | f_k re, im for the walk's
// KG frequencies k0 ..]: the hats on the ring knots (panel_walk.cuh::hat)
// and f_k from e^{iθ} and wxp as panel_pipe.cuh::phasors forms them
// (uncontracted, correctly rounded, by |k − B| products from f_B = wxp).
// The consumers then read it as they read a dense band's: the hats and
// phasor powers cost a slot once, not once a slot and channel, and the
// image is no wider than K1's (max(5, R + 2·KG) words rounded to 4,
// walk_plan), so dG's passes hold as many far rows as K1's.  Measured on
// an H100 (K = 5, R = 6, C = 32 and 48, versions side by side): the f_k
// formed in each consumer ran the contrib walk 1.6x and dG 1.5x K1's; the
// r plane as the slab (the building threads forming the hats, images of
// 4 + R words) left dG 10 far rows a pass where K1 has 19, 7-13% slower
// than this; the producer warps forming the f_k by source, once their copies
// landed, ran dG 7-17% slower than the consumers' expansion.

template <int KMAX>
__device__ __forceinline__ void expand_slot(uint32_t* slot, int R, int K,
                                            int KG, int k0,
                                            const pipe::Knots& kn)
{
    const float4 raw = *reinterpret_cast<const float4*>(slot);
    const float rv = __uint_as_float(slot[4]);
    float h[panel::kMaxRings];
#pragma unroll
    for (int r = 0; r < panel::kMaxRings; ++r)
        h[r] = r < R ? panel::hat(rv, r, kn) : 0.f;
    float fre[KMAX], fim[KMAX];
    if (KG == 1) {                           // f_k0 alone
        float cr = raw.z, ci = raw.w;
        const int dk = k0 - K / 2;
        for (int q = 0; q < dk; ++q) {
            const float nr = __fsub_rn(__fmul_rn(cr, raw.x),
                                       __fmul_rn(ci, raw.y));
            const float ni = __fadd_rn(__fmul_rn(cr, raw.y),
                                       __fmul_rn(ci, raw.x));
            cr = nr; ci = ni;
        }
        for (int q = 0; q < -dk; ++q) {
            const float nr = __fadd_rn(__fmul_rn(cr, raw.x),
                                       __fmul_rn(ci, raw.y));
            const float ni = __fsub_rn(__fmul_rn(ci, raw.x),
                                       __fmul_rn(cr, raw.y));
            cr = nr; ci = ni;
        }
        fre[0] = cr;
        fim[0] = ci;
    } else if (K == 5) {
        if constexpr (KMAX >= 5)
            pipe::phasors<2, KMAX>(fre, fim, raw.x, raw.y, raw.z, raw.w);
    } else if (K == 3) {
        if constexpr (KMAX >= 3)
            pipe::phasors<1, KMAX>(fre, fim, raw.x, raw.y, raw.z, raw.w);
    } else {
        pipe::phasors<0, KMAX>(fre, fim, raw.x, raw.y, raw.z, raw.w);
    }
    float* out = reinterpret_cast<float*>(slot);
#pragma unroll
    for (int r = 0; r < panel::kMaxRings; ++r)
        if (r < R) out[r] = h[r];
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
        if (k < KG) {
            out[R + 2 * k] = fre[k];
            out[R + 2 * k + 1] = fim[k];
        }
}

// The run of a walk block: by target virtual block blk = tv (over the
// launch's range of every mesh) and the virtual source blocks of its window
// inside the source array, s = b + boff .. b + boff + 2nh inside [0, nsb);
// by source virtual block blk = sv (over the source arrays) and the virtual
// target blocks whose window holds it, b = s − boff − 2nh .. s − boff inside
// [lo, lo + nr), all np pieces of each, ascending.  Far rows: g's (by
// target, the source arrays' n_mesh·nsb·TB rows) or dc's (by source, the
// range's n_mesh·nr·TB target rows); far index u of other block o is row
// o·TBv + u.  See panel_pipe.cuh::MetaRun for the interface.
template <bool BYSRC, bool COMP = false>
struct BandRun {
    // a compressed band: a slot image holds its 5 words (expand_pass)
    static constexpr bool kRawR = COMP;
    BandGeo g;
    int nb_far = 0;                // (GATHER only)
    int fk0 = 0;                   // a frequency group's first f_k plane − R
    int n = 0;
    int tbase = 0, sbase = 0;      // the mesh's first target / source block
    int lo = 0;                    // the run's first other block
    int self = 0, m = 0;           // blk; its mesh

    __device__ __forceinline__ void init(int blk)
    {
        const int ntv = g.nr * g.np, nsv = g.nsb * g.np;
        self = blk;
        int first, last;                    // original blocks of the run
        if constexpr (BYSRC) {
            m = blk / nsv;
            const int s = (blk - m * nsv) / g.np;
            first = max(g.lo, s - g.boff - 2 * g.nh);
            last = min(g.lo + g.nr - 1, s - g.boff);
            lo = (m * g.nr + first - g.lo) * g.np;
        } else {
            m = blk / ntv;
            const int b = g.lo + (blk - m * ntv) / g.np;
            first = max(0, b + g.boff);
            last = min(g.nsb - 1, b + g.boff + 2 * g.nh);
            lo = (m * g.nsb + first) * g.np;
        }
        n = max(0, last - first + 1) * g.np;
        tbase = m * ntv;
        sbase = m * nsv;
    }
    __device__ __forceinline__ int pid(int k) const { return k; }
    __device__ __forceinline__ int other(int k) const { return lo + k; }
    // (target virtual block tv, source virtual block sv), both global
    __device__ __forceinline__ int tgt(int o) const { return BYSRC ? o : self; }
    __device__ __forceinline__ int src(int o) const { return BYSRC ? self : o; }
    __device__ __forceinline__ size_t img(int, int o) const
    {
        const int tl = tgt(o) - tbase, svl = src(o) - sbase;
        const int b = g.lo + tl / g.np, h = tl % g.np;
        return ((size_t)(m * g.nb + b) * g.P * g.TB + (size_t)h * g.TBv)
                   * g.Wp
            + ((long long)svl * g.TBv - (long long)(b + g.boff) * g.TB);
    }
    __device__ __forceinline__ size_t slab(int, int o) const
    {
        const int tv = tgt(o), tl = tv - tbase, svl = src(o) - sbase;
        const int jv = svl - (g.lo + tl / g.np + g.boff) * g.np;
        return ((size_t)tv * g.Jv + jv) * g.TBv * g.TBvp;
    }
    __device__ __forceinline__ int far0(int o) const { return o * g.TBv; }
    __device__ __forceinline__ bool far_ok(int) const { return true; }
    __device__ __forceinline__ int img_rs() const { return g.Wp; }
    __device__ __forceinline__ int slab_rs() const { return g.TBvp; }
    __device__ __forceinline__ size_t img_plane() const
    {
        return (size_t)g.TB * g.Wp;
    }
    __device__ __forceinline__ size_t slab_plane() const
    {
        return (size_t)g.TBv * g.TBvp;
    }
};

// --- consumers ----------------------------------------------------------------------------
//
// panel_pipe.cuh's consumers read a dense slot image word by word; these
// read it as float4s where the slot's shape is the instantiation's (R =
// RMAX, K = KMAX), and sum the same terms in the same order.  Measured on
// an H100 at the serving shape (C = 32, K = 5, R = 6): the contrib walk
// 1.5x faster, dG 1.1x; at K = 3, R = 3 dG 1.3x.

// A slot's image words w[0 .. 4V) (16-byte aligned) as float4 loads.
template <int V>
__device__ __forceinline__ void image_words(float (&w)[4 * V],
                                            const uint32_t* slot)
{
#pragma unroll
    for (int q = 0; q < V; ++q) {
        const float4 v = reinterpret_cast<const float4*>(slot)[q];
        w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z;
        w[4 * q + 3] = v.w;
    }
}

// panel_pipe.cuh::consume_fwd, the image read as float4s (other shapes go
// to it).
template <int KMAX, int RMAX, int MT, int CPT>
__device__ __forceinline__ void consume_fwd(
    float (&are)[MT][KMAX][RMAX][CPT], float (&aim)[MT][KMAX][RMAX][CPT],
    const unsigned char* smem, const Plan& pl, int b, int C, int K, int R,
    int nt, bool active, int qi, int ic)
{
    constexpr int NV = (RMAX + 2 * KMAX + 3) / 4;   // float4s of an image
    if (R != RMAX || K != KMAX) {
        pipe::consume_fwd<KMAX, RMAX, MT, float, CPT>(
            are, aim, smem, pl, b, C, K, R, 0, nt, active, qi, ic);
        return;
    }
    if (!active) return;
    const int T = pl.T, UCAP = pl.UCAP, FW = pl.FW;
    const uint32_t* img = reinterpret_cast<const uint32_t*>(smem + pl.off_img)
        + (size_t)b * pl.img_words;
    const float* fb = reinterpret_cast<const float*>(smem + pl.off_far)
        + (size_t)b * UCAP * FW + ic;
    const uint32_t* pmask =
        reinterpret_cast<const uint32_t*>(smem + pl.off_pmask) + b * T;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
        const int l = qi + pl.NQ * m;
        if (l >= nt) continue;
        uint32_t bits = pmask[l];
        while (bits) {
            const int pc = __ffs(bits) - 1;
            bits &= bits - 1;
            float w[4 * NV];
            image_words<NV>(w, img + (size_t)(l * UCAP + pc) * pl.NIMG);
            const float* gr = fb + (size_t)pc * FW;
#pragma unroll
            for (int k = 0; k < KMAX; ++k) {
                float xr[CPT], xi[CPT];
                pipe::load_ch<CPT>(xr, gr + k * 2 * C);
                pipe::load_ch<CPT>(xi, gr + k * 2 * C + C);
                const float fr = w[RMAX + 2 * k], fi = w[RMAX + 2 * k + 1];
#pragma unroll
                for (int c = 0; c < CPT; ++c) {
                    const float hr = fr * xr[c] - fi * xi[c];
                    const float hi = fr * xi[c] + fi * xr[c];
#pragma unroll
                    for (int r = 0; r < RMAX; ++r) {
                        are[m][k][r][c] = fmaf(w[r], hr, are[m][k][r][c]);
                        aim[m][k][r][c] = fmaf(w[r], hi, aim[m][k][r][c]);
                    }
                }
            }
        }
    }
}

// panel_pipe.cuh::consume_dg (dc in contrib's layout), the image read as
// float4s (other shapes go to it).
template <int KMAX, int RMAX, int MT>
__device__ __forceinline__ void consume_dg(
    float (&gre)[MT][KMAX], float (&gim)[MT][KMAX], const unsigned char* smem,
    const Plan& pl, int b, int C, int K, int R, int nt, bool active, int qi,
    int ic)
{
    constexpr int NV = (RMAX + 2 * KMAX + 3) / 4;   // float4s of an image
    if (R != RMAX || K != KMAX) {
        pipe::consume_dg<KMAX, RMAX, MT, float>(gre, gim, smem, pl, b, C, K,
                                                R, 0, nt, active, qi, ic);
        return;
    }
    if (!active) return;
    const int T = pl.T, UCAP = pl.UCAP, FW = pl.FW;
    const int M = 2 * K * C;
    const uint32_t* img = reinterpret_cast<const uint32_t*>(smem + pl.off_img)
        + (size_t)b * pl.img_words;
    const float* fb = reinterpret_cast<const float*>(smem + pl.off_far)
        + (size_t)b * UCAP * FW + ic;
    const uint32_t* pmask =
        reinterpret_cast<const uint32_t*>(smem + pl.off_pmask) + b * T;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
        const int l = qi + pl.NQ * m;
        if (l >= nt) continue;
        uint32_t bits = pmask[l];
        while (bits) {
            const int pc = __ffs(bits) - 1;
            bits &= bits - 1;
            float w[4 * NV];
            image_words<NV>(w, img + (size_t)(l * UCAP + pc) * pl.NIMG);
            const float* dr = fb + (size_t)pc * FW;
#pragma unroll
            for (int k = 0; k < KMAX; ++k) {
                float ur = 0.f, ui = 0.f;
#pragma unroll
                for (int r = 0; r < RMAX; ++r) {
                    if (w[r] != 0.f) {
                        const float* d = dr + r * M + k * 2 * C;
                        ur = fmaf(w[r], d[0], ur);
                        ui = fmaf(w[r], d[C], ui);
                    }
                }
                const float fr = w[RMAX + 2 * k], fi = w[RMAX + 2 * k + 1];
                gre[m][k] = fmaf(fr, ur, fmaf(fi, ui, gre[m][k]));
                gim[m][k] = fmaf(fr, ui, fmaf(-fi, ur, gim[m][k]));
            }
        }
    }
}

// Expands a compressed band's pass buffer b: its occupied slots (local rows
// < nt), each once (expand_slot).  Every thread of the consuming group
// calls it (WS: the pl.nthr consumers, then their named barrier 2; else the
// CTA, then __syncthreads).
template <int KMAX, bool WS>
__device__ __forceinline__ void expand_pass(unsigned char* smem,
                                            const Plan& pl, int b, int R,
                                            int K, int KG, int k0, int nt,
                                            const pipe::Knots& kn)
{
    uint32_t* img = reinterpret_cast<uint32_t*>(smem + pl.off_img)
        + (size_t)b * pl.img_words;
    const uint32_t* pmask =
        reinterpret_cast<const uint32_t*>(smem + pl.off_pmask) + b * pl.T;
    const int n = WS ? pl.nthr : (int)blockDim.x;
    for (int i = threadIdx.x; i < nt * pl.UCAP; i += n) {
        const int l = i / pl.UCAP, pc = i - l * pl.UCAP;
        if ((pmask[l] >> pc) & 1u)
            expand_slot<KMAX>(img + (size_t)i * pl.NIMG, R, K, KG, k0, kn);
    }
    if constexpr (WS)
        asm volatile("bar.sync 2, %0;\n" :: "r"(pl.nthr) : "memory");
    else
        __syncthreads();
}

// --- contrib by target (the forward, and the backward's pass 1) ---------------------------

// contrib of every target row of the launch: one CTA per tile of T targets
// of a virtual block, MT a thread, written as (rows, R·M) row-major with
// column j = r·M + k·2C + (p·C + c) (panel_pipe.cuh::contrib_tile), rows
// the range's.  WS: warp-specialized (the walk's producer warps after
// pl.nthr consumers), CPT channels a consumer thread.  COMP: a compressed
// band, each landed pass expanded into the dense image (expand_pass, the
// hats on the knots kn).
template <int KMAX, int RMAX, int MT, int CPT, bool WS, bool COMP>
__global__ void __launch_bounds__(
    WS ? pipe::kCompactThreads + 32 * pipe::kProducerWarps : pipe::kThreads,
    WS ? 1 : 2)
contrib_kernel(const float* __restrict__ g, const float* __restrict__ sten,
               const unsigned char* __restrict__ occ,
               float* __restrict__ contrib, int C, int K, int R, BandGeo geo,
               Plan pl, pipe::Knots kn)
{
    const int M = 2 * K * C;
    const int RM = R * M;
    const int TB = geo.TBv;
    const int tiles = (TB + pl.T - 1) / pl.T;
    const int blk = blockIdx.x / tiles;
    const int l0 = (blockIdx.x % tiles) * pl.T;
    const int nt = min(pl.T, TB - l0);
    const int tid = threadIdx.x;
    const int tpt = C / CPT;                 // threads a target group
    const bool active = tid < pl.NQ * tpt;
    const int qi = active ? tid / tpt : 0;   // (target group, channels)
    const int ic = active ? tid % tpt * CPT : 0;

    extern __shared__ __align__(16) unsigned char smem[];
    float are[MT][KMAX][RMAX][CPT], aim[MT][KMAX][RMAX][CPT];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int k = 0; k < KMAX; ++k)
#pragma unroll
            for (int r = 0; r < RMAX; ++r)
#pragma unroll
                for (int c = 0; c < CPT; ++c) {
                    are[m][k][r][c] = 0.f;
                    aim[m][k][r][c] = 0.f;
                }
    BandRun<false, COMP> run{geo};
    pipe::walk<false, WS, RMAX, float, false, unsigned char>(
        smem, pl, sten, occ, run, g, R, K, 0, blk, l0, nt, pipe::Knots{},
        [&](int b) {
            if constexpr (COMP)
                expand_pass<KMAX, WS>(smem, pl, b, R, K, K, 0, nt, kn);
            bandpipe::consume_fwd<KMAX, RMAX, MT, CPT>(
                are, aim, smem, pl, b, C, K, R, nt, active, qi, ic);
        });
    if (!active) return;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
        const int l = qi + pl.NQ * m;
        if (l >= nt) continue;
        float* cr = contrib + ((size_t)blk * TB + l0 + l) * RM;
#pragma unroll
        for (int k = 0; k < KMAX; ++k)
#pragma unroll
            for (int r = 0; r < RMAX; ++r)
                if (k < K && r < R) {
                    const int j = r * M + k * 2 * C + ic;
#pragma unroll
                    for (int c = 0; c < CPT; ++c) {
                        cr[j + c] = are[m][k][r][c];
                        cr[j + C + c] = aim[m][k][r][c];
                    }
                }
    }
}

// Whether the contrib walk is warp-specialized: at K ≤ 3 (K6's walk, 512
// consumers, one CTA an SM); at K = 5 every thread builds, then consumes
// (K5's, two CTAs an SM: the K·R complex sums leave no registers for more
// targets).  Measured on an H100 at the serving shape (C = 32, R = 6):
// one CTA a frequency there, warp-specialized with 32-target tiles, ran
// the walk 1.5x slower; the rings whose hat is zero skipped by a branch,
// 1.1x slower.
inline bool contrib_ws(int K) { return K <= 3; }

// Channels a consumer thread of the warp-specialized walk sums: two at an
// even C from 32 to 62 with R ≤ 3, as K6's (panel_pipe.cuh::compact_cpt).
inline int contrib_cpt(int C, int K, int R)
{
    return contrib_ws(K) && R <= 3 && C % 2 == 0 && C >= 32 && C < 64 ? 2
                                                                      : 1;
}

// The plan of a walk over the band, KG frequencies a CTA: tile_plan's,
// with a one-byte occupancy slab (one plane, rows TBvp bytes by target; by
// source the tile's columns from a 16-byte boundary), every stage by bulk
// copy, and far rows of fw floats read from rows fs apart, a frequency's
// at goff floats from the last's; comp: a compressed band's slot images
// (its 5 words, expanded in place into K1's).
inline bool walk_plan(int bysrc, int tpt, int KG, int R, const BandGeo& geo,
                      int t_target, int mt, int threads, int fw, int fs,
                      int goff, const void* far, int limit, size_t budget,
                      Plan* p, bool comp)
{
    if (!pipe::tile_plan(bysrc, tpt, KG, R, geo.TBv, geo.TBv, 0, 1, t_target,
                         mt, fw, far, nullptr, p, threads))
        return false;
    p->W = 1;
    p->SW = bysrc ? std::min((p->T + 30) / 16 * 16, geo.TBvp) : geo.TBvp;
    p->bulk = 1;
    if (comp)                            // the slot expanded (expand_pass)
        p->NIMG = (std::max(5, R + 2 * KG) + 3) / 4 * 4;
    p->FS = fs;
    const bool a16 = (uintptr_t)far % 16 == 0, a8 = (uintptr_t)far % 8 == 0;
    p->FV = fw % 4 == 0 && fs % 4 == 0 && goff % 4 == 0 && a16 ? 4
          : fw % 2 == 0 && fs % 2 == 0 && goff % 2 == 0 && a8 ? 2 : 1;
    return pipe::fit_plan(p, 1, limit, budget);
}

// The contrib walk's plan: K5's tiles (panel_pipe.cuh::contrib_inst), one
// target a thread (the instantiations launch_contrib has), warp-specialized
// at K ≤ 3 with K6's 512 consumers.
inline bool contrib_plan(int C, int K, int R, const BandGeo& geo,
                         const void* g, int limit, Plan* p, bool comp)
{
    const bool ws = contrib_ws(K);
    const pipe::Inst in{pipe::contrib_inst(K, R).t_target, 1};
    const int cpt = contrib_cpt(C, K, R), M = 2 * K * C;
    for (int mt = cpt == 2 ? 1 : in.mt_max; mt >= 1; mt /= 2)
        if (walk_plan(0, C / cpt, K, R, geo, in.t_target, mt,
                      ws ? pipe::kCompactThreads : pipe::kThreads, M, M, M,
                      g, limit, ws ? (size_t)limit : pipe::kSmemBudget, p,
                      comp))
            return true;
    return false;
}

template <bool COMP>
cudaError_t launch_contrib(const float* g, const float* sten,
                           const unsigned char* occ, float* contrib, int n_mesh,
                           int C, int K, int R, const BandGeo& geo,
                           const Plan& p, cudaStream_t stream)
{
    const bool ws = contrib_ws(K);
    const unsigned grid = (unsigned)((long long)n_mesh * geo.nr * geo.np
                                     * ((geo.TBv + p.T - 1) / p.T));
    const pipe::Knots kn = COMP ? panel::ring_knots(R) : pipe::Knots{};
    auto go = [&](auto kernel) {
        cudaError_t err = pipe::set_smem(kernel, p);
        if (err != cudaSuccess) return err;
        kernel<<<grid, p.nthr + (ws ? 32 * pipe::kProducerWarps : 0),
                 p.bytes, stream>>>(g, sten, occ, contrib, C, K, R, geo, p,
                                    kn);
        return cudaGetLastError();
    };
    // the serving and training shapes' instantiations (K = 5, R = 6; K = 3,
    // R = 3) and one for every other ring count at K ≤ 3 (a compressed
    // band's knots hold 6 rings)
    if (!ws) return go(contrib_kernel<5, 6, 1, 1, false, COMP>);
    if (R <= 3)
        return contrib_cpt(C, K, R) == 2
            ? go(contrib_kernel<3, 3, 1, 2, true, COMP>)
            : go(contrib_kernel<3, 3, 1, 1, true, COMP>);
    return go(contrib_kernel<3, COMP ? 6 : 8, 1, 1, true, COMP>);
}

// --- dG by source (the backward's last pass) ----------------------------------------------
//
// At K ≤ 3 one walk covers every frequency, over dc in contrib's layout
// (rows, R·M).  At K > 3 a CTA covers one frequency k (blockIdx.y), over
// dc laid out channel-major a frequency: column (k·C + c)·kQS + 2r + p
// (p: re, im; zero for r ≥ R), so that a consumer thread reads its
// channel's rings as float4s, two rings a read (a pair whose hats are both
// zero skipped; a zero hat, or dc past R, adds an exact 0).  dc = dy·W'ᵀ
// with W' W's rows in that order (cm_w_kernel).

constexpr int kQS = 12;                  // floats a channel: 2·6 rings

__global__ void __launch_bounds__(256)
cm_w_kernel(const float* __restrict__ wmat, float* __restrict__ wcm, int C,
            int K, int R, int O2)
{
    const int M = 2 * K * C;
    const long long n = (long long)K * C * kQS * O2;
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n) return;
    const int jc = (int)(e / O2), o = (int)(e - (long long)jc * O2);
    const int kc = jc / kQS, q = jc - kc * kQS;
    const int k = kc / C, c = kc - k * C;
    const int r = q / 2, p = q - 2 * r;
    wcm[e] = r < R ? wmat[(size_t)(r * M + k * 2 * C + p * C + c) * O2 + o]
                   : 0.f;
}

// Whether dG runs a CTA a frequency over the channel-major dc.
inline bool dg_by_k(int K) { return K > 3; }

// Floats of a row of dc (rows of dy·W'ᵀ).
inline int dc_cols(int C, int K, int R)
{
    return dg_by_k(K) ? K * C * kQS : R * 2 * K * C;
}

inline cudaError_t launch_cm_w(const float* wmat, float* wcm, int C, int K,
                               int R, int O2, cudaStream_t stream)
{
    const long long n = (long long)K * C * kQS * O2;
    cm_w_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(wmat, wcm,
                                                                 C, K, R, O2);
    return cudaGetLastError();
}

// By source, one frequency: dG_k of each of a thread's MT sources over pass
// buffer b (far rows: the frequency's C·kQS floats of dc's target rows),
// channel ic: u = Σ_r rs_r·dc[r] over every ring of the instantiation (a
// zero hat, and dc past R, add exact zeros), then dG += conj(f_k)·u, in
// panel_pipe.cuh::consume_dg's order.
template <int RMAX, int MT>
__device__ __forceinline__ void consume_dg_cm(
    float (&gre)[MT][1], float (&gim)[MT][1], const unsigned char* smem,
    const Plan& pl, int b, int R, int nt, bool active, int qi, int ic)
{
    static_assert(2 * RMAX == kQS, "a channel's rings as float4s");
    if (!active) return;
    const int T = pl.T, UCAP = pl.UCAP, FW = pl.FW;
    const uint32_t* img = reinterpret_cast<const uint32_t*>(smem + pl.off_img)
        + (size_t)b * pl.img_words;
    const float* fb = reinterpret_cast<const float*>(smem + pl.off_far)
        + (size_t)b * UCAP * FW + ic * kQS;
    const uint32_t* pmask =
        reinterpret_cast<const uint32_t*>(smem + pl.off_pmask) + b * T;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
        const int l = qi + pl.NQ * m;
        if (l >= nt) continue;
        uint32_t bits = pmask[l];
        while (bits) {
            const int pc = __ffs(bits) - 1;
            bits &= bits - 1;
            float h[RMAX], fre[1], fim[1];
            const uint32_t* slot = img + (size_t)(l * UCAP + pc) * pl.NIMG;
            if (R == RMAX) {                 // [hats, f re, f im] as float4s
                float w[RMAX + 2];
                image_words<(RMAX + 2) / 4>(w, slot);
#pragma unroll
                for (int r = 0; r < RMAX; ++r) h[r] = w[r];
                fre[0] = w[RMAX];
                fim[0] = w[RMAX + 1];
            } else {
                pipe::slot_coefs<1, RMAX, float>(h, fre, fim, slot, 0u, 0u,
                                                 R, 1, 0);
            }
            const float4* d =
                reinterpret_cast<const float4*>(fb + (size_t)pc * FW);
            float ur = 0.f, ui = 0.f;
#pragma unroll
            for (int v = 0; v < RMAX / 2; ++v) {
                if (h[2 * v] == 0.f && h[2 * v + 1] == 0.f) continue;
                const float4 a = d[v];
                ur = fmaf(h[2 * v], a.x, ur);
                ui = fmaf(h[2 * v], a.y, ui);
                ur = fmaf(h[2 * v + 1], a.z, ur);
                ui = fmaf(h[2 * v + 1], a.w, ui);
            }
            gre[m][0] = fmaf(fre[0], ur, fmaf(fim[0], ui, gre[m][0]));
            gim[m][0] = fmaf(fre[0], ui, fmaf(-fim[0], ur, gim[m][0]));
        }
    }
}

// A CTA owns a tile of up to 32 sources of one virtual source block (up to
// 4 a thread), one consumer thread per (source, channel) with its complex
// dG sums in registers (every frequency's, or BYK frequency blockIdx.y's),
// and four producer warps (panel_pipe.cuh::walk, warp-specialized) that
// stage its dc columns of the target rows its sources need, a panel at a
// time.  Every dg element is written once, by its owner: a source block
// whose run holds no panel writes zeros.  COMP: a compressed band, as
// contrib_kernel's (the consumers expand each landed pass).
template <int KMAX, int RMAX, int MT, bool BYK, bool COMP>
__global__ void __launch_bounds__(
    pipe::kThreads + 32 * pipe::kProducerWarps, 2)
dg_kernel(const float* __restrict__ dc, const float* __restrict__ sten,
          const unsigned char* __restrict__ occ, float* __restrict__ dg,
          int C, int K, int R, BandGeo geo, Plan pl, pipe::Knots kn)
{
    const int M = 2 * K * C;
    const int k0 = BYK ? blockIdx.y : 0;
    const int KG = BYK ? 1 : K;              // frequencies of the CTA
    const int TBv = geo.TBv;
    const int tiles = (TBv + pl.T - 1) / pl.T;
    const int blk = blockIdx.x / tiles;      // virtual source block
    const int l0 = (blockIdx.x % tiles) * pl.T;
    const int nt = min(pl.T, TBv - l0);
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
    BandRun<true, COMP> run{geo};
    run.fk0 = 2 * k0;
    pipe::walk<true, true, RMAX, float, false, unsigned char>(
        smem, pl, sten, occ, run, dc + (size_t)k0 * C * kQS, R, KG, 0, blk,
        l0, nt, pipe::Knots{}, [&](int b) {
            if constexpr (COMP)
                expand_pass<KMAX, true>(smem, pl, b, R, K, KG, k0, nt, kn);
            if constexpr (BYK) {
                consume_dg_cm<RMAX, MT>(gre, gim, smem, pl, b, R, nt, active,
                                        qi, ic);
            } else {
                bandpipe::consume_dg<KMAX, RMAX, MT>(gre, gim, smem, pl, b, C,
                                                     K, R, nt, active, qi,
                                                     ic);
            }
        });
    if (!active) return;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
        const int l = qi + pl.NQ * m;
        if (l >= nt) continue;
        float* o = dg + ((size_t)blk * TBv + l0 + l) * M;
#pragma unroll
        for (int k = 0; k < KMAX; ++k)
            if (k < KG) {
                o[(k0 + k) * 2 * C + ic] = gre[m][k];
                o[(k0 + k) * 2 * C + C + ic] = gim[m][k];
            }
    }
}

// dG's plan: 32 sources a tile, up to 4 a thread (K5's pass 4; one at K ≤
// 3 with R > 3, launch_dg's instantiation), narrower where the dc rows leave
// no room.
inline bool dg_plan(int C, int K, int R, const BandGeo& geo, const void* dc,
                    int limit, Plan* p, bool comp)
{
    const bool byk = dg_by_k(K);
    const int fw = byk ? C * kQS : R * 2 * K * C;
    for (int mt = !byk && R > 3 ? 1 : 4; mt >= 1; mt /= 2)
        if (walk_plan(1, C, byk ? 1 : K, R, geo, 32, mt, pipe::kThreads, fw,
                      dc_cols(C, K, R), fw, dc, limit, pipe::kSmemBudget, p,
                      comp))
            return true;
    return false;
}

// Launches dG over every virtual source block of the source arrays (MT = 1
// only at K ≤ 3 with R > 3: dg_plan).
template <int KMAX, int RMAX, bool BYK, bool COMP>
cudaError_t launch_dg_mt(const float* dc, const float* sten,
                         const unsigned char* occ, float* dg, int n_mesh, int C,
                         int K, int R, const BandGeo& geo, const Plan& p,
                         cudaStream_t stream)
{
    const dim3 grid((unsigned)((long long)n_mesh * geo.nsb * geo.np
                               * ((geo.TBv + p.T - 1) / p.T)),
                    BYK ? K : 1);
    const pipe::Knots kn = COMP ? panel::ring_knots(R) : pipe::Knots{};
    auto go = [&](auto kernel) {
        cudaError_t err = pipe::set_smem(kernel, p);
        if (err != cudaSuccess) return err;
        kernel<<<grid, p.nthr + 32 * pipe::kProducerWarps, p.bytes,
                 stream>>>(dc, sten, occ, dg, C, K, R, geo, p, kn);
        return cudaGetLastError();
    };
    if constexpr (BYK || RMAX <= 3) {
        if (p.MT == 4) return go(dg_kernel<KMAX, RMAX, 4, BYK, COMP>);
        if (p.MT == 2) return go(dg_kernel<KMAX, RMAX, 2, BYK, COMP>);
    }
    return go(dg_kernel<KMAX, RMAX, 1, BYK, COMP>);
}

template <bool COMP>
cudaError_t launch_dg(const float* dc, const float* sten,
                      const unsigned char* occ, float* dg, int n_mesh, int C,
                      int K, int R, const BandGeo& geo, const Plan& p,
                      cudaStream_t stream)
{
    if (dg_by_k(K))
        return launch_dg_mt<1, 6, true, COMP>(dc, sten, occ, dg, n_mesh, C,
                                              K, R, geo, p, stream);
    if (R <= 3)
        return launch_dg_mt<3, 3, false, COMP>(dc, sten, occ, dg, n_mesh, C,
                                               K, R, geo, p, stream);
    return launch_dg_mt<3, COMP ? 6 : 8, false, COMP>(
        dc, sten, occ, dg, n_mesh, C, K, R, geo, p, stream);
}

// --- shapes and device limits --------------------------------------------------------------

// The shapes: K ≤ 5 (band limit ≤ 2); R ≤ 8, or R ≤ 6 with K > 3 or a
// compressed band (its ring knots); C ≤ 256; N a multiple of TB; nh ≥ 0;
// n_mesh ≤ 65535.
inline bool shapes_supported(int n_mesh, int N, int C, int K, int R, int TB,
                             int nh, int O2, bool comp = false)
{
    return !(n_mesh < 1 || N < 1 || C < 1 || C > pipe::kThreads || K < 1
             || K > 5 || R < 1
             || R > (comp ? panel::kMaxRings : K <= 3 ? 8 : 6) || TB < 1
             || N % TB != 0 || nh < 0 || O2 < 1 || n_mesh > 65535);
}

// A K9 launch's range: a source array of a positive multiple of TB rows,
// 0 ≤ lo < hi ≤ N / TB.
inline bool range_supported(int N, int TB, int n_src, int lo, int hi)
{
    return n_src >= TB && n_src % TB == 0 && lo >= 0 && lo < hi
        && hi <= N / TB;
}

// The current device's opt-in shared memory a block and its SM count, read
// from the CUDA runtime once a device (a call asks twice: for its scratch size,
// then to launch).
inline cudaError_t device_limits(int* limit, int* sms)
{
    constexpr int kDevices = 64;
    static std::atomic<int> known[kDevices][2];    // 0: not read yet
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    std::atomic<int>* k = dev < kDevices ? known[dev] : nullptr;
    int lim = k ? k[0].load(std::memory_order_relaxed) : 0;
    int n = k ? k[1].load(std::memory_order_relaxed) : 0;
    if (lim == 0 || n == 0) {
        err = cudaDeviceGetAttribute(
            &lim, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                         dev);
        if (err != cudaSuccess) return err;
        if (k) {
            k[0].store(lim, std::memory_order_relaxed);
            k[1].store(n, std::memory_order_relaxed);
        }
    }
    *limit = lim;
    if (sms) *sms = n;
    return cudaSuccess;
}

inline size_t round4(size_t n) { return (n + 3) / 4 * 4; }

}  // namespace bandpipe
