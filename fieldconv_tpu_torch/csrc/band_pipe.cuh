// K1's band on the pipelined panel walk (panel_pipe.cuh): the forward's
// contrib and the backward's pass 1 (by target), and the backward's dG
// (by source).  See band_fused_fwd.cu and band_fused_bwd.cu for what they
// compute and their design.
//
// A dense band is (2nh+1) square TB × TB panels a target block: panel j of
// block b is sten_band[m, b, :, :, j·TB:(j+1)·TB], R+2K planes whose rows
// lie W' = (2nh+1)·TB elements apart, reading source block b − nh + j.  A
// band of TB > 128 (panel_pipe.cuh's kMaxTB: four mask words) is walked in
// virtual blocks of TBv = TB / np rows (np the fewest pieces for which TBv
// ≤ 128 divides TB): virtual target block (b, h) reads the virtual source
// blocks of b's window, each a TBv × TBv piece of the band.  Panels whose
// source block lies outside [0, nb) are never visited.
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

// The band's shape and its virtual blocks.
struct BandGeo {
    int nb;          // blocks of a mesh (N / TB)
    int nh, TB, Wp;  // W' = (2nh+1)·TB
    int P;           // planes, R + 2K
    int np, TBv;     // pieces a block, rows a virtual block (TB / np)
    int TBvp;        // occupancy row: TBv rounded up to 16 bytes
    int Jv;          // virtual panels a window: (2nh+1)·np
};

inline BandGeo band_geo(int N, int TB, int nh, int R, int K)
{
    BandGeo g;
    g.nb = N / TB;
    g.nh = nh;
    g.TB = TB;
    g.Wp = (2 * nh + 1) * TB;
    g.P = R + 2 * K;
    g.np = (TB + pipe::kMaxTB - 1) / pipe::kMaxTB;
    while (TB % g.np) ++g.np;
    g.TBv = TB / g.np;
    g.TBvp = (g.TBv + 15) / 16 * 16;
    g.Jv = (2 * nh + 1) * g.np;
    return g;
}

// Bytes of the occupancy array of n_mesh meshes.
inline size_t occ_bytes(int n_mesh, const BandGeo& g)
{
    return (size_t)n_mesh * g.nb * g.np * g.Jv * g.TBv * g.TBvp;
}

// occ[((tv·Jv + jv)·TBv + t')·TBvp + s'] = 1 where any of the R hat planes
// of the band's slot (row t = h·TBv + t' of block b, window slot w = jv·TBv
// + s') is nonzero, tv = (m·nb + b)·np + h; V slots a thread (4 where rows
// and pieces allow float4 loads).
template <int V>
__global__ void __launch_bounds__(256)
occ_kernel(const float* __restrict__ sten, unsigned char* __restrict__ occ,
           long long items, int R, BandGeo g)
{
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= items) return;
    const int wv = g.Wp / V;
    const long long row = i / wv;            // (m·nb + b)·TB + t
    const int w = (int)(i - row * wv) * V;
    const long long gb = row / g.TB;
    const int t = (int)(row - gb * g.TB);
    const float* s = sten + ((size_t)gb * g.P * g.TB + t) * g.Wp + w;
    const size_t plane = (size_t)g.TB * g.Wp;
    bool nz[V];
#pragma unroll
    for (int v = 0; v < V; ++v) nz[v] = false;
    for (int r = 0; r < R; ++r) {
        if constexpr (V == 4) {
            const float4 x =
                __ldg(reinterpret_cast<const float4*>(s + r * plane));
            nz[0] |= x.x != 0.f;
            nz[1] |= x.y != 0.f;
            nz[2] |= x.z != 0.f;
            nz[3] |= x.w != 0.f;
        } else {
            nz[0] |= __ldg(s + r * plane) != 0.f;
        }
    }
    const long long tv = gb * g.np + t / g.TBv;
    const int jv = w / g.TBv;
    unsigned char* o = occ
        + (((size_t)tv * g.Jv + jv) * g.TBv + t % g.TBv) * g.TBvp + w % g.TBv;
    if constexpr (V == 4)
        *reinterpret_cast<uchar4*>(o) =
            make_uchar4(nz[0], nz[1], nz[2], nz[3]);
    else
        *o = nz[0];
}

inline cudaError_t launch_occ(const float* sten, unsigned char* occ,
                              int n_mesh, int R, const BandGeo& g,
                              cudaStream_t stream)
{
    const bool vec = g.TBv % 4 == 0 && (uintptr_t)sten % 16 == 0;
    const long long slots = (long long)n_mesh * g.nb * g.TB * g.Wp;
    const long long items = vec ? slots / 4 : slots;
    const unsigned blocks = (unsigned)((items + 255) / 256);
    if (vec)
        occ_kernel<4><<<blocks, 256, 0, stream>>>(sten, occ, items, R, g);
    else
        occ_kernel<1><<<blocks, 256, 0, stream>>>(sten, occ, items, R, g);
    return cudaGetLastError();
}

// The run of a walk block: by target virtual block blk = tv (global over
// the meshes) and the virtual source blocks of its window inside the mesh;
// by source virtual block blk = sv and the virtual target blocks whose
// window holds it (original blocks b = s − nh .. s + nh inside [0, nb), all
// np pieces of each), ascending.  Far rows: g's (by target) or dc's (by
// source) rows, n_mesh·N of them; far index u of other block o is row
// o·TBv + u.  See panel_pipe.cuh::MetaRun for the interface.
template <bool BYSRC>
struct BandRun {
    BandGeo g;
    int nb_far = 0;                // (GATHER only)
    int fk0 = 0;                   // a frequency group's first f_k plane − R
    int n = 0;
    int mbase = 0;                 // the mesh's first virtual block
    int lo = 0;                    // the run's first other block
    int self = 0, m = 0;           // blk; its mesh

    __device__ __forceinline__ void init(int blk)
    {
        const int nbv = g.nb * g.np;
        m = blk / nbv;
        mbase = m * nbv;
        self = blk;
        const int lv = blk - mbase;
        const int b = lv / g.np;            // its original block
        const int b_lo = max(0, b - g.nh);
        const int b_hi = min(g.nb - 1, b + g.nh);
        lo = mbase + b_lo * g.np;
        n = (b_hi - b_lo + 1) * g.np;
    }
    __device__ __forceinline__ int pid(int k) const { return k; }
    __device__ __forceinline__ int other(int k) const { return lo + k; }
    // (target virtual block tv, source virtual block sv), both global
    __device__ __forceinline__ int tgt(int o) const { return BYSRC ? o : self; }
    __device__ __forceinline__ int src(int o) const { return BYSRC ? self : o; }
    __device__ __forceinline__ size_t img(int, int o) const
    {
        const int tl = tgt(o) - mbase, svl = src(o) - mbase;
        const int b = tl / g.np, h = tl - b * g.np;
        return ((size_t)(m * g.nb + b) * g.P * g.TB + (size_t)h * g.TBv)
                   * g.Wp
            + (long long)svl * g.TBv - (long long)(b - g.nh) * g.TB;
    }
    __device__ __forceinline__ size_t slab(int, int o) const
    {
        const int tv = tgt(o), tl = tv - mbase, svl = src(o) - mbase;
        const int jv = svl - (tl / g.np - g.nh) * g.np;
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

// --- contrib by target (the forward, and the backward's pass 1) ---------------------------

// contrib of every target row of the band: one CTA per tile of T targets
// of a virtual block, MT a thread, written as (rows, R·M) row-major with
// column j = r·M + k·2C + (p·C + c) (panel_pipe.cuh::contrib_tile).  WS:
// warp-specialized (the walk's producer warps after pl.nthr consumers),
// CPT channels a consumer thread.
template <int KMAX, int RMAX, int MT, int CPT, bool WS>
__global__ void __launch_bounds__(
    WS ? pipe::kCompactThreads + 32 * pipe::kProducerWarps : pipe::kThreads,
    WS ? 1 : 2)
contrib_kernel(const float* __restrict__ g, const float* __restrict__ sten,
               const unsigned char* __restrict__ occ,
               float* __restrict__ contrib, int C, int K, int R, BandGeo geo,
               Plan pl)
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
    BandRun<false> run{geo};
    pipe::walk<false, WS, RMAX, float, false, unsigned char>(
        smem, pl, sten, occ, run, g, R, K, 0, blk, l0, nt, pipe::Knots{},
        [&](int b) {
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
// at goff floats from the last's.
inline bool walk_plan(int bysrc, int tpt, int KG, int R, const BandGeo& geo,
                      int t_target, int mt, int threads, int fw, int fs,
                      int goff, const void* far, int limit, size_t budget,
                      Plan* p)
{
    if (!pipe::tile_plan(bysrc, tpt, KG, R, geo.TBv, geo.TBv, 0, 1, t_target,
                         mt, fw, far, nullptr, p, threads))
        return false;
    p->W = 1;
    p->SW = bysrc ? std::min((p->T + 30) / 16 * 16, geo.TBvp) : geo.TBvp;
    p->bulk = 1;
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
                         const void* g, int limit, Plan* p)
{
    const bool ws = contrib_ws(K);
    const pipe::Inst in{pipe::contrib_inst(K, R).t_target, 1};
    const int cpt = contrib_cpt(C, K, R), M = 2 * K * C;
    for (int mt = cpt == 2 ? 1 : in.mt_max; mt >= 1; mt /= 2)
        if (walk_plan(0, C / cpt, K, R, geo, in.t_target, mt,
                      ws ? pipe::kCompactThreads : pipe::kThreads, M, M, M,
                      g, limit, ws ? (size_t)limit : pipe::kSmemBudget, p))
            return true;
    return false;
}

inline cudaError_t launch_contrib(const float* g, const float* sten,
                                  const unsigned char* occ, float* contrib,
                                  int n_mesh, int C, int K, int R,
                                  const BandGeo& geo, const Plan& p,
                                  cudaStream_t stream)
{
    const bool ws = contrib_ws(K);
    const unsigned grid = (unsigned)((long long)n_mesh * geo.nb * geo.np
                                     * ((geo.TBv + p.T - 1) / p.T));
    auto go = [&](auto kernel) {
        cudaError_t err = pipe::set_smem(kernel, p);
        if (err != cudaSuccess) return err;
        kernel<<<grid, p.nthr + (ws ? 32 * pipe::kProducerWarps : 0),
                 p.bytes, stream>>>(g, sten, occ, contrib, C, K, R, geo, p);
        return cudaGetLastError();
    };
    // the serving and training shapes' instantiations (K = 5, R = 6; K = 3,
    // R = 3) and one for every other ring count at K ≤ 3
    if (!ws) return go(contrib_kernel<5, 6, 1, 1, false>);
    if (R <= 3)
        return contrib_cpt(C, K, R) == 2
            ? go(contrib_kernel<3, 3, 1, 2, true>)
            : go(contrib_kernel<3, 3, 1, 1, true>);
    return go(contrib_kernel<3, 8, 1, 1, true>);
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
// time.  Every dg element is written once, by its owner.
template <int KMAX, int RMAX, int MT, bool BYK>
__global__ void __launch_bounds__(
    pipe::kThreads + 32 * pipe::kProducerWarps, 2)
dg_kernel(const float* __restrict__ dc, const float* __restrict__ sten,
          const unsigned char* __restrict__ occ, float* __restrict__ dg,
          int C, int K, int R, BandGeo geo, Plan pl)
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
    BandRun<true> run{geo};
    run.fk0 = 2 * k0;
    pipe::walk<true, true, RMAX, float, false, unsigned char>(
        smem, pl, sten, occ, run, dc + (size_t)k0 * C * kQS, R, KG, 0, blk,
        l0, nt, pipe::Knots{}, [&](int b) {
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
                    int limit, Plan* p)
{
    const bool byk = dg_by_k(K);
    const int fw = byk ? C * kQS : R * 2 * K * C;
    for (int mt = !byk && R > 3 ? 1 : 4; mt >= 1; mt /= 2)
        if (walk_plan(1, C, byk ? 1 : K, R, geo, 32, mt, pipe::kThreads, fw,
                      dc_cols(C, K, R), fw, dc, limit, pipe::kSmemBudget, p))
            return true;
    return false;
}

// (MT = 1 only at K ≤ 3 with R > 3: dg_plan)
template <int KMAX, int RMAX, bool BYK>
cudaError_t launch_dg_mt(const float* dc, const float* sten,
                         const unsigned char* occ, float* dg, int n_mesh,
                         int C, int K, int R, const BandGeo& geo,
                         const Plan& p, cudaStream_t stream)
{
    const dim3 grid((unsigned)((long long)n_mesh * geo.nb * geo.np
                               * ((geo.TBv + p.T - 1) / p.T)),
                    BYK ? K : 1);
    auto go = [&](auto kernel) {
        cudaError_t err = pipe::set_smem(kernel, p);
        if (err != cudaSuccess) return err;
        kernel<<<grid, p.nthr + 32 * pipe::kProducerWarps, p.bytes,
                 stream>>>(dc, sten, occ, dg, C, K, R, geo, p);
        return cudaGetLastError();
    };
    if constexpr (BYK || RMAX <= 3) {
        if (p.MT == 4) return go(dg_kernel<KMAX, RMAX, 4, BYK>);
        if (p.MT == 2) return go(dg_kernel<KMAX, RMAX, 2, BYK>);
    }
    return go(dg_kernel<KMAX, RMAX, 1, BYK>);
}

inline cudaError_t launch_dg(const float* dc, const float* sten,
                             const unsigned char* occ, float* dg, int n_mesh,
                             int C, int K, int R, const BandGeo& geo,
                             const Plan& p, cudaStream_t stream)
{
    if (dg_by_k(K))
        return launch_dg_mt<1, 6, true>(dc, sten, occ, dg, n_mesh, C, K, R,
                                        geo, p, stream);
    if (R <= 3)
        return launch_dg_mt<3, 3, false>(dc, sten, occ, dg, n_mesh, C, K, R,
                                         geo, p, stream);
    return launch_dg_mt<3, 8, false>(dc, sten, occ, dg, n_mesh, C, K, R, geo,
                                     p, stream);
}

// --- shapes and device limits --------------------------------------------------------------

// K1's shapes: K ≤ 5 (band limit ≤ 2); R ≤ 8, or R ≤ 6 with K > 3; C ≤ 256;
// N a multiple of TB; nh ≥ 0; n_mesh ≤ 65535.
inline bool shapes_supported(int n_mesh, int N, int C, int K, int R, int TB,
                             int nh, int O2)
{
    return !(n_mesh < 1 || N < 1 || C < 1 || C > pipe::kThreads || K < 1
             || K > 5 || R < 1 || R > (K <= 3 ? 8 : 6) || TB < 1
             || N % TB != 0 || nh < 0 || O2 < 1 || n_mesh > 65535);
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
