// The passes of the banded backward shared by K8's backward
// (band_sparse_bwd.cu, block-sparse stencil: pass 1 walks each block's NJ
// source blocks, pass 5 the panels that read each source block through the
// table's inverse index), K3 (band_contrib_fwd.cu: pass 1 alone, in the
// JAX kernel's layout; band_contrib_bwd.cu: pass 5 alone, fed with K3's
// cotangent) and K9's contrib (halo_contrib_fwd.cu, halo_contrib_bwd.cu:
// passes 1 and 5, HALO, over a range of a shard's target blocks and its
// halo-extended rows, pass 5 writing every row of that array).  They
// compute K1's backward (band_fused_bwd.cu) on those layouts, in five
// kernels over one scratch buffer: (1) contrib rematerialised per tile of
// targets (band_window.cuh) into (rows, R·M); (2) dc = dy·Wᵀ written
// channel-major, [c][k][r][re|im] with compile-time strides; (3, 4) dW by
// slice partials and their combine in slice order (dw_rows.cuh); (5) dG
// gathered by source, a CTA 32 source rows of one block walking the target
// blocks whose window covers it, 4 targets at a time, their dc rows and
// stencil columns double-buffered through shared memory by cp.async.  No
// atomics: two calls agree bitwise.

#pragma once

#include "band_window.cuh"
#include "dw_rows.cuh"

#include <algorithm>
#include <cstddef>

namespace band {

constexpr int kRowsPerThread = 4;   // pass 5: source rows per thread

// dcontrib's layout between passes 2 and 5: per target row, channel-major
// [c][k][r][p] with compile-time strides (KMAX, RMAX), so pass 5 reads one
// frequency's rings for its channel as contiguous float4s; entries with
// k ≥ K or r ≥ R hold zero.
template <int KMAX, int RMAX>
__host__ __device__ constexpr int dc_stride() { return 2 * KMAX * RMAX; }

// --- pass 1: contrib per tile of targets --------------------------------------
//
// contrib of target n = blk·TB + t, ring r, column j = k·2C + p·C + c lies
// at ((m·nb + blk)·TB·R·M) + t·ts + r·rs + j: ts = R·M, rs = M lays it out
// per target row (the fused backwards, (rows, R·M)); ts = M, rs = TB·M block by
// block and ring by ring, as the JAX kernel _band_contrib_fwd_impl does
// (K3's forward, (nb·R·TB, M)).

// SPARSE: nh is NJ and nbr the meshes' (n_mesh, nb, NJ) source blocks.
// HALO: the blocks hr.lo .. hr.hi − 1 over g of hr.n_src rows a mesh,
// contrib holding the (hr.hi − hr.lo)·TB targets of the range a mesh.
template <int KMAX, int RMAX, bool SPARSE = false, bool HALO = false>
__global__ void __launch_bounds__(kThreads, 2)
bwd_contrib_kernel(const float* __restrict__ g,
                   const float* __restrict__ sten,
                   float* __restrict__ contrib, int N, int C, int K, int R,
                   int TB, int nh, int T, int ts, int rs,
                   const int* __restrict__ nbr, HaloRange hr)
{
    const int M = 2 * K * C;
    const int P = R + 2 * K;               // stencil planes
    const int Wp = (SPARSE ? nh : 2 * nh + 1) * TB;
    const int nb = N / TB;
    const int tiles = (TB + T - 1) / T;
    const int lo = HALO ? hr.lo : 0;
    const int nr = HALO ? hr.hi - hr.lo : nb;  // blocks of the launch
    const int n_src = HALO ? hr.n_src : N;     // rows of g a mesh
    const int blk = lo + blockIdx.x / tiles;
    const int t0 = (blockIdx.x % tiles) * T;
    const int nt = min(T, TB - t0);
    const int m = blockIdx.y;
    const int tid = threadIdx.x;

    extern __shared__ __align__(16) float smem[];
    const float* gm = g + (size_t)m * n_src * M;
    const float* sb = sten + ((size_t)m * nb + blk) * (size_t)P * TB * Wp;

    const int item = tid;                  // (t, c) = (item / C, item % C)
    const bool active = item < nt * C;
    const int it = active ? item / C : 0;
    const int ic = active ? item % C : 0;

    float are[KMAX][RMAX], aim[KMAX][RMAX];
    window_contrib<KMAX, RMAX, SPARSE>(
        are, aim, smem, gm, sb, n_src, C, K, R, TB, nh, T, t0, nt,
        HALO ? blk + hr.blk_off + nh : blk, active, it, ic,
        SPARSE ? nbr + ((size_t)m * nb + blk) * nh : nullptr);

    // coalesced over c
    if (active) {
        float* cr = contrib + ((size_t)m * nr + blk - lo) * TB * R * M
            + (size_t)(t0 + it) * ts;
#pragma unroll
        for (int k = 0; k < KMAX; ++k)
#pragma unroll
            for (int r = 0; r < RMAX; ++r)
                if (k < K && r < R) {
                    const size_t j = (size_t)r * rs + k * 2 * C + ic;
                    cr[j] = are[k][r];
                    cr[j + C] = aim[k][r];
                }
    }
}

// --- pass 2: dc = dy · Wᵀ into the channel-major layout -------------------------
//
// A tiled product: a CTA owns 64 target rows × 64 dc columns; each thread
// 4 × 4 of them, summed over o in order.  Column i = c·QS + q maps to the W
// row j(c, q) (or to zero for padding entries).

constexpr int kGemmTile = 64;
constexpr int kGemmDepth = 16;

template <int KMAX, int RMAX>
__global__ void __launch_bounds__(kThreads)
bwd_dc_kernel(const float* __restrict__ dy, const float* __restrict__ wmat,
              float* __restrict__ dc, int rows, int C, int K, int R, int O2)
{
    constexpr int QS = dc_stride<KMAX, RMAX>();
    constexpr int LD = kGemmTile + 4;      // float4-aligned, fewer conflicts
    __shared__ __align__(16) float as[kGemmDepth][LD];   // dyᵀ: [o][row]
    __shared__ __align__(16) float bs[kGemmDepth][LD];   // Wᵀ:  [o][col]
    __shared__ int jrow[kGemmTile];
    const int M = 2 * K * C;
    const int CQ = C * QS;
    const int r0 = blockIdx.x * kGemmTile, i0 = blockIdx.y * kGemmTile;
    const int tid = threadIdx.x;
    const int ty = tid / 16, tx = tid % 16;
    if (tid < kGemmTile) {
        const int idx = i0 + tid;
        const int c = idx / QS, q = idx - c * QS;
        const int k = q / (2 * RMAX), r = (q / 2) % RMAX, p = q % 2;
        jrow[tid] = (idx < CQ && k < K && r < R)
            ? r * M + k * 2 * C + p * C + c : -1;
    }
    float acc[4][4] = {};
    for (int o0 = 0; o0 < O2; o0 += kGemmDepth) {
        __syncthreads();                   // jrow set, last tile read
        for (int u = tid; u < kGemmTile * kGemmDepth; u += kThreads) {
            const int i = u / kGemmDepth, o = u % kGemmDepth;
            const bool ok = o0 + o < O2;
            as[o][i] = ok && r0 + i < rows
                ? dy[(size_t)(r0 + i) * O2 + o0 + o] : 0.f;
            const int j = jrow[i];
            bs[o][i] = ok && j >= 0 ? wmat[(size_t)j * O2 + o0 + o] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int o = 0; o < kGemmDepth; ++o) {
            const float4 a = *reinterpret_cast<const float4*>(&as[o][ty * 4]);
            const float4 b = *reinterpret_cast<const float4*>(&bs[o][tx * 4]);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int x = 0; x < 4; ++x)
#pragma unroll
                for (int y = 0; y < 4; ++y)
                    acc[x][y] = fmaf(av[x], bv[y], acc[x][y]);
        }
    }
    const int col = i0 + tx * 4;           // CQ % 4 == 0: all 4 or none
    if (col < CQ) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
            const int row = r0 + ty * 4 + x;
            if (row < rows)
                *reinterpret_cast<float4*>(dc + (size_t)row * CQ + col) =
                    make_float4(acc[x][0], acc[x][1], acc[x][2], acc[x][3]);
        }
    }
}

// --- pass 5: dG gathered by source ----------------------------------------------
//
// The target blocks b whose window reads source block sblk, and the panel
// j of b's window it is: the dense window's b = sblk − nh .. sblk + nh
// (inside [0, nb)), j = sblk − b + nh; HALO: b = sblk − blk_off − 2nh ..
// sblk − blk_off inside [lo, hi), j = sblk − b − blk_off, over the n_src /
// TB blocks of the source array (every one written, zero where no window
// reads it); SPARSE (nh is NJ): the entries b·NJ + j of
// inv_bj[inv_ptr[m·nb + sblk] .. inv_ptr[m·nb + sblk + 1]), in that
// (ascending) order.  dc holds the launch's targets: (hi − lo)·TB rows a
// mesh under HALO, N otherwise.

template <int KMAX, int RMAX, bool SPARSE = false, bool HALO = false>
__global__ void __launch_bounds__(kThreads)
bwd_dg_kernel(const float* __restrict__ dc, const float* __restrict__ sten,
              float* __restrict__ dg, int N, int C, int K, int R, int TB,
              int nh, int G, int TC, const int* __restrict__ inv_ptr,
              const int* __restrict__ inv_bj, HaloRange hr)
{
    const int M = 2 * K * C;
    const int P = R + 2 * K;               // stencil planes
    const int Wp = (SPARSE ? nh : 2 * nh + 1) * TB;
    const int nb = N / TB;
    const int lo = HALO ? hr.lo : 0;
    const int hi = HALO ? hr.hi : nb;
    const int off = HALO ? hr.blk_off : -nh;   // window start − target block
    const int n_src = HALO ? hr.n_src : N;     // rows of dg a mesh
    const int TS = G * kRowsPerThread;     // source rows per CTA
    const int tiles = (TB + TS - 1) / TS;
    const int sblk = blockIdx.x / tiles;
    const int s0 = (blockIdx.x % tiles) * TS;
    const int ns = min(TS, TB - s0);
    const int m = blockIdx.y;
    const int tid = threadIdx.x;
    const int rg = tid / C, ic = tid % C;
    const bool active = rg < G;

    constexpr int QS = dc_stride<KMAX, RMAX>();
    static_assert(QS % 4 == 0 && RMAX % 2 == 0, "float4 reads of dc");
    const int CQ = C * QS;                 // dc row length
    extern __shared__ __align__(16) float smem[];
    const int stage_floats = TC * CQ + TC * P * TS;
    const float* dcm = dc + (size_t)m * (hi - lo) * TB * CQ;

    float gre[kRowsPerThread][KMAX], gim[kRowsPerThread][KMAX];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int k = 0; k < KMAX; ++k) { gre[i][k] = 0.f; gim[i][k] = 0.f; }

    // steps: the panels (b, j) that read sblk, TC targets each
    int b_lo, n_panels;
    const int* bj = nullptr;
    if constexpr (SPARSE) {
        const int e0 = __ldg(inv_ptr + (size_t)m * nb + sblk);
        bj = inv_bj + e0;
        b_lo = 0;
        n_panels = __ldg(inv_ptr + (size_t)m * nb + sblk + 1) - e0;
    } else {
        b_lo = max(lo, sblk - off - 2 * nh);
        n_panels = max(0, min(hi - 1, sblk - off) - b_lo + 1);
    }
    const int tchunks = (TB + TC - 1) / TC;
    const int n_steps = n_panels * tchunks;
    auto prefetch = [&](int si) {
        float* ds = smem + (si & 1) * stage_floats;
        float* ss = ds + TC * CQ;
        int b, j;                          // sblk is panel j of b's window
        if constexpr (SPARSE) {
            const int e = __ldg(bj + si / tchunks);
            b = e / nh;
            j = e - b * nh;
        } else {
            b = b_lo + si / tchunks;
            j = sblk - b - off;
        }
        const int tc0 = (si % tchunks) * TC;
        const int ntc = min(TC, TB - tc0);
        const float* drow = dcm + ((size_t)(b - lo) * TB + tc0) * CQ;
        for (int i = tid; i < TC * CQ / 4; i += kThreads) {
            const bool ok = i * 4 < ntc * CQ;
            band::copy_async<16>(ds + i * 4, ok ? drow + i * 4 : dcm, ok);
        }
        const float* sbb = sten + ((size_t)m * nb + b) * (size_t)P * TB * Wp;
        for (int i = tid; i < TC * P * TS; i += kThreads) {
            const int sl = i % TS, tp = i / TS;
            const int p = tp % P, t = tp / P;
            const bool ok = t < ntc && sl < ns;
            band::copy_async<4>(
                ss + i,
                ok ? sbb + ((size_t)p * TB + tc0 + t) * Wp + j * TB + s0 + sl
                   : sbb, ok);
        }
        __pipeline_commit();
    };

    if (n_steps > 0) prefetch(0);          // SPARSE: a block no panel reads
    for (int si = 0; si < n_steps; ++si) {
        if (si + 1 < n_steps) {
            prefetch(si + 1);
            __pipeline_wait_prior(1);
        } else {
            __pipeline_wait_prior(0);
        }
        const float* ds = smem + (si & 1) * stage_floats;
        const float* const ss = ds + TC * CQ;
        const int ntc = min(TC, TB - (si % tchunks) * TC);

        // vote on any nonzero radial weight of the tile in this step; each
        // thread reads back only the stencil elements its own copies wrote
        int nz = 0;
        for (int i = tid; i < TC * P * TS; i += kThreads)
            if ((i / TS) % P < R) nz |= ss[i] != 0.f;
        if (__syncthreads_or(nz) && active) {
            for (int t = 0; t < ntc; ++t) {
                const float* st = ss + t * P * TS;
                const float* d = ds + t * CQ + ic * QS;
#pragma unroll
                for (int i = 0; i < kRowsPerThread; ++i) {
                    const int sl = rg * kRowsPerThread + i;
                    float rs[RMAX];
                    bool edge = false;
#pragma unroll
                    for (int r = 0; r < RMAX; ++r) {
                        rs[r] = r < R ? st[r * TS + sl] : 0.f;
                        edge |= rs[r] != 0.f;
                    }
                    // no edge from this source to target t (uniform across
                    // a warp when C = 32: its lanes share the rows)
                    if (!edge) continue;
#pragma unroll
                    for (int k = 0; k < KMAX; ++k) {
                        if (k < K) {
                            // u_k = Σ_r rs_r · dc[t, c, k, r, (re, im)]
                            const float4* dk = reinterpret_cast<const float4*>(
                                d + k * 2 * RMAX);
                            float ur = 0.f, ui = 0.f;
#pragma unroll
                            for (int v = 0; v < RMAX / 2; ++v) {
                                const float4 a = dk[v];
                                ur = fmaf(rs[2 * v], a.x, ur);
                                ui = fmaf(rs[2 * v], a.y, ui);
                                ur = fmaf(rs[2 * v + 1], a.z, ur);
                                ui = fmaf(rs[2 * v + 1], a.w, ui);
                            }
                            const float fr = st[(R + 2 * k) * TS + sl];
                            const float fi = st[(R + 2 * k + 1) * TS + sl];
                            gre[i][k] = fmaf(fr, ur, fmaf(fi, ui, gre[i][k]));
                            gim[i][k] = fmaf(fr, ui, fmaf(-fi, ur, gim[i][k]));
                        }
                    }
                }
            }
        }
        __syncthreads();                   // buffer free for step si + 2
    }

    if (active) {
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
            const int sl = rg * kRowsPerThread + i;
            if (sl < ns) {
                float* o = dg
                    + ((size_t)m * n_src + (size_t)sblk * TB + s0 + sl) * M;
#pragma unroll
                for (int k = 0; k < KMAX; ++k)
                    if (k < K) {
                        o[k * 2 * C + ic] = gre[i][k];
                        o[k * 2 * C + C + ic] = gim[i][k];
                    }
            }
        }
    }
}

// --- launch ------------------------------------------------------------------------

inline size_t contrib_smem_bytes(int C, int K, int R, int T)
{
    return window_stage_floats(2 * K * C, R + 2 * K, T) * sizeof(float);
}

inline size_t dg_smem_bytes(int C, int K, int R, int QS, int G, int TC)
{
    const size_t P = R + 2 * (size_t)K;
    const size_t TS = (size_t)G * kRowsPerThread;
    return 2 * ((size_t)TC * C * QS + (size_t)TC * P * TS) * sizeof(float);
}

inline size_t round4(size_t n) { return (n + 3) / 4 * 4; }

// How one call is cut up, and where its scratch buffers lie in the one the
// caller owns (offsets in floats, each 16-byte aligned): contrib, then dc,
// then the dW partials.  With O2 = 0 (K3's backward) only dc is planned.
struct Plan {
    int T, G, TC, QS, slices, slice_rows;
    size_t smem1, smem4, dc_at, part_at, floats;
};

inline cudaError_t make_plan(int n_mesh, int N, int C, int K, int R, int O2,
                             Plan* pl)
{
    int dev = 0, limit = 0, sms = 0;
    cudaError_t err = smem_limit(&limit);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return err;
    pl->T = std::min(kTile, kThreads / C);
    while (pl->T > 1
           && contrib_smem_bytes(C, K, R, pl->T) > (size_t)limit)
        pl->T /= 2;
    pl->smem1 = contrib_smem_bytes(C, K, R, pl->T);
    pl->G = std::min(kTile, kThreads / C);
    pl->QS = K <= 3 ? dc_stride<3, 8>() : dc_stride<5, 6>();
    pl->TC = 4;
    while (pl->TC > 1
           && dg_smem_bytes(C, K, R, pl->QS, pl->G, pl->TC) > (size_t)limit)
        pl->TC /= 2;
    pl->smem4 = dg_smem_bytes(C, K, R, pl->QS, pl->G, pl->TC);
    if (pl->smem1 > (size_t)limit || pl->smem4 > (size_t)limit)
        return cudaErrorInvalidValue;
    const long long rows = (long long)n_mesh * N;
    const int RM = R * 2 * K * C;
    if (O2 > 0) {
        const DwSlices dws = dw_slices(rows, RM, O2, sms);
        pl->slices = dws.slices;
        pl->slice_rows = dws.slice_rows;
        pl->dc_at = round4((size_t)rows * RM);
    } else {
        pl->slices = pl->slice_rows = 0;
        pl->dc_at = 0;
    }
    pl->part_at = pl->dc_at + round4((size_t)rows * C * pl->QS);
    pl->floats = pl->part_at + (size_t)pl->slices * RM * O2;
    return cudaSuccess;
}

// Targets a mesh of a launch: the range's under HALO, else every one.
template <bool HALO>
inline int launch_targets(int N, int TB, const HaloRange& hr)
{
    return HALO ? (hr.hi - hr.lo) * TB : N;
}

// Pass 1 alone: contrib of every target into `out` with strides (ts, rs).
// SPARSE: nh is NJ and nbr the (n_mesh, nb, NJ) source blocks; HALO: the
// targets of hr's range over its source array.
template <int KMAX, int RMAX, bool SPARSE = false, bool HALO = false>
cudaError_t launch_contrib(const float* g, const float* sten, float* out,
                           int n_mesh, int N, int C, int K, int R, int TB,
                           int nh, int ts, int rs, const Plan& pl,
                           cudaStream_t stream, const int* nbr = nullptr,
                           HaloRange hr = HaloRange{})
{
    auto k1 = bwd_contrib_kernel<KMAX, RMAX, SPARSE, HALO>;
    cudaError_t err = cudaFuncSetAttribute(
        k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem1);
    if (err != cudaSuccess) return err;
    const int blocks = launch_targets<HALO>(N, TB, hr) / TB;
    k1<<<dim3(blocks * ((TB + pl.T - 1) / pl.T), n_mesh), kThreads,
         pl.smem1, stream>>>(g, sten, out, N, C, K, R, TB, nh, pl.T, ts, rs,
                             nbr, hr);
    return cudaGetLastError();
}

// Pass 5 alone: dG gathered by source from dc in the channel-major layout.
// SPARSE: nh is NJ, and (inv_ptr, inv_bj) the table's inverse index; HALO:
// every row of hr's source array, from the range's targets.
template <int KMAX, int RMAX, bool SPARSE = false, bool HALO = false>
cudaError_t launch_dg(const float* dc, const float* sten, float* dg,
                      int n_mesh, int N, int C, int K, int R, int TB, int nh,
                      const Plan& pl, cudaStream_t stream,
                      const int* inv_ptr = nullptr,
                      const int* inv_bj = nullptr, HaloRange hr = HaloRange{})
{
    auto k4 = bwd_dg_kernel<KMAX, RMAX, SPARSE, HALO>;
    cudaError_t err = cudaFuncSetAttribute(
        k4, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem4);
    if (err != cudaSuccess) return err;
    const int TS = pl.G * kRowsPerThread;
    const int blocks = (HALO ? hr.n_src : N) / TB;
    k4<<<dim3(blocks * ((TB + TS - 1) / TS), n_mesh), kThreads, pl.smem4,
         stream>>>(dc, sten, dg, N, C, K, R, TB, nh, pl.G, pl.TC, inv_ptr,
                   inv_bj, hr);
    return cudaGetLastError();
}

// The five passes of K8's backward (nh is NJ; nbr, inv_ptr and inv_bj the
// table's).
template <int KMAX, int RMAX>
int launch_fused_bwd(const float* dy, const float* g, const float* sten,
                     const float* wmat, float* dg, float* dw, float* scratch,
                     int n_mesh, int N, int C, int K, int R, int TB, int nh,
                     int O2, const Plan& pl, cudaStream_t stream,
                     const int* nbr, const int* inv_ptr, const int* inv_bj)
{
    float* contrib = scratch;
    float* dc = scratch + pl.dc_at;
    float* part = scratch + pl.part_at;
    const int rows = n_mesh * N;
    const int M = 2 * K * C;
    const int RM = R * M;

    cudaError_t err = launch_contrib<KMAX, RMAX, true>(
        g, sten, contrib, n_mesh, N, C, K, R, TB, nh, RM, M, pl, stream, nbr);
    if (err != cudaSuccess) return (int)err;

    const int CQ = C * pl.QS;
    bwd_dc_kernel<KMAX, RMAX><<<dim3((rows + kGemmTile - 1) / kGemmTile,
                                     (CQ + kGemmTile - 1) / kGemmTile),
                                kThreads, 0, stream>>>(dy, wmat, dc, rows, C,
                                                       K, R, O2);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

    err = launch_dw(contrib, dy, part, dw, rows, RM, O2,
                    DwSlices{pl.slices, pl.slice_rows}, stream);
    if (err != cudaSuccess) return (int)err;

    return (int)launch_dg<KMAX, RMAX, true>(dc, sten, dg, n_mesh, N, C, K, R,
                                            TB, nh, pl, stream, inv_ptr,
                                            inv_bj);
}

// Floats of the scratch buffer fused_bwd needs for these sizes (0 for
// sizes it does not take).
inline long long fused_bwd_scratch_floats(int n_mesh, int N, int C, int K,
                                          int R, int TB, int nh, int O2)
{
    Plan pl;
    if (!shapes_supported(n_mesh, N, C, K, R, TB, nh, O2)
        || make_plan(n_mesh, N, C, K, R, O2, &pl) != cudaSuccess)
        return 0;
    return (long long)pl.floats;
}

// Launches K8's backward (nh is NJ; nbr, inv_ptr and inv_bj the table's) on
// `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for shapes it does not take (K > 5; R > 8, or R >
// 6 with K > 3; C > 256; shared memory for one target of dc rows).
// scratch holds fused_bwd_scratch_floats floats.
inline int fused_bwd(const float* dy, const float* g, const float* sten,
                     const float* wmat, float* dg, float* dw, float* scratch,
                     int n_mesh, int N, int C, int K, int R, int TB, int nh,
                     int O2, cudaStream_t stream, const int* nbr,
                     const int* inv_ptr, const int* inv_bj)
{
    if (!shapes_supported(n_mesh, N, C, K, R, TB, nh, O2))
        return (int)cudaErrorInvalidValue;
    Plan pl;
    const cudaError_t err = make_plan(n_mesh, N, C, K, R, O2, &pl);
    if (err != cudaSuccess) return (int)err;
    if (K <= 3)
        return launch_fused_bwd<3, 8>(dy, g, sten, wmat, dg, dw, scratch,
                                      n_mesh, N, C, K, R, TB, nh, O2, pl,
                                      stream, nbr, inv_ptr, inv_bj);
    return launch_fused_bwd<5, 6>(dy, g, sten, wmat, dg, dw, scratch, n_mesh,
                                  N, C, K, R, TB, nh, O2, pl, stream, nbr,
                                  inv_ptr, inv_bj);
}

// --- the unfused contrib (K3, and K9's contrib, HALO) --------------------------

// K3's forward layout: contrib rows (b·R + r)·TB + t of each mesh, ts = M,
// rs = TB·M (pass 1 alone).  out holds n_mesh·targets·R·M floats, targets
// the launch's.
template <bool HALO = false>
int contrib_fwd(const float* g, const float* sten, float* out, int n_mesh,
                int N, int C, int K, int R, int TB, int nh,
                cudaStream_t stream, HaloRange hr = HaloRange{})
{
    if (!shapes_supported(n_mesh, N, C, K, R, TB, nh, 1)
        || (HALO && !halo_supported(N, TB, hr)))
        return (int)cudaErrorInvalidValue;
    Plan pl;
    cudaError_t err = make_plan(n_mesh, launch_targets<HALO>(N, TB, hr), C,
                                K, R, 0, &pl);
    if (err != cudaSuccess) return (int)err;
    const int M = 2 * K * C;
    err = K <= 3
        ? launch_contrib<3, 8, false, HALO>(
              g, sten, out, n_mesh, N, C, K, R, TB, nh, M, TB * M, pl, stream,
              nullptr, hr)
        : launch_contrib<5, 6, false, HALO>(
              g, sten, out, n_mesh, N, C, K, R, TB, nh, M, TB * M, pl, stream,
              nullptr, hr);
    return (int)err;
}

// dc[row, c·QS + (k·RMAX + r)·2 + p] = dout[m, (b·R + r)·TB + t, k·2C + p·C + c]
// for row = (m·nb + b)·TB + t of the cotangent's own blocks (nb of them
// a mesh); entries with k ≥ K or r ≥ R hold zero.
template <int KMAX, int RMAX>
__global__ void __launch_bounds__(kThreads)
dc_from_contrib_kernel(const float* __restrict__ dout, float* __restrict__ dc,
                       int C, int K, int R, int TB)
{
    constexpr int QS = dc_stride<KMAX, RMAX>();
    extern __shared__ __align__(16) float srow[];        // [R][M]
    const int M = 2 * K * C;
    const size_t row = blockIdx.x;
    const size_t mb = row / TB;            // m·nb + b
    const int t = (int)(row % TB);
    const int tid = threadIdx.x;
    for (int i = tid; i < R * M; i += kThreads) {
        const int r = i / M, j = i - r * M;
        srow[i] = dout[((mb * R + r) * TB + t) * M + j];
    }
    __syncthreads();
    float* out = dc + row * C * QS;
    for (int o = tid; o < C * QS; o += kThreads) {
        const int c = o / QS, q = o - c * QS;
        const int k = q / (2 * RMAX), r = (q / 2) % RMAX, p = q % 2;
        out[o] = (k < K && r < R) ? srow[r * M + k * 2 * C + p * C + c] : 0.f;
    }
}

template <int KMAX, int RMAX, bool HALO>
int launch_contrib_bwd(const float* dout, const float* sten, float* dg,
                       float* dc, int n_mesh, int N, int C, int K, int R,
                       int TB, int nh, const Plan& pl, cudaStream_t stream,
                       HaloRange hr)
{
    auto relayout = dc_from_contrib_kernel<KMAX, RMAX>;
    const size_t smem = (size_t)R * 2 * K * C * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        relayout, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const unsigned rows = (unsigned)n_mesh * launch_targets<HALO>(N, TB, hr);
    relayout<<<rows, kThreads, smem, stream>>>(dout, dc, C, K, R, TB);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    return (int)launch_dg<KMAX, RMAX, false, HALO>(
        dc, sten, dg, n_mesh, N, C, K, R, TB, nh, pl, stream, nullptr,
        nullptr, hr);
}

// Floats of the scratch buffer contrib_bwd needs (0 for sizes it does not
// take).
template <bool HALO = false>
inline long long contrib_bwd_scratch_floats(int n_mesh, int N, int C, int K,
                                            int R, int TB, int nh,
                                            HaloRange hr = HaloRange{})
{
    Plan pl;
    if (!shapes_supported(n_mesh, N, C, K, R, TB, nh, 1)
        || (HALO && !halo_supported(N, TB, hr))
        || make_plan(n_mesh, launch_targets<HALO>(N, TB, hr), C, K, R, 0,
                     &pl) != cudaSuccess)
        return 0;
    return (long long)pl.floats;
}

// K3's backward (HALO: K9's contrib backward): the cotangent dout in K3's
// forward layout put back into pass 5's channel-major dc (scratch: the
// caller's contrib_bwd_scratch_floats floats), then pass 5.
template <bool HALO = false>
int contrib_bwd(const float* dout, const float* sten, float* dg,
                float* scratch, int n_mesh, int N, int C, int K, int R,
                int TB, int nh, cudaStream_t stream,
                HaloRange hr = HaloRange{})
{
    if (!shapes_supported(n_mesh, N, C, K, R, TB, nh, 1)
        || (HALO && !halo_supported(N, TB, hr)))
        return (int)cudaErrorInvalidValue;
    Plan pl;
    const cudaError_t err = make_plan(
        n_mesh, launch_targets<HALO>(N, TB, hr), C, K, R, 0, &pl);
    if (err != cudaSuccess) return (int)err;
    if (K <= 3)
        return launch_contrib_bwd<3, 8, HALO>(dout, sten, dg, scratch, n_mesh,
                                              N, C, K, R, TB, nh, pl, stream,
                                              hr);
    return launch_contrib_bwd<5, 6, HALO>(dout, sten, dg, scratch, n_mesh, N,
                                          C, K, R, TB, nh, pl, stream, hr);
}

}  // namespace band
