// The banded-window contraction shared by K3 (band_contrib_fwd.cu,
// band_contrib_bwd.cu), K8 (band_sparse_fwd.cu, band_sparse_bwd.cu) and
// K9's contrib (halo_contrib_fwd.cu, halo_contrib_bwd.cu): staging of the
// block window through shared memory and the per-thread contrib
// accumulation.  (K1, K4 and K9's fused conv walk their band's panels
// instead: band_pipe.cuh.)
//
// For mesh m, target n = blk·TB + t0 + it of a tile of nt ≤ T targets,
// channel ic, ring r and frequency k it forms
//
//   s = (blk - nh)·TB + w  for window slot w < W' = (2nh+1)·TB
//       (block-sparse, SPARSE: s = nbr[blk, w / TB]·TB + w % TB for
//        w < W' = NJ·TB, with NJ passed as nh)
//   h_k[w]  = f_k[n, w] · G_k[s, ic]                 (complex product)
//   are[k][r] = Σ_w rs_r[n, w] · Re h_k[w],  aim[k][r] = Σ_w rs_r[n, w] · Im h_k[w]
//
// with rs_r = plane r and f_k = planes (R+2k, R+2k+1) of the block's stencil
// (R+2K, TB, W') and G the k-major rotated-source tensor (N, M = K·2C).
// Slots whose source row lies outside [0, N) count zero and are never read.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace band {

constexpr int kThreads = 256;
constexpr int kTile = 8;       // most targets per CTA
constexpr int kChunk = 16;     // window slots staged per step

// 4-byte or 16-byte async copy global -> shared; zero-fills when !valid.
template <int kBytes>
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool valid)
{
    __pipeline_memcpy_async(dst, src, kBytes, valid ? 0 : kBytes);
}

// A launch over a halo-extended source array (K9's contrib, HALO:
// halo_contrib_fwd.cu, halo_contrib_bwd.cu): target blocks [lo, hi) of the
// stencil's nb = N / TB are launched; block b's window starts at source
// block b + blk_off of g, which holds n_src rows per mesh (a shard's rows
// with its neighbours' nh·TB halo rows on each side, blk_off = 0, or a
// piece of them); the launch's contrib, dc and dy rows are its (hi − lo)·TB
// targets per mesh.  The dense window is n_src = N, blk_off = −nh, lo = 0,
// hi = nb.
struct HaloRange {
    int n_src, blk_off, lo, hi;
};

// The source row of slot w: row0 + w in the dense window (and in the
// halo-extended one, whose row0 is (b + blk_off)·TB); in the block-sparse
// one (SPARSE) row w % TB of source block nbr_b[w / TB].
template <bool SPARSE>
__device__ __forceinline__ long source_row(long row0, const int* nbr_b,
                                           int w, int TB)
{
    if constexpr (SPARSE) {
        const int j = w / TB;
        return (long)__ldg(nbr_b + j) * TB + (w - j * TB);
    } else {
        return row0 + w;
    }
}

template <int kBytes, bool SPARSE = false>
__device__ __forceinline__ void stage_chunk(
    float* gs, float* ss, const float* gm, const float* sb,
    long row0, int w0, int nw, int N, int M, int P, int TB, int Wp, int t0,
    int nt, int T, const int* nbr_b = nullptr)
{
    constexpr int V = kBytes / 4;
    const int tid = threadIdx.x;
    const int mv = M / V;
    for (int i = tid; i < kChunk * mv; i += kThreads) {
        const int wi = i / mv;
        const long s = wi < nw ? source_row<SPARSE>(row0, nbr_b, w0 + wi, TB)
                               : -1;
        const bool ok = s >= 0 && s < N;
        copy_async<kBytes>(gs + i * V,
                           ok ? gm + (size_t)s * M + (i - wi * mv) * V : gm,
                           ok);
    }
    constexpr int cv = kChunk / V;
    for (int i = tid; i < T * P * cv; i += kThreads) {
        const int wv = i % cv;
        const int tp = i / cv;
        const int p = tp % P, t = tp / P;
        const bool ok = t < nt && wv * V < nw;
        copy_async<kBytes>(
            ss + i * V,
            ok ? sb + ((size_t)p * TB + t0 + t) * Wp + w0 + wv * V : sb, ok);
    }
}

// Floats of shared memory window_contrib stages: two buffers, each a
// chunk of g rows and the tile's R + 2K stencil planes.
inline size_t window_stage_floats(int M, int P, int T)
{
    return 2 * ((size_t)kChunk * M + (size_t)T * P * kChunk);
}

// Every thread of the CTA must call this (it synchronises); inactive
// threads keep zero sums.  gm: mesh m's g (N, M), whose rows from
// (blk − nh)·TB on make the window (a HALO caller passes its source
// array's n_src as N and blk + blk_off + nh as blk); sb: the target
// block's stencil (R+2K planes × TB × W'); SPARSE: nh is NJ and nbr_b
// block blk's NJ source blocks; smem: window_stage_floats(M, R+2K, T)
// floats, free again on return.  The window streams
// through shared memory kChunk slots at a time, double-buffered with
// cp.async; a chunk whose radial weights are all zero for the tile is
// skipped, and so is a slot whose radial weights are all zero for the
// thread's target (no edge there).
template <int KMAX, int RMAX, bool SPARSE = false>
__device__ __forceinline__ void window_contrib(
    float (&are)[KMAX][RMAX], float (&aim)[KMAX][RMAX], float* smem,
    const float* gm, const float* sb, int N, int C, int K, int R, int TB,
    int nh, int T, int t0, int nt, int blk, bool active, int it, int ic,
    const int* nbr_b = nullptr)
{
    const int M = 2 * K * C;
    const int P = R + 2 * K;
    const int Wp = (SPARSE ? nh : 2 * nh + 1) * TB;
    const int tid = threadIdx.x;
    const int stage_floats = kChunk * M + T * P * kChunk;
    const long row0 = (long)(blk - nh) * TB;
    // 16-byte copies when every row start is 16-byte aligned
    const bool vec = (M % 4 == 0) && (Wp % 4 == 0);

#pragma unroll
    for (int k = 0; k < KMAX; ++k)
#pragma unroll
        for (int r = 0; r < RMAX; ++r) { are[k][r] = 0.f; aim[k][r] = 0.f; }

    const int n_chunks = (Wp + kChunk - 1) / kChunk;
    auto prefetch = [&](int ci) {
        float* buf = smem + (ci & 1) * stage_floats;
        const int w0 = ci * kChunk;
        const int nw = min(kChunk, Wp - w0);
        if (vec && nw == kChunk)
            stage_chunk<16, SPARSE>(buf, buf + kChunk * M, gm, sb, row0, w0,
                                    nw, N, M, P, TB, Wp, t0, nt, T, nbr_b);
        else
            stage_chunk<4, SPARSE>(buf, buf + kChunk * M, gm, sb, row0, w0,
                                   nw, N, M, P, TB, Wp, t0, nt, T, nbr_b);
        __pipeline_commit();
    };

    prefetch(0);
    for (int ci = 0; ci < n_chunks; ++ci) {
        if (ci + 1 < n_chunks) {
            prefetch(ci + 1);
            __pipeline_wait_prior(1);
        } else {
            __pipeline_wait_prior(0);
        }
        const float* gs = smem + (ci & 1) * stage_floats;
        const float* ss = gs + kChunk * M;
        const int nw = min(kChunk, Wp - ci * kChunk);

        // the barrier that publishes the chunk also votes on whether any
        // radial weight of the tile is nonzero in it; each thread reads back
        // only the stencil elements its own copies wrote (complete after its
        // wait), in stage_chunk's order
        int nz = 0;
        const int V = (vec && nw == kChunk) ? 4 : 1;
        const int cv = kChunk / V;
        for (int i = tid; i < T * P * cv; i += kThreads) {
            if ((i / cv) % P < R)
                for (int v = 0; v < V; ++v) nz |= ss[i * V + v] != 0.f;
        }
        if (__syncthreads_or(nz) && active) {
            const float* st = ss + it * P * kChunk;
            const float* gc = gs + ic;
            for (int wi = 0; wi < nw; ++wi) {
                float rs[RMAX];
                bool edge = false;
#pragma unroll
                for (int r = 0; r < RMAX; ++r) {
                    rs[r] = r < R ? st[r * kChunk + wi] : 0.f;
                    edge |= rs[r] != 0.f;
                }
                // no edge in this slot for this target (uniform across a
                // warp when C = 32: its lanes share the target)
                if (!edge) continue;
#pragma unroll
                for (int k = 0; k < KMAX; ++k) {
                    if (k < K) {
                        const float xr = gc[wi * M + k * 2 * C];
                        const float xi = gc[wi * M + k * 2 * C + C];
                        const float fr = st[(R + 2 * k) * kChunk + wi];
                        const float fi = st[(R + 2 * k + 1) * kChunk + wi];
                        const float hr = fr * xr - fi * xi;
                        const float hi = fr * xi + fi * xr;
#pragma unroll
                        for (int r = 0; r < RMAX; ++r) {
                            are[k][r] = fmaf(rs[r], hr, are[k][r]);
                            aim[k][r] = fmaf(rs[r], hi, aim[k][r]);
                        }
                    }
                }
            }
        }
        __syncthreads();                   // buffer free for chunk ci + 2
    }
}

// Shape limits shared by both directions: K ≤ 5 (band limit ≤ 2); R ≤ 8,
// or R ≤ 6 with K > 3; C ≤ kThreads.
inline bool shapes_supported(int n_mesh, int N, int C, int K, int R, int TB,
                             int nh, int O2)
{
    return !(n_mesh < 1 || N < 1 || C < 1 || C > kThreads || K < 1 || K > 5
             || R < 1 || R > (K <= 3 ? 8 : 6) || TB < 1 || N % TB != 0
             || nh < 0 || O2 < 1 || n_mesh > 65535);
}

// A HALO launch's range: n_src a positive multiple of TB, 0 ≤ lo < hi ≤
// N / TB.
inline bool halo_supported(int N, int TB, const HaloRange& hr)
{
    return hr.n_src >= TB && hr.n_src % TB == 0 && hr.lo >= 0
        && hr.lo < hr.hi && hr.hi <= N / TB;
}

inline cudaError_t smem_limit(int* limit)
{
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    return cudaDeviceGetAttribute(limit,
                                  cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                  dev);
}

}  // namespace band
