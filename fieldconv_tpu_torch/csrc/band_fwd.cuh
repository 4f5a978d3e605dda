// The fused banded forward of K8 (band_sparse_fwd.cu, block-sparse
// stencil: block b's window is its NJ listed source blocks): one CTA per
// tile of targets of one block of one mesh forms the tile's contrib over
// the window (band_window.cuh, SPARSE), then applies W.  It computes K1's
// function (band_fused_fwd.cu) on that layout.
//
// Design.  A CTA owns T = 256 / C targets (8 at C = 32), one thread a
// (target, channel) item with all K·R complex sums in registers; the
// window streams through shared memory kChunk slots at a time (the chunk's
// g rows, zero-filled outside [0, N), and the tile's stencil planes),
// double-buffered with cp.async; a chunk whose radial weights are all zero
// for the tile is skipped, and so is a slot with none for the thread's
// target.  The filter then reads the tile's contrib from shared memory
// against W, read once per CTA from L2.  f32 FMA only; every output one
// writer.

#pragma once

#include "band_window.cuh"

#include <algorithm>
#include <cstddef>

namespace band {

// NJ: the source blocks a target block lists, nbr the meshes' (n_mesh, nb,
// NJ) source blocks.
template <int KMAX, int RMAX>
__global__ void __launch_bounds__(kThreads, 2)
fused_fwd_kernel(const float* __restrict__ g,
                 const float* __restrict__ sten,
                 const float* __restrict__ wmat,
                 float* __restrict__ y,
                 int N, int C, int K, int R, int TB, int NJ, int O2, int T,
                 const int* __restrict__ nbr)
{
    const int M = 2 * K * C;
    const int RM = R * M;
    const int P = R + 2 * K;               // stencil planes
    const int Wp = NJ * TB;
    const int nb = N / TB;
    const int tiles = (TB + T - 1) / T;
    const int blk = blockIdx.x / tiles;
    const int t0 = (blockIdx.x % tiles) * T;
    const int nt = min(T, TB - t0);
    const int m = blockIdx.y;
    const int tid = threadIdx.x;

    extern __shared__ __align__(16) float smem[];
    float* contrib = smem;                 // [R·M][kTile], after the window
    float* red = smem + RM * kTile;        // [JG][T][O2]

    const float* gm = g + (size_t)m * N * M;
    const float* sb = sten + ((size_t)m * nb + blk) * (size_t)P * TB * Wp;

    const int item = tid;                  // (t, c) = (item / C, item % C)
    const bool active = item < nt * C;
    const int it = active ? item / C : 0;
    const int ic = active ? item % C : 0;

    float are[KMAX][RMAX], aim[KMAX][RMAX];
    window_contrib<KMAX, RMAX, true>(
        are, aim, smem, gm, sb, N, C, K, R, TB, NJ, T, t0, nt, blk, active,
        it, ic, nbr + ((size_t)m * nb + blk) * NJ);

    // contrib[j][t] with j = r·M + k·2C + (p·C + c), targets padded to kTile
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

    // y[t, o] = Σ_j contrib[j][t] · W[j, o]: thread (o, jg) sums
    // j ≡ jg (mod JG) for every target of the tile, so W is read once per
    // CTA; the JG partials are reduced through `red`.
    const int JG = max(1, kThreads / O2);
    for (int u = tid; u < O2 * JG; u += kThreads) {
        const int o = u % O2, jg = u / O2;
        float acc[kTile];
#pragma unroll
        for (int t = 0; t < kTile; ++t) acc[t] = 0.f;
#pragma unroll 4
        for (int j = jg; j < RM; j += JG) {
            const float wv = wmat[(size_t)j * O2 + o];
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
    for (int u = tid; u < nt * O2; u += kThreads) {
        const int o = u % O2, t = u / O2;
        float acc = 0.f;
        for (int jg = 0; jg < JG; ++jg) acc += red[(jg * T + t) * O2 + o];
        y[((size_t)m * N + (size_t)blk * TB + t0 + t) * O2 + o] = acc;
    }
}

inline size_t fused_fwd_smem_bytes(int C, int K, int R, int O2, int T)
{
    const size_t M = 2 * (size_t)K * C;
    const size_t P = R + 2 * (size_t)K;
    const size_t JG = std::max(1, kThreads / O2);
    const size_t stages = window_stage_floats((int)M, (int)P, T);
    const size_t filter = (size_t)R * M * kTile + JG * (size_t)T * O2;
    return std::max(stages, filter) * sizeof(float);
}

template <int KMAX, int RMAX>
int launch_fused_fwd(const float* g, const float* sten, const float* wmat,
                     float* y, int n_mesh, int N, int C, int K, int R, int TB,
                     int NJ, int O2, int T, size_t smem, cudaStream_t stream,
                     const int* nbr)
{
    auto kernel = fused_fwd_kernel<KMAX, RMAX>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(N / TB * ((TB + T - 1) / T), n_mesh);
    kernel<<<grid, kThreads, smem, stream>>>(g, sten, wmat, y, N, C, K, R,
                                             TB, NJ, O2, T, nbr);
    return (int)cudaGetLastError();
}

// Launches K8's forward (NJ listed source blocks a target block, nbr the
// (n_mesh, nb, NJ) source blocks) on `stream`; returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for shapes it does not take
// (K > 5, i.e. band limit > 2; R > 8, or R > 6 with K > 3; C > 256).
inline int fused_fwd(const float* g, const float* sten, const float* wmat,
                     float* y, int n_mesh, int N, int C, int K, int R, int TB,
                     int NJ, int O2, cudaStream_t stream, const int* nbr)
{
    if (!shapes_supported(n_mesh, N, C, K, R, TB, NJ, O2))
        return (int)cudaErrorInvalidValue;
    int limit = 0;
    const cudaError_t err = smem_limit(&limit);
    if (err != cudaSuccess) return (int)err;
    int T = std::min(kTile, kThreads / C);
    while (T > 1 && fused_fwd_smem_bytes(C, K, R, O2, T) > (size_t)limit)
        T /= 2;
    const size_t smem = fused_fwd_smem_bytes(C, K, R, O2, T);
    if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
    if (K <= 3)
        return launch_fused_fwd<3, 8>(g, sten, wmat, y, n_mesh, N, C, K, R,
                                      TB, NJ, O2, T, smem, stream, nbr);
    return launch_fused_fwd<5, 6>(g, sten, wmat, y, n_mesh, N, C, K, R, TB,
                                  NJ, O2, T, smem, stream, nbr);
}

}  // namespace band
