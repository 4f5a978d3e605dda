// Fused banded field-conv forward (K1) for Hopper, sm_90a.
//
// Replaces the TPU kernel fieldconv_tpu/ops/pallas/band_conv.py::
// _band_megaw_fwd_impl and its same-math pipeline twins
// _band_fused_mega_fwd_impl and _band_fused_fwd_impl.  Python wrapper and
// plain PyTorch version: fieldconv_tpu_torch/ops/band_conv.py.
//
// What it computes, for mesh m, target n in block b = n / TB, ring r,
// frequency k and channel c (all float32, complex values planar):
//
//   s = (b - nh)·TB + w  for window slot w < W' = (2nh+1)·TB
//   h_k[w, c]  = f_k[n, w] · G_k[s, c]             (complex product)
//   contrib[n, r, k·2C + c]     = Σ_w rs_r[n, w] · Re h_k[w, c]
//   contrib[n, r, k·2C + C + c] = Σ_w rs_r[n, w] · Im h_k[w, c]
//   y[n, o] = Σ_r Σ_j contrib[n, r, j] · W[r, j, o]
//
// with rs_r = plane r and f_k = planes (R+2k, R+2k+1) of sten_band
// (n_mesh, nb, R+2K, TB, W'), G the k-major rotated-source tensor g
// (n_mesh, N, M = K·2C) and W = filters_to_wmat (R, M, O2), 1/K included.
// Slots whose source row s lies outside [0, N) contribute nothing; the
// kernel never reads outside g.
//
// Design.  The TPU kernel keeps a whole block's contrib (R·TB × M, ~1 MB at
// the serving shape) and all of g in VMEM.  Here one CTA owns a tile of
// T = 256 / C targets (8 at C = 32) of one block of one mesh, and one
// thread owns one (target, channel) item with all K·R complex accumulators
// of that item in registers: per window slot it loads the R radial weights
// once and, per k, forms h_k once and applies it to every ring.  The window
// streams through shared memory in chunks of kChunk slots (the chunk's g
// rows, zero-filled outside [0, N), and the tile's stencil planes),
// double-buffered with cp.async so the next chunk loads while this one is
// computed (band_window.cuh, shared with the backward in
// band_fused_bwd.cu).  A chunk whose radial weights are all zero for the
// tile is skipped, and so is a slot whose radial weights are all zero for
// the thread's target (no edge there).  The filter contraction then reads the
// tile's contrib from shared memory (the staging buffers reused) against
// W, which is read once per CTA from L2, split over thread groups and
// reduced through shared memory.  f32 FMA only, f32 accumulation.
//
// What bounds it.  At the serving shape N=8192, TB=128, nh=1, C=O=32, K=5,
// R=6 one call moves ~214 MB (stencil 201 MB, g 10.5 MB, W 0.5 MB, y 2 MB:
// 0.064 ms at 3.35 TB/s).  The dense window would cost ~24 GFLOP plus ~2
// for W (0.39 ms at 67 TFLOP/s f32).  The work the data needs is 4.36
// GFLOP: only D/W' = 1/3 of the slots hold an edge, each with two nonzero
// radial weights; h_k is formed once per occupied slot (6C flops per k)
// and added once per nonzero ring (4C per k), plus 2 GFLOP for W: 0.065
// ms, so the bound is operations, barely above the bytes (counted by
// chip_smoke.py::k1_bound from the run's stencil).  The kernel still
// stages every slot of a non-empty chunk and re-reads the window's g rows
// once per tile of targets; staging only occupied rows and moving the
// contraction onto tensor cores are left to later work.

#include "band_window.cuh"

#include <algorithm>
#include <cstddef>

namespace {

using band::kThreads;
using band::kTile;

template <int KMAX, int RMAX>
__global__ void __launch_bounds__(kThreads, 2)
band_fused_fwd_kernel(const float* __restrict__ g,
                      const float* __restrict__ sten,
                      const float* __restrict__ wmat,
                      float* __restrict__ y,
                      int N, int C, int K, int R, int TB, int nh, int O2,
                      int T)
{
    const int M = 2 * K * C;
    const int RM = R * M;
    const int P = R + 2 * K;
    const int Wp = (2 * nh + 1) * TB;
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
    band::window_contrib<KMAX, RMAX>(are, aim, smem, gm, sb, N, C, K, R, TB,
                                     nh, T, t0, nt, blk, active, it, ic);

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

size_t smem_bytes(int C, int K, int R, int O2, int T)
{
    const size_t M = 2 * (size_t)K * C;
    const size_t P = R + 2 * (size_t)K;
    const size_t JG = std::max(1, kThreads / O2);
    const size_t stages = band::window_stage_floats((int)M, (int)P, T);
    const size_t filter = (size_t)R * M * kTile + JG * (size_t)T * O2;
    return std::max(stages, filter) * sizeof(float);
}

template <int KMAX, int RMAX>
int launch(const float* g, const float* sten, const float* wmat, float* y,
           int n_mesh, int N, int C, int K, int R, int TB, int nh, int O2,
           int T, size_t smem, cudaStream_t stream)
{
    auto kernel = band_fused_fwd_kernel<KMAX, RMAX>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((N / TB) * ((TB + T - 1) / T), n_mesh);
    kernel<<<grid, kThreads, smem, stream>>>(g, sten, wmat, y, N, C, K, R,
                                             TB, nh, O2, T);
    return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for shapes the kernel does not take (K > 5, i.e.
// band limit > 2; R > 8, or R > 6 with K > 3; C > 256).
extern "C" int band_fused_fwd(const float* g, const float* sten,
                              const float* wmat, float* y,
                              int n_mesh, int N, int C, int K, int R, int TB,
                              int nh, int O2, void* stream)
{
    if (!band::shapes_supported(n_mesh, N, C, K, R, TB, nh, O2))
        return (int)cudaErrorInvalidValue;
    int limit = 0;
    const cudaError_t err = band::smem_limit(&limit);
    if (err != cudaSuccess) return (int)err;
    int T = std::min(kTile, kThreads / C);
    while (T > 1 && smem_bytes(C, K, R, O2, T) > (size_t)limit) T /= 2;
    const size_t smem = smem_bytes(C, K, R, O2, T);
    if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (K <= 3)
        return launch<3, 8>(g, sten, wmat, y, n_mesh, N, C, K, R, TB, nh, O2,
                            T, smem, s);
    return launch<5, 6>(g, sten, wmat, y, n_mesh, N, C, K, R, TB, nh, O2, T,
                        smem, s);
}
