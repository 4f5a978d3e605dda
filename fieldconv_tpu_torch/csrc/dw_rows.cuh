// dW = Σ_rows contribᵀ · dy in a fixed order, shared by the backwards of
// K1, K9 and K4 (band_call.cuh), K8 (band_bwd.cuh, passes 3-4), K5
// (band_panel_bwd.cu) and K6 (band_compact_bwd.cu): contrib
// (rows, RM) and dy (rows, O2) row-major, dW (RM, O2).
//
// A CTA owns 128 rows j × 64 columns o of dW for one slice of the rows, and
// writes its partial sum; lane (jl, half) keeps 32 columns in registers.
// Row chunks of contrib and dy are double-buffered through shared memory by
// cp.async.  bwd_dw_combine then adds the slices' partials in slice order,
// so two calls on the same inputs agree bitwise (no atomics).

#pragma once

#include "band_window.cuh"

#include <algorithm>
#include <cstddef>

namespace band {
namespace {

constexpr int kDwJ = 128;
constexpr int kDwO = 64;
constexpr int kDwRows = 16;

template <int V>
__global__ void __launch_bounds__(kThreads)
bwd_dw_partial_kernel(const float* __restrict__ contrib,
                      const float* __restrict__ dy,
                      float* __restrict__ part, int rows, int RM, int O2,
                      int slice_rows)
{
    static_assert(kDwJ * 2 == kThreads && kDwO == 64, "lane = (j, half)");
    __shared__ __align__(16) float cs[2][kDwRows][kDwJ];
    __shared__ __align__(16) float ds[2][kDwRows][kDwO];
    const int j0 = blockIdx.x * kDwJ, o0 = blockIdx.y * kDwO;
    const int lo = blockIdx.z * slice_rows;
    const int hi = min(rows, lo + slice_rows);
    const int tid = threadIdx.x;
    const int jl = tid % kDwJ, half = tid / kDwJ;
    float acc[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) acc[q] = 0.f;

    auto prefetch = [&](int ci) {
        const int b = ci & 1, row0 = lo + ci * kDwRows;
        for (int u = tid; u < kDwRows * kDwJ / V; u += kThreads) {
            const int i = u / (kDwJ / V), jj = (u % (kDwJ / V)) * V;
            const bool ok = row0 + i < hi && j0 + jj < RM;
            band::copy_async<4 * V>(
                &cs[b][i][jj],
                ok ? contrib + (size_t)(row0 + i) * RM + j0 + jj : contrib,
                ok);
        }
        for (int u = tid; u < kDwRows * kDwO; u += kThreads) {
            const int i = u / kDwO, oo = u % kDwO;
            const bool ok = row0 + i < hi && o0 + oo < O2;
            band::copy_async<4>(
                &ds[b][i][oo],
                ok ? dy + (size_t)(row0 + i) * O2 + o0 + oo : dy, ok);
        }
        __pipeline_commit();
    };

    const int n_chunks = (hi - lo + kDwRows - 1) / kDwRows;
    if (n_chunks > 0) prefetch(0);
    for (int ci = 0; ci < n_chunks; ++ci) {
        if (ci + 1 < n_chunks) {
            prefetch(ci + 1);
            __pipeline_wait_prior(1);
        } else {
            __pipeline_wait_prior(0);
        }
        __syncthreads();
        const int b = ci & 1;
#pragma unroll 4
        for (int i = 0; i < kDwRows; ++i) {
            const float c = cs[b][i][jl];
            const float4* d4 = reinterpret_cast<const float4*>(&ds[b][i][half * 32]);
#pragma unroll
            for (int v = 0; v < 8; ++v) {
                const float4 d = d4[v];
                acc[4 * v] = fmaf(c, d.x, acc[4 * v]);
                acc[4 * v + 1] = fmaf(c, d.y, acc[4 * v + 1]);
                acc[4 * v + 2] = fmaf(c, d.z, acc[4 * v + 2]);
                acc[4 * v + 3] = fmaf(c, d.w, acc[4 * v + 3]);
            }
        }
        __syncthreads();                   // buffer free for chunk ci + 2
    }
    const int j = j0 + jl;
    if (j < RM) {
        float* out = part + ((size_t)blockIdx.z * RM + j) * O2;
#pragma unroll
        for (int q = 0; q < 32; ++q) {
            const int o = o0 + half * 32 + q;
            if (o < O2) out[o] = acc[q];
        }
    }
}

__global__ void bwd_dw_combine(const float* __restrict__ part,
                               float* __restrict__ dw, int n_slices,
                               long long n)
{
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n) return;
    float sum = 0.f;
    for (int sl = 0; sl < n_slices; ++sl) sum += part[sl * n + e];
    dw[e] = sum;
}

}  // namespace

// Row slices of a dW pass: about two CTAs per SM over all of dW's tiles.
struct DwSlices {
    int slices, slice_rows;
};

inline DwSlices dw_slices(long long rows, int RM, int O2, int sms)
{
    const int tiles = ((RM + kDwJ - 1) / kDwJ) * ((O2 + kDwO - 1) / kDwO);
    const long long want = std::max(1, (2 * sms + tiles - 1) / tiles);
    const long long chunks = (rows + kDwRows - 1) / kDwRows;
    const long long per = (chunks + want - 1) / want;
    DwSlices d;
    d.slice_rows = (int)(per * kDwRows);
    d.slices = (int)((rows + d.slice_rows - 1) / d.slice_rows);
    return d;
}

// Launches both kernels on `stream`; part holds sl.slices·RM·O2 floats.
inline cudaError_t launch_dw(const float* contrib, const float* dy,
                             float* part, float* dw, int rows, int RM, int O2,
                             const DwSlices& sl, cudaStream_t stream)
{
    const dim3 grid((RM + kDwJ - 1) / kDwJ, (O2 + kDwO - 1) / kDwO,
                    sl.slices);
    if (RM % 4 == 0)
        bwd_dw_partial_kernel<4><<<grid, kThreads, 0, stream>>>(
            contrib, dy, part, rows, RM, O2, sl.slice_rows);
    else
        bwd_dw_partial_kernel<1><<<grid, kThreads, 0, stream>>>(
            contrib, dy, part, rows, RM, O2, sl.slice_rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long n = (long long)RM * O2;
    bwd_dw_combine<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                     stream>>>(part, dw, sl.slices, n);
    return cudaGetLastError();
}

}  // namespace band
