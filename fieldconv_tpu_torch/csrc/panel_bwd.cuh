// Passes 1 and 3 of the panel convs' backwards, shared by K5's
// (band_panel_bwd.cu) and K6's (band_compact_bwd.cu): contrib of every
// target row rematerialised over the target order of the panels, and
// dc = dy·Wᵀ written over it.  Pass 2 (dW) is dw_rows.cuh.
//
// Both write one scratch layout, (rows, R·M) row-major with column j =
// r·M + k·2C + (p·C + c) (p: re then im), so that a row of contrib and the
// same row of dc lie at one address.

#pragma once

#include "panel_walk.cuh"

#include <cstddef>

namespace panel {
namespace {

// --- pass 1: contrib per tile of targets ---------------------------------------------
//
// The forward's walk and launch bounds without its filter stage.  GATHER:
// K6's compact panels (TB × TS columns read through src_idx), as in
// band_compact_fwd.cu.

template <int KMAX, int RMAX, int MINB, bool GATHER, typename ST>
__global__ void __launch_bounds__(kMaxThreads, MINB)
bwd_contrib_kernel(const float* __restrict__ g,
                   const ST* __restrict__ sten,
                   const int* __restrict__ meta,
                   float* __restrict__ contrib,
                   int P, int C, int K, int R, int TB, int compressed,
                   int nb_g, int T, Knots kn,
                   const int* __restrict__ src_idx, int TS)
{
    const int M = 2 * K * C;
    const int RM = R * M;
    const int tiles = (TB + T - 1) / T;
    const int blk = blockIdx.x / tiles;
    const int t0 = (blockIdx.x % tiles) * T;
    const int nt = min(T, TB - t0);
    const int tid = threadIdx.x;
    const bool active = tid < nt * C;
    const int it = active ? tid / C : 0;     // (target, channel) of a thread
    const int ic = active ? tid % C : 0;

    extern __shared__ __align__(16) float smem[];
    float are[KMAX][RMAX], aim[KMAX][RMAX];
    panel_contrib<KMAX, RMAX, GATHER, ST>(are, aim, smem, g, sten, meta, P,
                                          C, K, R, TB, compressed, nb_g, T,
                                          blk, t0, nt, active, it, ic, kn,
                                          src_idx, TS);
    if (!active) return;
    // contrib[row, j] with j = r·M + k·2C + (p·C + c): coalesced over c
    float* cr = contrib + ((size_t)blk * TB + t0 + it) * RM;
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
#pragma unroll
        for (int r = 0; r < RMAX; ++r)
            if (k < K && r < R) {
                const int j = r * M + k * 2 * C + ic;
                cr[j] = are[k][r];
                cr[j + C] = aim[k][r];
            }
}

// --- pass 3: dc = dy · Wᵀ -----------------------------------------------------------
//
// dc[row, j] = Σ_o dy[row, o] · W[j, o] with W viewed as (R·M, O2): a CTA
// owns 64 rows × 64 columns, each thread 4 × 4 of them, summed over o in
// order.

constexpr int kGemmTile = 64;
constexpr int kGemmDepth = 16;

__global__ void __launch_bounds__(256)
bwd_dc_kernel(const float* __restrict__ dy, const float* __restrict__ wmat,
              float* __restrict__ dc, int rows, int RM, int O2)
{
    constexpr int LD = kGemmTile + 4;      // float4-aligned, fewer conflicts
    __shared__ __align__(16) float as[kGemmDepth][LD];   // dyᵀ: [o][row]
    __shared__ __align__(16) float bs[kGemmDepth][LD];   // Wᵀ:  [o][j]
    const int r0 = blockIdx.x * kGemmTile, j0 = blockIdx.y * kGemmTile;
    const int tid = threadIdx.x;
    const int ty = tid / 16, tx = tid % 16;
    float acc[4][4] = {};
    for (int o0 = 0; o0 < O2; o0 += kGemmDepth) {
        __syncthreads();                   // the last tile is read
        for (int u = tid; u < kGemmTile * kGemmDepth; u += 256) {
            const int i = u / kGemmDepth, o = u % kGemmDepth;
            const bool ok = o0 + o < O2;
            as[o][i] = ok && r0 + i < rows
                ? dy[(size_t)(r0 + i) * O2 + o0 + o] : 0.f;
            bs[o][i] = ok && j0 + i < RM
                ? wmat[(size_t)(j0 + i) * O2 + o0 + o] : 0.f;
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
#pragma unroll
    for (int x = 0; x < 4; ++x) {
        const int row = r0 + ty * 4 + x;
        if (row >= rows) continue;
#pragma unroll
        for (int y = 0; y < 4; ++y) {
            const int j = j0 + tx * 4 + y;
            if (j < RM) dc[(size_t)row * RM + j] = acc[x][y];
        }
    }
}

}  // namespace

// Launches pass 3 on `stream`: dc (rows, RM) = dy (rows, O2) · Wᵀ.
inline cudaError_t launch_dc(const float* dy, const float* wmat, float* dc,
                             int rows, int RM, int O2, cudaStream_t stream)
{
    bwd_dc_kernel<<<dim3((rows + kGemmTile - 1) / kGemmTile,
                         (RM + kGemmTile - 1) / kGemmTile), 256, 0,
                    stream>>>(dy, wmat, dc, rows, RM, O2);
    return cudaGetLastError();
}

}  // namespace panel
