// The panel convs' two dense products with W, viewed as (R·M, O2): the
// forward's filter y = contrib·W (K5's, K6's, K1's, K9's and K4's
// forwards, after their contrib walk) and the backward's dc = dy·Wᵀ (in
// those kernels' backwards).  contrib and dc share one layout, (rows, R·M)
// row-major with column j = r·M + k·2C + (p·C + c) (p: re then im), so
// that a row of contrib and the same row of dc lie at one address in the
// backward's scratch.  Each sums in a fixed order: two calls agree
// bitwise.

#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

namespace panel {
namespace {

// The filter: y[row, o] = Σ_j contrib[row, j]·W[j, o], W viewed as (R·M,
// O2).  A CTA owns 128 rows × 64 columns, each thread 8 × 4 of them,
// summed over j in order; tiles of contrib (transposed) and W through
// shared memory, two of each in turn.  Split over j (blockIdx.z, jlen
// each): slice z's partial sums go to y + z·rows·O2, for filter_combine.
// Row `row` of the product lands in row (row / rpm)·ys + row % rpm of y:
// rpm rows a mesh, meshes ys rows apart (K9 writes its range's rows of each
// mesh's y); ys = 0 means y's own rows.

constexpr int kFiltRows = 128;
constexpr int kFiltCols = 64;
constexpr int kFiltDepth = 16;

__global__ void __launch_bounds__(256)
filter_kernel(const float* __restrict__ contrib,
              const float* __restrict__ wmat, float* __restrict__ y,
              int rows, int RM, int O2, int jlen, int rpm, int ys)
{
    // two tiles of each in turn: the next one's loads are in flight (in
    // registers) while this one's products are summed
    __shared__ __align__(16) float as[2][kFiltDepth][kFiltRows + 4];
    __shared__ __align__(16) float bs[2][kFiltDepth][kFiltCols + 4];
    const int r0 = blockIdx.x * kFiltRows, o0 = blockIdx.y * kFiltCols;
    const int jb = blockIdx.z * jlen, je = min(RM, jb + jlen);
    y += (size_t)blockIdx.z * rows * O2;
    const int tid = threadIdx.x;
    const int ty = tid / 16, tx = tid % 16;
    constexpr int NA = kFiltRows * kFiltDepth / 256;   // loads a thread
    constexpr int NB = kFiltCols * kFiltDepth / 256;
    float ra[NA], rb[NB];
    auto load = [&](int j0) {
#pragma unroll
        for (int q = 0; q < NA; ++q) {
            const int u = tid + 256 * q;
            const int i = u / kFiltDepth, j = u % kFiltDepth;
            ra[q] = r0 + i < rows && j0 + j < je
                ? __ldg(contrib + (size_t)(r0 + i) * RM + j0 + j) : 0.f;
        }
#pragma unroll
        for (int q = 0; q < NB; ++q) {
            const int u = tid + 256 * q;
            const int j = u / kFiltCols, o = u % kFiltCols;
            rb[q] = j0 + j < je && o0 + o < O2
                ? __ldg(wmat + (size_t)(j0 + j) * O2 + o0 + o) : 0.f;
        }
    };
    auto store = [&](int t) {
#pragma unroll
        for (int q = 0; q < NA; ++q) {
            const int u = tid + 256 * q;
            as[t][u % kFiltDepth][u / kFiltDepth] = ra[q];
        }
#pragma unroll
        for (int q = 0; q < NB; ++q) {
            const int u = tid + 256 * q;
            bs[t][u / kFiltCols][u % kFiltCols] = rb[q];
        }
    };
    float acc[8][4] = {};
    load(jb);
    store(0);
    __syncthreads();
    const int nt = (je - jb + kFiltDepth - 1) / kFiltDepth;
    for (int t = 0; t < nt; ++t) {
        if (t + 1 < nt) load(jb + (t + 1) * kFiltDepth);
        const int c = t & 1;
#pragma unroll
        for (int j = 0; j < kFiltDepth; ++j) {
            const float4 a0 = *reinterpret_cast<const float4*>(&as[c][j][ty * 8]);
            const float4 a1 = *reinterpret_cast<const float4*>(&as[c][j][ty * 8 + 4]);
            const float4 bv4 = *reinterpret_cast<const float4*>(&bs[c][j][tx * 4]);
            const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float bv[4] = {bv4.x, bv4.y, bv4.z, bv4.w};
#pragma unroll
            for (int x = 0; x < 8; ++x)
#pragma unroll
                for (int z = 0; z < 4; ++z)
                    acc[x][z] = fmaf(av[x], bv[z], acc[x][z]);
        }
        if (t + 1 < nt) store(c ^ 1);    // the other buffer: read a step ago
        __syncthreads();
    }
#pragma unroll
    for (int x = 0; x < 8; ++x) {
        const int row = r0 + ty * 8 + x;
        if (row >= rows) continue;
        float* yr = y + (ys ? (size_t)(row / rpm) * ys + row % rpm
                            : (size_t)row) * O2;
#pragma unroll
        for (int z = 0; z < 4; ++z) {
            const int o = o0 + tx * 4 + z;
            if (o < O2) yr[o] = acc[x][z];
        }
    }
}

// y at (row, o) = Σ_z part[z·n + row·O2 + o] over the filter's j slices,
// in slice order (rows placed as filter_kernel places them).
__global__ void __launch_bounds__(256)
filter_combine(const float* __restrict__ part, float* __restrict__ y,
               int slices, long long n, int O2, int rpm, int ys)
{
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n) return;
    float sum = 0.f;
    for (int z = 0; z < slices; ++z) sum += part[z * n + e];
    if (ys == 0) {                       // y's own rows
        y[e] = sum;
        return;
    }
    const long long row = e / O2;
    y[((row / rpm) * ys + row % rpm) * O2 + (e - row * O2)] = sum;
}

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

// Launches the filter on `stream`: y (rows, O2) = contrib (rows, RM) · W,
// row `row` of it into row (row / rpm)·ys + row % rpm of y (rpm 0: y's own
// rows, without the divisions).
inline cudaError_t launch_filter(const float* contrib, const float* wmat,
                                 float* y, int rows, int RM, int O2,
                                 cudaStream_t stream, int rpm = 0, int ys = 0)
{
    filter_kernel<<<dim3((rows + kFiltRows - 1) / kFiltRows,
                         (O2 + kFiltCols - 1) / kFiltCols), 256, 0,
                    stream>>>(contrib, wmat, y, rows, RM, O2, RM,
                              rpm > 0 ? rpm : rows, rpm > 0 ? ys : 0);
    return cudaGetLastError();
}

// Slices of j that give the filter at most one wave of two CTAs an SM,
// each slice at least 128 deep (1: no split).
inline int filter_slices(int rows, int RM, int O2, int sms)
{
    const long long tiles = (long long)((rows + kFiltRows - 1) / kFiltRows)
        * ((O2 + kFiltCols - 1) / kFiltCols);
    return (int)std::max(1LL, std::min(2LL * sms / tiles, (long long)RM / 128));
}

// The filter split over `slices` slices of j (filter_slices), summed in
// slice order: part holds slices·rows·O2 floats (unused for one slice);
// y's rows placed as launch_filter places them.
inline cudaError_t launch_filter_split(const float* contrib,
                                       const float* wmat, float* y,
                                       float* part, int rows, int RM, int O2,
                                       int slices, cudaStream_t stream,
                                       int rpm = 0, int ys = 0)
{
    if (slices <= 1)
        return launch_filter(contrib, wmat, y, rows, RM, O2, stream, rpm,
                             ys);
    const int jlen = ((RM + slices - 1) / slices + kFiltDepth - 1)
        / kFiltDepth * kFiltDepth;
    slices = (RM + jlen - 1) / jlen;
    filter_kernel<<<dim3((rows + kFiltRows - 1) / kFiltRows,
                         (O2 + kFiltCols - 1) / kFiltCols, slices), 256, 0,
                    stream>>>(contrib, wmat, part, rows, RM, O2, jlen, rows,
                              0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long n = (long long)rows * O2;
    filter_combine<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        part, y, slices, n, O2, rpm > 0 ? rpm : rows, rpm > 0 ? ys : 0);
    return cudaGetLastError();
}

// Launches dc on `stream`: dc (rows, RM) = dy (rows, O2) · Wᵀ.
inline cudaError_t launch_dc(const float* dy, const float* wmat, float* dc,
                             int rows, int RM, int O2, cudaStream_t stream)
{
    bwd_dc_kernel<<<dim3((rows + kGemmTile - 1) / kGemmTile,
                         (RM + kGemmTile - 1) / kGemmTile), 256, 0,
                    stream>>>(dy, wmat, dc, rows, RM, O2);
    return cudaGetLastError();
}

}  // namespace panel
