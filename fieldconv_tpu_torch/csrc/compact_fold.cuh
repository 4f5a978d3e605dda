// The fold of a CompactPanelTable's per-column gradients onto vertices,
// shared by K6's backward (band_compact_bwd.cu), K7's backward
// (echo_compact_bwd.cu) and the compact lift's backward (compact_fold.cu).
//
// Replaces the XLA segment_sums of the JAX package's compact VJPs
// (fieldconv_tpu/ops/pallas/band_conv.py:2118, ops/pallas/echo_panel.py:378
// and ops/trans_field.py:408).  Python wrapper and plain PyTorch version:
// fieldconv_tpu_torch/ops/compact_fold.py.
//
// What it computes.  vals (P·TS, W) holds one row per compact column; the
// table's fold index lists the live columns (those holding an occupied
// slot) stably sorted by source row, fold_order (L,), and each vertex's
// run in it, fold_ptr (rows + 1,).  Then
//
//   out[v, m] = Σ_{i = fold_ptr[v]}^{fold_ptr[v + 1] − 1} vals[fold_order[i], m]
//
// summed in ascending column order, from 0: the order of the plain
// version's index_add over every column (a dead column's row is exact
// zeros, so leaving it out changes no value).  A vertex with no live
// column gets 0.
//
// Design.  One thread per (vertex, m), consecutive threads on consecutive
// m, so a warp reads whole rows of vals; each output has one writer and
// is written once: no atomics, and two calls agree bitwise.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace fold {
namespace {

__global__ void __launch_bounds__(256)
compact_fold_kernel(const float* __restrict__ vals,
                    const int* __restrict__ order,
                    const int* __restrict__ ptr, float* __restrict__ out,
                    int rows, int W)
{
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= (long long)rows * W) return;
    const int v = (int)(e / W), m = (int)(e % W);
    const int hi = __ldg(ptr + v + 1);
    float acc = 0.f;
    for (int i = __ldg(ptr + v); i < hi; ++i)
        acc += __ldg(vals + (size_t)__ldg(order + i) * W + m);
    out[e] = acc;
}

}  // namespace

// Launches the fold on `stream`: out (rows, W) from vals (·, W).
inline cudaError_t launch_fold(const float* vals, const int* order,
                               const int* ptr, float* out, int rows, int W,
                               cudaStream_t stream)
{
    const long long n = (long long)rows * W;
    compact_fold_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        vals, order, ptr, out, rows, W);
    return cudaGetLastError();
}

}  // namespace fold
