// Compact ECHO forward (K7) for Hopper, sm_90a.
//
// Replaces the TPU kernel fieldconv_tpu/ops/pallas/echo_panel.py::
// _fwd_impl_compact (pallas_call at :310; body _fwd_kernel with the
// helpers _panel_tensors, _b_factors and _a_masks; the gathered copy of
// _compact_gather is not formed, see below).  Python wrapper and plain
// PyTorch version: fieldconv_tpu_torch/ops/echo_panel.py
// (echo_compact_grid, echo_compact_grid_reference).
//
// What it computes (float32, complex values planar; the stencil float32
// or bfloat16, each element read as f32, sten_load.cuh).  Inputs: source
// features x (rows, C, 2); the compact panel stencil sten (P, 5, TBt, TS)
// of a CompactPanelTable, planes r, e^{iθ} re/im, wxp re/im; meta (4, P)
// int32 rows (tgt, panel id, first, last), sorted by target; src_idx
// (P, TS) int32, the source row of each column.  K2's histogram
// (echo_panel_fwd.cu; the vote in echo_vote.cuh) over rectangular TBt × TS
// panels, where column s of panel p reads x at row src_idx[p, s].  Output
// grid (nb_out, 2w², C, TBt), each cell summed over the target block's run
// of panels.  The disk-map fold and soft_abs run in the op around the
// kernel.
//
// Design.  K2's forward, over the walk of echo_vote.cuh with GATHER: a CTA
// owns a tile of targets of one target block and all C channels; a warp
// per target row compacts the occupied slots (wxp ≠ 0; dead columns carry
// wxp = 0) once for all channels, reading each occupied slot's source row
// from src_idx there; per-thread cell accumulators live in shared memory
// laid out [cell][thread]; one writer per cell, a fixed order, no atomics,
// so two calls agree bitwise.  The thread reads x at that row directly:
// the JAX package's channel-major gathered copy (2C, P·TS) is never
// formed.  p is formed uncontracted and correctly rounded in the plain
// version's order, as in K2.  Panel shapes: TBt = 32 by TS = 128 on the
// pure-panel layout, 128 × 128 on the mixed route.
//
// What bounds it.  The function needs the r plane whole (the wxp planes,
// which say which slots are occupied, are counted with it) and the other
// planes only in the 32-byte sectors that hold an occupied slot, src_idx,
// the rows of x that live columns name, meta and the grid once; its
// operations are ~44 per (occupied slot, non-origin channel).
// chip_smoke.py::k7_bound counts both from the run's table.  The kernel's
// own cost, as K2's: 8 shared-memory read-modify-writes per (slot,
// channel), the per-panel compaction, and a dependent load of x per slot.
// It makes no use of tensor cores.

#include "echo_vote.cuh"

#include <algorithm>
#include <cstddef>

namespace {

template <typename ST>
__global__ void __launch_bounds__(echo::kMaxThreads)
echo_compact_fwd_kernel(const float2* __restrict__ x,
                        const ST* __restrict__ sten,
                        const int* __restrict__ meta,
                        const int* __restrict__ src_idx,
                        float* __restrict__ out,
                        int P, int C, int TBt, int TS, int n_bins, int T,
                        int rows)
{
    extern __shared__ __align__(16) float smem[];
    echo::grid_tile<true, ST>(x, sten, meta, src_idx, out, P, C, TBt, TS,
                              n_bins, T, rows, smem);
}

template <typename ST>
int launch(const float* x, const void* sten, const int* meta,
           const int* src_idx, float* out, int P, int nb_out, int C, int TBt,
           int TS, int n_bins, int rows, int T, int nthr, size_t smem,
           cudaStream_t stream)
{
    auto kernel = echo_compact_fwd_kernel<ST>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long grid = (long)nb_out * ((TBt + T - 1) / T);
    kernel<<<(unsigned)grid, nthr, smem, stream>>>(
        reinterpret_cast<const float2*>(x), static_cast<const ST*>(sten),
        meta, src_idx, out, P, C, TBt, TS, n_bins, T, rows);
    return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for sizes the kernel does not take (C > 256, no
// tile of targets whose accumulators fit in shared memory).  out:
// (nb_out, 2w², C, TBt); x: (rows, C, 2); sten float32, or bfloat16 when
// sten_bf16 is set.
extern "C" int echo_compact_fwd(const float* x, const void* sten,
                                const int* meta, const int* src_idx,
                                float* out, int P, int nb_out, int C,
                                int TBt, int TS, int n_bins, int rows,
                                int sten_bf16, void* stream)
{
    if (P < 1 || nb_out < 1 || C < 1 || C > echo::kMaxThreads || TBt < 1
        || TS < 1 || n_bins < 1 || rows < 1)
        return (int)cudaErrorInvalidValue;
    int dev = 0, limit = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    const int w = 2 * n_bins + 1;
    int T = std::min({echo::kMaxTargets, TBt,
                      std::max(1, echo::kMaxThreads / C)});
    while (T > 1 && echo::smem_bytes(w * w, echo::threads_for(T, C), T, TS)
                        > (size_t)limit)
        T /= 2;
    const int nthr = echo::threads_for(T, C);
    const size_t smem = echo::smem_bytes(w * w, nthr, T, TS);
    if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (sten_bf16)
        return launch<__nv_bfloat16>(x, sten, meta, src_idx, out, P, nb_out,
                                     C, TBt, TS, n_bins, rows, T, nthr, smem,
                                     s);
    return launch<float>(x, sten, meta, src_idx, out, P, nb_out, C, TBt, TS,
                         n_bins, rows, T, nthr, smem, s);
}
