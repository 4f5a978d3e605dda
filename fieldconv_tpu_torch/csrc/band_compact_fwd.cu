// Compact field-conv forward (K6) for Hopper, sm_90a.
//
// Replaces the TPU kernel fieldconv_tpu/ops/pallas/band_conv.py::
// _band_compact_fwd_impl (pallas_call at :2042, body _fwd_compact_kernel
// with _panel_accum_rect and _apply_w; the row gather g[src_idx] of
// _band_compact is done in place, see below).  Python wrapper and plain
// PyTorch version: fieldconv_tpu_torch/ops/band_conv.py (band_compact_fwd,
// band_compact_fwd_reference).
//
// What it computes (float32, complex values planar; the stencil float32
// or bfloat16, each element read as f32, sten_load.cuh).  Inputs: the
// k-major rotated-source tensor g (n_g, M = K·2C); W = filters_to_wmat
// (R, M, O2), 1/K inside; the compact panel stencil sten (P, 5, TBt, TS),
// rows the target slot t, columns the compact column s, planes r, e^{iθ}
// re/im, wxp re/im (r = R_SENTINEL at empty slots and dead columns); meta
// (4, P) int32 rows (tgt, panel id, first, last), sorted by target; src_idx
// (P, TS) int32, the source row of each column.  For every panel p of
// target block b, slot (t, s), ring r, k and channel c, with v =
// src_idx[p, s]:
//
//   contrib[b, r, t, k, c] += hats_r(t, s) · (f_k(t, s) ⊗ g[v, k, c])
//   y[b·TBt + t, o] = Σ_r Σ_j contrib[b, r, t, j] · W[r, j, o]
//
// This is K5's forward (band_panel_fwd.cu) with two differences: panels are
// rectangular (TBt = 32 rows by TS = 128 columns on the pure-panel layout,
// 128 × 128 on the mixed route), and a column's source row comes from
// src_idx instead of src·TB + s.
//
// Design.  K5's forward, over the generalised walk of panel_walk.cuh
// (GATHER): a CTA owns a tile of T = min(8, 256 / C) targets of one target
// block and walks that block's contiguous run of panels (bounds by binary
// search in meta's tgt row); one thread per (target, channel) keeps its
// K·R complex sums in registers; per panel one warp per target row
// compacts the row's occupied slots (any radial hat nonzero; dead columns
// have r = R_SENTINEL and are skipped exactly) into shared memory, once
// for all channels, with each slot's source row read from src_idx there
// (only for occupied slots).  The thread then reads its channel of that
// row of g directly: the JAX package's gathered copy gg (P·TS, M; ~1.2 GB
// at 163,842 samples and M = 192) is never formed.  W is applied from
// shared memory at the end (panel::filter_tile).  One writer per output
// and a fixed order for every sum: two calls agree bitwise, no atomics.
// Hats and phasor powers are formed uncontracted and correctly rounded in
// the plain version's order.  A slot whose source row lies outside [0,
// n_g) adds nothing.
//
// What bounds it.  The function needs the r plane whole and the other
// planes only in the 32-byte sectors that hold an occupied slot, src_idx,
// the rows of g that live columns name, W, meta and y once; its operations
// are the occupied-slot work and the filter contraction.  chip_smoke.py::
// k6_bound counts both from the run's table.  The compact table is ~5x
// denser than the block-panel one at 163,842 samples, so the r plane to
// scan shrinks ~6x; the price is a dependent load of src_idx per occupied
// slot during compaction (L1), and the gather of g per slot stays (one L2
// round trip per slot and thread, as in K5).  It makes no use of tensor
// cores.

#include "panel_walk.cuh"

#include <algorithm>
#include <cstddef>

namespace {

using panel::kMaxThreads;
using panel::kTile;
using panel::Knots;

// MINB as in K5's forward: its two instantiations, K = 3, R = 3
// (correspondence) and K = 5, R = 6 (segmentation, classification).
template <int KMAX, int RMAX, int MINB, typename ST>
__global__ void __launch_bounds__(kMaxThreads, MINB)
band_compact_fwd_kernel(const float* __restrict__ g,
                        const float* __restrict__ wmat,
                        const ST* __restrict__ sten,
                        const int* __restrict__ meta,
                        const int* __restrict__ src_idx,
                        float* __restrict__ y,
                        int P, int C, int K, int R, int TBt, int TS, int O2,
                        int nb_g, int T, Knots kn)
{
    const int tiles = (TBt + T - 1) / T;
    const int blk = blockIdx.x / tiles;
    const int t0 = (blockIdx.x % tiles) * T;
    const int nt = min(T, TBt - t0);
    const int tid = threadIdx.x;
    const bool active = tid < nt * C;
    const int it = active ? tid / C : 0;     // (target, channel) of a thread
    const int ic = active ? tid % C : 0;

    extern __shared__ __align__(16) float smem[];
    float are[KMAX][RMAX], aim[KMAX][RMAX];
    panel::panel_contrib<KMAX, RMAX, true, ST>(
        are, aim, smem, g, sten, meta, P, C, K, R, TBt, 1, nb_g, T, blk, t0,
        nt, active, it, ic, kn, src_idx, TS);
    panel::filter_tile<KMAX, RMAX>(are, aim, smem, wmat, y, blk, TBt, t0, C,
                                   K, R, O2, T, nt, active, it, ic);
}

template <int KMAX, int RMAX, int MINB, typename ST>
int launch(const float* g, const float* wmat, const ST* sten,
           const int* meta, const int* src_idx, float* y, int P, int nb_out,
           int C, int K, int R, int TBt, int TS, int O2, int nb_g, int T,
           int nthr, size_t smem, const Knots& kn, cudaStream_t stream)
{
    auto kernel = band_compact_fwd_kernel<KMAX, RMAX, MINB, ST>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long grid = (long)nb_out * ((TBt + T - 1) / T);
    kernel<<<(unsigned)grid, nthr, smem, stream>>>(
        g, wmat, sten, meta, src_idx, y, P, C, K, R, TBt, TS, O2, nb_g, T,
        kn);
    return (int)cudaGetLastError();
}

// The instantiation for (K, R): K ≤ 3 with R ≤ 3, or K = 5 with R ≤ 6.
template <typename ST>
int launch_for(const float* g, const float* wmat, const void* sten,
               const int* meta, const int* src_idx, float* y, int P,
               int nb_out, int C, int K, int R, int TBt, int TS, int O2,
               int nb_g, int T, int nthr, size_t smem, const Knots& kn,
               cudaStream_t s)
{
    const ST* st = static_cast<const ST*>(sten);
    if (K <= 3)
        return launch<3, 3, 5>(g, wmat, st, meta, src_idx, y, P, nb_out, C,
                               K, R, TBt, TS, O2, nb_g, T, nthr, smem, kn, s);
    return launch<5, 6, 2>(g, wmat, st, meta, src_idx, y, P, nb_out, C, K, R,
                           TBt, TS, O2, nb_g, T, nthr, smem, kn, s);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for shapes the kernel does not take (K even or
// > 5; R > 3 with K ≤ 3, or R > 6 with K = 5: the presets' shapes are
// K = 3, R = 3 and K = 5, R = 6; R < 2; C > 256; n_g not a multiple of
// TBt; lists or the filter stage above the shared memory a CTA can have).
// y: (nb_out·TBt, O2); g: (n_g, M); sten float32, or bfloat16 when
// sten_bf16 is set.
extern "C" int band_compact_fwd(const float* g, const float* wmat,
                                const void* sten, const int* meta,
                                const int* src_idx, float* y, int P,
                                int nb_out, int C, int K, int R, int TBt,
                                int TS, int O2, int n_g, int sten_bf16,
                                void* stream)
{
    if (P < 1 || nb_out < 1 || C < 1 || C > kMaxThreads || K < 1
        || K % 2 == 0 || K > 5 || R < 2 || R > (K <= 3 ? 3 : 6) || TBt < 1
        || TS < 1 || O2 < 1 || n_g < TBt || n_g % TBt)
        return (int)cudaErrorInvalidValue;
    int dev = 0, limit = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    const int T = std::min(kTile, std::max(1, kMaxThreads / C));
    const int nthr = panel::threads_for(T, C);
    const size_t smem = panel::fwd_smem_bytes(C, K, R, TS, O2, T, nthr);
    if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
    const Knots kn = panel::ring_knots(R);
    const int nb_g = n_g / TBt;
    cudaStream_t s = (cudaStream_t)stream;
    if (sten_bf16)
        return launch_for<__nv_bfloat16>(g, wmat, sten, meta, src_idx, y, P,
                                         nb_out, C, K, R, TBt, TS, O2, nb_g,
                                         T, nthr, smem, kn, s);
    return launch_for<float>(g, wmat, sten, meta, src_idx, y, P, nb_out, C, K,
                             R, TBt, TS, O2, nb_g, T, nthr, smem, kn, s);
}
