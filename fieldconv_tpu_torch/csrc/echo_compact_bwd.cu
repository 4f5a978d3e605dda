// Compact ECHO backward (K7 bwd) for Hopper, sm_90a.
//
// Replaces the TPU kernel fieldconv_tpu/ops/pallas/echo_panel.py::
// _bwd_impl_compact (pallas_call at :342, body _bwd_kernel_compact) and the
// segment_sum that folds its per-column gradients onto vertices in
// _echo_compact_grid's VJP (:378).  Python wrapper and plain PyTorch
// version: fieldconv_tpu_torch/ops/echo_panel.py (echo_compact_grid_bwd,
// echo_compact_grid_bwd_reference).
//
// What it computes (float32, complex values planar; the stencil float32
// or bfloat16, each element read as f32, sten_load.cuh).  Inputs: the
// cotangent dg of K7's grid, (nb_out, 2w², C, TBt), read through the four
// strides the caller passes; source features x (rows, C, 2); the compact
// stencil sten (P, 5, TBt, TS), meta (4, P) (tgt, panel id, first, last)
// and src_idx (P, TS) of a CompactPanelTable.  For each panel p of target
// block b = meta[0, p] and each column s, with x_s = x[src_idx[p, s]], the
// transpose of K7's vote over the column's occupied slots (t, s) (the
// per-slot terms of K2's backward, echo_vote.cuh::unvote_slot, reading
// dg[b, ·, c, t]) gives
//
//   dxg[p·TS + s, c] = (I − ûûᵀ)·du/|x_s| + dxv          (0 at the origin)
//
// and the fold sums the columns onto vertices:
//
//   dx[v] = Σ_{(p, s) : src_idx[p, s] = v} dxg[p·TS + s]
//
// Output dx (rows, C, 2); a row that no live column reads gets zeros.
//
// Design.  Per panel, like the JAX body: a CTA owns a group of S columns
// of one panel and all C channels, one thread per (column, channel); the
// thread reads x_s through src_idx (no gathered copy), keeps û and its
// four accumulators in registers, and writes its column of dxg once.  A
// warp per column compacts the column's occupied target slots (wxp ≠ 0)
// once for all channels (echo_vote.cuh::column_slots, as K2's backward
// does per source column); each thread walks the list and reads the 8
// values of dg it needs through L1/L2.  p is formed uncontracted and
// correctly rounded in the plain version's order ("Exact p",
// echo_vote.cuh).  Then the fold (compact_fold.cuh) sums the columns onto
// dx in ascending column order.  Every sum has one owner and a fixed
// order, no atomics: two calls agree bitwise.  Panels: TBt 32 × TS 128 on
// the pure-panel layout, 128 × 128 on the mixed route.  The per-column
// gradients dxg (P·TS·2C floats) live in a scratch buffer the caller owns.
//
// What bounds it.  Each (occupied slot, non-origin channel) pair costs ~80
// float operations and 8 dg reads; the function needs dg once, the
// stencil's r plane (with the wxp planes that say which slots are
// occupied) whole and its other planes where a slot is occupied, src_idx,
// the rows of x that live columns read, and dx written once
// (chip_smoke.py::k7_bwd_bound).  The kernel's own cost, as K2's: the
// scattered dg reads, the per-column compaction (strided loads of the wxp
// planes), and the dxg round trip of the fold.  It makes no use of tensor
// cores.

#include "compact_fold.cuh"
#include "echo_vote.cuh"

#include <algorithm>
#include <cstddef>

namespace {

constexpr int kMaxColumns = 32;

template <typename ST>
__global__ void __launch_bounds__(echo::kMaxThreads)
echo_compact_bwd_kernel(const float* __restrict__ dg, long long sb,
                        long long sq, long long sc, long long st,
                        const float2* __restrict__ x,
                        const ST* __restrict__ sten,
                        const int* __restrict__ meta,
                        const int* __restrict__ src_idx,
                        float2* __restrict__ dxg,
                        int P, int C, int TBt, int TS, int n_bins, int S,
                        int rows, int nb_out)
{
    const int groups = (TS + S - 1) / S;
    const int p = blockIdx.x / groups;
    const int s0 = (blockIdx.x % groups) * S;
    const int ns = min(S, TS - s0);
    const int tid = threadIdx.x;
    const int nthr = blockDim.x;             // a multiple of 32
    const bool active = tid < ns * C;
    const int is = tid / C, ic = tid % C;    // (column, channel) of a thread

    extern __shared__ __align__(16) float smem[];
    float4* slots = reinterpret_cast<float4*>(smem);         // [S][TBt]
    int* tidx = reinterpret_cast<int*>(slots + S * TBt);     // [S][TBt]
    int* cnt = tidx + S * TBt;                               // [S]

    const int tgt = __ldg(meta + p);
    float xre = 0.f, xim = 0.f;
    if (active && tgt >= 0 && tgt < nb_out) {
        const int v = __ldg(src_idx + (size_t)p * TS + s0 + is);
        if ((unsigned)v < (unsigned)rows) {
            const float2 xv = __ldg(x + (size_t)v * C + ic);
            xre = xv.x;
            xim = xv.y;
        }
    }
    float inv_r, uR, uI;
    // (an inactive thread, a row outside x and a target block outside the
    // grid hold x = 0, at the origin: they take no gradient)
    const bool nz = echo::unit_of(xre, xim, inv_r, uR, uI);

    const size_t plane = (size_t)TBt * TS;
    const ST* sp = sten + (size_t)p * 5 * plane;
    const int warp = tid >> 5, lane = tid & 31, nwarps = nthr >> 5;
    for (int s = warp; s < ns; s += nwarps) {
        const int n = echo::column_slots(slots + s * TBt, tidx + s * TBt, sp,
                                         s0 + s, TBt, TS, plane);
        if (lane == 0) cnt[s] = n;
    }
    __syncthreads();
    if (!active) return;
    float du_re = 0.f, du_im = 0.f, dxv_re = 0.f, dxv_im = 0.f;
    if (nz) {
        const int n = cnt[is];
        const float4* sl = slots + is * TBt;
        const int* ti = tidx + is * TBt;
        const float* g = dg + (long long)tgt * sb + (long long)ic * sc;
        for (int j = 0; j < n; ++j)
            echo::unvote_slot(du_re, du_im, dxv_re, dxv_im,
                              g + (long long)ti[j] * st, sq, sl[j], xre, xim,
                              uR, uI, n_bins);
    }
    dxg[((size_t)p * TS + s0 + is) * C + ic] =
        echo::unit_grad(nz, du_re, du_im, dxv_re, dxv_im, uR, uI, inv_r);
}

size_t smem_bytes(int S, int TBt)
{
    return (size_t)S * TBt * (sizeof(float4) + sizeof(int))
           + (size_t)S * sizeof(int);
}

template <typename ST>
int launch(const float* dg, long long sb, long long sq, long long sc,
           long long st, const float* x, const void* sten, const int* meta,
           const int* src_idx, float* dxg, int P, int C, int TBt, int TS,
           int n_bins, int S, int rows, int nb_out, size_t smem,
           cudaStream_t stream)
{
    auto kernel = echo_compact_bwd_kernel<ST>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int nthr = echo::threads_for(S, C);
    const long grid = (long)P * ((TS + S - 1) / S);
    kernel<<<(unsigned)grid, nthr, smem, stream>>>(
        dg, sb, sq, sc, st, reinterpret_cast<const float2*>(x),
        static_cast<const ST*>(sten), meta, src_idx,
        reinterpret_cast<float2*>(dxg), P, C, TBt, TS, n_bins, S, rows,
        nb_out);
    return (int)cudaGetLastError();
}

}  // namespace

// Floats of the per-column gradients echo_compact_bwd keeps in its scratch.
extern "C" long long echo_compact_bwd_scratch_floats(int P, int C, int TS)
{
    return (long long)P * TS * 2 * C;
}

// Launches the kernel and the fold on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for sizes it
// does not take (C > 256, no group of columns whose slot lists fit in
// shared memory).  dg is read as dg[b·sb + q·sq + c·sc + t·st] (strides in
// elements); x, dx: (rows, C, 2); fold_order and fold_ptr (rows + 1) the
// table's fold index; scratch holds echo_compact_bwd_scratch_floats
// floats, owned by the caller; sten float32, or bfloat16 when sten_bf16
// is set.
extern "C" int echo_compact_bwd(const float* dg, long long sb, long long sq,
                                long long sc, long long st, const float* x,
                                const void* sten, const int* meta,
                                const int* src_idx, const int* fold_order,
                                const int* fold_ptr, float* dx,
                                float* scratch, int P, int nb_out, int C,
                                int TBt, int TS, int n_bins, int rows,
                                int sten_bf16, void* stream)
{
    if (P < 1 || nb_out < 1 || C < 1 || C > echo::kMaxThreads || TBt < 1
        || TS < 1 || n_bins < 1 || rows < 1 || sb < 0 || sq < 0 || sc < 0
        || st < 0)
        return (int)cudaErrorInvalidValue;
    int dev = 0, limit = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    int S = std::min({kMaxColumns, TS, std::max(1, echo::kMaxThreads / C)});
    while (S > 1 && smem_bytes(S, TBt) > (size_t)limit) S /= 2;
    const size_t smem = smem_bytes(S, TBt);
    if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    err = (cudaError_t)(sten_bf16
        ? launch<__nv_bfloat16>(dg, sb, sq, sc, st, x, sten, meta, src_idx,
                                scratch, P, C, TBt, TS, n_bins, S, rows,
                                nb_out, smem, s)
        : launch<float>(dg, sb, sq, sc, st, x, sten, meta, src_idx, scratch,
                        P, C, TBt, TS, n_bins, S, rows, nb_out, smem, s));
    if (err != cudaSuccess) return (int)err;
    return (int)fold::launch_fold(scratch, fold_order, fold_ptr, dx, rows,
                                  2 * C, s);
}
