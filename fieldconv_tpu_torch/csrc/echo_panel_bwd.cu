// Panel ECHO backward (K2 bwd) for Hopper, sm_90a.
//
// Replaces the TPU kernel fieldconv_tpu/ops/pallas/echo_panel.py::_bwd_impl
// (pallas_call at :443; body _bwd_kernel).  Python wrapper and plain
// PyTorch version: fieldconv_tpu_torch/ops/echo_panel.py
// (echo_panel_grid_bwd, echo_panel_grid_bwd_reference).
//
// What it computes (float32, complex values planar; the stencil float32
// or bfloat16, each element read as f32, sten_load.cuh).  Inputs: the
// cotangent dg of the forward's grid, (nb_out, 2w², C, TB), read through
// the four strides the caller passes; source features x (rows, C, 2); the
// compressed panel stencil sten (P, 5, TB, TB) (planes r, e^{iθ} re/im,
// wxp re/im, target-major [t][s]); meta_s (4, P_s) int32 rows (pid, tgt,
// src, flags), the panels sorted by source block.  Output dx (rows, C, 2).
// For every occupied slot (t, s) of every panel and every channel c, with
// x_s = x[src·TB + s, c] not at the origin, p, the clipped floor/ceil
// corners and the weights w0..w3 are recomputed as csrc/echo_panel_fwd.cu
// forms them, G_k = dg[tgt, cell_k, c, t] (re and im), and
//
//   dv   = Σ_k w_k·G_k                          the vote's cotangent
//   dW_k = v_re·G_k,re + v_im·G_k,im            v = x_s·wxp
//   dp1  = −dW0·e2C + dW1·e2F + dW2·e2C − dW3·e2F   (e1C = pC1 − p1, ...)
//   dp2  = −dW0·e1C + dW1·e1F − dW2·e1F + dW3·e1C
//   du  += n_bins·(dp1·ln_re + dp2·ln_im, dp1·ln_im − dp2·ln_re)
//   dxv += conj(wxp)·dv
//
// and finally dx_s = (I − ûûᵀ)·du/|x_s| + dxv: u = x/|x| is linear in du,
// so its Jacobian is applied once per source.  Cell masks and corners have
// zero gradient; a source at the origin gets dx = 0, and so does a source
// block with no panel in meta_s (the TPU kernel leaves such blocks
// unwritten; its graph-parallel caller masks them).
//
// Design.  One CTA owns a tile of S sources of one source block (the block
// index is global over a batch of meshes: concat_panel_tables offsets each
// mesh by m·nb) and all C channels, one thread per (source, channel).  It
// walks the block's contiguous run of panels in meta_s (bounds by binary
// search on the src row); row 0 indexes the stencil, row 1 names the
// target block whose dg is read.  Everything a source needs beyond the
// panel's slots (x_s, 1/|x_s|, û) sits in registers, and so do its four
// accumulators (du re/im, dxv re/im) for the whole run: each dx value has
// exactly one writer and is written once, no atomics, and two calls agree
// bitwise.  Per panel, one warp per source column compacts the column's
// occupied slots (wxp ≠ 0; about two thirds of the slots are empty, and an
// empty slot contributes exactly 0) into shared memory, in target order,
// as (ln_re, ln_im, wxp_re, wxp_im, t); the column is read with a stride of
// TB, 32 rows per ballot.  Each thread then loops over its column's list
// and reads the 8 values of dg it needs through L1/L2: one target block's
// dg (2w²·C·TB floats, 2.4 MB at n_bins 3, C = 48) is far larger than
// shared memory.  With the strides autograd hands over (cells minor, the
// fold's layout) the 4 corners' cells of one (t, c) lie within a few
// sectors.
//
// Exact p.  As in the forward, p is formed with uncontracted, correctly
// rounded operations in the plain version's order, so kernel, forward and
// plain version pick the same corners (and thus read the same dg cells)
// where p lands on an integer.  Everything after p is continuous in p.
//
// What bounds it.  Each (occupied slot, non-origin channel) pair costs ~80
// float operations and 8 scattered dg reads; dg is read once (154 MB at the
// segmentation shape), the stencil once (60 MB), x and dx once:
// chip_smoke.py::k2_bwd_bound counts both from the run's own panels and
// features, the stencil as k2_bound does (bound by bytes at both ECHO
// shapes).  The kernel's own cost is
// the scattered dg reads (a sector per 4 useful bytes at worst) and the
// per-panel compaction; it makes no use of tensor cores.

#include "echo_vote.cuh"

#include <algorithm>
#include <cstddef>

namespace {

constexpr int kMaxThreads = echo::kMaxThreads;
constexpr int kMaxSources = 32;

template <typename ST>
__global__ void __launch_bounds__(kMaxThreads)
echo_panel_bwd_kernel(const float* __restrict__ dg, long long sb,
                      long long sq, long long sc, long long st,
                      const float2* __restrict__ x,
                      const ST* __restrict__ sten,
                      const int* __restrict__ meta_s,
                      float2* __restrict__ dx,
                      int Ps, int C, int TB, int n_bins, int S)
{
    const int tiles = (TB + S - 1) / S;
    const int blk = blockIdx.x / tiles;      // source block
    const int s0 = (blockIdx.x % tiles) * S;
    const int ns = min(S, TB - s0);
    const int tid = threadIdx.x;
    const int nthr = blockDim.x;             // a multiple of 32
    const bool active = tid < ns * C;
    const int is = tid / C, ic = tid % C;    // (source, channel) of a thread

    extern __shared__ __align__(16) float smem[];
    float4* slots = reinterpret_cast<float4*>(smem);         // [S][TB]
    int* tidx = reinterpret_cast<int*>(slots + S * TB);      // [S][TB]
    int* cnt = tidx + S * TB;                                // [S]

    const size_t xi = ((size_t)blk * TB + s0 + is) * C + ic;
    float xre = 0.f, xim = 0.f;
    if (active) {
        const float2 xv = __ldg(x + xi);
        xre = xv.x;
        xim = xv.y;
    }
    float inv_r, uR, uI;
    // (an inactive thread holds x = 0, at the origin)
    const bool nz = echo::unit_of(xre, xim, inv_r, uR, uI);
    float du_re = 0.f, du_im = 0.f, dxv_re = 0.f, dxv_im = 0.f;

    const int p_lo = echo::lower_bound(meta_s + 2 * (size_t)Ps, Ps, blk);
    const int p_hi = echo::lower_bound(meta_s + 2 * (size_t)Ps, Ps, blk + 1);
    const size_t plane = (size_t)TB * TB;
    const int warp = tid >> 5, lane = tid & 31, nwarps = nthr >> 5;

    for (int p = p_lo; p < p_hi; ++p) {
        const int pid = __ldg(meta_s + p);
        const int tgt = __ldg(meta_s + Ps + p);
        const ST* sp = sten + (size_t)pid * 5 * plane + s0;
        __syncthreads();                     // the last panel's lists are read
        // compact each source column's occupied slots, one warp per column
        for (int s = warp; s < ns; s += nwarps) {
            const int base = echo::column_slots(slots + s * TB, tidx + s * TB,
                                                sp, s, TB, TB, plane);
            if (lane == 0) cnt[s] = base;
        }
        __syncthreads();
        if (!nz) continue;
        const int n = cnt[is];
        const float4* sl = slots + is * TB;
        const int* ti = tidx + is * TB;
        const float* g = dg + (long long)tgt * sb + (long long)ic * sc;
        for (int j = 0; j < n; ++j) {
            const float4 e = sl[j];
            const float* gt = g + (long long)ti[j] * st;
            echo::unvote_slot(du_re, du_im, dxv_re, dxv_im, gt, sq, e, xre,
                              xim, uR, uI, n_bins);
        }
    }
    if (!active) return;
    dx[xi] = echo::unit_grad(nz, du_re, du_im, dxv_re, dxv_im, uR, uI,
                             inv_r);
}

size_t smem_bytes(int S, int TB)
{
    return (size_t)S * TB * (sizeof(float4) + sizeof(int))
           + (size_t)S * sizeof(int);
}

template <typename ST>
int launch(const float* dg, long long sb, long long sq, long long sc,
           long long st, const float* x, const void* sten, const int* meta_s,
           float* dx, int Ps, int nb, int C, int TB, int n_bins, int S,
           size_t smem, cudaStream_t stream)
{
    auto kernel = echo_panel_bwd_kernel<ST>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int nthr = (S * C + 31) / 32 * 32;
    const long grid = (long)nb * ((TB + S - 1) / S);
    kernel<<<(unsigned)grid, nthr, smem, stream>>>(
        dg, sb, sq, sc, st, reinterpret_cast<const float2*>(x),
        static_cast<const ST*>(sten), meta_s, reinterpret_cast<float2*>(dx),
        Ps, C, TB, n_bins, S);
    return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for sizes the kernel does not take (C > 256, no
// tile of sources whose slot lists fit in shared memory).  dg is read as
// dg[b·sb + q·sq + c·sc + t·st] (strides in elements); sten float32, or
// bfloat16 when sten_bf16 is set.
extern "C" int echo_panel_bwd(const float* dg, long long sb, long long sq,
                              long long sc, long long st, const float* x,
                              const void* sten, const int* meta_s,
                              float* dx, int Ps, int nb, int C, int TB,
                              int n_bins, int sten_bf16, void* stream)
{
    if (Ps < 1 || nb < 1 || C < 1 || C > kMaxThreads || TB < 1 || n_bins < 1
        || sb < 0 || sq < 0 || sc < 0 || st < 0)
        return (int)cudaErrorInvalidValue;
    int dev = 0, limit = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    int S = std::min({kMaxSources, TB, std::max(1, kMaxThreads / C)});
    while (S > 1 && smem_bytes(S, TB) > (size_t)limit) S /= 2;
    const size_t smem = smem_bytes(S, TB);
    if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (sten_bf16)
        return launch<__nv_bfloat16>(dg, sb, sq, sc, st, x, sten, meta_s, dx,
                                     Ps, nb, C, TB, n_bins, S, smem, s);
    return launch<float>(dg, sb, sq, sc, st, x, sten, meta_s, dx, Ps, nb, C,
                         TB, n_bins, S, smem, s);
}
