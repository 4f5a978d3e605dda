// Panel ECHO forward (K2) for Hopper, sm_90a.
//
// Replaces the TPU kernel fieldconv_tpu/ops/pallas/echo_panel.py::_fwd_impl
// (pallas_call at :408; body _fwd_kernel with the helpers _panel_tensors,
// _b_factors and _a_masks).  Python wrapper and plain PyTorch version:
// fieldconv_tpu_torch/ops/echo_panel.py.
//
// What it computes (all float32, complex values planar).  Inputs: source
// features x (rows, C, 2); the compressed panel stencil sten (P, 5, TB, TB)
// with planes r, e^{iθ} re/im, wxp re/im; meta (4, P) int32 rows (tgt, src,
// first, last), sorted by target.  For every slot (t, s) of every panel and
// every channel c, with x_s = x[src·TB + s, c]:
//
//   skip when |Re x_s| < EPS and |Im x_s| < EPS        (origin feature)
//   u  = conj(x_s / |x_s|),  ln = r·e^{iθ}
//   p1 = n_bins·(ln_re·u_re + ln_im·u_im),  p2 = n_bins·(ln_im·u_re − ln_re·u_im)
//   pF, pC = floor, ceil of p, clipped to ±n_bins
//   w0 = (pC1−p1)(pC2−p2)  at cell (pF1, pF2)     w1 = (p1−pF1)(p2−pF2) at (pC1, pC2)
//   w2 = (p1−pF1)(pC2−p2)  at (pC1, pF2)           w3 = (pC1−p1)(p2−pF2) at (pF1, pC2)
//   v  = x_s · wxp                                   (complex product)
//
// and adds w_i·v into cell (a, b) = corner + n_bins of target t's w×w grid
// (w = 2·n_bins + 1), real part and imaginary part.  Output grid
// (nb_out, 2w², C, TB): row q = a·w + b holds the real parts, row w² + q
// the imaginary ones, each summed over the target block's run of panels.
// A target block without panels gets zeros.  The disk-map fold and soft_abs
// run in the op around the kernel.
//
// Design.  The TPU kernel builds all w² cells of every (target, source,
// channel) with masks (49 dense passes at n_bins = 3), which suits 128-lane
// vectors.  Here each (edge, channel) touches exactly its 4 cells.  One CTA
// owns a tile of T targets of one target block and all C channels, one
// thread per (target, channel); it walks that block's contiguous run of
// panels in meta order (its bounds found by binary search in meta's tgt
// row), so each output cell has exactly one writer and no atomics: two
// calls agree bitwise.  Per panel, one warp per target compacts the row's
// occupied slots (wxp ≠ 0; about two thirds of a panel's slots are empty
// and carry wxp = 0, so their votes are exactly 0 and skipping them is
// exact) into shared memory as (ln_re, ln_im, wxp_re, wxp_im, s), once for
// all channels.  Each thread then loops over its target's list, reads x_s
// (its channel, 8 bytes, through L1), and splats 4 re + 4 im products into
// its own 2w² accumulators.  Those sit in shared memory, not registers (98
// floats at n_bins = 3 would be indexed by data, which spills), laid out
// [cell][thread] with a stride of the block size, so the 32 lanes of a warp
// always hit 32 distinct banks.  The epilogue writes the tile's cells with
// consecutive threads on consecutive targets.
//
// Exact p.  The bilinear weights are continuous in p except where p lands
// exactly on an integer: there pF = pC and all four weights are 0, so the
// vote vanishes (the reference formula's own behaviour, kept).  An ulp of
// difference in p (FMA contraction, an approximate rsqrt) then moves a
// whole vote between the kernel and its plain version; over the ~45M
// (edge, channel) pairs of a segmentation batch a few such votes occur.
// So p is formed with uncontracted, correctly rounded operations in the
// plain version's order (1/sqrt(|x|²) for the TPU kernel's rsqrt), and the
// kernel and the plain version floor the same p on any device.
//
// What bounds it.  The stencil is read once (5 planes, ~0.33 MB per panel at
// TB = 128) and each (edge, channel) costs ~40 float operations: at the
// segmentation shape (4 meshes × 2048 samples, ~114 edges per target,
// C = 48) ~1.8 GFLOP against ~62 MB, bound by operations (~0.027 ms at
// 67 TFLOP/s); at the correspondence shape (5120 samples, C = 12) bound by
// the stencil's bytes (~0.012 ms).  chip_smoke.py::k2_bound counts both from
// the run's own panels, the planes beyond r only in the 32-byte sectors
// that hold an occupied slot (most of a panel at these shapes, a few
// percent on a large mesh).  The kernel's own cost is the 8 shared-memory
// read-modify-writes per (edge, channel) and the per-panel compaction; it
// makes no use of tensor cores.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

namespace {

constexpr float kEps = 1e-7f;   // utils/complexops.py::EPS
constexpr int kMaxThreads = 256;
constexpr int kMaxTargets = 16;

__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n,
                                           int v)
{
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(a + mid) < v) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

__global__ void __launch_bounds__(kMaxThreads)
echo_panel_fwd_kernel(const float2* __restrict__ x,
                      const float* __restrict__ sten,
                      const int* __restrict__ meta,
                      float* __restrict__ out,
                      int P, int C, int TB, int n_bins, int T)
{
    const int w = 2 * n_bins + 1;
    const int w2 = w * w;
    const float nbf = (float)n_bins;
    const int tiles = (TB + T - 1) / T;
    const int blk = blockIdx.x / tiles;
    const int t0 = (blockIdx.x % tiles) * T;
    const int nt = min(T, TB - t0);
    const int tid = threadIdx.x;
    const int nthr = blockDim.x;             // a multiple of 32
    const bool active = tid < nt * C;
    const int it = tid / C, ic = tid % C;    // (target, channel) of a thread

    extern __shared__ __align__(16) float smem[];
    float* acc = smem;                                       // [2w²][nthr]
    float4* slots = reinterpret_cast<float4*>(acc + 2 * w2 * nthr);  // [T][TB]
    int* sidx = reinterpret_cast<int*>(slots + T * TB);      // [T][TB]
    int* cnt = sidx + T * TB;                                // [T]

    for (int q = 0; q < 2 * w2; ++q) acc[q * nthr + tid] = 0.f;

    const int p_lo = lower_bound(meta, P, blk);
    const int p_hi = lower_bound(meta, P, blk + 1);
    const size_t plane = (size_t)TB * TB;
    const int warp = tid >> 5, lane = tid & 31, nwarps = nthr >> 5;

    for (int p = p_lo; p < p_hi; ++p) {
        const int sblk = __ldg(meta + P + p);
        const float* sp = sten + (size_t)p * 5 * plane;
        __syncthreads();                     // the last panel's lists are read
        // compact each target row's occupied slots, one warp per target
        for (int t = warp; t < nt; t += nwarps) {
            const size_t row = (size_t)(t0 + t) * TB;
            int base = 0;
            for (int s0 = 0; s0 < TB; s0 += 32) {
                const int s = s0 + lane;
                float wre = 0.f, wim = 0.f;
                if (s < TB) {
                    wre = __ldg(sp + 3 * plane + row + s);
                    wim = __ldg(sp + 4 * plane + row + s);
                }
                const bool occ = wre != 0.f || wim != 0.f;
                const unsigned m = __ballot_sync(0xffffffffu, occ);
                if (occ) {
                    const float r = __ldg(sp + row + s);
                    const float ln_re = r * __ldg(sp + plane + row + s);
                    const float ln_im = r * __ldg(sp + 2 * plane + row + s);
                    const int j = base + __popc(m & ((1u << lane) - 1u));
                    slots[t * TB + j] = make_float4(ln_re, ln_im, wre, wim);
                    sidx[t * TB + j] = s;
                }
                base += __popc(m);
            }
            if (lane == 0) cnt[t] = base;
        }
        __syncthreads();
        if (!active) continue;
        const int n = cnt[it];
        const float4* sl = slots + it * TB;
        const int* si = sidx + it * TB;
        const float2* xs = x + (size_t)sblk * TB * C + ic;
        float* a = acc + tid;
        for (int j = 0; j < n; ++j) {
            const float2 xv = __ldg(xs + (size_t)si[j] * C);
            if (!(fabsf(xv.x) >= kEps || fabsf(xv.y) >= kEps)) continue;
            const float4 e = sl[j];
            // p in exactly the plain version's rounding: no contraction,
            // correctly rounded sqrt and division (see the note above)
            const float r2 = __fadd_rn(__fmul_rn(xv.x, xv.x),
                                       __fmul_rn(xv.y, xv.y));
            const float inv_r = __fdiv_rn(1.f, __fsqrt_rn(r2));
            const float uR = __fmul_rn(xv.x, inv_r);
            const float uI = __fmul_rn(xv.y, inv_r);
            const float p1 = __fmul_rn(
                nbf, __fadd_rn(__fmul_rn(e.x, uR), __fmul_rn(e.y, uI)));
            const float p2 = __fmul_rn(
                nbf, __fadd_rn(__fmul_rn(-e.x, uI), __fmul_rn(e.y, uR)));
            const float pC1 = fminf(fmaxf(ceilf(p1), -nbf), nbf);
            const float pF1 = fminf(fmaxf(floorf(p1), -nbf), nbf);
            const float pC2 = fminf(fmaxf(ceilf(p2), -nbf), nbf);
            const float pF2 = fminf(fmaxf(floorf(p2), -nbf), nbf);
            const float w0 = (pC1 - p1) * (pC2 - p2);
            const float w1 = (p1 - pF1) * (p2 - pF2);
            const float w2_ = (p1 - pF1) * (pC2 - p2);
            const float w3 = (pC1 - p1) * (p2 - pF2);
            const float vre = xv.x * e.z - xv.y * e.w;
            const float vim = xv.x * e.w + xv.y * e.z;
            const int aF = (int)pF1 + n_bins, aC = (int)pC1 + n_bins;
            const int bF = (int)pF2 + n_bins, bC = (int)pC2 + n_bins;
            const int q[4] = {aF * w + bF, aC * w + bC, aC * w + bF,
                              aF * w + bC};
            const float wt[4] = {w0, w1, w2_, w3};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                a[q[k] * nthr] += wt[k] * vre;
                a[(w2 + q[k]) * nthr] += wt[k] * vim;
            }
        }
    }
    __syncthreads();
    // out[blk, q, c, t0 + t], consecutive threads on consecutive targets
    const int cells = 2 * w2 * C * nt;
    for (int u = tid; u < cells; u += nthr) {
        const int t = u % nt;
        const int c = (u / nt) % C;
        const int q = u / (nt * C);
        out[(((size_t)blk * 2 * w2 + q) * C + c) * TB + t0 + t] =
            acc[q * nthr + t * C + c];
    }
}

size_t smem_bytes(int w2, int nthr, int T, int TB)
{
    return (size_t)2 * w2 * nthr * sizeof(float)
           + (size_t)T * TB * (sizeof(float4) + sizeof(int))
           + (size_t)T * sizeof(int);
}

int threads_for(int T, int C)
{
    return (T * C + 31) / 32 * 32;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for sizes the kernel does not take (C > 256, no
// tile of targets whose accumulators fit in shared memory).
extern "C" int echo_panel_fwd(const float* x, const float* sten,
                              const int* meta, float* out, int P, int nb_out,
                              int C, int TB, int n_bins, void* stream)
{
    if (P < 1 || nb_out < 1 || C < 1 || C > kMaxThreads || TB < 1
        || n_bins < 1)
        return (int)cudaErrorInvalidValue;
    int dev = 0, limit = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    const int w = 2 * n_bins + 1;
    int T = std::min({kMaxTargets, TB, std::max(1, kMaxThreads / C)});
    while (T > 1 && smem_bytes(w * w, threads_for(T, C), T, TB)
                        > (size_t)limit)
        T /= 2;
    const int nthr = threads_for(T, C);
    const size_t smem = smem_bytes(w * w, nthr, T, TB);
    if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(echo_panel_fwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long grid = (long)nb_out * ((TB + T - 1) / T);
    echo_panel_fwd_kernel<<<(unsigned)grid, nthr, smem,
                            (cudaStream_t)stream>>>(
        reinterpret_cast<const float2*>(x), sten, meta, out, P, C, TB,
        n_bins, T);
    return (int)cudaGetLastError();
}
