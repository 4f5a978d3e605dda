// The ECHO histogram walk shared by K2's forward (echo_panel_fwd.cu) and
// K7's forward (echo_compact_fwd.cu): the per-slot vote of a source feature
// into a target's w×w grid, and a CTA's walk over its target block's run
// of panels; and the vote's transpose, shared by K2's backward
// (echo_panel_bwd.cu) and K7's (echo_compact_bwd.cu).
//
// A panel stencil (P, 5, TB, TS) holds rows the target slot t and columns
// the source slot s, planes r, e^{iθ} re/im, wxp re/im.  K2's panels are
// square (TS = TB) and column s of a panel whose source block is b reads
// x's row b·TB + s; K7's compact panels (GATHER) are TB × TS and column s
// of panel p reads x's row src_idx[p·TS + s].  For every slot and channel
// c, with x_s = x[row, c]:
//
//   skip when |Re x_s| < EPS and |Im x_s| < EPS        (origin feature)
//   u  = conj(x_s / |x_s|),  ln = r·e^{iθ}
//   p1 = n_bins·(ln_re·u_re + ln_im·u_im),  p2 = n_bins·(ln_im·u_re − ln_re·u_im)
//   pF, pC = floor, ceil of p, clipped to ±n_bins
//   w0 = (pC1−p1)(pC2−p2)  at cell (pF1, pF2)     w1 = (p1−pF1)(p2−pF2) at (pC1, pC2)
//   w2 = (p1−pF1)(pC2−p2)  at (pC1, pF2)           w3 = (pC1−p1)(p2−pF2) at (pF1, pC2)
//   v  = x_s · wxp                                   (complex product)
//
// and w_i·v is added into cell (a, b) = corner + n_bins of target t's grid
// (w = 2·n_bins + 1), real part and imaginary part.  The stencil is f32 or
// bf16 (ST), each element read as f32 (sten_load.cuh), so that p is formed
// from the same f32 values as in the plain version, which casts each chunk
// of panels to f32 before it forms p.
//
// Exact p.  The bilinear weights are continuous in p except where p lands
// exactly on an integer: there pF = pC and all four weights are 0, so the
// vote vanishes (the reference formula's own behaviour, kept).  An ulp of
// difference in p (FMA contraction, an approximate rsqrt) then moves a
// whole vote between the kernel and its plain version.  So p is formed
// with uncontracted, correctly rounded operations in the plain version's
// order (1/sqrt(|x|²) for the TPU kernel's rsqrt), and the kernels and
// the plain versions floor the same p on any device.

#pragma once

#include "sten_load.cuh"

#include <cuda_runtime.h>

#include <cstddef>

namespace echo {

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

// The vote of source feature xv at an occupied slot e = (ln_re, ln_im,
// wxp_re, wxp_im): its four weighted complex products added into the
// thread's accumulators a[q·nthr] (real part of cell q) and a[(w² + q)·nthr]
// (imaginary part).  Origin features cast none.
__device__ __forceinline__ void splat_vote(float* a, int nthr, float2 xv,
                                           float4 e, int n_bins)
{
    if (!(fabsf(xv.x) >= kEps || fabsf(xv.y) >= kEps)) return;
    const int w = 2 * n_bins + 1;
    const int w2 = w * w;
    const float nbf = (float)n_bins;
    // p in exactly the plain version's rounding: no contraction, correctly
    // rounded sqrt and division (see "Exact p" above)
    const float r2 = __fadd_rn(__fmul_rn(xv.x, xv.x), __fmul_rn(xv.y, xv.y));
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
    const int q[4] = {aF * w + bF, aC * w + bC, aC * w + bF, aF * w + bC};
    const float wt[4] = {w0, w1, w2_, w3};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        a[q[k] * nthr] += wt[k] * vre;
        a[(w2 + q[k]) * nthr] += wt[k] * vim;
    }
}

// Compacts the occupied slots (wxp ≠ 0) of column s of a panel's planes sp
// (plane floats apart, rows `stride` floats apart) over its n_t target
// rows into a list, in target order, as (ln_re, ln_im, wxp_re, wxp_im) and
// the target row; 32 rows per ballot.  Every lane of the warp calls it;
// returns the list's length.  Empty slots and dead columns carry wxp = 0,
// so their transposed votes are exactly 0 and leaving them out is exact.
template <typename ST>
__device__ __forceinline__ int column_slots(float4* slots, int* tidx,
                                            const ST* __restrict__ sp,
                                            int s, int n_t, int stride,
                                            size_t plane)
{
    const int lane = threadIdx.x & 31;
    int base = 0;
    for (int t0 = 0; t0 < n_t; t0 += 32) {
        const int t = t0 + lane;
        const size_t at = (size_t)t * stride + s;
        float wre = 0.f, wim = 0.f;
        if (t < n_t) {
            wre = load_sten_ldg(sp, 3 * plane + at);
            wim = load_sten_ldg(sp, 4 * plane + at);
        }
        const bool occ = wre != 0.f || wim != 0.f;
        const unsigned m = __ballot_sync(0xffffffffu, occ);
        if (occ) {
            const float r = load_sten_ldg(sp, at);
            const float ln_re = r * load_sten_ldg(sp, plane + at);
            const float ln_im = r * load_sten_ldg(sp, 2 * plane + at);
            const int j = base + __popc(m & ((1u << lane) - 1u));
            slots[j] = make_float4(ln_re, ln_im, wre, wim);
            tidx[j] = t;
        }
        base += __popc(m);
    }
    return base;
}

// The transpose of one occupied slot's vote, for a source feature
// (xre, xim) not at the origin with unit û = (uR, uI) (formed as in
// splat_vote): the slot e = (ln_re, ln_im, wxp_re, wxp_im) of target row
// gt of the grid's cotangent, read as gt[q·sq] (real part of cell q) and
// gt[(w² + q)·sq] (imaginary part).  With p, the corners and the weights
// w0..w3 recomputed as splat_vote forms them and G_k the cotangent of
// corner k's cell:
//
//   dv   = Σ_k w_k·G_k                          the vote's cotangent
//   dW_k = v_re·G_k,re + v_im·G_k,im            v = x·wxp
//   dp1  = −dW0·e2C + dW1·e2F + dW2·e2C − dW3·e2F   (e1C = pC1 − p1, ...)
//   dp2  = −dW0·e1C + dW1·e1F − dW2·e1F + dW3·e1C
//   du  += n_bins·(dp1·ln_re + dp2·ln_im, dp1·ln_im − dp2·ln_re)
//   dxv += conj(wxp)·dv
//
// Shared by K2's backward (echo_panel_bwd.cu) and K7's
// (echo_compact_bwd.cu); finish with unit_grad.
__device__ __forceinline__ void unvote_slot(
    float& du_re, float& du_im, float& dxv_re, float& dxv_im,
    const float* __restrict__ gt, long long sq, float4 e, float xre,
    float xim, float uR, float uI, int n_bins)
{
    const int w = 2 * n_bins + 1;
    const int w2 = w * w;
    const float nbf = (float)n_bins;
    const float p1 = __fmul_rn(
        nbf, __fadd_rn(__fmul_rn(e.x, uR), __fmul_rn(e.y, uI)));
    const float p2 = __fmul_rn(
        nbf, __fadd_rn(__fmul_rn(-e.x, uI), __fmul_rn(e.y, uR)));
    const float pC1 = fminf(fmaxf(ceilf(p1), -nbf), nbf);
    const float pF1 = fminf(fmaxf(floorf(p1), -nbf), nbf);
    const float pC2 = fminf(fmaxf(ceilf(p2), -nbf), nbf);
    const float pF2 = fminf(fmaxf(floorf(p2), -nbf), nbf);
    const float e1C = pC1 - p1, e1F = p1 - pF1;
    const float e2C = pC2 - p2, e2F = p2 - pF2;
    const int aF = (int)pF1 + n_bins, aC = (int)pC1 + n_bins;
    const int bF = (int)pF2 + n_bins, bC = (int)pC2 + n_bins;
    const int q[4] = {aF * w + bF, aC * w + bC, aC * w + bF, aF * w + bC};
    const float wt[4] = {e1C * e2C, e1F * e2F, e1F * e2C, e1C * e2F};
    const float vre = xre * e.z - xim * e.w;
    const float vim = xre * e.w + xim * e.z;
    float dv_re = 0.f, dv_im = 0.f, dW[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const float gre = __ldg(gt + (long long)q[k] * sq);
        const float gim = __ldg(gt + (long long)(w2 + q[k]) * sq);
        dv_re += wt[k] * gre;
        dv_im += wt[k] * gim;
        dW[k] = vre * gre + vim * gim;
    }
    const float da1 = nbf * (-dW[0] * e2C + dW[1] * e2F
                             + dW[2] * e2C - dW[3] * e2F);
    const float da2 = nbf * (-dW[0] * e1C + dW[1] * e1F
                             - dW[2] * e1F + dW[3] * e1C);
    du_re += da1 * e.x + da2 * e.y;
    du_im += da1 * e.y - da2 * e.x;
    dxv_re += dv_re * e.z + dv_im * e.w;
    dxv_im += dv_im * e.z - dv_re * e.w;
}

// A source's dx from its summed unvote_slot terms: u = x/|x| is linear in
// du, so its Jacobian (I − ûûᵀ)/|x| is applied once, dx = (I − ûûᵀ)·du·
// inv_r + dxv; a source at the origin (nz false) gets 0.
__device__ __forceinline__ float2 unit_grad(bool nz, float du_re,
                                            float du_im, float dxv_re,
                                            float dxv_im, float uR, float uI,
                                            float inv_r)
{
    float2 out = make_float2(0.f, 0.f);
    if (nz) {
        const float dot = uR * du_re + uI * du_im;
        out.x = (du_re - uR * dot) * inv_r + dxv_re;
        out.y = (du_im - uI * dot) * inv_r + dxv_im;
    }
    return out;
}

// 1/|x| and the unit û of a source feature in the forward's exact
// rounding (see "Exact p" above); 0 for a feature at the origin.
__device__ __forceinline__ bool unit_of(float xre, float xim, float& inv_r,
                                        float& uR, float& uI)
{
    const bool nz = fabsf(xre) >= kEps || fabsf(xim) >= kEps;
    inv_r = nz ? __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(
                     __fmul_rn(xre, xre), __fmul_rn(xim, xim))))
               : 0.f;
    uR = __fmul_rn(xre, inv_r);
    uI = __fmul_rn(xim, inv_r);
    return nz;
}

// Bytes of shared memory of a CTA of nthr threads and T targets over
// panels of TS columns: the accumulators, then the slot lists.
inline size_t smem_bytes(int w2, int nthr, int T, int TS)
{
    return (size_t)2 * w2 * nthr * sizeof(float)
           + (size_t)T * TS * (sizeof(float4) + sizeof(int))
           + (size_t)T * sizeof(int);
}

inline int threads_for(int T, int C)
{
    return (T * C + 31) / 32 * 32;
}

// The grid of a tile of T targets of one target block (blockIdx.x counts
// the tiles of every block), one thread per (target, channel): the block's
// contiguous run of panels in meta (4, P) (rows tgt, src or panel id,
// first, last; bounds by binary search in the tgt row) walked in meta
// order, so each output cell has exactly one writer and no atomics: two
// calls agree bitwise.  Per panel, one warp per target compacts the row's
// occupied slots (wxp ≠ 0; empty slots and dead columns carry wxp = 0, so
// their votes are exactly 0 and skipping them is exact) into shared memory
// as (ln_re, ln_im, wxp_re, wxp_im) and the source row, once for all
// channels.  Each thread then loops over its target's list, reads x_s (its
// channel, 8 bytes, through L1), and splats 4 re + 4 im products into its
// own 2w² accumulators.  Those sit in shared memory, not registers (98
// floats at n_bins = 3 would be indexed by data, which spills), laid out
// [cell][thread] with a stride of the block size, so the 32 lanes of a warp
// always hit 32 distinct banks.  The epilogue writes out (nb_out, 2w², C,
// TB) with consecutive threads on consecutive targets.  GATHER: column s of
// panel p reads row src_idx[p·TS + s]; a slot whose row lies outside [0,
// n_rows) adds nothing.  smem as smem_bytes counts it.
template <bool GATHER, typename ST>
__device__ __forceinline__ void grid_tile(
    const float2* __restrict__ x, const ST* __restrict__ sten,
    const int* __restrict__ meta, const int* __restrict__ src_idx,
    float* __restrict__ out, int P, int C, int TB, int TS, int n_bins, int T,
    int n_rows, float* smem)
{
    const int w = 2 * n_bins + 1;
    const int w2 = w * w;
    const int tiles = (TB + T - 1) / T;
    const int blk = blockIdx.x / tiles;
    const int t0 = (blockIdx.x % tiles) * T;
    const int nt = min(T, TB - t0);
    const int tid = threadIdx.x;
    const int nthr = blockDim.x;             // a multiple of 32
    const bool active = tid < nt * C;
    const int it = tid / C, ic = tid % C;    // (target, channel) of a thread

    float* acc = smem;                                       // [2w²][nthr]
    float4* slots = reinterpret_cast<float4*>(acc + 2 * w2 * nthr);  // [T][TS]
    int* sidx = reinterpret_cast<int*>(slots + T * TS);      // [T][TS]
    int* cnt = sidx + T * TS;                                // [T]

    for (int q = 0; q < 2 * w2; ++q) acc[q * nthr + tid] = 0.f;

    const int p_lo = lower_bound(meta, P, blk);
    const int p_hi = lower_bound(meta, P, blk + 1);
    const size_t plane = (size_t)TB * TS;
    const int warp = tid >> 5, lane = tid & 31, nwarps = nthr >> 5;

    for (int p = p_lo; p < p_hi; ++p) {
        const int sblk = GATHER ? 0 : __ldg(meta + P + p);
        const int* srow = GATHER ? src_idx + (size_t)p * TS : nullptr;
        const ST* sp = sten + (size_t)p * 5 * plane;
        __syncthreads();                     // the last panel's lists are read
        // compact each target row's occupied slots, one warp per target
        for (int t = warp; t < nt; t += nwarps) {
            const size_t row = (size_t)(t0 + t) * TS;
            int base = 0;
            for (int s0 = 0; s0 < TS; s0 += 32) {
                const int s = s0 + lane;
                float wre = 0.f, wim = 0.f;
                if (s < TS) {
                    wre = load_sten(sp, 3 * plane + row + s);
                    wim = load_sten(sp, 4 * plane + row + s);
                }
                bool occ = wre != 0.f || wim != 0.f;
                int src = s;
                if (GATHER && occ) {
                    src = __ldg(srow + s);
                    occ = (unsigned)src < (unsigned)n_rows;
                }
                const unsigned m = __ballot_sync(0xffffffffu, occ);
                if (occ) {
                    const float r = load_sten(sp, row + s);
                    const float ln_re = r * load_sten(sp, plane + row + s);
                    const float ln_im =
                        r * load_sten(sp, 2 * plane + row + s);
                    const int j = base + __popc(m & ((1u << lane) - 1u));
                    slots[t * TS + j] = make_float4(ln_re, ln_im, wre, wim);
                    sidx[t * TS + j] = src;
                }
                base += __popc(m);
            }
            if (lane == 0) cnt[t] = base;
        }
        __syncthreads();
        if (!active) continue;
        const int n = cnt[it];
        const float4* sl = slots + it * TS;
        const int* si = sidx + it * TS;
        const float2* xs = x + (size_t)sblk * TB * C + ic;
        float* a = acc + tid;
        for (int j = 0; j < n; ++j)
            splat_vote(a, nthr, __ldg(xs + (size_t)si[j] * C), sl[j], n_bins);
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

}  // namespace echo
