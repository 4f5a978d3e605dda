// The coefficients of a compressed slot, shared by the panel and banded
// kernels: K5 and K6 (panel_pipe.cuh) and K4 (band_window.cuh, and through
// it K1, K3, K8 and K9).  A slot's R radial hats come from r (the hat on
// the ring knots, ops/band_conv.py::_hats_from_r) and its K complex
// factors f_k = wxp·e^{i(k−B)θ} from the unit phasor e^{iθ} and wxp, built
// by repeated multiplication in _phasor_pairs' order; both are formed with
// uncontracted, correctly rounded operations in the plain version's order.
// Also the binary search that finds a block's run of panels.

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace panel {

constexpr int kMaxRings = 6;

// ring r's hat of a compressed slot: clamp(min((rv − lo)·up, (hi − rv)·dn),
// 0, 1), knots as ops/band_conv.py::_hats_from_r forms them
struct Knots {
    float lo[kMaxRings], hi[kMaxRings], up[kMaxRings], dn[kMaxRings];
};

inline Knots ring_knots(int R)
{
    // knots sqrt(r / (R − 1)) with virtual knots −1 and 2 at the ends, the
    // slopes' reciprocals taken in double and rounded once
    Knots kn{};
    for (int r = 0; r < R; ++r) {
        const double sc = std::sqrt((double)r / (R - 1));
        const double sl = r > 0 ? std::sqrt((double)(r - 1) / (R - 1)) : -1.0;
        const double sr = r < R - 1 ? std::sqrt((double)(r + 1) / (R - 1))
                                    : 2.0;
        kn.lo[r] = (float)sl;
        kn.hi[r] = (float)sr;
        kn.up[r] = (float)(1.0 / (sc - sl));
        kn.dn[r] = (float)(1.0 / (sr - sc));
    }
    return kn;
}

// The first index of the sorted a[0, n) whose value is not below v.
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

__device__ __forceinline__ float hat(float rv, int r, const Knots& kn)
{
    const float a = __fmul_rn(__fsub_rn(rv, kn.lo[r]), kn.up[r]);
    const float b = __fmul_rn(__fsub_rn(kn.hi[r], rv), kn.dn[r]);
    return fminf(fmaxf(fminf(a, b), 0.f), 1.f);
}

// f_k = wxp·e^{i(k−B)θ} re/im for k = 0..2B into cf[2k·stride] and
// cf[(2k+1)·stride], from the unit phasor (pr, pi) and wxp (fr, fi): built
// by repeated multiplication in _phasor_pairs' order and rounding (K4,
// band_window.cuh; panel_pipe.cuh::phasors is the same in registers).
__device__ __forceinline__ void phasor_powers(float* cf, int stride, float pr,
                                              float pi, float fr, float fi,
                                              int B)
{
    float cpr = fr, cpi = fi, cmr = fr, cmi = fi;
    cf[2 * B * stride] = cpr;
    cf[(2 * B + 1) * stride] = cpi;
    for (int kk = 1; kk <= B; ++kk) {
        const float npr = __fsub_rn(__fmul_rn(cpr, pr), __fmul_rn(cpi, pi));
        const float npi = __fadd_rn(__fmul_rn(cpr, pi), __fmul_rn(cpi, pr));
        const float nmr = __fadd_rn(__fmul_rn(cmr, pr), __fmul_rn(cmi, pi));
        const float nmi = __fsub_rn(__fmul_rn(cmi, pr), __fmul_rn(cmr, pi));
        cpr = npr; cpi = npi; cmr = nmr; cmi = nmi;
        cf[2 * (B + kk) * stride] = cpr;
        cf[(2 * (B + kk) + 1) * stride] = cpi;
        cf[2 * (B - kk) * stride] = cmr;
        cf[(2 * (B - kk) + 1) * stride] = cmi;
    }
}

}  // namespace panel
