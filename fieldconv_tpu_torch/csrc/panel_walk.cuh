// The ring knots and hats of a compressed slot, shared by the kernels that
// read compressed stencils on panel_pipe.cuh's walk: K5, K6 and K4
// (band_pipe.cuh).  A slot's R radial hats come from r (the hat on the ring
// knots, ops/band_conv.py::_hats_from_r), formed with uncontracted,
// correctly rounded operations in the plain version's order (its K complex
// factors f_k = wxp·e^{i(k−B)θ}: panel_pipe.cuh::phasors).  Also the
// binary search that finds a block's run of panels.

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

}  // namespace panel
