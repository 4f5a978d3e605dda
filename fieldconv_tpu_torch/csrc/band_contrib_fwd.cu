// Unfused banded contrib forward (K3) for Hopper, sm_90a.
//
// Replaces the TPU kernel fieldconv_tpu/ops/pallas/band_conv.py::
// _band_contrib_fwd_impl (body _fwd_kernel).  Python wrapper and plain
// PyTorch version: fieldconv_tpu_torch/ops/band_conv.py (band_contrib_fwd,
// band_contrib_reference).
//
// What it computes: K1's contrib without the filter step (band_fused_fwd.cu),
// for mesh m, target n = b·TB + t, ring r, frequency k and channel c,
//
//   contrib[m, (b·R + r)·TB + t, k·2C + c]     = Σ_w rs_r[n, w] · Re h_k[w, c]
//   contrib[m, (b·R + r)·TB + t, k·2C + C + c] = Σ_w rs_r[n, w] · Im h_k[w, c]
//
// over the dense band stencil (n_mesh, nb, R+2K, TB, W'), laid out block by
// block and ring by ring as the JAX kernel lays it out (nb·R·TB, K·2C);
// ops/band_conv.py::band_contrib permutes it to (N, R, C, K, 2).
//
// Design.  It is K1 backward's pass 1 (band_bwd.cuh, bwd_contrib_kernel:
// a CTA per tile of ≤ 8 targets of one block of one mesh, one thread per
// (target, channel) with all K·R complex sums in registers, the window
// staged through shared memory by cp.async) with its output strides set to
// the JAX layout.  No atomics: every output has one owner.
//
// What bounds it.  At the serving shape N=8192, TB=128, nh=1, C=32, K=5,
// R=6 it reads the 201 MB stencil and g once and writes contrib (N·R·M
// floats, 63 MB) once: bytes ~0.08 ms at 3.35 TB/s, and ~2.4 GFLOP of
// stencil work; chip_smoke.py::k3_bound counts both from the run's data.

#include "band_bwd.cuh"

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for shapes the kernel does not take (K > 5; R > 8,
// or R > 6 with K > 3; C > 256).  out holds n_mesh·N·R·M floats.
extern "C" int band_contrib_fwd(const float* g, const float* sten, float* out,
                                int n_mesh, int N, int C, int K, int R,
                                int TB, int nh, void* stream)
{
    return band::contrib_fwd(g, sten, out, n_mesh, N, C, K, R, TB, nh,
                             (cudaStream_t)stream);
}
