// Panel ECHO forward (K2) for Hopper, sm_90a.
//
// Replaces the TPU kernel fieldconv_tpu/ops/pallas/echo_panel.py::_fwd_impl
// (pallas_call at :408; body _fwd_kernel with the helpers _panel_tensors,
// _b_factors and _a_masks).  Python wrapper and plain PyTorch version:
// fieldconv_tpu_torch/ops/echo_panel.py.
//
// What it computes (float32, complex values planar; the stencil float32
// or bfloat16, each element read as f32, sten_load.cuh).  Inputs: source
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
// panels in meta order, so each output cell has exactly one writer and no
// atomics: two calls agree bitwise.  Per panel, one warp per target
// compacts the row's occupied slots (wxp ≠ 0; about two thirds of a
// panel's slots are empty and carry wxp = 0, so their votes are exactly 0
// and skipping them is exact) into shared memory, once for all channels;
// each thread splats its channel's votes into 2w² accumulators in shared
// memory laid out [cell][thread].  The walk and the vote live in
// echo_vote.cuh (echo::grid_tile, echo::splat_vote), which K7's forward
// (echo_compact_fwd.cu) shares; so does the rule that p is formed
// uncontracted and correctly rounded in the plain version's order ("Exact
// p" there): an ulp in p moves a whole vote where p lands on an integer.
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

#include "echo_vote.cuh"

#include <algorithm>
#include <cstddef>

namespace {

template <typename ST>
__global__ void __launch_bounds__(echo::kMaxThreads)
echo_panel_fwd_kernel(const float2* __restrict__ x,
                      const ST* __restrict__ sten,
                      const int* __restrict__ meta,
                      float* __restrict__ out,
                      int P, int C, int TB, int n_bins, int T)
{
    extern __shared__ __align__(16) float smem[];
    echo::grid_tile<false, ST>(x, sten, meta, nullptr, out, P, C, TB, TB,
                               n_bins, T, 0, smem);
}

template <typename ST>
int launch(const float* x, const void* sten, const int* meta, float* out,
           int P, int nb_out, int C, int TB, int n_bins, int T, int nthr,
           size_t smem, cudaStream_t stream)
{
    auto kernel = echo_panel_fwd_kernel<ST>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long grid = (long)nb_out * ((TB + T - 1) / T);
    kernel<<<(unsigned)grid, nthr, smem, stream>>>(
        reinterpret_cast<const float2*>(x), static_cast<const ST*>(sten),
        meta, out, P, C, TB, n_bins, T);
    return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for sizes the kernel does not take (C > 256, no
// tile of targets whose accumulators fit in shared memory).  sten float32,
// or bfloat16 when sten_bf16 is set.
extern "C" int echo_panel_fwd(const float* x, const void* sten,
                              const int* meta, float* out, int P, int nb_out,
                              int C, int TB, int n_bins, int sten_bf16,
                              void* stream)
{
    if (P < 1 || nb_out < 1 || C < 1 || C > echo::kMaxThreads || TB < 1
        || n_bins < 1)
        return (int)cudaErrorInvalidValue;
    int dev = 0, limit = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    const int w = 2 * n_bins + 1;
    int T = std::min({echo::kMaxTargets, TB,
                      std::max(1, echo::kMaxThreads / C)});
    while (T > 1 && echo::smem_bytes(w * w, echo::threads_for(T, C), T, TB)
                        > (size_t)limit)
        T /= 2;
    const int nthr = echo::threads_for(T, C);
    const size_t smem = echo::smem_bytes(w * w, nthr, T, TB);
    if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (sten_bf16)
        return launch<__nv_bfloat16>(x, sten, meta, out, P, nb_out, C, TB,
                                     n_bins, T, nthr, smem, s);
    return launch<float>(x, sten, meta, out, P, nb_out, C, TB, n_bins, T,
                         nthr, smem, s);
}
