// Unfused banded contrib backward (K3 bwd) for Hopper, sm_90a.
//
// Replaces the TPU kernel fieldconv_tpu/ops/pallas/band_conv.py::
// _band_contrib_bwd (body _bwd_kernel) and the _shift_combine that sums
// its per-(block, shift) partials.  Python wrapper and plain PyTorch
// version: fieldconv_tpu_torch/ops/band_conv.py (band_contrib_bwd,
// band_contrib_bwd_reference).
//
// What it computes.  For the contrib cotangent dout (n_mesh, nb·R·TB, K·2C)
// in K3's forward layout (band_contrib_fwd.cu) and S_k = rs ⊙ f_k,
//
//   dG_k[s, re|im] = Σ_n Σ_r S_k,r[n, w] ⊛ dout[n, r, k]  with s = (n/TB - nh)·TB + w,
//                    [S_re·d_re + S_im·d_im | S_re·d_im − S_im·d_re]
//
// onto g's rows (n_mesh, N, M); window slots whose source row lies outside
// [0, N) take no gradient.
//
// Design.  Two kernels on the stream.  The first puts dout back into the
// channel-major layout K1 backward's pass 5 reads ([row][c][k][r][re|im]
// with compile-time strides, zeros in the padding): a CTA per target row
// stages the row's R·M values of dout in shared memory and writes its dc
// row once, both coalesced.  The second is K1 backward's pass 5
// (band_bwd.cuh, bwd_dg_kernel): dG gathered by source block, every
// source row summing over the target blocks whose windows cover it, so the
// JAX shift combine becomes part of its fixed-order sum.  No atomics; two
// calls give bitwise-equal outputs.  The dc buffer is scratch owned by the
// caller (band_contrib_bwd_scratch_floats).
//
// What bounds it.  At the serving shape it reads the 201 MB stencil and
// dout (63 MB) once and writes dG once (~0.08 ms at 3.35 TB/s), with ~2.6
// GFLOP of stencil work; the relayout adds a round trip of dc (63 MB).

#include "band_bwd.cuh"

namespace {

using band::kThreads;

// dc[row, c·QS + (k·RMAX + r)·2 + p] = dout[m, (b·R + r)·TB + t, k·2C + p·C + c]
// for row = m·N + b·TB + t; entries with k ≥ K or r ≥ R hold zero.
template <int KMAX, int RMAX>
__global__ void __launch_bounds__(kThreads)
dc_from_contrib_kernel(const float* __restrict__ dout, float* __restrict__ dc,
                       int C, int K, int R, int TB)
{
    constexpr int QS = band::dc_stride<KMAX, RMAX>();
    extern __shared__ __align__(16) float srow[];        // [R][M]
    const int M = 2 * K * C;
    const size_t row = blockIdx.x;
    const size_t mb = row / TB;            // m·nb + b
    const int t = (int)(row % TB);
    const int tid = threadIdx.x;
    for (int i = tid; i < R * M; i += kThreads) {
        const int r = i / M, j = i - r * M;
        srow[i] = dout[((mb * R + r) * TB + t) * M + j];
    }
    __syncthreads();
    float* out = dc + row * C * QS;
    for (int o = tid; o < C * QS; o += kThreads) {
        const int c = o / QS, q = o - c * QS;
        const int k = q / (2 * RMAX), r = (q / 2) % RMAX, p = q % 2;
        out[o] = (k < K && r < R) ? srow[r * M + k * 2 * C + p * C + c] : 0.f;
    }
}

template <int KMAX, int RMAX>
int launch(const float* dout, const float* sten, float* dg, float* dc,
           int n_mesh, int N, int C, int K, int R, int TB, int nh,
           const band::Plan& pl, cudaStream_t stream)
{
    auto relayout = dc_from_contrib_kernel<KMAX, RMAX>;
    const size_t smem = (size_t)R * 2 * K * C * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        relayout, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    relayout<<<(unsigned)n_mesh * N, kThreads, smem, stream>>>(dout, dc, C, K,
                                                               R, TB);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    return (int)band::launch_dg<KMAX, RMAX, false>(dc, sten, dg, n_mesh, N, C,
                                                   K, R, TB, nh, pl, stream);
}

}  // namespace

// Floats of the scratch buffer band_contrib_bwd needs for these sizes (0
// for sizes it does not take).
extern "C" long long band_contrib_bwd_scratch_floats(int n_mesh, int N, int C,
                                                     int K, int R, int TB,
                                                     int nh)
{
    band::Plan pl;
    if (!band::shapes_supported(n_mesh, N, C, K, R, TB, nh, 1)
        || band::make_plan(n_mesh, N, C, K, R, 0, false, &pl) != cudaSuccess)
        return 0;
    return (long long)pl.floats;
}

// Launches the two kernels on `stream` and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for shapes they do not take (K > 5;
// R > 8, or R > 6 with K > 3; C > 256).  scratch holds
// band_contrib_bwd_scratch_floats floats, owned by the caller.
extern "C" int band_contrib_bwd(const float* dout, const float* sten,
                                float* dg, float* scratch, int n_mesh, int N,
                                int C, int K, int R, int TB, int nh,
                                void* stream)
{
    if (!band::shapes_supported(n_mesh, N, C, K, R, TB, nh, 1))
        return (int)cudaErrorInvalidValue;
    band::Plan pl;
    const cudaError_t err = band::make_plan(n_mesh, N, C, K, R, 0, false,
                                            &pl);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = (cudaStream_t)stream;
    if (K <= 3)
        return launch<3, 8>(dout, sten, dg, scratch, n_mesh, N, C, K, R, TB,
                            nh, pl, s);
    return launch<5, 6>(dout, sten, dg, scratch, n_mesh, N, C, K, R, TB, nh,
                        pl, s);
}
