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
// Design.  Two kernels on the stream (band_bwd.cuh, contrib_bwd, which K9's
// contrib backward shares).  The first puts dout back into the
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

// Floats of the scratch buffer band_contrib_bwd needs for these sizes (0
// for sizes it does not take).
extern "C" long long band_contrib_bwd_scratch_floats(int n_mesh, int N, int C,
                                                     int K, int R, int TB,
                                                     int nh)
{
    return band::contrib_bwd_scratch_floats(n_mesh, N, C, K, R, TB, nh);
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
    return band::contrib_bwd(dout, sten, dg, scratch, n_mesh, N, C, K, R, TB,
                             nh, (cudaStream_t)stream);
}
