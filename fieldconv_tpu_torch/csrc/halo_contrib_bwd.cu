// Graph-parallel unfused banded contrib backward (K9 contrib bwd) for
// Hopper, sm_90a.
//
// Replaces the TPU kernel fieldconv_tpu/parallel/halo.py::_halo_bwd_impl
// (body _bwd_kernel, with the XLA combine of its per-(block, shift) parts
// into dG_ext).  Python wrapper and plain PyTorch version:
// fieldconv_tpu_torch/parallel/halo.py (halo_contrib_bwd,
// halo_contrib_bwd_reference).
//
// What it computes.  For the contrib cotangent dout (n_mesh, (hi − lo)·R·TB,
// K·2C) in halo_contrib_fwd.cu's layout and S_k = rs ⊙ f_k,
//
//   dG_k[s, re|im] = Σ_n Σ_r S_k,r[n, w] ⊛ dout[n, r, k]
//                    with s = (b + blk_off)·TB + w for target n of block b,
//                    [S_re·d_re + S_im·d_im | S_re·d_im − S_im·d_re]
//
// onto every row of the source array (n_mesh, n_src, M), its halo rows
// included (parallel/halo.py returns those to the ring neighbours).
//
// Design.  K3's backward (band_bwd.cuh, contrib_bwd), HALO: the cotangent
// put back into pass 5's channel-major layout (a CTA per target row), then
// pass 5 by owner row of the source array (halo_fused_bwd.cu): no parts
// tensor, no atomics, bitwise-equal outputs across calls.  The dc buffer is
// scratch owned by the caller (halo_contrib_bwd_scratch_floats).
//
// What bounds it.  The stencil and dout read once and dG written once, with
// the stencil work of the transposed contraction
// (chip_smoke.py::k9_contrib_bound).

#include "band_bwd.cuh"

// Floats of the scratch buffer halo_contrib_bwd needs for these sizes (0
// for sizes it does not take).
extern "C" long long halo_contrib_bwd_scratch_floats(int n_mesh, int N,
                                                     int n_src, int C, int K,
                                                     int R, int TB, int nh,
                                                     int blk_off, int lo,
                                                     int hi)
{
    return band::contrib_bwd_scratch_floats<true>(
        n_mesh, N, C, K, R, TB, nh, band::HaloRange{n_src, blk_off, lo, hi});
}

// Launches the two kernels on `stream` and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for shapes they do not take.  scratch
// holds halo_contrib_bwd_scratch_floats floats, owned by the caller.
extern "C" int halo_contrib_bwd(const float* dout, const float* sten,
                                float* dg, float* scratch, int n_mesh, int N,
                                int n_src, int C, int K, int R, int TB,
                                int nh, int blk_off, int lo, int hi,
                                void* stream)
{
    return band::contrib_bwd<true>(dout, sten, dg, scratch, n_mesh, N, C, K,
                                   R, TB, nh, (cudaStream_t)stream,
                                   band::HaloRange{n_src, blk_off, lo, hi});
}
