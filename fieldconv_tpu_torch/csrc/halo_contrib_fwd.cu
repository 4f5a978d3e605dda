// Graph-parallel unfused banded contrib forward (K9 contrib) for Hopper,
// sm_90a.
//
// Replaces the TPU kernel fieldconv_tpu/parallel/halo.py::_halo_fwd_impl
// (body _fwd_kernel: K3's contrib of a shard's targets over the
// halo-extended G).  Python wrapper and plain PyTorch version:
// fieldconv_tpu_torch/parallel/halo.py (halo_contrib_fwd,
// halo_contrib_reference).
//
// What it computes: K3's contrib (band_contrib_fwd.cu) for the target
// blocks b = lo .. hi − 1 of a shard's stencil (n_mesh, nb, R+2K, TB, W'),
// each reading its window from the source array g (n_mesh, n_src, M) at
// block b + blk_off (halo_fused_fwd.cu), laid out as the JAX kernel lays
// it out, block by block and ring by ring:
//
//   out[m, ((b − lo)·R + r)·TB + t, k·2C + c]     = Σ_w rs_r[n, w] · Re h_k[w, c]
//   out[m, ((b − lo)·R + r)·TB + t, k·2C + C + c] = Σ_w rs_r[n, w] · Im h_k[w, c]
//
// Design.  K1 backward's pass 1 (band_bwd.cuh, contrib_fwd) with the
// window walk's HALO policy and K3's output strides.  No atomics.
//
// What bounds it.  The stencil of the range and its window's rows of g
// read once, contrib written once (chip_smoke.py::k9_contrib_bound).

#include "band_bwd.cuh"

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for shapes the kernel does not take (K3's, and
// n_src a positive multiple of TB, 0 ≤ lo < hi ≤ N / TB).  out holds
// n_mesh·(hi − lo)·TB·R·M floats.
extern "C" int halo_contrib_fwd(const float* g, const float* sten,
                                float* out, int n_mesh, int N, int n_src,
                                int C, int K, int R, int TB, int nh,
                                int blk_off, int lo, int hi, void* stream)
{
    return band::contrib_fwd<true>(g, sten, out, n_mesh, N, C, K, R, TB, nh,
                                   (cudaStream_t)stream,
                                   band::HaloRange{n_src, blk_off, lo, hi});
}
