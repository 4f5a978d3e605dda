// Block-sparse banded field-conv backward (K8 bwd) for Hopper, sm_90a.
//
// Replaces the TPU kernels fieldconv_tpu/ops/pallas/band_conv.py::
// _band_sparse_bwd_impl (grid pipeline, body _bwd_sparse_kernel, with the
// XLA scatter-add _sparse_combine of its per-panel dG parts) and its
// single-step twin _band_sparse_mega_bwd_impl (body
// _bwd_sparse_mega_kernel).  Python wrapper and plain PyTorch version:
// fieldconv_tpu_torch/ops/band_conv.py (band_sparse_bwd,
// band_sparse_bwd_reference).
//
// What it computes: K1's backward (band_fused_bwd.cu) over a
// BlockSparseTable (band_sparse_fwd.cu): for the output cotangent dy
// (n_mesh, N, O2),
//
//   dW[r, j, o]  = Σ_m Σ_n contrib[m, n, r, j] · dy[m, n, o]
//   dc[n, r, j]  = Σ_o dy[n, o] · W[r, j, o]
//   dG_k[s]     += Σ_r S_k,r[n, w] ⊛ dc[n, r, k]   for every slot w of
//                  target n whose source row is s = nbr[b, w / TB]·TB + w % TB
//
// Outputs dg (n_mesh, N, M) and dw (R, M, O2), f32.
//
// Design.  K1's five passes (band_bwd.cuh), SPARSE: (1) contrib is
// rematerialised by the forward's block-sparse walk; (2) dc = dy·Wᵀ;
// (3-4) dW as slice partials and their combine (dw_rows.cuh); (5) dG by
// source block: a CTA owns 32 source rows of block s and walks the panels
// (b, j) that read s, taken from the table's inverse index (inv_ptr,
// inv_bj: built on the host from nbr, padding entries left out, each
// block's list ascending), where K1 walks b = s − nh .. s + nh.  The TPU
// grid kernel instead writes every panel's dG part, an (nb·NJ·TB, M)
// tensor (2.39 GB at 163,842 vertices, C = 32), and scatter-adds them; here
// each dG row has one owner that sums its panels in a fixed order: no
// parts tensor, no atomics, and two calls give bitwise-equal outputs.  One
// caller-owned scratch buffer (band_sparse_bwd_scratch_floats) holds
// contrib, dc and the dW partials.
//
// What bounds it.  As K1's backward: the operations of contrib, dc, dW and
// dG (~2 GFLOP each at the serving shapes) against the stencil, read twice
// here (passes 1 and 5) where the bound counts it once
// (chip_smoke.py::k8_bwd_bound).

#include "band_bwd.cuh"

// Floats of the scratch buffer band_sparse_bwd needs for these sizes (0 for
// sizes it does not take).
extern "C" long long band_sparse_bwd_scratch_floats(int n_mesh, int N, int C,
                                                    int K, int R, int TB,
                                                    int nj, int O2)
{
    return band::fused_bwd_scratch_floats(n_mesh, N, C, K, R, TB, nj, O2);
}

// Launches the five kernels on `stream` and returns cudaGetLastError() (0
// on success), or cudaErrorInvalidValue for shapes they do not take (as the
// forward's, plus shared memory for one target of dc rows).  scratch holds
// band_sparse_bwd_scratch_floats floats, owned by the caller.
extern "C" int band_sparse_bwd(const float* dy, const float* g,
                               const float* sten, const int* nbr,
                               const int* inv_ptr, const int* inv_bj,
                               const float* wmat, float* dg, float* dw,
                               float* scratch, int n_mesh, int N, int C,
                               int K, int R, int TB, int nj, int O2,
                               void* stream)
{
    if (nj < 1) return (int)cudaErrorInvalidValue;
    return band::fused_bwd(dy, g, sten, wmat, dg, dw, scratch, n_mesh, N, C,
                           K, R, TB, nj, O2, (cudaStream_t)stream, nbr,
                           inv_ptr, inv_bj);
}
