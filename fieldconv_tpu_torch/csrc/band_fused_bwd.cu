// Fused banded field-conv backward (K1 bwd) for Hopper, sm_90a.
//
// Replaces the TPU kernel fieldconv_tpu/ops/pallas/band_conv.py::
// _band_megaw_bwd_impl (body _bwd_megaw_kernel) and its same-math pipeline
// twins _band_fused_mega_bwd_impl and _band_fused_bwd.  Python wrapper and
// plain PyTorch version: fieldconv_tpu_torch/ops/band_conv.py
// (band_fused_bwd, band_fused_bwd_reference).
//
// What it computes.  With contrib, G, S and W as in the forward
// (band_fused_fwd.cu, band_window.cuh): S_k = rs ⊙ f_k per ring,
// dy (n_mesh, N, O2) the output cotangent,
//
//   dW[r, j, o]     = Σ_m Σ_n contrib[m, n, r, j] · dy[m, n, o]    (W is shared)
//   dc[n, r, j]     = Σ_o dy[n, o] · W[r, j, o]
//   dG_k[s, re|im]  = Σ_n Σ_r S_k,r[n, w] ⊛ dc[n, r, k]  with s = (n/TB - nh)·TB + w,
//                     [S_re·d_re + S_im·d_im | S_re·d_im − S_im·d_re]
//
// Window slots whose source row lies outside [0, N) take no gradient.
// Outputs dg (n_mesh, N, M) and dw (R, M, O2), f32.
//
// Design.  The TPU kernel walks target blocks in order and read-modify-
// writes each block's overlapping dG window in one VMEM buffer, and sums dW
// in a revisited output block; both rely on its sequential grid.  Here the
// blocks run in parallel, so every sum has one owner and runs in a fixed
// order: no atomics, and two calls on the same inputs give bitwise-equal
// outputs.  One call launches five kernels on the stream, with one scratch
// buffer owned by the caller (band_fused_bwd_scratch_floats):
//
//   1. contrib: per tile of targets, contrib is rematerialised exactly as
//      the forward forms it (band_window.cuh; only g, W and the stencil are
//      kept from the forward, as in JAX) and written to scratch.
//   2. dc = dy·Wᵀ, a tiled product (64 × 64 outputs per CTA) written
//      channel-major, [c][k][r][re|im] with compile-time strides.
//   3. dW partials: a CTA owns 128 rows j × 64 columns o of dW for one
//      slice of the target rows of every mesh, with row chunks of contrib
//      and dy double-buffered through shared memory by cp.async;
//   4. a second kernel adds the slices' partials in slice order (3 and 4
//      live in dw_rows.cuh, which K5's backward shares).
//   5. dG, gathered by source: a CTA owns 32 source rows of one source
//      block (4 rows × all channels per thread group) and walks the target
//      blocks whose window covers it, 4 targets at a time, with those
//      targets' dc rows and the stencil columns that land on its rows
//      double-buffered through shared memory by cp.async.  Per (target,
//      source) slot it skips slots without an edge, forms
//      u_k = Σ_r rs_r·dc_{r,k} from float4 reads of its channel's dc (no
//      branch per ring, compile-time offsets), then applies f_k once.
//
// What bounds it.  At the serving shape N=8192, TB=128, nh=1, C=O=32, K=5,
// R=6 a call must move ~225 MB (stencil 201 MB, g, dg, dy, W, dW: 0.067 ms
// at 3.35 TB/s) and needs ~9 GFLOP f32 (contrib ~2.4, dW 2, dc 2, dG ~2.6:
// 0.135 ms at 67 TFLOP/s), so it is bound by operations (chip_smoke.py
// counts both from the run's stencil).  This version also writes and reads
// back contrib and dc (63 MB each), reads the stencil twice, and reads one
// dc row per target from shared memory for every edge (pass 5, bound by
// shared-memory bandwidth and instruction issue); fusing the passes and
// moving the contractions onto tensor cores are left to later work.
//
// An earlier draft read dc in the contrib layout with a branch per nonzero
// ring, and summed dW with one thread per output over all rows: its dG
// pass was bound by integer address arithmetic and branches, not by data
// movement, and its dW pass by load latency (PERF.md, Findings).

#include "band_bwd.cuh"

// Floats of the scratch buffer band_fused_bwd needs for these sizes (0 for
// sizes it does not take).
extern "C" long long band_fused_bwd_scratch_floats(int n_mesh, int N, int C,
                                                   int K, int R, int TB,
                                                   int nh, int O2)
{
    return band::fused_bwd_scratch_floats(n_mesh, N, C, K, R, TB, nh, O2,
                                          false);
}

// Launches the five kernels on `stream` and returns cudaGetLastError() (0
// on success), or cudaErrorInvalidValue for shapes they do not take (as the
// forward's, plus shared memory for one target of dc rows).  scratch holds
// band_fused_bwd_scratch_floats floats, owned by the caller.
extern "C" int band_fused_bwd(const float* dy, const float* g,
                              const float* sten, const float* wmat,
                              float* dg, float* dw, float* scratch,
                              int n_mesh, int N, int C, int K, int R, int TB,
                              int nh, int O2, void* stream)
{
    return band::fused_bwd<false>(dy, g, sten, wmat, dg, dw, scratch, n_mesh,
                                  N, C, K, R, TB, nh, O2,
                                  (cudaStream_t)stream);
}
