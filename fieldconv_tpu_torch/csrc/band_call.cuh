// One call of a banded conv on the panel walk (band_pipe.cuh), forward or
// backward: its scratch layout and its launches, shared by K1
// (band_fused_fwd.cu, band_fused_bwd.cu), K9 (halo_fused_fwd.cu,
// halo_fused_bwd.cu: a range of a shard's target blocks over its
// halo-extended rows) and K4 (band_cfused_fwd.cu, band_cfused_bwd.cu: COMP,
// a compressed band).  A call's band is a BandGeo (band_pipe.cuh): K1's
// whole band, or K9's range of it.
//
// Forward: the occupancy bytes (of a compressed band: from its r), the
// contrib walk by target, the filter split over j (panel_gemm.cuh), whose
// rows land in the range's rows of each mesh's y.  Backward: the
// occupancy bytes, the contrib walk, dW (dw_rows.cuh), W's rows in dc's order at K = 5, dc
// (panel_gemm.cuh), dG by source over every block of the source arrays.
// Every output has one writer and every sum a fixed order: no atomics,
// two calls agree bitwise.

#pragma once

#include "band_pipe.cuh"
#include "dw_rows.cuh"
#include "panel_gemm.cuh"

#include <cstddef>

namespace bandcall {

using bandpipe::BandGeo;
using bandpipe::round4;

// Floats of the occupancy bytes, 16-byte aligned.
inline size_t occ_floats(int n_mesh, const BandGeo& g)
{
    return (bandpipe::occ_bytes(n_mesh, g) + 15) / 16 * 4;
}

// Where a forward's scratch parts lie (floats from its start, each 16-byte
// aligned): contrib (the range's rows, R·M), the filter's partial sums
// (slices of j), the occupancy bytes.
struct Fwd {
    int slices;
    size_t part_at, occ_at, floats;
};

inline Fwd fwd_layout(int n_mesh, int C, int K, int R, int O2,
                      const BandGeo& g, int sms)
{
    Fwd l;
    const int rows = n_mesh * g.nr * g.TB, RM = R * 2 * K * C;
    l.slices = panel::filter_slices(rows, RM, O2, sms);
    l.part_at = round4((size_t)rows * RM);
    l.occ_at = l.part_at
        + (l.slices > 1 ? round4((size_t)l.slices * rows * O2) : 0);
    l.floats = l.occ_at + occ_floats(n_mesh, g);
    return l;
}

// Floats of a forward's scratch (0 where the device cannot be read).
inline long long fwd_scratch_floats(int n_mesh, int C, int K, int R, int O2,
                                    const BandGeo& g)
{
    int limit = 0, sms = 0;
    if (bandpipe::device_limits(&limit, &sms) != cudaSuccess) return 0;
    return (long long)fwd_layout(n_mesh, C, K, R, O2, g, sms).floats;
}

// The forward's three launches on `stream`: y (n_mesh, nb·TB, O2) gets the
// rows of the range's targets, its other rows are left as they are.
template <bool COMP>
int fused_fwd(const float* g, const float* sten, const float* wmat, float* y,
              float* scratch, int n_mesh, int C, int K, int R, int O2,
              const BandGeo& geo, cudaStream_t s)
{
    int limit = 0, sms = 0;
    cudaError_t err = bandpipe::device_limits(&limit, &sms);
    if (err != cudaSuccess) return (int)err;
    const Fwd l = fwd_layout(n_mesh, C, K, R, O2, geo, sms);
    pipe::Plan p;
    if (!bandpipe::contrib_plan(C, K, R, geo, g, limit, &p, COMP))
        return (int)cudaErrorInvalidValue;
    unsigned char* occ =
        reinterpret_cast<unsigned char*>(scratch + l.occ_at);
    err = bandpipe::launch_occ<COMP>(sten, occ, n_mesh, R, geo, s);
    if (err != cudaSuccess) return (int)err;
    err = bandpipe::launch_contrib<COMP>(g, sten, occ, scratch, n_mesh, C, K,
                                         R, geo, p, s);
    if (err != cudaSuccess) return (int)err;
    // the range's rows of each mesh's y (the whole band: y's own rows)
    const int rpm = geo.nr * geo.TB;
    return (int)panel::launch_filter_split(
        scratch, wmat, y + (size_t)geo.lo * geo.TB * O2, scratch + l.part_at,
        n_mesh * rpm, R * 2 * K * C, O2, l.slices, s,
        geo.nr == geo.nb ? 0 : rpm, geo.nb * geo.TB);
}

// Where a backward's scratch lies (floats from its start, each 16-byte
// aligned): contrib, then dc over it where it fits (else after the rest);
// the dW partials; W's rows in dc's order (bandpipe::cm_w_kernel, at K >
// 3); the occupancy bytes.
struct Bwd {
    band::DwSlices dws;
    size_t part_at, wcm_at, occ_at, dc_at, floats;
};

inline Bwd bwd_layout(int n_mesh, int C, int K, int R, int O2,
                      const BandGeo& g, int sms)
{
    Bwd l;
    const long long rows = (long long)n_mesh * g.nr * g.TB;
    const int RM = R * 2 * K * C;
    l.dws = band::dw_slices(rows, RM, O2, sms);
    l.part_at = round4((size_t)rows * RM);
    const int DC = bandpipe::dc_cols(C, K, R);
    l.wcm_at = l.part_at + round4((size_t)l.dws.slices * RM * O2);
    l.occ_at = l.wcm_at
        + (bandpipe::dg_by_k(K) ? round4((size_t)DC * O2) : 0);
    const size_t end = l.occ_at + occ_floats(n_mesh, g);
    l.dc_at = DC <= RM ? 0 : end;
    l.floats = DC <= RM ? end : end + (size_t)rows * DC;
    return l;
}

inline long long bwd_scratch_floats(int n_mesh, int C, int K, int R, int O2,
                                    const BandGeo& g)
{
    int limit = 0, sms = 0;
    if (bandpipe::device_limits(&limit, &sms) != cudaSuccess) return 0;
    return (long long)bwd_layout(n_mesh, C, K, R, O2, g, sms).floats;
}

// The backward's launches on `stream` (six, seven at K = 5): dy holds the
// range's rows (n_mesh, nr·TB, O2), dg gets every row of the source arrays
// (n_mesh, nsb·TB, M), dw (R, M, O2).
template <bool COMP>
int fused_bwd(const float* dy, const float* g, const float* sten,
              const float* wmat, float* dg, float* dw, float* scratch,
              int n_mesh, int C, int K, int R, int O2, const BandGeo& geo,
              cudaStream_t s)
{
    int limit = 0, sms = 0;
    cudaError_t err = bandpipe::device_limits(&limit, &sms);
    if (err != cudaSuccess) return (int)err;
    const Bwd l = bwd_layout(n_mesh, C, K, R, O2, geo, sms);
    pipe::Plan p1, p4;
    if (!bandpipe::contrib_plan(C, K, R, geo, g, limit, &p1, COMP)
        || !bandpipe::dg_plan(C, K, R, geo, scratch + l.dc_at, limit, &p4,
                              COMP))
        return (int)cudaErrorInvalidValue;
    const int rows = n_mesh * geo.nr * geo.TB;
    const int RM = R * 2 * K * C;
    const int DC = bandpipe::dc_cols(C, K, R);
    float* contrib = scratch;
    float* dc = scratch + l.dc_at;
    float* part = scratch + l.part_at;
    unsigned char* occ =
        reinterpret_cast<unsigned char*>(scratch + l.occ_at);

    err = bandpipe::launch_occ<COMP>(sten, occ, n_mesh, R, geo, s);
    if (err != cudaSuccess) return (int)err;
    err = bandpipe::launch_contrib<COMP>(g, sten, occ, contrib, n_mesh, C, K,
                                         R, geo, p1, s);
    if (err != cudaSuccess) return (int)err;
    err = band::launch_dw(contrib, dy, part, dw, rows, RM, O2, l.dws, s);
    if (err != cudaSuccess) return (int)err;
    const float* wdc = wmat;                 // W's rows in dc's order
    if (bandpipe::dg_by_k(K)) {
        float* wcm = scratch + l.wcm_at;
        err = bandpipe::launch_cm_w(wmat, wcm, C, K, R, O2, s);
        if (err != cudaSuccess) return (int)err;
        wdc = wcm;
    }
    err = panel::launch_dc(dy, wdc, dc, rows, DC, O2, s);
    if (err != cudaSuccess) return (int)err;
    return (int)bandpipe::launch_dg<COMP>(dc, sten, occ, dg, n_mesh, C, K, R,
                                          geo, p4, s);
}

}  // namespace bandcall
