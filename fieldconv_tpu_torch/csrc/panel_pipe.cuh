// The pipelined panel walk of K5 (band_panel_fwd.cu, band_panel_bwd.cu),
// K6 (band_compact_fwd.cu, band_compact_bwd.cu), and K1, K9 and K4 over
// their band's panels (band_pipe.cuh): contrib by target (the forwards and
// the backwards' pass 1) and dG by source (K5's, K1's, K9's and K4's
// backwards).
//
// A CTA owns a tile of T ≤ 32 "local" rows of one block: targets of a
// target block, or sources of a source block.  It walks the block's run of
// panels (P, planes, TB, TS), rows the target slot t and columns the
// source slot s; the "far" index u runs over the other side (source
// columns by target, target rows by source), and a far row is the row of
// g (by target) or of dc (by source) that u's slots read.  K5's panels are
// square (TS = TB) and column s of a panel whose source block is b reads
// g's row b·TB + s; K6's compact panels (GATHER, by target only) are TB ×
// TS and column s of panel p reads g's row src_idx[p·TS + s], a row
// outside [0, n_g) adding nothing.  A slot's coefficients are formed as
// panel_walk.cuh forms them (hats on the ring knots, phasor powers
// uncontracted and correctly rounded, or the dense planes read as they
// are).
//
// Per panel:
//   slab    the tile's part of the plane(s) that say which slots are
//           occupied (r, a dense stencil's R hat planes, or K1's occupancy
//           bytes, band_pipe.cuh), whole: by
//           target T rows of TS slots, one bulk copy (TMA) a plane; by
//           source TB short rows of the tile's columns.  A ring of kStages
//           stages on mbarriers, each refilled as soon as its panel is done.
//   masks   for every far index u a word of the local rows whose slot
//           (l, u) is occupied (r strictly between the outermost knots:
//           every slot with a nonzero hat, and a slot counted with all hats
//           zero adds exact zeros; or any dense hat nonzero); their union
//           is the far rows the tile needs, numbered in ascending order.  A
//           panel none of whose slots the tile holds costs its masks and a
//           barrier.
//   passes  UCAP of those far rows at a time: the far rows themselves, a
//           bulk copy each, completing on the pass buffer's mbarrier (each
//           row read once per tile and panel, however many local rows use
//           it), and the pass's occupied slots, numbered column by column
//           (a warp scan, a binary search, the n-th set bit) so that every
//           lane builds one: its hats from the slab, its other planes
//           (e^{iθ} and wxp, or the f_k planes) copied at that slot only by
//           cp.async of 4 bytes (a bf16 plane's element pair), one record
//           of NIMG words read back with 128-bit loads; and each local
//           row's word of occupied pass columns.
//   consume a thread (local row, CPT channels) walks its row's word in
//           ascending far order and sums in registers.
// Every sum has one order (panels in run order, far index ascending): no
// atomics, two calls agree bitwise.
//
// Two modes.  Every thread builds, then consumes, with a CTA barrier a
// pass and one pass in flight (K5 by target: its consumers' K·R complex
// sums leave no registers to spare at two CTAs an SM).  Or
// warp-specialized (K5 by source, K6 by target): the CTA's first threads
// consume and kProducerWarps more warps build, publishing each pass on its
// buffer's full mbarrier (their cp.async copies tracked by it) and reusing
// a buffer once the consumers arrive on its empty mbarrier; no barrier
// spans the CTA, so building overlaps consuming, and the by-source slab's
// short rows are spread over the producers as 16-byte copies.  K6 runs one
// CTA an SM of kCompactThreads consumers, a whole 32-row target block a
// tile at C = 32, two channels a consumer thread (float2 reads of g).

#pragma once

#include "panel_walk.cuh"

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace pipe {

using panel::Knots;

constexpr int kThreads = 256;      // most threads of a CTA
constexpr int kStages = 2;         // slab stages in flight
constexpr int kPassBufs = 2;       // pass buffers: kPassBufs − 1 in flight
constexpr int kMaxTB = 128;        // slots per panel side (4 mask words)
constexpr int kMaxWords = kMaxTB / 32;
constexpr int kProducerWarps = 4;  // warp-specialized walks: pass producers
// K6's contrib walk is warp-specialized: kCompactThreads consumers (a whole
// TBt-32 block a tile) and kProducerWarps producer warps, one CTA an SM
constexpr int kCompactThreads = 512;
// shared memory a walk aims at: two CTAs of 256 threads on an SM
constexpr size_t kSmemBudget = 113 * 1024;

// How a launch cuts its blocks and its shared memory (bytes from the start
// of the dynamic shared memory; the first 64 hold the slab and pass
// mbarriers).
struct Plan {
    int NQ, MT, T, nthr;   // local-row groups of C threads, rows a thread, rows a tile
    int UCAP;              // far rows a pass
    int W, SW, SROWS;      // slab planes, row width (elements), rows
    int NIMG;              // words of a slot's coefficients (a multiple of 4)
    int FW;                // floats of a far row
    int FS;                // floats from one far row to the next in memory
    int NU;                // far indices a panel: TS by target, TB by source
    int MW;                // words of a union of far indices (NU bits)
    unsigned pp;           // parity of a plane's elements (TB·TS odd)
    int bulk;              // slabs by bulk copy (rows 16-byte aligned)
    int FV;                // floats a far-row copy (4, 2 or 1); 4: rows by
                           // bulk copy, completing on the pass's mbarrier
    float r_lo, r_hi;      // compressed: a slot is occupied for r_lo < r < r_hi
    unsigned slab_bytes, img_words, off_slab, off_img, off_far, off_mask,
        off_pmask, off_done, bytes;
};

inline unsigned align16(size_t n) { return (unsigned)((n + 15) / 16 * 16); }

// Shared memory of the walk for a given UCAP (Plan fields other than the
// offsets set).  Masks are kept for two panels in turn, so that a panel's
// are written while the last one's may still be read.
inline unsigned walk_layout(Plan* p, int elem)
{
    size_t at = 64;
    p->slab_bytes = align16((size_t)p->W * p->SROWS * p->SW * elem);
    p->off_slab = (unsigned)at;
    at += (size_t)kStages * p->slab_bytes;
    p->img_words = (unsigned)((size_t)p->T * p->UCAP * p->NIMG);
    p->off_img = (unsigned)at;
    at += align16((size_t)kPassBufs * p->img_words * 4);
    p->off_far = (unsigned)at;
    at += align16((size_t)kPassBufs * p->UCAP * p->FW * 4);
    p->off_mask = (unsigned)at;
    at += align16((size_t)2 * p->NU * 4);
    p->off_pmask = (unsigned)at;                  // occupancy, bf16 parity
    at += align16((size_t)2 * kPassBufs * p->T * 4);
    p->off_done = (unsigned)at;                   // a pass buffer's end mark
    at += align16((size_t)kPassBufs * 4);
    return (unsigned)at;
}

// The tile of a walk: by target (bysrc = 0) or by source, C channels,
// panels of TB rows and TS columns (TS = TB by source), at most t_target
// local rows with at most mt_max of them a thread, far rows of fw floats
// at far (for the width of their copies) and the stencil at sten (for its
// bulk copies).  False for shapes it does not take.
inline bool tile_plan(int bysrc, int C, int K, int R, int TB, int TS,
                      int compressed, int elem, int t_target, int mt_max,
                      int fw, const void* far, const void* sten, Plan* p,
                      int threads = kThreads)
{
    if (C < 1 || C > threads || TB < 1 || TB > kMaxTB || TS < 1
        || TS > kMaxTB || (bysrc && TS != TB))
        return false;
    *p = Plan{};
    p->NQ = threads / C < t_target ? threads / C : t_target;
    p->MT = 1;
    while (p->MT * 2 <= mt_max && p->NQ * p->MT * 2 <= t_target) p->MT *= 2;
    p->T = p->NQ * p->MT;
    p->nthr = (p->NQ * C + 31) / 32 * 32;
    p->W = compressed ? 1 : R;
    p->SROWS = bysrc ? TB : p->T;
    // by source a row of the slab holds the tile's columns from the 8-slot
    // boundary at or below its first to the one above its last (or TB)
    p->SW = bysrc ? ((p->T + 14) / 8 * 8 < TB ? (p->T + 14) / 8 * 8 : TB)
                  : TS;
    p->NIMG = ((compressed ? 4 + R : R + 2 * K) + 3) / 4 * 4;
    p->FW = fw;
    p->FS = fw;
    p->NU = bysrc ? TB : TS;
    p->MW = (p->NU + 31) / 32;
    p->pp = (unsigned)(TB * TS) & 1u;
    // a panel's rows are TS elements apart
    p->bulk = (TS * elem) % 16 == 0 && (uintptr_t)sten % 16 == 0;
    p->FV = fw % 4 == 0 && (uintptr_t)far % 16 == 0 ? 4
          : fw % 2 == 0 && (uintptr_t)far % 8 == 0 ? 2 : 1;
    if (compressed) {                    // the outermost knots
        const panel::Knots kn = panel::ring_knots(R);
        p->r_lo = kn.lo[0];
        p->r_hi = kn.hi[R - 1];
    }
    return true;
}

// UCAP, the layout and the bytes of a tiled plan: the most far rows a
// pass (≤ 32) that keep the walk within kSmemBudget; if that leaves fewer
// than 8, within the limit.  False when nothing fits the limit.
inline bool fit_plan(Plan* p, int elem, int limit,
                     size_t budget = kSmemBudget)
{
    for (int pass = 0; pass < 2; ++pass) {
        const size_t cap = pass == 0 ? budget : (size_t)limit;
        for (int u = 32; u >= 1; --u) {
            p->UCAP = u;
            const size_t need = walk_layout(p, elem);
            if (need <= cap && (u >= 8 || pass == 1)) {
                p->bytes = (unsigned)need;
                return need <= (size_t)limit;
            }
        }
    }
    return false;
}

// Sets a kernel's dynamic shared memory to the plan's and its carveout to
// the most shared memory, so that two CTAs of kSmemBudget fit an SM.
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, const Plan& p)
{
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.bytes);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
}

// --- asynchronous copies --------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* ptr)
{
    return (unsigned)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity)
{
    unsigned done = 0;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

// an arrival on bar once this thread's cp.async copies so far are done
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar)
{
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar)
{
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

// the 4 bytes holding stencil element e: the f32, or the bf16 pair
__device__ __forceinline__ const void* raw_word(const float* sten, size_t e)
{
    return sten + e;
}

__device__ __forceinline__ const void* raw_word(const __nv_bfloat16* sten,
                                                size_t e)
{
    return reinterpret_cast<const void*>(
        reinterpret_cast<uintptr_t>(sten + e) & ~(uintptr_t)3);
}

// the element held in a raw word (par: bit 1 of its byte address)
__device__ __forceinline__ float raw_value(uint32_t w, unsigned, float*)
{
    return __uint_as_float(w);
}

__device__ __forceinline__ float raw_value(uint32_t w, unsigned par,
                                           __nv_bfloat16*)
{
    return __uint_as_float(__byte_perm(w, 0, par ? 0x3244 : 0x1044));
}

__device__ __forceinline__ float raw_value(float w, unsigned par,
                                           __nv_bfloat16* tag)
{
    return raw_value(__float_as_uint(w), par, tag);
}

__device__ __forceinline__ float raw_value(float w, unsigned, float*)
{
    return w;
}

__device__ __forceinline__ float slab_value(float v) { return v; }

__device__ __forceinline__ float slab_value(__nv_bfloat16 v)
{
    return __uint_as_float((unsigned)__bfloat16_as_ushort(v) << 16);
}

// f_k = wxp·e^{i(k−B)θ} for k < 2B + 1 from the unit phasor (pr, pi) and
// wxp (fr, fi) into registers (B a constant): by repeated multiplication
// from f_B = wxp, uncontracted and correctly rounded, in
// ops/band_conv.py::_phasor_pairs' order.
template <int B, int KMAX>
__device__ __forceinline__ void phasors(float (&fre)[KMAX], float (&fim)[KMAX],
                                        float pr, float pi, float fr,
                                        float fi)
{
    float cpr = fr, cpi = fi, cmr = fr, cmi = fi;
    fre[B] = cpr;
    fim[B] = cpi;
#pragma unroll
    for (int kk = 1; kk <= B; ++kk) {
        const float npr = __fsub_rn(__fmul_rn(cpr, pr), __fmul_rn(cpi, pi));
        const float npi = __fadd_rn(__fmul_rn(cpr, pi), __fmul_rn(cpi, pr));
        const float nmr = __fadd_rn(__fmul_rn(cmr, pr), __fmul_rn(cmi, pi));
        const float nmi = __fsub_rn(__fmul_rn(cmi, pr), __fmul_rn(cmr, pi));
        cpr = npr; cpi = npi; cmr = nmr; cmi = nmi;
        fre[B + kk] = cpr;
        fim[B + kk] = cpi;
        fre[B - kk] = cmr;
        fim[B - kk] = cmi;
    }
}

// A slot's coefficients out of a pass buffer's image: hats h, f_k (fre,
// fim).  slot: the slot's NIMG words (16-byte aligned), compressed [e^{iθ}
// re, im, wxp re, im, hats, ...] or dense [hats, f_k planes, ...]; par: for
// a bf16 stencil the half of the first raw plane's word that holds the
// slot, pp = Plan::pp (a plane of an odd number of elements flips it plane
// to plane).
template <int KMAX, int RMAX, typename ST>
__device__ __forceinline__ void slot_coefs(
    float (&h)[RMAX], float (&fre)[KMAX], float (&fim)[KMAX],
    const uint32_t* slot, unsigned par, unsigned pp, int R, int K,
    int compressed)
{
    ST* tag = nullptr;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) { fre[k] = 0.f; fim[k] = 0.f; }
    if (compressed) {
        const float4 raw = *reinterpret_cast<const float4*>(slot);
        constexpr int NH = (RMAX + 3) / 4;
        float hv[4 * NH];
#pragma unroll
        for (int q = 0; q < NH; ++q) {
            const float4 v = reinterpret_cast<const float4*>(slot + 4)[q];
            hv[4 * q] = v.x; hv[4 * q + 1] = v.y;
            hv[4 * q + 2] = v.z; hv[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < RMAX; ++r) h[r] = r < R ? hv[r] : 0.f;
        const float pr = raw_value(raw.x, par, tag);
        const float pi = raw_value(raw.y, par ^ pp, tag);
        const float fr = raw_value(raw.z, par, tag);
        const float fi = raw_value(raw.w, par ^ pp, tag);
        if (K == 5) {
            if constexpr (KMAX >= 5) phasors<2, KMAX>(fre, fim, pr, pi, fr, fi);
        } else if (K == 3) {
            if constexpr (KMAX >= 3) phasors<1, KMAX>(fre, fim, pr, pi, fr, fi);
        } else {
            phasors<0, KMAX>(fre, fim, pr, pi, fr, fi);
        }
    } else {
#pragma unroll
        for (int r = 0; r < RMAX; ++r)
            h[r] = r < R ? __uint_as_float(slot[r]) : 0.f;
        const uint32_t* raw = slot + R;
#pragma unroll
        for (int k = 0; k < KMAX; ++k)
            if (k < K) {
                fre[k] = raw_value(raw[2 * k], par, tag);
                fim[k] = raw_value(raw[2 * k + 1], par ^ pp, tag);
            }
    }
}

// The position of the k-th (from 0) set bit of x.
__device__ __forceinline__ int nth_bit(uint32_t x, int k)
{
    int pos = 0;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
        const uint32_t lo = x & ((1u << s) - 1u);
        const int c = __popc(lo);
        if (k >= c) { k -= c; x >>= s; pos += s; }
        else x = lo;
    }
    return pos;
}

// --- the walk ---------------------------------------------------------------------------

// A run: the panels of one block and where a walk finds their data.  For
// the run's k-th panel, pid(k) and other(k) (the far block) name it; from
// those, img (the stencil element of its plane 0, row 0, column 0), slab
// (the same in the array the slab is copied from), far0 (the far row of
// far index 0) and far_ok (whether the far block exists).  A panel's rows
// lie img_rs (slab_rs) elements apart, its planes img_plane (slab_plane).
// kRawR (an occupancy-byte slab over a compressed stencil): a slot's image
// is its e^{iθ}, wxp and r words, copied as they are, from which the
// consumers form its coefficients (band_pipe.cuh::expand_pass).
//
// K5's and K6's runs come from meta: by target meta (4, P) rows (tgt, src,
// ...), sorted by tgt; by source meta_s (4, P) rows (pid, tgt, src, ...),
// sorted by src; panel pid is `planes` planes of TB × TS slots at
// pid·planes·plane (plane = TB·TS), its slab read from the stencil itself.
// K1's band is arithmetic (band_pipe.cuh::BandRun).
template <bool BYSRC>
struct MetaRun {
    static constexpr bool kRawR = false;
    const int* meta;
    int P, nb_far, TB, rs;     // rs: TS by target, TB by source
    size_t plane;
    int planes;
    int p_lo = 0, n = 0;

    __device__ __forceinline__ void init(int blk)
    {
        const int* key = meta + (size_t)(BYSRC ? 2 : 0) * P;
        p_lo = panel::lower_bound(key, P, blk);
        n = panel::lower_bound(key, P, blk + 1) - p_lo;
    }
    __device__ __forceinline__ int pid(int k) const
    {
        return BYSRC ? __ldg(meta + p_lo + k) : p_lo + k;
    }
    __device__ __forceinline__ int other(int k) const
    {
        return __ldg(meta + (size_t)P + p_lo + k);
    }
    __device__ __forceinline__ size_t img(int pid, int) const
    {
        return (size_t)pid * planes * plane;
    }
    __device__ __forceinline__ size_t slab(int pid, int o) const
    {
        return img(pid, o);
    }
    __device__ __forceinline__ int far0(int o) const { return o * TB; }
    __device__ __forceinline__ bool far_ok(int o) const
    {
        return o >= 0 && o < nb_far;
    }
    __device__ __forceinline__ int img_rs() const { return rs; }
    __device__ __forceinline__ int slab_rs() const { return rs; }
    __device__ __forceinline__ size_t img_plane() const { return plane; }
    __device__ __forceinline__ size_t slab_plane() const { return plane; }
};

// Walks block blk's run for the tile of nt ≤ T local rows l0.. and calls
// consume(b) for every pass, in order, once its pass buffer b holds it.
// Every thread of the CTA must call it.  far: the far rows, FW floats each
// staged from rows pl.FS floats apart, row run.far0(other) + u for far
// index u; with GATHER far row src_idx[pid·NU + u] (a row outside [0,
// run.nb_far) adding nothing).  The slab is copied from slab_src: the
// stencil itself (SL = ST), or (SL = unsigned char, OCC) an occupancy byte
// a slot, and then a slot's image copies its R hats and the 2K f_k planes
// from plane R + run.fk0 on.
//
// WS: warp-specialized.  The CTA's first pl.nthr threads consume and
// kProducerWarps more warps produce: they mask, number and build passes
// among themselves (named barrier 1) and publish each pass on its buffer's
// full mbarrier (their cp.async copies tracked by it, the far rows' bulk
// copies counted in bytes); the consumers wait on it, consume, and free
// the buffer on its empty mbarrier.  No barrier spans the whole CTA, so
// building overlaps consuming.  Otherwise every thread does both, in turn,
// with a CTA barrier a pass.
template <bool BYSRC, bool WS, int RMAX, typename ST, bool GATHER = false,
          typename SL = ST, typename Run, typename Consume>
__device__ __forceinline__ void walk(
    unsigned char* smem, const Plan& pl, const ST* __restrict__ sten,
    const SL* __restrict__ slab_src, Run& run, const float* __restrict__ far,
    int R, int K, int compressed, int blk, int l0, int nt, const Knots& kn,
    Consume&& consume, const int* __restrict__ src_idx = nullptr)
{
    static_assert(WS || !BYSRC, "the by-source walk is warp-specialized");
    static_assert(!GATHER || !BYSRC, "a gathered walk runs by target");
    constexpr bool OCC = std::is_same<SL, unsigned char>::value;
    // by source the slab's 16-byte copies start on an AL-slot boundary
    constexpr int AL = 16 / (int)sizeof(SL) > 8 ? 16 / (int)sizeof(SL) : 8;
    // the building group: every thread, or (WS) the producer warps
    const int ncons = WS ? pl.nthr : 0;
    const bool producer = !WS || (int)threadIdx.x >= ncons;
    const int tid = threadIdx.x - ncons, lane = threadIdx.x & 31;
    const int warp = tid >> 5;
    const int nwarps = WS ? kProducerWarps : (int)(blockDim.x >> 5);
    const int nthr = nwarps * 32;
    auto group_sync = [&]() {
        if constexpr (WS)
            asm volatile("bar.sync 1, %0;\n" :: "r"(nthr) : "memory");
        else
            __syncthreads();
    };
    // far indices: columns by target, target rows by source
    const int NU = pl.NU;
    const int T = pl.T, UCAP = pl.UCAP, FW = pl.FW, MW = pl.MW;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
    uint32_t* img = reinterpret_cast<uint32_t*>(smem + pl.off_img);
    float* fbuf = reinterpret_cast<float*>(smem + pl.off_far);
    uint32_t* masks = reinterpret_cast<uint32_t*>(smem + pl.off_mask);
    uint32_t* pmask = reinterpret_cast<uint32_t*>(smem + pl.off_pmask);
    int* done = reinterpret_cast<int*>(smem + pl.off_done);

    run.init(blk);
    const int n = run.n;
    // by source: the slab's first column, at or below l0 on an AL-slot
    // boundary, and its width
    const int a0 = BYSRC ? (l0 & ~(AL - 1)) : 0;
    const int aw = BYSRC
        ? min((l0 + nt + AL - 1) & ~(AL - 1), run.slab_rs()) - a0 : NU;
    const int aoff = l0 - a0;

    auto slab = [&](int k) {
        return reinterpret_cast<SL*>(smem + pl.off_slab
                                     + (size_t)(k % kStages) * pl.slab_bytes);
    };
    // start the slab copies of the run's k-th panel: by target a bulk copy
    // a plane from warp 0; by source (NU short rows) 16-byte copies spread
    // over the building threads, each arriving on the stage's mbarrier
    // when its own are done
    auto start_slab = [&](int k) {
        if (!pl.bulk || (!BYSRC && warp != 0)) return;
        uint64_t* bar = bars + k % kStages;
        SL* dst = slab(k);
        const SL* src = slab_src + run.slab(run.pid(k), run.other(k));
        if constexpr (BYSRC) {
            constexpr int V = 16 / sizeof(SL);   // elements a copy
            const int nv = aw / V;
            for (int i = tid; i < pl.W * NU * nv; i += nthr) {
                const int v = i % nv, qu = i / nv;
                const int q = qu / NU, u = qu - q * NU;
                __pipeline_memcpy_async(
                    dst + ((size_t)q * NU + u) * pl.SW + V * v,
                    src + q * run.slab_plane() + (size_t)u * run.slab_rs()
                        + a0 + V * v,
                    16);
            }
            mbar_arrive_copies(bar);
        } else {
            const unsigned bytes = (unsigned)(nt * pl.SW * sizeof(SL));
            if (lane == 0) mbar_expect_tx(bar, bytes * pl.W);
            __syncwarp();
            for (int q = lane; q < pl.W; q += 32)
                bulk_copy(dst + (size_t)q * T * pl.SW,
                          src + q * run.slab_plane()
                              + (size_t)l0 * run.slab_rs(),
                          bytes, bar);
        }
    };
    const float r_lo = pl.r_lo, r_hi = pl.r_hi;
    auto occupied = [&](const SL* sl, int row, int c) {
        if constexpr (OCC) {
            return sl[(size_t)row * pl.SW + c] != 0;
        } else {
            if (compressed) {
                const float rv = slab_value(sl[(size_t)row * pl.SW + c]);
                return rv > r_lo && rv < r_hi;
            }
            bool occ = false;
            for (int r = 0; r < R; ++r)
                occ |= slab_value(
                           sl[((size_t)r * pl.SROWS + row) * pl.SW + c])
                    != 0.f;
            return occ;
        }
    };

    // word w of the union of far rows panel kc's tile needs (after its
    // masks' barrier; the same in every lane)
    auto union_word = [&](int kc, int w) -> uint32_t {
        const uint32_t* mask = masks + (kc & 1) * NU;
        const int u = 32 * w + lane;
        return __ballot_sync(0xffffffffu, u < NU && mask[u] != 0);
    };

    uint64_t* pbars = bars + kStages;        // a pass buffer's: full
    uint64_t* ebars = pbars + kPassBufs;     // (WS) empty
    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s) mbar_init(bars + s, BYSRC ? nthr : 1);
        for (int b = 0; b < kPassBufs; ++b) {
            // WS: every producer thread arrives twice (its generic writes,
            // its copies); else the thread that starts the bulk copies once
            mbar_init(pbars + b, WS ? 2 * nthr : 1);
            mbar_init(ebars + b, pl.nthr / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (producer)
        for (int k = 0; k < n && k < kStages; ++k) start_slab(k);

    int km = 0, kc = 0, U = 0, c0 = 0, pid = 0, oblk = 0, refill = -1;
    int np = 0;                  // passes built
    bool have = false;
    // Builds the next pass into buffer np % kPassBufs, if there is one, and
    // commits (or, WS, publishes) its copies; returns whether there was
    // one.  A stage freed by the last pass of its panel is refilled after
    // the next barrier (the next panel's masks', or the next top of the
    // loop).
    auto produce = [&]() -> bool {
        bool produced = false;
        while (!produced && (have || km < n)) {
            if (!have) {
                // --- the masks of the run's panel kc
                kc = km++;
                pid = run.pid(kc);
                oblk = GATHER ? 0 : run.other(kc);
                const SL* sl = slab(kc);
                uint32_t* mask = masks + (kc & 1) * NU;
                if (pl.bulk) {
                    mbar_wait(bars + kc % kStages, (kc / kStages) & 1);
                } else {
                    SL* dst = slab(kc);
                    const SL* src = slab_src + run.slab(pid, oblk);
                    const int rows = BYSRC ? NU : nt, w = BYSRC ? aw : NU;
                    const size_t sp = run.slab_plane();
                    const int srs = run.slab_rs();
                    for (int i = tid; i < pl.W * rows * w; i += nthr) {
                        const int c = i % w, qr = i / w;
                        const int q = qr / rows, row = qr - q * rows;
                        dst[((size_t)q * pl.SROWS + row) * pl.SW + c] = BYSRC
                            ? src[q * sp + (size_t)row * srs + a0 + c]
                            : src[q * sp + (size_t)(l0 + row) * srs + c];
                    }
                    group_sync();
                }
                // far index u's mask: the local rows whose slot (l, u) is
                // occupied (by target a thread a column, reading along it;
                // by source a ballot a slab row)
                if constexpr (!BYSRC) {
                    // GATHER: a column whose far row lies outside [0,
                    // n_far) holds no slot
                    const int* srow =
                        GATHER ? src_idx + (size_t)pid * NU : nullptr;
                    for (int u = tid; u < NU; u += nthr) {
                        uint32_t m = 0;
                        if (!GATHER
                            || (unsigned)__ldg(srow + u)
                                < (unsigned)run.nb_far)
                            for (int l = 0; l < nt; ++l)
                                if (occupied(sl, l, u)) m |= 1u << l;
                        mask[u] = m;
                    }
                } else {
                    for (int u = warp; u < NU; u += nwarps) {
                        const unsigned m = __ballot_sync(
                            0xffffffffu,
                            lane < nt && occupied(sl, u, aoff + lane));
                        if (lane == 0) mask[u] = m;
                    }
                }
                group_sync();
                if (refill >= 0) { start_slab(refill); refill = -1; }
                // --- the number of far rows the tile needs, in every warp
                U = 0;
#pragma unroll
                for (int w = 0; w < kMaxWords; ++w)
                    if (w < MW) U += __popc(union_word(kc, w));
                if (!GATHER && !run.far_ok(oblk)) U = 0;
                c0 = 0;
                if (U == 0) {            // the slab's stage is free
                    if (kc + kStages < n) start_slab(kc + kStages);
                    continue;
                }
                have = true;
            }
            // --- pass np: far rows c0 .. c0 + nu of panel kc, in order
            const int b = np % kPassBufs;
            const int nu = min(UCAP, U - c0);
            const SL* sl = slab(kc);
            const uint32_t* mask = masks + (kc & 1) * NU;
            const size_t ip = run.img_plane();
            const int irs = run.img_rs();
            int ul = 0;                  // far index of pass column `lane`
            {
                int k = c0 + lane, base = 0;
#pragma unroll
                for (int w = 0; w < kMaxWords; ++w) {
                    if (w < MW) {
                        const uint32_t x = union_word(kc, w);
                        const int c = __popc(x);
                        if (k >= base && k < base + c)
                            ul = 32 * w + nth_bit(x, k - base);
                        base += c;
                    }
                }
            }
            // a slot's hats (from the slab, or copied) and raw planes
            // (copied) into image word at
            auto put_slot = [&](uint32_t* at, int row, int c, size_t e0) {
                if constexpr (OCC && Run::kRawR) {
                    // e^{iθ} and wxp (planes 1-4), then r (plane 0)
                    for (int q = 0; q < 5; ++q)
                        __pipeline_memcpy_async(
                            at + q, raw_word(sten, e0 + (q + 1) % 5 * ip), 4);
                } else if constexpr (OCC) {
                    // the hats, then planes fk0 on of the f_k (a walk over
                    // a group of frequencies)
                    for (int q = 0; q < R + 2 * K; ++q)
                        __pipeline_memcpy_async(
                            at + q,
                            raw_word(sten, e0 + (q < R ? q : q + run.fk0) * ip),
                            4);
                } else if (compressed) {
                    const float rv = slab_value(sl[(size_t)row * pl.SW + c]);
#pragma unroll
                    for (int r = 0; r < RMAX; ++r)
                        if (r < R)
                            at[4 + r] = __float_as_uint(panel::hat(rv, r, kn));
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        __pipeline_memcpy_async(
                            at + q, raw_word(sten, e0 + (1 + q) * ip), 4);
                } else {
                    for (int r = 0; r < R; ++r)
                        at[r] = __float_as_uint(slab_value(
                            sl[((size_t)r * pl.SROWS + row) * pl.SW + c]));
                    for (int q = 0; q < 2 * K; ++q)
                        __pipeline_memcpy_async(
                            at + R + q, raw_word(sten, e0 + (R + q) * ip),
                            4);
                }
            };
            uint32_t* im = img + (size_t)b * pl.img_words;
            {
                // the local rows whose slot in pass column `lane` is occupied
                const uint32_t cm = lane < nu ? mask[ul] : 0u;
                const int first = compressed ? 1 : OCC ? 0 : R;  // first raw plane
                auto slot_of = [&](int l, int u) {
                    return BYSRC ? (size_t)u * irs + l0 + l
                                 : (size_t)(l0 + l) * irs + u;
                };
                const size_t pbase = run.img(pid, oblk);
                // bf16: the half of its first raw plane's word each slot of
                // local row 0 is in; row l's flips where slot (l, u) lies an
                // odd number of elements from (0, u)
                unsigned par0 = 0;
                if constexpr (sizeof(ST) == 2) {
                    const ST* e = sten + pbase + slot_of(0, ul) + first * ip;
                    par0 = __ballot_sync(
                        0xffffffffu, (reinterpret_cast<uintptr_t>(e) >> 1) & 1);
                }
                // each local row's occupied pass columns (and halves)
                for (int l = warp; l < T; l += nwarps) {
                    const unsigned m = __ballot_sync(0xffffffffu, (cm >> l) & 1u);
                    if (lane == 0) {
                        pmask[b * T + l] = m;
                        if constexpr (sizeof(ST) == 2) {
                            const bool flip = (BYSRC ? l : l * irs) & 1;
                            pmask[(kPassBufs + b) * T + l] = flip ? ~par0 : par0;
                        }
                    }
                }
                // the pass's occupied slots, numbered column by column, 32 a
                // warp at a time: column pc (the last whose first number is
                // ≤ j), row l (the (j − first)-th set bit of its rows)
                const int cnt = __popc(cm);
                int incl = cnt;
#pragma unroll
                for (int o = 1; o < 32; o <<= 1) {
                    const int v = __shfl_up_sync(0xffffffffu, incl, o);
                    if (lane >= o) incl += v;
                }
                const int excl = incl - cnt;
                const int total = __shfl_sync(0xffffffffu, incl, 31);
                for (int base = warp * 32; base < total; base += nthr) {
                    const int j = base + lane;
                    int pc = 0;
#pragma unroll
                    for (int st = 16; st > 0; st >>= 1) {
                        const int ex = __shfl_sync(0xffffffffu, excl, pc + st);
                        if (ex <= j) pc += st;
                    }
                    const uint32_t x = __shfl_sync(0xffffffffu, cm, pc);
                    const int u = __shfl_sync(0xffffffffu, ul, pc);
                    const int e = __shfl_sync(0xffffffffu, excl, pc);
                    if (j >= total) continue;
                    const int l = nth_bit(x, j - e);
                    put_slot(im + (size_t)(l * UCAP + pc) * pl.NIMG,
                             BYSRC ? u : l, BYSRC ? aoff + l : u,
                             pbase + slot_of(l, u));
                }
            }
            // the far row of pass column `lane` (lane < nu)
            int frow = 0;
            if constexpr (GATHER)
                frow = lane < nu ? __ldg(src_idx + (size_t)pid * NU + ul) : 0;
            else
                frow = run.far0(oblk) + ul;
            float* fdst = fbuf + (size_t)b * UCAP * FW;
            if (WS && tid == 0) done[b] = 0;
            if (pl.FV == 4) {            // a bulk copy a row (warp 0)
                if (warp == 0) {
                    if (lane == 0)
                        mbar_expect_tx(pbars + b, (unsigned)(nu * FW * 4));
                    __syncwarp();
                    if (lane < nu)
                        bulk_copy(fdst + (size_t)lane * FW,
                                  far + (size_t)frow * pl.FS, (unsigned)(FW * 4),
                                  pbars + b);
                }
            } else {
                const int FV = pl.FV, nv = FW / FV;
                for (int pc = warp; pc < nu; pc += nwarps) {
                    const int fr = __shfl_sync(0xffffffffu, frow, pc);
                    float* d = fdst + (size_t)pc * FW;
                    const float* sp = far + (size_t)fr * pl.FS;
                    for (int v = lane; v < nv; v += 32) {
                        if (FV == 2) __pipeline_memcpy_async(d + 2 * v, sp + 2 * v, 8);
                        else __pipeline_memcpy_async(d + v, sp + v, 4);
                    }
                }
            }
            if constexpr (WS) {          // publish the pass
                if (!(pl.FV == 4 && tid == 0)) mbar_arrive(pbars + b);
                mbar_arrive_copies(pbars + b);
            }
            produced = true;
            ++np;
            c0 += nu;
            if (c0 >= U) {
                have = false;
                if (kc + kStages < n) refill = kc + kStages;
            }
        }
        if constexpr (!WS) __pipeline_commit();
        return produced;
    };
    if constexpr (WS) {
        if (producer) {
            for (;;) {
                const int b = np % kPassBufs;
                if (np >= kPassBufs)     // pass np − kPassBufs is consumed
                    mbar_wait(ebars + b, (np / kPassBufs - 1) & 1);
                if (produce()) continue;
                if (tid == 0) done[b] = 1;   // the end: an empty pass
                mbar_arrive(pbars + b);
                mbar_arrive_copies(pbars + b);
                break;
            }
            __pipeline_wait_prior(0);
        } else {
            for (int nc = 0;; ++nc) {
                const int b = nc % kPassBufs;
                mbar_wait(pbars + b, (nc / kPassBufs) & 1);
                if (done[b]) break;
                consume(b);
                __syncwarp();
                if (lane == 0) mbar_arrive(ebars + b);
            }
        }
    } else {
        for (int i = 0; i < kPassBufs - 1; ++i) produce();
        for (int nc = 0;; ++nc) {
            __pipeline_wait_prior(kPassBufs - 2);
            if (nc < np && pl.FV == 4)
                mbar_wait(pbars + nc % kPassBufs, (nc / kPassBufs) & 1);
            __syncthreads();     // pass nc has landed; pass nc − 1 is consumed
            if (refill >= 0) { start_slab(refill); refill = -1; }
            if (nc == np) break;
            produce();
            consume(nc % kPassBufs);
        }
    }
}

// --- consumers --------------------------------------------------------------------------

// CPT consecutive floats at p (8-byte aligned for 2)
template <int CPT>
__device__ __forceinline__ void load_ch(float (&x)[CPT], const float* p)
{
    if constexpr (CPT == 2) {
        const float2 v = *reinterpret_cast<const float2*>(p);
        x[0] = v.x;
        x[1] = v.y;
    } else {
        x[0] = *p;
    }
}

// By target: contrib of each of a thread's MT targets l = qi + NQ·m over
// pass buffer b, channels ic .. ic + CPT − 1:
//   are[m][k][r][c] + i·aim[m][k][r][c] += hats_r·f_k ⊗ g[row, k, ic + c]
template <int KMAX, int RMAX, int MT, typename ST, int CPT = 1>
__device__ __forceinline__ void consume_fwd(
    float (&are)[MT][KMAX][RMAX][CPT], float (&aim)[MT][KMAX][RMAX][CPT],
    const unsigned char* smem, const Plan& pl, int b, int C, int K, int R,
    int compressed, int nt, bool active, int qi, int ic)
{
    if (!active) return;
    const int T = pl.T, UCAP = pl.UCAP, FW = pl.FW;
    const uint32_t* img = reinterpret_cast<const uint32_t*>(smem + pl.off_img)
        + (size_t)b * pl.img_words;
    const float* fb = reinterpret_cast<const float*>(smem + pl.off_far)
        + (size_t)b * UCAP * FW + ic;
    const uint32_t* pmask =
        reinterpret_cast<const uint32_t*>(smem + pl.off_pmask) + b * T;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
        const int l = qi + pl.NQ * m;
        if (l >= nt) continue;
        uint32_t bits = pmask[l];
        const uint32_t ppar = pmask[kPassBufs * T + l];
        while (bits) {
            const int pc = __ffs(bits) - 1;
            bits &= bits - 1;
            float h[RMAX], fre[KMAX], fim[KMAX];
            slot_coefs<KMAX, RMAX, ST>(
                h, fre, fim, img + (size_t)(l * UCAP + pc) * pl.NIMG,
                (ppar >> pc) & 1u, pl.pp, R, K, compressed);
            const float* gr = fb + (size_t)pc * FW;
#pragma unroll
            for (int k = 0; k < KMAX; ++k) {
                if (k < K) {
                    float xr[CPT], xi[CPT];
                    load_ch<CPT>(xr, gr + k * 2 * C);
                    load_ch<CPT>(xi, gr + k * 2 * C + C);
#pragma unroll
                    for (int c = 0; c < CPT; ++c) {
                        const float hr = fre[k] * xr[c] - fim[k] * xi[c];
                        const float hi = fre[k] * xi[c] + fim[k] * xr[c];
#pragma unroll
                        for (int r = 0; r < RMAX; ++r) {
                            are[m][k][r][c] = fmaf(h[r], hr, are[m][k][r][c]);
                            aim[m][k][r][c] = fmaf(h[r], hi, aim[m][k][r][c]);
                        }
                    }
                }
            }
        }
    }
}

// K6's consumer on a bf16 stencil: consume_fwd's sums for a thread of CPT
// channels, f_k ⊗ g formed for every k < KMAX (zeros from K on) before any
// is added.  The two forms compile to code of other speeds: on an H100
// this one ran K6's contrib 0.3 ms faster on a bf16 stencil at 163,842
// samples and 0.26 ms slower on an f32 one (C = 32, K = 3, R = 3).
template <int KMAX, int RMAX, int MT, typename ST, int CPT>
__device__ __forceinline__ void consume_compact(
    float (&are)[MT][KMAX][RMAX][CPT], float (&aim)[MT][KMAX][RMAX][CPT],
    const unsigned char* smem, const Plan& pl, int b, int C, int K, int R,
    int nt, bool active, int qi, int ic)
{
    if (!active) return;
    const int T = pl.T, UCAP = pl.UCAP, FW = pl.FW;
    const uint32_t* img = reinterpret_cast<const uint32_t*>(smem + pl.off_img)
        + (size_t)b * pl.img_words;
    const float* fb = reinterpret_cast<const float*>(smem + pl.off_far)
        + (size_t)b * UCAP * FW + ic;
    const uint32_t* pmask =
        reinterpret_cast<const uint32_t*>(smem + pl.off_pmask) + b * T;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
        const int l = qi + pl.NQ * m;
        if (l >= nt) continue;
        uint32_t bits = pmask[l];
        const uint32_t ppar = pmask[kPassBufs * T + l];
        while (bits) {
            const int pc = __ffs(bits) - 1;
            bits &= bits - 1;
            float h[RMAX], fre[KMAX], fim[KMAX];
            slot_coefs<KMAX, RMAX, ST>(
                h, fre, fim, img + (size_t)(l * UCAP + pc) * pl.NIMG,
                (ppar >> pc) & 1u, pl.pp, R, K, 1);
            const float* gr = fb + (size_t)pc * FW;
            float hr[KMAX][CPT], hi[KMAX][CPT];
#pragma unroll
            for (int k = 0; k < KMAX; ++k) {
                float xr[CPT], xi[CPT];
#pragma unroll
                for (int c = 0; c < CPT; ++c) { xr[c] = 0.f; xi[c] = 0.f; }
                if (k < K) {
                    load_ch<CPT>(xr, gr + k * 2 * C);
                    load_ch<CPT>(xi, gr + k * 2 * C + C);
                }
#pragma unroll
                for (int c = 0; c < CPT; ++c) {
                    hr[k][c] = fre[k] * xr[c] - fim[k] * xi[c];
                    hi[k][c] = fre[k] * xi[c] + fim[k] * xr[c];
                }
            }
#pragma unroll
            for (int k = 0; k < KMAX; ++k)
                if (k < K)
#pragma unroll
                    for (int c = 0; c < CPT; ++c)
#pragma unroll
                        for (int r = 0; r < RMAX; ++r) {
                            are[m][k][r][c] = fmaf(h[r], hr[k][c], are[m][k][r][c]);
                            aim[m][k][r][c] = fmaf(h[r], hi[k][c], aim[m][k][r][c]);
                        }
        }
    }
}

// By source: dG of each of a thread's MT sources l = qi + NQ·m over pass
// buffer b (far rows: dc's target rows, (R, M) each), channel ic:
//   u_k = Σ_r hats_r·dc[r, k]  (rings whose hat is zero skipped: exact),
//   dG_k += conj(f_k)·u_k  (panel_bwd's dg_slot order)
template <int KMAX, int RMAX, int MT, typename ST>
__device__ __forceinline__ void consume_dg(
    float (&gre)[MT][KMAX], float (&gim)[MT][KMAX], const unsigned char* smem,
    const Plan& pl, int b, int C, int K, int R, int compressed, int nt,
    bool active, int qi, int ic)
{
    if (!active) return;
    const int T = pl.T, UCAP = pl.UCAP, FW = pl.FW;
    const int M = 2 * K * C;
    const uint32_t* img = reinterpret_cast<const uint32_t*>(smem + pl.off_img)
        + (size_t)b * pl.img_words;
    const float* fb = reinterpret_cast<const float*>(smem + pl.off_far)
        + (size_t)b * UCAP * FW + ic;
    const uint32_t* pmask =
        reinterpret_cast<const uint32_t*>(smem + pl.off_pmask) + b * T;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
        const int l = qi + pl.NQ * m;
        if (l >= nt) continue;
        uint32_t bits = pmask[l];
        const uint32_t ppar = pmask[kPassBufs * T + l];
        while (bits) {
            const int pc = __ffs(bits) - 1;
            bits &= bits - 1;
            const uint32_t* slot = img + (size_t)(l * UCAP + pc) * pl.NIMG;
            const float* dr = fb + (size_t)pc * FW;
            float fre[KMAX], fim[KMAX];
            float h[RMAX];
            slot_coefs<KMAX, RMAX, ST>(h, fre, fim, slot, (ppar >> pc) & 1u,
                                       pl.pp, R, K, compressed);
#pragma unroll
            for (int k = 0; k < KMAX; ++k) {
                if (k < K) {
                    float ur = 0.f, ui = 0.f;
#pragma unroll
                    for (int r = 0; r < RMAX; ++r) {
                        if (r < R && h[r] != 0.f) {
                            const float* d = dr + r * M + k * 2 * C;
                            ur = fmaf(h[r], d[0], ur);
                            ui = fmaf(h[r], d[C], ui);
                        }
                    }
                    gre[m][k] = fmaf(fre[k], ur, fmaf(fim[k], ui, gre[m][k]));
                    gim[m][k] = fmaf(fre[k], ui, fmaf(-fim[k], ur, gim[m][k]));
                }
            }
        }
    }
}

// --- contrib by target (the forward, and the backward's pass 1) -------------------------

// The tile of each instantiation (K ≤ 3 with R ≤ 3, K ≤ 3 with R ≤ 6, K = 5
// with R ≤ 6): the most targets a tile and a thread, as the registers of
// the K·R complex sums allow two CTAs an SM.
struct Inst {
    int t_target, mt_max;
};

inline Inst contrib_inst(int K, int R)
{
    if (K <= 3 && R <= 3) return {32, 2};
    if (K <= 3) return {16, 2};
    return {8, 1};
}

namespace {

// contrib of every target row over its block's run of panels: one CTA per
// tile of T targets, MT a thread, written as (rows, R·M) row-major with
// column j = r·M + k·2C + (p·C + c) (coalesced over c).  nb_far: source
// blocks (K5), or with GATHER the rows of g (K6).  WS: warp-specialized
// (the walk's producer warps after pl.nthr consumers); CPT channels a
// consumer thread.
template <int KMAX, int RMAX, int MT, typename ST, bool GATHER, bool WS,
          int CPT>
__device__ __forceinline__ void contrib_tile(
    const float* __restrict__ g, const ST* __restrict__ sten,
    const int* __restrict__ meta, const int* __restrict__ src_idx,
    float* __restrict__ contrib, int P, int C, int K, int R, int TB,
    int compressed, int nb_far, const Plan& pl, const Knots& kn)
{
    const int M = 2 * K * C;
    const int RM = R * M;
    const int tiles = (TB + pl.T - 1) / pl.T;
    const int blk = blockIdx.x / tiles;
    const int l0 = (blockIdx.x % tiles) * pl.T;
    const int nt = min(pl.T, TB - l0);
    const int tid = threadIdx.x;
    const int tpt = C / CPT;                 // threads a target group
    const bool active = tid < pl.NQ * tpt;
    const int qi = active ? tid / tpt : 0;   // (target group, channels)
    const int ic = active ? tid % tpt * CPT : 0;

    extern __shared__ __align__(16) unsigned char smem[];
    float are[MT][KMAX][RMAX][CPT], aim[MT][KMAX][RMAX][CPT];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int k = 0; k < KMAX; ++k)
#pragma unroll
            for (int r = 0; r < RMAX; ++r)
#pragma unroll
                for (int c = 0; c < CPT; ++c) {
                    are[m][k][r][c] = 0.f;
                    aim[m][k][r][c] = 0.f;
                }
    // panels of TB × TS slots, TS = pl.NU
    MetaRun<false> run{meta, P, nb_far, TB, pl.NU, (size_t)TB * pl.NU,
                       compressed ? 5 : R + 2 * K};
    walk<false, WS, RMAX, ST, GATHER>(
        smem, pl, sten, sten, run, g, R, K, compressed, blk, l0, nt, kn,
        [&](int b) {
            if constexpr (GATHER && sizeof(ST) == 2)
                consume_compact<KMAX, RMAX, MT, ST, CPT>(
                    are, aim, smem, pl, b, C, K, R, nt, active, qi, ic);
            else
                consume_fwd<KMAX, RMAX, MT, ST, CPT>(
                    are, aim, smem, pl, b, C, K, R, compressed, nt, active,
                    qi, ic);
        }, src_idx);
    if (!active) return;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
        const int l = qi + pl.NQ * m;
        if (l >= nt) continue;
        float* cr = contrib + ((size_t)blk * TB + l0 + l) * RM;
#pragma unroll
        for (int k = 0; k < KMAX; ++k)
#pragma unroll
            for (int r = 0; r < RMAX; ++r)
                if (k < K && r < R) {
                    const int j = r * M + k * 2 * C + ic;
#pragma unroll
                    for (int c = 0; c < CPT; ++c) {
                        cr[j + c] = are[m][k][r][c];
                        cr[j + C + c] = aim[m][k][r][c];
                    }
                }
    }
}

// K5's contrib (square panels, source blocks from meta)
template <int KMAX, int RMAX, int MT, typename ST>
__global__ void __launch_bounds__(kThreads, 2)
contrib_kernel(const float* __restrict__ g, const ST* __restrict__ sten,
               const int* __restrict__ meta, float* __restrict__ contrib,
               int P, int C, int K, int R, int TB, int compressed, int nb_g,
               Plan pl, Knots kn)
{
    contrib_tile<KMAX, RMAX, MT, ST, false, false, 1>(
        g, sten, meta, nullptr, contrib, P, C, K, R, TB, compressed, nb_g, pl,
        kn);
}

// K6's contrib (compact panels, TB × TS, columns read through src_idx;
// compressed planes), CPT channels a consumer thread; WS: warp-specialized,
// one CTA an SM, else K5's two CTAs an SM
template <int KMAX, int RMAX, int MT, typename ST, int CPT, bool WS>
__global__ void __launch_bounds__(
    WS ? kCompactThreads + 32 * kProducerWarps : kThreads, WS ? 1 : 2)
compact_contrib_kernel(const float* __restrict__ g,
                       const ST* __restrict__ sten,
                       const int* __restrict__ meta,
                       const int* __restrict__ src_idx,
                       float* __restrict__ contrib, int P, int C, int K,
                       int R, int TB, int n_g, Plan pl, Knots kn)
{
    contrib_tile<KMAX, RMAX, MT, ST, true, WS, CPT>(
        g, sten, meta, src_idx, contrib, P, C, K, R, TB, 1, n_g, pl, kn);
}

}  // namespace

// Whether K6's contrib walk is warp-specialized: at K ≤ 3 (the
// correspondence and matching widths, 32-target tiles); at K = 5 (the
// segmentation width, tiles of 5 targets) K5's walk ran 3.4x faster on an
// H100.
inline bool compact_ws(int K) { return K <= 3; }

// Channels a consumer thread of K6's warp-specialized walk sums: two
// (float2 reads of g) on an f32 stencil of even C from 32 to 62, where a
// tile still fills kCompactThreads with one target a thread; else one.
// Measured on an H100 at 163,842 samples: two channels 0.1 ms faster at
// C = 32 on f32, slower at C = 16 and on bf16.
inline int compact_cpt(int C, int K, int elem)
{
    return compact_ws(K) && elem == 4 && C % 2 == 0 && C >= 32 && C < 64
        ? 2 : 1;
}

// The plan of a contrib launch over panels of TB rows and TS columns: the
// instantiation's tile, or a narrower one where its slabs (a dense
// stencil's R planes) leave no room.  compact: K6's walk (where
// compact_ws, kCompactThreads consumers of compact_cpt channels each, one
// CTA an SM, the whole limit).  False for shapes it does not take.
inline bool contrib_plan(int C, int K, int R, int TB, int TS, int compressed,
                         int elem, const void* g, const void* sten,
                         int limit, Plan* p, bool compact = false)
{
    const Inst in = contrib_inst(K, R);
    const bool ws = compact && compact_ws(K);
    const int cpt = compact ? compact_cpt(C, K, elem) : 1;
    const int tpt = C / cpt;                 // threads a target
    // two channels a thread come with one target a thread
    for (int mt = cpt == 2 ? 1 : in.mt_max; mt >= 1; mt /= 2)
        if (tile_plan(0, tpt, K, R, TB, TS, compressed, elem, in.t_target,
                      mt, 2 * K * C, g, sten, p,
                      ws ? kCompactThreads : kThreads)
            && fit_plan(p, elem, limit, ws ? (size_t)limit : kSmemBudget))
            return true;
    return false;
}

// K5's contrib_kernel, or (GATHER) K6's compact_contrib_kernel.
template <int KMAX, int RMAX, int MT, typename ST, bool GATHER, int CPT,
          bool WS>
inline auto contrib_entry()
{
    if constexpr (GATHER)
        return compact_contrib_kernel<KMAX, RMAX, MT, ST, CPT, WS>;
    else
        return contrib_kernel<KMAX, RMAX, MT, ST>;
}

// Launches plan p's kernel over nb_out target blocks, the instantiation for
// (K, R) and p.MT: K5's (nb_far: source blocks), or with GATHER K6's
// (nb_far: rows of g; columns read through src_idx, compressed planes).
template <typename ST, bool GATHER = false>
cudaError_t launch_contrib(const float* g, const ST* sten, const int* meta,
                           float* contrib, int P, int nb_out, int C, int K,
                           int R, int TB, int compressed, int nb_far,
                           const Plan& p, cudaStream_t stream,
                           const int* src_idx = nullptr)
{
    const Knots kn = compressed ? panel::ring_knots(R) : Knots{};
    const unsigned grid = (unsigned)((long)nb_out * ((TB + p.T - 1) / p.T));
    // WS: the walk's producer warps after the plan's consumers
    auto go = [&](auto kernel, bool ws) {
        cudaError_t err = set_smem(kernel, p);
        if (err != cudaSuccess) return err;
        if constexpr (GATHER)
            kernel<<<grid, p.nthr + (ws ? 32 * kProducerWarps : 0), p.bytes,
                     stream>>>(
                g, sten, meta, src_idx, contrib, P, C, K, R, TB, nb_far, p,
                kn);
        else
            kernel<<<grid, p.nthr, p.bytes, stream>>>(
                g, sten, meta, contrib, P, C, K, R, TB, compressed, nb_far, p,
                kn);
        return cudaGetLastError();
    };
    // the instantiation for (K, R) and p.MT, of CPT channels a thread; K6
    // warp-specialized at K ≤ 3 (compact_ws)
    // (two channels a thread come with one target a thread: compact_cpt)
    auto pick = [&](auto cpt) {
        constexpr int CPT = decltype(cpt)::value;
        if constexpr (CPT == 2) {
            if (p.MT != 1 || K > 3) return cudaErrorInvalidValue;
            if (R <= 3)
                return go(contrib_entry<3, 3, 1, ST, GATHER, 2, GATHER>(),
                          GATHER);
            return go(contrib_entry<3, 6, 1, ST, GATHER, 2, GATHER>(), GATHER);
        } else {
            if (K <= 3 && R <= 3) {
                if (p.MT == 2)
                    return go(contrib_entry<3, 3, 2, ST, GATHER, 1, GATHER>(),
                              GATHER);
                return go(contrib_entry<3, 3, 1, ST, GATHER, 1, GATHER>(),
                          GATHER);
            }
            if (K <= 3) {
                if (p.MT == 2)
                    return go(contrib_entry<3, 6, 2, ST, GATHER, 1, GATHER>(),
                              GATHER);
                return go(contrib_entry<3, 6, 1, ST, GATHER, 1, GATHER>(),
                          GATHER);
            }
            return go(contrib_entry<5, 6, 1, ST, GATHER, 1, false>(), false);
        }
    };
    if constexpr (GATHER && sizeof(ST) == 4)
        if (compact_cpt(C, K, sizeof(ST)) == 2)
            return pick(std::integral_constant<int, 2>{});
    return pick(std::integral_constant<int, 1>{});
}

}  // namespace pipe
