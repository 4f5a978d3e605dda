// The stencil read of the panel kernels (K2 and K7, echo_vote.cuh; K6's
// dG pass where it reads e^{iθ} and wxp at the occupied slots; K5's and
// K6's walks read raw words instead, panel_pipe.cuh::raw_value).  A panel
// stencil is stored in float32 or, cast by precomp/banded.py::
// cast_panel_sten, in bfloat16: the
// JAX package's panel kernels cast each plane to f32 on read
// (ops/pallas/band_conv.py::_panel_pairs, ops/pallas/echo_panel.py::
// _panel_tensors).  The kernels are templated on the element type ST and
// read every stencil element through load_sten (or load_sten_ldg, below),
// which returns it as f32 (a bf16 value widens to f32 exactly: its 16 bits
// are the f32's top half), so that everything after the load is the same
// f32 code for both, and a bf16 table halves the stencil bytes a call
// streams.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

__device__ __forceinline__ float load_sten(const float* __restrict__ p,
                                           size_t i)
{
    return __ldg(p + i);
}

__device__ __forceinline__ float load_sten(const __nv_bfloat16* __restrict__ p,
                                           size_t i)
{
    const unsigned short bits =
        __ldg(reinterpret_cast<const unsigned short*>(p) + i);
    return __uint_as_float((unsigned)bits << 16);
}

// load_sten through the bf16 load intrinsic: the same value, other code.
// The ECHO backwards' column walk (echo_vote.cuh::column_slots) reads
// through it: with load_sten's 16-bit integer read, ptxas unrolled that
// walk less on bf16 than on f32 (48 registers against 63) and K2's
// backward ran far slower on a bf16 table than on the f32 one, while with
// this read everywhere K5's backward and K2's forward ran slower on bf16.
__device__ __forceinline__ float load_sten_ldg(const float* __restrict__ p,
                                               size_t i)
{
    return __ldg(p + i);
}

__device__ __forceinline__ float load_sten_ldg(
    const __nv_bfloat16* __restrict__ p, size_t i)
{
    return __bfloat162float(__ldg(p + i));
}
