// The compact fold on its own (compact_fold.cuh), for the compact lift's
// backward (fieldconv_tpu_torch/ops/trans_field.py::_CompactLiftAggFn):
// per-column gradients (P·TS, W) summed onto rows (rows, W) through a
// CompactPanelTable's fold index.  K6's and K7's backwards run the same
// kernel as their last pass.

#include "compact_fold.cuh"

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for empty sizes.  vals: (·, W); fold_order: the
// live columns by source row; fold_ptr: (rows + 1,); out: (rows, W).
extern "C" int compact_fold(const float* vals, const int* fold_order,
                            const int* fold_ptr, float* out, int rows, int W,
                            void* stream)
{
    if (rows < 1 || W < 1) return (int)cudaErrorInvalidValue;
    return (int)fold::launch_fold(vals, fold_order, fold_ptr, out, rows, W,
                                  (cudaStream_t)stream);
}
