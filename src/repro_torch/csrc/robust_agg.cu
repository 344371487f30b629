// Standalone masked robust aggregation (K5) for Hopper (sm_90a), plain C
// interface.
//
// Counterpart of the Pallas TPU kernel src/repro/kernels/robust_agg.py:
// robust_agg_fwd (_robust_body): over a (C, N) matrix of client updates and a
// (C,) 0/1 team mask, with n = sum(mask), per coordinate either
//   trimmed  the mean of the masked-in rows whose stable rank lies in
//            [floor(trim_frac * n), n - floor(trim_frac * n)), divided by
//            max(n - 2 floor(trim_frac * n), 1), or
//   median   the mean of the rows ranked floor((n-1)/2) and ceil((n-1)/2).
// No gate and no weights.  These are exactly K2's rank modes (compare
// _robust_body with robust_pipeline.py:_combine_block), so the entry point
// runs launch_combine<DenseRows> from robust_pipeline.cuh with the team mask
// as both the mask and the (unread) weights: K5 is bitwise K2 under the same
// mask by construction.  An empty mask gives exactly 0.
//
// Bound at the main path's shape (C=16, N=421,642): one read of the 27.0 MB
// matrix and one write of the (N,) row, about 8.6 us at 3.35 TB/s; the C^2
// compares per column stay under that on the fp32 units.  Design: K2's, each
// column ranked from registers for C <= 64 and from a (C, 128) shared-memory
// tile past that, so C is bounded by shared memory (about 450), not by the
// TPU kernel's C <= 64.
//
// Returns cudaGetLastError(); the Python wrapper raises when it is not 0.

#include "robust_pipeline.cuh"

extern "C" {

// x (C, N), mask (C,) fp32 -> out (N,).  mode 1 trimmed, 2 median.
int ra_fwd(const float* x, const float* mask, float* out, int C, int N, int cols,
           int mode, float trim_frac, void* stream) {
  if (mode != 1 && mode != 2) return (int)cudaErrorInvalidValue;
  return launch_combine(DenseRows{x, N}, mask, mask, out, 1, C, N, cols, mode,
                        trim_frac, (cudaStream_t)stream);
}

}  // extern "C"
