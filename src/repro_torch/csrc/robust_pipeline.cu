// Robust Eq.-11 aggregation kernels for Hopper (sm_90a), plain C interface.
//
// Counterparts of the Pallas TPU kernels in src/repro/kernels/robust_pipeline.py:
//   rp_pass1   <- cosine_gate_partials_leafwise  (K1: masked coordinate median
//                 over the client axis by the stable-rank network, then
//                 sum_j x_ij*med_j, sum_j x_ij^2 and sum_j med_j^2)
//   rp_combine <- gated_combine_leafwise         (K2: mean | trimmed | median)
//   rp_gram    <- pairwise_sq_dists_leafwise     (K3: Gram matrix X X^T)
// The kernels themselves are in robust_pipeline.cuh, shared with K6
// (comm_codecs.cu); these entry points read a dense fp32 (G, C, N) matrix,
// and the *_seg ones the same matrix as L fp32 leaves side by side (a tree's
// leaves, each (G, C, n_l), with no copy into one matrix): the same kernels,
// plan and sums, so bitwise the dense entry points on the concatenation.
//
// Bound at the main path's shape (G=1, C=16, N=421,642): each kernel reads the
// 27.0 MB matrix once, about 8 us at 3.35 TB/s; the rank network's C^2 compares
// per column and the Gram's C^2 FMAs per column stay under that on the fp32
// units.  The design keeps the loads coalesced (a warp reads 32 neighbouring
// columns of one client row, or 32 neighbouring vectors of 2 or 4) and holds
// each column's C values in registers for the O(C^2) rank network (C <= 64;
// past that a (C, 128) shared tile), so the network reads no device memory;
// K1's row sums read its values back from a (C, cols) shared tile.  The Gram
// multiplies from register micro-tiles over double-buffered cp.async stages
// (past C ~ 50 it is bound by operations; robust_pipeline.cuh says how).
//
// Each entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.

#include "robust_pipeline.cuh"

extern "C" {

// x (G, C, N), mask (G, C) fp32 -> part (G, nblk, 2C+1) scratch, out (G,
// 2C+1) = [dots | sqnorms | refsq].  nblk: robust_pipeline.py:pass1_plan.
int rp_pass1(const float* x, const float* mask, float* part, float* out,
             int G, int C, int N, int nblk, void* stream) {
  return launch_pass1(DenseRows{x, N}, mask, part, out, G, C, N, nblk,
                      (cudaStream_t)stream);
}

// x (G, C, N), mask/w (G, C) fp32 -> out (G, N).  mode 0 mean, 1 trimmed, 2 median.
int rp_combine(const float* x, const float* mask, const float* w, float* out,
               int G, int C, int N, int cols, int mode, float trim_frac, void* stream) {
  return launch_combine(DenseRows{x, N}, mask, w, out, G, C, N, cols, mode,
                        trim_frac, (cudaStream_t)stream);
}

// x (G, C, N) fp32 -> part (G, ceil(N/chunk), C*C) scratch, out (G, C, C).
int rp_gram(const float* x, float* part, float* out, int G, int C, int N, int chunk,
            void* stream) {
  return launch_gram(DenseRows{x, N}, part, out, G, C, N, chunk,
                     (cudaStream_t)stream);
}

// seg[0 .. L-1] the leaves' device pointers, off[0 .. L] their first columns
// (off[0] = 0, off[L] = N), both host arrays read here; L <= kMaxSegs.
static int seg_rows(const float* const* seg, const int* off, int L, int N,
                    SegRows* s) {
  if (L < 1 || L > kMaxSegs || off[0] != 0 || off[L] != N)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < L; ++l) {
    if (off[l + 1] <= off[l]) return (int)cudaErrorInvalidValue;
    s->seg[l] = seg[l];
    s->off[l] = off[l];
  }
  s->off[L] = N;
  s->L = L;
  return 0;
}

int rp_pass1_seg(const float* const* seg, const int* off, int L,
                 const float* mask, float* part, float* out, int G, int C,
                 int N, int nblk, void* stream) {
  SegRows s;
  const int err = seg_rows(seg, off, L, N, &s);
  if (err) return err;
  return launch_pass1(s, mask, part, out, G, C, N, nblk, (cudaStream_t)stream);
}

int rp_combine_seg(const float* const* seg, const int* off, int L,
                   const float* mask, const float* w, float* out, int G, int C,
                   int N, int cols, int mode, float trim_frac, void* stream) {
  SegRows s;
  const int err = seg_rows(seg, off, L, N, &s);
  if (err) return err;
  return launch_combine(s, mask, w, out, G, C, N, cols, mode, trim_frac,
                        (cudaStream_t)stream);
}

int rp_gram_seg(const float* const* seg, const int* off, int L, float* part,
                float* out, int G, int C, int N, int chunk, void* stream) {
  SegRows s;
  const int err = seg_rows(seg, off, L, N, &s);
  if (err) return err;
  return launch_gram(s, part, out, G, C, N, chunk, (cudaStream_t)stream);
}

}  // extern "C"
