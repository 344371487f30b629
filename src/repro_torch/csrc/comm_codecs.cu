// Fused dequant-into-aggregation kernels for Hopper (sm_90a), plain C interface.
//
// Counterparts of the Pallas TPU kernels in src/repro/comm/kernels/comm_codecs.py:
//   cc_pass1   <- dequant_gate_partials      (K6a: K1 from int8 codes)
//   cc_combine <- dequant_gated_combine      (K6b: K2 from int8 codes)
//   cc_gram    <- dequant_pairwise_sq_dists  (K6c: the K3 Gram from int8 codes)
// They run the K1-K3 kernels of robust_pipeline.cuh with the QuantRows source:
// each element is a byte load of its int8 code times its fp32 block scale,
// found through the leaf table, and a masked-out row reads as 0.  So
//   K6x(q, s, table, mask) == K1-K3(where(mask, q * s, 0))   bitwise,
// the TPU package's bit-identity with decode-then-aggregate
// (comm_codecs.py:20-24), with masked-out rows zeroed.
//
// Bound at the main path's shape (G=1, C=16, N=421,642, NQ=3,297): 6.75 MB of
// codes and 0.21 MB of scales, about 2.1 us at 3.35 TB/s, a quarter of K1's
// bytes; the rank network's C^2 compares per column come to about as much on
// the fp32 units.  The design is K1-K3's: a thread owns 1, 2 or 4
// consecutive columns (pass 1: 2 in the 16-row bucket when N is even) and
// reads each row of them as one char / char2 / char4 load, the mask once a
// row; loads coalesced across a warp, one scale lookup per column (the Gram:
// per column and stage, its stages dequantized through registers).  Pass 1
// past 64 rows keeps one thread a column and three loads an element.
//
// Each entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.

#include "robust_pipeline.cuh"

extern "C" {

// q (G, C, N) int8, s (G, C, NQ) fp32, table (2L+2) int32, mask (G, C) fp32
// -> part (G, nblk, 2C+1) scratch, out (G, 2C+1) = [dots | sqnorms | refsq],
// with K1's plan (robust_pipeline.py:pass1_plan).
int cc_pass1(const int8_t* q, const float* s, const int* table, const float* mask,
             float* part, float* out, int G, int C, int N, int NQ, int L, int qblk,
             int nblk, void* stream) {
  return launch_pass1(QuantRows{q, s, table, mask, N, NQ, L, qblk}, mask, part,
                      out, G, C, N, nblk, (cudaStream_t)stream);
}

// ... mask/w (G, C) fp32 -> out (G, N).  mode 0 mean, 1 trimmed, 2 median.
int cc_combine(const int8_t* q, const float* s, const int* table, const float* mask,
               const float* w, float* out, int G, int C, int N, int NQ, int L,
               int qblk, int cols, int mode, float trim_frac, void* stream) {
  return launch_combine(QuantRows{q, s, table, mask, N, NQ, L, qblk}, mask, w, out,
                        G, C, N, cols, mode, trim_frac, (cudaStream_t)stream);
}

// ... -> part (G, ceil(N/chunk), C*C) scratch, out (G, C, C) Gram of the
// masked dequantized rows.
int cc_gram(const int8_t* q, const float* s, const int* table, const float* mask,
            float* part, float* out, int G, int C, int N, int NQ, int L, int qblk,
            int chunk, void* stream) {
  return launch_gram(QuantRows{q, s, table, mask, N, NQ, L, qblk}, part, out, G, C,
                     N, chunk, (cudaStream_t)stream);
}

}  // extern "C"
