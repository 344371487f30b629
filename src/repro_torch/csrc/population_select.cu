// Blocked top-d of the population's Gumbel keys for Hopper (sm_90a), plain C
// interface.
//
// Counterpart of the Pallas TPU kernel in src/repro/kernels/population_select.py:
//   ps_block_topd <- topd_pallas (K7, body _block_topd_body): for each block of
//                    blk keys, the block's top-d by d rounds of max-and-mask,
//                    written as d values and their global indices in
//                    extraction order.
// The merge of the nb*d candidates (stage 2) stays a stable sort in torch, as
// it stays an XLA top_k in the JAX package.
//
// Semantics, held bitwise against the plain version (population_select.py's
// block_topd_plain, torch.argmax rounds): each round takes the first maximum
// of the block (the lowest index among equal keys, as jnp.argmax does), then
// sets that key to -inf.  A block whose finite keys are used up (the padded
// last block, or a block with fewer than d finite keys) keeps picking the
// lowest index among its -inf keys, which after the first such round is the
// block's first key: its candidates repeat index b*blk with value -inf, as
// the TPU kernel's do.  Keys are finite or -inf (log priorities plus Gumbel
// noise, and the -inf padding); NaN keys are outside the contract.
//
// Bound: bytes.  The kernel reads each key once (4 B) and writes 8 B per
// candidate: at M = 10^6, d = 64 that is 4.14 MB, 1.24 us at 3.35 TB/s; the
// d * M compares come to 0.96 us on the fp32 units.  Design, the simple one:
// one block of 256 threads per segment loads the segment into shared memory
// (16 KB at blk = 4096); each of the d rounds is a strided scan per thread
// for (max, lowest index), a warp-shuffle reduction, one shared-memory pass
// over the 8 warp winners, and one thread writing the pair and masking the
// key.  Blocks are independent, so there are no atomics and no second pass.
// The d rounds are serial and latency-bound (two barriers each), so the
// kernel sits far above its bound; keeping each thread's running maximum in
// registers, or a bitonic top-d, is later work.
//
// The entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// (v, i) beats (bv, bi): a larger key, or an equal key at a lower index.
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kThreads)
block_topd_kernel(const float* __restrict__ g, float* __restrict__ vals,
                  int* __restrict__ idx, int blk, int d) {
  extern __shared__ float keys[];             // blk
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  const int b = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* src = g + (size_t)b * blk;
  for (int j = t; j < blk; j += kThreads) keys[j] = src[j];
  __syncthreads();

  for (int r = 0; r < d; ++r) {
    float bv = -INFINITY;
    int bi = INT_MAX;                          // -inf at any index beats it
    for (int j = t; j < blk; j += kThreads) {
      const float v = keys[j];
      if (beats(v, j, bv, bi)) { bv = v; bi = j; }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (beats(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) { warp_v[warp] = bv; warp_i[warp] = bi; }
    __syncthreads();
    if (t == 0) {
      for (int w = 1; w < kWarps; ++w)
        if (beats(warp_v[w], warp_i[w], bv, bi)) { bv = warp_v[w]; bi = warp_i[w]; }
      vals[(size_t)b * d + r] = bv;
      idx[(size_t)b * d + r] = b * blk + bi;
      keys[bi] = -INFINITY;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// g (nb * blk) fp32 keys, padded with -inf -> vals (nb, d) fp32, idx (nb, d)
// int32 global indices.  Shared memory: 4 * blk bytes.
int ps_block_topd(const float* g, float* vals, int* idx, int nb, int blk, int d,
                  void* stream) {
  const size_t smem = sizeof(float) * (size_t)blk;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        block_topd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  block_topd_kernel<<<nb, kThreads, smem, (cudaStream_t)stream>>>(g, vals, idx,
                                                                   blk, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
