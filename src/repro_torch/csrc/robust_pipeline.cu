// Robust Eq.-11 aggregation kernels for Hopper (sm_90a), plain C interface.
//
// Counterparts of the Pallas TPU kernels in src/repro/kernels/robust_pipeline.py:
//   rp_pass1   <- cosine_gate_partials_leafwise  (K1: masked coordinate median
//                 over the client axis by the stable-rank network, then
//                 sum_j x_ij*med_j, sum_j x_ij^2 and sum_j med_j^2)
//   rp_combine <- gated_combine_leafwise         (K2: mean | trimmed | median)
//   rp_gram    <- pairwise_sq_dists_leafwise     (K3: Gram matrix X X^T)
//
// Every kernel streams a (G, C, N) fp32 update matrix once.  On the TPU the
// grid runs in order and (C,) accumulators carry across steps; here blocks run
// in parallel, so each cross-block sum is written as per-block partials and
// summed by a second launch (reduce_partials) in a fixed order.  No float
// atomics: a run is bitwise repeatable.
//
// Bound at the main path's shape (G=1, C=16, N=421,642): each kernel reads the
// 27.0 MB matrix once, about 8 us at 3.35 TB/s; the rank network's C^2 compares
// per column and the Gram's C^2 FMAs per column stay under that on the fp32
// units.  The design keeps the loads coalesced (a warp reads 32 neighbouring
// columns of one client row) and holds the (C, cols) tile in shared memory so
// the O(C^2) network reads no device memory.  Speed beyond that (TMA, wgmma
// for the Gram) is later work.
//
// Each entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float kBig = 1e30f;        // masked-out rows rank past every real row
constexpr int kGramTK = 32;          // Gram tile depth (columns per smem stage)
constexpr int kGramThreads = 256;
constexpr int kReduceThreads = 256;  // 8 warps, one output each

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly over the 32 lanes: a fixed order, so the result is repeatable
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Stable rank of row i of one column: #{j: xm_j < xm_i} + #{j < i: xm_j == xm_i}
// where xm = x on masked-in rows and kBig elsewhere (robust_agg.stable_ranks).
__device__ __forceinline__ int stable_rank(const float* tile, int cols, int col,
                                           const float* m, int C, int i) {
  const float xi = m[i] > 0.f ? tile[i * cols + col] : kBig;
  int r = 0;
  for (int j = 0; j < C; ++j) {
    const float xj = m[j] > 0.f ? tile[j * cols + col] : kBig;
    r += (xj < xi) || (xj == xi && j < i);
  }
  return r;
}

// Masked coordinate median of one column: 0.5 * (x_lo*m_lo + x_hi*m_hi) for
// the rows of rank lo = floor((n-1)/2) and hi = ceil((n-1)/2), which is the
// TPU kernel's pick-and-sum (_median_block).  An empty cohort gives 0.
__device__ float column_median(const float* tile, int cols, int col,
                               const float* m, int C, float lo, float hi) {
  float v_lo = 0.f, v_hi = 0.f;
  for (int i = 0; i < C; ++i) {
    const float r = (float)stable_rank(tile, cols, col, m, C, i);
    const float v = tile[i * cols + col] * m[i];
    if (r == lo) v_lo = v;
    if (r == hi) v_hi = v;
  }
  return 0.5f * (v_lo + v_hi);
}

// Loads the (C, cols) tile of block `blk` and the cohort's mask into shared
// memory; columns past N read as 0.  Returns n = sum(mask).
__device__ float load_tile(const float* __restrict__ xg, const float* __restrict__ mg,
                           float* tile, float* m, int C, int N, int col0) {
  const int cols = blockDim.x, t = threadIdx.x, col = col0 + t;
  for (int i = t; i < C; i += cols) m[i] = mg[i];
  for (int i = 0; i < C; ++i)
    tile[i * cols + t] = col < N ? xg[(size_t)i * N + col] : 0.f;
  __syncthreads();
  float n = 0.f;
  for (int i = 0; i < C; ++i) n += m[i];
  return n;
}

// K1, pass 1: one thread per column.  Writes part[g, blk, :] =
// [sum_j x_ij*med_j (C) | sum_j x_ij^2 (C) | sum_j med_j^2 (1)] over the block.
__global__ void pass1_partials(const float* __restrict__ x, const float* __restrict__ mask,
                               float* __restrict__ part, int C, int N) {
  extern __shared__ float sm[];
  const int cols = blockDim.x, t = threadIdx.x;
  const int g = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  float* tile = sm;               // C * cols
  float* med = tile + C * cols;   // cols
  float* m = med + cols;          // C
  const float n = load_tile(x + (size_t)g * C * N, mask + (size_t)g * C, tile, m,
                            C, N, blk * cols);
  const float lo = floorf((n - 1.f) / 2.f), hi = ceilf((n - 1.f) / 2.f);
  med[t] = blk * cols + t < N ? column_median(tile, cols, t, m, C, lo, hi) : 0.f;
  __syncthreads();

  // rows i < C: (x_i . med, |x_i|^2); row C: |med|^2.  Warp w takes rows
  // w, w + nwarps, ...; lanes stride the block's columns.
  const int lane = t & 31, warp = t >> 5, nwarps = cols >> 5;
  float* pg = part + ((size_t)g * nblk + blk) * (2 * C + 1);
  for (int i = warp; i <= C; i += nwarps) {
    float a = 0.f, b = 0.f;
    for (int c = lane; c < cols; c += 32) {
      const float mc = med[c];
      if (i < C) {
        const float xv = tile[i * cols + c];
        a += xv * mc;
        b += xv * xv;
      } else {
        a += mc * mc;
      }
    }
    a = warp_sum(a);
    b = warp_sum(b);
    if (lane == 0) {
      if (i < C) {
        pg[i] = a;
        pg[C + i] = b;
      } else {
        pg[2 * C] = a;
      }
    }
  }
}

// K2, pass 2: one thread per column writes out[g, col].
// mode 0 = mean (sum_i w_i x_i), 1 = trimmed, 2 = median (_combine_block).
__global__ void gated_combine(const float* __restrict__ x, const float* __restrict__ mask,
                              const float* __restrict__ w, float* __restrict__ out,
                              int C, int N, int mode, float trim_frac) {
  extern __shared__ float sm[];
  const int cols = blockDim.x, t = threadIdx.x;
  const int g = blockIdx.y, col = blockIdx.x * cols + t;
  float* tile = sm;               // C * cols
  float* m = tile + C * cols;     // C
  float* wg = m + C;              // C
  for (int i = t; i < C; i += cols) wg[i] = w[(size_t)g * C + i];
  const float n = load_tile(x + (size_t)g * C * N, mask + (size_t)g * C, tile, m,
                            C, N, blockIdx.x * cols);
  if (col >= N) return;
  float r;
  if (mode == 0) {
    r = 0.f;
    for (int i = 0; i < C; ++i) r += tile[i * cols + t] * wg[i];
  } else if (mode == 1) {
    const float tr = floorf(trim_frac * n);
    float s = 0.f;
    for (int i = 0; i < C; ++i) {
      const float rk = (float)stable_rank(tile, cols, t, m, C, i);
      const float keep = (rk >= tr && rk < n - tr) ? m[i] : 0.f;
      s += tile[i * cols + t] * keep;
    }
    r = s / fmaxf(n - 2.f * tr, 1.f);
  } else {
    r = column_median(tile, cols, t, m, C, floorf((n - 1.f) / 2.f),
                      ceilf((n - 1.f) / 2.f));
  }
  out[(size_t)g * N + col] = r;
}

// K3: block (split s, cohort g) accumulates the C x C Gram of its column chunk
// in fp32 FMA (not TF32).  Thread o owns outputs o, o + 256, ... (R of them).
// The (C, TK) stage is padded to TK + 1 floats a row so the 32 lanes reading
// 32 different rows at one depth hit 32 different banks.
template <int R>
__global__ void gram_partials(const float* __restrict__ x, float* __restrict__ part,
                              int C, int N, int chunk) {
  extern __shared__ float tile[];  // C * (kGramTK + 1)
  const int g = blockIdx.y, s = blockIdx.x, t = threadIdx.x;
  const int c0 = s * chunk, c1 = min(c0 + chunk, N), CC = C * C;
  const float* xg = x + (size_t)g * C * N;
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  for (int k0 = c0; k0 < c1; k0 += kGramTK) {
    for (int e = t; e < C * kGramTK; e += blockDim.x) {
      const int i = e / kGramTK, k = e % kGramTK, col = k0 + k;
      tile[i * (kGramTK + 1) + k] = col < c1 ? xg[(size_t)i * N + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int o = t + r * blockDim.x;
      if (o < CC) {
        const float* a = tile + (o / C) * (kGramTK + 1);
        const float* b = tile + (o % C) * (kGramTK + 1);
        float v = acc[r];
#pragma unroll 8
        for (int k = 0; k < kGramTK; ++k) v = fmaf(a[k], b[k], v);
        acc[r] = v;
      }
    }
    __syncthreads();
  }
  float* pg = part + ((size_t)g * gridDim.x + s) * CC;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int o = t + r * blockDim.x;
    if (o < CC) pg[o] = acc[r];
  }
}

// part (G, P, M) -> out (G, M): one warp per output, lanes stride P in order.
__global__ void reduce_partials(const float* __restrict__ part, float* __restrict__ out,
                                int P, int M) {
  const int g = blockIdx.y, lane = threadIdx.x & 31;
  const int o = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (o >= M) return;  // whole warp leaves together
  const float* p = part + (size_t)g * P * M + o;
  float s = 0.f;
  for (int k = lane; k < P; k += 32) s += p[(size_t)k * M];
  s = warp_sum(s);
  if (lane == 0) out[(size_t)g * M + o] = s;
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes > 48 * 1024)
    return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)bytes);
  return 0;
}

void launch_reduce(const float* part, float* out, int G, int P, int M, cudaStream_t st) {
  const int warps = kReduceThreads / 32;
  dim3 grid((M + warps - 1) / warps, G);
  reduce_partials<<<grid, kReduceThreads, 0, st>>>(part, out, P, M);
}

}  // namespace

extern "C" {

// x (G, C, N), mask (G, C) fp32 -> part (G, ceil(N/cols), 2C+1) scratch,
// out (G, 2C+1) = [dots | sqnorms | refsq].  cols is a multiple of 32.
int rp_pass1(const float* x, const float* mask, float* part, float* out,
             int G, int C, int N, int cols, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = sizeof(float) * ((size_t)C * cols + cols + C);
  int err = set_smem((const void*)pass1_partials, smem);
  if (err) return err;
  const int nblk = (N + cols - 1) / cols;
  pass1_partials<<<dim3(nblk, G), cols, smem, st>>>(x, mask, part, C, N);
  launch_reduce(part, out, G, nblk, 2 * C + 1, st);
  return (int)cudaGetLastError();
}

// x (G, C, N), mask/w (G, C) fp32 -> out (G, N).  mode 0 mean, 1 trimmed, 2 median.
int rp_combine(const float* x, const float* mask, const float* w, float* out,
               int G, int C, int N, int cols, int mode, float trim_frac, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = sizeof(float) * ((size_t)C * cols + 2 * C);
  int err = set_smem((const void*)gated_combine, smem);
  if (err) return err;
  const int nblk = (N + cols - 1) / cols;
  gated_combine<<<dim3(nblk, G), cols, smem, st>>>(x, mask, w, out, C, N, mode,
                                                    trim_frac);
  return (int)cudaGetLastError();
}

// x (G, C, N) fp32 -> part (G, ceil(N/chunk), C*C) scratch, out (G, C, C).
// C <= 64 (at most 16 accumulators a thread).
int rp_gram(const float* x, float* part, float* out, int G, int C, int N, int chunk,
            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nsplit = (N + chunk - 1) / chunk;
  const size_t smem = sizeof(float) * (size_t)C * (kGramTK + 1);
  const dim3 grid(nsplit, G);
  const int per = (C * C + kGramThreads - 1) / kGramThreads;
  if (per <= 1)
    gram_partials<1><<<grid, kGramThreads, smem, st>>>(x, part, C, N, chunk);
  else if (per <= 4)
    gram_partials<4><<<grid, kGramThreads, smem, st>>>(x, part, C, N, chunk);
  else if (per <= 16)
    gram_partials<16><<<grid, kGramThreads, smem, st>>>(x, part, C, N, chunk);
  else
    return (int)cudaErrorInvalidValue;
  launch_reduce(part, out, G, nsplit, C * C, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
