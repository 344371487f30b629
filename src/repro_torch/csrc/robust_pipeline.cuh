// Robust Eq.-11 aggregation on Hopper (sm_90a): the device code both kernel
// families share.
//
// The kernels are templated on a row source, which says how element (row r,
// column col) of the (G*C, N) client matrix is read:
//   DenseRows  fp32 rows, one load                (K1-K3, robust_pipeline.cu)
//   QuantRows  int8 codes times their fp32 block  (K6a-c, comm_codecs.cu)
//              scale, found through the leaf table;
//              a masked-out row reads as 0
// Everything after the load (stable_rank, column_median, the pass-1 partial
// sums, gated_combine's three modes, gram_partials, reduce_partials) is one
// copy.  So K6 on (codes, scales, mask) is bitwise K1-K3 on the fp32 matrix
// where(mask, q * s, 0), by construction.
//
// Every kernel streams its matrix once.  On the TPU the grid runs in order and
// (C,) accumulators carry across steps; here blocks run in parallel, so each
// cross-block sum is written as per-block partials and summed by a second
// launch (reduce_partials) in a fixed order.  No float atomics: a run is
// bitwise repeatable.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;        // masked-out rows rank past every real row
constexpr int kGramTK = 32;          // Gram tile depth (columns per smem stage)
constexpr int kGramTile = 64;        // Gram output tile: at most 64 x 64 a block
constexpr int kGramThreads = 256;
constexpr int kReduceThreads = 256;  // 8 warps, one output each

// fp32 rows: x (G*C, N).
struct DenseRows {
  const float* __restrict__ x;
  int N;
  __device__ __forceinline__ int scale_col(int) const { return 0; }
  __device__ __forceinline__ float load(size_t r, int col, int) const {
    return x[r * N + col];
  }
};

// int8 codes q (G*C, N) and fp32 scales s (G*C, NQ), laid out leaf after leaf
// (comm/codecs.py WireLayout).  table = [off_0 .. off_L, soff_0 .. soff_L]:
// column j of leaf l (off_l <= j < off_{l+1}) has its scale in column
// soff_l + (j - off_l) / qblk, so quant blocks restart at every leaf.  The
// dequant is the one fp32 multiply of codecs.quant_decode.  A row whose mask
// is 0 reads as 0: a scale of inf (a non-finite client) would make 0 * inf =
// NaN reach the sums even at weight 0.
struct QuantRows {
  const int8_t* __restrict__ q;
  const float* __restrict__ s;
  const int* __restrict__ table;
  const float* __restrict__ mask;    // (G*C,)
  int N, NQ, L, qblk;
  __device__ __forceinline__ int scale_col(int col) const {
    int lo = 0, hi = L - 1;          // the last leaf l with off_l <= col
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (__ldg(table + mid) <= col) lo = mid; else hi = mid - 1;
    }
    return __ldg(table + L + 1 + lo) + (col - __ldg(table + lo)) / qblk;
  }
  __device__ __forceinline__ float load(size_t r, int col, int sc) const {
    if (!(mask[r] > 0.f)) return 0.f;
    return (float)q[r * N + col] * s[r * NQ + sc];
  }
};

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

// Loads cohort g's (C, cols) tile of block col0 and its mask into shared
// memory; columns past N read as 0.  Returns n = sum(mask).
template <class Src>
__device__ float load_tile(const Src& src, int g, const float* __restrict__ mg,
                           float* tile, float* m, int C, int N, int col0) {
  const int cols = blockDim.x, t = threadIdx.x, col = col0 + t;
  for (int i = t; i < C; i += cols) m[i] = mg[i];
  const int sc = col < N ? src.scale_col(col) : 0;
  for (int i = 0; i < C; ++i)
    tile[i * cols + t] = col < N ? src.load((size_t)g * C + i, col, sc) : 0.f;
  __syncthreads();
  float n = 0.f;
  for (int i = 0; i < C; ++i) n += m[i];
  return n;
}

// K1/K6a, pass 1: one thread per column.  Writes part[g, blk, :] =
// [sum_j x_ij*med_j (C) | sum_j x_ij^2 (C) | sum_j med_j^2 (1)] over the block.
template <class Src>
__global__ void pass1_partials(Src src, const float* __restrict__ mask,
                               float* __restrict__ part, int C, int N) {
  extern __shared__ float sm[];
  const int cols = blockDim.x, t = threadIdx.x;
  const int g = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  float* tile = sm;               // C * cols
  float* med = tile + C * cols;   // cols
  float* m = med + cols;          // C
  const float n = load_tile(src, g, mask + (size_t)g * C, tile, m, C, N, blk * cols);
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

// K2/K6b, pass 2: one thread per column writes out[g, col].
// mode 0 = mean (sum_i w_i x_i), 1 = trimmed, 2 = median (_combine_block).
template <class Src>
__global__ void gated_combine(Src src, const float* __restrict__ mask,
                              const float* __restrict__ w, float* __restrict__ out,
                              int C, int N, int mode, float trim_frac) {
  extern __shared__ float sm[];
  const int cols = blockDim.x, t = threadIdx.x;
  const int g = blockIdx.y, col = blockIdx.x * cols + t;
  float* tile = sm;               // C * cols
  float* m = tile + C * cols;     // C
  float* wg = m + C;              // C
  for (int i = t; i < C; i += cols) wg[i] = w[(size_t)g * C + i];
  const float n = load_tile(src, g, mask + (size_t)g * C, tile, m, C, N,
                            blockIdx.x * cols);
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

// K3/K6c: block (split s, output tile y, cohort g) accumulates one tile of the
// C x C Gram of its column chunk in fp32 FMA (not TF32).  A tile is rows
// [i0, i0 + ni) x columns [j0, j0 + nj) of the Gram, ni, nj <= kGramTile, so any
// C runs.  The Gram is symmetric, so only tiles with i0 <= j0 are launched and
// an off-diagonal tile writes each output at (i, j) and (j, i); fmaf(a, b, v)
// is fmaf(b, a, v) exactly, so the mirror is the value the (j, i) tile would
// have computed.  For C <= kGramTile there is one tile and local output o is
// Gram entry (o / C, o % C).  Thread t owns local outputs t, t + 256, ... (R of
// them).  The (rows, TK) stages are padded to TK + 1 floats a row so the 32
// lanes reading 32 different rows at one depth hit 32 different banks; a
// diagonal tile reads one stage twice.  Each output is one fmaf chain over its
// chunk in column order, whatever the tiling.
template <int R, class Src>
__global__ void gram_partials(Src src, float* __restrict__ part, int C, int N,
                              int chunk) {
  __shared__ float stage_i[kGramTile * (kGramTK + 1)];
  __shared__ float stage_j[kGramTile * (kGramTK + 1)];
  const int s = blockIdx.x, g = blockIdx.z, t = threadIdx.x;
  const int nt = (C + kGramTile - 1) / kGramTile;
  int ti = 0, rem = blockIdx.y;  // y -> upper-triangle tile (ti, ti + rem)
  while (rem >= nt - ti) {
    rem -= nt - ti;
    ++ti;
  }
  const int i0 = ti * kGramTile, j0 = (ti + rem) * kGramTile;
  const int ni = min(kGramTile, C - i0), nj = min(kGramTile, C - j0);
  const bool diag = i0 == j0;
  const float* sj = diag ? stage_i : stage_j;
  const int rows = diag ? ni : max(ni, nj);
  const int c0 = s * chunk, c1 = min(c0 + chunk, N), CC = C * C;
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  for (int k0 = c0; k0 < c1; k0 += kGramTK) {
    for (int e = t; e < rows * kGramTK; e += blockDim.x) {
      const int i = e / kGramTK, k = e % kGramTK, col = k0 + k;
      const int sc = col < c1 ? src.scale_col(col) : 0;
      if (i < ni)
        stage_i[i * (kGramTK + 1) + k] =
            col < c1 ? src.load((size_t)g * C + i0 + i, col, sc) : 0.f;
      if (!diag && i < nj)
        stage_j[i * (kGramTK + 1) + k] =
            col < c1 ? src.load((size_t)g * C + j0 + i, col, sc) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int o = t + r * blockDim.x;
      if (o < ni * nj) {
        const float* a = stage_i + (o / nj) * (kGramTK + 1);
        const float* b = sj + (o % nj) * (kGramTK + 1);
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
    if (o < ni * nj) {
      const int i = i0 + o / nj, j = j0 + o % nj;
      pg[(size_t)i * C + j] = acc[r];
      if (!diag) pg[(size_t)j * C + i] = acc[r];
    }
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

// The launches behind the C entry points, one per pass, for either source.
// Each returns cudaGetLastError().

// mask (G, C) -> part (G, ceil(N/cols), 2C+1) scratch, out (G, 2C+1) =
// [dots | sqnorms | refsq].  cols is a multiple of 32.
template <class Src>
int launch_pass1(Src src, const float* mask, float* part, float* out, int G, int C,
                 int N, int cols, cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)C * cols + cols + C);
  int err = set_smem((const void*)pass1_partials<Src>, smem);
  if (err) return err;
  const int nblk = (N + cols - 1) / cols;
  pass1_partials<Src><<<dim3(nblk, G), cols, smem, st>>>(src, mask, part, C, N);
  launch_reduce(part, out, G, nblk, 2 * C + 1, st);
  return (int)cudaGetLastError();
}

// mask/w (G, C) -> out (G, N).  mode 0 mean, 1 trimmed, 2 median.
template <class Src>
int launch_combine(Src src, const float* mask, const float* w, float* out, int G,
                   int C, int N, int cols, int mode, float trim_frac, cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)C * cols + 2 * C);
  int err = set_smem((const void*)gated_combine<Src>, smem);
  if (err) return err;
  const int nblk = (N + cols - 1) / cols;
  gated_combine<Src><<<dim3(nblk, G), cols, smem, st>>>(src, mask, w, out, C, N, mode,
                                                         trim_frac);
  return (int)cudaGetLastError();
}

// -> part (G, ceil(N/chunk), C*C) scratch, out (G, C, C).  Any C whose
// nt (nt + 1) / 2 upper-triangle tiles, nt = ceil(C/64), fit the grid's y axis
// (C <= 23,104).
template <class Src>
int launch_gram(Src src, float* part, float* out, int G, int C, int N, int chunk,
                cudaStream_t st) {
  const int nsplit = (N + chunk - 1) / chunk;
  const int nt = (C + kGramTile - 1) / kGramTile;
  const int ntiles = nt * (nt + 1) / 2;
  if (ntiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(nsplit, ntiles, G);
  const int side = min(C, kGramTile);
  const int per = (side * side + kGramThreads - 1) / kGramThreads;
  if (per <= 1)
    gram_partials<1, Src><<<grid, kGramThreads, 0, st>>>(src, part, C, N, chunk);
  else if (per <= 4)
    gram_partials<4, Src><<<grid, kGramThreads, 0, st>>>(src, part, C, N, chunk);
  else
    gram_partials<16, Src><<<grid, kGramThreads, 0, st>>>(src, part, C, N, chunk);
  launch_reduce(part, out, G, nsplit, C * C, st);
  return (int)cudaGetLastError();
}

}  // namespace
