// Robust Eq.-11 aggregation on Hopper (sm_90a): the device code both kernel
// families share.
//
// The kernels are templated on a row source, which says how element (row r,
// column col) of the (G*C, N) client matrix is read:
//   DenseRows  fp32 rows, one load                (K1-K3, robust_pipeline.cu)
//   SegRows    fp32 leaves side by side, each its (K1-K3 on a tree,
//              own (G*C, n_l) matrix, found       robust_pipeline.cu)
//              through the segment table
//   QuantRows  int8 codes times their fp32 block  (K6a-c, comm_codecs.cu)
//              scale, found through the leaf table;
//              a masked-out row reads as 0
// Everything after the load (the rank networks, the pass-1 partial sums, the
// combine's three modes, gram_partials, reduce_partials) is one copy.  So K6
// on (codes, scales, mask) is bitwise K1-K3 on the fp32 matrix
// where(mask, q * s, 0), and K1-K3 on a tree's leaves bitwise K1-K3 on their
// concatenation, by construction.
//
// Every kernel streams its matrix once.  On the TPU the grid runs in order and
// (C,) accumulators carry across steps; here blocks run in parallel, so each
// cross-block sum is written as per-block partials and summed by a second
// launch (reduce_partials) in a fixed order.  No float atomics: a run is
// bitwise repeatable.
//
// The combine (K2 / K4b / K5 / K6b) is bound by bytes: one read of the
// (C, N) matrix, one write of the row.  Its design: a thread owns V
// consecutive columns (V = 4, 2 or 1, the widest that divides N, so that
// every row's vector loads are aligned, N being each row's stride) and
// holds them in registers, with no shared tile and no barrier.  The mean
// streams the rows, kMeanRows loads in flight a thread.  Trimmed and median
// load the column's C values once and rank them from registers in a
// network unrolled over a bucket of 16, 32 or 64 rows (rows past C skipped
// by a predicate); past 64 rows they keep the (C, cols) shared tile.  Each
// output is the same arithmetic in the same order on every path, so K4b
// and K5 are bitwise K2 and K6b bitwise K2 on the masked decode.
//
// Pass 1 (K1 / K4a / K6a) is the median of the combine and then 2C + 1 sums
// over N.  Its design for C <= 64 (pass1_ranks): a thread owns V columns (2
// in the 16-row bucket when N is even, else 1), reads each row's V values
// once (one vector load, the mask once a row) and ranks its columns from
// registers as the combine does; the values also go to a (C, cols) shared
// tile, from which a block adds its 2C + 1 row sums in a fixed order.  Past
// 64 rows the (C, 128) tile and stable_rank (pass1_partials).  The plan
// depends on (C, N) alone, so K6a adds in K1's order whatever the alignment.
// 256 threads a block, not 128: ptxas then gives the 16-row int8 body with
// one column a thread 40 registers and no spill (at 128 it capped it at 32
// and spilled 4 B), and on an H100 the 16-row body ran 10% faster.
//
// The Gram (gram_partials, K3 / K4c / K6c) is bound by operations on the
// fp32 units past C ~ 50 (C (C + 1) / 2 FMAs a column against 4 C bytes) and
// by bytes at C = 16.  Its design: 64-thread blocks, one upper-triangle
// output tile of 16 x 16 (C <= 16) or 32 x 32 each, a 2 x 2 or 4 x 4 register
// micro-tile a thread fed by float4 reads of double-buffered shared-memory
// stages, and column chunks sized by robust_pipeline.py:gram_split to fill
// the card (at least 2 waves of blocks at the main path's shapes).  A thread
// sums each 64 columns from zero and adds that to its running sum, so no
// fp32 chain is longer than 64 or its chunk over 64: one chain over a whole
// chunk (121,600 columns at 6.4e7 on 132 SMs) drifts with its growing
// partial sum, 2.2e-5 of the largest Gram entry, where the plain version's
// 8,192-column steps stay near 2e-6.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;        // masked-out rows rank past every real row
constexpr int kGramThreads = 64;     // a Gram block: 8 x 8 threads
constexpr int kReduceThreads = 256;  // 8 warps, one output each
constexpr int kMeanRows = 4;         // row loads a mean thread has in flight
constexpr int kPass1Threads = 256;   // a pass-1 block on the register path
constexpr int kPass1TileCols = 128;  // a pass-1 block on the shared tile

// fp32 rows: x (G*C, N).  kAsync: the Gram stages them by cp.async.
struct DenseRows {
  static constexpr bool kAsync = true;
  const float* __restrict__ x;
  int N;
  __device__ __forceinline__ int scale_col(int) const { return 0; }
  __device__ __forceinline__ float load(size_t r, int col, int) const {
    return x[r * N + col];
  }
  __device__ __forceinline__ const float* at(size_t r, int col) const {
    return x + r * N + col;
  }
  __device__ __forceinline__ bool live(size_t) const { return true; }
  // V consecutive columns from col (col % V == 0, N % V == 0)
  template <int V>
  __device__ __forceinline__ void load_vec(size_t r, int col, const int*,
                                           float* v) const {
    const float* p = x + r * N + col;
    if constexpr (V == 4) {
      const float4 t = *reinterpret_cast<const float4*>(p);
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else if constexpr (V == 2) {
      const float2 t = *reinterpret_cast<const float2*>(p);
      v[0] = t.x; v[1] = t.y;
    } else {
      v[0] = *p;
    }
  }
  // the same, for a row whose mask the caller has tested (fp32 rows read
  // their values either way)
  template <int V>
  __device__ __forceinline__ void load_vec(size_t r, int col, const int* sc,
                                           bool, float* v) const {
    load_vec<V>(r, col, sc, v);
  }
  bool aligned(int V) const { return (uintptr_t)x % (4 * V) == 0; }
};

// fp32 leaves side by side: column col of the (G*C, N) matrix lies in leaf l
// (off[l] <= col < off[l+1]), a contiguous (G*C, off[l+1] - off[l]) matrix
// at seg[l].  The table travels in the kernel's parameters (no copy to the
// device, so a launch can be captured in a CUDA graph), L <= kMaxSegs.  A
// thread's V columns are one vector load where they lie in one leaf and its
// row is aligned to the vector, else V scalar loads (a leaf of odd width
// shifts the alignment from row to row): the values the concatenated matrix
// holds either way.
constexpr int kMaxSegs = 64;
struct SegRows {
  static constexpr bool kAsync = false;
  const float* seg[kMaxSegs];
  int off[kMaxSegs + 1];
  int L;
  // the leaf of column col: the last l with off[l] <= col
  __device__ __forceinline__ int scale_col(int col) const {
    int lo = 0, hi = L - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (off[mid] <= col) lo = mid; else hi = mid - 1;
    }
    return lo;
  }
  __device__ __forceinline__ float value(size_t r, int col, int l) const {
    return __ldg(seg[l] + r * (size_t)(off[l + 1] - off[l]) + (col - off[l]));
  }
  __device__ __forceinline__ float load(size_t r, int col, int l) const {
    return value(r, col, l);
  }
  __device__ __forceinline__ bool live(size_t) const { return true; }
  template <int V>
  __device__ __forceinline__ void load_vec(size_t r, int col, const int* sc,
                                           float* v) const {
    const int l = sc[0];
    const float* p = seg[l] + r * (size_t)(off[l + 1] - off[l]) + (col - off[l]);
    if constexpr (V > 1) {
      if (sc[V - 1] == l && (uintptr_t)p % (4 * V) == 0) {
        if constexpr (V == 4) {
          const float4 t = *reinterpret_cast<const float4*>(p);
          v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
        } else {
          const float2 t = *reinterpret_cast<const float2*>(p);
          v[0] = t.x; v[1] = t.y;
        }
        return;
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = value(r, col + k, sc[k]);
  }
  template <int V>
  __device__ __forceinline__ void load_vec(size_t r, int col, const int* sc,
                                           bool, float* v) const {
    load_vec<V>(r, col, sc, v);
  }
  // the vector path is picked a load at a time, above
  bool aligned(int) const { return true; }
};

// int8 codes q (G*C, N) and fp32 scales s (G*C, NQ), laid out leaf after leaf
// (comm/codecs.py WireLayout).  table = [off_0 .. off_L, soff_0 .. soff_L]:
// column j of leaf l (off_l <= j < off_{l+1}) has its scale in column
// soff_l + (j - off_l) / qblk, so quant blocks restart at every leaf.  The
// dequant is the one fp32 multiply of codecs.quant_decode.  A row whose mask
// is 0 reads as 0: a scale of inf (a non-finite client) would make 0 * inf =
// NaN reach the sums even at weight 0.
struct QuantRows {
  static constexpr bool kAsync = false;
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
    if (!live(r)) return 0.f;
    return value(r, col, sc);
  }
  __device__ __forceinline__ bool live(size_t r) const { return mask[r] > 0.f; }
  // the element of a row known to be masked in
  __device__ __forceinline__ float value(size_t r, int col, int sc) const {
    return (float)q[r * N + col] * s[r * NQ + sc];
  }
  // V consecutive columns from col, column k's scale in column sc[k]: value()
  // of each, one char4 / char2 load of the codes
  // (branch-free, so that a thread's row loads all issue before their use;
  // a masked-out row's codes and scales are read and dropped)
  template <int V>
  __device__ __forceinline__ void load_vec(size_t r, int col, const int* sc,
                                           float* v) const {
    load_vec<V>(r, col, sc, live(r), v);
  }
  // the same, for a row whose mask test `on` the caller has made
  template <int V>
  __device__ __forceinline__ void load_vec(size_t r, int col, const int* sc,
                                           bool on, float* v) const {
    const int8_t* p = q + r * N + col;
    float c[V];
    if constexpr (V == 4) {
      const char4 t = *reinterpret_cast<const char4*>(p);
      c[0] = (float)t.x; c[1] = (float)t.y; c[2] = (float)t.z; c[3] = (float)t.w;
    } else if constexpr (V == 2) {
      const char2 t = *reinterpret_cast<const char2*>(p);
      c[0] = (float)t.x; c[1] = (float)t.y;
    } else {
      c[0] = (float)*p;
    }
    const float* sr = s + r * NQ;
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = on ? c[k] * sr[sc[k]] : 0.f;
  }
  bool aligned(int V) const { return (uintptr_t)q % V == 0; }
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

// Pass 1's row sums over a block's (C, cols) tile and its median row:
// pg = [sum_c x_ic*med_c (C) | sum_c x_ic^2 (C) | sum_c med_c^2 (1)].  Warp
// w takes rows w, w + nwarps, ... (row C: |med|^2); lane l adds columns
// l, l + 32, ... in order, then warp_sum: an order set by cols alone.
__device__ __forceinline__ void pass1_row_sums(const float* tile,
                                               const float* med, int cols,
                                               int C, float* __restrict__ pg) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
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

// K1/K6a, pass 1 past 64 rows: one thread per column ranks it from the (C,
// cols) shared tile.  Writes part[g, blk, :] (pass1_row_sums).
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
  pass1_row_sums(tile, med, cols, C,
                 part + ((size_t)g * nblk + blk) * (2 * C + 1));
}

// K2/K6b trimmed (mode 1) and median (mode 2) past 64 rows, from the (C,
// cols) shared tile: one thread per column writes out[g, col]
// (_combine_block).
template <class Src>
__global__ void combine_tile(Src src, const float* __restrict__ mask,
                             float* __restrict__ out, int C, int N, int mode,
                             float trim_frac) {
  extern __shared__ float sm[];
  const int cols = blockDim.x, t = threadIdx.x;
  const int g = blockIdx.y, col = blockIdx.x * cols + t;
  float* tile = sm;               // C * cols
  float* m = tile + C * cols;     // C
  const float n = load_tile(src, g, mask + (size_t)g * C, tile, m, C, N,
                            blockIdx.x * cols);
  if (col >= N) return;
  float r;
  if (mode == 1) {
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

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// K2/K6b mean (mode 0): a thread owns V consecutive columns and streams the
// C rows through registers, r += x_i * w_i in row order.
template <class Src, int V>
__global__ void combine_mean(Src src, const float* __restrict__ w,
                             float* __restrict__ out, int C, int N) {
  const int g = blockIdx.y;
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (col >= N) return;
  int sc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) sc[k] = src.scale_col(col + k);
  const float* wg = w + (size_t)g * C;
  const size_t row0 = (size_t)g * C;
  float r[V];
#pragma unroll
  for (int k = 0; k < V; ++k) r[k] = 0.f;
  for (int i0 = 0; i0 < C; i0 += kMeanRows) {
    float xv[kMeanRows][V];
#pragma unroll
    for (int u = 0; u < kMeanRows; ++u)
      if (i0 + u < C) src.template load_vec<V>(row0 + i0 + u, col, sc, xv[u]);
#pragma unroll
    for (int u = 0; u < kMeanRows; ++u)
      if (i0 + u < C) {
        const float wi = __ldg(wg + i0 + u);
#pragma unroll
        for (int k = 0; k < V; ++k) r[k] += xv[u][k] * wi;
      }
  }
  store_vec<V>(out + (size_t)g * N + col, r);
}

// stable_rank from registers: row i's rank among xm[0 .. C-1]; B and i are
// compile-time after unrolling, so j < i is too.  FULL: C == B, so no row
// needs the j < C predicate.
template <int B, bool FULL>
__device__ __forceinline__ int register_rank(const float (&xm)[B], int i, int C) {
  const float xi = xm[i];
  int r = 0;
#pragma unroll
  for (int j = 0; j < B; ++j)
    if (FULL || j < C) r += j < i ? (xm[j] <= xi) : (xm[j] < xi);
  return r;
}

// K2/K6b trimmed (mode 1) and median (mode 2) for C <= B: a thread owns V
// consecutive columns, loads their C values and the mask once into
// registers and ranks each column there, as stable_rank and column_median
// do from the tile.
template <class Src, int B, int V, bool FULL>
__global__ void combine_ranks(Src src, const float* __restrict__ mask,
                              float* __restrict__ out, int C, int N, int mode,
                              float trim_frac) {
  const int g = blockIdx.y;
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (col >= N) return;
  int sc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) sc[k] = src.scale_col(col + k);
  const float* mg = mask + (size_t)g * C;
  const size_t row0 = (size_t)g * C;
  float x[B][V], mk[B];
  float n = 0.f;
#pragma unroll
  for (int j = 0; j < B; ++j) {
    if (FULL || j < C) {
      mk[j] = __ldg(mg + j);
      src.template load_vec<V>(row0 + j, col, sc, x[j]);
    } else {
      mk[j] = 0.f;
#pragma unroll
      for (int k = 0; k < V; ++k) x[j][k] = 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < B; ++j)
    if (FULL || j < C) n += mk[j];
  const float tr = floorf(trim_frac * n);
  const float lo = floorf((n - 1.f) / 2.f), hi = ceilf((n - 1.f) / 2.f);
  float r[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float xm[B];                     // x on masked-in rows, kBig elsewhere
#pragma unroll
    for (int j = 0; j < B; ++j)
      xm[j] = (FULL || j < C) && mk[j] > 0.f ? x[j][k] : kBig;
    int rk[B];
#pragma unroll
    for (int i = 0; i < B; ++i)
      rk[i] = FULL || i < C ? register_rank<B, FULL>(xm, i, C) : 0;
    if (mode == 1) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < B; ++i)
        if (FULL || i < C) {
          const float rf = (float)rk[i];
          const float keep = (rf >= tr && rf < n - tr) ? mk[i] : 0.f;
          acc += x[i][k] * keep;
        }
      r[k] = acc / fmaxf(n - 2.f * tr, 1.f);
    } else {
      float v_lo = 0.f, v_hi = 0.f;
#pragma unroll
      for (int i = 0; i < B; ++i)
        if (FULL || i < C) {
          const float rf = (float)rk[i];
          const float v = x[i][k] * mk[i];
          if (rf == lo) v_lo = v;
          if (rf == hi) v_hi = v;
        }
      r[k] = 0.5f * (v_lo + v_hi);
    }
  }
  store_vec<V>(out + (size_t)g * N + col, r);
}

// V consecutive columns of row r from col: one vector load (VEC), or V
// scalar loads where the rows are not aligned to the vector.  The values
// are the same either way.
template <int V, bool VEC, class Src>
__device__ __forceinline__ void load_cols(const Src& src, size_t r, int col,
                                          const int* sc, bool on, float* v) {
  if constexpr (VEC) {
    src.template load_vec<V>(r, col, sc, on, v);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k)
      src.template load_vec<1>(r, col + k, sc + k, on, v + k);
  }
}

// K1/K6a, pass 1 for C <= B (B = 16, 32 or 64): thread t owns the V
// consecutive columns c0 = t V .. of the block's kCols.  It reads each row's
// V values once (load_cols; the mask once a row, rows past C reading row C-1
// unconditionally, so that every load is in flight before its use) and stores
// them to the (C, kCols) shared tile.  Each column is ranked from
// registers: xm holds x on masked-in rows, kBig on masked-out rows and +inf
// on rows C .. B-1, which add to no row's rank (+inf < x is never true), so
// register_rank<B, true> gives row i < C the rank stable_rank gives it.  The
// median is 0.5 * (x_lo*m_lo + x_hi*m_hi) of the last rows ranked lo and hi,
// as column_median and combine_ranks compute it, so it is bitwise theirs;
// then the block's row sums (pass1_row_sums) over the tile.
template <class Src, int B, int V, bool VEC>
__global__ void __launch_bounds__(kPass1Threads)
pass1_ranks(Src src, const float* __restrict__ mask, float* __restrict__ part,
            int C, int N) {
  constexpr int kCols = V * kPass1Threads;
  extern __shared__ float sm[];
  float* tile = sm;                   // C * kCols
  float* med = tile + C * kCols;      // kCols
  const int t = threadIdx.x, g = blockIdx.y, blk = blockIdx.x;
  const int c0 = t * V, col = blk * kCols + c0;
  const bool in = col < N;            // N % V == 0: all V columns or none
  const int lc = in ? col : 0;        // a thread past N loads column 0
  const float* mg = mask + (size_t)g * C;
  const size_t row0 = (size_t)g * C;
  int sc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) sc[k] = src.scale_col(lc + k);
  float xm[V][B];
  float n = 0.f;
#pragma unroll
  for (int j = 0; j < B; ++j) {
    const int jr = j < C ? j : C - 1;
    const float mj = __ldg(mg + jr);
    float v[V];
    load_cols<V, VEC>(src, row0 + jr, lc, sc, mj > 0.f, v);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      v[k] = in ? v[k] : 0.f;
      xm[k][j] = j >= C ? INFINITY : mj > 0.f ? v[k] : kBig;
    }
    if (j < C) {
      n += mj;
      store_vec<V>(tile + j * kCols + c0, v);
    }
  }
  const float lo = floorf((n - 1.f) / 2.f), hi = ceilf((n - 1.f) / 2.f);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    int ilo = -1, ihi = -1;
#pragma unroll
    for (int i = 0; i < B; ++i)
      if (i < C) {
        const float rf = (float)register_rank<B, true>(xm[k], i, C);
        if (rf == lo) ilo = i;
        if (rf == hi) ihi = i;
      }
    const float v_lo =
        ilo < 0 ? 0.f : tile[ilo * kCols + c0 + k] * __ldg(mg + ilo);
    const float v_hi =
        ihi < 0 ? 0.f : tile[ihi * kCols + c0 + k] * __ldg(mg + ihi);
    med[c0 + k] = 0.5f * (v_lo + v_hi);
  }
  __syncthreads();
  pass1_row_sums(tile, med, kCols, C,
                 part + ((size_t)g * gridDim.x + blk) * (2 * C + 1));
}

// K3/K6c: block (output tile, split s, cohort g) accumulates one tile of the
// C x C Gram of its column chunk in fp32 FMA (not TF32).  A tile is rows
// [i0, i0 + ni) x columns [j0, j0 + nj) of the Gram, ni, nj <= TS, so any C
// runs.  The Gram is symmetric, so only tiles with i0 <= j0 are launched and
// an off-diagonal tile writes each output at (i, j) and (j, i); fmaf(a, b, v)
// is fmaf(b, a, v) exactly, so the mirror is the value the (j, i) tile would
// have computed.  Each output is one fmaf chain over its chunk in column
// order, whatever the tiling; a diagonal tile reads one stage twice.
//
// 64 threads, 8 x 8; thread (ty, tx) owns the MT x MT micro-tile of rows
// ty + 8 ii and columns tx + 8 jj in registers.  A stage holds the tile's
// rows (and the other tile's, off the diagonal) over TK columns, row-major
// with rows of TK + 4 floats: at each depth k of 4 a thread reads each of
// its rows and columns as one float4, 2 MT shared loads for 4 MT^2 FMAs, and
// the 8 lanes of a quarter-warp reading 8 consecutive rows hit 32 banks.
// Stages are double-buffered: the next stage is fetched while this one is
// multiplied (cp.async for fp32 rows, registers for int8 rows, so the
// dequant happens once an element), one barrier a stage.  Thread t fetches
// column t % TK of every stage, so an int8 row source finds its column's
// scale once a stage, not once an element.  Elements past the chunk or past
// C stage as 0.
template <int TS, bool kAsync>
struct GramTile {
  static constexpr int kMT = TS / 8;                 // micro-tile side
  // stage depth: half for a source staged through registers
  static constexpr int kTK = 1024 / TS / (kAsync ? 1 : 2);
  static constexpr int kLD = kTK + 4;                // stage row stride
  static constexpr int kRowsPerPass = kGramThreads / kTK;
  static constexpr int kLoads = 2 * TS / kRowsPerPass;  // a thread a stage
  // stages a partial sum covers before it joins the running sum: 64
  // columns for either source, so K6c adds in K3's order
  static constexpr int kSubStages = 64 / kTK;
  // the running sums: registers in a 16 x 16 tile, shared memory in a
  // 32 x 32 one, where a second 4 x 4 set of registers took ptxas from 168
  // to 190 and the C = 96 Gram from 0.062 to 0.088 ms on an H100
  static constexpr bool kSharedRun = TS == 32;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// Stages a Gram block's rows over TK columns: thread t takes column t % TK
// of rows t / TK + u * kRowsPerPass.  Stage row r < TS is Gram row ri + r,
// r >= TS is rj + r - TS; a diagonal tile stages only its first TS rows
// (nrows).  fp32 rows go by cp.async, int8 rows through `held`.  `live`
// (bit u: row u is in the tile and masked in) is set once by init().
template <int TS, class Src>
struct GramStager {
  using T = GramTile<TS, Src::kAsync>;
  Src src;
  size_t ri, rj;
  int ni, nj, nrows, c1;
  uint32_t live = 0;
  float held[T::kLoads];

  __device__ __forceinline__ size_t row(int u) const {
    const int r = threadIdx.x / T::kTK + u * T::kRowsPerPass;
    return r < TS ? ri + r : rj + r - TS;
  }

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int u = 0; u < T::kLoads; ++u) {
      const int r = threadIdx.x / T::kTK + u * T::kRowsPerPass;
      if (u * T::kRowsPerPass < nrows && (r < TS ? r < ni : r - TS < nj) &&
          src.live(row(u)))
        live |= 1u << u;
    }
  }

  __device__ __forceinline__ void fetch(int k0, float* buf) {
    const int t = threadIdx.x, sk = t % T::kTK, sr = t / T::kTK;
    const int col = k0 + sk;
    const bool cv = col < c1;
    const int sc = cv ? src.scale_col(col) : 0;
#pragma unroll
    for (int u = 0; u < T::kLoads; ++u) {
      const bool on = cv && (live >> u & 1u);
      if constexpr (Src::kAsync) {
        if (u * T::kRowsPerPass < nrows)
          cp_async4(buf + (sr + u * T::kRowsPerPass) * T::kLD + sk,
                    on ? src.at(row(u), col) : src.at(0, 0), on);
      } else {
        held[u] = on ? src.value(row(u), col, sc) : 0.f;
      }
    }
    if constexpr (Src::kAsync)
      asm volatile("cp.async.commit_group;" ::: "memory");
  }

  __device__ __forceinline__ void land(float* buf) {
    if constexpr (Src::kAsync) {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    } else {
      const int t = threadIdx.x, sk = t % T::kTK, sr = t / T::kTK;
#pragma unroll
      for (int u = 0; u < T::kLoads; ++u)
        if (u * T::kRowsPerPass < nrows)
          buf[(sr + u * T::kRowsPerPass) * T::kLD + sk] = held[u];
    }
  }
};

template <int TS, class Src>
__global__ void __launch_bounds__(kGramThreads)
gram_partials(Src src, float* __restrict__ part, int C, int N, int chunk,
              int nsplit) {
  using T = GramTile<TS, Src::kAsync>;
  constexpr int MT = T::kMT, TK = T::kTK, LD = T::kLD;
  __shared__ __align__(16) float stage[2][2 * TS * LD];
  const int t = threadIdx.x, g = blockIdx.y;
  const int s = blockIdx.x % nsplit;
  const int nt = (C + TS - 1) / TS;
  int ti = 0, rem = blockIdx.x / nsplit;  // -> upper-triangle tile (ti, ti + rem)
  while (rem >= nt - ti) {
    rem -= nt - ti;
    ++ti;
  }
  const int i0 = ti * TS, j0 = (ti + rem) * TS;
  const int ni = min(TS, C - i0), nj = min(TS, C - j0);
  const bool diag = i0 == j0;
  const int c0 = s * chunk, c1 = min(c0 + chunk, N);
  const size_t base = (size_t)g * C;

  GramStager<TS, Src> stager{src, base + i0, base + j0, ni, nj,
                             diag ? TS : 2 * TS, c1};
  stager.init();
  const int ty = t / 8, tx = t % 8;
  float acc[MT][MT];  // the running sums (kSharedRun: in run, this thread's)
  __shared__ float run[T::kSharedRun ? MT * MT : 1][kGramThreads];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < MT; ++b) {
      acc[a][b] = 0.f;
      if constexpr (T::kSharedRun) run[a * MT + b][t] = 0.f;
    }
  float sub[MT][MT];  // the current kSubStages stages' columns
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < MT; ++b) sub[a][b] = 0.f;
  int cur = 0, nsub = 0;
  stager.fetch(c0, stage[0]);
  stager.land(stage[0]);
  __syncthreads();
  for (int k0 = c0; k0 < c1; k0 += TK) {
    const bool more = k0 + TK < c1;
    if (more) stager.fetch(k0 + TK, stage[cur ^ 1]);
    const float* sa = stage[cur] + ty * LD;
    const float* sb = stage[cur] + (diag ? 0 : TS * LD) + tx * LD;
#pragma unroll
    for (int k = 0; k < TK; k += 4) {
      float4 a[MT], b[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        a[m] = *reinterpret_cast<const float4*>(sa + 8 * m * LD + k);
        b[m] = *reinterpret_cast<const float4*>(sb + 8 * m * LD + k);
      }
#pragma unroll
      for (int ii = 0; ii < MT; ++ii)
#pragma unroll
        for (int jj = 0; jj < MT; ++jj) {
          float v = sub[ii][jj];
          v = fmaf(a[ii].x, b[jj].x, v);
          v = fmaf(a[ii].y, b[jj].y, v);
          v = fmaf(a[ii].z, b[jj].z, v);
          v = fmaf(a[ii].w, b[jj].w, v);
          sub[ii][jj] = v;
        }
    }
    if (++nsub == T::kSubStages || !more) {
#pragma unroll
      for (int ii = 0; ii < MT; ++ii)
#pragma unroll
        for (int jj = 0; jj < MT; ++jj) {
          if constexpr (T::kSharedRun)
            run[ii * MT + jj][t] += sub[ii][jj];
          else
            acc[ii][jj] += sub[ii][jj];
          sub[ii][jj] = 0.f;
        }
      nsub = 0;
    }
    if (more) stager.land(stage[cur ^ 1]);
    __syncthreads();
    cur ^= 1;
  }
  float* pg = part + ((size_t)g * nsplit + s) * C * C;
#pragma unroll
  for (int ii = 0; ii < MT; ++ii)
#pragma unroll
    for (int jj = 0; jj < MT; ++jj) {
      const int i = ty + 8 * ii, j = tx + 8 * jj;
      if constexpr (T::kSharedRun) acc[ii][jj] = run[ii * MT + jj][t];
      if (i < ni && j < nj) {
        pg[(size_t)(i0 + i) * C + j0 + j] = acc[ii][jj];
        if (!diag) pg[(size_t)(j0 + j) * C + i0 + i] = acc[ii][jj];
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

// The combine's row bucket: 16, 32 or 64, 0 past 64 rows.
inline int combine_bucket(int C) {
  return C <= 16 ? 16 : C <= 32 ? 32 : C <= 64 ? 64 : 0;
}

// Pass 1's plan at (C, N) (robust_pipeline.py:pass1_plan mirrors it): the
// register body over the combine's bucket for C <= 64, V = 2 columns a
// thread in the 16-row bucket when N is even, else 1, V * kPass1Threads
// columns a block; past 64 rows the shared tile, one column a thread,
// kPass1TileCols a block.  It depends on (C, N) alone: an unaligned matrix
// takes the same plan with scalar loads, so K6a adds its sums in K1's order.
inline int pass1_vec(int C, int N) {
  return combine_bucket(C) == 16 && N % 2 == 0 ? 2 : 1;
}

inline int pass1_cols(int C, int N) {
  return combine_bucket(C) ? pass1_vec(C, N) * kPass1Threads : kPass1TileCols;
}

template <class Src, int B, int V, bool VEC>
int launch_pass1_ranks(Src src, const float* mask, float* part, int G, int C,
                       int N, int nblk, cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)C + 1) * V * kPass1Threads;
  const void* fn = (const void*)pass1_ranks<Src, B, V, VEC>;
  int err = set_smem(fn, smem);
  if (err) return err;
  pass1_ranks<Src, B, V, VEC><<<dim3(nblk, G), kPass1Threads, smem, st>>>(
      src, mask, part, C, N);
  return (int)cudaGetLastError();
}

// mask (G, C) -> part (G, nblk, 2C+1) scratch, out (G, 2C+1) = [dots |
// sqnorms | refsq].  nblk, the caller's count of partial rows, must be the
// plan's.
template <class Src>
int launch_pass1(Src src, const float* mask, float* part, float* out, int G,
                 int C, int N, int nblk, cudaStream_t st) {
  const int v = pass1_vec(C, N), cols = pass1_cols(C, N);
  if (C < 1 || N < 1 || G > 65535 || nblk != (N + cols - 1) / cols)
    return (int)cudaErrorInvalidValue;
  int err;
  switch (combine_bucket(C)) {
    case 16:
      err = v == 1 ? launch_pass1_ranks<Src, 16, 1, true>(src, mask, part, G,
                                                          C, N, nblk, st)
            : src.aligned(2)
                ? launch_pass1_ranks<Src, 16, 2, true>(src, mask, part, G, C,
                                                       N, nblk, st)
                : launch_pass1_ranks<Src, 16, 2, false>(src, mask, part, G, C,
                                                        N, nblk, st);
      break;
    case 32:
      err = launch_pass1_ranks<Src, 32, 1, true>(src, mask, part, G, C, N,
                                                 nblk, st);
      break;
    case 64:
      err = launch_pass1_ranks<Src, 64, 1, true>(src, mask, part, G, C, N,
                                                 nblk, st);
      break;
    default: {
      const size_t smem = sizeof(float) * ((size_t)C * cols + cols + C);
      err = set_smem((const void*)pass1_partials<Src>, smem);
      if (err) return err;
      pass1_partials<Src><<<dim3(nblk, G), cols, smem, st>>>(src, mask, part,
                                                             C, N);
      err = (int)cudaGetLastError();
    }
  }
  if (err) return err;
  launch_reduce(part, out, G, nblk, 2 * C + 1, st);
  return (int)cudaGetLastError();
}

// The combine's plan at (C, N), mode (robust_pipeline.py:combine_plan
// mirrors it): V, the widest of 4, 2, 1 dividing N (and to which the rows
// and out are aligned); the mean streams at V; trimmed and median rank in
// registers over a bucket of 16 rows (V <= 2), 32 or 64 (V = 1), and past
// 64 rows from the (C, cols) shared tile, one column a thread.

template <class Src, int B, int V>
int launch_ranks_v(Src src, const float* mask, float* out, int G, int C, int N,
                   int cols, int mode, float trim_frac, cudaStream_t st) {
  const dim3 grid((N + V * cols - 1) / (V * cols), G);
  if (C == B)
    combine_ranks<Src, B, V, true><<<grid, cols, 0, st>>>(src, mask, out, C, N,
                                                          mode, trim_frac);
  else
    combine_ranks<Src, B, V, false><<<grid, cols, 0, st>>>(src, mask, out, C,
                                                           N, mode, trim_frac);
  return (int)cudaGetLastError();
}

template <class Src, int B>
int launch_ranks(Src src, const float* mask, float* out, int G, int C, int N,
                 int cols, int v, int mode, float trim_frac, cudaStream_t st) {
  if constexpr (B == 16) {
    if (v == 2)
      return launch_ranks_v<Src, B, 2>(src, mask, out, G, C, N, cols, mode,
                                       trim_frac, st);
  }
  return launch_ranks_v<Src, B, 1>(src, mask, out, G, C, N, cols, mode,
                                   trim_frac, st);
}

// mask/w (G, C) -> out (G, N).  mode 0 mean, 1 trimmed, 2 median; cols
// threads a block.
template <class Src>
int launch_combine(Src src, const float* mask, const float* w, float* out, int G,
                   int C, int N, int cols, int mode, float trim_frac, cudaStream_t st) {
  if (G > 65535 || cols < 32 || cols > 1024) return (int)cudaErrorInvalidValue;
  int v = N % 4 == 0 ? 4 : N % 2 == 0 ? 2 : 1;
  while (v > 1 && !(src.aligned(v) && (uintptr_t)out % (4 * v) == 0)) v >>= 1;
  if (mode == 0) {
    const dim3 grid((N + v * cols - 1) / (v * cols), G);
    if (v == 4)
      combine_mean<Src, 4><<<grid, cols, 0, st>>>(src, w, out, C, N);
    else if (v == 2)
      combine_mean<Src, 2><<<grid, cols, 0, st>>>(src, w, out, C, N);
    else
      combine_mean<Src, 1><<<grid, cols, 0, st>>>(src, w, out, C, N);
    return (int)cudaGetLastError();
  }
  switch (combine_bucket(C)) {
    case 16:
      return launch_ranks<Src, 16>(src, mask, out, G, C, N, cols, v < 2 ? v : 2,
                                   mode, trim_frac, st);
    case 32:
      return launch_ranks<Src, 32>(src, mask, out, G, C, N, cols, 1, mode,
                                   trim_frac, st);
    case 64:
      return launch_ranks<Src, 64>(src, mask, out, G, C, N, cols, 1, mode,
                                   trim_frac, st);
  }
  const size_t smem = sizeof(float) * ((size_t)C * cols + C);
  int err = set_smem((const void*)combine_tile<Src>, smem);
  if (err) return err;
  const int nblk = (N + cols - 1) / cols;
  combine_tile<Src><<<dim3(nblk, G), cols, smem, st>>>(src, mask, out, C, N, mode,
                                                        trim_frac);
  return (int)cudaGetLastError();
}

// -> part (G, nsplit, C*C) scratch, out (G, C, C), nsplit = ceil(N/chunk)
// (robust_pipeline.py:gram_split picks chunk).  Output tiles of 16 x 16 (2 x 2
// micro-tiles) for C <= 16, else 32 x 32 (4 x 4): the upper triangle's
// nt (nt + 1) / 2 tiles, nt = ceil(C / TS), times nsplit on the grid's x axis.
template <class Src>
int launch_gram(Src src, float* part, float* out, int G, int C, int N, int chunk,
                cudaStream_t st) {
  const int nsplit = (N + chunk - 1) / chunk;
  const int ts = C <= 16 ? 16 : 32;
  const long long nt = (C + ts - 1) / ts;
  const long long blocks = nt * (nt + 1) / 2 * nsplit;
  if (blocks >= (1ll << 31) || G > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, G);
  if (ts == 16)
    gram_partials<16, Src><<<grid, kGramThreads, 0, st>>>(src, part, C, N, chunk,
                                                          nsplit);
  else
    gram_partials<32, Src><<<grid, kGramThreads, 0, st>>>(src, part, C, N, chunk,
                                                          nsplit);
  launch_reduce(part, out, G, nsplit, C * C, st);
  return (int)cudaGetLastError();
}

}  // namespace
