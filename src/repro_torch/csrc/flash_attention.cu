// Causal sliding-window flash attention forward (K9) for Hopper (sm_90a),
// plain C interface.
//
// Counterpart of the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_fwd (body _flash_body): q (B, Hq, S, dh) against k, v
// (B, Hkv, S, dh), query head h reading kv head h / g (GQA), scores of
// (q * dh^-0.5) . k in fp32, masked to -1e30 outside the causal and window
// band, an online softmax in fp32 (running max m, sum l, output acc,
// rescaled by exp(m_old - m_new) a key tile), out = acc / max(l, 1e-30)
// rounded to q's dtype.  Key tiles wholly outside a query tile's band are
// skipped.  A row whose keys are all masked inside a visited tile takes
// weights exp(0) = 1 there, as _flash_body does; the first live key sets m
// to a real value and exp(-1e30 - m) = 0 wipes them.  Every S >= 1 (a ragged
// last tile is masked, its rows zero) and every dh <= 256.
//
// Bound: operations.  4 dh flops a live (row, key) pair: at B = 2, Hq = 24,
// S = 1024, dh = 128, causal, 12.9 GFLOP, 0.19 ms on the fp32 units, against
// 25 MB of q, k, v and o (bf16), 7.5 us at 3.35 TB/s.  Design, the simple
// one (fp32 FMA; wgmma and TMA are later work): one CTA of 256 threads a
// (64-row q tile, q head, batch), the CTAs of the last (longest, under the
// causal mask) q tiles first.  Q, K and V tiles are staged in shared memory
// as fp32 (Q and K rows padded to dh + 1 floats, so a warp's 16 key rows
// fall in 16 banks); each thread owns 4 query rows: a 4 x 4 micro-tile of
// scores (key columns strided by 16) and 4 x ceil(dh / 16) output columns in
// registers, with the row statistics reduced over its 16-lane half-warp by
// shuffles; the probabilities pass through a (64, 65) shared tile to the
// P V product.  Tensors are read through their strides (unit stride on dh),
// so the model layout's (B, S, H, dh) views go in and out without a copy.
//
// The entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BLK = 64;
constexpr int THREADS = 256;
constexpr int UNROLL = 8;            // loads in flight a thread while staging
constexpr float NEG_INF = -1e30f;

struct Strides {                     // batch, head, seq strides in elements
  long long q[3], k[3], v[3], o[3];
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Rows [r0, r0 + BLK) of one head's (S, dh) matrix (row stride ss) into a
// shared tile of row stride ld, times scale, zero past row S.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, long long ss,
                                      int r0, int S, int dh, float* tile,
                                      int ld, float scale) {
  const int n = BLK * dh;
  for (int base = threadIdx.x; base < n; base += THREADS * UNROLL) {
    float val[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int idx = base + u * THREADS;
      const int r = idx / dh;
      val[u] = (idx < n && r0 + r < S)
                   ? load_f(src + (r0 + r) * ss + (idx - r * dh)) * scale
                   : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int idx = base + u * THREADS;
      const int r = idx / dh;
      if (idx < n) tile[r * ld + idx - r * dh] = val[u];
    }
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, Strides st, int g,
              int S, int dh, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int ld = dh + 1;
  float* Qs = smem;                  // (BLK, dh + 1), q * scale
  float* Ks = Qs + BLK * ld;         // (BLK, dh + 1)
  float* Vs = Ks + BLK * ld;         // (BLK, dh)
  float* Ps = Vs + BLK * dh;         // (BLK, BLK + 1) probabilities
  const int nqb = (S + BLK - 1) / BLK;
  const int q0 = (nqb - 1 - (int)blockIdx.x) * BLK;
  const int q1 = min(q0 + BLK, S);
  const int h = blockIdx.y, b = blockIdx.z, hk = h / g;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* qh = q + b * st.q[0] + h * st.q[1];
  const T* kh = k + b * st.k[0] + hk * st.k[1];
  const T* vh = v + b * st.v[0] + hk * st.v[1];

  stage(qh, st.q[2], q0, S, dh, Qs, ld, scale);
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }
  const int lo = (window && q0 - window + 1 > 0) ? (q0 - window + 1) / BLK : 0;
  const int hi = causal ? (q1 - 1) / BLK + 1 : nqb;
  for (int kb = lo; kb < hi; ++kb) {
    const int k0 = kb * BLK;
    __syncthreads();                 // Qs staged / the last tile's readers done
    stage(kh, st.k[2], k0, S, dh, Ks, ld, 1.f);
    stage(vh, st.v[2], k0, S, dh, Vs, dh, 1.f);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = Qs[(ty * 4 + r) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[r][j] = fmaf(qv[r], kv[j], s[r][j]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + ty * 4 + r;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool live = col < S && (!causal || col <= row) &&
                          (!window || col > row - window);
        s[r][j] = live ? s[r][j] : NEG_INF;
        mx = fmaxf(mx, s[r][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[r][j] - m_new);
        Ps[(ty * 4 + r) * (BLK + 1) + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= corr;
    }
    __syncthreads();
    for (int j = 0; j < BLK; ++j) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        vv[c] = col < dh ? Vs[j * dh + col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = Ps[(ty * 4 + r) * (BLK + 1) + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
  }
  T* oh = o + b * st.o[0] + h * st.o[1];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty * 4 + r;
    if (row >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < dh) store_f(oh + row * st.o[2] + col, acc[r][c] / denom);
    }
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* o,
           const Strides& st, int B, int Hq, int Hkv, int S, int dh,
           int causal, int window, float scale, cudaStream_t stream) {
  const int smem = 4 * (2 * BLK * (dh + 1) + BLK * dh + BLK * (BLK + 1));
  auto fn = fa_fwd_kernel<T, NC>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + BLK - 1) / BLK, Hq, B);
  fn<<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, st, Hq / Hkv, S, dh,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* o,
              const Strides& st, int B, int Hq, int Hkv, int S, int dh,
              int causal, int window, float scale, cudaStream_t stream) {
  if (dh <= 64)
    return launch<T, 4>(q, k, v, o, st, B, Hq, Hkv, S, dh, causal, window,
                        scale, stream);
  if (dh <= 128)
    return launch<T, 8>(q, k, v, o, st, B, Hq, Hkv, S, dh, causal, window,
                        scale, stream);
  return launch<T, 16>(q, k, v, o, st, B, Hq, Hkv, S, dh, causal, window,
                       scale, stream);
}

}  // namespace

extern "C" {

// q (B, Hq, S, dh), k/v (B, Hkv, S, dh), o (B, Hq, S, dh) through
// strides[12] = (batch, head, seq) element strides of q, k, v, o; dtype 0 fp32,
// 1 bf16 (all four alike).
int fa_fwd(const void* q, const void* k, const void* v, void* o,
           const long long* strides, int dtype, int B, int Hq, int Hkv, int S,
           int dh, int causal, int window, float scale, void* stream) {
  if (dh < 1 || dh > 256 || Hkv < 1 || Hq % Hkv || S < 1 || (dtype & ~1))
    return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  cudaStream_t s = (cudaStream_t)stream;
  return dtype ? launch_dh<__nv_bfloat16>(q, k, v, o, st, B, Hq, Hkv, S, dh,
                                          causal, window, scale, s)
               : launch_dh<float>(q, k, v, o, st, B, Hq, Hkv, S, dh, causal,
                                  window, scale, s);
}

}  // extern "C"
