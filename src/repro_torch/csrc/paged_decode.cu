// Paged flash-decode (K8) for Hopper (sm_90a), plain C interface.
//
// Counterpart of the Pallas TPU kernel src/repro/kernels/paged_decode.py:
// paged_flash_decode (body _kernel): one query token a slot, q (S, Hq, dh),
// attends over the slot's KV pages in the pools kp, vp (N, page, Hkv, dh),
// found through the page table (S, maxp) int32, up to lengths[s] keys; GQA
// (query head h reads kv head h / g); scores of (q * dh^-0.5) . k in fp32,
// keys past lengths[s] at -1e30, an online softmax in fp32 (running max m,
// sum l, output acc, rescaled by exp(m_old - m_new)), out (S, Hq, dh) fp32 =
// acc / max(l, 1e-30); a slot with lengths <= 0 writes exactly 0.  int8 pools
// hold codes with (N, page, Hkv) fp32 scales: each code is multiplied by its
// (row, head) scale right after the load, the exact codes * scale of the
// reference's dequant_pool.  Any dh <= 256 and any page size.
//
// Bound: bytes.  Each live K and V row once (Hkv * dh * itemsize a row and
// kv), the int8 scales, q and the output; the 4 dh flops a (query row, key)
// pair stay far under.  Design, the simple one: one CTA of 256 threads a
// (slot, kv head), holding the g query rows of its group (scaled) and their
// accumulators in shared memory.  It walks the slot's live keys in 64-row
// chunks: each chunk's K and V rows are gathered page by page through
// table[s, p] into shared memory (UNROLL loads in flight a thread; rows past
// lengths[s] load as 0), a thread a (query row, key) computes the scores
// (K rows padded to dh + 1 floats: conflict-free), a warp a query row updates
// (m, l) by shuffles, and a thread an output element folds the chunk into
// acc.  The loop stops at lengths[s], so dead pages cost nothing (the TPU
// kernel's DMAs for them still land).  cp.async or TMA page fetch is later
// work.
//
// The entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int CHUNK = 64;
constexpr int THREADS = 256;
constexpr int UNROLL = 8;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_f(const int8_t* p) { return (float)*p; }

template <typename TQ, typename TP, bool INT8>
__global__ void __launch_bounds__(THREADS)
pd_kernel(const TQ* __restrict__ q, const TP* __restrict__ kp,
          const TP* __restrict__ vp, const float* __restrict__ ks,
          const float* __restrict__ vs, const int* __restrict__ table,
          const int* __restrict__ lengths, float* __restrict__ out, int hq,
          int hkv, int dh, int page, int maxp, float scale) {
  extern __shared__ float smem[];
  const int g = hq / hkv;
  const int s = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* Qs = smem;                      // (g, dh), q * scale
  float* acc = Qs + g * dh;              // (g, dh)
  float* Ks = acc + g * dh;              // (CHUNK, dh + 1)
  float* Vs = Ks + CHUNK * (dh + 1);     // (CHUNK, dh)
  float* Ps = Vs + CHUNK * dh;           // (g, CHUNK) scores, then weights
  float* stat = Ps + g * CHUNK;          // m (g), l (g), corr (g)
  const size_t head0 = ((size_t)s * hq + (size_t)h * g) * dh;
  const int n = min(lengths[s], maxp * page);   // visible keys, as the reference's
                                               // arange(maxp * page) < lengths
  if (n <= 0) {
    for (int i = tid; i < g * dh; i += THREADS) out[head0 + i] = 0.f;
    return;
  }
  for (int i = tid; i < g * dh; i += THREADS) {
    Qs[i] = load_f(q + head0 + i) * scale;
    acc[i] = 0.f;
  }
  for (int i = tid; i < g; i += THREADS) {
    stat[i] = NEG_INF;
    stat[g + i] = 0.f;
  }
  const int* row_table = table + (size_t)s * maxp;
  for (int c0 = 0; c0 < n; c0 += CHUNK) {
    const int rows = min(CHUNK, n - c0);
    __syncthreads();                     // the last chunk's readers are done
    for (int base = tid; base < CHUNK * dh; base += THREADS * UNROLL) {
      float kv[UNROLL], vv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int idx = base + u * THREADS;
        const int r = idx / dh;
        kv[u] = vv[u] = 0.f;
        if (idx < CHUNK * dh && r < rows) {
          const int kpos = c0 + r;
          const size_t prow =
              (size_t)row_table[kpos / page] * page + kpos % page;
          const size_t off = (prow * hkv + h) * dh + (idx - r * dh);
          kv[u] = load_f(kp + off);
          vv[u] = load_f(vp + off);
          if (INT8) {
            kv[u] *= ks[prow * hkv + h];
            vv[u] *= vs[prow * hkv + h];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int idx = base + u * THREADS;
        const int r = idx / dh;
        if (idx < CHUNK * dh) {
          Ks[r * (dh + 1) + idx - r * dh] = kv[u];
          Vs[idx] = vv[u];
        }
      }
    }
    __syncthreads();
    for (int idx = tid; idx < g * CHUNK; idx += THREADS) {
      const int gi = idx / CHUNK, r = idx - gi * CHUNK;
      float sc = NEG_INF;
      if (r < rows) {
        sc = 0.f;
        const float* qr = Qs + gi * dh;
        const float* kr = Ks + r * (dh + 1);
        for (int e = 0; e < dh; ++e) sc = fmaf(qr[e], kr[e], sc);
      }
      Ps[idx] = sc;
    }
    __syncthreads();
    for (int gi = warp; gi < g; gi += THREADS / 32) {
      float* pr = Ps + gi * CHUNK;
      float mx = NEG_INF;
      for (int r = lane; r < CHUNK; r += 32) mx = fmaxf(mx, pr[r]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = stat[gi];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < CHUNK; r += 32) {
        const float p = expf(pr[r] - m_new);
        pr[r] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        stat[g + gi] = stat[g + gi] * corr + sum;
        stat[gi] = m_new;
        stat[2 * g + gi] = corr;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < g * dh; idx += THREADS) {
      const int gi = idx / dh, e = idx - gi * dh;
      const float* pr = Ps + gi * CHUNK;
      float a = acc[idx] * stat[2 * g + gi];
      for (int r = 0; r < rows; ++r) a = fmaf(pr[r], Vs[r * dh + e], a);
      acc[idx] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < g * dh; i += THREADS)
    out[head0 + i] = acc[i] / fmaxf(stat[g + i / dh], 1e-30f);
}

template <typename TQ, typename TP, bool INT8>
int launch(const void* q, const void* kp, const void* vp, const float* ks,
           const float* vs, const int* table, const int* lengths, float* out,
           int S, int hq, int hkv, int dh, int page, int maxp, float scale,
           cudaStream_t stream) {
  const int g = hq / hkv;
  const int smem =
      4 * (2 * g * dh + CHUNK * (dh + 1) + CHUNK * dh + g * CHUNK + 3 * g);
  auto fn = pd_kernel<TQ, TP, INT8>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  fn<<<dim3(S, hkv), THREADS, smem, stream>>>(
      (const TQ*)q, (const TP*)kp, (const TP*)vp, ks, vs, table, lengths, out,
      hq, hkv, dh, page, maxp, scale);
  return (int)cudaGetLastError();
}

template <typename TQ>
int launch_pool(const void* q, const void* kp, const void* vp,
                const float* ks, const float* vs, const int* table,
                const int* lengths, float* out, int int8, int S, int hq,
                int hkv, int dh, int page, int maxp, float scale,
                cudaStream_t stream) {
  if (int8)
    return launch<TQ, int8_t, true>(q, kp, vp, ks, vs, table, lengths, out,
                                    S, hq, hkv, dh, page, maxp, scale, stream);
  return launch<TQ, float, false>(q, kp, vp, ks, vs, table, lengths, out, S,
                                  hq, hkv, dh, page, maxp, scale, stream);
}

}  // namespace

extern "C" {

// q (S, hq, dh) fp32 (q_bf16 = 0) or bf16 (1); kp, vp (N, page, hkv, dh) fp32
// (int8 = 0) or int8 codes with ks, vs (N, page, hkv) fp32 scales (int8 = 1);
// table (S, maxp) int32; lengths (S,) int32 -> out (S, hq, dh) fp32.
int pd_decode(const void* q, const void* kp, const void* vp, const float* ks,
              const float* vs, const int* table, const int* lengths,
              float* out, int q_bf16, int int8, int S, int hq, int hkv,
              int dh, int page, int maxp, float scale, void* stream) {
  if (dh < 1 || dh > 256 || hkv < 1 || hq % hkv || page < 1 || S < 1 ||
      (int8 && (!ks || !vs)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return q_bf16 ? launch_pool<__nv_bfloat16>(q, kp, vp, ks, vs, table,
                                             lengths, out, int8, S, hq, hkv,
                                             dh, page, maxp, scale, st)
                : launch_pool<float>(q, kp, vp, ks, vs, table, lengths, out,
                                     int8, S, hq, hkv, dh, page, maxp, scale,
                                     st);
}

}  // extern "C"
