// Paged flash-decode (K8) for Hopper (sm_90a), plain C interface.
//
// Counterpart of the Pallas TPU kernel src/repro/kernels/paged_decode.py:
// paged_flash_decode (body _kernel): one query token a slot, q (S, Hq, dh),
// attends over the slot's KV pages in the pools kp, vp (N, page, Hkv, dh),
// found through the page table (S, maxp) int32, up to lengths[s] keys; GQA
// (query head h reads kv head h / g); scores of (q * dh^-0.5) . k in fp32,
// keys past lengths[s] are dead, an online softmax in fp32 (running max m,
// sum l, output acc, rescaled by exp(m_old - m_new)), out (S, Hq, dh) fp32 =
// acc / max(l, 1e-30); a slot with lengths <= 0 writes exactly 0.  int8 pools
// hold codes with (N, page, Hkv) fp32 scales: each code is multiplied by its
// (row, head) scale right after the load, the exact codes * scale of the
// reference's dequant_pool.  Any dh <= 256, any page size, any group g.
//
// Bound: bytes.  Each live K and V row once (Hkv * dh * itemsize a row and
// kv), the int8 scales, q and the output; the 4 dh flops a (query row, key)
// pair stay far under.  At the serving shape the bytes take ~4 us, so the
// kernel has to keep many rows in flight on every SM at once.
//
// Design: register-resident, split over keys in proportion to each slot's
// length (flash-decoding with work items).
//   A kv head's live keys are cut into items of `chunk` keys, slot after slot:
//   slot s has ceil(min(lengths[s], maxp page) / chunk) items (none when
//   inactive).  The grid is (ctas, Hkv * row blocks); CTA x takes items x,
//   x + ctas, ... of its head.  The host picks chunk and ctas from maxp *
//   page and the SM count (paged_decode.py:decode_splits), never from
//   lengths: each CTA maps its item to (slot, piece) from lengths on the
//   device, by a warp prefix sum over the slots' item counts.  So a long
//   slot gets as many CTAs as its length asks for, a short one few, and no
//   CTA waits on a dead range; there is no host read.
//   Warps own keys, lanes own head dims.  The CTA's 4 warps take groups of
//   U consecutive keys in turn.  Lane l holds elements j * 32 VEC + l VEC
//   .. + VEC - 1 (j < NV) of each of the CTA's query rows (up to GB of the
//   group: the whole group for g <= 8), scaled, and of each row's
//   accumulator, in registers.  A key's K and V rows are one coalesced
//   vector load a lane (float4 / char4 at VEC 4, narrower when dh or the
//   pointers are not aligned to it).  The item's page-table entries are
//   loaded once, lane i holding page p0 + i, and passed by shuffle.  All U
//   keys' loads are issued before their first use; the dot product is
//   finished by an xor butterfly (a fixed order); (m, l, acc) are updated
//   once per U keys; no shared-memory staging of K or V and no barrier in
//   the key loop.
//   The warps merge through shared memory in warp order.  A slot of one
//   item writes its output there; else each item writes its (m, l, acc) to
//   scratch, and the last CTA of the slot to finish, found by an integer
//   counter that it resets to 0, merges the items in item order by the
//   log-sum-exp rule.  Every merge runs in a fixed order, so two calls are
//   bitwise equal.
//
// The entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;

// keys a warp has in flight, by the floats a lane holds for its rows
__host__ __device__ constexpr int keys_in_flight(int rows_x_epl) {
  return rows_x_epl >= 64 ? 1 : rows_x_epl >= 32 ? 2 : 4;
}

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const int8_t* p, float* v) {
  if constexpr (VEC == 4) {
    const char4 t = __ldg(reinterpret_cast<const char4*>(p));
    v[0] = (float)t.x; v[1] = (float)t.y; v[2] = (float)t.z; v[3] = (float)t.w;
  } else if constexpr (VEC == 2) {
    const char2 t = __ldg(reinterpret_cast<const char2*>(p));
    v[0] = (float)t.x; v[1] = (float)t.y;
  } else {
    v[0] = (float)__ldg(reinterpret_cast<const signed char*>(p));
  }
}

__device__ __forceinline__ float load_q(const void* q, int q_bf16, size_t i) {
  return q_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(q)[i])
                : reinterpret_cast<const float*>(q)[i];
}

// Item `item` of a kv head -> (slot, piece), or slot -1 past the last item.
// Every lane of every warp computes the same answer.
__device__ __forceinline__ int2 find_item(const int* __restrict__ lengths, int S,
                                          int total, int chunk, int item, int lane) {
  int carry = 0;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int n = s0 + lane < S ? min(__ldg(lengths + s0 + lane), total) : 0;
    const int c = n > 0 ? (n - 1) / chunk + 1 : 0;
    int incl = c;                               // inclusive prefix over lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += t;
    }
    const unsigned hit = __ballot_sync(FULL, carry + incl > item);
    if (hit) {
      const int f = __ffs(hit) - 1;
      const int before = __shfl_sync(FULL, incl - c, f);
      return make_int2(s0 + f, item - carry - before);
    }
    carry += __shfl_sync(FULL, incl, 31);
  }
  return make_int2(-1, 0);
}

// GB query rows a CTA; lane elements VEC x NV (dh <= 32 VEC NV); TP the pool
// type (float, or int8_t with scales).
template <int GB, int VEC, int NV, typename TP, bool INT8>
__global__ void __launch_bounds__(THREADS)
pd_kernel(const void* __restrict__ q, const TP* __restrict__ kp,
          const TP* __restrict__ vp, const float* __restrict__ ks,
          const float* __restrict__ vs, const int* __restrict__ table,
          const int* __restrict__ lengths, float* __restrict__ out,
          float* __restrict__ part, int* __restrict__ counter, int q_bf16,
          int S, int hq, int hkv, int dh, int page, int maxp, int splits,
          int chunk, float scale) {
  constexpr int EPL = VEC * NV;                 // elements a lane holds
  constexpr int U = keys_in_flight(GB * EPL);
  __shared__ float sm_ml[WARPS][GB][2];
  __shared__ int sm_last;
  extern __shared__ float sm_acc[];             // (WARPS, GB, dh)

  const int ctas = gridDim.x, hb = blockIdx.y;
  const int g = hq / hkv, nrb = (g + GB - 1) / GB;
  const int h = hb / nrb, r0 = (hb % nrb) * GB;
  const int rows = min(GB, g - r0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int total = maxp * page;                // the reference's arange(maxp page)

  for (int s = blockIdx.x; s < S; s += ctas)    // inactive slots give 0
    if (__ldg(lengths + s) <= 0)
      for (int i = threadIdx.x; i < rows * dh; i += THREADS)
        out[((size_t)s * hq + (size_t)h * g + r0) * dh + i] = 0.f;

  for (int item = blockIdx.x;; item += ctas) {
    const int2 it = find_item(lengths, S, total, chunk, item, lane);
    const int s = it.x, j = it.y;
    if (s < 0) break;
    const int n = min(__ldg(lengths + s), total);
    const int cnt = (n - 1) / chunk + 1;        // the slot's items
    const int k0 = j * chunk, k1 = min(k0 + chunk, n), p0 = k0 / page;
    const size_t row0 = (size_t)s * hq + (size_t)h * g + r0;  // first query head
    const int* trow = table + (size_t)s * maxp;
    const int tab = p0 + lane < maxp ? __ldg(trow + p0 + lane) : 0;
    float qr[GB][EPL], acc[GB][EPL], m[GB], l[GB];
#pragma unroll
    for (int gi = 0; gi < GB; ++gi) {
      m[gi] = NEG_INF;
      l[gi] = 0.f;
#pragma unroll
      for (int jj = 0; jj < NV; ++jj)
#pragma unroll
        for (int t = 0; t < VEC; ++t) {
          const int e = jj * 32 * VEC + lane * VEC + t;
          qr[gi][jj * VEC + t] =
              gi < rows && e < dh ? load_q(q, q_bf16, (row0 + gi) * dh + e) * scale
                                  : 0.f;
          acc[gi][jj * VEC + t] = 0.f;
        }
    }

    for (int base = k0 + warp * U; base < k1; base += WARPS * U) {
      float kv[U][EPL], vv[U][EPL];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kpos = min(base + u, k1 - 1);  // a dead slot re-reads a live key
        const int pi = kpos / page, rel = pi - p0;
        const int pe = __shfl_sync(FULL, tab, rel & 31);
        const size_t prow =
            (size_t)(rel < 32 ? pe : __ldg(trow + pi)) * page + (kpos - pi * page);
        const size_t off = (prow * hkv + h) * dh;
#pragma unroll
        for (int jj = 0; jj < NV; ++jj) {
          const int e = jj * 32 * VEC + lane * VEC;
          if (e < dh) {
            load_vec<VEC>(kp + off + e, &kv[u][jj * VEC]);
            load_vec<VEC>(vp + off + e, &vv[u][jj * VEC]);
          } else {
#pragma unroll
            for (int t = 0; t < VEC; ++t) kv[u][jj * VEC + t] = vv[u][jj * VEC + t] = 0.f;
          }
        }
        if constexpr (INT8) {
          const float sk = __ldg(ks + prow * hkv + h), sv = __ldg(vs + prow * hkv + h);
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            kv[u][e] *= sk;
            vv[u][e] *= sv;
          }
        }
      }
      float sc[U][GB];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int gi = 0; gi < GB; ++gi) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) d = fmaf(qr[gi][e], kv[u][e], d);
          sc[u][gi] = d;
        }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int gi = 0; gi < GB; ++gi)
            sc[u][gi] += __shfl_xor_sync(FULL, sc[u][gi], off);
#pragma unroll
      for (int gi = 0; gi < GB; ++gi) {
        float mx = m[gi];
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (base + u < k1) mx = fmaxf(mx, sc[u][gi]);
        const float corr = expf(m[gi] - mx);
        float p[U], psum = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          p[u] = base + u < k1 ? expf(sc[u][gi] - mx) : 0.f;
          psum += p[u];
        }
        l[gi] = l[gi] * corr + psum;
        m[gi] = mx;
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          float a = acc[gi][e] * corr;
#pragma unroll
          for (int u = 0; u < U; ++u) a = fmaf(p[u], vv[u][e], a);
          acc[gi][e] = a;
        }
      }
    }

    // the warps' partials, merged in warp order (a warp with no key has
    // m = -1e30, l = 0, acc = 0 and weight exp(-1e30 - M) = 0)
#pragma unroll
    for (int gi = 0; gi < GB; ++gi) {
      if (lane == 0) {
        sm_ml[warp][gi][0] = m[gi];
        sm_ml[warp][gi][1] = l[gi];
      }
#pragma unroll
      for (int jj = 0; jj < NV; ++jj)
#pragma unroll
        for (int t = 0; t < VEC; ++t) {
          const int e = jj * 32 * VEC + lane * VEC + t;
          if (e < dh) sm_acc[(warp * GB + gi) * dh + e] = acc[gi][jj * VEC + t];
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * dh; i += THREADS) {
      const int gi = i / dh, e = i - gi * dh;
      float M = NEG_INF;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_ml[w][gi][0]);
      float L = 0.f, A = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float c = expf(sm_ml[w][gi][0] - M);
        L = fmaf(sm_ml[w][gi][1], c, L);
        A = fmaf(sm_acc[(w * GB + gi) * dh + e], c, A);
      }
      if (cnt == 1) {
        out[(row0 + gi) * dh + e] = A / fmaxf(L, 1e-30f);
      } else {
        const size_t pr = (row0 + gi) * splits + j;
        part[pr * (dh + 2) + 2 + e] = A;
        if (e == 0) {
          part[pr * (dh + 2)] = M;
          part[pr * (dh + 2) + 1] = L;
        }
      }
    }
    if (cnt > 1) {
      // the last item of this (slot, row block) to finish merges them all
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) {
        int* c = counter + (size_t)s * gridDim.y + hb;
        const int last = atomicAdd(c, 1) == cnt - 1;
        if (last) *c = 0;                       // ready for the next launch
        sm_last = last;
      }
      __syncthreads();
      if (sm_last) {
        __threadfence();
        for (int i = threadIdx.x; i < rows * dh; i += THREADS) {
          const int gi = i / dh, e = i - gi * dh;
          const float* pg = part + (row0 + gi) * splits * (dh + 2);
          float M = NEG_INF;
          for (int k = 0; k < cnt; ++k) M = fmaxf(M, __ldcg(pg + k * (dh + 2)));
          float L = 0.f, A = 0.f;
          for (int k = 0; k < cnt; ++k) {
            const float* pk = pg + k * (dh + 2);
            const float c = expf(__ldcg(pk) - M);
            L = fmaf(__ldcg(pk + 1), c, L);
            A = fmaf(__ldcg(pk + 2 + e), c, A);
          }
          out[(row0 + gi) * dh + e] = A / fmaxf(L, 1e-30f);
        }
      }
    }
    __syncthreads();                            // shared memory is reused
  }
}

struct Args {
  const void* q;
  const void* kp;
  const void* vp;
  const float* ks;
  const float* vs;
  const int* table;
  const int* lengths;
  float* out;
  float* part;
  int* counter;
  int q_bf16, S, hq, hkv, dh, page, maxp, splits, chunk, ctas;
  float scale;
};

template <int GB, int VEC, int NV, typename TP, bool INT8>
int launch(const Args& a, cudaStream_t stream) {
  const int g = a.hq / a.hkv, nrb = (g + GB - 1) / GB;
  const int smem = (int)sizeof(float) * WARPS * GB * a.dh;
  auto fn = pd_kernel<GB, VEC, NV, TP, INT8>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  fn<<<dim3(a.ctas, a.hkv * nrb), THREADS, smem, stream>>>(
      a.q, (const TP*)a.kp, (const TP*)a.vp, a.ks, a.vs, a.table, a.lengths,
      a.out, a.part, a.counter, a.q_bf16, a.S, a.hq, a.hkv, a.dh, a.page,
      a.maxp, a.splits, a.chunk, a.scale);
  return (int)cudaGetLastError();
}

template <int GB, typename TP, bool INT8>
int launch_vec(const Args& a, int vec, cudaStream_t stream) {
  if (vec == 4)
    return a.dh <= 128 ? launch<GB, 4, 1, TP, INT8>(a, stream)
                       : launch<GB, 4, 2, TP, INT8>(a, stream);
  if (vec == 2) return launch<GB, 2, 4, TP, INT8>(a, stream);
  return launch<GB, 1, 8, TP, INT8>(a, stream);
}

template <typename TP, bool INT8>
int launch_rows(const Args& a, int vec, cudaStream_t stream) {
  const int g = a.hq / a.hkv;
  if (g <= 1) return launch_vec<1, TP, INT8>(a, vec, stream);
  if (g <= 2) return launch_vec<2, TP, INT8>(a, vec, stream);
  if (g <= 3) return launch_vec<3, TP, INT8>(a, vec, stream);
  if (g <= 4) return launch_vec<4, TP, INT8>(a, vec, stream);
  return launch_vec<8, TP, INT8>(a, vec, stream);
}

// The widest of 4, 2, 1 elements that divides dh and to which both pools are
// aligned, so that every K and V row's loads are aligned.
int pick_vec(const void* kp, const void* vp, int dh, int item) {
  for (int vec = 4; vec > 1; vec >>= 1)
    if (dh % vec == 0 && (uintptr_t)kp % (vec * item) == 0 &&
        (uintptr_t)vp % (vec * item) == 0)
      return vec;
  return 1;
}

}  // namespace

extern "C" {

// q (S, hq, dh) fp32 (q_bf16 = 0) or bf16 (1); kp, vp (N, page, hkv, dh) fp32
// (int8 = 0) or int8 codes with ks, vs (N, page, hkv) fp32 scales (int8 = 1);
// table (S, maxp) int32; lengths (S,) int32 -> out (S, hq, dh) fp32.  A slot
// has at most splits = ceil(maxp page / chunk) items; ctas CTAs a head.
// part is (S, hq, splits, dh + 2) fp32 scratch and counter holds S * hkv *
// ceil(g / 8) ints (g = hq / hkv), all 0, which every launch leaves 0.
int pd_decode(const void* q, const void* kp, const void* vp, const float* ks,
              const float* vs, const int* table, const int* lengths,
              float* out, float* part, int* counter, int q_bf16, int int8,
              int S, int hq, int hkv, int dh, int page, int maxp, int splits,
              int chunk, int ctas, float scale, void* stream) {
  if (dh < 1 || dh > 256 || hkv < 1 || hq % hkv || page < 1 || S < 1 ||
      maxp < 1 || chunk < 1 || ctas < 1 || hkv > 65535 / ((hq / hkv + 7) / 8) ||
      (long long)splits * chunk < (long long)maxp * page ||
      (long long)(splits - 1) * chunk >= (long long)maxp * page ||
      (int8 && (!ks || !vs)) || (splits > 1 && (!part || !counter)))
    return (int)cudaErrorInvalidValue;
  const Args a{q, kp, vp, ks, vs, table, lengths, out, part, counter, q_bf16,
               S, hq, hkv, dh, page, maxp, splits, chunk, ctas, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (int8)
    return launch_rows<int8_t, true>(a, pick_vec(kp, vp, dh, 1), st);
  return launch_rows<float, false>(a, pick_vec(kp, vp, dh, 4), st);
}

}  // extern "C"
