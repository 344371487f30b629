// Blocked top-d of the population's Gumbel keys for Hopper (sm_90a), plain C
// interface.
//
// Counterpart of the Pallas TPU kernel in src/repro/kernels/population_select.py:
//   ps_topd <- topd_pallas (K7, body _block_topd_body): for each block of blk
//              keys, the block's top-d candidates (values and global indices,
//              in the order d rounds of max-and-mask extract them); then, in
//              the same launch, the merge of the nb*d candidates into the d
//              indices the reference's stage-2 lax.top_k returns.
//
// Semantics, held bitwise against the plain versions (population_select.py's
// block_topd_plain and _merge):
//   stage 1  a block's candidates are its keys above -inf by descending key,
//            the lower index first on equal keys, where -0.0 equals +0.0
//            (jnp.argmax's and torch.argmax's rule), each written with its
//            own bits.  A block with f < d keys above -inf ends in d - f
//            copies of (-inf, b*blk): max-and-mask turns every extracted key
//            into -inf, and the argmax of an all -inf block is its first
//            index.
//   stage 2  the d largest candidates by the floats' total order (+0.0 above
//            -0.0, as lax.top_k orders them), the lower candidate position
//            (b*d + r) first on equal bits; their global indices in that
//            order.
// NaN keys are outside the contract (keys are log priorities plus Gumbel
// noise, and -inf).
//
// Bound: bytes.  The launch reads each key once (4 B) and writes and reads
// back 16 B a candidate and 4 B an index: at M = 10^6, d = 64 that is 4.25
// MB, 1.27 us at 3.35 TB/s.  The time goes to the chain of dependent steps
// inside one CTA, each a barrier apart, so the design keeps that chain short
// and, up to d = 256, its length independent of d (past 256 the bitonic
// sort adds log^2 d barriers):
//   * One CTA of 256 threads a block reads the block's keys once into
//     shared memory with 16-byte loads (scalar loads where the pointer is
//     not 16-byte aligned; keys past M read as -inf).  Each key is a
//     distinct 48-bit composite, the order-preserving image of its bits
//     (-0.0 folded into +0.0) above 0xffff - position, so "above the d-th
//     composite" is the whole selection rule, ties included.
//   * For d <= 256 a bound prunes the block: each warp sorts its threads'
//     maxima in registers, and the least over the warps of the ceil(d/8)-th
//     largest has d keys at or above it.  The keys at or above the bound
//     (~2d on Gumbel keys) go to a shared buffer and are ranked by counting
//     (up to 512 of them), which selects and orders them in one step.
//   * Past 256, or when more than 512 keys pass the bound (over them, or
//     over the whole block past 2048), a radix select finds the
//     d-th composite 8 bits a pass from the top (a 256-bin shared histogram
//     whose adds are aggregated over the lanes that share a digit with
//     __match_any_sync; every warp scans it, so a pass takes one barrier; it
//     stops at the first pass whose bin is taken whole), and the selected
//     are ranked by counting, or by a bitonic sort past 256.
//   * The last CTA to finish (a completion counter in a persistent
//     workspace, which that CTA resets) merges the candidates the same way,
//     on 64-bit composites (the unfolded image above 0xffffffff -
//     position): all of them staged in shared memory up to 512; else a
//     bound from one column of the (nb, d) rows (k rows whose column-c
//     candidate is at or above a bound hold (c + 1) * k >= d candidates at
//     or above it: the column's k-th, counted up to 128 rows, else the
//     warps' bound as in stage 1) limits each row's reads to its
//     survivors.  No memset, no host read, one launch.
//
// The entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kRankByCount = 256;     // past this many selected, a sort
constexpr int kCountSurvivors = 512;  // survivors ranked by counting
constexpr int kSurv = 2048;           // shared survivors of a bound
constexpr int kCountColumn = 128;     // merge rows whose bound is counted
static_assert(kThreads == kBins, "one thread clears one bin");
using u64 = unsigned long long;

// order-preserving image of fp32 bits: a larger float has a larger key, and
// +0.0 sits above -0.0 (lax.top_k's total order)
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// argmax's order: -0.0 equal to +0.0
__device__ __forceinline__ unsigned folded_key(float x) {
  return x == 0.0f ? 0x80000000u : order_key(x);
}

// stage 1's key: the folded key of a key above -inf, else 0 (no candidate)
__device__ __forceinline__ unsigned present_key(float x) {
  return x > -INFINITY ? folded_key(x) : 0u;
}

struct Shared {
  unsigned hist[3][kBins];
  unsigned warp_bound[kWarps];
  unsigned bound;  // the merge's column bound
  int n_sel;       // slots filled
  int n_surv;      // survivors of a bound
  int last;        // this CTA merges
};

// Stage 1's elements: the block's keys in shared memory, nq float4s (nq a
// multiple of kThreads, padded with -inf).  0 for a key at -inf: it is never
// a candidate (the exhausted block's tail is written apart).
struct BlockKeys {
  const float4* k4;
  int nq;
  __device__ static u64 comp(float x, int p) {
    const unsigned k = present_key(x);
    return k ? (u64)k << 16 | (u64)(0xffffu - (unsigned)p) : 0ull;
  }
  template <class F>
  __device__ void each(F&& f) const {
    for (int q = threadIdx.x; q < nq; q += kThreads) {
      const float4 v = k4[q];
      f(comp(v.x, 4 * q));
      f(comp(v.y, 4 * q + 1));
      f(comp(v.z, 4 * q + 2));
      f(comp(v.w, 4 * q + 3));
    }
  }
};

// The merge's elements: candidate values at positions b*d + r.
struct Candidates {
  const float* v;
  int n;
  __device__ static u64 comp(float x, int i) {
    return (u64)order_key(x) << 32 | (u64)(0xffffffffu - (unsigned)i);
  }
  template <class F>
  __device__ void each(F&& f) const {
    for (int i0 = 0; i0 < n; i0 += kThreads) {
      const int i = i0 + threadIdx.x;
      f(i < n ? comp(__ldcg(v + i), i) : 0ull);
    }
  }
};

// Composites in shared memory: survivors, or a staged column.
struct Survivors {
  const u64* s;
  int n;
  template <class F>
  __device__ void each(F&& f) const {
    for (int i0 = 0; i0 < n; i0 += kThreads) {
      const int i = i0 + threadIdx.x;
      f(i < n ? s[i] : 0ull);
    }
  }
};

// The merge's bound past kThreads in a column: column c of the (nb, d)
// candidates by argmax's order.
struct Column {
  const float* v;
  int nb, d, c;
  __device__ static u64 comp(float x, int b) {
    return (u64)folded_key(x) << 32 | (u64)(0xffffffffu - (unsigned)b);
  }
  template <class F>
  __device__ void each(F&& f) const {
    for (int i0 = 0; i0 < nb; i0 += kThreads) {
      const int i = i0 + threadIdx.x;
      f(i < nb ? comp(__ldcg(v + (size_t)i * d + c), i) : 0ull);
    }
  }
};

// Every warp: the bin of h that holds the need-th largest element, bins read
// from the top.  total: the elements counted; when it is below need, bin,
// above and cnt are not set.
struct Pick {
  unsigned bin, above, cnt, total;
};

__device__ Pick find_bin(const unsigned* h, unsigned need) {
  const int lane = threadIdx.x & 31;
  unsigned c[8], s = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    c[k] = h[kBins - 1 - 8 * lane - k];
    s += c[k];
  }
  unsigned cum = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, cum, off);
    if (lane >= off) cum += y;
  }
  Pick pk;
  pk.total = __shfl_sync(0xffffffffu, cum, 31);
  unsigned run = cum - s, bin = 0, cnt = 0;
  const bool mine = run < need && need <= cum;       // at most one lane
  bool found = false;
#pragma unroll
  for (int k = 0; k < 8; ++k) {        // unrolled: c stays in registers
    if (!found && run + c[k] >= need) {
      found = true;
      bin = kBins - 1 - 8 * lane - k;
      cnt = c[k];
    } else if (!found) {
      run += c[k];
    }
  }
  const unsigned who = __ballot_sync(0xffffffffu, mine);
  const int src = who ? __ffs(who) - 1 : 0;
  pk.bin = __shfl_sync(0xffffffffu, bin, src);
  pk.above = __shfl_sync(0xffffffffu, run, src);
  pk.cnt = __shfl_sync(0xffffffffu, cnt, src);
  return pk;
}

// Leaves in slot[0..n) the d largest nonzero composites of src (every
// nonzero one, if fewer), in no order, and returns n.  Radix select over
// `bits`-bit composites, 8 bits a pass from the top, stopping at the first
// pass whose bin is taken whole.  Every warp scans the histogram, so a pass
// takes one barrier: pass p adds into hist[p % 3] while hist[(p + 2) % 3]
// is cleared for pass p + 2.  Called by the whole CTA.
template <class Src>
__device__ int select_top(const Src& src, int d, int bits, Shared& sh,
                          u64* slot) {
  const int t = threadIdx.x, lane = t & 31;
  sh.hist[0][t] = 0;
  sh.hist[1][t] = 0;
  if (t == 0) sh.n_sel = 0;
  __syncthreads();
  u64 prefix = 0, cmin = 1;            // cmin 1: every nonzero composite
  unsigned need = (unsigned)d;
  for (int pass = 0, shift = bits - 8; shift >= 0; ++pass, shift -= 8) {
    unsigned* h = sh.hist[pass % 3];
    src.each([&](u64 c) {
      const bool act = c != 0 && (pass == 0 || (c >> (shift + 8)) == prefix);
      if (!__any_sync(0xffffffffu, act)) return;
      const unsigned digit = act ? (unsigned)(c >> shift) & 0xffu : 0xffffffffu;
      const unsigned peers = __match_any_sync(0xffffffffu, digit);
      if (act && lane == __ffs(peers) - 1)
        atomicAdd(&h[digit], (unsigned)__popc(peers));
    });
    __syncthreads();
    sh.hist[(pass + 2) % 3][t] = 0;
    const Pick pk = find_bin(h, need);
    if (pk.total < need) break;        // first pass: fewer than d at all
    prefix = prefix << 8 | pk.bin;
    need -= pk.above;
    if (pk.cnt == need || shift == 0) {
      cmin = prefix << shift;
      break;
    }
  }
  src.each([&](u64 c) {
    if (c != 0 && c >= cmin) slot[atomicAdd(&sh.n_sel, 1)] = c;
  });
  __syncthreads();
  return sh.n_sel;
}

// The folded-key bound of the k largest of src (64-bit composites, the key
// above 32 bits): the least key among them, so at least k elements have a
// key at or above it; 0 when src has fewer than k.
template <class Src>
__device__ unsigned bound_of(const Src& src, int k, Shared& sh, u64* slot) {
  const int n = select_top(src, k, 64, sh, slot);
  unsigned lk = 0xffffffffu;
  for (int e = threadIdx.x; e < n; e += kThreads)
    lk = min(lk, (unsigned)(slot[e] >> 32));
  lk = __reduce_min_sync(0xffffffffu, lk);
  if ((threadIdx.x & 31) == 0) sh.warp_bound[threadIdx.x >> 5] = lk;
  __syncthreads();
  lk = 0xffffffffu;
  for (int w = 0; w < kWarps; ++w) lk = min(lk, sh.warp_bound[w]);
  return n < k ? 0u : lk;
}

// Sorts slot[0..n2) descending (n2 a power of two; slot[n..n2) zeroed).
__device__ void bitonic_desc(u64* slot, int n, int n2) {
  for (int i = n + threadIdx.x; i < n2; i += kThreads) slot[i] = 0;
  __syncthreads();
  for (int k = 2; k <= n2; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n2; i += kThreads) {
        const int l = i ^ j;
        if (l > i) {
          const u64 a = slot[i], b = slot[l];
          if (((i & k) == 0) == (a < b)) {
            slot[i] = b;
            slot[l] = a;
          }
        }
      }
      __syncthreads();
    }
}

// put(rank, composite) for each of the n distinct composites in s whose
// rank (0 the largest) is below d, ranked by counting.
template <class Put>
__device__ void put_counted(const u64* s, int n, int d, Put&& put) {
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const u64 c = s[e];
    int rank = 0;
#pragma unroll 8
    for (int j = 0; j < n; ++j) rank += s[j] > c;   // loads in flight
    if (rank < d) put(rank, c);
  }
}

// put(rank, composite) for each of the n distinct composites in slot, rank
// 0 the largest.
template <class Put>
__device__ void put_ranked(u64* slot, int n, Put&& put) {
  if (n <= kRankByCount) {
    put_counted(slot, n, n, put);
    return;
  }
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  bitonic_desc(slot, n, n2);
  for (int e = threadIdx.x; e < n; e += kThreads) put(e, slot[e]);
}

// put(rank, composite) for the d best of the ns survivors in shared memory
// (every one, if fewer); returns how many.  whole: the source the survivors
// were taken from, selected instead when they overflowed the buffer.
template <class Src, class Put>
__device__ int put_best(const u64* surv, int ns, int d, int bits,
                        const Src& whole, u64* slot, Shared& sh, Put&& put) {
  if (ns <= kCountSurvivors) {
    put_counted(surv, ns, d, put);
    return min(ns, d);
  }
  const int n = ns <= kSurv
                    ? select_top(Survivors{surv, ns}, d, bits, sh, slot)
                    : select_top(whole, d, bits, sh, slot);
  put_ranked(slot, n, put);
  return n;
}

// This warp's ceil(d/8)-th largest thread maximum into warp_bound (d <=
// kThreads): a bitonic sort of the warp's 32 maxima in registers.
__device__ void warp_bound(unsigned best, int d, Shared& sh) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const unsigned o = __shfl_xor_sync(0xffffffffu, best, j);
      best = ((lane & j) == 0) == ((lane & k) == 0) ? max(best, o)
                                                     : min(best, o);
    }
  const unsigned r =
      __shfl_sync(0xffffffffu, best, (d + kWarps - 1) / kWarps - 1);
  if (lane == 0) sh.warp_bound[threadIdx.x >> 5] = r;
}

// The last CTA: put(rank, composite) for the d candidates of the merge.
// Up to kCountSurvivors candidates are staged whole and ranked by counting;
// past that a column bound keeps ~2d of them.
template <class Put>
__device__ void merge(const float* vals, int nb, int d, u64* surv, u64* slot,
                      Shared& sh, Put&& put) {
  const int t = threadIdx.x, n = nb * d;
  int ns;
  if (n <= kCountSurvivors) {          // every candidate, staged
#pragma unroll 4
    for (int i = t; i < n; i += kThreads)
      surv[i] = Candidates::comp(__ldcg(vals + i), i);
    ns = n;
  } else {
    const int c = (d + nb - 1) / nb - 1, k = (d + c) / (c + 1);
    unsigned lk;
    if (nb <= kCountColumn) {          // the column's k-th, by counting
      for (int b = t; b < nb; b += kThreads)
        surv[b] = Column::comp(__ldcg(vals + (size_t)b * d + c), b);
      __syncthreads();
      put_counted(surv, nb, k, [&](int r, u64 comp) {
        if (r == k - 1) sh.bound = (unsigned)(comp >> 32);
      });
      __syncthreads();
      lk = sh.bound;
    } else if (k <= kThreads) {
      // as stage 1's bound: warp w holds rows b = w (mod kWarps), each
      // thread the largest of its rows' column-c candidates
      unsigned best = 0;
      for (int b = (t & 31) * kWarps + (t >> 5); b < nb; b += kThreads)
        best = max(best, folded_key(__ldcg(vals + (size_t)b * d + c)));
      warp_bound(best, k, sh);
      __syncthreads();
      lk = 0xffffffffu;
      for (int w = 0; w < kWarps; ++w) lk = min(lk, sh.warp_bound[w]);
    } else {
      lk = bound_of(Column{vals, nb, d, c}, k, sh, slot);
    }
    if (t == 0) sh.n_surv = 0;
    __syncthreads();
    // each row is sorted in argmax order: read it while it survives
    for (int b = t; b < nb; b += kThreads) {
      const float* row = vals + (size_t)b * d;
      bool more = true;
      for (int r0 = 0; more && r0 < d; r0 += 16) {
        float x[16];
#pragma unroll
        for (int j = 0; j < 16; ++j)
          x[j] = r0 + j < d ? __ldcg(row + r0 + j) : -INFINITY;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          more = more && r0 + j < d && folded_key(x[j]) >= lk;
          if (more) {
            const int s = atomicAdd(&sh.n_surv, 1);
            if (s < kSurv) surv[s] = Candidates::comp(x[j], b * d + r0 + j);
          }
        }
      }
    }
    __syncthreads();
    ns = sh.n_surv;
  }
  __syncthreads();
  put_best(surv, ns, d, 64, Candidates{vals, n}, slot, sh, put);
}

__global__ void __launch_bounds__(kThreads)
block_topd_kernel(const float* __restrict__ g, int m, int blk, int d, int nq,
                  float* __restrict__ vals, int* __restrict__ idx,
                  int* __restrict__ out, int* __restrict__ counter) {
  extern __shared__ __align__(16) unsigned char dyn[];
  float4* k4 = reinterpret_cast<float4*>(dyn);                 // nq
  u64* surv = reinterpret_cast<u64*>(dyn + 16 * (size_t)nq);   // kSurv
  u64* slot = surv + kSurv;                                    // pow2 >= d
  __shared__ Shared sh;
  const int b = blockIdx.x, t = threadIdx.x;
  const int base = b * blk, valid = min(blk, m - base);
  const float* src = g + base;
  const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  unsigned best = 0;                   // this thread's largest key
  for (int q = t; q < nq; q += kThreads) {
    const int p = 4 * q;
    float4 v;
    if (vec && p + 3 < valid) {
      v = __ldcs(reinterpret_cast<const float4*>(src) + q);
    } else {
      v.x = p < valid ? src[p] : -INFINITY;
      v.y = p + 1 < valid ? src[p + 1] : -INFINITY;
      v.z = p + 2 < valid ? src[p + 2] : -INFINITY;
      v.w = p + 3 < valid ? src[p + 3] : -INFINITY;
    }
    k4[q] = v;
    best = max(best, max(max(present_key(v.x), present_key(v.y)),
                         max(present_key(v.z), present_key(v.w))));
  }
  const float* kf = reinterpret_cast<const float*>(k4);
  const bool bounded = d <= kThreads;
  if (bounded && valid < 4 * kThreads) {
    // a short last block leaves threads without keys: take them one a
    // thread in turn, so that every warp holds maxima
    __syncthreads();
    best = 0;
    for (int p = t; p < valid; p += kThreads) best = max(best, present_key(kf[p]));
  }
  if (bounded) warp_bound(best, d, sh);
  if (t == 0) sh.n_surv = 0;
  __syncthreads();

  const BlockKeys keys{k4, nq};
  float* vrow = vals + (size_t)b * d;
  int* irow = idx + (size_t)b * d;
  auto put = [&](int r, u64 c) {
    const int p = (int)(0xffffu - (unsigned)(c & 0xffffu));
    vrow[r] = kf[p];
    irow[r] = base + p;
  };
  int n;
  if (bounded) {
    unsigned lk = 0xffffffffu;
    for (int w = 0; w < kWarps; ++w) lk = min(lk, sh.warp_bound[w]);
    keys.each([&](u64 c) {
      if (c != 0 && (unsigned)(c >> 16) >= lk) {
        const int s = atomicAdd(&sh.n_surv, 1);
        if (s < kSurv) surv[s] = c;
      }
    });
    __syncthreads();
    n = put_best(surv, sh.n_surv, d, 48, keys, slot, sh, put);
  } else {
    n = select_top(keys, d, 48, sh, slot);
    put_ranked(slot, n, put);
  }
  for (int r = n + t; r < d; r += kThreads) {    // the exhausted block's tail
    vrow[r] = -INFINITY;
    irow[r] = base;
  }
  if (out == nullptr) return;

  __threadfence();
  __syncthreads();
  if (t == 0) sh.last = atomicAdd(counter, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!sh.last) return;
  if (t == 0) *counter = 0;            // ready for the next launch
  __threadfence();
  merge(vals, gridDim.x, d, surv, slot, sh, [&](int r, u64 c) {
    out[r] = __ldcg(idx + (0xffffffffu - (unsigned)c));
  });
}

// Dynamic shared memory of one CTA: the keys (nq float4s, nq a multiple of
// kThreads), kSurv survivors and the slots (the next power of two >= d),
// composites of 8 B.
size_t topd_smem(int blk, int d, int* nq) {
  *nq = ((blk + 3) / 4 + kThreads - 1) / kThreads * kThreads;
  int n2 = 1;
  while (n2 < d) n2 <<= 1;
  return 16 * (size_t)*nq + 8 * (size_t)(kSurv + n2);
}

// ---------------------------------------------------------------------------
// The global path: d past the shared-memory budget.
//
// ps_topd's CTA holds the block's keys and a power of two >= d of 8-byte
// slots in shared memory; from d = 16,385 (blk = d) that passes the limit.
// There each block's candidates are all its keys, so the merged top-d is the
// d largest keys of the whole array by the merge's order (+0.0 above -0.0,
// the lower index first on equal bits), and past the keys above -inf the
// blocks' -inf tails in block order (d - f_b copies of b*blk for a block
// with f_b keys above -inf).  This path computes that over global memory,
// every launch on the caller's stream, no host read:
//   gs_init     zeroes the scratch (the select's state, the per-block
//               counts, the padded composites);
//   gs_hist x8  a radix select of the d-th largest 64-bit composite (the
//               key's order image above 0xffffffff - index), 8 bits a
//               pass from the top: a shared histogram a CTA, added into
//               the scratch; the last CTA (a completion counter) picks the
//               bin and ends the select when the bin is taken whole (the
//               later passes return at once);
//   gs_compact  the composites at or above the d-th into the scratch (and,
//               when fewer than d keys are above -inf, the per-block counts
//               of those that are);
//   gs_sort_*   a bitonic sort of the next power of two >= d composites,
//               descending: 2,048-composite tiles in shared memory, the
//               strides past a tile one global pass each;
//   gs_write    the indices in order, then the tails.
// Bound: the same bytes as ps_topd's (4 B a key read, 4 B an index
// written); the passes over the keys and the sort's launches set the time.

constexpr int kTile = 2048;          // composites a CTA sorts in shared memory
constexpr int kSortThreads = 1024;

struct GlobalSelect {
  u64 prefix;      // the composite's top bits fixed so far
  u64 cmin;        // selected: the nonzero composites >= cmin
  unsigned need;   // still to take below the prefix
  int done;        // the select has ended
  int n_sel;       // composites compacted
  int counter;     // CTAs of the current pass finished
  int short_;      // fewer than d keys above -inf
  unsigned hist[kBins];
};

__device__ __forceinline__ u64 global_comp(float x, int i) {
  return x > -INFINITY ? (u64)order_key(x) << 32 | (u64)(0xffffffffu - (unsigned)i)
                       : 0ull;
}

__global__ void __launch_bounds__(kThreads)
gs_init(GlobalSelect* st, int* fcount, int nb, u64* sel, int n2, int d) {
  const int i0 = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
  for (int i = i0; i < n2; i += stride) sel[i] = 0ull;
  for (int i = i0; i < nb; i += stride) fcount[i] = 0;
  if (i0 < kBins) st->hist[i0] = 0;
  if (i0 == 0) {
    st->prefix = 0;
    st->cmin = 1;
    st->need = (unsigned)d;
    st->done = 0;
    st->n_sel = 0;
    st->counter = 0;
    st->short_ = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
gs_hist(const float* __restrict__ g, int m, GlobalSelect* st, int shift) {
  __shared__ unsigned h[kBins];
  __shared__ int last;
  const int t = threadIdx.x;
  if (st->done) return;
  const u64 prefix = st->prefix;
  h[t] = 0;
  __syncthreads();
  for (int i = blockIdx.x * kThreads + t; i < m; i += gridDim.x * kThreads) {
    const u64 c = global_comp(g[i], i);
    if (c != 0 && (shift == 56 || (c >> (shift + 8)) == prefix))
      atomicAdd(&h[(unsigned)(c >> shift) & 0xffu], 1u);
  }
  __syncthreads();
  if (h[t]) atomicAdd(&st->hist[t], h[t]);
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(&st->counter, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  h[t] = __ldcg(&st->hist[t]);
  st->hist[t] = 0;                     // ready for the next pass
  __syncthreads();
  if (t < 32) {
    const unsigned need = st->need;
    const Pick pk = find_bin(h, need);
    if (t == 0) {
      st->counter = 0;
      if (pk.total < need) {           // the first pass: fewer than d keys
        st->cmin = 1;
        st->done = 1;
        st->short_ = 1;
      } else {
        const u64 p = prefix << 8 | pk.bin;
        st->prefix = p;
        st->need = need - pk.above;
        if (pk.cnt == need - pk.above || shift == 0) {
          st->cmin = p << shift;
          st->done = 1;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gs_compact(const float* __restrict__ g, int m, int blk, GlobalSelect* st,
           int* fcount, u64* sel) {
  const u64 cmin = st->cmin;
  const bool count = st->short_ != 0;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < m;
       i += gridDim.x * kThreads) {
    const u64 c = global_comp(g[i], i);
    if (c != 0 && c >= cmin) sel[atomicAdd(&st->n_sel, 1)] = c;
    if (count && c != 0) atomicAdd(&fcount[i / blk], 1);
  }
}

// Stages k in [k0, k1] of the descending bitonic network over a tile of
// `tile` composites in shared memory, the strides below the tile; a pair's
// direction comes from its global index, as in bitonic_desc.
__global__ void __launch_bounds__(kSortThreads)
gs_sort_tile(u64* sel, int tile, int k0, int k1) {
  __shared__ u64 s[kTile];
  const int base = blockIdx.x * tile, t = threadIdx.x;
  for (int i = t; i < tile; i += kSortThreads) s[i] = sel[base + i];
  __syncthreads();
  for (int k = k0; k <= k1; k <<= 1)
    for (int j = min(k, tile) >> 1; j > 0; j >>= 1) {
      for (int i = t; i < tile; i += kSortThreads) {
        const int l = i ^ j;
        if (l > i) {
          const u64 a = s[i], b = s[l];
          if ((((base + i) & k) == 0) == (a < b)) {
            s[i] = b;
            s[l] = a;
          }
        }
      }
      __syncthreads();
    }
  for (int i = t; i < tile; i += kSortThreads) sel[base + i] = s[i];
}

// One stride j >= kTile of stage k, over global memory.
__global__ void __launch_bounds__(kThreads)
gs_sort_stride(u64* sel, int n2, int k, int j) {
  for (int p = blockIdx.x * kThreads + threadIdx.x; p < n2 / 2;
       p += gridDim.x * kThreads) {
    const int i = (p / j) * 2 * j + p % j, l = i + j;
    const u64 a = sel[i], b = sel[l];
    if (((i & k) == 0) == (a < b)) {
      sel[i] = b;
      sel[l] = a;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gs_write(const u64* __restrict__ sel, const GlobalSelect* st,
         const int* __restrict__ fcount, int nb, int blk, int d, int* out) {
  const int n_sel = st->n_sel;
  for (int r = blockIdx.x * kThreads + threadIdx.x; r < d;
       r += gridDim.x * kThreads) {
    if (r < n_sel) {
      out[r] = (int)(0xffffffffu - (unsigned)(sel[r] & 0xffffffffull));
      continue;
    }
    int left = r - n_sel, b = 0;         // the tails, block by block
    for (; b < nb - 1 && left >= d - fcount[b]; ++b) left -= d - fcount[b];
    out[r] = b * blk;
  }
}

int next_pow2(int d) {
  int n2 = 1;
  while (n2 < d) n2 <<= 1;
  return n2 < kTile ? kTile : n2;
}

size_t global_scratch(int m, int blk, int d, int* nb, int* n2) {
  *nb = (m + blk - 1) / blk;
  *n2 = next_pow2(d);
  const size_t fc = (sizeof(GlobalSelect) + 4 * (size_t)*nb + 7) / 8 * 8;
  return fc + 8 * (size_t)*n2;
}

}  // namespace

extern "C" {

// Shared memory one CTA of ps_topd takes, dynamic and static, in bytes.
int ps_topd_smem(int blk, int d) {
  int nq = 0;
  return (int)(topd_smem(blk, d, &nq) + sizeof(Shared));
}

// g (m,) fp32 keys (any 4-byte alignment) -> vals (nb, d) fp32 and idx (nb,
// d) int32 global indices, nb = ceil(m / blk), the blocks' candidates; and,
// when out is not null, out (d,) int32, the merged top-d.  counter: one
// int32, 0 before the first launch on this stream; the launch leaves it 0.
int ps_topd(const float* g, int m, int blk, int d, float* vals, int* idx,
            int* out, int* counter, void* stream) {
  int nq = 0;
  const size_t smem = topd_smem(blk, d, &nq);
  if (smem + sizeof(Shared) > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        block_topd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int nb = (m + blk - 1) / blk;
  block_topd_kernel<<<nb, kThreads, smem, (cudaStream_t)stream>>>(
      g, m, blk, d, nq, vals, idx, out, counter);
  return (int)cudaGetLastError();
}

// Bytes of scratch ps_topd_global takes at (m, blk, d).
long long ps_topd_global_bytes(int m, int blk, int d) {
  int nb = 0, n2 = 0;
  return (long long)global_scratch(m, blk, d, &nb, &n2);
}

// The merged top-d of g (m,) fp32 when every block's candidates are all its
// keys (blk == d), through global memory: out (d,) int32, bitwise ps_topd's
// merged indices at the same (m, blk, d).  scratch: ps_topd_global_bytes,
// 8-byte aligned, any contents.
int ps_topd_global(const float* g, int m, int blk, int d, void* scratch,
                   int* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int nb = 0, n2 = 0;
  global_scratch(m, blk, d, &nb, &n2);
  GlobalSelect* st = reinterpret_cast<GlobalSelect*>(scratch);
  int* fcount = reinterpret_cast<int*>(st + 1);
  u64* sel = reinterpret_cast<u64*>(
      static_cast<char*>(scratch) +
      (sizeof(GlobalSelect) + 4 * (size_t)nb + 7) / 8 * 8);
  const int grid = min((m + 4 * kThreads - 1) / (4 * kThreads), 1056);
  gs_init<<<min((n2 + kThreads - 1) / kThreads, 1056), kThreads, 0, s>>>(
      st, fcount, nb, sel, n2, d);
  for (int shift = 56; shift >= 0; shift -= 8)
    gs_hist<<<grid, kThreads, 0, s>>>(g, m, st, shift);
  gs_compact<<<grid, kThreads, 0, s>>>(g, m, blk, st, fcount, sel);
  const int tile = min(n2, kTile);
  gs_sort_tile<<<n2 / tile, kSortThreads, 0, s>>>(sel, tile, 2, tile);
  for (int k = 2 * kTile; k <= n2; k <<= 1) {
    for (int j = k >> 1; j >= kTile; j >>= 1)
      gs_sort_stride<<<min(n2 / 2 / kThreads, 1056), kThreads, 0, s>>>(
          sel, n2, k, j);
    gs_sort_tile<<<n2 / kTile, kSortThreads, 0, s>>>(sel, kTile, k, k);
  }
  gs_write<<<(d + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      sel, st, fcount, nb, blk, d, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
