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
// Bound: operations, at bf16's tensor-core rate.  4 dh flops a live (row,
// key) pair: at B = 2, Hq = 24, S = 1024, dh = 128, causal, 12.9 GFLOP,
// 13.0 us at 989 TFLOP/s, against 25 MB of q, k, v and o (bf16), 7.5 us at
// 3.35 TB/s.  Two bodies, chosen by dtype and head dim:
//
// The tensor-core body (bf16, dh a multiple of 16; fa_mma_kernel).  A work
// item is a (128-row q tile, q head, batch), the last (longest, under the
// causal mask) q tiles first, with the key tiles of kv_block_range only.
// The kernel is persistent: one CTA of three warpgroups a SM takes items c,
// c + #CTAs, ..., so one item's start (its Q load, the first K and V tiles)
// and end (the output's stores) overlap its neighbours' work.  Each item
// serves one q head (the g q heads of a kv head read its K and V tiles from
// L2, not once for the group).  Warpgroup 2 is the producer: one thread
// issues TMA loads (cp.async.bulk.tensor, 4-D maps (dh, S, H, B) over the
// caller's strides, 128-byte swizzle, rows past S and columns past dh
// filled with zeros) of each item's Q into 2 buffers (1 at dh > 192) and of
// 64-key K and V tiles into a ring of 3 stages (2 at dh > 128), each
// buffer's and stage's arrival on an mbarrier, each released by the
// consumers' arrivals on another.  The head dim is held as 64-column
// (128-byte) chunks.  Warpgroups 0 and 1 are the consumers, 64 q rows each
// (setmaxnreg moves registers from the producer to them):
//   S = Q K^T    wgmma m64n64k16 bf16 x bf16 -> fp32, both from shared
//                memory (K-major, 128-byte swizzle), dh / 16 of them a tile;
//   softmax      the scale dh^-0.5 * log2(e) on the fp32 scores, the -1e30
//                mask (skipped on a tile whose keys are all live for the
//                warpgroup's rows) and the online softmax in exp2 (ex2.approx),
//                in registers on the accumulator's layout (a thread holds 2
//                rows x 16 keys; the row max and sum reduce over the 4 lanes
//                of a row);
//   O += P V     wgmma m64n64k16 with P from registers (the fp32 scores'
//                fragment repacked as bf16 pairs) and V from shared memory
//                (MN-major: the transposed descriptor), one a 64-column
//                chunk of dh.  P is split as hi = p cut to bf16 (its top 16
//                bits), lo = bf16(p - hi), two wgmma on the same V tile:
//                bf16(p) alone would move the output by about 2^-9 of its
//                scale, a bf16 ulp; hi + lo carries p to about 2^-16.
// O stays in registers and is divided by max(l, 1e-30), rounded to bf16 and
// stored through the output's strides once.  Shared memory: Q 128 x dh a
// buffer and K and V 64 x dh a stage, bf16 (161 KB at dh 128; smem_bytes in
// kernels/flash_attention.py mirrors it).  The wrapper raises on strides or
// pointers that are not 16-byte multiples (TMA's rule).  The tensor maps
// come from cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so the
// library needs no -lcuda.
//
// The FMA body (fp32, or bf16 with dh not a multiple of 16; fa_fwd_kernel),
// the first design, unchanged: one CTA of 256 threads a (64-row q tile, q
// head, batch); Q, K and V tiles staged in shared memory as fp32 (Q and K
// rows padded to dh + 1 floats); each thread owns 4 query rows: a 4 x 4
// micro-tile of scores and 4 x ceil(dh / 16) output columns in registers,
// the row statistics reduced over its 16-lane half-warp by shuffles; the
// probabilities pass through a (64, 65) shared tile to the P V product.  It
// runs on the fp32 units (67 TFLOP/s); fp32 on the tensor cores would be
// TF32, which the port keeps off.
//
// Tensors are read through their strides (unit stride on dh), so the model
// layout's (B, S, H, dh) views go in and out without a copy.  The entry
// point launches on the caller's stream and returns cudaGetLastError() (or
// cudaErrorInvalidValue when a tensor map cannot be made); the Python
// wrapper raises when it is not 0.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

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


// ---------------------------------------------------------------------------
// the tensor-core body: TMA, mbarriers and wgmma (bf16, dh % 16 == 0)
// ---------------------------------------------------------------------------

constexpr int MQ = 128;              // q rows a CTA: two consumer warpgroups
constexpr int NK = BLK;              // keys a tile
constexpr int CH = 64;               // head-dim columns a 128-byte chunk
constexpr int MMA_THREADS = 384;     // warpgroups 0-1 consume, 2 produces
constexpr float LOG2E = 1.4426950408889634f;

template <int NCH>                   // dh <= 64 * NCH
struct MmaTile {
  static constexpr int kStages = NCH <= 2 ? 3 : 2;  // K and V tiles
  static constexpr int kQBufs = NCH <= 3 ? 2 : 1;   // Q tiles
  static constexpr int kChunkQ = MQ * 128;         // bytes of a Q chunk
  static constexpr int kChunkKV = NK * 128;        // of a K or V chunk
  static constexpr int kQBytes = NCH * kChunkQ;
  static constexpr int kStageBytes = 2 * NCH * kChunkKV;
  // q_full[], q_empty[], full[], empty[]
  static constexpr int kBars = 2 * kQBufs + 2 * kStages;
  // 1024 bytes of slack to align the swizzled tiles
  static constexpr int kSmem = 1024 + kQBufs * kQBytes +
                               kStages * kStageBytes + 8 * kBars;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}" ::"r"(
          bar) : "memory");
}

// Returns once the phase of parity `parity` has completed.  A wait that
// never completes (a TMA that faulted) traps after 2^24 tries, so the
// caller sees a launch failure instead of a card that never returns.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t n = 0;; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (n == (1u << 24)) __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3) : "memory");
}

// A wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define WG_D32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WG_OUT32(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (64 x 64 fp32) (+)= A (64 x 16) B (16 x 64), both from shared memory,
// K-major; d is overwritten when accumulate is 0.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}"
      : WG_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 fp32) += A (64 x 16, bf16 pairs in registers) B (16 x 64), B
// from shared memory MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x on the special-function unit (relative error ~2^-22); ex2(0) = 1 and
// ex2(-1e30) = 0, which the masked-row semantics need.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One work item of the persistent kernel: a 128-row q tile (the longest,
// under the causal mask, first) of one q head and batch, and its key tiles
// [lo, hi) (kv_block_range).
struct Item {
  int q0, h, b, lo, hi;
  __device__ __forceinline__ Item(int i, int Hq, int B, int S, int causal,
                                  int window) {
    const int nqb = (S + MQ - 1) / MQ;
    q0 = (nqb - 1 - i / (Hq * B)) * MQ;
    h = i % Hq;
    b = i / Hq % B;
    const int q1 = min(q0 + MQ, S);
    lo = (window && q0 - window + 1 > 0) ? (q0 - window + 1) / NK : 0;
    hi = causal ? (q1 - 1) / NK + 1 : (S + NK - 1) / NK;
  }
};

// The accumulator layout of a 64 x 64 wgmma tile, thread t of the
// warpgroup (warp w = t / 32, lane l): d[4i + r] is row 16 w + l / 4 (+ 8
// for r >= 2), column 8 i + 2 (l % 4) + (r & 1).
//
// Persistent: CTA c takes items c, c + gridDim.x, ... (one CTA a SM), so
// the producer loads the next item's Q (double-buffered where shared memory
// allows) and K and V tiles while the consumers finish this one and store
// its output.
template <int NCH>
__global__ void __launch_bounds__(MMA_THREADS, 1)
fa_mma_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              __nv_bfloat16* __restrict__ o, long long so_b, long long so_h,
              long long so_s, int B, int Hq, int g, int S, int dh, int causal,
              int window, float scale_log2) {
  using Tile = MmaTile<NCH>;
  constexpr int ST = Tile::kStages, QB = Tile::kQBufs;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t qs = (raw + 1023) & ~1023u;       // Q buffers: NCH chunks
  const uint32_t kvs = qs + QB * Tile::kQBytes;    // stages: K chunks, V chunks
  const uint32_t bars = kvs + ST * Tile::kStageBytes;
  auto q_full = [&](int x) { return bars + 8 * x; };
  auto q_empty = [&](int x) { return bars + 8 * (QB + x); };
  auto full = [&](int x) { return bars + 8 * (2 * QB + x); };
  auto empty = [&](int x) { return bars + 8 * (2 * QB + ST + x); };
  const int items = (S + MQ - 1) / MQ * Hq * B;

  if (threadIdx.x == 0) {
    for (int x = 0; x < QB; ++x) {
      mbar_init(q_full(x), 1);
      mbar_init(q_empty(x), 2 * 128);  // every consumer thread
    }
    for (int x = 0; x < ST; ++x) {
      mbar_init(full(x), 1);
      mbar_init(empty(x), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 2 * 128) {
      int st = 0, ph = 0, n = 0;    // K/V stage, its parity, tiles issued
      for (int k = 0, i = blockIdx.x; i < items; ++k, i += gridDim.x) {
        const Item it(i, Hq, B, S, causal, window);
        const int qb = k % QB;
        if (k >= QB) mbar_wait(q_empty(qb), (k / QB - 1) & 1);
        mbar_expect_tx(q_full(qb), Tile::kQBytes);
        for (int c = 0; c < NCH; ++c)
          tma_load(qs + qb * Tile::kQBytes + c * Tile::kChunkQ, &tq,
                   q_full(qb), c * CH, it.q0, it.h, it.b);
        for (int kb = it.lo; kb < it.hi; ++kb, ++n) {
          if (n >= ST) mbar_wait(empty(st), ph ^ 1);
          mbar_expect_tx(full(st), Tile::kStageBytes);
          const uint32_t ks = kvs + st * Tile::kStageBytes;
          const uint32_t vs = ks + NCH * Tile::kChunkKV;
          for (int c = 0; c < NCH; ++c) {
            tma_load(ks + c * Tile::kChunkKV, &tk, full(st), c * CH,
                     kb * NK, it.h / g, it.b);
            tma_load(vs + c * Tile::kChunkKV, &tv, full(st), c * CH,
                     kb * NK, it.h / g, it.b);
          }
          if (++st == ST) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: q rows [q0 + 64 wg, q0 + 64 wg + 64) of each item ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int t = threadIdx.x & 127, lane = t & 31;
    const int cq = 2 * (lane & 3);   // column of d[4i] within its 8
    int st = 0, ph = 0;
    for (int k = 0, i = blockIdx.x; i < items; ++k, i += gridDim.x) {
      const Item it(i, Hq, B, S, causal, window);
      const int wr0 = it.q0 + 64 * wg;
      const int row0 = wr0 + 16 * (t >> 5) + (lane >> 2);
      const int row1 = row0 + 8;
      const int qb = k % QB;
      float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
      float acc[NCH][32];
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int j = 0; j < 32; ++j) acc[c][j] = 0.f;
      const uint32_t qw = qs + qb * Tile::kQBytes + wg * 64 * 128;
      mbar_wait(q_full(qb), (k / QB) & 1);
      for (int kb = it.lo; kb < it.hi; ++kb) {
        mbar_wait(full(st), ph);
        const uint32_t ks = kvs + st * Tile::kStageBytes;
        const uint32_t vs = ks + NCH * Tile::kChunkKV;
        float s[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) s[j] = 0.f;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4 * NCH; ++kk) {
          const uint32_t off = (kk & 3) * 32;    // 16 columns, 32 bytes
          wgmma_ss(s,
                   sw128_desc(qw + (kk >> 2) * Tile::kChunkQ + off, 16, 1024),
                   sw128_desc(ks + (kk >> 2) * Tile::kChunkKV + off, 16, 1024),
                   kk > 0);
        }
        wg_commit();
        wg_wait_all();
        hold(s);

        // mask, scale and the online softmax on the accumulator's layout; a
        // tile whose keys are all live for the warpgroup's 64 rows skips the
        // mask
        const int k0 = kb * NK;
        const bool inside = k0 + NK <= S && (!causal || k0 + NK - 1 <= wr0) &&
                            (!window || k0 > wr0 + 63 - window);
        float mx0 = NEG_INF, mx1 = NEG_INF;
        if (inside) {
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            s[j] *= scale_log2;
            if (j & 2) mx1 = fmaxf(mx1, s[j]); else mx0 = fmaxf(mx0, s[j]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int col = k0 + 8 * (j >> 2) + cq + (j & 1);
            const int row = (j & 2) ? row1 : row0;
            const bool live = col < S && (!causal || col <= row) &&
                              (!window || col > row - window);
            s[j] = live ? s[j] * scale_log2 : NEG_INF;
            if (j & 2) mx1 = fmaxf(mx1, s[j]); else mx0 = fmaxf(mx0, s[j]);
          }
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float corr0 = ex2(m0 - mn0), corr1 = ex2(m1 - mn1);
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          s[j] = ex2(s[j] - ((j & 2) ? mn1 : mn0));
          if (j & 2) sum1 += s[j]; else sum0 += s[j];
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
          sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
        }
        l0 = l0 * corr0 + sum0;
        l1 = l1 * corr1 + sum1;
        m0 = mn0;
        m1 = mn1;
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int j = 0; j < 32; ++j) acc[c][j] *= (j & 2) ? corr1 : corr0;

        // P as the A operand, hi = p cut to bf16 (exact: its top 16 bits)
        // and lo = bf16(p - hi): keys [16 kk, 16 kk + 16) are d[8 kk ..
        // 8 kk + 8), register r the pair (d[8 kk + 2 r], d[8 kk + 2 r + 1])
        uint32_t phi[4][4], plo[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float a = s[8 * kk + 2 * r], c = s[8 * kk + 2 * r + 1];
            const uint32_t ha = __float_as_uint(a) & 0xffff0000u;
            const uint32_t hc = __float_as_uint(c) & 0xffff0000u;
            phi[kk][r] = __byte_perm(ha, hc, 0x7632);
            plo[kk][r] = pack_bf16(a - __uint_as_float(ha),
                                   c - __uint_as_float(hc));
          }
        wg_fence();
#pragma unroll
        for (int c = 0; c < NCH; ++c) hold(acc[c]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
            const uint64_t dv = sw128_desc(
                vs + c * Tile::kChunkKV + kk * 16 * 128, Tile::kChunkKV, 1024);
            wgmma_rs(acc[c], phi[kk], dv);
            wgmma_rs(acc[c], plo[kk], dv);
          }
        wg_commit();
        wg_wait_all();
#pragma unroll
        for (int c = 0; c < NCH; ++c) hold(acc[c]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          hold(phi[kk]);
          hold(plo[kk]);
        }
        mbar_arrive(empty(st));
        if (++st == ST) {
          st = 0;
          ph ^= 1;
        }
      }
      mbar_arrive(q_empty(qb));

      const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
      __nv_bfloat16* oh = o + it.b * so_b + it.h * so_h;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int i8 = 0; i8 < 8; ++i8) {
          const int col = c * CH + 8 * i8 + cq;
          if (col >= dh) continue;
          if (row0 < S)
            *reinterpret_cast<__nv_bfloat162*>(oh + row0 * so_s + col) =
                __floats2bfloat162_rn(acc[c][4 * i8] / d0,
                                      acc[c][4 * i8 + 1] / d0);
          if (row1 < S)
            *reinterpret_cast<__nv_bfloat162*>(oh + row1 * so_s + col) =
                __floats2bfloat162_rn(acc[c][4 * i8 + 2] / d1,
                                      acc[c][4 * i8 + 3] / d1);
        }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found =
        cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A 4-D map (dh, S, H, B) of bf16 over element strides st = (batch, head,
// seq), boxes of 64 columns x `rows` rows, 128-byte swizzle, zeros outside.
bool make_map(CUtensorMap* map, const void* ptr, const long long* st, int B,
              int H, int S, int dh, int rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)S, (cuuint64_t)H,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                           (cuuint64_t)st[0] * 2};
  cuuint32_t box[4] = {(cuuint32_t)CH, (cuuint32_t)rows, 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NCH>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               const Strides& st, int B, int Hq, int Hkv, int S, int dh,
               int causal, int window, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, st.q, B, Hq, S, dh, MQ) ||
      !make_map(&tk, k, st.k, B, Hkv, S, dh, NK) ||
      !make_map(&tv, v, st.v, B, Hkv, S, dh, NK))
    return (int)cudaErrorInvalidValue;
  auto fn = fa_mma_kernel<NCH>;
  const int smem = MmaTile<NCH>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long items = (long long)((S + MQ - 1) / MQ) * Hq * B;
  if (items >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  fn<<<(int)(items < sms ? items : sms), MMA_THREADS, smem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, st.o[0], st.o[1], st.o[2], B, Hq,
      Hq / Hkv, S, dh, causal, window, scale * LOG2E);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v, void* o,
                const Strides& st, int B, int Hq, int Hkv, int S, int dh,
                int causal, int window, float scale, cudaStream_t stream) {
  if (dh % 16)
    return launch_dh<__nv_bfloat16>(q, k, v, o, st, B, Hq, Hkv, S, dh, causal,
                                    window, scale, stream);
  switch ((dh + CH - 1) / CH) {
    case 1:
      return launch_mma<1>(q, k, v, o, st, B, Hq, Hkv, S, dh, causal, window,
                           scale, stream);
    case 2:
      return launch_mma<2>(q, k, v, o, st, B, Hq, Hkv, S, dh, causal, window,
                           scale, stream);
    case 3:
      return launch_mma<3>(q, k, v, o, st, B, Hq, Hkv, S, dh, causal, window,
                           scale, stream);
    default:
      return launch_mma<4>(q, k, v, o, st, B, Hq, Hkv, S, dh, causal, window,
                           scale, stream);
  }
}

}  // namespace

extern "C" {

// q (B, Hq, S, dh), k/v (B, Hkv, S, dh), o (B, Hq, S, dh) through
// strides[12] = (batch, head, seq) element strides of q, k, v, o; dtype 0 fp32,
// 1 bf16 (all four alike).  bf16 with dh % 16 == 0 takes the tensor-core
// body, whose strides and pointers must be 16-byte multiples.
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
  return dtype ? launch_bf16(q, k, v, o, st, B, Hq, Hkv, S, dh, causal,
                             window, scale, s)
               : launch_dh<float>(q, k, v, o, st, B, Hq, Hkv, S, dh, causal,
                                  window, scale, s);
}

}  // extern "C"
