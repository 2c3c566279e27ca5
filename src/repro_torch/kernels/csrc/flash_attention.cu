// Flash attention: online-softmax GQA attention with causal and
// sliding-window masks, hand-written for Hopper (sm_90a) on the tensor
// cores: bf16 inputs with mma.sync.m16n8k16 (f32 accumulation), f32 inputs
// in 3×TF32 with mma.sync.m16n8k8 (f32 accuracy).
//
// Replaces the TPU Pallas kernel of the JAX package:
//   repro/kernels/flash_attention.py:72 flash_attention
//   (pallas_call :91, kernel body _kernel :27)
//
// q (B, S, H, D), k and v (B, T, K, D) with H % K == 0; query head h reads
// kv head h / (H / K). Positions are the indices: key c is masked for query
// r when causal and c > r, or when window > 0 and r - c >= window. A masked
// score is -1e30, not -inf, as in the Pallas kernel, so a query row with no
// unmasked key at all averages v over every key; keys past T are excluded
// (p = 0). The output is (B, S, H, D), contiguous, in q's dtype; scores,
// softmax and the accumulator are f32, the output acc / max(l, 1e-30), and
// in bf16 the probabilities are rounded to bf16 once, before the p·v
// product, as the Pallas kernel's p.astype(v.dtype). q, k and v are read
// through their strides (the last axis contiguous, rows 16-byte aligned).
//
// What bounds it on this card: per unmasked (query, key) pair the two
// products do 4·D flops, and a head reads its q, k and v once: at S = T =
// 8192 and D = 128 that is ~2000 flops per byte, far right of the ridge, so
// the tensor cores bound it: 989 TFLOP/s in bf16, and 3·flops at the 495
// TFLOP/s TF32 rate in f32 (three products per pair of operands). mma.sync
// itself reaches about 62% of those rates here (csrc/probe/mma_ceiling.cu);
// wgmma is the way to the rest.
//
// Design (FlashAttention-2's structure on mma.sync):
//   * grid (q tile, q head, batch); NW warps, each owning RM 16-row
//     m-tiles of the q tile (BQ = 16·RM·NW): with RM = 2 each k and v
//     fragment read from shared memory feeds two mma, which halves those
//     reads per mma where the registers allow it. The heaviest causal q
//     tiles launch first (blockIdx.x reversed). The tile sizes are
//     compile-time per head width and dtype (tile_sizes below).
//   * the q tile is staged once; BK-row k and v tiles stream through a ring
//     of STAGES shared-memory stages with cp.async (zero-filled past T), so
//     the next tiles load while one is multiplied. Rows are padded by 16
//     bytes: an odd number of 16-byte chunks per row (bf16) or a row stride
//     of 4 banks mod 32 (f32) keeps ldmatrix and the fragment reads free of
//     bank conflicts with plain row-major addressing.
//   * S = Q·Kᵀ stays in registers (m16n8 accumulator fragments); the online
//     softmax runs on them: row max and row sum over the 4 lanes of a quad
//     (2 xor-shuffles), scores in log2 units (scale·log2e folded into one
//     FMA before exp2f on tiles without masks), the row sum l kept per lane
//     and reduced once at the end. P stays in registers: the m16n8
//     accumulator layout is the A-operand layout of the next product.
//   * bf16: Q fragments are loaded once with ldmatrix and kept in
//     registers where RM·D <= 128 (else read per kv tile, to stay clear of
//     spills), K fragments with ldmatrix, V's with ldmatrix.trans; P is
//     packed to bf16 (the one rounding) and O accumulates in the tensor
//     cores' f32.
//   * f32, 3×TF32: each operand x is split into hi = cvt.rna.tf32(x) and lo
//     = x - hi (read as tf32), and each product takes lo·hi, hi·lo and
//     hi·hi (never 1×TF32), the three passes interleaved over independent
//     accumulators. At D <= 128 each k and v tile is split once for the
//     block as it lands (hi in place, lo in a buffer beside the ring): on
//     sm_90 cvt.rna.tf32 is four instructions, which every warp would
//     repeat; that measured 5–9% faster than splitting in registers
//     (launch/bench_attention.py). At D = 256 the copy does not fit beside
//     the q tile and the ring, and the warps split k and v as they read
//     them. q and P are split in registers. The m16n8k8 accumulator holds
//     columns 2t, 2t+1 where the tf32 A operand wants t, t+4, so P·V
//     permutes its k index: A's column t is key 2t, t + 4 is key 2t + 1,
//     and V's B fragment is read from rows 2t and 2t + 1. Each kv tile's P·V goes to fresh accumulators
//     that are added to acc·alpha in f32 (chaining the tensor cores'
//     accumulation over all keys is what missed the 1e-5 bar in the spmm
//     kernels); Q·Kᵀ chains over the head dim, 3·D/8 steps
//     (tests/test_torch_flash_schedule.py emulates both within the 2e-5
//     bar).
//   * masks only where needed: a warp whose rows all see every key of the
//     tile unmasked (inside the causal diagonal and the window, below T)
//     skips the mask arithmetic. Tiles that no (query, key) pair of the q
//     tile leaves unmasked are skipped: with every query row holding at
//     least one unmasked key, such a tile changes nothing, exactly (alpha =
//     1, p = 0 after a real key; before one, the first real key's alpha = 0
//     wipes it). A q tile with a row that has no unmasked key walks every k
//     tile, as the Pallas grid does, so that row gets the mean of v.
//   * the epilogue normalises O, stages it through the warp's own q rows in
//     shared memory and writes 16-byte stores. No atomics: two launches on
//     one input are bitwise equal.
//   * the C entry point launches on the caller's stream, allocates nothing,
//     and returns cudaGetLastError() so a refused launch is seen.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float MASKED = -1e30f;  // a masked score (the log2 units keep it)
constexpr float LOG2E = 1.4426950408889634f;

// Tile sizes per head width and dtype: NW warps of RM 16-row m-tiles each
// (BQ = 16·RM·NW query rows per block), BK keys per k / v tile, STAGES ring
// stages, and for f32 whether k and v are split once per tile in shared
// memory. Chosen by the sweep of launch/bench_attention.py on the H100,
// among the variants that do not spill (PERF.md); FA_NW, FA_BK, FA_STAGES,
// FA_RM and FA_SPLIT override them for that sweep.
struct TileSizes {
  int nw, bk, stages, rm;
  bool split;
};

constexpr TileSizes tile_sizes(int d, bool bf16) {
  if (bf16) {
    switch (d) {
      case 32:
      case 64: return {4, 64, 2, 2, false};
      case 128: return {4, 32, 2, 2, false};
      default: return {8, 64, 2, 1, false};
    }
  }
  switch (d) {
    case 32: return {8, 64, 3, 2, true};
    case 64: return {8, 64, 3, 1, true};
    case 128: return {8, 48, 2, 1, true};
    // no room for a split copy beside the q tile and the ring
    default: return {8, 16, 2, 1, false};
  }
}

#ifndef FA_NW
#define FA_NW 0
#endif
#ifndef FA_BK
#define FA_BK 0
#endif
#ifndef FA_STAGES
#define FA_STAGES 0
#endif
#ifndef FA_RM
#define FA_RM 0
#endif
#ifndef FA_SPLIT
#define FA_SPLIT -1
#endif


template <int D, bool BF16>
struct Tiles {
  static constexpr TileSizes base = tile_sizes(D, BF16);
  static constexpr int NW = FA_NW ? FA_NW : base.nw;
  static constexpr int BK = FA_BK ? FA_BK : base.bk;
  static constexpr int STAGES = FA_STAGES ? FA_STAGES : base.stages;
  static constexpr int RM = FA_RM ? FA_RM : base.rm;
  static constexpr bool SPLIT = !BF16 && (FA_SPLIT < 0 ? base.split : FA_SPLIT);
};

template <int D, typename T>
struct Cfg {
  static constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int NW = Tiles<D, BF16>::NW;  // warps
  static constexpr int BK = Tiles<D, BF16>::BK;
  static constexpr int STAGES = Tiles<D, BF16>::STAGES;
  static constexpr int RM = Tiles<D, BF16>::RM;  // 16-row m-tiles per warp
  static constexpr int BQ = 16 * RM * NW;
  static constexpr int THREADS = 32 * NW;
  static constexpr int LD = D + 16 / (int)sizeof(T);  // padded row, elements
  static constexpr int Q_ELEMS = BQ * LD;
  static constexpr int KV_ELEMS = BK * LD;
  // f32: k and v split into hi and lo once per tile, in shared memory
  static constexpr bool SPLIT = Tiles<D, BF16>::SPLIT;
  static constexpr size_t SMEM =
      sizeof(T) * (size_t)(Q_ELEMS + (STAGES + SPLIT) * 2 * KV_ELEMS);
  static constexpr bool Q_IN_REGS = BF16 && RM * D <= 128;
  static_assert(STAGES >= 2, "the ring needs two stages");
  static_assert(BK % 16 == 0 && D % 32 == 0, "tile shapes");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 fills the destination with zeros.
__device__ __forceinline__ void cp16(void* dst, const void* src,
                                     int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The mma steps are register-only: not volatile, so that the compiler may
// interleave independent accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 3×TF32 split x = hi + lo: hi = tf32(x) rounded to nearest, lo the
// exact f32 rest, read by the tensor cores as tf32 (truncated).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// One 8-deep 3×TF32 step on N independent accumulators, d[n] += a·b[n]:
// per accumulator the small terms first (lo·hi, hi·lo, hi·hi), the passes
// interleaved across the accumulators so that no mma waits on the one
// before it.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (&d)[N][4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           const uint32_t (&bhi)[N][2],
                                           const uint32_t (&blo)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], alo, bhi[n][0], bhi[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], ahi, blo[n][0], blo[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], ahi, bhi[n][0], bhi[n][1]);
}

// The 3×TF32 operand x[i]: split here, or read from its split copy (hi in
// x, lo in x_lo) when PRESPLIT.
template <bool PRESPLIT>
__device__ __forceinline__ void operand(const float* x, const float* x_lo,
                                        int i, uint32_t& hi, uint32_t& lo) {
  if constexpr (PRESPLIT) {
    hi = __float_as_uint(x[i]);
    lo = __float_as_uint(x_lo[i]);
  } else {
    split_tf32(x[i], hi, lo);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Keys [lo(r), hi(r)] are the unmasked ones of query r; empty when lo > hi.
__device__ __forceinline__ int key_hi(int r, int T, bool causal) {
  return causal ? min(r, T - 1) : T - 1;
}
__device__ __forceinline__ int key_lo(int r, int window) {
  return window > 0 ? max(0, r - window + 1) : 0;
}

// Stage rows [row0, row0 + ROWS) of one head of x into s (ROWS × LD);
// rows past n_rows are zero-filled.
template <int ROWS, int D, int LD, int THREADS, typename T>
__device__ __forceinline__ void stage_rows(T* s, const T* x,
                                           long long row_stride, int row0,
                                           int n_rows) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = D / EPC;         // chunks per row
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR;
    const int c = i % CPR;
    const int row = row0 + r;
    const bool in = row < n_rows;
    cp16(s + r * LD + c * EPC, x + (in ? row * row_stride : 0) + c * EPC,
         in ? 16 : 0);
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(Cfg<D, T>::THREADS, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int T_len, int H, int K, long long sqb, long long sqs,
                       long long sqh, long long skb, long long skt,
                       long long skh, long long svb, long long svt,
                       long long svh, float scale, int causal, int window) {
  using C = Cfg<D, T>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, RM = C::RM;
  constexpr int NS = BK / 8;  // key n-tiles of 8 columns
  constexpr int NO = D / 8;   // output n-tiles of 8 columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // BQ × LD
  T* ring = qs + C::Q_ELEMS;               // stage s: k at 2s, v at 2s + 1

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / K);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t = lane & 3;   // fragment column pair
  const int wr = 16 * RM * warp;  // this warp's first row in the tile
  const int r0 = q0 + wr;

  const T* qp = q + b * sqb + h * sqh;
  const T* kp = k + b * skb + kvh * skh;
  const T* vp = v + b * svb + kvh * svh;

  // Does every valid query row of this tile have an unmasked key?
  bool live = true;
  if (threadIdx.x < BQ) {
    const int r = q0 + threadIdx.x;
    if (r < S && key_lo(r, window) > key_hi(r, T_len, causal)) live = false;
  }
  const bool all_rows_live = __syncthreads_and(live);
  int kt_begin = 0, kt_end = (T_len + BK - 1) / BK;
  if (all_rows_live) {
    // The rows' key ranges are contiguous and nondecreasing in r, so the
    // tile's unmasked keys are exactly [lo(q0), hi(q_last)].
    const int q_last = min(q0 + BQ, S) - 1;
    kt_begin = key_lo(q0, window) / BK;
    kt_end = key_hi(q_last, T_len, causal) / BK + 1;
  }
  const int n_tiles = kt_end - kt_begin;

  auto load_kv = [&](int i) {
    T* st = ring + ((i % C::STAGES) * 2) * C::KV_ELEMS;
    const int k0 = (kt_begin + i) * BK;
    stage_rows<BK, D, LD, C::THREADS>(st, kp, skt, k0, T_len);
    stage_rows<BK, D, LD, C::THREADS>(st + C::KV_ELEMS, vp, svt, k0, T_len);
  };

  stage_rows<BQ, D, LD, C::THREADS>(qs, qp, sqs, q0, S);  // group 0 with tile 0
#pragma unroll
  for (int i = 0; i < C::STAGES - 1; ++i) {
    if (i < n_tiles) load_kv(i);
    cp_commit();
  }

  // Per 16-row m-tile i of the warp: the output accumulator, the row max m
  // (log2 units) and this lane's part of the row sum l, for rows g (hf =
  // 0) and g + 8 (hf = 1).
  float o[RM][NO][4];
  float m[RM][2], l[RM][2];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      m[i][hf] = -INFINITY;
      l[i][hf] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][j][e] = 0.f;
  }
  const float c = scale * LOG2E;
  uint32_t qf[C::Q_IN_REGS ? RM : 1][C::Q_IN_REGS ? D / 16 : 1][4];

  for (int it = 0; it < n_tiles; ++it) {
    cp_wait<C::STAGES - 2>();  // tile it (and q) have landed
    __syncthreads();           // ... for every thread; tile it-1 is consumed
    if (it + C::STAGES - 1 < n_tiles) load_kv(it + C::STAGES - 1);
    cp_commit();
    const T* ks = ring + ((it % C::STAGES) * 2) * C::KV_ELEMS;
    const T* vs = ks + C::KV_ELEMS;
    const int k0 = (kt_begin + it) * BK;
    [[maybe_unused]] float* lo_buf =
        reinterpret_cast<float*>(ring + C::STAGES * 2 * C::KV_ELEMS);
    if constexpr (C::SPLIT) {
      // k and v rows (2·BK, contiguous) split once for the block: hi in
      // place, lo into lo_buf (free: the previous tile is consumed)
      float* kv = reinterpret_cast<float*>(const_cast<T*>(ks));
      for (int i = threadIdx.x; i < 2 * BK * (D / 4); i += C::THREADS) {
        const int off = (i / (D / 4)) * LD + 4 * (i % (D / 4));
        float4 x = *reinterpret_cast<float4*>(kv + off), lo;
        auto split = [](float& v, float& v_lo) {
          uint32_t h, l;
          split_tf32(v, h, l);
          v = __uint_as_float(h);
          v_lo = __uint_as_float(l);
        };
        split(x.x, lo.x);
        split(x.y, lo.y);
        split(x.z, lo.z);
        split(x.w, lo.w);
        *reinterpret_cast<float4*>(kv + off) = x;
        *reinterpret_cast<float4*>(lo_buf + off) = lo;
      }
      __syncthreads();
    }

    // ---- S = Q·Kᵀ (16·RM rows × BK keys per warp) ----
    float s[RM][NS][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][j][e] = 0.f;
    if constexpr (C::BF16) {
      // A fragment of m-tile i at k-step kk: ldmatrix of its 16 q rows
      auto q_frag = [&](uint32_t(&a)[4], int i, int kk) {
        ldsm_x4(a, qs + (wr + 16 * i + (lane & 15)) * LD + 16 * kk +
                       (lane >> 4) * 8);
      };
      if constexpr (C::Q_IN_REGS) {
        if (it == 0) {
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) q_frag(qf[i][kk], i, kk);
        }
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[RM][4];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          if constexpr (C::Q_IN_REGS) {
#pragma unroll
            for (int e = 0; e < 4; ++e) a[i][e] = qf[i][kk][e];
          } else {
            q_frag(a[i], i, kk);
          }
        }
#pragma unroll
        for (int jp = 0; jp < NS / 2; ++jp) {
          uint32_t bb[4];  // key n-tiles 2jp and 2jp + 1, shared by the m-tiles
          ldsm_x4(bb, ks + (16 * jp + (lane & 7) + ((lane >> 4) << 3)) * LD +
                          16 * kk + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            mma_bf16(s[i][2 * jp], a[i], bb[0], bb[1]);
            mma_bf16(s[i][2 * jp + 1], a[i], bb[2], bb[3]);
          }
        }
      }
    } else {
      const float* qw = reinterpret_cast<const float*>(qs) + wr * LD;
      const float* kf = reinterpret_cast<const float*>(ks);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        uint32_t bhi[NS][2], blo[NS][2];
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const int i = (8 * j + g) * LD + 8 * kk + t;
          operand<C::SPLIT>(kf, lo_buf, i, bhi[j][0], blo[j][0]);
          operand<C::SPLIT>(kf, lo_buf, i + 4, bhi[j][1], blo[j][1]);
        }
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float* qi = qw + (16 * i + g) * LD + 8 * kk + t;
          uint32_t ahi[4], alo[4];
          split_tf32(qi[0], ahi[0], alo[0]);
          split_tf32(qi[8 * LD], ahi[1], alo[1]);
          split_tf32(qi[4], ahi[2], alo[2]);
          split_tf32(qi[8 * LD + 4], ahi[3], alo[3]);
          mma_3xtf32(s[i], ahi, alo, bhi, blo);
        }
      }
    }

    // ---- masks and the online softmax on the fragments ----
    // Lane (g, t) holds, per m-tile i and key n-tile j, rows 16i + g (e =
    // 0, 1) and 16i + g + 8 (e = 2, 3) at keys 8j + 2t + (e & 1).
    const bool need_mask = k0 + BK > T_len ||
                           (causal && k0 + BK - 1 > r0) ||
                           (window > 0 && r0 + 16 * RM - 1 - k0 >= window);
    float mul = c;  // raw scores times c: log2 units, folded into the exp2 FMA
    if (need_mask) {
      mul = 1.f;
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + 8 * j + 2 * t + (e & 1);
            const int row = r0 + 16 * i + g + 8 * (e >> 1);
            float x = s[i][j][e] * c;
            if (col >= T_len)
              x = -INFINITY;  // past the keys: excluded, p = 0
            else if ((causal && col > row) ||
                     (window > 0 && row - col >= window))
              x = MASKED;
            s[i][j][e] = x;
          }
    }
    float alpha[RM][2];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NS; ++j)
          mx = fmaxf(mx, fmaxf(s[i][j][2 * hf], s[i][j][2 * hf + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i][hf], mx * mul);
        alpha[i][hf] = exp2f(m[i][hf] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
            const float p = exp2f(fmaf(s[i][j][e], mul, -m_new));
            s[i][j][e] = p;
            sum += p;
          }
        l[i][hf] = l[i][hf] * alpha[i][hf] + sum;
        m[i][hf] = m_new;
      }

    // ---- O = O·alpha + P·V ----
    if constexpr (C::BF16) {
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < NO; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[i][j][e] *= alpha[i][e >> 1];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[RM][4];  // P rounded to bf16 once, in the A-operand layout
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          a[i][0] = pack_bf16(s[i][2 * kk][0], s[i][2 * kk][1]);
          a[i][1] = pack_bf16(s[i][2 * kk][2], s[i][2 * kk][3]);
          a[i][2] = pack_bf16(s[i][2 * kk + 1][0], s[i][2 * kk + 1][1]);
          a[i][3] = pack_bf16(s[i][2 * kk + 1][2], s[i][2 * kk + 1][3]);
        }
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          uint32_t bb[4];  // output n-tiles 2np and 2np + 1
          ldsm_x4_t(bb, vs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                            16 * np + (lane >> 4) * 8);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            mma_bf16(o[i][2 * np], a[i], bb[0], bb[1]);
            mma_bf16(o[i][2 * np + 1], a[i], bb[2], bb[3]);
          }
        }
      }
    } else {
      // A fragment of k-step j, k permuted: column t is key 8j + 2t (e = 0
      // and 2 of S's n-tile j), column t + 4 is key 8j + 2t + 1 (e = 1, 3).
      uint32_t phi[RM][NS][4], plo[RM][NS][4];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          split_tf32(s[i][j][0], phi[i][j][0], plo[i][j][0]);
          split_tf32(s[i][j][2], phi[i][j][1], plo[i][j][1]);
          split_tf32(s[i][j][1], phi[i][j][2], plo[i][j][2]);
          split_tf32(s[i][j][3], phi[i][j][3], plo[i][j][3]);
        }
      const float* vf = reinterpret_cast<const float*>(vs);
      constexpr int NG = NO < 4 ? NO : 4;  // output n-tiles per group
#pragma unroll
      for (int n0 = 0; n0 < NO; n0 += NG) {
        float f[RM][NG][4];  // this tile's P·V, fresh
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int n = 0; n < NG; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) f[i][n][e] = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          uint32_t bhi[NG][2], blo[NG][2];
#pragma unroll
          for (int n = 0; n < NG; ++n) {
            const int idx = (8 * j + 2 * t) * LD + 8 * (n0 + n) + g;
            operand<C::SPLIT>(vf, lo_buf + C::KV_ELEMS, idx, bhi[n][0],
                              blo[n][0]);
            operand<C::SPLIT>(vf, lo_buf + C::KV_ELEMS, idx + LD, bhi[n][1],
                              blo[n][1]);
          }
#pragma unroll
          for (int i = 0; i < RM; ++i)
            mma_3xtf32(f[i], phi[i][j], plo[i][j], bhi, blo);
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int n = 0; n < NG; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              o[i][n0 + n][e] = o[i][n0 + n][e] * alpha[i][e >> 1] + f[i][n][e];
      }
    }
  }
  cp_wait<0>();

  // ---- epilogue: O / l through this warp's q rows, 16-byte stores ----
  __syncwarp();  // every lane of the warp is done reading its q rows
  T* ow = qs + wr * LD;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float den = l[i][hf];
      den += __shfl_xor_sync(0xffffffffu, den, 1);
      den += __shfl_xor_sync(0xffffffffu, den, 2);
      den = fmaxf(den, 1e-30f);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const float x0 = o[i][n][2 * hf] / den;
        const float x1 = o[i][n][2 * hf + 1] / den;
        T* dst = ow + (16 * i + g + 8 * hf) * LD + 8 * n + 2 * t;
        if constexpr (C::BF16) {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(x0, x1);
        } else {
          *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
        }
      }
    }
  __syncwarp();
  constexpr int EPC = 16 / sizeof(T);
  constexpr int CPR = D / EPC;
#pragma unroll
  for (int i = lane; i < 16 * RM * CPR; i += 32) {
    const int rr = i / CPR;
    const int cc = i % CPR;
    const int r = r0 + rr;
    if (r < S)
      *reinterpret_cast<uint4*>(out + (((long long)b * S + r) * H + h) * D +
                                cc * EPC) =
          *reinterpret_cast<const uint4*>(ow + rr * LD + cc * EPC);
  }
}

template <int D, typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int S, int T_len, int H, int K, const long long* st, float scale,
             int causal, int window, cudaStream_t stream) {
  using C = Cfg<D, T>;
  auto kernel = flash_attention_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + C::BQ - 1) / C::BQ, H, B);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, T_len, H, K, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int T_len, int H, int K, int D, const long long* st,
           float scale, int causal, int window, void* stream) {
  if (B <= 0 || S <= 0 || T_len <= 0 || K <= 0 || H % K != 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // cp.async moves 16-byte chunks: every row must start 16-byte aligned
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) |
                          reinterpret_cast<uintptr_t>(out);
  long long strides = 0;
  for (int i = 0; i < 9; ++i) strides |= st[i] * (long long)sizeof(T);
  if ((align | (uintptr_t)strides) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_d<32, T>(q, k, v, out, B, S, T_len, H, K, st, scale,
                             causal, window, s);
    case 64:
      return launch_d<64, T>(q, k, v, out, B, S, T_len, H, K, st, scale,
                             causal, window, s);
    case 128:
      return launch_d<128, T>(q, k, v, out, B, S, T_len, H, K, st, scale,
                              causal, window, s);
    case 256:
      return launch_d<256, T>(q, k, v, out, B, S, T_len, H, K, st, scale,
                              causal, window, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// out (B, S, H, D) contiguous = attention(q, k, v); q (B, S, H, D) and k, v
// (B, T, K, D) with element strides st = (q: batch, seq, head; k: ...; v:
// ...) and a contiguous last axis; D in {32, 64, 128, 256}, H % K == 0,
// pointers and strides 16-byte aligned. Anything else returns
// cudaErrorInvalidValue (cudaErrorMisalignedAddress for the alignment).
int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* out, int B, int S, int T, int H, int K, int D,
                        const long long* strides, float scale, int causal,
                        int window, void* stream) {
  return launch<float>(q, k, v, out, B, S, T, H, K, D, strides, scale, causal,
                       window, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, int B, int S, int T, int H, int K, int D,
                         const long long* strides, float scale, int causal,
                         int window, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, B, S, T, H, K, D, strides, scale,
                               causal, window, stream);
}

}  // extern "C"
