// Flash attention: online-softmax GQA attention with causal and
// sliding-window masks, hand-written for Hopper (sm_90a), f32 FMA on the
// CUDA cores.
//
// Replaces the TPU Pallas kernel of the JAX package:
//   repro/kernels/flash_attention.py:72 flash_attention
//   (pallas_call :91, kernel body _kernel :27)
//
// q (B, S, H, D), k and v (B, T, K, D) with H % K == 0; query head h reads
// kv head h / (H / K). Positions are the indices: key c is masked for query
// r when causal and c > r, or when window > 0 and r - c >= window. A masked
// score is -1e30, not -inf, as in the Pallas kernel, so a query row with no
// unmasked key at all averages v over every key. The output is
// (B, S, H, D), contiguous, in q's dtype (float or bf16); scores, softmax
// and the accumulator are f32, and in bf16 the probabilities are rounded to
// bf16 before the p·v product, as the Pallas kernel's p.astype(v.dtype).
// q, k and v are read through their strides (the last axis contiguous), so
// the (B, S, H, D) layout needs no transposing copy.
//
// What bounds it on this card: per unmasked (query, key) pair the two
// products do 4·D flops, and a head reads its q, k and v once: at S = T =
// 8192 and D = 128 that is ~2000 flops per byte, far right of the H100's
// ridge (67 TFLOP/s f32 over 3.35 TB/s = 20 flop/byte), so the f32 FMA rate
// bounds it (the tensor cores' bf16 rate, 989 TFLOP/s, for bf16 inputs).
//
// Design (simple and right first; no tensor cores, no TF32, no TMA):
//   * grid (64-row q tile, q head, batch); 256 threads as 16 × 16. Thread
//     (ty, tx) owns query rows ty + 16·i (i < 4) both in the 64 × 64 score
//     tile (key columns tx + 16·j, j < 4) and in the 64 × D accumulator
//     (columns tx + 16·j, j < D/16), so the running max m, sum l and the
//     accumulator of a row live in the registers of the 16 threads of one
//     half-warp, and the row max and sum are 4 xor-shuffles.
//   * the q tile is staged once; per step a 64-row k tile and v tile are
//     staged in shared memory (f32; bf16 widened on the load), the 64 × 64
//     probabilities go through shared memory to the p·v product. Rows are
//     padded by one float so the column reads of the score product are
//     free of bank conflicts. At D = 256 that is 208.5 KB of dynamic shared
//     memory, one block per SM.
//   * tiles that no (query, key) pair of the q tile leaves unmasked are
//     skipped: with every query row holding at least one unmasked key
//     (the self-attention case), such a tile changes nothing, exactly
//     (alpha = 1, p = exp(-1e30 - m) = 0 after a real key; before one,
//     the first real key's alpha = 0 wipes it). A q tile with a row that
//     has no unmasked key walks every k tile, as the Pallas grid does, so
//     that row gets the mean of v. Keys past T are excluded (p = 0).
//   * the C entry point launches on the caller's stream, allocates
//     nothing, and returns cudaGetLastError() so a refused launch is seen.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per thread block
constexpr int BK = 64;        // keys per staged k / v tile
constexpr int THREADS = 256;  // 16 × 16
constexpr int RPT = 4;        // query rows per thread   (16 · 4 = 64)
constexpr int KPT = 4;        // key columns per thread  (16 · 4 = 64)
constexpr float MASKED = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
// p as the p·v product sees it: rounded to v's type.
__device__ __forceinline__ float as_v(float p, float*) { return p; }
__device__ __forceinline__ float as_v(float p, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Keys [lo(r), hi(r)] are the unmasked ones of query r; empty when lo > hi.
__device__ __forceinline__ int key_hi(int r, int T, bool causal) {
  return causal ? min(r, T - 1) : T - 1;
}
__device__ __forceinline__ int key_lo(int r, int window) {
  return window > 0 ? max(0, r - window + 1) : 0;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * BQ * (D + 1) + BK * D + BQ * (BK + 1));
}

// Stage rows [row0, row0 + 64) of one head of x into s (64 × ld floats);
// rows past n_rows read as zero.
template <int D, typename T>
__device__ __forceinline__ void stage(float* s, int ld, const T* x,
                                      long long row_stride, int row0,
                                      int n_rows) {
#pragma unroll 4
  for (int idx = threadIdx.x; idx < 64 * D; idx += THREADS) {
    const int r = idx / D;
    const int c = idx % D;
    const int row = row0 + r;
    s[r * ld + c] = row < n_rows ? to_float(x[row * row_stride + c]) : 0.f;
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int T_len, int H, int K, long long sqb, long long sqs,
                       long long sqh, long long skb, long long skt,
                       long long skh, long long svb, long long svt,
                       long long svh, float scale, int causal, int window) {
  constexpr int CPT = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                    // BQ × (D + 1)
  float* ks = qs + BQ * (D + 1);       // BK × (D + 1)
  float* vs = ks + BK * (D + 1);       // BK × D
  float* ps = vs + BK * D;             // BQ × (BK + 1)

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / K);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const T* qp = q + b * sqb + h * sqh;
  const T* kp = k + b * skb + kvh * skh;
  const T* vp = v + b * svb + kvh * svh;

  // Does every valid query row of this tile have an unmasked key?
  bool all_rows_live = true;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < S && key_lo(r, window) > key_hi(r, T_len, causal))
      all_rows_live = false;
  }
  all_rows_live = __syncthreads_and(all_rows_live);
  const int n_kt = (T_len + BK - 1) / BK;
  int kt_begin = 0, kt_end = n_kt;
  if (all_rows_live) {
    // The rows' key ranges are contiguous and nondecreasing in r, so the
    // tile's unmasked keys are exactly [lo(q0), hi(q_last)].
    const int q_last = min(q0 + BQ, S) - 1;
    kt_begin = key_lo(q0, window) / BK;
    kt_end = key_hi(q_last, T_len, causal) / BK + 1;
  }

  stage<D>(qs, D + 1, qp, sqs, q0, S);

  float m[RPT], l[RPT], acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous step's k, v and p are consumed
    stage<D>(ks, D + 1, kp, skt, k0, T_len);
    stage<D>(vs, D, vp, svt, k0, T_len);
    __syncthreads();

    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[RPT], c[KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < KPT; ++j) c[j] = ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = q0 + ty + 16 * i;
      float row_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int c = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (c >= T_len)
          x = -INFINITY;  // past the keys: excluded, p = 0
        else if ((causal && c > r) || (window > 0 && r - c >= window))
          x = MASKED;
        s[i][j] = x;
        row_max = fmaxf(row_max, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(row_max));
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        row_sum += p;
        ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = as_v(p, (T*)nullptr);
      }
      l[i] = l[i] * alpha + half_warp_sum(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float a[RPT], w[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) w[j] = vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* op = out + (((long long)b * S + r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < CPT; ++j) store(op + tx + 16 * j, acc[i][j] * inv);
  }
}

template <int D, typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int S, int T_len, int H, int K, const long long* st, float scale,
             int causal, int window, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<D, T>;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
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
// ...) and a contiguous last axis; D in {32, 64, 128, 256}, H % K == 0.
// Anything else returns cudaErrorInvalidValue.
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
