// Block-sparse SpMM for the PipeGCN aggregation, forward and transpose,
// hand-written for Hopper (sm_90a): 3×TF32 on the tensor cores
// (mma.sync.m16n8k8.tf32), f32 accuracy.
//
// Replaces the TPU Pallas kernels of the JAX package:
//   forward    z = P·h        repro/kernels/gcn_spmm.py:110 spmm_block_sparse
//                             (kernel body _kernel, :85)
//   transpose  δcomb = Pᵀ·δz  repro/kernels/gcn_spmm.py:182 spmm_block_sparse_t
//                             (kernel body _kernel_t, :151)
//   both, one phase of the split-phase schedule:
//                             repro/kernels/gcn_spmm.py:245 spmm_block_sparse_phased,
//                             :267 spmm_block_sparse_t_phased
//
// P is stored as dense 128×128 tiles. The Pallas grid walks every slot of
// the tile streams, padding and zero filler tiles included, one output
// block after another on one core. Here the work comes from a schedule
// built once per topology (gcn_spmm.tile_schedule):
//   work  (P, W, 2)  (value-array tile, input block) of each NONZERO slot,
//                    grouped by output block in stream order (for the
//                    transpose the tile is t_perm[s]: tileᵀ is read from the
//                    same value array, no second copy of P exists);
//   items (P, I, 5)  (output block r, first entry, end entry, chunk c,
//                    chunks n): block r's run cut into n ≥ 1 work items of
//                    at most C tiles (C = 4), sorted by (r, c).
// The grid is (item × column slice, partition). A phase is a range of
// output blocks [blk_begin, blk_end): items outside it return at once, and
// the items inside are those the unsplit launch runs for the same blocks,
// so boundary + interior are bit-equal to the unsplit launch.
//
// What bounds it on this card: with F feature columns every nonzero tile
// costs 2·128²·F flops, ×3 in 3×TF32, against 64 KB of tile values read
// once: 3·F/2 tensor-core flops per tile byte against a ridge of 495
// TFLOP/s over 3.35 TB/s = 148. So F ≤ 64 is bound by the tile bytes and
// F ≥ 128 comes near the 3×TF32 rate (F = 512: 768 flops/byte).
//
// Design:
//   * one thread block (8 warps) per work item and slice of FB columns, FB
//     = 8, 16, 32, 64 or 128 chosen by the wrapper as the narrowest that
//     holds F (F > 128: F/128 slices, adjacent in launch order so they
//     share the item's tiles in L2). A run longer than C tiles is spread
//     over several blocks; an output block without nonzero tiles gets one
//     empty item, which writes its zeros.
//   * the item's tiles are streamed in 32-deep k-chunks through a ring of
//     3 shared-memory stages with cp.async (zero-fill for input rows past
//     x_rows and columns past F), so two chunks load while one is
//     multiplied (a ring of 4 to 6 stages measured no faster). The forward stages tile[m][k] row-major, the transpose
//     tile[k][m] as it lies in memory; the A fragment reads differ, the
//     rest is shared. Padding of 4 / 8 floats keeps fragment reads free of
//     bank conflicts.
//   * 3×TF32: each operand x is split in registers into hi = tf32(x)
//     (cvt.rna) and lo = x − hi (read as tf32 by the tensor cores), and an
//     f32 accumulator takes lo·hi, hi·lo and hi·hi, three
//     mma.sync.m16n8k8 per fragment pair (lo·lo, ~2⁻²² relative, is
//     dropped). The tensor cores accumulate only one 32-deep stage; the
//     running sum over the item's tiles is kept by round-to-nearest f32
//     adds on the CUDA cores, since the tensor cores' own f32 accumulation,
//     chained over 2048 terms, drifted past 1e-5 of the f32 result on a
//     320-tile run (tests/test_torch_cuda.py). mma.sync, not wgmma: a
//     128-row tile runs as 8 warps of 16-row fragments read straight from
//     the padded ring, with no K-major re-staging (tf32 wgmma takes both
//     operands K-major from shared memory: the forward's features and the
//     transpose's tiles would have to be transposed on the way in, hi and
//     lo apart). mma.sync's TF32 rate and the per-warp splits hold the
//     wide widths to about a quarter of the 3×TF32 bound (chip_smoke.py);
//     wgmma is the next step there.
//   * a run of one item writes its output directly. A run of n > 1 items
//     writes each item's (128, FB) partial to a scratch buffer in the
//     accumulator's register layout (coalesced float4s); the block that
//     arrives last at the run's counter (atomicAdd after a fence) adds the
//     n partials in chunk order, its own from registers, writes the
//     output and sets the counter back to 0. The sum order is fixed, so
//     results are deterministic run to run. Every in-range output element
//     of a block in the range is written, so outputs may be torch.empty.
//   * the C entry point launches on the caller's stream, allocates nothing
//     (scratch and the zeroed counters come from the wrapper), and returns
//     cudaGetLastError() so a refused launch is seen.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;     // adjacency tile edge (matches the tile streams)
constexpr int KC = 32;        // contraction depth of one ring stage
constexpr int NSTAGE = 3;     // ring stages
constexpr int THREADS = 256;  // 8 warps
constexpr int CHUNKS = TILE / KC;
constexpr int LDA_F = KC + 4;       // forward stage: sA[m][k], 128 × 36
constexpr int LDA_T = TILE + 8;     // transpose stage: sT[k][m], 32 × 136
constexpr int A_FLOATS = (TILE * LDA_F > KC * LDA_T) ? TILE * LDA_F : KC * LDA_T;

// Warp layout of the 128 × FB output block: WM × WN warps, each MT 16-row
// by NT 8-column mma fragments.
template <int FB> struct Layout {
  static constexpr int WN = FB >= 64 ? 2 : 1;
  static constexpr int WM = 8 / WN;
  static constexpr int MT = TILE / (16 * WM);
  static constexpr int NT = FB / (8 * WN);
  static constexpr int LDB = FB + 8 > 24 ? FB + 8 : 24;  // sB[k][n]
  static constexpr int STAGE = A_FLOATS + KC * LDB;
  static constexpr int SMEM = NSTAGE * STAGE * 4;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 fills the destination with zeros.
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp4(float* dst, const float* src,
                                    int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
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

// The 3×TF32 split x = hi + lo: hi = tf32(x) rounded to nearest, lo the
// exact f32 rest (|lo| ≤ 2⁻¹¹|x|). The tensor cores read a tf32 operand's
// top 19 bits, so lo enters the products as tf32(lo) truncated, an error
// of at most 2⁻²²|x|, with one instruction fewer per operand than a
// second cvt.rna on lo.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool TRANSPOSE, int FB>
__global__ void __launch_bounds__(THREADS, FB >= 128 ? 1 : 2)
spmm_items_kernel(const int* __restrict__ work,    // (P, n_work, 2)
                  const int* __restrict__ items,   // (P, n_items, 5)
                  const float* __restrict__ vals,  // (P, n_tiles, 128, 128)
                  const float* __restrict__ x,     // (P, x_rows, F)
                  float* __restrict__ out,         // (P, out_rows, F)
                  float* __restrict__ scratch,     // (P, n_items, slices, 128·FB)
                  int* __restrict__ counters,      // (P, n_out_blocks, slices)
                  int n_work, int n_items, int n_out_blocks, int blk_begin,
                  int blk_end, int n_tiles, int x_rows, int out_rows, int F,
                  int slices) {
  using L = Layout<FB>;
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_last;

  const int p = blockIdx.y;
  const int item = blockIdx.x / slices;
  const int slice = blockIdx.x - item * slices;
  const int* it = items + ((long long)p * n_items + item) * 5;
  const int r = it[0];
  if (r < blk_begin || r >= blk_end) return;  // another phase, or a pad
  const int lo = it[1], hi = it[2], chunk = it[3], n_chunks = it[4];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp % L::WM, wn = warp / L::WM;
  const int f0 = slice * FB;
  const int2* wp = reinterpret_cast<const int2*>(work) + (long long)p * n_work;
  const float* xp = x + (long long)p * x_rows * F;
  // 16-byte copies of x where its rows keep that alignment
  const bool vec = (F & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;

  float acc[L::MT][L::NT][4];
#pragma unroll
  for (int i = 0; i < L::MT; ++i)
#pragma unroll
    for (int j = 0; j < L::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // The (tile, input block) pair of the tile being loaded, and the next
  // one's, fetched a tile ahead.
  const int steps = (hi - lo) * CHUNKS;
  int2 cur = lo < hi ? wp[lo] : make_int2(0, 0);
  int2 nxt = lo + 1 < hi ? wp[lo + 1] : make_int2(0, 0);

  auto load_stage = [&](int q) {
    const int j = q / CHUNKS, k0 = (q % CHUNKS) * KC;
    if (q % CHUNKS == 0 && q > 0) {
      cur = nxt;
      nxt = lo + j + 1 < hi ? wp[lo + j + 1] : make_int2(0, 0);
    }
    float* sa = smem + (q % NSTAGE) * L::STAGE;
    float* sb = sa + A_FLOATS;
    const float* tv = vals + ((long long)p * n_tiles + cur.x) * (TILE * TILE);
#pragma unroll
    for (int i = 0; i < (TILE * KC / 4) / THREADS; ++i) {
      const int idx = i * THREADS + tid;
      if (TRANSPOSE) {  // sT[k][m] = tile[k0 + k][m]
        const int k = idx / (TILE / 4), c = idx % (TILE / 4);
        cp16(sa + k * LDA_T + c * 4, tv + (k0 + k) * TILE + c * 4, 16);
      } else {          // sA[m][k] = tile[m][k0 + k]
        const int m = idx / (KC / 4), c = idx % (KC / 4);
        cp16(sa + m * LDA_F + c * 4, tv + m * TILE + k0 + c * 4, 16);
      }
    }
    const long long row0 = (long long)cur.y * TILE + k0;
    if (vec) {
      for (int idx = tid; idx < KC * FB / 4; idx += THREADS) {
        const int k = idx / (FB / 4), c = idx % (FB / 4);
        const long long row = row0 + k;
        const int col = f0 + c * 4;
        const bool ok = row < x_rows && col < F;
        cp16(sb + k * L::LDB + c * 4, ok ? xp + row * F + col : xp,
             ok ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < KC * FB; idx += THREADS) {
        const int k = idx / FB, c = idx % FB;
        const long long row = row0 + k;
        const int col = f0 + c;
        const bool ok = row < x_rows && col < F;
        cp4(sb + k * L::LDB + c, ok ? xp + row * F + col : xp, ok ? 4 : 0);
      }
    }
  };

#pragma unroll
  for (int q = 0; q < NSTAGE - 1; ++q) {
    if (q < steps) load_stage(q);
    cp_commit();
  }
  for (int q = 0; q < steps; ++q) {
    cp_wait<NSTAGE - 2>();  // stage q has landed
    __syncthreads();        // ... for every thread; stage q-1 is consumed
    if (q + NSTAGE - 1 < steps) load_stage(q + NSTAGE - 1);
    cp_commit();
    const float* sa = smem + (q % NSTAGE) * L::STAGE;
    const float* sb = sa + A_FLOATS;
    float stage_acc[L::MT][L::NT][4];  // this stage's 32-deep partial
#pragma unroll
    for (int i = 0; i < L::MT; ++i)
#pragma unroll
      for (int j = 0; j < L::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) stage_acc[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 8) {
      uint32_t ahi[L::MT][4], alo[L::MT][4];
#pragma unroll
      for (int i = 0; i < L::MT; ++i) {
        const int m = (wm * L::MT + i) * 16 + g;
        float a[4];
        if (TRANSPOSE) {
          a[0] = sa[(kk + t4) * LDA_T + m];
          a[1] = sa[(kk + t4) * LDA_T + m + 8];
          a[2] = sa[(kk + t4 + 4) * LDA_T + m];
          a[3] = sa[(kk + t4 + 4) * LDA_T + m + 8];
        } else {
          a[0] = sa[m * LDA_F + kk + t4];
          a[1] = sa[(m + 8) * LDA_F + kk + t4];
          a[2] = sa[m * LDA_F + kk + t4 + 4];
          a[3] = sa[(m + 8) * LDA_F + kk + t4 + 4];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(a[e], ahi[i][e], alo[i][e]);
      }
#pragma unroll
      for (int j = 0; j < L::NT; ++j) {
        const int n = (wn * L::NT + j) * 8 + g;
        uint32_t bhi0, blo0, bhi1, blo1;
        split_tf32(sb[(kk + t4) * L::LDB + n], bhi0, blo0);
        split_tf32(sb[(kk + t4 + 4) * L::LDB + n], bhi1, blo1);
#pragma unroll
        for (int i = 0; i < L::MT; ++i) {
          mma_tf32(stage_acc[i][j], alo[i], bhi0, bhi1);
          mma_tf32(stage_acc[i][j], ahi[i], blo0, blo1);
          mma_tf32(stage_acc[i][j], ahi[i], bhi0, bhi1);
        }
      }
    }
    // the running sum in round-to-nearest f32 adds on the CUDA cores
#pragma unroll
    for (int i = 0; i < L::MT; ++i)
#pragma unroll
      for (int j = 0; j < L::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += stage_acc[i][j][e];
  }
  cp_wait<0>();

  // Thread (g, t4) of a warp holds, per fragment, rows g and g + 8 and
  // columns 2·t4, 2·t4 + 1.
  auto store = [&](int i, int j, const float (&v)[4]) {
    const int m = (wm * L::MT + i) * 16 + g;
    const int col = f0 + (wn * L::NT + j) * 8 + 2 * t4;
    float* op = out + (long long)p * out_rows * F;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r * TILE + m + (e >> 1) * 8;
      const int c = col + (e & 1);
      if (row < out_rows && c < F) op[(long long)row * F + c] = v[e];
    }
  };

  if (n_chunks == 1) {
#pragma unroll
    for (int i = 0; i < L::MT; ++i)
#pragma unroll
      for (int j = 0; j < L::NT; ++j) store(i, j, acc[i][j]);
    return;
  }

  // A run cut in several items: publish this item's partial, and let the
  // last block of the run to arrive add all partials in chunk order.
  float4* part = reinterpret_cast<float4*>(
      scratch + (((long long)p * n_items + item) * slices + slice) *
                    (TILE * FB));
#pragma unroll
  for (int i = 0; i < L::MT; ++i)
#pragma unroll
    for (int j = 0; j < L::NT; ++j)
      part[(i * L::NT + j) * THREADS + tid] =
          make_float4(acc[i][j][0], acc[i][j][1], acc[i][j][2], acc[i][j][3]);
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ctr = counters + ((long long)p * n_out_blocks + r) * slices + slice;
    s_last = atomicAdd(ctr, 1) == n_chunks - 1;
    if (s_last) atomicExch(ctr, 0);  // ready for the next launch
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const long long stride = (long long)slices * (TILE * FB) / 4;  // per item
  const float4* first = part - (long long)chunk * stride;
#pragma unroll
  for (int i = 0; i < L::MT; ++i)
#pragma unroll
    for (int j = 0; j < L::NT; ++j) {
      const int e = (i * L::NT + j) * THREADS + tid;
      float s[4];
      for (int c = 0; c < n_chunks; ++c) {
        float v[4];
        if (c == chunk) {
#pragma unroll
          for (int k = 0; k < 4; ++k) v[k] = acc[i][j][k];
        } else {
          const float4 w = __ldcg(first + c * stride + e);
          v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) s[k] = c == 0 ? v[k] : s[k] + v[k];
      }
      store(i, j, s);
    }
}

template <bool TRANSPOSE, int FB>
int launch_fb(const int* work, const int* items, const float* vals,
              const float* x, float* out, float* scratch, int* counters,
              int P, int n_work, int n_items, int n_out_blocks, int blk_begin,
              int blk_end, int n_tiles, int x_rows, int out_rows, int F,
              cudaStream_t st) {
  using L = Layout<FB>;
  auto kernel = spmm_items_kernel<TRANSPOSE, FB>;
  static bool attr_set = false;  // once per instance and process
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int slices = (F + FB - 1) / FB;
  const dim3 grid(n_items * slices, P);
  kernel<<<grid, THREADS, L::SMEM, st>>>(
      work, items, vals, x, out, scratch, counters, n_work, n_items,
      n_out_blocks, blk_begin, blk_end, n_tiles, x_rows, out_rows, F, slices);
  return static_cast<int>(cudaGetLastError());
}

template <bool TRANSPOSE>
int launch(const void* work, const void* items, const void* vals,
           const void* x, void* out, void* scratch, void* counters, int P,
           int n_work, int n_items, int n_out_blocks, int blk_begin,
           int blk_end, int n_tiles, int x_rows, int out_rows, int F, int FB,
           void* stream) {
  if (blk_begin < 0 || blk_end > n_out_blocks || blk_begin >= blk_end)
    return static_cast<int>(cudaErrorInvalidValue);
  if (P <= 0 || F <= 0 || n_items <= 0) return cudaSuccess;
  const int* w = static_cast<const int*>(work);
  const int* it = static_cast<const int*>(items);
  const float* v = static_cast<const float*>(vals);
  const float* xx = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  float* s = static_cast<float*>(scratch);
  int* c = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SPMM_LAUNCH(fb)                                                      \
  return launch_fb<TRANSPOSE, fb>(w, it, v, xx, o, s, c, P, n_work, n_items, \
                                  n_out_blocks, blk_begin, blk_end, n_tiles, \
                                  x_rows, out_rows, F, st)
  switch (FB) {
    case 8: SPMM_LAUNCH(8);
    case 16: SPMM_LAUNCH(16);
    case 32: SPMM_LAUNCH(32);
    case 64: SPMM_LAUNCH(64);
    case 128: SPMM_LAUNCH(128);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SPMM_LAUNCH
}

}  // namespace

extern "C" {

// z[p] = P_p · h[p] on row blocks [blk_begin, blk_end) (0 and nrb: all).
// work (P, n_work, 2) and items (P, n_items, 5) int32, the forward schedule;
// vals (P, n_tiles, 128, 128), h (P, h_rows, F), z (P, num_rows, F);
// scratch ≥ P·n_items·ceil(F/FB)·128·FB floats; counters ≥
// P·nrb·ceil(F/FB) int32, zero; nrb = ceil(num_rows/128); FB = 8, 16, 32,
// 64 or 128 columns per block (ceil(F/FB) column slices). An empty or
// out-of-range block range, or another FB, returns cudaErrorInvalidValue.
int gcn_spmm_f32(const void* work, const void* items, const void* vals,
                 const void* h, void* z, void* scratch, void* counters, int P,
                 int n_work, int n_items, int nrb, int blk_begin, int blk_end,
                 int n_tiles, int h_rows, int num_rows, int F, int FB,
                 void* stream) {
  return launch<false>(work, items, vals, h, z, scratch, counters, P, n_work,
                       n_items, nrb, blk_begin, blk_end, n_tiles, h_rows,
                       num_rows, F, FB, stream);
}

// dcomb[p] = P_pᵀ · dz[p] on column blocks [blk_begin, blk_end); t_work /
// t_items the transpose schedule (its work entries name t_perm[s] and
// t_in[s]), dz (P, dz_rows, F), dcomb (P, num_cols, F); ncb =
// ceil(num_cols/128); the rest as above.
int gcn_spmm_t_f32(const void* t_work, const void* t_items, const void* vals,
                   const void* dz, void* dcomb, void* scratch, void* counters,
                   int P, int n_work, int n_items, int ncb, int blk_begin,
                   int blk_end, int n_tiles, int dz_rows, int num_cols, int F,
                   int FB, void* stream) {
  return launch<true>(t_work, t_items, vals, dz, dcomb, scratch, counters, P,
                      n_work, n_items, ncb, blk_begin, blk_end, n_tiles,
                      dz_rows, num_cols, F, FB, stream);
}

// Dynamic shared memory of one thread block at column block FB (the ring
// of NSTAGE stages), or -1 for an FB the kernels are not built for.
int gcn_spmm_smem_bytes(int FB) {
  switch (FB) {
    case 8: return Layout<8>::SMEM;
    case 16: return Layout<16>::SMEM;
    case 32: return Layout<32>::SMEM;
    case 64: return Layout<64>::SMEM;
    case 128: return Layout<128>::SMEM;
    default: return -1;
  }
}

}  // extern "C"
