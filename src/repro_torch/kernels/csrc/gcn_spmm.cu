// Block-sparse SpMM for the PipeGCN aggregation, forward and transpose,
// and the fused aggregate+transform pair, hand-written for Hopper
// (sm_90a): 3×TF32 on the tensor cores (mma.sync.m16n8k8.tf32), f32
// accuracy.
//
// Replaces the TPU Pallas kernels of the JAX package:
//   forward    z = P·h        repro/kernels/gcn_spmm.py:110 spmm_block_sparse
//                             (kernel body _kernel, :85)
//   transpose  δcomb = Pᵀ·δz  repro/kernels/gcn_spmm.py:182 spmm_block_sparse_t
//                             (kernel body _kernel_t, :151)
//   both, one phase of the split-phase schedule:
//                             repro/kernels/gcn_spmm.py:245 spmm_block_sparse_phased,
//                             :267 spmm_block_sparse_t_phased
//   fused forward    u = (P·h)·w + b [ReLU], z = P·h optional
//                             repro/kernels/gcn_spmm.py:370 spmm_block_sparse_fused
//                             (kernel body _kernel_fused, :328)
//   fused transpose  δcomb = Pᵀ·(du·wᵀ), computed as (Pᵀ·du)·wᵀ
//                             repro/kernels/gcn_spmm.py:458 spmm_block_sparse_fused_t
//                             (kernel body _kernel_fused_t, :421)
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
// F ≥ 128 comes near the 3×TF32 rate (F = 512: 768 flops/byte). The fused
// pair adds a dense (128, K)·(K, N) product per output block, K and N the
// layer's widths, also on the tensor cores.
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
//   * the fused pair runs the same aggregation (the same code, so the
//     forward's z is bit-equal to gcn_spmm_f32's at the same FB), the
//     transpose on du at F_out: δcomb = Pᵀ·(du·wᵀ) is computed as
//     (Pᵀ·du)·wᵀ, so the dense product is paid once per output block
//     instead of once per tile slot as in the Pallas kernel, and the
//     aggregation runs at F_out. The block that finishes a column slice
//     of output block r (the run's only item, or its last arrival) writes
//     it to z (forward, when asked and z's rows take 16-byte copies) or
//     else to a row-major buffer zbuf (P, nb·128, slices·FB) with zero
//     columns past F, fences and counts at r's run counter. The dense
//     product runs in epilogue passes of ON = 16 or 64 output columns (16
//     where that holds N, else N/64 passes; passes of 128 spilled), one
//     thread block each, spread over the card: a block takes a ticket,
//     the first tickets are the aggregation units and the rest the
//     passes, and a pass waits for its run's counter to reach `slices`,
//     then multiplies the row block's aggregate (K = F, read with
//     cp.async.cg through L2 only) by w (forward: w[k][n], K = F_in;
//     transpose: wᵀ, w read in its stored (F_in, F_out) layout as the
//     col-major B operand, K = F_out) through the same ring, then adds b
//     and ReLU when asked. (One elected block per output block doing the
//     whole product, on an H100, was 1–38% slower than the spmm kernel
//     plus torch.matmul: PERF.md.) The epilogue multiplies in 4×TF32 (lo
//     rounded to nearest, lo·lo too, each 8-deep step summed in f32): in
//     3×TF32 its products stay within 1e-5 of the plain version, but they
//     err about twice as much as an f32 GEMM's and flipped a ReLU of
//     yelp-sim's first layer that the f32 path keeps, moving a gradient
//     leaf of chip_smoke.py's step check 9.4e-4 from the float64
//     reference on an H100 (bar 5e-4; 4×TF32: 2.3e-4, as the f32 FMA
//     kernel before it). The epilogue is a function of its own, not
//     inlined, so its registers do not add to the aggregation's. The
//     fused instances run one block per SM at every FB (under the
//     128-register cap of two blocks per SM, with the aggregation's own FB
//     ≤ 64 instances already at 113–128, they spilled). A block reads the
//     work item of the ticket it expects (its block index) while its
//     ticket is on the way, so the ticket costs no extra round trip when
//     blocks take tickets in dispatch order. An empty run still writes u
//     = b (ReLU'd) and δcomb = 0.
//   * the C entry points launch on the caller's stream, allocate nothing
//     (scratch, zbuf and the zeroed counters come from the wrapper), and
//     return cudaGetLastError() so a refused launch is seen.

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

// A ring stage of a fused epilogue pass of ON columns: zbuf as sA[m][k]
// and w as sB[k][n] (forward) or wᵀ as sB[n][k] (transpose).
template <bool TRANSPOSE, int ON> struct Epilogue {
  static constexpr int STAGE =
      A_FLOATS + (TRANSPOSE ? ON * LDA_F : KC * Layout<ON>::LDB);
};

template <bool TRANSPOSE, int FB, int ON> struct Fused {
  static constexpr int STAGE = Layout<FB>::STAGE > Epilogue<TRANSPOSE, ON>::STAGE
                                   ? Layout<FB>::STAGE
                                   : Epilogue<TRANSPOSE, ON>::STAGE;
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

// x rounded to TF32, to nearest with ties away from zero: the value of
// cvt.rna.tf32.f32 (adding half a TF32 unit to the magnitude's bits and
// dropping the low 13), in two integer instructions where sm_90 spends
// four on the cvt.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// The 3×TF32 split x = hi + lo: hi = tf32(x) rounded to nearest, lo the
// exact f32 rest (|lo| ≤ 2⁻¹¹|x|). The tensor cores read a tf32 operand's
// top 19 bits, so lo enters the products as tf32(lo) truncated, an error
// of at most 2⁻²²|x|; RNA_LO rounds lo to nearest as well.
template <bool RNA_LO = false>
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = rna_tf32(x);
  const float rest = x - __uint_as_float(hi);
  lo = RNA_LO ? rna_tf32(rest) : __float_as_uint(rest);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int N> using Acc = float[Layout<N>::MT][Layout<N>::NT][4];

template <int N>
__device__ __forceinline__ void zero(Acc<N>& acc) {
#pragma unroll
  for (int i = 0; i < Layout<N>::MT; ++i)
#pragma unroll
    for (int j = 0; j < Layout<N>::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// acc (a 128 × N block) += the product of `steps` 32-deep stages. Stage q
// is loaded by load(q, stage) with cp.async into stage (q % NSTAGE) of the
// ring at `smem` (stride stage_floats): A at the stage's start, as sA[k][m]
// (A_KM, LDA_T) or sA[m][k] (LDA_F); B at A_FLOATS, as sB[n][k] (B_NK,
// LDA_F) or sB[k][n] (Layout<N>::LDB). Each stage is multiplied in 3×TF32
// on a fresh accumulator, which is then added to acc in f32. FOUR (the
// fused epilogue) multiplies in 4×TF32 instead: lo rounded to nearest,
// lo·lo taken too, and each 8-deep step on a fresh accumulator of its own
// added in f32, so the tensor cores round one sum of eight where they
// rounded a chain of twelve. The ring is free again when this returns
// only after a __syncthreads().
template <int N, bool A_KM, bool B_NK, bool FOUR = false, class Load>
__device__ __forceinline__ void ring_mma(Acc<N>& acc, float* smem,
                                         int stage_floats, int steps,
                                         Load load) {
  using L = Layout<N>;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp % L::WM, wn = warp / L::WM;
#pragma unroll
  for (int q = 0; q < NSTAGE - 1; ++q) {
    if (q < steps) load(q, smem + q * stage_floats);
    cp_commit();
  }
  for (int q = 0; q < steps; ++q) {
    cp_wait<NSTAGE - 2>();  // stage q has landed
    __syncthreads();        // ... for every thread; stage q-1 is consumed
    if (q + NSTAGE - 1 < steps)
      load(q + NSTAGE - 1, smem + ((q + NSTAGE - 1) % NSTAGE) * stage_floats);
    cp_commit();
    const float* sa = smem + (q % NSTAGE) * stage_floats;
    const float* sb = sa + A_FLOATS;
    Acc<N> stage_acc;  // this stage's 32-deep partial
    zero<N>(stage_acc);
#pragma unroll
    for (int kk = 0; kk < KC; kk += 8) {
      uint32_t ahi[L::MT][4], alo[L::MT][4];
#pragma unroll
      for (int i = 0; i < L::MT; ++i) {
        const int m = (wm * L::MT + i) * 16 + g;
        float a[4];
        if (A_KM) {
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
        for (int e = 0; e < 4; ++e)
          split_tf32<FOUR>(a[e], ahi[i][e], alo[i][e]);
      }
#pragma unroll
      for (int j = 0; j < L::NT; ++j) {
        const int n = (wn * L::NT + j) * 8 + g;
        uint32_t bhi0, blo0, bhi1, blo1;
        if (B_NK) {
          split_tf32<FOUR>(sb[n * LDA_F + kk + t4], bhi0, blo0);
          split_tf32<FOUR>(sb[n * LDA_F + kk + t4 + 4], bhi1, blo1);
        } else {
          split_tf32<FOUR>(sb[(kk + t4) * L::LDB + n], bhi0, blo0);
          split_tf32<FOUR>(sb[(kk + t4 + 4) * L::LDB + n], bhi1, blo1);
        }
#pragma unroll
        for (int i = 0; i < L::MT; ++i) {
          float (&d)[4] = stage_acc[i][j];
          if (FOUR) {
            d[0] = d[1] = d[2] = d[3] = 0.f;
            mma_tf32(d, alo[i], blo0, blo1);
          }
          mma_tf32(d, alo[i], bhi0, bhi1);
          mma_tf32(d, ahi[i], blo0, blo1);
          mma_tf32(d, ahi[i], bhi0, bhi1);
          if (FOUR) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] += d[e];
          }
        }
      }
    }
    // the running sum in round-to-nearest f32 adds on the CUDA cores
    if (!FOUR) {
#pragma unroll
      for (int i = 0; i < L::MT; ++i)
#pragma unroll
        for (int j = 0; j < L::NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += stage_acc[i][j][e];
    }
  }
  cp_wait<0>();
}

// Thread (g, t4) of a warp holds, per fragment, rows g and g + 8 and
// columns 2·t4, 2·t4 + 1: element e of fragment (i, j) is row
// (wm·MT + i)·16 + g + 8·(e >> 1), column (wn·NT + j)·8 + 2·t4 + (e & 1)
// of the block. f(i, j, e, row, column) visits them.
template <int N, class F>
__device__ __forceinline__ void for_each(F f) {
  using L = Layout<N>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp % L::WM, wn = warp / L::WM;
#pragma unroll
  for (int i = 0; i < L::MT; ++i)
#pragma unroll
    for (int j = 0; j < L::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f(i, j, e, (wm * L::MT + i) * 16 + g + (e >> 1) * 8,
          (wn * L::NT + j) * 8 + 2 * t4 + (e & 1));
}

// out[row0 + m][c0 + n] = acc for rows < rows and columns < cols (row
// length ld).
template <int FB>
__device__ __forceinline__ void store_block(const Acc<FB>& acc, float* out,
                                            int row0, int rows, int c0,
                                            int cols, int ld) {
  for_each<FB>([&](int i, int j, int e, int m, int n) {
    const int row = row0 + m, c = c0 + n;
    if (row < rows && c < cols) out[(long long)row * ld + c] = acc[i][j][e];
  });
}

// The (128, FB) sum of one output block's tiles in one column slice
// (columns f0 ..): this block's work item [lo, hi) of the work list wp,
// chunk `chunk` of n_chunks. Returns true in the block that finishes the
// sum, with the sum in acc: the run's only item, or the last of its items
// to arrive at the run's counter `ctr`, which adds every item's partial
// (this one's `part`, the others `part_stride` float4s apart, in chunk
// order) and resets the counter; false in the others.
template <bool TRANSPOSE, int FB>
__device__ __forceinline__ bool aggregate(
    Acc<FB>& acc, float* smem, const int2* wp, const float* tiles,
    const float* xp, bool vec, int lo, int hi, int chunk, int n_chunks,
    int x_rows, int F, int f0, float4* part, long long part_stride,
    int* ctr) {
  using L = Layout<FB>;
  __shared__ int s_last;
  const int tid = threadIdx.x;
  zero<FB>(acc);

  // The (tile, input block) pair of the tile being loaded, and the next
  // one's, fetched a tile ahead.
  const int steps = (hi - lo) * CHUNKS;
  int2 cur = lo < hi ? wp[lo] : make_int2(0, 0);
  int2 nxt = lo + 1 < hi ? wp[lo + 1] : make_int2(0, 0);

  auto load_stage = [&](int q, float* sa) {
    const int j = q / CHUNKS, k0 = (q % CHUNKS) * KC;
    if (q % CHUNKS == 0 && q > 0) {
      cur = nxt;
      nxt = lo + j + 1 < hi ? wp[lo + j + 1] : make_int2(0, 0);
    }
    float* sb = sa + A_FLOATS;
    const float* tv = tiles + (long long)cur.x * (TILE * TILE);
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
  ring_mma<FB, TRANSPOSE, false>(acc, smem, L::STAGE, steps, load_stage);
  if (n_chunks == 1) return true;

  // A run cut in several items: publish this item's partial, and let the
  // last block of the run to arrive add all partials in chunk order.
#pragma unroll
  for (int i = 0; i < L::MT; ++i)
#pragma unroll
    for (int j = 0; j < L::NT; ++j)
      part[(i * L::NT + j) * THREADS + tid] =
          make_float4(acc[i][j][0], acc[i][j][1], acc[i][j][2], acc[i][j][3]);
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    s_last = atomicAdd(ctr, 1) == n_chunks - 1;
    if (s_last) atomicExch(ctr, 0);  // ready for the next launch
  }
  __syncthreads();
  if (!s_last) return false;
  __threadfence();
  const float4* first = part - (long long)chunk * part_stride;
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
          const float4 w = __ldcg(first + c * part_stride + e);
          v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) s[k] = c == 0 ? v[k] : s[k] + v[k];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = s[k];
    }
  return true;
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
  extern __shared__ __align__(16) float smem[];
  const int p = blockIdx.y;
  const int item = blockIdx.x / slices;
  const int slice = blockIdx.x - item * slices;
  const int* it = items + ((long long)p * n_items + item) * 5;
  const int r = it[0];
  if (r < blk_begin || r >= blk_end) return;  // another phase, or a pad
  const int f0 = slice * FB;
  // 16-byte copies of x where its rows keep that alignment
  const bool vec = (F & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  Acc<FB> acc;
  if (!aggregate<TRANSPOSE, FB>(
          acc, smem, reinterpret_cast<const int2*>(work) + (long long)p * n_work,
          vals + (long long)p * n_tiles * (TILE * TILE),
          x + (long long)p * x_rows * F, vec, it[1], it[2], it[3], it[4],
          x_rows, F, f0,
          reinterpret_cast<float4*>(
              scratch + (((long long)p * n_items + item) * slices + slice) *
                            (TILE * FB)),
          (long long)slices * (TILE * FB) / 4,
          counters + ((long long)p * n_out_blocks + r) * slices + slice))
    return;
  store_block<FB>(acc, out + (long long)p * out_rows * F, r * TILE, out_rows,
                  f0, F, F);
}

// One pass of the fused epilogue of one output block: out[row0 + m][g0 +
// n] = (zb · B)[m][g0 + n] (+ bias, ReLU'd when relu) for rows < out_rows
// and the ON columns from g0 (those < n_out). zb holds the block's
// aggregate: `rows` rows of row length ks (a multiple of 4, zero past K;
// rows past `rows` read as 0); B is w (K, n_out) forward, wᵀ with w (n_out,
// K) for the transpose, row length ldw. Not
// inlined: its registers are allocated apart from the aggregation's, and
// nothing of it is hoisted above the aggregation (inlined, the forward FB
// = 128 instances spilled at ON ≥ 32).
template <bool TRANSPOSE, int ON>
__device__ __noinline__ void epilogue(const float* zb, int ks, int rows,
                                      int K, const float* w, int ldw,
                                      const float* bias, int relu, float* out,
                                      int row0, int out_rows, int g0,
                                      int n_out) {
  using L = Layout<ON>;
  extern __shared__ __align__(16) float smem[];
  constexpr int STAGE = Epilogue<TRANSPOSE, ON>::STAGE;
  const int tid = threadIdx.x;
  const bool wvec = (ldw & 3) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  auto load_stage = [&](int q, float* sa) {
    const int k0 = q * KC;
    float* sb = sa + A_FLOATS;
#pragma unroll
    for (int i = 0; i < (TILE * KC / 4) / THREADS; ++i) {  // sA[m][k]
      const int idx = i * THREADS + tid;
      const int m = idx / (KC / 4), c = idx % (KC / 4);
      const int k = k0 + c * 4;
      const bool ok = k < ks && m < rows;
      cp16(sa + m * LDA_F + c * 4, ok ? zb + (long long)m * ks + k : zb,
           ok ? 16 : 0);
    }
    if (TRANSPOSE) {  // sB[n][k] = w[g0 + n][k0 + k]
      if (wvec) {
        for (int idx = tid; idx < ON * KC / 4; idx += THREADS) {
          const int n = idx / (KC / 4), c = idx % (KC / 4);
          const int row = g0 + n, col = k0 + c * 4;
          const bool ok = row < n_out && col < K;
          cp16(sb + n * LDA_F + c * 4, ok ? w + (long long)row * ldw + col : w,
               ok ? 16 : 0);
        }
      } else {
        for (int idx = tid; idx < ON * KC; idx += THREADS) {
          const int n = idx / KC, c = idx % KC;
          const int row = g0 + n, col = k0 + c;
          const bool ok = row < n_out && col < K;
          cp4(sb + n * LDA_F + c, ok ? w + (long long)row * ldw + col : w,
              ok ? 4 : 0);
        }
      }
    } else {          // sB[k][n] = w[k0 + k][g0 + n]
      if (wvec) {
        for (int idx = tid; idx < KC * ON / 4; idx += THREADS) {
          const int k = idx / (ON / 4), c = idx % (ON / 4);
          const int row = k0 + k, col = g0 + c * 4;
          const bool ok = row < K && col < n_out;
          cp16(sb + k * L::LDB + c * 4, ok ? w + (long long)row * ldw + col : w,
               ok ? 16 : 0);
        }
      } else {
        for (int idx = tid; idx < KC * ON; idx += THREADS) {
          const int k = idx / ON, c = idx % ON;
          const int row = k0 + k, col = g0 + c;
          const bool ok = row < K && col < n_out;
          cp4(sb + k * L::LDB + c, ok ? w + (long long)row * ldw + col : w,
              ok ? 4 : 0);
        }
      }
    }
  };
  Acc<ON> acc;
  zero<ON>(acc);
  ring_mma<ON, false, TRANSPOSE, true>(acc, smem, STAGE, (ks + KC - 1) / KC,
                                       load_stage);
  for_each<ON>([&](int i, int j, int e, int m, int n) {
    const int row = row0 + m, c = g0 + n;
    if (row < out_rows && c < n_out) {
      float v = acc[i][j][e];
      if (bias) v += bias[c];
      if (relu) v = fmaxf(v, 0.f);
      out[(long long)row * n_out + c] = v;
    }
  });
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The fused pair. Each thread block takes a ticket and runs the unit it
// names: the first n_agg tickets an aggregation unit of spmm_items_kernel
// at width F (F_in forward, F_out transpose), one (partition, item, column
// slice) in the spmm kernels' launch order, the others an epilogue pass,
// one (partition, output block r, pass o). The block that finishes a
// column slice of output block r parks it in z (forward, where z's rows
// take 16-byte copies) or else in zbuf, and counts at r's run counter; a
// pass waits until r's run counter holds all `slices` slices, then
// computes ON output columns, and the last pass of r to finish resets r's
// counters. (Handing a partition's passes out after the next partition's
// aggregation, to run them beside it, measured slower on an H100.)
// A block waits only on units of earlier tickets, all taken by blocks
// already running, which never wait on later ones: no deadlock, whatever
// the grid's size or order of dispatch.
// Counters: (P, nb, slices) item arrivals, then (P, nb) run counters,
// (P, nb) finished passes, and the ticket.
template <bool TRANSPOSE, int FB, int ON>
__global__ void __launch_bounds__(THREADS, 1)
fused_items_kernel(const int* __restrict__ work,    // (P, n_work, 2)
                   const int* __restrict__ items,   // (P, n_items, 5)
                   const float* __restrict__ vals,  // (P, n_tiles, 128, 128)
                   const float* __restrict__ x,     // (P, x_rows, F)
                   const float* __restrict__ w,     // fwd (F, n_out); transpose (n_out, F)
                   const float* __restrict__ bias,  // (n_out,) or null
                   float* __restrict__ out,         // (P, out_rows, n_out)
                   float* __restrict__ z,           // (P, out_rows, F) or null
                   float* __restrict__ zbuf,        // (P, nb·128, slices·FB)
                   float* __restrict__ scratch,     // (P, n_items, slices, 128·FB)
                   int* __restrict__ counters,      // see above
                   int P, int n_work, int n_items, int nb, int n_tiles,
                   int x_rows, int out_rows, int F, int slices, int n_out,
                   int relu) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_ticket, s_item[5];
  const int passes = (n_out + ON - 1) / ON;
  const int n_agg = P * n_items * slices;
  const int n_units = n_agg + P * nb * passes;
  int* run_ctr = counters + (long long)P * nb * slices;
  int* pass_ctr = run_ctr + (long long)P * nb;
  int* ticket = pass_ctr + (long long)P * nb;
  // The item of an aggregation unit u < n_agg, (p, item, slice) in the spmm
  // kernels' order.
  auto item_of = [&](int u) {
    return items + ((long long)(u / (n_items * slices)) * n_items +
                    (u % (n_items * slices)) / slices) * 5;
  };
  if (threadIdx.x == 0) {
    // Blocks mostly take tickets in the order they are dispatched: read the
    // item of ticket blockIdx.x while the ticket is on its way.
    const int guess = blockIdx.x;
    int f[5] = {0, 0, 0, 0, 0};
    if (guess < n_agg)
      for (int i = 0; i < 5; ++i) f[i] = item_of(guess)[i];
    const int u = atomicAdd(ticket, 1);
    if (u == n_units - 1) atomicExch(ticket, 0);  // ready for the next launch
    if (u != guess && u < n_agg)
      for (int i = 0; i < 5; ++i) f[i] = item_of(u)[i];
    s_ticket = u;
    for (int i = 0; i < 5; ++i) s_item[i] = f[i];
  }
  __syncthreads();
  int p, t = s_ticket;
  const bool pass = t >= n_agg;
  if (pass) {  // pass (r, o) of partition p
    t -= n_agg;
    p = t / (nb * passes);
    t -= p * nb * passes;
  } else {     // aggregation unit (item, slice) of partition p
    p = t / (n_items * slices);
    t -= p * n_items * slices;
  }
  const int ks = slices * FB;
  // the epilogue reads the aggregate from z where it can, else from zbuf
  const bool from_z =
      z && (F & 3) == 0 && (reinterpret_cast<uintptr_t>(z) & 15) == 0;

  if (pass) {  // epilogue pass t of partition p: (r, o)
    const int r = t / passes, o = t % passes;
    const long long pr = (long long)p * nb + r;
    if (threadIdx.x == 0)
      while (load_acquire(run_ctr + pr) < slices) __nanosleep(256);
    __syncthreads();
    __threadfence();
    epilogue<TRANSPOSE, ON>(
        from_z ? z + ((long long)p * out_rows + r * TILE) * F
               : zbuf + pr * TILE * ks,
        from_z ? F : ks, from_z ? min(TILE, out_rows - r * TILE) : TILE, F, w,
        TRANSPOSE ? F : n_out, bias, relu,
        out + (long long)p * out_rows * n_out, r * TILE, out_rows, o * ON,
        n_out);
    if (threadIdx.x == 0 && atomicAdd(pass_ctr + pr, 1) == passes - 1) {
      pass_ctr[pr] = 0;  // every pass has seen the run complete
      run_ctr[pr] = 0;
    }
    return;
  }

  // aggregation unit t of partition p: (item, slice)
  const int item = t / slices, slice = t % slices;
  const int* it = s_item;
  const int r = it[0];
  if (r < 0) return;  // a pad
  const int f0 = slice * FB;
  const bool vec = (F & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  Acc<FB> acc;
  if (!aggregate<TRANSPOSE, FB>(
          acc, smem, reinterpret_cast<const int2*>(work) + (long long)p * n_work,
          vals + (long long)p * n_tiles * (TILE * TILE),
          x + (long long)p * x_rows * F, vec, it[1], it[2], it[3], it[4],
          x_rows, F, f0,
          reinterpret_cast<float4*>(
              scratch + (((long long)p * n_items + item) * slices + slice) *
                            (TILE * FB)),
          (long long)slices * (TILE * FB) / 4,
          counters + ((long long)p * nb + r) * slices + slice))
    return;
  // This block finished slice `slice` of output block r: park it for the
  // epilogue passes.
  if (z)
    store_block<FB>(acc, z + (long long)p * out_rows * F, r * TILE, out_rows,
                    f0, F, F);
  if (!from_z)
    store_block<FB>(acc, zbuf + ((long long)p * nb + r) * TILE * ks, 0, TILE,
                    f0, ks, ks);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(run_ctr + (long long)p * nb + r, 1);
}

template <class Kernel>
int set_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = e == cudaSuccess;
  return static_cast<int>(e);
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
  if (const int e = set_smem(kernel, L::SMEM, attr_set)) return e;
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

// The arguments of a fused launch, as the C entry points take them.
struct FusedArgs {
  const int* work;
  const int* items;
  const float* vals;
  const float* x;
  const float* w;
  const float* bias;
  float* out;
  float* z;
  float* zbuf;
  float* scratch;
  int* counters;
  int P, n_work, n_items, nb, n_tiles, x_rows, out_rows, F, n_out, relu;
  cudaStream_t stream;
};

template <bool TRANSPOSE, int FB, int ON>
int launch_fused_fb(const FusedArgs& a) {
  auto kernel = fused_items_kernel<TRANSPOSE, FB, ON>;
  constexpr int smem = Fused<TRANSPOSE, FB, ON>::SMEM;
  static bool attr_set = false;  // once per instance and process
  if (const int e = set_smem(kernel, smem, attr_set)) return e;
  const int slices = (a.F + FB - 1) / FB;
  const int passes = (a.n_out + ON - 1) / ON;
  const long long units =
      (long long)a.P * (a.n_items * slices + a.nb * passes);
  if (units > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(units);
  kernel<<<grid, THREADS, smem, a.stream>>>(
      a.work, a.items, a.vals, a.x, a.w, a.bias, a.out, a.z, a.zbuf,
      a.scratch, a.counters, a.P, a.n_work, a.n_items, a.nb, a.n_tiles,
      a.x_rows, a.out_rows, a.F, slices, a.n_out, a.relu);
  return static_cast<int>(cudaGetLastError());
}

// The (FB, ON) pairs built: every FB with ON = 16 or 64.
template <bool TRANSPOSE>
int launch_fused(const FusedArgs& a, int FB, int ON) {
  if (a.P <= 0 || a.F <= 0 || a.n_out <= 0 || a.n_items <= 0)
    return cudaSuccess;
#define FUSED_LAUNCH(fb, on) \
  if (FB == fb && ON == on) return launch_fused_fb<TRANSPOSE, fb, on>(a)
  FUSED_LAUNCH(8, 16);
  FUSED_LAUNCH(8, 64);
  FUSED_LAUNCH(16, 16);
  FUSED_LAUNCH(16, 64);
  FUSED_LAUNCH(32, 16);
  FUSED_LAUNCH(32, 64);
  FUSED_LAUNCH(64, 16);
  FUSED_LAUNCH(64, 64);
  FUSED_LAUNCH(128, 16);
  FUSED_LAUNCH(128, 64);
#undef FUSED_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
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

// u[p] = (P_p · h[p]) · w + b (ReLU'd when relu != 0), and z[p] = P_p · h[p]
// when z is not null, bit-equal to gcn_spmm_f32's z at the same FB. The
// forward schedule, vals, h and FB as for gcn_spmm_f32 (F = Fin); w (Fin,
// Fout), b (Fout,), u (P, num_rows, Fout), z (P, num_rows, Fin); zbuf ≥
// P·nrb·128·ceil(Fin/FB)·FB floats; scratch as for gcn_spmm_f32; counters
// ≥ P·nrb·(ceil(Fin/FB) + 2) + 1 int32, zero; ON = 16 or 64 output columns
// per epilogue pass. Another (FB, ON) returns cudaErrorInvalidValue.
int gcn_spmm_fused_f32(const void* work, const void* items, const void* vals,
                       const void* h, const void* w, const void* b, void* u,
                       void* z, void* zbuf, void* scratch, void* counters,
                       int P, int n_work, int n_items, int nrb, int n_tiles,
                       int h_rows, int num_rows, int Fin, int Fout, int FB,
                       int ON, int relu, void* stream) {
  const FusedArgs a{static_cast<const int*>(work),
                    static_cast<const int*>(items),
                    static_cast<const float*>(vals),
                    static_cast<const float*>(h),
                    static_cast<const float*>(w),
                    static_cast<const float*>(b),
                    static_cast<float*>(u),
                    static_cast<float*>(z),
                    static_cast<float*>(zbuf),
                    static_cast<float*>(scratch),
                    static_cast<int*>(counters),
                    P, n_work, n_items, nrb, n_tiles, h_rows, num_rows, Fin,
                    Fout, relu, static_cast<cudaStream_t>(stream)};
  return launch_fused<false>(a, FB, ON);
}

// dcomb[p] = (P_pᵀ · du[p]) · wᵀ = P_pᵀ · (du[p] · wᵀ). The transpose
// schedule and vals as for gcn_spmm_t_f32, du (P, du_rows, Fout) (F =
// Fout), w (Fin, Fout), dcomb (P, num_cols, Fin); zbuf ≥
// P·ncb·128·ceil(Fout/FB)·FB floats; the rest as for gcn_spmm_fused_f32
// with ncb = ceil(num_cols/128) output blocks.
int gcn_spmm_fused_t_f32(const void* t_work, const void* t_items,
                         const void* vals, const void* du, const void* w,
                         void* dcomb, void* zbuf, void* scratch,
                         void* counters, int P, int n_work, int n_items,
                         int ncb, int n_tiles, int du_rows, int num_cols,
                         int Fin, int Fout, int FB, int ON, void* stream) {
  const FusedArgs a{static_cast<const int*>(t_work),
                    static_cast<const int*>(t_items),
                    static_cast<const float*>(vals),
                    static_cast<const float*>(du),
                    static_cast<const float*>(w),
                    nullptr,
                    static_cast<float*>(dcomb),
                    nullptr,
                    static_cast<float*>(zbuf),
                    static_cast<float*>(scratch),
                    static_cast<int*>(counters),
                    P, n_work, n_items, ncb, n_tiles, du_rows, num_cols, Fout,
                    Fin, 0, static_cast<cudaStream_t>(stream)};
  return launch_fused<true>(a, FB, ON);
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
