// Block-sparse SpMM for the PipeGCN aggregation, forward and transpose,
// hand-written for Hopper (sm_90a), f32 FMA on the CUDA cores.
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
// A phase is a range of output blocks [blk_begin, blk_end): the grid covers
// only those blocks and the other output rows are not written. The Pallas
// entry points run a phase as a slice of the tile stream (its last n_bnd
// slots, or the rest); the phase-aware padding places every pad of a group
// at that group's last output block, so the slots of a block range are
// exactly that slice, and each block walks the same run in the same order
// as in the unphased launch: the two phases together are bit-equal to it.
//
// P is stored as dense 128×128 tiles (only the nonempty ones). The forward
// stream is grouped by output row block, the transpose stream by output
// column block (slot s reads tile t_perm[s] of the SAME value array,
// contracted transposed, so no second copy of P exists). One launch covers
// all partitions: the partition index is grid.z, as the vmap was.
//
// What bounds it on this card: with F feature columns every tile does
// 2·128²·F flops against 64 KB of tile values, i.e. F/2 flops per tile
// byte. The H100's ridge is 67 TFLOP/s f32 over 3.35 TB/s = 20 flop/byte,
// so F = 128 and 256 (the hidden layers) are bound by the f32 FMA rate and
// F = 16 (the transform-first last layer) by the tile bytes. This kernel
// re-reads each tile once per 64-column feature block (F/64 times, mostly
// from the 50 MB L2) and wastes 3/4 of its lanes at F = 16.
//
// Design (simple and right first; no tensor cores, no TF32, no atomics):
//   * grid (output block r, feature block of FB = 64 columns, partition p);
//     256 threads own the 128 × 64 output block, 8 rows × 4 columns each,
//     accumulated in registers.
//   * the block walks its run [ptr[p, r], ptr[p, r+1]) in stream order,
//     stopping at the partition's live length: the slots past the last
//     nonzero tile of a stream hold only the all-zero tiles that pad every
//     partition to one stream length (the Pallas grid must walk them, its
//     shape is static; skipping them changes no finite result). In
//     k-chunks of KC = 32, the 128 × 32 slice of the tile (transposed on
//     the load for the forward product) and the 32 × 64 slice of the input
//     rows are staged in shared memory, then every thread does 32 FMA
//     steps. Accumulation order follows the stream, so results are
//     deterministic run to run.
//   * ragged edges are masked: input rows past x_rows and feature columns
//     past F read as zero, output rows past out_rows and columns past F
//     are not written. Every in-range output element of the block is
//     written, zeros for an empty run, so the caller may allocate the
//     output with torch.empty.
//   * the C entry point launches on the caller's stream, allocates
//     nothing, and returns cudaGetLastError() so a refused launch is seen.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;     // adjacency tile edge (matches the tile streams)
constexpr int FB = 64;        // feature columns per thread block
constexpr int KC = 32;        // contraction chunk staged in shared memory
constexpr int THREADS = 256;  // 16 × 16 threads
constexpr int RPT = 8;        // output rows per thread   (16 · 8 = 128)
constexpr int CPT = 4;        // output columns per thread (16 · 4 = 64)

template <bool TRANSPOSE>
__global__ void __launch_bounds__(THREADS)
spmm_tiles_kernel(const int* __restrict__ ptr,    // (P, n_out_blocks + 1)
                  const int* __restrict__ live,   // (P,) live stream length
                  const int* __restrict__ blk,    // (P, n_tiles) input block
                  const int* __restrict__ perm,   // (P, n_tiles) or null
                  const float* __restrict__ vals, // (P, n_tiles, 128, 128)
                  const float* __restrict__ x,    // (P, x_rows, F)
                  float* __restrict__ out,        // (P, out_rows, F)
                  int n_out_blocks, int blk_begin, int n_tiles, int x_rows,
                  int out_rows, int F) {
  // as_[k][m] = A[m][k0 + k] with A = tile (forward) or tileᵀ (transpose);
  // the +1 pad keeps both the transposing store and the reads conflict-free.
  __shared__ float as_[KC][TILE + 1];
  __shared__ float xs_[KC][FB];

  const int r = blk_begin + blockIdx.x;
  const int f0 = blockIdx.y * FB;
  const int p = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const int* pp = ptr + (long long)p * (n_out_blocks + 1);
  const int s_end = min(pp[r + 1], live[p]);
  const int s_begin = min(pp[r], s_end);
  const int* bp = blk + (long long)p * n_tiles;
  const int* mp = perm ? perm + (long long)p * n_tiles : nullptr;
  const float* xp = x + (long long)p * x_rows * F;

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int s = s_begin; s < s_end; ++s) {
    const int t = mp ? mp[s] : s;
    const long long in_row0 = (long long)bp[s] * TILE;
    const float* tv = vals + ((long long)p * n_tiles + t) * (TILE * TILE);
    for (int k0 = 0; k0 < TILE; k0 += KC) {
      __syncthreads();  // previous chunk fully consumed
      // Stage the 128 × 32 tile slice: 4096 values, 16 per thread.
#pragma unroll
      for (int it = 0; it < (TILE * KC) / THREADS; ++it) {
        const int idx = it * THREADS + tid;
        if (TRANSPOSE) {
          // A[m][k] = tile[k][m]: read row k0+kk of the tile, contiguous m.
          const int kk = idx / TILE;
          const int m = idx % TILE;
          as_[kk][m] = tv[(k0 + kk) * TILE + m];
        } else {
          // A[m][k] = tile[m][k]: 32 contiguous k of row m per warp.
          const int m = idx / KC;
          const int kk = idx % KC;
          as_[kk][m] = tv[m * TILE + k0 + kk];
        }
      }
      // Stage the 32 × 64 input slice: 2048 values, 8 per thread.
#pragma unroll
      for (int it = 0; it < (KC * FB) / THREADS; ++it) {
        const int idx = it * THREADS + tid;
        const int kk = idx / FB;
        const int n = idx % FB;
        const long long row = in_row0 + k0 + kk;
        const int col = f0 + n;
        xs_[kk][n] = (row < x_rows && col < F) ? xp[row * F + col] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        float a[RPT], b[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) a[i] = as_[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < CPT; ++j) b[j] = xs_[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }

  float* op = out + (long long)p * out_rows * F;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = r * TILE + ty + 16 * i;
    if (row >= out_rows) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = f0 + tx + 16 * j;
      if (col < F) op[(long long)row * F + col] = acc[i][j];
    }
  }
}

int launch(bool transpose, const void* ptr, const void* live, const void* blk,
           const void* perm, const void* vals, const void* x, void* out, int P,
           int n_out_blocks, int blk_begin, int blk_end, int n_tiles,
           int x_rows, int out_rows, int F, void* stream) {
  if (blk_begin < 0 || blk_end > n_out_blocks || blk_begin >= blk_end)
    return static_cast<int>(cudaErrorInvalidValue);
  if (P <= 0 || F <= 0) return cudaSuccess;
  const dim3 grid(blk_end - blk_begin, (F + FB - 1) / FB, P);
  const dim3 block(THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(ptr);
  const int* il = static_cast<const int*>(live);
  const int* ib = static_cast<const int*>(blk);
  const int* im = static_cast<const int*>(perm);
  const float* v = static_cast<const float*>(vals);
  const float* xx = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  if (transpose)
    spmm_tiles_kernel<true><<<grid, block, 0, st>>>(
        ip, il, ib, im, v, xx, o, n_out_blocks, blk_begin, n_tiles, x_rows,
        out_rows, F);
  else
    spmm_tiles_kernel<false><<<grid, block, 0, st>>>(
        ip, il, ib, nullptr, v, xx, o, n_out_blocks, blk_begin, n_tiles,
        x_rows, out_rows, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// z[p] = P_p · h[p] on row blocks [blk_begin, blk_end) (0 and nrb: all).
// row_ptr (P, nrb+1), live (P,), cols (P, n_tiles), vals (P, n_tiles, 128,
// 128), h (P, h_rows, F), z (P, num_rows, F); nrb = ceil(num_rows/128).
// An empty or out-of-range block range returns cudaErrorInvalidValue.
int gcn_spmm_f32(const void* row_ptr, const void* live, const void* cols,
                 const void* vals, const void* h, void* z, int P, int nrb,
                 int blk_begin, int blk_end, int n_tiles, int h_rows,
                 int num_rows, int F, void* stream) {
  return launch(false, row_ptr, live, cols, nullptr, vals, h, z, P, nrb,
                blk_begin, blk_end, n_tiles, h_rows, num_rows, F, stream);
}

// dcomb[p] = P_pᵀ · dz[p] on column blocks [blk_begin, blk_end). col_ptr
// (P, ncb+1), t_live (P,), t_in / t_perm (P, n_tiles), vals as above, dz
// (P, dz_rows, F), dcomb (P, num_cols, F); ncb = ceil(num_cols/128).
int gcn_spmm_t_f32(const void* col_ptr, const void* t_live, const void* t_in,
                   const void* t_perm, const void* vals, const void* dz,
                   void* dcomb, int P, int ncb, int blk_begin, int blk_end,
                   int n_tiles, int dz_rows, int num_cols, int F,
                   void* stream) {
  return launch(true, col_ptr, t_live, t_in, t_perm, vals, dz, dcomb, P, ncb,
                blk_begin, blk_end, n_tiles, dz_rows, num_cols, F, stream);
}

}  // extern "C"
