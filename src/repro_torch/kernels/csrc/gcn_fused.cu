// Fused aggregate+transform kernels for the PipeGCN layer, hand-written for
// Hopper (sm_90a), f32 FMA on the CUDA cores.
//
// Replace the TPU Pallas kernels of the JAX package:
//   forward    u = (P·h)@w + b [ReLU], z = P·h optional
//              repro/kernels/gcn_spmm.py:370 spmm_block_sparse_fused
//              (kernel body _kernel_fused, :328)
//   transpose  δcomb = Pᵀ·(du@wᵀ)
//              repro/kernels/gcn_spmm.py:458 spmm_block_sparse_fused_t
//              (kernel body _kernel_fused_t, :421)
//
// P is stored as dense 128×128 tiles over the same row-sorted forward and
// column-sorted transpose streams as csrc/gcn_spmm.cu, with the same run
// pointers and live lengths; the partition index is grid.z.
//
// What bounds them on this card: the aggregation does 2·128²·F flops per
// tile against 64 KB of tile values (F/2 flops per byte; the f32 ridge is
// 67 TFLOP/s / 3.35 TB/s = 20), so at the hidden widths both kernels are
// bound by the f32 FMA rate. The Pallas kernel keeps a (128, F_in)
// accumulator, the whole (F_in, F_out) weight and a (128, F_out) output
// block in VMEM; at F_in = F_out = 512 (yelp-sim) those are 256 KB, 1 MB
// and 256 KB, and a Hopper block has 227 KB of shared memory.
//
// Forward design: a thread-block cluster per (row block, partition) of
// ceil(F_in/64) ≤ 8 blocks. Block k of the cluster walks the row run once
// and accumulates z[:, 64k : 64k+64] in registers, then parks that slice in
// its own shared memory (32 KB) and, when asked, writes it to z. After a
// cluster barrier each block computes 64-column slices of u, reading the
// whole z row block from its peers' shared memory (distributed shared
// memory) and streaming w through shared memory in k-chunks; bias and ReLU
// are applied before the store. So z never goes to device memory to be
// read back, the aggregation keeps the parallelism of the unfused kernel
// (one block per 64 feature columns), and F_in up to 512 fits. A final
// cluster barrier keeps each block's slice alive until its peers are done.
//
// Transpose design: grid (column block, 64-column slice of F_in,
// partition). For each slot of its run the block first computes the
// prologue dz = du[input row block] @ w[slice, :]ᵀ (128 × 64, w read in
// its stored (F_in, F_out) layout, no transposed copy) into shared
// memory, then adds tileᵀ @ dz into its register accumulator. The prologue
// is paid once per slot and slice, as on the TPU: 2·128·F_out·64 flops
// against 2·128·128·64 for the tile, twice the tile's work at F_out = 256.
// The (rows, F_in) product du@wᵀ never exists in device memory.
//
// Both kernels: 256 threads own a 128 × 64 output block, 8 rows × 4 columns
// each; operands are staged through shared memory in k-chunks of 32 and
// contracted with fmaf (no tensor cores, no TF32, no atomics). The compiler
// gives them 220 (forward) and 239 (transpose) registers a thread, so one
// block fits an SM; capping them at 128 for two blocks spilled and ran
// slower on an H100 (PERF.md).
// Accumulation follows the stream order, so results are deterministic.
// Runs stop at each partition's live length (past it only zero padding
// tiles remain). Ragged row counts and widths are masked, never padded; an
// empty run still writes u = b (ReLU'd if asked), z = 0 and δcomb = 0, so
// the caller may allocate every output with torch.empty. The C entry
// points launch on the caller's stream, allocate nothing and return the
// launch's cudaError_t.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TILE = 128;     // adjacency tile edge (matches the tile streams)
constexpr int FB = 64;        // output columns per thread block
constexpr int KC = 32;        // contraction chunk staged in shared memory
constexpr int THREADS = 256;  // 16 × 16 threads
constexpr int RPT = 8;        // output rows per thread   (16 · 8 = 128)
constexpr int CPT = 4;        // output columns per thread (16 · 4 = 64)
constexpr int LDA = TILE + 1; // as_[KC][LDA]: A chunk, stored k-major
constexpr int LDB = FB + 1;   // bs_[KC][LDB]: B chunk
constexpr int LDZ = FB + 1;   // [TILE][LDZ]: a 128 × 64 slice kept on chip
constexpr int MAX_CLUSTER = 8;
constexpr size_t SMEM_BYTES =
    sizeof(float) * (KC * LDA + KC * LDB + TILE * LDZ);

// as_[kk][m] = src[m][k0 + kk] for m < 128, kk < KC (row-major src with
// leading dimension ld); rows ≥ m_valid and columns ≥ k_valid read as 0.
__device__ __forceinline__ void stage_a_rows(float* as_, const float* src,
                                             long long ld, int k0,
                                             int m_valid, int k_valid,
                                             int tid) {
#pragma unroll
  for (int it = 0; it < (TILE * KC) / THREADS; ++it) {
    const int idx = it * THREADS + tid;
    const int m = idx / KC;
    const int kk = idx % KC;
    as_[kk * LDA + m] = (m < m_valid && k0 + kk < k_valid)
                            ? src[m * ld + k0 + kk] : 0.f;
  }
}

// as_[kk][m] = tile[k0 + kk][m]: the tile contracted transposed.
__device__ __forceinline__ void stage_a_cols(float* as_, const float* tile,
                                             int k0, int tid) {
#pragma unroll
  for (int it = 0; it < (TILE * KC) / THREADS; ++it) {
    const int idx = it * THREADS + tid;
    const int kk = idx / TILE;
    const int m = idx % TILE;
    as_[kk * LDA + m] = tile[(k0 + kk) * TILE + m];
  }
}

// bs_[kk][n] = src[k0 + kk][c0 + n]; rows ≥ k_valid, columns ≥ c_valid
// read as 0.
__device__ __forceinline__ void stage_b_rows(float* bs_, const float* src,
                                             long long ld, int k0, int c0,
                                             int k_valid, int c_valid,
                                             int tid) {
#pragma unroll
  for (int it = 0; it < (KC * FB) / THREADS; ++it) {
    const int idx = it * THREADS + tid;
    const int kk = idx / FB;
    const int n = idx % FB;
    const int k = k0 + kk;
    const int c = c0 + n;
    bs_[kk * LDB + n] = (k < k_valid && c < c_valid) ? src[k * ld + c] : 0.f;
  }
}

// bs_[kk][n] = src[c0 + n][k0 + kk]: a row slice of src used transposed
// (w[f][:] as column f of wᵀ); rows ≥ c_valid, columns ≥ k_valid read as 0.
__device__ __forceinline__ void stage_b_cols(float* bs_, const float* src,
                                             long long ld, int k0, int c0,
                                             int k_valid, int c_valid,
                                             int tid) {
#pragma unroll
  for (int it = 0; it < (KC * FB) / THREADS; ++it) {
    const int idx = it * THREADS + tid;
    const int n = idx / KC;
    const int kk = idx % KC;
    const int k = k0 + kk;
    const int c = c0 + n;
    bs_[kk * LDB + n] = (k < k_valid && c < c_valid) ? src[c * ld + k] : 0.f;
  }
}

// acc[i][j] += Σ_kk A[kk][ty + 16i] · B[kk][tx + 16j] over one k-chunk.
__device__ __forceinline__ void fma_chunk(const float* as_, const float* B,
                                          int ldb, float (&acc)[RPT][CPT],
                                          int tx, int ty) {
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
    float a[RPT], b[CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) a[i] = as_[kk * LDA + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < CPT; ++j) b[j] = B[kk * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[RPT][CPT]) {
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
}

__global__ void __launch_bounds__(THREADS)
fused_fwd_kernel(const int* __restrict__ ptr,     // (P, n_row_blocks + 1)
                 const int* __restrict__ live,    // (P,) live stream length
                 const int* __restrict__ cols,    // (P, n_tiles) input block
                 const float* __restrict__ vals,  // (P, n_tiles, 128, 128)
                 const float* __restrict__ h,     // (P, h_rows, Fin)
                 const float* __restrict__ w,     // (Fin, Fout)
                 const float* __restrict__ bias,  // (Fout,)
                 float* __restrict__ u,           // (P, out_rows, Fout)
                 float* __restrict__ z,           // (P, out_rows, Fin) or null
                 int n_row_blocks, int n_tiles, int h_rows, int out_rows,
                 int Fin, int Fout, int relu) {
  extern __shared__ float smem[];
  float* as_ = smem;
  float* bs_ = as_ + KC * LDA;
  float* zs = bs_ + KC * LDB;   // this block's 128 × 64 slice of z

  cg::cluster_group cluster = cg::this_cluster();
  const int slice = blockIdx.x;       // == cluster.block_rank()
  const int n_slices = gridDim.x;     // == the cluster size
  const int r = blockIdx.y;
  const int p = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int f0 = slice * FB;

  const int* pp = ptr + (long long)p * (n_row_blocks + 1);
  const int s_end = min(pp[r + 1], live[p]);
  const int s_begin = min(pp[r], s_end);
  const int* cp = cols + (long long)p * n_tiles;
  const float* hp = h + (long long)p * h_rows * Fin;

  // (1) z[:, f0 : f0 + 64] of row block r, in stream order.
  float acc[RPT][CPT];
  zero(acc);
  for (int s = s_begin; s < s_end; ++s) {
    const int in_row0 = cp[s] * TILE;
    const float* tv = vals + ((long long)p * n_tiles + s) * (TILE * TILE);
    const float* hb = hp + (long long)in_row0 * Fin;
    for (int k0 = 0; k0 < TILE; k0 += KC) {
      __syncthreads();  // previous chunk fully consumed
      stage_a_rows(as_, tv, TILE, k0, TILE, TILE, tid);
      stage_b_rows(bs_, hb, Fin, k0, f0, h_rows - in_row0, Fin, tid);
      __syncthreads();
      fma_chunk(as_, bs_, LDB, acc, tx, ty);
    }
  }
  float* zp = z ? z + (long long)p * out_rows * Fin : nullptr;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int m = ty + 16 * i;
    const int row = r * TILE + m;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int n = tx + 16 * j;
      zs[m * LDZ + n] = acc[i][j];   // columns past Fin hold 0
      if (zp && row < out_rows && f0 + n < Fin)
        zp[(long long)row * Fin + f0 + n] = acc[i][j];
    }
  }
  cluster.sync();  // every slice of the z row block is in shared memory

  // (2) u[:, g0 : g0 + 64] = z @ w[:, g0 : g0 + 64] + b for the output
  // slices o = slice, slice + n_slices, ...; z chunk k0 lives in the shared
  // memory of cluster block k0 / 64.
  const int n_out = (Fout + FB - 1) / FB;
  float* up = u + (long long)p * out_rows * Fout;
  for (int o = slice; o < n_out; o += n_slices) {
    const int g0 = o * FB;
    zero(acc);
    for (int k0 = 0; k0 < Fin; k0 += KC) {
      const float* peer = cluster.map_shared_rank(zs, k0 / FB);
      __syncthreads();
      stage_a_rows(as_, peer, LDZ, k0 % FB, TILE, FB, tid);
      stage_b_rows(bs_, w, Fout, k0, g0, Fin, Fout, tid);
      __syncthreads();
      fma_chunk(as_, bs_, LDB, acc, tx, ty);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = r * TILE + ty + 16 * i;
      if (row >= out_rows) continue;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = g0 + tx + 16 * j;
        if (col >= Fout) continue;
        float v = acc[i][j] + bias[col];
        if (relu) v = fmaxf(v, 0.f);
        up[(long long)row * Fout + col] = v;
      }
    }
  }
  cluster.sync();  // peers may still be reading this block's slice
}

__global__ void __launch_bounds__(THREADS)
fused_t_kernel(const int* __restrict__ ptr,     // (P, n_col_blocks + 1)
               const int* __restrict__ live,    // (P,) live stream length
               const int* __restrict__ t_in,    // (P, n_tiles) du row block
               const int* __restrict__ perm,    // (P, n_tiles) tile index
               const float* __restrict__ vals,  // (P, n_tiles, 128, 128)
               const float* __restrict__ du,    // (P, du_rows, Fout)
               const float* __restrict__ w,     // (Fin, Fout)
               float* __restrict__ out,         // (P, out_rows, Fin)
               int n_col_blocks, int n_tiles, int du_rows, int out_rows,
               int Fin, int Fout) {
  extern __shared__ float smem[];
  float* as_ = smem;
  float* bs_ = as_ + KC * LDA;
  float* ds = bs_ + KC * LDB;   // the slot's prologue, 128 × 64

  const int c = blockIdx.x;
  const int f0 = blockIdx.y * FB;
  const int p = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const int* pp = ptr + (long long)p * (n_col_blocks + 1);
  const int s_end = min(pp[c + 1], live[p]);
  const int s_begin = min(pp[c], s_end);
  const int* ip = t_in + (long long)p * n_tiles;
  const int* mp = perm + (long long)p * n_tiles;
  const float* dp = du + (long long)p * du_rows * Fout;

  float acc[RPT][CPT];
  zero(acc);
  for (int s = s_begin; s < s_end; ++s) {
    const int in_row0 = ip[s] * TILE;
    const float* tv = vals + ((long long)p * n_tiles + mp[s]) * (TILE * TILE);
    const float* db = dp + (long long)in_row0 * Fout;
    // prologue: ds = du[in_row0 : +128, :] @ w[f0 : f0 + 64, :]ᵀ
    float pro[RPT][CPT];
    zero(pro);
    for (int k0 = 0; k0 < Fout; k0 += KC) {
      __syncthreads();  // also: the previous slot is done reading ds
      stage_a_rows(as_, db, Fout, k0, du_rows - in_row0, Fout, tid);
      stage_b_cols(bs_, w, Fout, k0, f0, Fout, Fin, tid);
      __syncthreads();
      fma_chunk(as_, bs_, LDB, pro, tx, ty);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        ds[(ty + 16 * i) * LDZ + tx + 16 * j] = pro[i][j];
    // acc += tileᵀ @ ds
    for (int k0 = 0; k0 < TILE; k0 += KC) {
      __syncthreads();
      stage_a_cols(as_, tv, k0, tid);
      __syncthreads();
      fma_chunk(as_, ds + k0 * LDZ, LDZ, acc, tx, ty);
    }
  }

  float* op = out + (long long)p * out_rows * Fin;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = c * TILE + ty + 16 * i;
    if (row >= out_rows) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = f0 + tx + 16 * j;
      if (col < Fin) op[(long long)row * Fin + col] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// u[p] = (P_p · h[p]) @ w + b (ReLU'd when relu != 0), and z[p] = P_p · h[p]
// when z is not null. row_ptr (P, nrb+1), live (P,), cols (P, n_tiles),
// vals (P, n_tiles, 128, 128), h (P, h_rows, Fin), w (Fin, Fout), b (Fout,),
// u (P, num_rows, Fout), z (P, num_rows, Fin); nrb = ceil(num_rows/128),
// Fin ≤ 512.
int gcn_spmm_fused_f32(const void* row_ptr, const void* live,
                       const void* cols, const void* vals, const void* h,
                       const void* w, const void* b, void* u, void* z, int P,
                       int nrb, int n_tiles, int h_rows, int num_rows,
                       int Fin, int Fout, int relu, void* stream) {
  if (P <= 0 || nrb <= 0 || Fin <= 0 || Fout <= 0) return cudaSuccess;
  const int n_slices = (Fin + FB - 1) / FB;
  if (n_slices > MAX_CLUSTER) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_slices, nrb, P);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_slices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, fused_fwd_kernel, static_cast<const int*>(row_ptr),
      static_cast<const int*>(live), static_cast<const int*>(cols),
      static_cast<const float*>(vals), static_cast<const float*>(h),
      static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<float*>(u), static_cast<float*>(z), nrb, n_tiles, h_rows,
      num_rows, Fin, Fout, relu);
  if (err != cudaSuccess) return err;
  return static_cast<int>(cudaGetLastError());
}

// dcomb[p] = P_pᵀ · (du[p] @ wᵀ). col_ptr (P, ncb+1), t_live (P,), t_in /
// t_perm (P, n_tiles), vals as above, du (P, du_rows, Fout), w (Fin, Fout),
// dcomb (P, num_cols, Fin); ncb = ceil(num_cols/128).
int gcn_spmm_fused_t_f32(const void* col_ptr, const void* t_live,
                         const void* t_in, const void* t_perm,
                         const void* vals, const void* du, const void* w,
                         void* dcomb, int P, int ncb, int n_tiles,
                         int du_rows, int num_cols, int Fin, int Fout,
                         void* stream) {
  if (P <= 0 || ncb <= 0 || Fin <= 0 || Fout <= 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      fused_t_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  const dim3 grid(ncb, (Fin + FB - 1) / FB, P);
  fused_t_kernel<<<grid, THREADS, SMEM_BYTES,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(col_ptr), static_cast<const int*>(t_live),
      static_cast<const int*>(t_in), static_cast<const int*>(t_perm),
      static_cast<const float*>(vals), static_cast<const float*>(du),
      static_cast<const float*>(w), static_cast<float*>(dcomb), ncb, n_tiles,
      du_rows, num_cols, Fin, Fout);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
