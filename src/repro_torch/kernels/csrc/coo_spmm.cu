// COO aggregation as one destination-segmented reduction, hand-written for
// Hopper (sm_90a): out[p, r] = Σ w[p, e] · x[p, src[p, e]] over the edges e
// of output row r, in float32 or float64, with no float atomic and no
// per-edge intermediate.
//
// Replaces no Pallas kernel: the JAX package computes its COO engine with
// jax.ops.segment_sum (repro/kernels/aggregate.py, _coo). The port's plain
// version (kernels/coo_spmm.py, spmm_plain) gathers one source row per
// padded edge slot into an (E, F) tensor, scales it into a second one and
// index_add_s the result with one float atomic per element; on the card
// that is three passes over E·F elements and E·F atomics on a few
// thousand hot rows. This kernel serves both directions of the engine:
// the forward z = P·comb walks the edges grouped by output row, the
// transpose δcomb = Pᵀ·δz the same edges grouped by column, each from a
// view built once per topology (coo_spmm.segment_view):
//   src, w  (P, E)     the real edges of each partition, stably sorted by
//                      output index (zero-weight padding slots left out);
//   items   (P, I, 5)  (output row r, first edge, end edge, chunk c,
//                      chunks n): row r's segment cut into n ≥ 1 work items
//                      of at most C edges (C = coo_spmm.COO_CHUNK), sorted
//                      by (r, c); a row without edges has one empty item,
//                      which writes its zeros. Pads at the tails have r = -1.
//
// What bounds it on this card: each edge costs one source row of F
// elements, read from wherever it lies, for 2·F flops: E·F·4 bytes of
// gathers in f32 (about 10 GB a call at F = 256 on the benchmark's proteins
// cell), far past the bytes of the edges and of each row read once. A
// partition's source rows (~22 MB there) fit in the 50 MB L2, so the
// design keeps the gathers in L2 and their latency hidden:
//   * one warp per work item; the grid runs partition-major, so the warps
//     in flight read one partition's rows while they stay in L2;
//   * lanes cover a column slice of SW = G·K·VEC elements: G lanes a row
//     (a power of two, up to 32), K vectors a lane, 16-byte vectors (VEC =
//     4 floats or 2 doubles) where F and the pointers allow it, else
//     scalars. With G < 32 the warp walks 32/G edges side by side and sums
//     the lanes of each column by a fixed xor butterfly at the end; F past
//     one slice takes several slices (grid.y), each re-reading the edges;
//   * an item's edge indices and weights are read once, coalesced, one per
//     lane, and broadcast by shuffle; U source rows are loaded before any is
//     multiplied, so U·K 16-byte loads a lane are in flight;
//   * a hub row (thousands of edges) becomes many items spread over the
//     card: a segment of one item writes its row directly; a segment of n
//     > 1 items writes each item's partial to a scratch buffer, and the
//     warp that arrives last at the segment's counter (atomicAdd after a
//     fence) adds the n partials in chunk order, its own from registers,
//     writes the row and sets the counter back to 0. Each item sums its
//     edges in a fixed order, so the result is the same bits run to run,
//     and outputs may be torch.empty;
//   * an output range [row_begin, row_end) runs one phase of the split
//     schedule: items of other rows write zeros (chunk 0) or return, and
//     the rows in range get the unsplit launch's items, bit for bit;
//   * the weight multiply is fused (fma) and the sum is kept in the
//     tensor's own type: no TF32, no bf16.
// A source index past x's rows reads as NaN, never another row's data.
// The C entry points launch on the caller's stream, allocate nothing
// (scratch and the zeroed counters come from the wrapper), and return
// cudaGetLastError() so a refused launch is seen.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // work items (warps) per thread block
constexpr int THREADS = WARPS * 32;
constexpr int ITEM_FIELDS = 5;
constexpr unsigned FULL = 0xffffffffu;

// VEC consecutive elements: a read-only load, a load through L2 only (the
// partials other warps wrote in this launch), and a store.
template <typename T, int VEC> struct Vec;

template <> struct Vec<float, 4> {
  __device__ static void ro(const float* p, float (&v)[4]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  __device__ static void cg(const float* p, float (&v)[4]) {
    const float4 q = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  __device__ static void st(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <> struct Vec<double, 2> {
  __device__ static void ro(const double* p, double (&v)[2]) {
    const double2 q = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = q.x; v[1] = q.y;
  }
  __device__ static void cg(const double* p, double (&v)[2]) {
    const double2 q = __ldcg(reinterpret_cast<const double2*>(p));
    v[0] = q.x; v[1] = q.y;
  }
  __device__ static void st(double* p, const double (&v)[2]) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  }
};

template <typename T> struct Vec<T, 1> {
  __device__ static void ro(const T* p, T (&v)[1]) { v[0] = __ldg(p); }
  __device__ static void cg(const T* p, T (&v)[1]) { v[0] = __ldcg(p); }
  __device__ static void st(T* p, const T (&v)[1]) { *p = v[0]; }
};

template <typename T> __device__ __forceinline__ T nan_of();
template <> __device__ __forceinline__ float nan_of<float>() {
  return CUDART_NAN_F;
}
template <> __device__ __forceinline__ double nan_of<double>() {
  return CUDART_NAN;
}

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// Source rows in flight per lane group: U·K vectors a lane, at most 8,
// and no more than the G edges a group takes from a batch of 32.
template <int G, int K> struct Unroll {
  static constexpr int WANT = 8 / K;
  static constexpr int U = WANT < G ? WANT : G;
};

template <typename T, int VEC, int G, int K>
__global__ void __launch_bounds__(THREADS)
coo_segment_kernel(const int* __restrict__ items,  // (P, n_items, 5)
                   const int* __restrict__ src,    // (P, n_edges)
                   const T* __restrict__ w,        // (P, n_edges)
                   const T* __restrict__ x,        // (P, x_rows, F)
                   T* __restrict__ out,            // (P, num_out, F)
                   T* __restrict__ scratch,        // (P, n_items, slices, SW)
                   int* __restrict__ counters,     // (P, num_out, slices)
                   int n_items, int blocks_per_part, int n_edges, int x_rows,
                   int num_out, int row_begin, int row_end, int F,
                   int slices) {
  constexpr int S = 32 / G;          // edges a warp walks side by side
  constexpr int SW = G * K * VEC;    // columns of one slice
  constexpr int U = Unroll<G, K>::U;
  using V = Vec<T, VEC>;
  const int p = blockIdx.x / blocks_per_part;
  const int lane = threadIdx.x & 31;
  const int item =
      (blockIdx.x - p * blocks_per_part) * WARPS + (threadIdx.x >> 5);
  if (item >= n_items) return;
  const int slice = blockIdx.y;
  const int* it = items + ((long long)p * n_items + item) * ITEM_FIELDS;
  const int r = it[0];
  if (r < 0) return;                 // a pad at the tail of the item list
  const int chunk = it[3], n_chunks = it[4];
  const int sub = lane / G, gl = lane % G;
  const int f0 = slice * SW + gl * VEC;
  T* orow = out + ((long long)p * num_out + r) * F;
  T acc[K][VEC];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[k][i] = T(0);

  auto store = [&]() {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int col = f0 + k * G * VEC;
      if (col < F) V::st(orow + col, acc[k]);
    }
  };

  if (r < row_begin || r >= row_end) {  // another phase's row: zeros
    if (chunk == 0 && sub == 0) store();
    return;
  }

  const int lo = it[1], hi = it[2];
  const int* sp = src + (long long)p * n_edges;
  const T* wp = w + (long long)p * n_edges;
  const T* xp = x + (long long)p * x_rows * F;
  for (int base = lo; base < hi; base += 32) {
    const int e = base + lane;
    const bool have = e < hi;
    const int my_s = have ? __ldg(sp + e) : 0;
    const T my_w = have ? __ldg(wp + e) : T(0);
    const int cnt = min(32, hi - base);
#pragma unroll
    for (int t0 = 0; t0 < G; t0 += U) {
      if (t0 * S >= cnt) break;      // the same for the whole warp
      T v[U][K][VEC];
      T ww[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = (t0 + u) * S + sub;   // < 32: edge j of the batch
        const int s = __shfl_sync(FULL, my_s, j);
        ww[u] = __shfl_sync(FULL, my_w, j);
        const bool ok = j < cnt;
        const bool in = s < x_rows;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int col = f0 + k * G * VEC;
          if (ok && in && col < F) {
            V::ro(xp + (long long)s * F + col, v[u][k]);
          } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i)
              v[u][k][i] = ok && !in ? nan_of<T>() : T(0);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            acc[k][i] = fma_t(ww[u], v[u][k][i], acc[k][i]);
    }
  }
  // The S lane groups of the warp summed different edges: add them by a
  // fixed butterfly (every group ends with the same bits).
#pragma unroll
  for (int off = G; off < 32; off <<= 1)
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        acc[k][i] += __shfl_xor_sync(FULL, acc[k][i], off);

  if (n_chunks > 1) {
    // A segment cut in several items: publish this item's partial, and let
    // the last warp of the segment to arrive add all partials in chunk
    // order.
    const long long stride = (long long)slices * SW;
    T* part = scratch + ((long long)p * n_items + item) * stride + slice * SW;
    if (sub == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) V::st(part + gl * VEC + k * G * VEC, acc[k]);
    }
    __threadfence();
    __syncwarp();
    int last = 0;
    if (lane == 0) {
      int* ctr = counters + ((long long)p * num_out + r) * slices + slice;
      last = atomicAdd(ctr, 1) == n_chunks - 1;
      if (last) atomicExch(ctr, 0);  // ready for the next launch
    }
    last = __shfl_sync(FULL, last, 0);
    if (!last || sub != 0) return;
    __threadfence();
    const T* first = part - chunk * stride;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      T s[VEC];
      for (int c = 0; c < n_chunks; ++c) {
        T v[VEC];
        if (c == chunk) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) v[i] = acc[k][i];
        } else {
          V::cg(first + c * stride + gl * VEC + k * G * VEC, v);
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) s[i] = c == 0 ? v[i] : s[i] + v[i];
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[k][i] = s[i];
    }
  }
  if (sub == 0) store();
}

struct Args {
  const int* items;
  const int* src;
  const void* w;
  const void* x;
  void* out;
  void* scratch;
  int* counters;
  int P, n_items, n_edges, x_rows, num_out, row_begin, row_end, F;
  cudaStream_t stream;
};

template <typename T, int VEC, int G, int K>
int launch_gk(const Args& a) {
  constexpr int SW = G * K * VEC;
  const int slices = (a.F + SW - 1) / SW;
  const int bpp = (a.n_items + WARPS - 1) / WARPS;
  const long long blocks = (long long)a.P * bpp;
  if (blocks > 0x7fffffff || slices > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), slices);
  coo_segment_kernel<T, VEC, G, K><<<grid, THREADS, 0, a.stream>>>(
      a.items, a.src, static_cast<const T*>(a.w), static_cast<const T*>(a.x),
      static_cast<T*>(a.out), static_cast<T*>(a.scratch), a.counters,
      a.n_items, bpp, a.n_edges, a.x_rows, a.num_out, a.row_begin, a.row_end,
      a.F, slices);
  return static_cast<int>(cudaGetLastError());
}

// The (G, K) pairs built: G lanes a row, K vectors a lane (K > 1 only with
// G = 32).
template <typename T, int VEC>
int launch_vec(const Args& a, int G, int K) {
#define COO_LAUNCH(g, k) \
  if (G == g && K == k) return launch_gk<T, VEC, g, k>(a)
  COO_LAUNCH(1, 1);
  COO_LAUNCH(2, 1);
  COO_LAUNCH(4, 1);
  COO_LAUNCH(8, 1);
  COO_LAUNCH(16, 1);
  COO_LAUNCH(32, 1);
  COO_LAUNCH(32, 2);
  COO_LAUNCH(32, 4);
#undef COO_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch(const void* items, const void* src, const void* w, const void* x,
           void* out, void* scratch, void* counters, int P, int n_items,
           int n_edges, int x_rows, int num_out, int row_begin, int row_end,
           int F, int vec, int G, int K, void* stream) {
  if (row_begin < 0 || row_end > num_out || row_begin >= row_end)
    return static_cast<int>(cudaErrorInvalidValue);
  if (P <= 0 || F <= 0 || n_items <= 0) return cudaSuccess;
  const Args a{static_cast<const int*>(items), static_cast<const int*>(src),
               w, x, out, scratch, static_cast<int*>(counters), P, n_items,
               n_edges, x_rows, num_out, row_begin, row_end, F,
               static_cast<cudaStream_t>(stream)};
  constexpr int NV = 16 / sizeof(T);
  if (vec == NV) return launch_vec<T, NV>(a, G, K);
  if (vec == 1) return launch_vec<T, 1>(a, G, K);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// out[p, r] = Σ w[p, e] · x[p, src[p, e]] over the edges of row r's work
// items, for the rows r in [row_begin, row_end); the other rows are
// written with zeros. items (P, n_items, 5), src (P, n_edges) int32; w
// (P, n_edges) and x (P, x_rows, F) float32; out (P, num_out, F); scratch
// ≥ P·n_items·slices·SW floats and counters ≥ P·num_out·slices int32,
// zero, where SW = G·K·vec and slices = ceil(F / SW); vec ∈ {1, 4}
// floats a load (4 needs F % 4 == 0 and 16-byte aligned x and out). G ∈
// {1, 2, 4, 8, 16, 32} lanes a row, K ∈ {1, 2, 4} (K > 1 with G = 32).
// Another vec or (G, K), or an empty or out-of-range row range, returns
// cudaErrorInvalidValue.
int coo_spmm_f32(const void* items, const void* src, const void* w,
                 const void* x, void* out, void* scratch, void* counters,
                 int P, int n_items, int n_edges, int x_rows, int num_out,
                 int row_begin, int row_end, int F, int vec, int G, int K,
                 void* stream) {
  return launch<float>(items, src, w, x, out, scratch, counters, P, n_items,
                       n_edges, x_rows, num_out, row_begin, row_end, F, vec,
                       G, K, stream);
}

// The same in float64, vec ∈ {1, 2}.
int coo_spmm_f64(const void* items, const void* src, const void* w,
                 const void* x, void* out, void* scratch, void* counters,
                 int P, int n_items, int n_edges, int x_rows, int num_out,
                 int row_begin, int row_end, int F, int vec, int G, int K,
                 void* stream) {
  return launch<double>(items, src, w, x, out, scratch, counters, P, n_items,
                        n_edges, x_rows, num_out, row_begin, row_end, F, vec,
                        G, K, stream);
}

}  // extern "C"
