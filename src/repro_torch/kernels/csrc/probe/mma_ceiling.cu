// The tensor-core rate that mma.sync reaches on this card: each warp issues
// chains of independent m16n8k8 TF32 or m16n8k16 bf16 steps (f32
// accumulation) from registers, with no memory traffic, so the time is the
// instruction's own throughput. A yardstick for the kernels built on
// mma.sync (flash_attention.cu, gcn_spmm.cu), timed by
// repro_torch.launch.bench_attention; it computes nothing the port uses.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHAINS = 8;  // independent accumulators per warp

template <bool TF32>
__global__ void __launch_bounds__(256) mma_ceiling_kernel(float* out,
                                                          int iters) {
  float d[CHAINS][4] = {};
  // 1.0 as tf32, or a pair of bf16 1.0s
  const uint32_t one = TF32 ? 0x3f800000u : 0x3f803f80u;
  const uint32_t a[4] = {one, one, one, one};
  const uint32_t b0 = one, b1 = one;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int n = 0; n < CHAINS; ++n) {
      if (TF32) {
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[n][0]), "+f"(d[n][1]), "+f"(d[n][2]), "+f"(d[n][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      } else {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[n][0]), "+f"(d[n][1]), "+f"(d[n][2]), "+f"(d[n][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      }
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int n = 0; n < CHAINS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum += d[n][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

}  // namespace

extern "C" {

// blocks × 256 threads, each warp iters × CHAINS mma steps; out holds
// blocks × 256 floats. Returns cudaGetLastError().
int mma_ceiling(int tf32, int blocks, int iters, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tf32)
    mma_ceiling_kernel<true><<<blocks, 256, 0, s>>>(out, iters);
  else
    mma_ceiling_kernel<false><<<blocks, 256, 0, s>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
