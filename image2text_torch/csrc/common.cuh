// Shared device helpers of the port's CUDA kernels (bf16 storage, f32 math).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <cmath>

namespace i2t {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

// WMMA tile shape for bf16 inputs and f32 accumulators.
constexpr int TM = 16, TN = 16, TK = 16;
using FragA = wmma::fragment<wmma::matrix_a, TM, TN, TK, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, TM, TN, TK, bf16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, TM, TN, TK, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, TM, TN, TK, float>;

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 to_bf(float v) { return __float2bfloat16(v); }
// Round an f32 value to bf16 (round to nearest even) and back: the
// storage-dtype rounding at a product's or an elementwise op's output.
__device__ __forceinline__ float rbf(float v) { return to_f(to_bf(v)); }

// jax.nn.gelu(approximate=True): 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;
  return 0.5f * x * (1.f + tanhf(k * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 8 consecutive bf16 values as one 16-byte access.
struct alignas(16) Bf16x8 {
  bf16 v[8];
};

// 16-byte asynchronous copy device → shared memory; pred false zero-fills
// the destination and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace i2t
