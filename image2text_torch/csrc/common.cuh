// Shared device helpers of the port's CUDA kernels (bf16 storage, f32 math).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace i2t {

using bf16 = __nv_bfloat16;

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

// Measurement switches of the block probes (image2text_torch/probes/
// block_ablate.py), fixed at compile time; the shipping build defines none:
//   I2T_GELU     0 tanh GELU, 1 0.5·x, 2 x·sigmoid(1.702 x)
//   I2T_SOFTMAX  0 exact softmax, 1 probabilities 0.01·s, 2 exp2 softmax
//   I2T_LN       0 LayerNorm, 1 identity (LN1 and the FFN's LN2 prologue)
#ifndef I2T_GELU
#define I2T_GELU 0
#endif
#ifndef I2T_SOFTMAX
#define I2T_SOFTMAX 0
#endif
#ifndef I2T_LN
#define I2T_LN 0
#endif

// The MoE FFN's activation (gelu_tanh unless a probe build swaps it); the
// caller rounds the result to bf16.
__device__ __forceinline__ float act(float x) {
#if I2T_GELU == 1
  return 0.5f * x;
#elif I2T_GELU == 2
  return x * rbf(1.f / (1.f + expf(-1.702f * x)));
#else
  return gelu_tanh(x);
#endif
}

// The flash kernels' dropout hash: a murmur3 finalizer over (row, col,
// plane = batch·h + head, seed), bit for bit the JAX package's
// ops/flash_attention.py::dropout_keep_mask; keep iff below the threshold.
__device__ __forceinline__ unsigned keep_hash(int row, int col, int plane, unsigned seed) {
  unsigned x = (unsigned)row * 0x9E3779B1u ^ (unsigned)col * 0x85EBCA77u ^
               (unsigned)plane * 0xC2B2AE3Du ^ seed;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// The flash entry points' trailing arguments (flash_attention.cu's bf16
// kernels and flash_attention_f32.cu's f32 ones: ops/flash_attention.py
// passes the same list to both), their Params built by the including
// file's make_params, and the dispatch on the head dim.
// The dropout hash's plane of (batch i, head j) is plane_off + i·plane_h +
// j: under a mesh a rank holding rows [b0, b0 + b) and heads [h0, h0 + h)
// of H hashes the global (b0 + i)·H + h0 + j (plane_h = H, plane_off =
// b0·H + h0); one device passes (h, 0).
#define I2T_FLASH_ARGS                                                                        \
  const void *bias, long long bsb, long long bsh, long long bsr, int b, int h, int hk, int sq, \
      int skv, int d, int causal, float scale, int dropout, unsigned seed, unsigned threshold, \
      float inv_keep, int plane_h, int plane_off, void *stream
#define I2T_FLASH_PARAMS \
  make_params(q, k, v, bias, bsb, bsh, bsr, b, h, hk, sq, skv, causal, scale, dropout, seed, \
              threshold, inv_keep, plane_h, plane_off)
// The kernels' head dims (256: JAX's flash takes any head dim up to 256;
// the host pads a head dim to the next of these with zero lanes).  The
// resident kernels take those up to 128 and refuse 256 themselves.
#define I2T_DISPATCH(X) \
  switch (d) {          \
    case 16: X(16);     \
    case 32: X(32);     \
    case 64: X(64);     \
    case 128: X(128);   \
    case 256: X(256);   \
    default: return (int)cudaErrorInvalidValue; \
  }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
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

// mma.sync m16n8k16, bf16 in, f32 accumulate: c += a·b.  Fragments
// (g = lane / 4, q = lane % 4): a0 (row g, k 2q..2q+1), a1 (row g + 8),
// a2 (row g, k 2q + 8..), a3 (row g + 8, k 2q + 8..); b0 (k 2q..2q+1, col
// g), b1 (k 2q + 8..); c0, c1 (row g, cols 2q, 2q + 1), c2, c3 (row g + 8).
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// Four 8x8 bf16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i.  With .trans each comes transposed: from a
// row-major (k, n) slab, the b0/b1 fragments of two n8 tiles.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
}
// Two f32 values as a bf16 pair (lo in the low half), rounded to nearest.
__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace i2t
