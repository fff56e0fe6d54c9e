// Int4 dequant-matmul for Hopper (sm_90a): counterpart of
// image2text_tpu/ops/int4_matmul.py::_int4_matmul_kernel.
//
//   y[r, o] = Σ_b s[o, b] · Σ_{c in strip b} ( x[r, c]        · (lo(W[o, c]) − 8)
//                                           + x[r, in/2 + c] · (hi(W[o, c]) − 8) )
//
// W is (out, in/2) packed bytes, s (out, in/64) f32 or bf16 scales, x
// (rows, in) bf16, y (rows, out) bf16; accumulation in f32.
//
// A block owns a 64 x 64 (rows x outs) tile and walks the 32-column strips
// b: per step it copies (cp.async, double buffered) the low and high x
// tiles, the 64 x 32 packed bytes and the 64 scales into shared memory.
// Each of 4 warps computes 32 x 32 with mma.sync m16n8k16 (bf16 in, f32
// out): the B fragments are built straight from the packed bytes — a
// nibble q becomes the bf16 128 + q by bit pattern, minus 136 exactly —
// so the products x·(q − 8) are exact, the strip's partial sums stay in f32
// registers and are scaled by s[o, b] in f32 before joining the
// accumulator.  The float weight never exists in device memory.
#include "common.cuh"

using namespace i2t;

namespace {

constexpr int BM = 64, BN = 64, KS = 32;  // rows, outs, packed columns per step
constexpr int XLD = KS + 8;               // x tile row stride (bf16): conflict-free fragment loads
constexpr int WLD = KS + 16;              // packed tile row stride (bytes)
constexpr int THREADS = 128;

struct Stage {  // bf16 x tiles held as raw 16-bit words
  uint16_t xlo[BM * XLD];
  uint16_t xhi[BM * XLD];
  uint8_t w[BN * WLD];
  float s[BN];
};

// Two packed bytes (k in bits 0-7, k + 1 in bits 8-15) → the bf16 pair
// (q_k − 8, q_{k+1} − 8) of their low (HI false) or high nibbles.
template <bool HI>
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t w) {
  const uint32_t q = HI ? (((w >> 4) & 0xFu) | ((w & 0xF000u) << 4))
                        : ((w & 0xFu) | ((w & 0xF00u) << 8));
  uint32_t r = 0x43004300u | q;  // bf16 128 + q in each half
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&r);
  v = __hsub2(v, __float2bfloat162_rn(136.f));
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (16 x 16, row major) of rows r0.. and columns c0.. of a tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint16_t* t, int r0, int c0, int lane) {
  const int r = r0 + lane / 4, c = c0 + (lane % 4) * 2;
  a[0] = *reinterpret_cast<const uint32_t*>(t + r * XLD + c);
  a[1] = *reinterpret_cast<const uint32_t*>(t + (r + 8) * XLD + c);
  a[2] = *reinterpret_cast<const uint32_t*>(t + r * XLD + c + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(t + (r + 8) * XLD + c + 8);
}

template <bool SCALE_BF16>
__global__ void __launch_bounds__(THREADS)
    int4_matmul_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ w,
                       const void* __restrict__ scales, bf16* __restrict__ y, int rows, int out,
                       int in_pad) {
  __shared__ __align__(16) Stage st[2];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int half = in_pad / 2, nb = in_pad / 64;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  auto load = [&](int stage, int b) {
    Stage& S = st[stage];
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // 64 rows x 4 chunks of 8 bf16, each plane
      const int v = tid + i * THREADS, r = v / 4, c = (v % 4) * 8;
      const bool ok = m0 + r < rows;
      const bf16* src = x + (size_t)(ok ? m0 + r : 0) * in_pad + b * KS + c;
      cp_async16(S.xlo + r * XLD + c, src, ok);
      cp_async16(S.xhi + r * XLD + c, src + half, ok);
    }
    {  // 64 outs x 2 chunks of 16 bytes
      const int r = tid / 2, c = (tid % 2) * 16;
      const bool ok = n0 + r < out;
      cp_async16(S.w + r * WLD + c, w + (size_t)(ok ? n0 + r : 0) * half + b * KS + c, ok);
    }
    if (tid < BN) {
      const int n = n0 + tid;
      float s = 0.f;
      if (n < out) {
        const size_t at = (size_t)n * nb + b;
        s = SCALE_BF16 ? to_f(static_cast<const bf16*>(scales)[at])
                       : static_cast<const float*>(scales)[at];
      }
      S.s[tid] = s;
    }
    cp_async_commit();
  };

  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int g = lane / 4, tg = lane % 4;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  load(0, 0);
  for (int b = 0; b < nb; ++b) {
    if (b + 1 < nb) {
      load((b + 1) & 1, b + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const Stage& S = st[b & 1];
    float part[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      uint32_t alo[2][4], ahi[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        load_a(alo[i], S.xlo, wm + i * 16, kk * 16, lane);
        load_a(ahi[i], S.xhi, wm + i * 16, kk * 16, lane);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint8_t* wrow = S.w + (wn + j * 8 + g) * WLD + kk * 16 + tg * 2;
        const uint32_t w0 = *reinterpret_cast<const uint16_t*>(wrow);
        const uint32_t w1 = *reinterpret_cast<const uint16_t*>(wrow + 8);
        const uint32_t lo0 = nibbles_to_bf16x2<false>(w0), lo1 = nibbles_to_bf16x2<false>(w1);
        const uint32_t hi0 = nibbles_to_bf16x2<true>(w0), hi1 = nibbles_to_bf16x2<true>(w1);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(part[i][j], alo[i], lo0, lo1);
          mma_bf16(part[i][j], ahi[i], hi0, hi1);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float s0 = S.s[wn + j * 8 + tg * 2], s1 = S.s[wn + j * 8 + tg * 2 + 1];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[i][j][0] += part[i][j][0] * s0;
        acc[i][j][1] += part[i][j][1] * s1;
        acc[i][j][2] += part[i][j][2] * s0;
        acc[i][j][3] += part[i][j][3] * s1;
      }
    }
    __syncthreads();  // the next step's copies overwrite this stage
  }

  // Accumulator element e of an m16n8 tile: row g (+ 8 for e >= 2), column
  // tg·2 + e % 2.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + wm + i * 16 + g + (e >= 2 ? 8 : 0);
        const int c = n0 + wn + j * 8 + tg * 2 + e % 2;
        if (r < rows && c < out) y[(size_t)r * out + c] = to_bf(acc[i][j][e]);
      }
}

}  // namespace

extern "C" int int4_matmul_launch(const void* x, const void* w, const void* scales, int scale_bf16,
                                  void* y, int rows, int out, int in_pad, void* stream) {
  if (rows <= 0 || out <= 0 || in_pad <= 0 || in_pad % 64 || (rows + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((out + BN - 1) / BN, (rows + BM - 1) / BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const uint8_t* wb = static_cast<const uint8_t*>(w);
  bf16* yb = static_cast<bf16*>(y);
  if (scale_bf16)
    int4_matmul_kernel<true><<<grid, THREADS, 0, st>>>(xb, wb, scales, yb, rows, out, in_pad);
  else
    int4_matmul_kernel<false><<<grid, THREADS, 0, st>>>(xb, wb, scales, yb, rows, out, in_pad);
  return (int)cudaGetLastError();
}
