// Kernels of the eval encoder blocks for Hopper (sm_90a): counterpart of
// image2text_tpu/ops/fused_block.py::_sparse_block_kernel (the lazy sparse
// block) and ::_block_kernel (the dense block, the same chain on the whole
// stream), as a short sequence of kernels (the TPU kernels' resident 7.6 MB
// of weights do not fit a Hopper block's 227 KB of shared memory):
//
//   ln_gather   LN1 of the selected rows, read through a row-index list
//               (or of every row when the list is null);
//   gemm        C = A·B (+ bias) (+ residual), bf16 tensor cores with f32
//               accumulators (gemm.cuh); A and the residual are read through
//               row-index lists and C rows land at an offset, so the lazy
//               layout's [sel; byp] gather and concat cost no separate pass;
//   mqa_attention  one shared K/V head, scores rounded to bf16 before an
//               f32 softmax, probabilities in bf16 before the V product.
//
// The block's MoE FFN stage is the kernel of fused_moe.cu.
#include "common.cuh"
#include "gemm.cuh"

using namespace i2t;

namespace {

// ---------------------------------------------------------------- LN gather
// out[m] = LN(x[(m / tg) * T + rows[m % tg]]) with f32 two-pass statistics,
// one warp per row; a null row list reads row m.
__global__ void __launch_bounds__(256) ln_gather_kernel(const bf16* x, bf16* out, const int* rows,
                                                        int b, int T, int tg, int d,
                                                        const bf16* w, const bf16* bias) {
  const int m = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (m >= b * tg) return;
  const bf16* src = x + map_row(m, rows, T, tg) * d;
  float sum = 0.f;
  for (int c = lane * 8; c < d; c += 256) {
    const Bf16x8 v = *reinterpret_cast<const Bf16x8*>(src + c);
#pragma unroll
    for (int t = 0; t < 8; ++t) sum += to_f(v.v[t]);
  }
  const float mean = warp_sum(sum) / d;
  float var = 0.f;
  for (int c = lane * 8; c < d; c += 256) {
    const Bf16x8 v = *reinterpret_cast<const Bf16x8*>(src + c);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float e = to_f(v.v[t]) - mean;
      var += e * e;
    }
  }
  const float rstd = rsqrtf(warp_sum(var) / d + 1e-5f);
  for (int c = lane * 8; c < d; c += 256) {
    const Bf16x8 v = *reinterpret_cast<const Bf16x8*>(src + c);
    Bf16x8 o;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      float y = (to_f(v.v[t]) - mean) * rstd;
      y = y * to_f(w[c + t]);
      if (bias != nullptr) y = y + to_f(bias[c + t]);
      o.v[t] = to_bf(y);
    }
    *reinterpret_cast<Bf16x8*>(out + (size_t)m * d + c) = o;
  }
}

// ------------------------------------------------------------ MQA attention
// A warp takes 16 query rows of one (image, head); a block holds 4 warps.
// qkv holds tp = t rounded up to 16 rows per image, rows t..tp zero; a row
// is [q (n_head·hd) | k (hd) | v (hd)]; o rows are n_head·hd, t per image.
// Q, K and V fragments load straight from device memory (the image's K/V
// rows stay hot in L1/L2 across its heads); the scores live in shared
// memory as bf16 — the storage-dtype rounding the softmax reads — and are
// turned into bf16 probabilities in place; key columns >= t are masked.
struct AttnArgs {
  const bf16* qkv;
  bf16* o;
  int t, tp, n_head, d, ldq;
  float scale;
};

__host__ __device__ constexpr size_t attn_warp_bytes(int tp) { return 32 * (size_t)tp + 1024; }

template <int HD>
__global__ void __launch_bounds__(128) mqa_attention_kernel(AttnArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = p.t, tp = p.tp, ldq = p.ldq;
  const int img = blockIdx.z, h = blockIdx.y;
  const int q0 = (blockIdx.x * 4 + warp) * 16;
  if (q0 >= t) return;  // no block-wide barriers in this kernel
  bf16* sP = reinterpret_cast<bf16*>(smem_raw + warp * attn_warp_bytes(tp));
  float* stg = reinterpret_cast<float*>(sP + 16 * tp);
  const bf16* base = p.qkv + (size_t)img * tp * ldq;

  FragA qf[HD / 16];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], base + (size_t)q0 * ldq + h * HD + kk * 16, ldq);

  // S = Q Kᵀ (f32), scaled in f32 and rounded to bf16
  for (int j = 0; j < tp / 16; ++j) {
    FragC c;
    wmma::fill_fragment(c, 0.f);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      FragBT fb;
      wmma::load_matrix_sync(fb, base + (size_t)j * 16 * ldq + p.d + kk * 16, ldq);
      wmma::mma_sync(c, qf[kk], fb, c);
    }
    wmma::store_matrix_sync(stg, c, 16, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 256; i += 32) sP[(i / 16) * tp + j * 16 + i % 16] = to_bf(stg[i] * p.scale);
    __syncwarp();
  }

  // softmax in f32 per row; bf16 probabilities written over the scores
  for (int row = 0; row < 16; ++row) {
    bf16* srow = sP + row * tp;
    float mx = -INFINITY;
    for (int c = lane; c < t; c += 32) mx = fmaxf(mx, to_f(srow[c]));
    mx = warp_max(mx);
    float sum = 0.f;
    for (int c = lane; c < t; c += 32) sum += expf(to_f(srow[c]) - mx);
    sum = warp_sum(sum);
    for (int c = lane; c < tp; c += 32)
      srow[c] = to_bf(c < t ? expf(to_f(srow[c]) - mx) / sum : 0.f);
  }
  __syncwarp();

  // O = P V
  const int r = lane / 2, c8 = (lane % 2) * 8;
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) {
    FragC c;
    wmma::fill_fragment(c, 0.f);
    for (int kk = 0; kk < tp / 16; ++kk) {
      FragA fa;
      FragB fb;
      wmma::load_matrix_sync(fa, sP + kk * 16, tp);
      wmma::load_matrix_sync(fb, base + (size_t)kk * 16 * ldq + p.d + HD + j * 16, ldq);
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(stg, c, 16, wmma::mem_row_major);
    __syncwarp();
    if (q0 + r < t) {
      Bf16x8 o;
#pragma unroll
      for (int e = 0; e < 8; ++e) o.v[e] = to_bf(stg[r * 16 + c8 + e]);
      *reinterpret_cast<Bf16x8*>(p.o + ((size_t)img * t + q0 + r) * p.d + h * HD + j * 16 + c8) =
          o;
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int ln_gather_launch(const void* x, void* out, const void* rows, int b, int T, int tg,
                                int d, const void* w, const void* bias, void* stream) {
  if (b <= 0 || tg <= 0 || d % 8) return (int)cudaErrorInvalidValue;
  const int rows_total = b * tg;
  ln_gather_kernel<<<(rows_total + 7) / 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), static_cast<const int*>(rows), b, T,
      tg, d, static_cast<const bf16*>(w), static_cast<const bf16*>(bias));
  return (int)cudaGetLastError();
}

extern "C" int gemm_launch(const void* A, const void* a_rows, int a_T, const void* B,
                           const void* bias, const void* R, const void* r_rows, int r_T, void* C,
                           int c_T, int c_off, int n_img, int t_g, int N, int K, void* stream) {
  return launch_gemm(A, a_rows, a_T, B, bias, R, r_rows, r_T, C, c_T, c_off, n_img, t_g, N, K,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int mqa_attention_launch(const void* qkv, void* o, int b, int t, int n_head, int hd,
                                    float scale, void* stream) {
  if (b <= 0 || t <= 0 || n_head <= 0) return (int)cudaErrorInvalidValue;
  AttnArgs p;
  p.qkv = static_cast<const bf16*>(qkv);
  p.o = static_cast<bf16*>(o);
  p.t = t;
  p.tp = (t + 15) / 16 * 16;
  p.n_head = n_head;
  p.d = n_head * hd;
  p.ldq = p.d + 2 * hd;
  p.scale = scale;
  const size_t smem = 4 * attn_warp_bytes(p.tp);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  dim3 grid((t + 63) / 64, n_head, b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (hd) {
#define I2T_ATTN(HD)                                                                        \
  case HD:                                                                                  \
    err = cudaFuncSetAttribute(mqa_attention_kernel<HD>,                                    \
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);     \
    if (err != cudaSuccess) return (int)err;                                                \
    mqa_attention_kernel<HD><<<grid, 128, smem, st>>>(p);                                   \
    break;
    I2T_ATTN(16)
    I2T_ATTN(32)
    I2T_ATTN(64)
    I2T_ATTN(128)
#undef I2T_ATTN
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
