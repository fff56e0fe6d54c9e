// The port's tiled bf16 tensor-core GEMM (sm_90a), shared by the encoder
// block kernels (fused_block.cu) and the encoder front (fused_frontend.cu):
//
//   C[(m / t_g) * c_T + c_off + m % t_g, n] =
//       bf16(bf16(bf16(Σ_k A[arow(m), k] B[k, n]) + bias[n]) + R[rrow(m), n])
//
// A (M, K) and the residual R are read through optional row-index lists
// (row m of image m / t_g is row rows[m % t_g] of that image's T rows); C
// rows land at an offset inside images of c_T rows.  Bias and residual are
// optional.  f32 accumulators, each add rounded to bf16 as the module chain
// rounds it.  128x128 block tile, 8 warps of 32x64 WMMA tiles, BK = 32,
// cp.async double buffering.
#pragma once

#include "common.cuh"

namespace i2t {

constexpr int GEMM_BM = 128, GEMM_BN = 128, GEMM_BK = 32, GEMM_PAD = 8;
constexpr int GEMM_LDA = GEMM_BK + GEMM_PAD;  // shared-memory row strides (bf16 elements)
constexpr int GEMM_LDB = GEMM_BN + GEMM_PAD;
constexpr size_t GEMM_SMEM = 2 * (GEMM_BM * GEMM_LDA + GEMM_BK * GEMM_LDB) * sizeof(bf16);

struct GemmArgs {
  const bf16* A;
  const int* a_rows;
  int a_T;
  const bf16* B;  // (K, N) row-major
  const bf16* bias;
  const bf16* R;
  const int* r_rows;
  int r_T;
  bf16* C;
  int c_T, c_off, t_g, M, N, K;
};

// Row of the logical m-th row through an optional index list.
__device__ __forceinline__ size_t map_row(int m, const int* rows, int T, int t_g) {
  return rows != nullptr ? (size_t)(m / t_g) * T + rows[m % t_g] : (size_t)m;
}

__global__ void __launch_bounds__(256) gemm_kernel(GemmArgs p) {
  constexpr int BM = GEMM_BM, BN = GEMM_BN, BK = GEMM_BK, LDA = GEMM_LDA, LDB = GEMM_LDB;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);
  bf16* sB = sA + 2 * BM * LDA;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  const bf16* a_src[2];
  bool a_ok[2];
  int a_off[2], b_row[2], b_col[2];
  bool b_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = tid + i * 256;
    const int row = v / (BK / 8), cv = (v % (BK / 8)) * 8;
    const int m = m0 + row;
    a_ok[i] = m < p.M;
    a_src[i] = p.A + (a_ok[i] ? map_row(m, p.a_rows, p.a_T, p.t_g) : 0) * p.K + cv;
    a_off[i] = row * LDA + cv;
    b_row[i] = v / (BN / 8);
    b_col[i] = (v % (BN / 8)) * 8;
    b_ok[i] = n0 + b_col[i] < p.N;
  }
  auto load_stage = [&](int stage, int kt) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      cp_async16(sA + stage * BM * LDA + a_off[i], a_ok[i] ? a_src[i] + kt * BK : p.A, a_ok[i]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      cp_async16(sB + stage * BK * LDB + b_row[i] * LDB + b_col[i],
                 b_ok[i] ? p.B + (size_t)(kt * BK + b_row[i]) * p.N + n0 + b_col[i] : p.B,
                 b_ok[i]);
    cp_async_commit();
  };

  FragC acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int KT = p.K / BK;
  load_stage(0, 0);
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) {
      load_stage((kt + 1) & 1, kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* a = sA + (kt & 1) * BM * LDA;
    const bf16* b = sB + (kt & 1) * BK * LDB;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      FragA fa[2];
      FragB fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a + (wm * 32 + i * 16) * LDA + kk * 16, LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], b + kk * 16 * LDB + wn * 64 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue through a per-warp 16x16 f32 staging tile.
  float* stg = reinterpret_cast<float*>(smem_raw) + warp * 256;
  const int r = lane / 2, c8 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(stg, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + wm * 32 + i * 16 + r;
      const int n = n0 + wn * 64 + j * 16 + c8;
      if (m < p.M && n < p.N) {
        Bf16x8 bb, rb, o;
        if (p.bias != nullptr) bb = *reinterpret_cast<const Bf16x8*>(p.bias + n);
        if (p.R != nullptr)
          rb = *reinterpret_cast<const Bf16x8*>(
              p.R + map_row(m, p.r_rows, p.r_T, p.t_g) * p.N + n);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          float v = rbf(stg[r * 16 + c8 + t]);
          if (p.bias != nullptr) v = rbf(v + to_f(bb.v[t]));
          if (p.R != nullptr) v = rbf(to_f(rb.v[t]) + v);
          o.v[t] = to_bf(v);
        }
        const size_t crow = (size_t)(m / p.t_g) * p.c_T + p.c_off + m % p.t_g;
        *reinterpret_cast<Bf16x8*>(p.C + crow * p.N + n) = o;
      }
      __syncwarp();
    }
  }
}

// Launch on ``stream``; returns the cudaError_t of the launch (N must be a
// multiple of 16 and K a positive multiple of 32).
inline int launch_gemm(const void* A, const void* a_rows, int a_T, const void* B,
                       const void* bias, const void* R, const void* r_rows, int r_T, void* C,
                       int c_T, int c_off, int n_img, int t_g, int N, int K,
                       cudaStream_t stream) {
  if (n_img <= 0 || t_g <= 0 || N % 16 || K % GEMM_BK || K <= 0)
    return (int)cudaErrorInvalidValue;
  GemmArgs p;
  p.A = static_cast<const bf16*>(A);
  p.a_rows = static_cast<const int*>(a_rows);
  p.a_T = a_T;
  p.B = static_cast<const bf16*>(B);
  p.bias = static_cast<const bf16*>(bias);
  p.R = static_cast<const bf16*>(R);
  p.r_rows = static_cast<const int*>(r_rows);
  p.r_T = r_T;
  p.C = static_cast<bf16*>(C);
  p.c_T = c_T;
  p.c_off = c_off;
  p.t_g = t_g;
  p.M = n_img * t_g;
  p.N = N;
  p.K = K;
  dim3 grid((N + GEMM_BN - 1) / GEMM_BN, (p.M + GEMM_BM - 1) / GEMM_BM);
  gemm_kernel<<<grid, 256, GEMM_SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace i2t
