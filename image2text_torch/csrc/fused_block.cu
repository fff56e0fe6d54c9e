// Kernels of the eval encoder blocks for Hopper (sm_90a): counterpart of
// image2text_tpu/ops/fused_block.py::_sparse_block_kernel (the lazy sparse
// block) and ::_block_kernel (the dense block, the same chain on the whole
// stream), as a short sequence of kernels (the TPU kernels' resident 7.6 MB
// of weights do not fit a Hopper block's 227 KB of shared memory):
//
//   ln_gather   LN1 of the selected rows, read through a row-index list
//               (or of every row when the list is null);
//   gemm        C = A·B (+ bias) (+ residual) on wgmma from TMA-fed shared
//               memory tiles (gemm.cuh); the residual is read through a row
//               list and C rows land at an offset, so the lazy layout's
//               [sel; byp] gather and concat cost no separate pass;
//   mqa_attention  multi-query attention with the heads folded into the
//               rows: one shared K/V head, scores rounded to bf16 before an
//               exact f32 softmax, probabilities in bf16 before the V
//               product: an image's K/V resident in shared memory while
//               they fit (t <= 432 at head dims up to 128), else staged
//               ATTN_KT keys at a time (any t; head dim 256 always).
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
  if (I2T_LN == 1) {
    for (int c = lane * 8; c < d; c += 256)
      *reinterpret_cast<Bf16x8*>(out + (size_t)m * d + c) = *reinterpret_cast<const Bf16x8*>(src + c);
    return;
  }
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
// What bounds it: operations, and before the redesign the bytes it re-read:
// 4·b·n_head·t²·hd FLOP (27 GFLOP at b 256, t 160: 0.03 ms at the bf16
// peak).  With one shared K/V head the n_head·t query rows of an image all
// meet the same K and V (the JAX sdpa head fold), so a block stages one
// image's K (row-major) and Vᵀ in shared memory once and its 16 warps run
// 16 folded query rows at a time through mma.sync m16n8k16, Q fragments
// straight from device memory, K and Vᵀ fragments by ldmatrix.  The
// softmax is exact, as the plain version's: pass 1 runs Q·Kᵀ over every
// key for the row max and sum (the sum rescaled as the max grows: only its
// f32 order differs), pass 2 runs Q·Kᵀ again, p = bf16(exp(s - max) / sum)
// in registers, and P·V.  Scores never leave registers (keeping pass 1's
// in registers for pass 2 spilled at the 128 registers a 16-warp block
// allows, and ran slower).  Shared memory: tp (t rounded up to 16) rows of
// K at hd + 8 bf16 and hd rows of Vᵀ at tp + 8, (tp·(hd + 8) + hd·(tp +
// 8))·2 bytes: 86.5 KB at t 160, 171 KB at t 320; within a block's 227 KB
// (232,448 bytes) up to tp 432 at hd 128.  Registers (at most 128 a
// thread) allow one 16-warp block an SM.
struct AttnArgs {
  const bf16* qkv;  // (b·t, ldq) rows [q (n_head·hd) | k (hd) | v (hd)]
  bf16* o;          // (b·t, n_head·hd)
  int t, tp, n_head, d, ldq;
  float scale;
};

constexpr int ATTN_WARPS = 16;  // 512 threads at <= 128 registers: one block an SM

__host__ __device__ constexpr size_t attn_smem_bytes(int tp, int hd) {
  return ((size_t)tp * (hd + 8) + (size_t)hd * (tp + 8)) * 2;
}

template <int HD>
__global__ void __launch_bounds__(ATTN_WARPS * 32, 1) mqa_attention_kernel(AttnArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LDK = HD + 8;
  const int t = p.t, tp = p.tp, ldv = tp + 8, img = blockIdx.y;
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sVt = sK + (size_t)tp * LDK;
  const bf16* base = p.qkv + (size_t)img * t * p.ldq;

  // stage K (rows t..tp zero) and Vᵀ (columns t..tp zero)
  for (int i = threadIdx.x; i < tp * (HD / 8); i += blockDim.x) {
    const int key = i / (HD / 8), c = (i % (HD / 8)) * 8;
    Bf16x8 kv, vv;
    if (key < t) {
      kv = *reinterpret_cast<const Bf16x8*>(base + (size_t)key * p.ldq + p.d + c);
      vv = *reinterpret_cast<const Bf16x8*>(base + (size_t)key * p.ldq + p.d + HD + c);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) kv.v[e] = vv.v[e] = to_bf(0.f);
    }
    *reinterpret_cast<Bf16x8*>(sK + key * LDK + c) = kv;
#pragma unroll
    for (int e = 0; e < 8; ++e) sVt[(c + e) * ldv + key] = vv.v[e];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q4 = lane % 4;
  const int rows = p.n_head * t, tiles = (rows + 15) / 16;
  for (int tile = blockIdx.x * ATTN_WARPS + warp; tile < tiles; tile += gridDim.x * ATTN_WARPS) {
    // folded rows r = h·t + i of this tile: thread rows g and g + 8
    int hh[2], ii[2];
    bool ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = tile * 16 + g + 8 * h;
      ok[h] = r < rows;
      hh[h] = ok[h] ? r / t : 0;
      ii[h] = ok[h] ? r % t : 0;
    }
    uint32_t qa[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int h = u & 1, col = kk * 16 + 2 * q4 + (u >> 1) * 8;
        qa[kk][u] = ok[h] ? *reinterpret_cast<const uint32_t*>(
                                base + (size_t)ii[h] * p.ldq + hh[h] * HD + col)
                          : 0u;
      }
    }
    // S for key tile j (8 keys): c0, c1 row g keys 8j + 2q4 (+1); c2, c3 row g + 8
    // S for key tiles j and j + 1 (8 keys each): c0, c1 row g keys 8j + 2q4
    // (+1); c2, c3 row g + 8.  One ldmatrix.x4 gives both tiles' K
    // fragments (K rows are the B operand's columns) for a k16 step.
    const int lrow = (lane % 8) + (lane / 16) * 8, lcol = ((lane / 8) % 2) * 8;
    auto scores2 = [&](int j, float (&s0)[4], float (&s1)[4]) {
#pragma unroll
      for (int u = 0; u < 4; ++u) s0[u] = s1[u] = 0.f;
      const bf16* kr = sK + (j * 8 + lrow) * LDK + lcol;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t b[4];
        ldsm_x4(b, kr + kk * 16);
        mma16816(s0, qa[kk], b[0], b[1]);
        mma16816(s1, qa[kk], b[2], b[3]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float v0 = s0[u] * p.scale, v1 = s1[u] * p.scale;
        s0[u] = I2T_SOFTMAX == 1 ? v0 * 0.01f : rbf(v0);
        s1[u] = I2T_SOFTMAX == 1 ? v1 * 0.01f : rbf(v1);
      }
    };
    auto ex = [](float x) {
      return I2T_SOFTMAX == 2 ? exp2f(x * 1.4426950408889634f) : expf(x);
    };
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
    auto stats = [&](int j, const float (&sc)[4]) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int h = u >> 1;
        if (j * 8 + 2 * q4 + (u & 1) >= t) continue;
        const float v = sc[u];
        if (v > mx[h]) {
          sum[h] = sum[h] * ex(mx[h] - v);
          mx[h] = v;
        }
        sum[h] += ex(v - mx[h]);
      }
    };
    if (I2T_SOFTMAX != 1) {
      // two key tiles at a time: two independent product chains
      for (int j = 0; j < tp / 8; j += 2) {
        float sc[2][4];
        scores2(j, sc[0], sc[1]);
        stats(j, sc[0]);
        stats(j + 1, sc[1]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          const float m2 = __shfl_xor_sync(0xffffffffu, mx[h], o);
          const float s2 = __shfl_xor_sync(0xffffffffu, sum[h], o);
          const float m = fmaxf(mx[h], m2);
          sum[h] = (mx[h] == -INFINITY ? 0.f : sum[h] * ex(mx[h] - m)) +
                   (m2 == -INFINITY ? 0.f : s2 * ex(m2 - m));
          mx[h] = m;
        }
      }
    }
    float acc[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int kc = 0; kc < tp / 16; ++kc) {
      float s0[4], s1[4];
      scores2(2 * kc, s0, s1);
      float pr[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float s = u < 4 ? s0[u] : s1[u - 4];
        const int key = kc * 16 + (u >> 2) * 8 + 2 * q4 + (u & 1), h = (u >> 1) & 1;
        pr[u] = I2T_SOFTMAX == 1 ? (key < t ? s : 0.f)
                                 : (key < t ? ex(s - mx[h]) / sum[h] : 0.f);
      }
      const uint32_t pa[4] = {pack_bf2(pr[0], pr[1]), pack_bf2(pr[2], pr[3]),
                              pack_bf2(pr[4], pr[5]), pack_bf2(pr[6], pr[7])};
      // Vᵀ rows are the B operand's columns: one ldmatrix.x4, two dim tiles
      const bf16* vr = sVt + lrow * ldv + kc * 16 + lcol;
#pragma unroll
      for (int j = 0; j < HD / 8; j += 2) {
        uint32_t b[4];
        ldsm_x4(b, vr + j * 8 * ldv);
        mma16816(acc[j], pa, b[0], b[1]);
        mma16816(acc[j + 1], pa, b[2], b[3]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!ok[h]) continue;
      bf16* orow = p.o + ((size_t)img * t + ii[h]) * p.d + hh[h] * HD + 2 * q4;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + j * 8) = pack_bf2(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
}

// ------------------------------------------------- MQA attention, K/V tiled
// Past the resident kernel's shared memory (t > 432 at hd <= 128) and at hd
// 256 (JAX's chain takes any hd % 128 == 0): the same folded-row warps and
// the same exact two-pass softmax, with K and Vᵀ staged ATTN_KT keys at a
// time.  Pass 1 walks the key tiles for each row's running max and sum
// (the resident kernel's online rescale, over the keys in the same order,
// so the two agree bit for bit where both run); pass 2 walks them again
// for p = bf16(exp(s - max) / sum) and P·V.  A block's WARPS warps take
// WARPS consecutive 16-row query tiles and stage every key tile together:
// one block barrier per tile.  Simple, not fast: a row's scores are
// computed twice and K is staged twice.  Shared memory (ATTN_KT·(hd + 8)
// + hd·(ATTN_KT + 8))·2 bytes: 35,840 at hd 128, 70,656 at hd 256; hd 256
// runs 8 warps a block for the registers of Q and the accumulators.
constexpr int ATTN_KT = 64;

__host__ __device__ constexpr size_t attn_tiled_smem_bytes(int hd) {
  return ((size_t)ATTN_KT * (hd + 8) + (size_t)hd * (ATTN_KT + 8)) * 2;
}

template <int HD, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, 1) mqa_attention_tiled_kernel(AttnArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LDK = HD + 8, LDV = ATTN_KT + 8;
  const int t = p.t, img = blockIdx.y;
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sVt = sK + (size_t)ATTN_KT * LDK;
  const bf16* base = p.qkv + (size_t)img * t * p.ldq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q4 = lane % 4;
  const int rows = p.n_head * t, tiles = (rows + 15) / 16;
  const int nkt = (t + ATTN_KT - 1) / ATTN_KT;
  const int lrow = (lane % 8) + (lane / 16) * 8, lcol = ((lane / 8) % 2) * 8;

  // keys [k0, k0 + ATTN_KT): K rows and, with want_v, Vᵀ columns (zeros past t)
  auto stage = [&](int k0, bool want_v) {
    for (int i = threadIdx.x; i < ATTN_KT * (HD / 8); i += blockDim.x) {
      const int kl = i / (HD / 8), c = (i % (HD / 8)) * 8, key = k0 + kl;
      Bf16x8 kv, vv;
      if (key < t) {
        kv = *reinterpret_cast<const Bf16x8*>(base + (size_t)key * p.ldq + p.d + c);
        if (want_v)
          vv = *reinterpret_cast<const Bf16x8*>(base + (size_t)key * p.ldq + p.d + HD + c);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kv.v[e] = vv.v[e] = to_bf(0.f);
      }
      *reinterpret_cast<Bf16x8*>(sK + kl * LDK + c) = kv;
      if (want_v) {
#pragma unroll
        for (int e = 0; e < 8; ++e) sVt[(c + e) * LDV + kl] = vv.v[e];
      }
    }
  };

  for (int t0 = blockIdx.x * WARPS; t0 < tiles; t0 += gridDim.x * WARPS) {
    const int tile = t0 + warp;
    const bool active = tile < tiles;
    int hh[2], ii[2];
    bool ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = tile * 16 + g + 8 * h;
      ok[h] = active && r < rows;
      hh[h] = ok[h] ? r / t : 0;
      ii[h] = ok[h] ? r % t : 0;
    }
    uint32_t qa[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int h = u & 1, col = kk * 16 + 2 * q4 + (u >> 1) * 8;
        qa[kk][u] = ok[h] ? *reinterpret_cast<const uint32_t*>(
                                base + (size_t)ii[h] * p.ldq + hh[h] * HD + col)
                          : 0u;
      }
    }
    // S for the staged tile's 8-key groups j and j + 1
    auto scores2 = [&](int j, float (&s0)[4], float (&s1)[4]) {
#pragma unroll
      for (int u = 0; u < 4; ++u) s0[u] = s1[u] = 0.f;
      const bf16* kr = sK + (j * 8 + lrow) * LDK + lcol;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t b[4];
        ldsm_x4(b, kr + kk * 16);
        mma16816(s0, qa[kk], b[0], b[1]);
        mma16816(s1, qa[kk], b[2], b[3]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        s0[u] = rbf(s0[u] * p.scale);
        s1[u] = rbf(s1[u] * p.scale);
      }
    };
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
    auto stats = [&](int key0, const float (&sc)[4]) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int h = u >> 1;
        if (key0 + 2 * q4 + (u & 1) >= t) continue;
        const float v = sc[u];
        if (v > mx[h]) {
          sum[h] = sum[h] * expf(mx[h] - v);
          mx[h] = v;
        }
        sum[h] += expf(v - mx[h]);
      }
    };
    for (int kt = 0; kt < nkt; ++kt) {
      __syncthreads();
      stage(kt * ATTN_KT, false);
      __syncthreads();
      if (!active) continue;
      for (int j = 0; j < ATTN_KT / 8; j += 2) {
        float sc[2][4];
        scores2(j, sc[0], sc[1]);
        stats(kt * ATTN_KT + j * 8, sc[0]);
        stats(kt * ATTN_KT + (j + 1) * 8, sc[1]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, mx[h], o);
        const float s2 = __shfl_xor_sync(0xffffffffu, sum[h], o);
        const float m = fmaxf(mx[h], m2);
        sum[h] = (mx[h] == -INFINITY ? 0.f : sum[h] * expf(mx[h] - m)) +
                 (m2 == -INFINITY ? 0.f : s2 * expf(m2 - m));
        mx[h] = m;
      }
    }
    float acc[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int kt = 0; kt < nkt; ++kt) {
      __syncthreads();
      stage(kt * ATTN_KT, true);
      __syncthreads();
      if (!active) continue;
      for (int kc = 0; kc < ATTN_KT / 16; ++kc) {
        float s0[4], s1[4];
        scores2(2 * kc, s0, s1);
        float pr[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float s = u < 4 ? s0[u] : s1[u - 4];
          const int key = kt * ATTN_KT + kc * 16 + (u >> 2) * 8 + 2 * q4 + (u & 1);
          const int h = (u >> 1) & 1;
          pr[u] = key < t ? expf(s - mx[h]) / sum[h] : 0.f;
        }
        const uint32_t pa[4] = {pack_bf2(pr[0], pr[1]), pack_bf2(pr[2], pr[3]),
                                pack_bf2(pr[4], pr[5]), pack_bf2(pr[6], pr[7])};
        const bf16* vr = sVt + lrow * LDV + kc * 16 + lcol;
#pragma unroll
        for (int j = 0; j < HD / 8; j += 2) {
          uint32_t b[4];
          ldsm_x4(b, vr + j * 8 * LDV);
          mma16816(acc[j], pa, b[0], b[1]);
          mma16816(acc[j + 1], pa, b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!ok[h]) continue;
      bf16* orow = p.o + ((size_t)img * t + ii[h]) * p.d + hh[h] * HD + 2 * q4;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + j * 8) = pack_bf2(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
}

template <int HD, int WARPS>
cudaError_t launch_attn_tiled(const AttnArgs& p, dim3 grid, cudaStream_t st) {
  const size_t smem = attn_tiled_smem_bytes(HD);
  const cudaError_t err = cudaFuncSetAttribute(mqa_attention_tiled_kernel<HD, WARPS>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
  if (err != cudaSuccess) return err;
  mqa_attention_tiled_kernel<HD, WARPS><<<grid, WARPS * 32, smem, st>>>(p);
  return cudaSuccess;
}

template <int HD>
cudaError_t launch_attn(const AttnArgs& p, dim3 grid, size_t smem, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      mqa_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mqa_attention_kernel<HD><<<grid, ATTN_WARPS * 32, smem, st>>>(p);
  return cudaSuccess;
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

extern "C" int gemm_launch(const void* A, const void* a_rows, int a_T, void* a_scratch,
                           const void* B, const void* bias, const void* R, const void* r_rows,
                           int r_T, void* C, int c_T, int c_off, int n_img, int t_g, int N, int K,
                           void* stream) {
  return launch_gemm(A, a_rows, a_T, a_scratch, B, bias, R, r_rows, r_T, C, c_T, c_off, n_img,
                     t_g, N, K, static_cast<cudaStream_t>(stream));
}

// qkv (b·t, n_head·hd + 2·hd) → o (b·t, n_head·hd); ``blocks_per_img``
// blocks share each image's folded rows; ``tiled`` takes the K/V-tiled
// kernel (the host's ops/fused_block.py::attn_route).
extern "C" int mqa_attention_launch(const void* qkv, void* o, int b, int t, int n_head, int hd,
                                    float scale, int blocks_per_img, int tiled, void* stream) {
  if (b <= 0 || t <= 0 || n_head <= 0 || blocks_per_img <= 0) return (int)cudaErrorInvalidValue;
  AttnArgs p;
  p.qkv = static_cast<const bf16*>(qkv);
  p.o = static_cast<bf16*>(o);
  p.t = t;
  p.tp = (t + 15) / 16 * 16;
  p.n_head = n_head;
  p.d = n_head * hd;
  p.ldq = p.d + 2 * hd;
  p.scale = scale;
  dim3 grid(blocks_per_img, b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (tiled) {
    switch (hd) {
      case 16: err = launch_attn_tiled<16, ATTN_WARPS>(p, grid, st); break;
      case 32: err = launch_attn_tiled<32, ATTN_WARPS>(p, grid, st); break;
      case 64: err = launch_attn_tiled<64, ATTN_WARPS>(p, grid, st); break;
      case 128: err = launch_attn_tiled<128, ATTN_WARPS>(p, grid, st); break;
      case 256: err = launch_attn_tiled<256, 8>(p, grid, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  const size_t smem = attn_smem_bytes(p.tp, hd);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  switch (hd) {
#define I2T_ATTN(HD)                                                                        \
  case HD:                                                                                  \
    err = launch_attn<HD>(p, grid, smem, st);                                               \
    break;
    I2T_ATTN(16)
    I2T_ATTN(32)
    I2T_ATTN(64)
    I2T_ATTN(128)
#undef I2T_ATTN
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
