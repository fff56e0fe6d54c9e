// Flash attention for training on Hopper (sm_90a): counterparts of
// image2text_tpu/ops/flash_attention.py::_fwd_kernel, ::_bwd_dkv_kernel and
// ::_bwd_dq_kernel.
//
// Forward: O = softmax(q·kᵀ·scale + clamp(bias, NEG_BIG) [causal]) · V with
// the online softmax of FlashAttention-2; the per-row lse is saved.  The
// denominator sums the probabilities before dropout; the dropped, rescaled
// probabilities are rounded to bf16 for the V product.  Backward from lse
// and D = rowsum(dO ∘ O): dS = p ∘ (keep·dP/(1 − rate) − D), dV = p̃ᵀ dO,
// dK = dSᵀ q · scale, dQ = dS k · scale.  Dropout is the murmur3 counter
// hash of (row, col, plane = batch·h + head, seed), bit for bit the JAX
// package's dropout_keep_mask, so the backward regenerates the mask.
//
// What bounds it on the H100: bytes at the training shapes.  At batch 48,
// 8 heads, s = 160, d = 128 a forward reads and writes about 36 MB
// (0.011 ms at 3.35 TB/s) for 5 GFLOP (0.005 ms at the bf16 peak); the
// backward about twice both.  Scores never reach device memory.
//
// Design, correct and simple first: a thread block of four warps owns a
// 64-row tile, each warp 16 rows, and loops over 64-row tiles of the other
// side held in shared memory; every product is a WMMA bf16 tensor-core
// product with f32 accumulators.  Score tiles go through shared memory in
// f32 so that plain threads apply bias, masks, softmax and dropout with
// known row/column coordinates; the forward's O accumulator lives in
// shared memory too (its rows are rescaled by the online softmax).
// - forward: one block per (batch·head, q tile); K/V of a multi-query
//   call are indexed by batch only, so each image's K/V are read by its
//   h heads' blocks through L2.
// - dK/dV: one block per (K/V plane, kv tile).  For multi-query K/V the
//   block loops over all h query heads and all q tiles, so the head
//   reduction stays in f32 registers (no (b·h, skv, d) f32 outputs and no
//   separate sum as on the TPU).
// - dQ: one block per (batch·head, q tile) looping over kv tiles.
// No atomics: every output element is written by one block, so results
// are deterministic.  Causal calls without a bias skip the tiles above the
// diagonal band.  Key columns past skv take no part (p = 0); query rows
// past sq are computed on zeros and not written.  A row that sees no key at
// all gets the uniform average over all skv keys (its scores are all
// NEG_BIG), so a q tile holding a row that the causal offset leaves without
// keys (sq > skv) visits every kv tile, and so does every q tile of a
// causal call with a bias, which may mask a whole row (the decoder's calls;
// at lengths 129 to 142 that is 9 (q tile, kv tile) pairs against 6).
#include "common.cuh"

using namespace i2t;

namespace {

constexpr int BQ = 64, BK = 64, THREADS = 128;
constexpr int SLD = BK + 4;  // f32 score tile row stride
constexpr int PLD = BK + 8;  // bf16 probability tile row stride
constexpr float NEG_BIG = -0.7f * 3.40282346638528859811704183484516925e38f;

using FragAT = wmma::fragment<wmma::matrix_a, TM, TN, TK, bf16, wmma::col_major>;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* bias;
  long long bsb, bsh, bsr;  // bias strides of batch, head, query (0: broadcast)
  const bf16* dout;
  const float* lse;
  const float* dvec;
  bf16* o;
  float* lse_out;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int b, h, hk, sq, skv;
  int causal;
  float scale;
  int dropout;
  unsigned seed, threshold;
  float inv_keep;
};

__device__ __forceinline__ float keep_scale(const Params& p, int row, int col, int plane) {
  unsigned x = (unsigned)row * 0x9E3779B1u ^ (unsigned)col * 0x85EBCA77u ^
               (unsigned)plane * 0xC2B2AE3Du ^ p.seed;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x < p.threshold ? p.inv_keep : 0.f;
}

// Rows [r0, r0 + 64) of a (rows, D) bf16 matrix into shared memory (row
// stride ld), zeros past ``rows``.
template <int D>
__device__ void load_tile(bf16* dst, int ld, const bf16* src, int r0, int rows) {
  constexpr int VPR = D / 8;
  for (int i = threadIdx.x; i < 64 * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    Bf16x8 val;
    if (r0 + r < rows) {
      val = *reinterpret_cast<const Bf16x8*>(src + (size_t)(r0 + r) * D + c);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) val.v[j] = to_bf(0.f);
    }
    *reinterpret_cast<Bf16x8*>(dst + r * ld + c) = val;
  }
}

// One warp: S (16 x 64, f32, row stride SLD) = A (16 x D) · Bᵀ, B (64 x D).
template <int D>
__device__ void warp_abt(const bf16* A, const bf16* B, int ld, float* S) {
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) {
    FragC c;
    wmma::fill_fragment(c, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA a;
      FragBT bt;
      wmma::load_matrix_sync(a, A + kk * 16, ld);
      wmma::load_matrix_sync(bt, B + n * 16 * ld + kk * 16, ld);
      wmma::mma_sync(c, a, bt, c);
    }
    wmma::store_matrix_sync(S + n * 16, c, SLD, wmma::mem_row_major);
  }
}

// The masked, scaled score of (row, col); -inf for a column past skv.
__device__ __forceinline__ float score(const Params& p, const float* bias, float s, int row,
                                       int col) {
  if (col >= p.skv) return -INFINITY;
  s *= p.scale;
  if (bias != nullptr && row < p.sq) s += fmaxf(bias[row * p.bsr + col], NEG_BIG);
  if (p.causal && col > row + p.skv - p.sq) s = NEG_BIG;
  return s;
}

// Last kv tile a q tile starting at q0 needs: under ``causal`` without a
// bias the band of its last row, else all of them (a row the bias or the
// causal offset leaves without keys averages over every key).
__device__ __forceinline__ int last_kv_tile(const Params& p, int q0) {
  const int last = (p.skv + BK - 1) / BK - 1;
  if (!p.causal || p.bias != nullptr || q0 + p.skv - p.sq < 0) return last;
  return min(last, (q0 + BQ - 1 + p.skv - p.sq) / BK);
}

template <int D>
struct FwdSmem {
  static constexpr int LD = D + 8, OLD = D + 4;
  static constexpr size_t bytes = 3 * 64 * LD * sizeof(bf16) + BQ * SLD * sizeof(float) +
                                  BQ * PLD * sizeof(bf16) + BQ * OLD * sizeof(float) +
                                  2 * BQ * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Params p) {
  using L = FwdSmem<D>;
  constexpr int LD = L::LD, OLD = L::OLD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * LD;
  bf16* Vs = Ks + BK * LD;
  float* S = reinterpret_cast<float*>(Vs + BK * LD);
  bf16* P = reinterpret_cast<bf16*>(S + BQ * SLD);
  float* O = reinterpret_cast<float*>(P + BQ * PLD);
  float* M = O + BQ * OLD;
  float* Lsum = M + BQ;

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int bi = bh / p.h, hi = bh % p.h, kvp = p.hk == 1 ? bi : bh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* kp = p.k + (size_t)kvp * p.skv * D;
  const bf16* vp = p.v + (size_t)kvp * p.skv * D;
  const float* bias = p.bias ? p.bias + bi * p.bsb + hi * p.bsh : nullptr;

  load_tile<D>(Qs, LD, p.q + (size_t)bh * p.sq * D, q0, p.sq);
  for (int i = threadIdx.x; i < BQ * OLD; i += THREADS) O[i] = 0.f;
  if (threadIdx.x < BQ) {
    M[threadIdx.x] = -INFINITY;
    Lsum[threadIdx.x] = 0.f;
  }
  float* Sw = S + warp * 16 * SLD;
  const int last = last_kv_tile(p, q0);
  for (int j = 0; j <= last; ++j) {
    const int k0 = j * BK;
    __syncthreads();
    load_tile<D>(Ks, LD, kp, k0, p.skv);
    load_tile<D>(Vs, LD, vp, k0, p.skv);
    __syncthreads();
    warp_abt<D>(Qs + warp * 16 * LD, Ks, LD, Sw);
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      const int lr = warp * 16 + r, row = q0 + lr;
      const float s0 = score(p, bias, Sw[r * SLD + lane], row, k0 + lane);
      const float s1 = score(p, bias, Sw[r * SLD + lane + 32], row, k0 + lane + 32);
      const float m_prev = M[lr];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float m_safe = fmaxf(m_new, NEG_BIG);
      const float alpha = expf(fmaxf(m_prev, NEG_BIG) - m_safe);
      float p0 = expf(s0 - m_safe), p1 = expf(s1 - m_safe);
      const float psum = warp_sum(p0 + p1);
      if (p.dropout) {
        p0 *= keep_scale(p, row, k0 + lane, bh);
        p1 *= keep_scale(p, row, k0 + lane + 32, bh);
      }
      P[lr * PLD + lane] = to_bf(p0);
      P[lr * PLD + lane + 32] = to_bf(p1);
      for (int c = lane; c < D; c += 32) O[lr * OLD + c] *= alpha;
      __syncwarp();
      if (lane == 0) {
        M[lr] = m_new;
        Lsum[lr] = alpha * Lsum[lr] + psum;
      }
    }
    __syncwarp();
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      FragC c;
      wmma::load_matrix_sync(c, O + warp * 16 * OLD + n * 16, OLD, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        FragA a;
        FragB bb;
        wmma::load_matrix_sync(a, P + warp * 16 * PLD + kk * 16, PLD);
        wmma::load_matrix_sync(bb, Vs + kk * 16 * LD + n * 16, LD);
        wmma::mma_sync(c, a, bb, c);
      }
      wmma::store_matrix_sync(O + warp * 16 * OLD + n * 16, c, OLD, wmma::mem_row_major);
    }
  }
  __syncwarp();
  for (int r = 0; r < 16; ++r) {
    const int lr = warp * 16 + r, row = q0 + lr;
    if (row >= p.sq) break;
    const float l = fmaxf(Lsum[lr], 1e-30f);
    bf16* orow = p.o + ((size_t)bh * p.sq + row) * D;
    for (int c = lane; c < D; c += 32) orow[c] = to_bf(O[lr * OLD + c] / l);
    if (lane == 0) p.lse_out[(size_t)bh * p.sq + row] = fmaxf(M[lr], NEG_BIG) + logf(l);
  }
}

// Shared memory of both backward kernels: four bf16 tiles (Q, dO, K, V),
// the f32 score and dP tiles, the bf16 p̃ and dS tiles, lse and D.
template <int D>
struct BwdSmem {
  static constexpr int LD = D + 8;
  static constexpr size_t bytes = 4 * 64 * LD * sizeof(bf16) + 2 * BQ * SLD * sizeof(float) +
                                  2 * BQ * PLD * sizeof(bf16) + 2 * BQ * sizeof(float);
  // the f32 staging of a warp's 16 x D output fits in the score tiles
  static_assert(4 * 16 * (D + 4) <= 2 * BQ * SLD, "staging must fit the score tiles");
};

struct BwdTiles {
  bf16 *Qs, *dOs, *Ks, *Vs, *Pt, *dS;
  float *S, *dP, *lse, *dvec;
};

template <int D>
__device__ BwdTiles bwd_tiles(unsigned char* smem) {
  constexpr int LD = BwdSmem<D>::LD;
  BwdTiles t;
  t.Qs = reinterpret_cast<bf16*>(smem);
  t.dOs = t.Qs + 64 * LD;
  t.Ks = t.dOs + 64 * LD;
  t.Vs = t.Ks + 64 * LD;
  t.S = reinterpret_cast<float*>(t.Vs + 64 * LD);
  t.dP = t.S + BQ * SLD;
  t.Pt = reinterpret_cast<bf16*>(t.dP + BQ * SLD);
  t.dS = t.Pt + BQ * PLD;
  t.lse = reinterpret_cast<float*>(t.dS + BQ * PLD);
  t.dvec = t.lse + BQ;
  return t;
}

// Q, dO, lse and D of rows [q0, q0 + 64) of plane bh.
template <int D>
__device__ void load_q_side(const Params& p, const BwdTiles& t, int bh, int q0) {
  constexpr int LD = BwdSmem<D>::LD;
  load_tile<D>(t.Qs, LD, p.q + (size_t)bh * p.sq * D, q0, p.sq);
  load_tile<D>(t.dOs, LD, p.dout + (size_t)bh * p.sq * D, q0, p.sq);
  if (threadIdx.x < BQ) {
    const int row = q0 + threadIdx.x;
    const bool in = row < p.sq;
    t.lse[threadIdx.x] = in ? p.lse[(size_t)bh * p.sq + row] : 0.f;
    t.dvec[threadIdx.x] = in ? p.dvec[(size_t)bh * p.sq + row] : 0.f;
  }
}

// One warp: its 16 q rows of p̃ and dS (bf16) for the tile (q0, k0).
template <int D>
__device__ void warp_p_ds(const Params& p, const BwdTiles& t, const float* bias, int bh,
                          int q0, int k0, bool want_p) {
  constexpr int LD = BwdSmem<D>::LD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* Sw = t.S + warp * 16 * SLD;
  float* dPw = t.dP + warp * 16 * SLD;
  warp_abt<D>(t.Qs + warp * 16 * LD, t.Ks, LD, Sw);
  warp_abt<D>(t.dOs + warp * 16 * LD, t.Vs, LD, dPw);
  __syncwarp();
  for (int r = 0; r < 16; ++r) {
    const int lr = warp * 16 + r, row = q0 + lr;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = lane + 32 * half, col = k0 + c;
      const float s = score(p, bias, Sw[r * SLD + c], row, col);
      float pr = row < p.sq ? expf(s - t.lse[lr]) : 0.f;
      float dp = dPw[r * SLD + c];
      if (p.dropout) {
        const float ks = keep_scale(p, row, col, bh);
        dp *= ks;
        if (want_p) t.Pt[lr * PLD + c] = to_bf(pr * ks);
      } else if (want_p) {
        t.Pt[lr * PLD + c] = to_bf(pr);
      }
      t.dS[lr * PLD + c] = to_bf(pr * (dp - t.dvec[lr]));
    }
  }
}

// Write a warp's 16 x D f32 accumulators, times ``mul``, as bf16 rows
// [r0, r0 + 16) of dst (row count ``rows``), staged through ``stage``.
template <int D>
__device__ void store_rows(FragC (&acc)[D / 16], float mul, float* stage, bf16* dst, int r0,
                           int rows) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
#pragma unroll
    for (int i = 0; i < acc[n].num_elements; ++i) acc[n].x[i] *= mul;
    wmma::store_matrix_sync(stage + n * 16, acc[n], D + 4, wmma::mem_row_major);
  }
  __syncwarp();
  for (int r = 0; r < 16 && r0 + r < rows; ++r)
    for (int c = lane; c < D; c += 32) dst[(size_t)(r0 + r) * D + c] = to_bf(stage[r * (D + 4) + c]);
  __syncwarp();
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(Params p) {
  constexpr int LD = BwdSmem<D>::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdTiles t = bwd_tiles<D>(smem);
  const int kvp = blockIdx.y, k0 = blockIdx.x * BK;
  const int warp = threadIdx.x / 32;
  const int bi = p.hk == 1 ? kvp : kvp / p.h;
  const int h0 = p.hk == 1 ? 0 : kvp % p.h, h1 = p.hk == 1 ? p.h : h0 + 1;
  load_tile<D>(t.Ks, LD, p.k + (size_t)kvp * p.skv * D, k0, p.skv);
  load_tile<D>(t.Vs, LD, p.v + (size_t)kvp * p.skv * D, k0, p.skv);
  FragC dk[D / 16], dv[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dk[n], 0.f);
    wmma::fill_fragment(dv[n], 0.f);
  }
  // q tiles whose last row precedes this kv tile's first column see none of
  // it, unless rows that see no key at all (a bias, or causal with sq >
  // skv) spread their uniform weights over every column
  int i0 = 0;
  if (p.causal && p.bias == nullptr && p.sq <= p.skv) {
    const int first_row = k0 - (p.skv - p.sq);
    i0 = first_row <= 0 ? 0 : first_row / BQ;
  }
  const int nq = (p.sq + BQ - 1) / BQ;
  for (int hi = h0; hi < h1; ++hi) {
    const int bh = bi * p.h + hi;
    const float* bias = p.bias ? p.bias + bi * p.bsb + hi * p.bsh : nullptr;
    for (int i = i0; i < nq; ++i) {
      const int q0 = i * BQ;
      __syncthreads();
      load_q_side<D>(p, t, bh, q0);
      __syncthreads();
      warp_p_ds<D>(p, t, bias, bh, q0, k0, true);
      __syncthreads();
      // this warp's 16 kv rows: dV += p̃ᵀ dO, dK += dSᵀ Q
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        FragAT pt, dst;
        wmma::load_matrix_sync(pt, t.Pt + kk * 16 * PLD + warp * 16, PLD);
        wmma::load_matrix_sync(dst, t.dS + kk * 16 * PLD + warp * 16, PLD);
#pragma unroll
        for (int n = 0; n < D / 16; ++n) {
          FragB dob, qb;
          wmma::load_matrix_sync(dob, t.dOs + kk * 16 * LD + n * 16, LD);
          wmma::mma_sync(dv[n], pt, dob, dv[n]);
          wmma::load_matrix_sync(qb, t.Qs + kk * 16 * LD + n * 16, LD);
          wmma::mma_sync(dk[n], dst, qb, dk[n]);
        }
      }
    }
  }
  __syncthreads();
  float* stage = t.S + warp * 16 * (D + 4);
  store_rows<D>(dk, p.scale, stage, p.dk + (size_t)kvp * p.skv * D, k0 + warp * 16, p.skv);
  store_rows<D>(dv, 1.f, stage, p.dv + (size_t)kvp * p.skv * D, k0 + warp * 16, p.skv);
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(Params p) {
  constexpr int LD = BwdSmem<D>::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdTiles t = bwd_tiles<D>(smem);
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int bi = bh / p.h, hi = bh % p.h, kvp = p.hk == 1 ? bi : bh;
  const int warp = threadIdx.x / 32;
  const float* bias = p.bias ? p.bias + bi * p.bsb + hi * p.bsh : nullptr;
  load_q_side<D>(p, t, bh, q0);
  FragC dq[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(dq[n], 0.f);
  const int last = last_kv_tile(p, q0);
  for (int j = 0; j <= last; ++j) {
    const int k0 = j * BK;
    __syncthreads();
    load_tile<D>(t.Ks, LD, p.k + (size_t)kvp * p.skv * D, k0, p.skv);
    load_tile<D>(t.Vs, LD, p.v + (size_t)kvp * p.skv * D, k0, p.skv);
    __syncthreads();
    warp_p_ds<D>(p, t, bias, bh, q0, k0, false);
    __syncwarp();
    // this warp's 16 q rows: dQ += dS K
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      FragA a;
      wmma::load_matrix_sync(a, t.dS + warp * 16 * PLD + kk * 16, PLD);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        FragB kb;
        wmma::load_matrix_sync(kb, t.Ks + kk * 16 * LD + n * 16, LD);
        wmma::mma_sync(dq[n], a, kb, dq[n]);
      }
    }
  }
  __syncthreads();
  store_rows<D>(dq, p.scale, t.S + warp * 16 * (D + 4), p.dq + (size_t)bh * p.sq * D,
                q0 + warp * 16, p.sq);
}

Params make_params(const void* q, const void* k, const void* v, const void* bias,
                   long long bsb, long long bsh, long long bsr, int b, int h, int hk, int sq,
                   int skv, int causal, float scale, int dropout, unsigned seed,
                   unsigned threshold, float inv_keep) {
  Params p = {};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.bias = static_cast<const float*>(bias);
  p.bsb = bsb;
  p.bsh = bsh;
  p.bsr = bsr;
  p.b = b;
  p.h = h;
  p.hk = hk;
  p.sq = sq;
  p.skv = skv;
  p.causal = causal;
  p.scale = scale;
  p.dropout = dropout;
  p.seed = seed;
  p.threshold = threshold;
  p.inv_keep = inv_keep;
  return p;
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, dim3 grid, const Params& p, void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

bool valid(int b, int h, int hk, int sq, int skv) {
  return b > 0 && h > 0 && sq > 0 && skv > 0 && (hk == 1 || hk == h);
}

}  // namespace

#define I2T_FLASH_ARGS                                                                        \
  const void *bias, long long bsb, long long bsh, long long bsr, int b, int h, int hk, int sq, \
      int skv, int d, int causal, float scale, int dropout, unsigned seed, unsigned threshold, \
      float inv_keep, void *stream
#define I2T_FLASH_PARAMS \
  make_params(q, k, v, bias, bsb, bsh, bsr, b, h, hk, sq, skv, causal, scale, dropout, seed, \
              threshold, inv_keep)
#define I2T_DISPATCH(X) \
  switch (d) {          \
    case 16: X(16);     \
    case 32: X(32);     \
    case 64: X(64);     \
    case 128: X(128);   \
    default: return (int)cudaErrorInvalidValue; \
  }

extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                void* lse, I2T_FLASH_ARGS) {
  if (!valid(b, h, hk, sq, skv)) return (int)cudaErrorInvalidValue;
  Params p = I2T_FLASH_PARAMS;
  p.o = static_cast<bf16*>(o);
  p.lse_out = static_cast<float*>(lse);
  const dim3 grid((sq + BQ - 1) / BQ, b * h);
#define FWD(D) return launch(flash_fwd_kernel<D>, FwdSmem<D>::bytes, grid, p, stream)
  I2T_DISPATCH(FWD)
#undef FWD
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* dvec,
                                    void* dk, void* dv, I2T_FLASH_ARGS) {
  if (!valid(b, h, hk, sq, skv)) return (int)cudaErrorInvalidValue;
  Params p = I2T_FLASH_PARAMS;
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.dvec = static_cast<const float*>(dvec);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  const dim3 grid((skv + BK - 1) / BK, b * hk);
#define DKV(D) return launch(flash_bwd_dkv_kernel<D>, BwdSmem<D>::bytes, grid, p, stream)
  I2T_DISPATCH(DKV)
#undef DKV
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* dvec,
                                   void* dq, I2T_FLASH_ARGS) {
  if (!valid(b, h, hk, sq, skv)) return (int)cudaErrorInvalidValue;
  Params p = I2T_FLASH_PARAMS;
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.dvec = static_cast<const float*>(dvec);
  p.dq = static_cast<bf16*>(dq);
  const dim3 grid((sq + BQ - 1) / BQ, b * h);
#define DQ(D) return launch(flash_bwd_dq_kernel<D>, BwdSmem<D>::bytes, grid, p, stream)
  I2T_DISPATCH(DQ)
#undef DQ
}
