// Flash attention for training on Hopper (sm_90a): counterparts of
// image2text_tpu/ops/flash_attention.py::_fwd_kernel, and of ::_bwd_dkv_kernel
// with ::_bwd_dq_kernel together (one backward).
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
// Forward, K/V resident (skv <= SKV_MAX = 160 keys: every ported training
// shape).  A block of four warps holds a whole K/V plane in shared memory,
// loaded once by cp.async, and its warps walk the 16-row query tiles of the
// plane (multi-query: the h heads' rows folded, as the backward folds
// them), each warp on its own tiles with no block barrier past the K/V
// load: a warp pulls its tile's Q into mma.sync A fragments, then at once
// starts the cp.async of its next tile into the same buffer.  S = Q·Kᵀ
// runs on mma.sync m16n8k16 into registers, the whole row of up to 160
// keys (80 f32 a thread), where every lane knows its (row, col): bias,
// causal mask, the exact softmax (row max and sum over the 4 lanes of a
// quad, p = exp(s − m) against the row's final max, as the plain version
// rounds it) and the dropout hash are applied there; p̃ feeds P̃·V
// straight from the score registers as A fragments and O accumulates in
// registers (64 f32 a thread at d 128, live only once Q's fragments are
// not).  The hash and the bias take the unfolded (head, row) of each
// folded row.  A causal tile stops at its band once every row in it holds
// a max above NEG_BIG / 2 (past the band p = exp(NEG_BIG − m) = 0); a tile
// with a keyless row visits every key.  A plane is split over G blocks (the
// host's ops/flash_attention.py::fwd_plan: as many as two blocks an SM
// allow in one wave; it reads FWD_ROWS, FWD_WARPS, FWD_SLICE and
// FWD_BLOCKS_PER_SM from this file).  Shared memory at d 128, 160 keys:
// K and V 87,040 B, four warps' Q 17,408 B: 104,448 B, two blocks an SM.
//
// Forward, tiled (skv > 160): a thread block of four warps owns a 64-row
// tile, each warp 16 rows, and loops over 64-row K/V tiles held in shared
// memory; WMMA bf16 products with f32 accumulators; score tiles go through
// shared memory in f32 so that plain threads apply bias, masks, softmax and
// dropout; one block per (batch·head, q tile).
//
// Backward, K/V resident (skv <= SKV_MAX = 160 keys: every ported training
// shape).  One block holds a whole K/V plane in shared memory, one warp
// per 16 keys (at most 10 warps), and walks over 32-row query tiles of its
// plane (multi-query: the h heads' rows folded, as the encoder chain's
// attention folds them), each tile loaded by cp.async into a double buffer
// while the previous one computes.  For each (tile, 16-key slice) a warp
// computes Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ once on mma.sync m16n8k16 and keeps
// them in registers, where every lane knows its (key, query) coordinates:
// bias, causal mask, exp(s − lse), the dropout hash and dS are applied
// there, once per element (5 products per pair, not 7: no recompute for
// dQ).  p̃ᵀ and dSᵀ then feed dV += p̃ᵀ·dO and dK += dSᵀ·Q straight from
// the accumulators (the f32 → bf16 A-fragment reuse of FlashAttention-2),
// with dK/dV accumulating in registers over the block's tiles; dSᵀ goes to
// shared memory as bf16 once, and all warps take dQ = dS·K of the tile in
// (16 rows, 16 dims) jobs, written whole: the block sees every key, so no
// dQ partials and no atomics.  A multi-query plane is split over G blocks
// (G from the host: enough blocks for the SMs without a second wave), each
// writing f32 dK/dV partials that a second kernel sums in group order; for
// G = 1 (hk = h: GPT-2) the block writes bf16 dK/dV itself.  Results are
// bitwise deterministic.  Causal calls skip the key slices wholly above the
// band of a tile whose rows all saw a key — decided on the device from the
// saved lse (a row had a visible key exactly when lse > NEG_BIG / 2, and
// then p = exp(NEG_BIG − lse) = 0 above the band), so a soft-prompt bias no
// longer forces every pair; a tile holding a keyless row (it averages over
// every key) visits all slices.  dSᵀ needs one stage: a warp writes it
// for tile t + 1 only after the barrier that every warp reaches once done
// with tile t's dQ, its only reader.  Shared memory at d 128, 160 keys: K
// and V 87,040 B, Q and dO two stages 34,816 B, dSᵀ 12,800 B, lse and D
// 512 B: 135 KB, one block of 10 warps per SM.  The host picks the route
// and G (ops/flash_attention.py::bwd_plan, which reads RB, KW and MAX_KW
// from this file): G = 0 takes the tiled kernels.
//
// Backward, tiled (skv > 160: K/V do not fit a block): two kernels.
// dK/dV: one block of four warps per (K/V plane, 64-key tile) looping over
// every query head and 64-row q tile (multi-query heads summed in f32
// registers); dQ: one block per (batch·head, q tile) looping over key
// tiles, recomputing S and dP.  Score tiles through f32 shared memory.
//
// No float atomics anywhere: every output element is written by one block
// (partials summed in a fixed order).  Key columns past skv take no part
// (p = 0); query rows past sq are computed on zeros and not written.  A row
// that sees no key at all gets the uniform average over all skv keys (its
// scores are all NEG_BIG).
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
  float* part;  // f32 dK/dV partials of the resident backward's groups
  int* pairs;   // if set, the resident backward adds its visited pairs
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

// ------------------------------------------------- backward, K/V resident
constexpr int RB = 32;                // query rows per tile
constexpr int KW = 16;                // keys per warp
constexpr int MAX_KW = 10;            // warps of a block
constexpr int SKV_MAX = KW * MAX_KW;  // keys a block holds
constexpr int RLD = RB + 8;           // dSᵀ row stride (bf16)

template <int D>
size_t res_smem(int nw) {
  constexpr int LD = D + 8;
  return (size_t)2 * nw * KW * LD * sizeof(bf16)  // K, V
         + 2 * 2 * RB * LD * sizeof(bf16)          // Q, dO: two stages
         + nw * KW * RLD * sizeof(bf16)            // dSᵀ
         + 2 * 2 * RB * sizeof(float);             // lse, D: two stages
}

// 4-byte asynchronous copy; pred false zero-fills and reads nothing.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 4 : 0));
}

// Q, dO, lse and D of rows [q0, q0 + RB) of plane bh into one stage (zeros
// past sq).
template <int D>
__device__ void res_load_tile(const Params& p, bf16* Qs, bf16* dOs, float* lse, float* dvec,
                              int bh, int q0) {
  constexpr int LD = D + 8, VPR = D / 8;
  const bf16* qp = p.q + (size_t)bh * p.sq * D;
  const bf16* op = p.dout + (size_t)bh * p.sq * D;
  for (int i = threadIdx.x; i < RB * VPR; i += blockDim.x) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool in = q0 + r < p.sq;
    const size_t off = in ? (size_t)(q0 + r) * D + c : 0;
    cp_async16(Qs + r * LD + c, qp + off, in);
    cp_async16(dOs + r * LD + c, op + off, in);
  }
  for (int i = threadIdx.x; i < 2 * RB; i += blockDim.x) {
    const int r = i % RB;
    const bool in = q0 + r < p.sq;
    const size_t off = (size_t)bh * p.sq + (in ? q0 + r : 0);
    if (i < RB)
      cp_async4(lse + r, p.lse + off, in);
    else
      cp_async4(dvec + r, p.dvec + off, in);
  }
}

// Grid (G groups, b·hk K/V planes); blockDim 32·⌈skv/16⌉.  Group g of a
// plane takes its query tiles [g·T/G, (g+1)·T/G), T = (h if hk = 1 else 1)
// × ⌈sq/32⌉, a tile being 32 rows of one head.
template <int D>
__global__ void __launch_bounds__(MAX_KW * 32, 1) flash_bwd_kernel(Params p) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nw = blockDim.x / 32, nk = nw * KW;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + nk * LD;
  bf16* Qs = Vs + nk * LD;         // [2][RB][LD]
  bf16* dOs = Qs + 2 * RB * LD;    // [2][RB][LD]
  bf16* dSt = dOs + 2 * RB * LD;   // [nk][RLD]: dSᵀ, keys × query rows
  float* lse_s = reinterpret_cast<float*>(dSt + nk * RLD);      // [2][RB]
  float* dvec_s = lse_s + 2 * RB;                                // [2][RB]

  const int kvp = blockIdx.y, grp = blockIdx.x, groups = gridDim.x;
  const int bi = p.hk == 1 ? kvp : kvp / p.h;
  const int h0 = p.hk == 1 ? 0 : kvp % p.h, nh = p.hk == 1 ? p.h : 1;
  const int nqt = (p.sq + RB - 1) / RB, ntiles = nh * nqt;
  const int t0 = (int)((long long)grp * ntiles / groups);
  const int t1 = (int)((long long)(grp + 1) * ntiles / groups);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c4 = lane % 4;
  const int kv0 = warp * KW;
  // ldmatrix lane addresses: A from a row-major (m, k) tile; B from an
  // (n, k) tile; B (.trans) from a row-major (k, n) tile; A (.trans) from a
  // (k, m) tile
  const int ar = (lane % 8) + ((lane / 8) % 2) * 8, ac = (lane / 16) * 8;
  const int br = (lane % 8) + (lane / 16) * 8, bc = ((lane / 8) % 2) * 8;
  const int tr = ar, tc = ac;
  const int atr = br, atc = bc;

  {  // the plane's K and V, rows past skv zero
    const bf16* kp = p.k + (size_t)kvp * p.skv * D;
    const bf16* vp = p.v + (size_t)kvp * p.skv * D;
    for (int i = threadIdx.x; i < nk * (D / 8); i += blockDim.x) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const bool in = r < p.skv;
      const size_t off = in ? (size_t)r * D + c : 0;
      cp_async16(Ks + r * LD + c, kp + off, in);
      cp_async16(Vs + r * LD + c, vp + off, in);
    }
  }
  if (t0 < t1)
    res_load_tile<D>(p, Qs, dOs, lse_s, dvec_s, bi * p.h + h0 + t0 / nqt, (t0 % nqt) * RB);
  cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int u = 0; u < 4; ++u) dk[n][u] = dv[n][u] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const int st_ = (t - t0) & 1;
    if (t + 1 < t1)
      res_load_tile<D>(p, Qs + (st_ ^ 1) * RB * LD, dOs + (st_ ^ 1) * RB * LD,
                       lse_s + (st_ ^ 1) * RB, dvec_s + (st_ ^ 1) * RB,
                       bi * p.h + h0 + (t + 1) / nqt, ((t + 1) % nqt) * RB);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int hi = h0 + t / nqt, q0 = (t % nqt) * RB, bh = bi * p.h + hi;
    const float* bias = p.bias ? p.bias + bi * p.bsb + hi * p.bsh : nullptr;
    const bf16* Qt = Qs + st_ * RB * LD;
    const bf16* dOt = dOs + st_ * RB * LD;
    const float* lt = lse_s + st_ * RB;
    const float* dt = dvec_s + st_ * RB;
    // key slices [0, w_hi) are visited: under causal, when every row of the
    // tile saw a key, those up to the band of its last row
    const bool keyed =
        __all_sync(0xffffffffu, q0 + lane >= p.sq || lt[lane] > 0.5f * NEG_BIG);
    int w_hi = nw;
    if (p.causal && keyed) w_hi = min(nw, (min(q0 + RB, p.sq) - 1 + p.skv - p.sq) / KW + 1);
    if (p.pairs != nullptr && threadIdx.x == 0) atomicAdd(p.pairs, w_hi);

    if (warp < w_hi) {
      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: this warp's 16 keys × the tile's 32 rows
      float sa[RB / 8][4], pa[RB / 8][4];
#pragma unroll
      for (int n = 0; n < RB / 8; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) sa[n][u] = pa[n][u] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        ldsm_x4(ak, Ks + (kv0 + ar) * LD + kk * 16 + ac);
        ldsm_x4(av, Vs + (kv0 + ar) * LD + kk * 16 + ac);
#pragma unroll
        for (int n = 0; n < RB / 16; ++n) {
          uint32_t bq[4], bo[4];
          ldsm_x4(bq, Qt + (n * 16 + br) * LD + kk * 16 + bc);
          ldsm_x4(bo, dOt + (n * 16 + br) * LD + kk * 16 + bc);
          mma16816(sa[2 * n], ak, bq[0], bq[1]);
          mma16816(sa[2 * n + 1], ak, bq[2], bq[3]);
          mma16816(pa[2 * n], av, bo[0], bo[1]);
          mma16816(pa[2 * n + 1], av, bo[2], bo[3]);
        }
      }
      // p̃ (into sa) and dS (into pa) at (key kv0 + g [+ 8], row q0 + 8n +
      // 2·c4 [+ 1])
#pragma unroll
      for (int n = 0; n < RB / 8; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int col = kv0 + g + 8 * (u >> 1);
          const int r = n * 8 + 2 * c4 + (u & 1), row = q0 + r;
          float pr = 0.f;
          if (row < p.sq && col < p.skv) {
            float sc = sa[n][u] * p.scale;
            if (bias != nullptr) sc += fmaxf(bias[row * p.bsr + col], NEG_BIG);
            if (p.causal && col > row + p.skv - p.sq) sc = NEG_BIG;
            pr = expf(sc - lt[r]);
          }
          float dp = pa[n][u];
          if (p.dropout) {
            const float ks = keep_scale(p, row, col, bh);
            dp *= ks;
            sa[n][u] = pr * ks;
          } else {
            sa[n][u] = pr;
          }
          pa[n][u] = pr * (dp - dt[r]);
        }
      // dV += p̃ᵀ·dO and dK += dSᵀ·Q, A fragments from the accumulators
#pragma unroll
      for (int kq = 0; kq < RB / 16; ++kq) {
        const uint32_t ap[4] = {pack_bf2(sa[2 * kq][0], sa[2 * kq][1]),
                                pack_bf2(sa[2 * kq][2], sa[2 * kq][3]),
                                pack_bf2(sa[2 * kq + 1][0], sa[2 * kq + 1][1]),
                                pack_bf2(sa[2 * kq + 1][2], sa[2 * kq + 1][3])};
        const uint32_t as[4] = {pack_bf2(pa[2 * kq][0], pa[2 * kq][1]),
                                pack_bf2(pa[2 * kq][2], pa[2 * kq][3]),
                                pack_bf2(pa[2 * kq + 1][0], pa[2 * kq + 1][1]),
                                pack_bf2(pa[2 * kq + 1][2], pa[2 * kq + 1][3])};
#pragma unroll
        for (int n = 0; n < D / 16; ++n) {
          uint32_t bo[4], bq[4];
          ldsm_x4_t(bo, dOt + (kq * 16 + tr) * LD + n * 16 + tc);
          ldsm_x4_t(bq, Qt + (kq * 16 + tr) * LD + n * 16 + tc);
          mma16816(dv[2 * n], ap, bo[0], bo[1]);
          mma16816(dv[2 * n + 1], ap, bo[2], bo[3]);
          mma16816(dk[2 * n], as, bq[0], bq[1]);
          mma16816(dk[2 * n + 1], as, bq[2], bq[3]);
        }
      }
      // dSᵀ to shared memory, as the same bf16 values
#pragma unroll
      for (int n = 0; n < RB / 8; ++n) {
        *reinterpret_cast<uint32_t*>(dSt + (kv0 + g) * RLD + n * 8 + 2 * c4) =
            pack_bf2(pa[n][0], pa[n][1]);
        *reinterpret_cast<uint32_t*>(dSt + (kv0 + g + 8) * RLD + n * 8 + 2 * c4) =
            pack_bf2(pa[n][2], pa[n][3]);
      }
    }
    __syncthreads();
    // dQ = dS·K·scale over the visited keys, in (16 rows, 16 dims) jobs
    constexpr int NC = D / 16;
    for (int j = warp; j < (RB / 16) * NC; j += nw) {
      const int mt = j / NC, nc = j % NC;
      float acc[2][4] = {};
      for (int kk = 0; kk < w_hi; ++kk) {
        uint32_t a[4], bk[4];
        ldsm_x4_t(a, dSt + (kk * 16 + atr) * RLD + mt * 16 + atc);
        ldsm_x4_t(bk, Ks + (kk * 16 + tr) * LD + nc * 16 + tc);
        mma16816(acc[0], a, bk[0], bk[1]);
        mma16816(acc[1], a, bk[2], bk[3]);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = q0 + mt * 16 + g + 8 * hh;
        if (row >= p.sq) continue;
        bf16* dst = p.dq + ((size_t)bh * p.sq + row) * D + nc * 16 + 2 * c4;
#pragma unroll
        for (int n = 0; n < 2; ++n)
          *reinterpret_cast<uint32_t*>(dst + n * 8) =
              pack_bf2(acc[n][2 * hh] * p.scale, acc[n][2 * hh + 1] * p.scale);
      }
    }
  }

  // this warp's 16 keys of dK (scaled) and dV: bf16 when the block is the
  // plane's only group, else f32 partials [dK: G][planes][skv][D], then dV
  const size_t plane_elems = (size_t)gridDim.y * p.skv * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = kv0 + g + 8 * hh;
    if (key >= p.skv) continue;
    const size_t at = ((size_t)kvp * p.skv + key) * D + 2 * c4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      if (groups == 1) {
        *reinterpret_cast<uint32_t*>(p.dk + at + n * 8) =
            pack_bf2(dk[n][2 * hh] * p.scale, dk[n][2 * hh + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(p.dv + at + n * 8) =
            pack_bf2(dv[n][2 * hh], dv[n][2 * hh + 1]);
      } else {
        float* pk = p.part + grp * plane_elems + at + n * 8;
        float* pv = pk + groups * plane_elems;
        *reinterpret_cast<float2*>(pk) = make_float2(dk[n][2 * hh], dk[n][2 * hh + 1]);
        *reinterpret_cast<float2*>(pv) = make_float2(dv[n][2 * hh], dv[n][2 * hh + 1]);
      }
    }
  }
}

// ------------------------------------------------- forward, K/V resident
constexpr int FWD_ROWS = 16;          // query rows of a warp's tile
constexpr int FWD_WARPS = 4;          // warps of a block
constexpr int FWD_SLICE = 32;         // keys of an online-softmax step
constexpr int FWD_BLOCKS_PER_SM = 2;  // blocks an SM holds (launch bounds; shared memory)
constexpr int SM_SMEM = 233472;       // shared memory of an SM (228 KB), 1 KB a block reserved
constexpr int FWD_SLICES = SKV_MAX / FWD_SLICE;  // score slices a warp holds
static_assert(FWD_SLICES * FWD_SLICE == SKV_MAX, "the resident keys are whole slices");

// Max over the 4 lanes of a quad (the lanes holding one accumulator row).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

constexpr size_t fwd_smem(int d, int skv) {
  return (size_t)(2 * ((skv + FWD_SLICE - 1) / FWD_SLICE * FWD_SLICE) + FWD_WARPS * FWD_ROWS) *
         (d + 8) * sizeof(bf16);
}
static_assert(FWD_BLOCKS_PER_SM * (fwd_smem(128, SKV_MAX) + 1024) <= SM_SMEM,
              "two resident forward blocks must fit an SM at d 128, 160 keys");

// Grid (G groups, b·hk K/V planes); FWD_WARPS warps.  Group g of a plane
// takes its 16-row tiles [g·T/G, (g+1)·T/G) of the nh·sq folded rows (nh =
// h if hk = 1 else 1), T = ⌈nh·sq/16⌉; warp w of the block the tiles
// t1 − 1 − w, t1 − 1 − w − FWD_WARPS, ... of that range [t0, t1).
template <int D>
__global__ void __launch_bounds__(FWD_WARPS * 32, FWD_BLOCKS_PER_SM)
    flash_fwd_res_kernel(Params p) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nk = (p.skv + FWD_SLICE - 1) / FWD_SLICE * FWD_SLICE, ns = nk / FWD_SLICE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c4 = lane % 4;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + nk * LD;
  bf16* Qw = Vs + nk * LD + warp * FWD_ROWS * LD;  // this warp's Q tile

  const int kvp = blockIdx.y, grp = blockIdx.x, groups = gridDim.x;
  const int bi = p.hk == 1 ? kvp : kvp / p.h;
  const int h0 = p.hk == 1 ? 0 : kvp % p.h, nh = p.hk == 1 ? p.h : 1;
  const int nrows = nh * p.sq, ntiles = (nrows + FWD_ROWS - 1) / FWD_ROWS;
  const int t0 = (int)((long long)grp * ntiles / groups);
  const int t1 = (int)((long long)(grp + 1) * ntiles / groups);
  const size_t base = (size_t)(bi * p.h + h0) * p.sq;  // first folded row of (b, h, sq)
  // ldmatrix lane addresses: A from a row-major (m, k) tile; B from an
  // (n, k) tile; B (.trans) from a row-major (k, n) tile
  const int ar = (lane % 8) + ((lane / 8) % 2) * 8, ac = (lane / 16) * 8;
  const int br = (lane % 8) + (lane / 16) * 8, bc = ((lane / 8) % 2) * 8;

  {  // the plane's K and V, rows past skv zero
    const bf16* kp = p.k + (size_t)kvp * p.skv * D;
    const bf16* vp = p.v + (size_t)kvp * p.skv * D;
    for (int i = threadIdx.x; i < nk * (D / 8); i += blockDim.x) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const bool in = r < p.skv;
      const size_t off = in ? (size_t)r * D + c : 0;
      cp_async16(Ks + r * LD + c, kp + off, in);
      cp_async16(Vs + r * LD + c, vp + off, in);
    }
  }
  // folded rows [16 t, 16 t + 16) of Q into this warp's buffer, zeros past
  // the plane's rows
  auto load_q = [&](int t) {
    const bf16* qp = p.q + base * D;
    for (int i = lane; i < FWD_ROWS * (D / 8); i += 32) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8, fr = t * FWD_ROWS + r;
      const bool in = fr < nrows;
      cp_async16(Qw + r * LD + c, qp + (in ? (size_t)fr * D + c : 0), in);
    }
  };
  // a warp walks its tiles from the range's end: within a head a causal
  // tile's band, and so its work, falls with the tile, so each tile's Q
  // copy runs under a tile at least as long
  int t = t1 - 1 - warp;
  if (t >= t0) load_q(t);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  for (; t >= t0; t -= FWD_WARPS) {
    cp_async_wait<0>();
    __syncwarp();
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(qa[kk], Qw + ar * LD + kk * 16 + ac);
    __syncwarp();
    if (t - FWD_WARPS >= t0) load_q(t - FWD_WARPS);
    cp_async_commit();

    // this lane's rows g and g + 8 of the tile, unfolded to (head, row)
    int row[2], lim[2], plane[2];
    bool in[2];
    const float* brow[2];
    int band = -1;  // the last key any row of the tile sees (causal)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int fr = t * FWD_ROWS + g + 8 * hh;
      in[hh] = fr < nrows;
      const int head = h0 + (in[hh] ? fr / p.sq : 0);
      row[hh] = fr % p.sq;
      plane[hh] = bi * p.h + head;
      lim[hh] = row[hh] + p.skv - p.sq;
      brow[hh] = (p.bias != nullptr && in[hh])
                     ? p.bias + bi * p.bsb + head * p.bsh + row[hh] * p.bsr
                     : nullptr;
      if (in[hh]) band = max(band, lim[hh]);
    }
    band = __reduce_max_sync(0xffffffffu, band);

    // S = Q·Kᵀ of the visited slices, all in registers (at most SKV_MAX
    // keys): the scores a causal tile needs end at its band; a tile with a
    // row that sees no key there visits every slice (it averages over all)
    float s[FWD_SLICES][FWD_SLICE / 8][4];
    float m[2] = {-INFINITY, -INFINITY};
    auto scores = [&](int j) {
      const int k0 = j * FWD_SLICE;
#pragma unroll
      for (int n = 0; n < FWD_SLICE / 8; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) s[j][n][u] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int n = 0; n < FWD_SLICE / 16; ++n) {
          uint32_t bk[4];
          ldsm_x4(bk, Ks + (k0 + n * 16 + br) * LD + kk * 16 + bc);
          mma16816(s[j][2 * n], qa[kk], bk[0], bk[1]);
          mma16816(s[j][2 * n + 1], qa[kk], bk[2], bk[3]);
        }
      // at (row g [+ 8], col k0 + 8n + 2·c4 [+ 1]); -inf past skv
#pragma unroll
      for (int n = 0; n < FWD_SLICE / 8; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int hh = u >> 1, col = k0 + n * 8 + 2 * c4 + (u & 1);
          float x = -INFINITY;
          if (col < p.skv) {
            x = s[j][n][u] * p.scale;
            if (brow[hh] != nullptr) x += fmaxf(brow[hh][col], NEG_BIG);
            if (p.causal && col > lim[hh]) x = NEG_BIG;
          }
          s[j][n][u] = x;
          m[hh] = fmaxf(m[hh], x);
        }
    };
    // slices up to the band; past it only for a tile with a row that has
    // seen no key (every lane takes part in the quad shuffles)
    const int band_slices = p.causal ? min(ns, max(band, 0) / FWD_SLICE + 1) : ns;
    int nv = 0;
#pragma unroll
    for (int j = 0; j < FWD_SLICES; ++j) {
      if (j >= ns) break;
      if (j == band_slices) {
        const float mq0 = quad_max(m[0]), mq1 = quad_max(m[1]);
        if (__all_sync(0xffffffffu, (!in[0] || mq0 > 0.5f * NEG_BIG) &&
                                        (!in[1] || mq1 > 0.5f * NEG_BIG)))
          break;
      }
      scores(j);
      nv = j + 1;
    }
    // the exact softmax: p = exp(s − m) with the row's max over every
    // visited key (past the band p = exp(NEG_BIG − m) = 0), the denominator
    // before dropout, then p̃ = p·keep/(1 − rate)
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) m[hh] = fmaxf(quad_max(m[hh]), NEG_BIG);
#pragma unroll
    for (int j = 0; j < FWD_SLICES; ++j) {
      if (j >= nv) continue;
#pragma unroll
      for (int n = 0; n < FWD_SLICE / 8; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int hh = u >> 1;
          float pr = expf(s[j][n][u] - m[hh]);
          l[hh] += pr;
          if (p.dropout)
            pr *= keep_scale(p, row[hh], j * FWD_SLICE + n * 8 + 2 * c4 + (u & 1), plane[hh]);
          s[j][n][u] = pr;
        }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    }
    // O = P̃·V, A fragments from the score registers (bf16)
    float o[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) o[n][u] = 0.f;
#pragma unroll
    for (int j = 0; j < FWD_SLICES; ++j) {
      if (j >= nv) continue;
#pragma unroll
      for (int kq = 0; kq < FWD_SLICE / 16; ++kq) {
        const uint32_t ap[4] = {pack_bf2(s[j][2 * kq][0], s[j][2 * kq][1]),
                                pack_bf2(s[j][2 * kq][2], s[j][2 * kq][3]),
                                pack_bf2(s[j][2 * kq + 1][0], s[j][2 * kq + 1][1]),
                                pack_bf2(s[j][2 * kq + 1][2], s[j][2 * kq + 1][3])};
#pragma unroll
        for (int n = 0; n < D / 16; ++n) {
          uint32_t bv[4];
          ldsm_x4_t(bv, Vs + (j * FWD_SLICE + kq * 16 + ar) * LD + n * 16 + ac);
          mma16816(o[2 * n], ap, bv[0], bv[1]);
          mma16816(o[2 * n + 1], ap, bv[2], bv[3]);
        }
      }
    }
    // O / l as bf16 and lse, rows past the plane's not written
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (!in[hh]) continue;
      const size_t at = base + t * FWD_ROWS + g + 8 * hh;
      const float lc = fmaxf(l[hh], 1e-30f);
      bf16* dst = p.o + at * D + 2 * c4;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(dst + n * 8) =
            pack_bf2(o[n][2 * hh] / lc, o[n][2 * hh + 1] / lc);
      if (c4 == 0) p.lse_out[at] = m[hh] + logf(lc);
    }
  }
}

// dK = scale·Σ_g part_dK[g], dV = Σ_g part_dV[g], summed in group order;
// ``elems`` = planes·skv·D (a multiple of 4), four elements a thread.
__global__ void __launch_bounds__(256) flash_bwd_reduce_kernel(const float* part, bf16* dk,
                                                               bf16* dv, int groups,
                                                               long long elems, float scale) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= 2 * elems) return;
  const bool is_v = i >= elems;
  const long long j = is_v ? i - elems : i;
  const float* src = part + (is_v ? groups * elems : 0) + j;
  float4 s = *reinterpret_cast<const float4*>(src);
  for (int g = 1; g < groups; ++g) {
    const float4 x = *reinterpret_cast<const float4*>(src + g * elems);
    s.x += x.x;
    s.y += x.y;
    s.z += x.z;
    s.w += x.w;
  }
  const float m = is_v ? 1.f : scale;
  uint2 o;
  o.x = pack_bf2(s.x * m, s.y * m);
  o.y = pack_bf2(s.z * m, s.w * m);
  *reinterpret_cast<uint2*>((is_v ? dv : dk) + j) = o;
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
int launch(Kernel kernel, size_t smem, dim3 grid, const Params& p, void* stream,
           int threads = THREADS) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The tiled backward (skv > SKV_MAX): dK/dV, then dQ.
template <int D>
int launch_tiled_bwd(const Params& p, void* stream) {
  int err = launch(flash_bwd_dkv_kernel<D>, BwdSmem<D>::bytes,
                   dim3((p.skv + BK - 1) / BK, p.b * p.hk), p, stream);
  if (err != 0) return err;
  return launch(flash_bwd_dq_kernel<D>, BwdSmem<D>::bytes,
                dim3((p.sq + BQ - 1) / BQ, p.b * p.h), p, stream);
}

template <int D>
int launch_bwd(const Params& p, int groups, void* stream) {
  if (groups == 0) return launch_tiled_bwd<D>(p, stream);
  if (groups < 0 || p.skv > SKV_MAX || (groups > 1 && p.part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int nw = (p.skv + KW - 1) / KW;
  int err = launch(flash_bwd_kernel<D>, res_smem<D>(nw), dim3(groups, p.b * p.hk), p, stream,
                   32 * nw);
  if (err != 0 || groups == 1) return err;
  const long long elems = (long long)p.b * p.hk * p.skv * D;
  const long long threads = (2 * elems / 4 + 255) / 256;
  flash_bwd_reduce_kernel<<<(unsigned)threads, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      p.part, p.dk, p.dv, groups, elems, p.scale);
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

// Out and lse of one forward call: the K/V-resident kernel (skv <=
// SKV_MAX) with ``groups`` blocks per K/V plane, or the tiled kernel for
// groups = 0.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                void* lse, int groups, I2T_FLASH_ARGS) {
  if (!valid(b, h, hk, sq, skv) || groups < 0 || (groups > 0 && skv > SKV_MAX))
    return (int)cudaErrorInvalidValue;
  Params p = I2T_FLASH_PARAMS;
  p.o = static_cast<bf16*>(o);
  p.lse_out = static_cast<float*>(lse);
  if (groups == 0) {
    const dim3 grid((sq + BQ - 1) / BQ, b * h);
#define FWD(D) return launch(flash_fwd_kernel<D>, FwdSmem<D>::bytes, grid, p, stream)
    I2T_DISPATCH(FWD)
#undef FWD
  }
  const dim3 grid(groups, b * hk);
#define FWD_RES(D) \
  return launch(flash_fwd_res_kernel<D>, fwd_smem(D, skv), grid, p, stream, FWD_WARPS * 32)
  I2T_DISPATCH(FWD_RES)
#undef FWD_RES
}

// dQ, dK and dV of one backward call: the K/V-resident kernel (skv <=
// SKV_MAX; ``groups`` blocks per K/V plane; for groups > 1 ``part`` holds
// 2·groups·b·hk·skv·d f32 partials, summed by a second kernel), or the
// tiled kernels for groups = 0.  ``pairs`` (may be null) counts the
// resident kernel's visited (32-row query tile, 16-key slice) pairs.
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* dvec, void* dq, void* dk, void* dv,
                                void* part, void* pairs, int groups, I2T_FLASH_ARGS) {
  if (!valid(b, h, hk, sq, skv)) return (int)cudaErrorInvalidValue;
  Params p = I2T_FLASH_PARAMS;
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.dvec = static_cast<const float*>(dvec);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.part = static_cast<float*>(part);
  p.pairs = static_cast<int*>(pairs);
#define BWD(D) return launch_bwd<D>(p, groups, stream)
  I2T_DISPATCH(BWD)
#undef BWD
}
