// Flash attention in f32 for Hopper (sm_90a): the f32 forms of
// image2text_tpu/ops/flash_attention.py::_fwd_kernel, ::_bwd_dkv_kernel and
// ::_bwd_dq_kernel.  The JAX kernels are dtype-generic (their products take
// preferred_element_type=f32 and the forward writes q's dtype); the
// configs with ``precision: 'no'`` (training_configs/local/synthetic-*.yaml,
// the families' f32 YAMLs) run them in f32.  The entry semantics are those
// of the bf16 kernels in flash_attention.cu: the (1|b, 1|h, 1|sq, skv) f32
// bias clamped at NEG_BIG, K/V heads 1 or h, the in-kernel causal mask, the
// murmur3 keep mask of common.cuh::keep_hash with the denominator taken
// before dropout, lse out, and a row that sees no key averaging every key
// (p = exp(NEG_BIG − NEG_BIG) = 1 forward, and p = exp(s − lse) = 1
// backward, where lse rounds to NEG_BIG).  Nothing is rounded to a
// narrower type: p̃ = p · keep / (1 − rate) feeds the V product in f32.
//
// Products on the tensor cores as 3xTF32.  Hopper's tensor cores take f32
// operands only as TF32 (ten mantissa bits), so each operand x is split
// into big = cvt.rna.tf32(x) and small = x − big (exact in f32; the tensor
// core reads its top TF32 bits), and a product runs mma.sync m16n8k8 TF32
// three times: small·big, big·small, then big·big (small·small, about
// 2⁻²² of the product, is left out), as PyTorch's f32 memory-efficient
// SDPA does with CUTLASS's OpMultiplyAddFastF32.  The tensor cores'
// accumulation truncates, so a long running sum of mma results drifts
// with one sign: each k-step of 8 goes into a zeroed accumulator that an
// f32 add rounded to nearest adds to the sum (mma3's FRESH), wherever the
// registers allow it (fresh_products, fresh_o, fresh_grads).  The errors
// against a float64 truth then stay near or below the FFMA kernels' that
// these replace (probes/kernel_times.py --flash-f32-only).  Operands are
// split where they are read: from shared memory for Q, K, V and dO, from
// the score registers for p̃ and dS.
//
// What bounds it on the H100: bytes at the families' calls, operations at
// the offline encoder's.  The least time is the larger of the bytes at
// 3.35 TB/s and 3 × the FLOP at 495 TFLOP/s of dense TF32 (Llama-2-7B's
// f32 training call, b 1, 32 heads, 272 keys, d 128, causal: a forward of
// 0.61 GFLOP, 3.7 µs, moving 17.9 MB, 5.3 µs).  The kernels run at 1–9%
// of it: their time goes to the mma.sync chains, the operand splits, and
// every pair's exp, mask and hash on the CUDA cores.
//
// Forward (flash_fwd_f32_kernel).  A block of four warps takes 64-row tiles
// of the folded query rows (the h heads' rows for one K/V head, else its
// own head's), G blocks a K/V plane (the host's f32_groups: one a tile),
// so one K/V stage serves every head that shares it.  It streams the
// plane's K/V through a two-stage cp.async ring of 16-byte copies (64 keys
// a stage up to head dim 64, 4,096 floats of K a stage past it: 32 keys at
// 128, 16 at 256), the copy of stage j + 1 under the products of stage j,
// one block barrier a stage.  A warp's S = Q·Kᵀ (16 rows × the stage's
// keys) stays in registers in the mma accumulator layout, where every lane
// knows its (row, col): bias, causal mask and the online softmax of
// FlashAttention-2 (running max m, rescaled O and row sums) are applied
// there, p̃ = p·keep is split again as the A operand of P̃·V with no trip
// through shared memory (the accumulator's columns 2c, 2c + 1 are the A
// fragment's k c, c + 4: the V operand is read with the same permutation of
// its keys), and O (16 × D) accumulates in registers.  The causal band is
// skipped on the device: a tile stops at the band of its last row once
// every row in it holds a max above NEG_BIG / 2 (past the band p =
// exp(NEG_BIG − m) = 0), under a bias too; a tile with a keyless row
// streams every stage; a warp whose rows all saw a key skips the stages
// past its own band.
//
// Backward: a dK/dV kernel and a dQ kernel, then the group sums.  dK/dV
// (flash_bwd_dkv_f32_kernel): a block holds a 64-key tile of one K/V plane
// (32 past head dim 64, each 16 keys shared by two warps, one half of the
// dims each) and walks its group's share of the plane's 32-row query tiles
// (h heads' for one K/V head: the multi-query sum over heads), their Q, dO,
// lse and D through a two-stage cp.async ring.  Per (query tile, key tile)
// a warp computes Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (16 keys × 32 rows) once on the
// tensor cores, p = exp(s − lse), the hash and dS = p ∘ (keep·dP − D) in
// registers, then dV += p̃ᵀ·dO and dK += dSᵀ·Q with p̃ᵀ and dSᵀ split as A
// operands, dK/dV in registers over the block's tiles.  G groups a key
// tile (the host's f32_bwd_plan, so that a multi-query plane's few key
// tiles still fill the card): for G = 1 the block writes dK·scale and dV,
// else f32 partials that flash_bwd_reduce_f32_kernel sums in group order.
// dQ (flash_bwd_dq_f32_kernel): the forward's grid, tiles and K/V ring
// (half the keys a stage past head dim 64); S and dP again in registers,
// dQ += dS·K with dS split as the A operand, dQ written whole (a block sees
// every key of its rows).  Both skip the causal band from the saved lse (a
// row saw a key exactly when lse > NEG_BIG / 2).
//
// No float atomics: every output element is written by one block, partials
// summed in a fixed order, so reruns are bitwise equal.  Key columns past
// skv take no part (p = 0); query rows past sq are computed on zeros and
// not written.  The host's plans (ops/flash_attention.py::f32_groups,
// f32_bwd_plan) read F32_TILE_ROWS, F32_DKV_KEYS and F32_DKV_ROWS from
// this file, and tests/test_torch_flash.py its shared memory budget.
#include "flash_common.cuh"

using namespace i2t;

constexpr int F32_WARPS = 4;             // warps of every block
constexpr int F32_TILE_ROWS = 64;        // folded query rows of a forward or dQ tile: 16 a warp
constexpr int F32_TILE_KEYS = 64;        // keys of their K/V stages, at most
constexpr int F32_STAGE_FLOATS = 4096;   // floats of a K (or V) stage, at most
constexpr int F32_STAGES = 2;            // stages of the K/V ring, and of the dK/dV Q/dO ring
constexpr int F32_DKV_KEYS = 64;         // keys of a dK/dV block (half past head dim 64)
constexpr int F32_DKV_ROWS = 32;         // query rows of a dK/dV block's tiles
constexpr int F32_SMEM = 232448;         // shared memory a block may take (227 KB)
constexpr int SM_SMEM = 233472;          // shared memory of an SM (228 KB), 1 KB a block reserved
static_assert(F32_TILE_ROWS == 16 * F32_WARPS && F32_DKV_KEYS == 16 * F32_WARPS,
              "16 rows (keys) a warp");

namespace {

// Keys of a forward K/V stage at head dim d, and of a dQ stage: half past
// d 64, so that two dQ blocks (Q and dO too) fit an SM at d 128.
__host__ __device__ constexpr int stage_keys(int d) {
  return F32_STAGE_FLOATS / d < F32_TILE_KEYS ? F32_STAGE_FLOATS / d : F32_TILE_KEYS;
}
__host__ __device__ constexpr int dq_keys(int d) {
  return d > 64 ? stage_keys(d) / 2 : stage_keys(d);
}
// dK/dV: a warp holds 16 keys × at most 64 dims of both accumulators (so
// that they accumulate FRESH without spills), so past d 64 two warps share
// 16 keys, each half of the dims.
__host__ __device__ constexpr int dkv_split(int d) { return d > 64 ? 2 : 1; }
__host__ __device__ constexpr int dkv_keys(int d) { return F32_DKV_KEYS / dkv_split(d); }
// Which products accumulate FRESH (mma3): S and dP, dQ, dK and dV up to
// head dim 128, O up to 64 (at 128 its zeroed accumulators take the forward
// to 255 registers and a spill); none at 256, where they would spill.
__host__ __device__ constexpr bool fresh_products(int d) { return d <= 128; }
__host__ __device__ constexpr bool fresh_o(int d) { return d <= 64; }
__host__ __device__ constexpr bool fresh_grads(int d) { return d <= 128; }

// Shared memory of each kernel (row stride d + 4 floats: the fragment
// reads of a warp fall on 32 distinct banks).
constexpr size_t fwd_smem(int d) {  // Q; K and V of each stage
  return (size_t)(F32_TILE_ROWS + 2 * F32_STAGES * stage_keys(d)) * (d + 4) * sizeof(float);
}
constexpr size_t dq_smem(int d) {  // Q, dO; K and V of each stage
  return (size_t)(2 * F32_TILE_ROWS + 2 * F32_STAGES * dq_keys(d)) * (d + 4) * sizeof(float);
}
constexpr size_t dkv_smem(int d) {  // K, V; Q, dO, lse and D of each stage
  return (size_t)(2 * dkv_keys(d) + 2 * F32_STAGES * F32_DKV_ROWS) * (d + 4) * sizeof(float) +
         2 * F32_STAGES * F32_DKV_ROWS * sizeof(float);
}
static_assert(fwd_smem(256) <= F32_SMEM && dq_smem(256) <= F32_SMEM && dkv_smem(256) <= F32_SMEM &&
                  dq_smem(128) <= F32_SMEM && dkv_smem(128) <= F32_SMEM,
              "every block fits an SM up to head dim 256");
// The forward asks for two blocks an SM up to head dim 128 (its shared
// memory, 101,376 bytes at d 128, fits twice).
__host__ __device__ constexpr int fwd_min_blocks(int d) { return d > 128 ? 1 : 2; }
static_assert(2 * (fwd_smem(128) + 1024) <= SM_SMEM && 2 * (fwd_smem(64) + 1024) <= SM_SMEM,
              "two forward blocks an SM up to d 128");

struct Params32 {
  const float* q;
  const float* k;
  const float* v;
  const float* bias;
  long long bsb, bsh, bsr;  // bias strides of batch, head, query (0: broadcast)
  const float* dout;
  const float* lse;
  const float* dvec;
  float* o;
  float* lse_out;
  float* dq;
  float* dk;
  float* dv;
  float* part;  // f32 dK/dV partials of a backward's groups
  int b, h, hk, sq, skv;
  int causal;
  float scale;
  int dropout;
  unsigned seed, threshold;
  float inv_keep;
  int plane_h, plane_off;  // the hash's plane of (batch i, head j): plane_off + i·plane_h + j
};

// One warp's 16 × N products of A (16 rows, row stride LD) with the N rows
// of B (row stride LD) over D columns: c[n] holds columns 8n..8n+7.
template <int D, int N, bool FRESH>
__device__ __forceinline__ void warp_products(float (&c)[N / 8][4], const float* A,
                                              const float* B) {
  constexpr int LD = D + 4;
  const int lane = threadIdx.x % 32, g = lane / 4, c4 = lane % 4;
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int u = 0; u < 4; ++u) c[n][u] = 0.f;
  const float* a = A + g * LD + c4;
  const float* b = B + g * LD + c4;
#pragma unroll 4
  for (int kk = 0; kk < D; kk += 8) {
    uint32_t ab[4], as[4];
    split(a[kk], ab[0], as[0]);
    split(a[8 * LD + kk], ab[1], as[1]);
    split(a[kk + 4], ab[2], as[2]);
    split(a[8 * LD + kk + 4], ab[3], as[3]);
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      uint32_t bb[2], bs[2];
      split(b[n * 8 * LD + kk], bb[0], bs[0]);
      split(b[n * 8 * LD + kk + 4], bb[1], bs[1]);
      mma3<FRESH>(c[n], ab, as, bb, bs);
    }
  }
}

// acc (16 × ND) += P (16 × K, f32 registers in the accumulator layout) ·
// B (K rows of a row-major matrix of row stride LD, from its column 0).
// The accumulator's columns 8kq + 2c, 8kq + 2c + 1 serve as the A
// fragment's k c and c + 4, so B's rows are read in that order too.
template <int LD, int ND, int K, bool FRESH>
__device__ __forceinline__ void warp_pv(float (&acc)[ND / 8][4], const float (&pr)[K / 8][4],
                                        const float* B) {
  const int lane = threadIdx.x % 32, g = lane / 4, c4 = lane % 4;
#pragma unroll
  for (int kq = 0; kq < K / 8; ++kq) {
    uint32_t ab[4], as[4];
    split(pr[kq][0], ab[0], as[0]);
    split(pr[kq][2], ab[1], as[1]);
    split(pr[kq][1], ab[2], as[2]);
    split(pr[kq][3], ab[3], as[3]);
    const float* b = B + (kq * 8 + 2 * c4) * LD + g;
#pragma unroll
    for (int n = 0; n < ND / 8; ++n) {
      uint32_t bb[2], bs[2];
      split(b[n * 8], bb[0], bs[0]);
      split(b[LD + n * 8], bb[1], bs[1]);
      mma3<FRESH>(acc[n], ab, as, bb, bs);
    }
  }
}

// -- forward -----------------------------------------------------------------

// Grid (G groups, b·hk K/V planes); F32_WARPS warps.  Group g of a plane
// takes its F32_TILE_ROWS-row tiles [g·T/G, (g+1)·T/G) of the folded rows
// (T = ⌈nrows / F32_TILE_ROWS⌉), warp w rows 16w..16w+15 of each.
template <int D>
__global__ void __launch_bounds__(F32_WARPS * 32, fwd_min_blocks(D))
    flash_fwd_f32_kernel(Params32 p) {
  constexpr int LD = D + 4, KT = stage_keys(D), NST = F32_STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [F32_TILE_ROWS][LD]
  float* Ks = Qs + F32_TILE_ROWS * LD;          // [NST][KT][LD]
  float* Vs = Ks + NST * KT * LD;               // [NST][KT][LD]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c4 = lane % 4;
  const int kvp = blockIdx.y, grp = blockIdx.x, groups = gridDim.x;
  const Plane pl = plane_of(p, kvp);
  const size_t kvbase = (size_t)kvp * p.skv;
  const int ntiles = (pl.nrows + F32_TILE_ROWS - 1) / F32_TILE_ROWS, nkt = (p.skv + KT - 1) / KT;
  const int t0 = (int)((long long)grp * ntiles / groups);
  const int t1 = (int)((long long)(grp + 1) * ntiles / groups);
  // stage j's K and V into ring slot j % NST, one commit group a stage
  // (empty past the last)
  auto load_stage = [&](int j) {
    if (j < nkt) {
      load_rows<D>(Ks + (j % NST) * KT * LD, p.k, kvbase, j * KT, p.skv, KT);
      load_rows<D>(Vs + (j % NST) * KT * LD, p.v, kvbase, j * KT, p.skv, KT);
    }
    cp_async_commit();
  };

  for (int t = t0; t < t1; ++t) {
    const int f0 = t * F32_TILE_ROWS, f1 = min(f0 + F32_TILE_ROWS, pl.nrows);
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the previous tile's Q and stages
    load_rows<D>(Qs, p.q, pl.base, f0, pl.nrows, F32_TILE_ROWS);
#pragma unroll
    for (int j = 0; j < NST - 1; ++j) load_stage(j);
    const LaneRows r = lane_rows(p, pl, f0 + warp * 16 + g);
    const int band_stages = p.causal ? min(nkt, max(rows_band(p, f0, f1), 0) / KT + 1) : nkt;
    const int wf0 = f0 + warp * 16;
    const int wband = wf0 < f1 ? rows_band(p, wf0, min(wf0 + 16, f1)) : -1;
    const int wfloor = wf0 < f1 ? rows_floor(p, wf0, min(wf0 + 16, f1)) : -1;

    float o[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) o[n][u] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int j = 0; j < nkt; ++j) {
      cp_async_wait<NST - 2>();
      const bool keyed =
          (!r.in[0] || m[0] > 0.5f * NEG_BIG) && (!r.in[1] || m[1] > 0.5f * NEG_BIG);
      // the barrier: stage j is in, and the slot of stage j + NST − 1 (stage
      // j − 1's) is read by no one
      if (__syncthreads_and(keyed) && j >= band_stages) break;
      load_stage(j + NST - 1);
      if (p.causal && j * KT > wband && __all_sync(0xffffffffu, keyed)) continue;
      const float* Kt = Ks + (j % NST) * KT * LD;
      const float* Vt = Vs + (j % NST) * KT * LD;
      float s[KT / 8][4];
      warp_products<D, KT, fresh_products(D)>(s, Qs + warp * 16 * LD, Kt);
      // at (row g [+ 8], col j·KT + 8n + 2·c4 [+ 1]); a stage inside every
      // row's band with no bias takes only the scale
      const bool plain = unmasked(p, j * KT, (j + 1) * KT, wfloor);
      float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int hh = u >> 1;
          s[n][u] = plain ? s[n][u] * p.scale
                          : masked_score(p, r, hh, s[n][u], j * KT + n * 8 + 2 * c4 + (u & 1));
          mt[hh] = fmaxf(mt[hh], s[n][u]);
        }
      float ms[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float mn = fmaxf(m[hh], quad_max(mt[hh]));
        ms[hh] = fmaxf(mn, NEG_BIG);
        const float alpha = expf(fmaxf(m[hh], NEG_BIG) - ms[hh]);
        m[hh] = mn;
        l[hh] *= alpha;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          o[n][2 * hh] *= alpha;
          o[n][2 * hh + 1] *= alpha;
        }
      }
      // the denominator before dropout, then p̃ = p·keep/(1 − rate)
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int hh = u >> 1;
          float pr = expf(s[n][u] - ms[hh]);
          l[hh] += pr;
          if (p.dropout)
            pr *= keep_scale(p, r.row[hh], j * KT + n * 8 + 2 * c4 + (u & 1), r.plane[hh]);
          s[n][u] = pr;
        }
      warp_pv<LD, D, KT, fresh_o(D)>(o, s, Vt);
    }
    // O / l and lse, rows past the plane's not written
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
      if (!r.in[hh]) continue;
      const float lc = fmaxf(l[hh], 1e-30f);
      float* dst = p.o + r.at[hh] * D + 2 * c4;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(dst + n * 8) =
            make_float2(o[n][2 * hh] / lc, o[n][2 * hh + 1] / lc);
      if (c4 == 0) p.lse_out[r.at[hh]] = fmaxf(m[hh], NEG_BIG) + logf(lc);
    }
  }
}

// -- backward ----------------------------------------------------------------

// dQ: the forward's grid, tiles and K/V ring.  A warp computes S = Q·Kᵀ and
// dP = dO·Vᵀ (16 × KT) in registers, p = exp(s − lse) and dS = p·(keep·dP −
// D) there, and dQ += dS·K with dS as the A operand; a block sees every key
// of its rows, so it writes dQ whole (× scale).  A causal tile stops at its
// last row's band when every row in it saw a key (lse > NEG_BIG / 2), else
// streams every stage; a warp whose rows all saw a key skips the stages
// past its band, and as in the forward an unmasked stage takes the scale
// alone.
template <int D>
__global__ void __launch_bounds__(F32_WARPS * 32) flash_bwd_dq_f32_kernel(Params32 p) {
  constexpr int LD = D + 4, KT = dq_keys(D), NST = F32_STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [F32_TILE_ROWS][LD]
  float* dOs = Qs + F32_TILE_ROWS * LD;         // [F32_TILE_ROWS][LD]
  float* Ks = dOs + F32_TILE_ROWS * LD;         // [NST][KT][LD]
  float* Vs = Ks + NST * KT * LD;               // [NST][KT][LD]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c4 = lane % 4;
  const int kvp = blockIdx.y, grp = blockIdx.x, groups = gridDim.x;
  const Plane pl = plane_of(p, kvp);
  const size_t kvbase = (size_t)kvp * p.skv;
  const int ntiles = (pl.nrows + F32_TILE_ROWS - 1) / F32_TILE_ROWS, nkt = (p.skv + KT - 1) / KT;
  const int t0 = (int)((long long)grp * ntiles / groups);
  const int t1 = (int)((long long)(grp + 1) * ntiles / groups);
  // stage j's K and V into ring slot j % NST, one commit group a stage
  // (empty from the tile's last visited stage on)
  int last = nkt;
  auto load_stage = [&](int j) {
    if (j < last) {
      load_rows<D>(Ks + (j % NST) * KT * LD, p.k, kvbase, j * KT, p.skv, KT);
      load_rows<D>(Vs + (j % NST) * KT * LD, p.v, kvbase, j * KT, p.skv, KT);
    }
    cp_async_commit();
  };

  for (int t = t0; t < t1; ++t) {
    const int f0 = t * F32_TILE_ROWS, f1 = min(f0 + F32_TILE_ROWS, pl.nrows);
    cp_async_wait<0>();
    __syncthreads();
    load_rows<D>(Qs, p.q, pl.base, f0, pl.nrows, F32_TILE_ROWS);
    load_rows<D>(dOs, p.dout, pl.base, f0, pl.nrows, F32_TILE_ROWS);
    last = nkt;
    load_stage(0);  // with Q and dO: one commit group
    const LaneRows r = lane_rows(p, pl, f0 + warp * 16 + g);
    float lse[2], dvec[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      lse[hh] = r.in[hh] ? p.lse[r.at[hh]] : 0.f;
      dvec[hh] = r.in[hh] ? p.dvec[r.at[hh]] : 0.f;
    }
    const bool keyed =
        (!r.in[0] || lse[0] > 0.5f * NEG_BIG) && (!r.in[1] || lse[1] > 0.5f * NEG_BIG);
    const bool tile_keyed = __syncthreads_and(keyed);
    const bool warp_keyed = __all_sync(0xffffffffu, keyed);
    last = p.causal && tile_keyed ? min(nkt, max(rows_band(p, f0, f1), 0) / KT + 1) : nkt;
    const int wf0 = f0 + warp * 16;
    const int wband = wf0 < f1 ? rows_band(p, wf0, min(wf0 + 16, f1)) : -1;
    const int wfloor = wf0 < f1 ? rows_floor(p, wf0, min(wf0 + 16, f1)) : -1;
#pragma unroll
    for (int j = 1; j < NST - 1; ++j) load_stage(j);

    float dq[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) dq[n][u] = 0.f;
    for (int j = 0; j < last; ++j) {
      cp_async_wait<NST - 2>();
      __syncthreads();  // stage j is in; stage j − 1's slot is read by no one
      load_stage(j + NST - 1);
      if (p.causal && j * KT > wband && warp_keyed) continue;
      const float* Kt = Ks + (j % NST) * KT * LD;
      const float* Vt = Vs + (j % NST) * KT * LD;
      float s[KT / 8][4], dp[KT / 8][4];
      warp_products<D, KT, fresh_products(D)>(s, Qs + warp * 16 * LD, Kt);
      warp_products<D, KT, fresh_products(D)>(dp, dOs + warp * 16 * LD, Vt);
      // rows are independent in dQ, so a row past the plane's (lse 0, not
      // written) needs no care on the unmasked path
      const bool plain = unmasked(p, j * KT, (j + 1) * KT, wfloor);
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int hh = u >> 1, col = j * KT + n * 8 + 2 * c4 + (u & 1);
          const float pr =
              plain ? expf(s[n][u] * p.scale - lse[hh])
                    : (r.in[hh] && col < p.skv
                           ? expf(masked_score(p, r, hh, s[n][u], col) - lse[hh])
                           : 0.f);
          float d = dp[n][u];
          if (p.dropout) d *= keep_scale(p, r.row[hh], col, r.plane[hh]);
          s[n][u] = pr * (d - dvec[hh]);
        }
      warp_pv<LD, D, KT, fresh_grads(D)>(dq, s, Kt);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (!r.in[hh]) continue;
      float* dst = p.dq + r.at[hh] * D + 2 * c4;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(dst + n * 8) =
            make_float2(dq[n][2 * hh] * p.scale, dq[n][2 * hh + 1] * p.scale);
    }
  }
}

// dK/dV.  Grid (G groups, ⌈skv / keys⌉ key tiles, b·hk K/V planes);
// F32_WARPS warps; keys = dkv_keys(D).  A block holds one key tile's K and V
// (warp w: keys 16·(w / split)..+15, dims (w % split)·D / split..) and
// walks group g's share [g·T/G, (g+1)·T/G) of the plane's T = nh·⌈sq/32⌉
// query tiles (32 rows of one head; nh = h if hk = 1 else 1), each with
// its lse and D copied by cp.async into a double buffer under the previous
// tile.  Per pair: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (16 keys × 32 rows) once; bias,
// mask, exp(s − lse), the hash and dS there; then dV += p̃ᵀ·dO and dK +=
// dSᵀ·Q from the accumulators, dK/dV in registers over the block's tiles
// (multi-query heads summed).  For G = 1 the block writes dK (× scale) and
// dV, else f32 partials [dK: G][planes][skv][D] then dV, summed in group
// order by flash_bwd_reduce_f32_kernel.  The band: under causal a query
// tile whose last row sees no key of the tile is skipped, unless its first
// row sees no key at all (sq > skv: it averages over every key); with a
// bias, which can leave any row keyless, the block first reads the lse of
// the tiles it would skip and walks all of its tiles if one of them holds a
// keyless row.  A warp whose 16 keys lie past the band of a tile in which
// every row saw a key adds nothing there and skips it.
template <int D>
__global__ void __launch_bounds__(F32_WARPS * 32) flash_bwd_dkv_f32_kernel(Params32 p) {
  constexpr int LD = D + 4, SPLIT = dkv_split(D), DH = D / SPLIT, RW = F32_DKV_ROWS;
  constexpr int NK = dkv_keys(D), NST = F32_STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);  // [NK][LD]
  float* Vs = Ks + NK * LD;                     // [NK][LD]
  float* Qs = Vs + NK * LD;                     // [NST][RW][LD]
  float* dOs = Qs + NST * RW * LD;              // [NST][RW][LD]
  float* lse_s = dOs + NST * RW * LD;           // [NST][RW]
  float* dvec_s = lse_s + NST * RW;             // [NST][RW]

  const int grp = blockIdx.x, groups = gridDim.x, kvp = blockIdx.z;
  const int k0 = blockIdx.y * NK;
  const int bi = p.hk == 1 ? kvp : kvp / p.h;
  const int h0 = p.hk == 1 ? 0 : kvp % p.h, nh = p.hk == 1 ? p.h : 1;
  const int nqt = (p.sq + RW - 1) / RW, ntiles = nh * nqt;
  const int t0 = (int)((long long)grp * ntiles / groups);
  const int t1 = (int)((long long)(grp + 1) * ntiles / groups);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c4 = lane % 4;
  const int kv0 = (warp / SPLIT) * 16, d0 = (warp % SPLIT) * DH;

  // query tile t needs these keys unless causal hides all of them from
  // every row of it, each of which sees some key
  auto band_needed = [&](int t) {
    const int q0 = (t % nqt) * RW, last = min(q0 + RW, p.sq) - 1;
    return !p.causal || q0 + p.skv - p.sq < 0 || last + p.skv - p.sq >= k0;
  };
  bool all = !p.causal;
  if (p.causal && p.bias != nullptr) {
    int keyless = 0;
    for (int x = threadIdx.x; x < (t1 - t0) * RW; x += blockDim.x) {
      const int t = t0 + x / RW, row = (t % nqt) * RW + x % RW;
      if (row < p.sq && !band_needed(t))
        keyless |= p.lse[(size_t)(bi * p.h + h0 + t / nqt) * p.sq + row] <= 0.5f * NEG_BIG;
    }
    all = __syncthreads_or(keyless);
  }
  auto next_tile = [&](int t) {
    while (t < t1 && !all && !band_needed(t)) ++t;
    return t;
  };
  // Q, dO, lse and D of query tile t (if below t1) into ring slot st,
  // zeros past sq; one commit group a tile
  auto load_tile = [&](int st, int t) {
    const int bh = bi * p.h + h0 + t / nqt, q0 = (t % nqt) * RW;
    if (t >= t1) {
      cp_async_commit();
      return;
    }
    load_rows<D>(Qs + st * RW * LD, p.q, (size_t)bh * p.sq, q0, p.sq, RW);
    load_rows<D>(dOs + st * RW * LD, p.dout, (size_t)bh * p.sq, q0, p.sq, RW);
    for (int i = threadIdx.x; i < 2 * RW; i += blockDim.x) {
      const int rr = i % RW;
      const bool in = q0 + rr < p.sq;
      const size_t off = (size_t)bh * p.sq + (in ? q0 + rr : 0);
      if (i < RW)
        cp_async4(lse_s + st * RW + rr, p.lse + off, in);
      else
        cp_async4(dvec_s + st * RW + rr, p.dvec + off, in);
    }
    cp_async_commit();
  };

  // the key tile with the first query tile; then NST − 2 more ahead
  load_rows<D>(Ks, p.k, (size_t)kvp * p.skv, k0, p.skv, NK);
  load_rows<D>(Vs, p.v, (size_t)kvp * p.skv, k0, p.skv, NK);
  int t = next_tile(t0), tl = t;
  load_tile(0, tl);
#pragma unroll
  for (int j = 1; j < NST - 1; ++j) {
    tl = next_tile(min(tl + 1, t1));
    load_tile(j, tl);
  }

  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int u = 0; u < 4; ++u) dk[n][u] = dv[n][u] = 0.f;

  for (int i = 0; t < t1; ++i) {
    const int st = i % NST;
    cp_async_wait<NST - 2>();
    __syncthreads();  // tile t is in; the previous tile's slot is read by no one
    tl = next_tile(min(tl + 1, t1));
    load_tile((i + NST - 1) % NST, tl);
    const int hi = h0 + t / nqt, q0 = (t % nqt) * RW;
    const float* bias = p.bias ? p.bias + bi * p.bsb + hi * p.bsh : nullptr;
    const float* Qt = Qs + st * RW * LD;
    const float* dOt = dOs + st * RW * LD;
    const float* lt = lse_s + st * RW;
    const float* dt = dvec_s + st * RW;
    const bool keyed = __all_sync(0xffffffffu, q0 + lane >= p.sq || lt[lane] > 0.5f * NEG_BIG);
    const int last = min(q0 + RW, p.sq) - 1;
    if (!(p.causal && keyed && last + p.skv - p.sq < k0 + kv0)) {
      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: this warp's 16 keys × the tile's 32 rows
      float sa[RW / 8][4], pa[RW / 8][4];
      warp_products<D, RW, fresh_products(D)>(sa, Ks + kv0 * LD, Qt);
      warp_products<D, RW, fresh_products(D)>(pa, Vs + kv0 * LD, dOt);
      // p̃ (into sa) and dS (into pa) at (key k0 + kv0 + g [+ 8], row q0 +
      // 8n + 2·c4 [+ 1])
#pragma unroll
      for (int n = 0; n < RW / 8; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int col = k0 + kv0 + g + 8 * (u >> 1);
          const int rr = n * 8 + 2 * c4 + (u & 1), row = q0 + rr;
          float pr = 0.f;
          if (row < p.sq && col < p.skv) {
            float sc = sa[n][u] * p.scale;
            if (bias != nullptr) sc += fmaxf(bias[row * p.bsr + col], NEG_BIG);
            if (p.causal && col > row + p.skv - p.sq) sc = NEG_BIG;
            pr = expf(sc - lt[rr]);
          }
          float dp = pa[n][u];
          if (p.dropout) {
            const float ks = keep_scale(p, row, col, hash_plane(p, bi, hi));
            dp *= ks;
            sa[n][u] = pr * ks;
          } else {
            sa[n][u] = pr;
          }
          pa[n][u] = pr * (dp - dt[rr]);
        }
      // dV += p̃ᵀ·dO and dK += dSᵀ·Q over this warp's dims
      warp_pv<LD, DH, RW, fresh_grads(D)>(dv, sa, dOt + d0);
      warp_pv<LD, DH, RW, fresh_grads(D)>(dk, pa, Qt + d0);
    }
    t = next_tile(t + 1);
  }

  // this warp's keys and dims of dK (scaled) and dV: whole when the block
  // is its key tile's only group, else f32 partials
  const size_t plane_elems = (size_t)gridDim.z * p.skv * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = k0 + kv0 + g + 8 * hh;
    if (key >= p.skv) continue;
    const size_t at = ((size_t)kvp * p.skv + key) * D + d0 + 2 * c4;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      float* pk = groups == 1 ? p.dk + at + n * 8 : p.part + grp * plane_elems + at + n * 8;
      float* pv = groups == 1 ? p.dv + at + n * 8 : pk + groups * plane_elems;
      const float m = groups == 1 ? p.scale : 1.f;
      *reinterpret_cast<float2*>(pk) = make_float2(dk[n][2 * hh] * m, dk[n][2 * hh + 1] * m);
      *reinterpret_cast<float2*>(pv) = make_float2(dv[n][2 * hh], dv[n][2 * hh + 1]);
    }
  }
}

// dK = scale·Σ_g part_dK[g], dV = Σ_g part_dV[g], summed in group order;
// ``elems`` = planes·skv·D (a multiple of 4), four elements a thread.
__global__ void __launch_bounds__(256) flash_bwd_reduce_f32_kernel(const float* part, float* dk,
                                                                   float* dv, int groups,
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
  *reinterpret_cast<float4*>((is_v ? dv : dk) + j) =
      make_float4(s.x * m, s.y * m, s.z * m, s.w * m);
}

// -- launches ----------------------------------------------------------------

template <typename K>
int launch(K kernel, size_t smem, dim3 grid, const Params32& p, void* stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, F32_WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_fwd(const Params32& p, int groups, void* stream) {
  return launch(flash_fwd_f32_kernel<D>, fwd_smem(D), dim3(groups, p.b * p.hk), p, stream);
}

// The dK/dV kernel with ``groups`` blocks a (plane, key tile), the dQ
// kernel with ``dq_groups`` a plane; then, for groups > 1, the group sums.
template <int D>
int launch_bwd(const Params32& p, int groups, int dq_groups, void* stream) {
  const int nkt = (p.skv + dkv_keys(D) - 1) / dkv_keys(D);
  if (nkt > 65535) return (int)cudaErrorInvalidValue;
  int err = launch(flash_bwd_dkv_f32_kernel<D>, dkv_smem(D), dim3(groups, nkt, p.b * p.hk), p,
                   stream);
  if (err == 0)
    err = launch(flash_bwd_dq_f32_kernel<D>, dq_smem(D), dim3(dq_groups, p.b * p.hk), p, stream);
  if (err != 0 || groups == 1) return err;
  const long long elems = (long long)p.b * p.hk * p.skv * D;
  const long long blocks = (2 * elems / 4 + 255) / 256;
  flash_bwd_reduce_f32_kernel<<<(unsigned)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      p.part, p.dk, p.dv, groups, elems, p.scale);
  return (int)cudaGetLastError();
}

Params32 make_params(const void* q, const void* k, const void* v, const void* bias, long long bsb,
                     long long bsh, long long bsr, int b, int h, int hk, int sq, int skv,
                     int causal, float scale, int dropout, unsigned seed, unsigned threshold,
                     float inv_keep, int plane_h, int plane_off) {
  Params32 p = {};
  p.plane_h = plane_h;
  p.plane_off = plane_off;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
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

bool valid(int b, int h, int hk, int sq, int skv, int groups) {
  return b > 0 && h > 0 && sq > 0 && skv > 0 && (hk == 1 || hk == h) && groups > 0 &&
         groups <= 65535 && b * hk <= 65535;
}

}  // namespace

// Out (b, h, sq, d) and lse (b, h, sq) of one f32 forward call, ``groups``
// blocks a K/V plane.
extern "C" int flash_fwd_f32_launch(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int groups, I2T_FLASH_ARGS) {
  if (!valid(b, h, hk, sq, skv, groups)) return (int)cudaErrorInvalidValue;
  Params32 p = I2T_FLASH_PARAMS;
  p.o = static_cast<float*>(o);
  p.lse_out = static_cast<float*>(lse);
#define FWD(D) return launch_fwd<D>(p, groups, stream)
  I2T_DISPATCH(FWD)
#undef FWD
}

// dQ, dK and dV of one f32 backward call: ``groups`` dK/dV blocks a (K/V
// plane, key tile), ``dq_groups`` dQ blocks a K/V plane.  For groups > 1
// ``part`` holds 2·groups·b·hk·skv·d f32 partials, summed by a second
// kernel.
extern "C" int flash_bwd_f32_launch(const void* q, const void* k, const void* v, const void* dout,
                                    const void* lse, const void* dvec, void* dq, void* dk,
                                    void* dv, void* part, int groups, int dq_groups,
                                    I2T_FLASH_ARGS) {
  if (!valid(b, h, hk, sq, skv, groups) || dq_groups < 1 || dq_groups > 65535 ||
      (groups > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  Params32 p = I2T_FLASH_PARAMS;
  p.dout = static_cast<const float*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.dvec = static_cast<const float*>(dvec);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.part = static_cast<float*>(part);
#define BWD(D) return launch_bwd<D>(p, groups, dq_groups, stream)
  I2T_DISPATCH(BWD)
#undef BWD
}
