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
// Forward, tiled (skv > 160, or head dim 256): the resident forward's
// folded rows, register scores and A-fragment reuse, with a loop over K/V
// stages (64 keys; 32 past d 64) through a two-stage cp.async ring and the
// online softmax of FlashAttention-2 rescaling O in registers.  A block of
// four warps takes 64-row tiles of a plane, G blocks a plane (the host's
// fwd_plan), so one K/V stage serves every head that shares it; the causal
// band is skipped on the device from the running row max, under a bias too.
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
// from this file).
//
// Backward, tiled (skv > 160, or head dim 256: K/V do not fit a block):
// two kernels and the group sums.  dK/dV: a block holds a 64-key tile and
// walks its group's share of the plane's 32-row query tiles (G groups a
// key tile from bwd_plan, so that a multi-query plane's few key tiles still
// fill the card), Sᵀ and dPᵀ once per pair in registers as the resident
// backward computes them, f32 partials summed in group order.  dQ: the
// tiled forward's grid and K/V ring, S and dP again in registers, dQ = dS·K
// written whole.  Both skip the causal band from the saved lse.
//
// No float atomics anywhere: every output element is written by one block
// (partials summed in a fixed order).  Key columns past skv take no part
// (p = 0); query rows past sq are computed on zeros and not written.  A row
// that sees no key at all gets the uniform average over all skv keys (its
// scores are all NEG_BIG).
#include "flash_common.cuh"

using namespace i2t;

namespace {

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
  float* part;  // f32 dK/dV partials of a backward's groups
  int* pairs;   // if set, the backward adds its visited pairs
  int b, h, hk, sq, skv;
  int causal;
  float scale;
  int dropout;
  unsigned seed, threshold;
  float inv_keep;
  int plane_h, plane_off;  // the hash's plane of (batch i, head j): plane_off + i·plane_h + j
};

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
            const float ks = keep_scale(p, row, col, hash_plane(p, bi, hi));
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
      plane[hh] = hash_plane(p, bi, head);
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

// ------------------------------------------------- tiled route
// Past the resident kernels' 160 keys, and at head dim 256.  The host's
// plans (ops/flash_attention.py::fwd_plan, bwd_plan, tiled_bwd_pairs) read
// TILE_ROWS, TILE_KEYS, DKV_KEYS and DKV_ROWS from this file.
constexpr int TILE_WARPS = 4;  // warps of a forward or dQ block
constexpr int TILE_ROWS = 64;  // folded query rows of their tiles: 16 a warp
constexpr int TILE_KEYS = 64;  // keys of their K/V stages (tile_keys, fwd_keys: fewer)
constexpr int TILE_STAGES = 2; // stages of their K/V ring
constexpr int DKV_KEYS = 64;   // keys of a dK/dV block: 16 a warp (a warp pair at d 256)
constexpr int DKV_ROWS = 32;   // query rows of a dK/dV block's tiles
constexpr int DKV_STAGES = 2;  // stages of its Q/dO ring
static_assert(TILE_ROWS == 16 * TILE_WARPS && DKV_ROWS == 32, "a warp's 16 rows; a lane a row");
// (Three or four stages, and 128-key stages, measured no faster at the
// families' shapes on the H100.)

__host__ __device__ constexpr int tile_keys(int d) { return d > 128 ? TILE_KEYS / 2 : TILE_KEYS; }
// The forward's K/V stages hold 32 keys past head dim 64, and it asks the
// register allocator for four blocks an SM up to head dim 64 (128
// registers a thread, 48 bytes spilled) and three at 128: at the
// families' shapes that took 7–9% less device time at d 64 than three
// blocks, and 24% less at d 128 than 64-key stages at two blocks
// (probes/flash_variants.py on the H100).
__host__ __device__ constexpr int fwd_keys(int d) { return d > 64 ? TILE_KEYS / 2 : TILE_KEYS; }
__host__ __device__ constexpr int fwd_min_blocks(int d) { return d > 128 ? 1 : d > 64 ? 3 : 4; }
// dK/dV: a warp holds 16 keys × at most 128 dims of both accumulators, so
// at d 256 two warps share 16 keys, each half of the dims
__host__ __device__ constexpr int dkv_split(int d) { return d > 128 ? 2 : 1; }

constexpr size_t fwd_tiled_smem(int d) {  // Q; K and V of each stage
  return (size_t)(TILE_ROWS + 2 * TILE_STAGES * fwd_keys(d)) * (d + 8) * sizeof(bf16);
}
constexpr size_t dq_tiled_smem(int d) {  // Q, dO; K and V of each stage
  return (size_t)(2 * TILE_ROWS + 2 * TILE_STAGES * tile_keys(d)) * (d + 8) * sizeof(bf16);
}
constexpr size_t dkv_tiled_smem(int d) {  // K, V; Q, dO, lse and D of each stage
  return (size_t)(2 * DKV_KEYS + 2 * DKV_STAGES * DKV_ROWS) * (d + 8) * sizeof(bf16) +
         2 * DKV_STAGES * DKV_ROWS * sizeof(float);
}
static_assert(dq_tiled_smem(256) + 1024 <= SM_SMEM && dkv_tiled_smem(256) + 1024 <= SM_SMEM,
              "a tiled block fits an SM at head dim 256");
static_assert(fwd_min_blocks(64) * (fwd_tiled_smem(64) + 1024) <= SM_SMEM &&
                  fwd_min_blocks(128) * (fwd_tiled_smem(128) + 1024) <= SM_SMEM,
              "the forward's blocks an SM fit its shared memory");

// One warp's 16 × KT products of A (16 rows from A0, row stride D + 8) with
// the KT rows of B: c[n] holds columns 8n..8n+7 (mma.sync accumulators).
template <int D, int KT>
__device__ __forceinline__ void warp_scores(float (&c)[KT / 8][4], const bf16* A0,
                                            const bf16* B) {
  constexpr int LD = D + 8;
  const int lane = threadIdx.x % 32;
  const int ar = (lane % 8) + ((lane / 8) % 2) * 8, ac = (lane / 16) * 8;
  const int br = (lane % 8) + (lane / 16) * 8, bc = ((lane / 8) % 2) * 8;
#pragma unroll
  for (int n = 0; n < KT / 8; ++n)
#pragma unroll
    for (int u = 0; u < 4; ++u) c[n][u] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, A0 + ar * LD + kk * 16 + ac);
#pragma unroll
    for (int n = 0; n < KT / 16; ++n) {
      uint32_t bk[4];
      ldsm_x4(bk, B + (n * 16 + br) * LD + kk * 16 + bc);
      mma16816(c[2 * n], a, bk[0], bk[1]);
      mma16816(c[2 * n + 1], a, bk[2], bk[3]);
    }
  }
}

// acc (16 × D) += P (16 × KT, f32 registers rounded to bf16 A fragments) ·
// B (a row-major (KT, D) stage).
template <int D, int KT>
__device__ __forceinline__ void warp_pv(float (&acc)[D / 8][4], const float (&pr)[KT / 8][4],
                                        const bf16* B) {
  constexpr int LD = D + 8;
  const int lane = threadIdx.x % 32;
  const int ar = (lane % 8) + ((lane / 8) % 2) * 8, ac = (lane / 16) * 8;
#pragma unroll
  for (int kq = 0; kq < KT / 16; ++kq) {
    const uint32_t a[4] = {pack_bf2(pr[2 * kq][0], pr[2 * kq][1]),
                           pack_bf2(pr[2 * kq][2], pr[2 * kq][3]),
                           pack_bf2(pr[2 * kq + 1][0], pr[2 * kq + 1][1]),
                           pack_bf2(pr[2 * kq + 1][2], pr[2 * kq + 1][3])};
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      uint32_t bv[4];
      ldsm_x4_t(bv, B + (kq * 16 + ar) * LD + n * 16 + ac);
      mma16816(acc[2 * n], a, bv[0], bv[1]);
      mma16816(acc[2 * n + 1], a, bv[2], bv[3]);
    }
  }
}

// Forward, tiled.  Grid (G groups, b·hk K/V planes); TILE_WARPS warps.
// Group g of a plane takes its TILE_ROWS-row tiles [g·T/G, (g+1)·T/G) of
// the folded rows (T = ⌈nrows / TILE_ROWS⌉) one after another, warp w rows
// 16w..16w+15 of each.  The block streams the plane's K/V through a
// two-stage cp.async ring of KT-key stages, the copy of stage j + 1 under
// the products of stage j, one block barrier a stage.  A warp's S = Q·Kᵀ
// (16 × KT) is in registers, every lane knowing its (row, col); the online
// softmax (FlashAttention-2) rescales O and the row sums there, p̃ = p·keep
// feeds P̃·V as A fragments, and O (16 × D) accumulates in registers.  A
// causal tile stops at the band of its last row once every row in it holds
// a max above NEG_BIG / 2 (past the band p = exp(NEG_BIG − m) = 0); a tile
// with a keyless row streams every stage.  A warp whose rows all saw a key
// skips the stages past its own band (they would add exact zeros), and a
// stage inside the band of all its rows, with no bias, takes the scale
// alone.  The exponentials are __expf (ex2.approx: 2 ulp; exact 1 at 0 and
// 0 at −inf, so the NEG_BIG rules hold).
template <int D>
__global__ void __launch_bounds__(TILE_WARPS * 32, fwd_min_blocks(D))
    flash_fwd_tiled_kernel(Params p) {
  constexpr int LD = D + 8, KT = fwd_keys(D), NST = TILE_STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [TILE_ROWS][LD]
  bf16* Ks = Qs + TILE_ROWS * LD;             // [NST][KT][LD]
  bf16* Vs = Ks + NST * KT * LD;              // [NST][KT][LD]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c4 = lane % 4;
  const int kvp = blockIdx.y, grp = blockIdx.x, groups = gridDim.x;
  const Plane pl = plane_of(p, kvp);
  const size_t kvbase = (size_t)kvp * p.skv;
  const int ntiles = (pl.nrows + TILE_ROWS - 1) / TILE_ROWS, nkt = (p.skv + KT - 1) / KT;
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
    const int f0 = t * TILE_ROWS, f1 = min(f0 + TILE_ROWS, pl.nrows);
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the previous tile's Q and stages
    load_rows<D>(Qs, p.q, pl.base, f0, pl.nrows, TILE_ROWS);
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
      const bf16* Kt = Ks + (j % NST) * KT * LD;
      const bf16* Vt = Vs + (j % NST) * KT * LD;
      float s[KT / 8][4];
      warp_scores<D, KT>(s, Qs + warp * 16 * LD, Kt);
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
        const float alpha = __expf(fmaxf(m[hh], NEG_BIG) - ms[hh]);
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
          float pr = __expf(s[n][u] - ms[hh]);
          l[hh] += pr;
          if (p.dropout)
            pr *= keep_scale(p, r.row[hh], j * KT + n * 8 + 2 * c4 + (u & 1), r.plane[hh]);
          s[n][u] = pr;
        }
      warp_pv<D, KT>(o, s, Vt);
    }
    // O / l as bf16 and lse, rows past the plane's not written
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
      if (!r.in[hh]) continue;
      const float lc = fmaxf(l[hh], 1e-30f);
      bf16* dst = p.o + r.at[hh] * D + 2 * c4;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(dst + n * 8) =
            pack_bf2(o[n][2 * hh] / lc, o[n][2 * hh + 1] / lc);
      if (c4 == 0) p.lse_out[r.at[hh]] = fmaxf(m[hh], NEG_BIG) + logf(lc);
    }
  }
}

// Backward dQ, tiled: the forward's grid, tiles and K/V ring.  A warp
// computes S = Q·Kᵀ and dP = dO·Vᵀ (16 × KT) in registers, p = exp(s −
// lse) and dS = p·(keep·dP − D) there, and dQ += dS·K with dS as A
// fragments; a block sees every key of its rows, so it writes dQ whole (×
// scale).  A causal tile stops at its last row's band when every row in it
// saw a key (lse > NEG_BIG / 2, saved by the forward), else streams every
// stage; a warp whose rows all saw a key skips the stages past its band,
// and as in the forward an unmasked stage takes the scale alone.
template <int D>
__global__ void __launch_bounds__(TILE_WARPS * 32) flash_bwd_dq_tiled_kernel(Params p) {
  constexpr int LD = D + 8, KT = tile_keys(D), NST = TILE_STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [TILE_ROWS][LD]
  bf16* dOs = Qs + TILE_ROWS * LD;            // [TILE_ROWS][LD]
  bf16* Ks = dOs + TILE_ROWS * LD;            // [NST][KT][LD]
  bf16* Vs = Ks + NST * KT * LD;              // [NST][KT][LD]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c4 = lane % 4;
  const int kvp = blockIdx.y, grp = blockIdx.x, groups = gridDim.x;
  const Plane pl = plane_of(p, kvp);
  const size_t kvbase = (size_t)kvp * p.skv;
  const int ntiles = (pl.nrows + TILE_ROWS - 1) / TILE_ROWS, nkt = (p.skv + KT - 1) / KT;
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
    const int f0 = t * TILE_ROWS, f1 = min(f0 + TILE_ROWS, pl.nrows);
    cp_async_wait<0>();
    __syncthreads();
    load_rows<D>(Qs, p.q, pl.base, f0, pl.nrows, TILE_ROWS);
    load_rows<D>(dOs, p.dout, pl.base, f0, pl.nrows, TILE_ROWS);
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
      const bf16* Kt = Ks + (j % NST) * KT * LD;
      const bf16* Vt = Vs + (j % NST) * KT * LD;
      float s[KT / 8][4], dp[KT / 8][4];
      warp_scores<D, KT>(s, Qs + warp * 16 * LD, Kt);
      warp_scores<D, KT>(dp, dOs + warp * 16 * LD, Vt);
      // rows are independent in dQ, so a row past the plane's (lse 0, not
      // written) needs no care on the unmasked path
      const bool plain = unmasked(p, j * KT, (j + 1) * KT, wfloor);
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int hh = u >> 1, col = j * KT + n * 8 + 2 * c4 + (u & 1);
          const float pr =
              plain ? __expf(s[n][u] * p.scale - lse[hh])
                    : (r.in[hh] && col < p.skv
                           ? __expf(masked_score(p, r, hh, s[n][u], col) - lse[hh])
                           : 0.f);
          float d = dp[n][u];
          if (p.dropout) d *= keep_scale(p, r.row[hh], col, r.plane[hh]);
          s[n][u] = pr * (d - dvec[hh]);
        }
      warp_pv<D, KT>(dq, s, Kt);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (!r.in[hh]) continue;
      bf16* dst = p.dq + r.at[hh] * D + 2 * c4;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(dst + n * 8) =
            pack_bf2(dq[n][2 * hh] * p.scale, dq[n][2 * hh + 1] * p.scale);
    }
  }
}

// Backward dK/dV, tiled.  Grid (G groups, ⌈skv / DKV_KEYS⌉ key tiles, b·hk
// K/V planes); 4·dkv_split(D) warps.  A block holds one key tile's K and V
// (warp w: keys 16·(w / split)..+15, dims (w % split)·D / split..) and
// walks group g's share [g·T/G, (g+1)·T/G) of the plane's T = nh·⌈sq/32⌉
// query tiles (32 rows of one head; nh = h if hk = 1 else 1), each with
// its lse and D copied by cp.async into a double buffer under the previous
// tile.  Per pair, the resident backward's work in registers: Sᵀ = K·Qᵀ and
// dPᵀ = V·dOᵀ (16 keys × 32 rows) once; bias, mask, exp(s − lse), the hash
// and dS there; then dV += p̃ᵀ·dO and dK += dSᵀ·Q from the accumulators,
// dK/dV in registers over the block's tiles (multi-query heads summed).
// For G = 1 the block writes bf16 dK/dV, else f32 partials [dK: G][planes]
// [skv][D] then dV, summed in group order by flash_bwd_reduce_kernel.  The
// band: under causal a query tile whose last row sees no key of the tile
// is skipped, unless its first row sees no key at all (sq > skv: it
// averages over every key); with a bias, which can leave any row keyless,
// the block first reads the lse of the tiles it would skip and walks all
// of its tiles if one of them holds a keyless row.  A warp whose 16 keys
// lie past the band of a tile in which every row saw a key adds nothing
// there and skips it.  ``pairs`` counts the (query tile, key tile) pairs.
template <int D>
__global__ void __launch_bounds__(4 * dkv_split(D) * 32) flash_bwd_dkv_tiled_kernel(Params p) {
  constexpr int LD = D + 8, SPLIT = dkv_split(D), DH = D / SPLIT, RW = DKV_ROWS;
  constexpr int NST = DKV_STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);                    // [DKV_KEYS][LD]
  bf16* Vs = Ks + DKV_KEYS * LD;                                // [DKV_KEYS][LD]
  bf16* Qs = Vs + DKV_KEYS * LD;                                  // [NST][RW][LD]
  bf16* dOs = Qs + NST * RW * LD;                                 // [NST][RW][LD]
  float* lse_s = reinterpret_cast<float*>(dOs + NST * RW * LD);  // [NST][RW]
  float* dvec_s = lse_s + NST * RW;                               // [NST][RW]

  const int grp = blockIdx.x, groups = gridDim.x, kvp = blockIdx.z;
  const int k0 = blockIdx.y * DKV_KEYS;
  const int bi = p.hk == 1 ? kvp : kvp / p.h;
  const int h0 = p.hk == 1 ? 0 : kvp % p.h, nh = p.hk == 1 ? p.h : 1;
  const int nqt = (p.sq + RW - 1) / RW, ntiles = nh * nqt;
  const int t0 = (int)((long long)grp * ntiles / groups);
  const int t1 = (int)((long long)(grp + 1) * ntiles / groups);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c4 = lane % 4;
  const int kv0 = (warp / SPLIT) * 16, d0 = (warp % SPLIT) * DH;
  // ldmatrix lane addresses: A from a row-major (m, k) tile, and B
  // (.trans) from a row-major (k, n) tile; B from an (n, k) tile
  const int ar = (lane % 8) + ((lane / 8) % 2) * 8, ac = (lane / 16) * 8;
  const int br = (lane % 8) + (lane / 16) * 8, bc = ((lane / 8) % 2) * 8;

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
  load_rows<D>(Ks, p.k, (size_t)kvp * p.skv, k0, p.skv, DKV_KEYS);
  load_rows<D>(Vs, p.v, (size_t)kvp * p.skv, k0, p.skv, DKV_KEYS);
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
    if (p.pairs != nullptr && threadIdx.x == 0) atomicAdd(p.pairs, 1);
    const int hi = h0 + t / nqt, q0 = (t % nqt) * RW;
    const float* bias = p.bias ? p.bias + bi * p.bsb + hi * p.bsh : nullptr;
    const bf16* Qt = Qs + st * RW * LD;
    const bf16* dOt = dOs + st * RW * LD;
    const float* lt = lse_s + st * RW;
    const float* dt = dvec_s + st * RW;
    const bool keyed = __all_sync(0xffffffffu, q0 + lane >= p.sq || lt[lane] > 0.5f * NEG_BIG);
    const int last = min(q0 + RW, p.sq) - 1;
    if (!(p.causal && keyed && last + p.skv - p.sq < k0 + kv0)) {
      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: this warp's 16 keys × the tile's 32 rows
      float sa[RW / 8][4], pa[RW / 8][4];
#pragma unroll
      for (int n = 0; n < RW / 8; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) sa[n][u] = pa[n][u] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        ldsm_x4(ak, Ks + (kv0 + ar) * LD + kk * 16 + ac);
        ldsm_x4(av, Vs + (kv0 + ar) * LD + kk * 16 + ac);
#pragma unroll
        for (int n = 0; n < RW / 16; ++n) {
          uint32_t bq[4], bo[4];
          ldsm_x4(bq, Qt + (n * 16 + br) * LD + kk * 16 + bc);
          ldsm_x4(bo, dOt + (n * 16 + br) * LD + kk * 16 + bc);
          mma16816(sa[2 * n], ak, bq[0], bq[1]);
          mma16816(sa[2 * n + 1], ak, bq[2], bq[3]);
          mma16816(pa[2 * n], av, bo[0], bo[1]);
          mma16816(pa[2 * n + 1], av, bo[2], bo[3]);
        }
      }
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
      // dV += p̃ᵀ·dO and dK += dSᵀ·Q over this warp's dims, A fragments
      // from the accumulators
#pragma unroll
      for (int kq = 0; kq < RW / 16; ++kq) {
        const uint32_t ap[4] = {pack_bf2(sa[2 * kq][0], sa[2 * kq][1]),
                                pack_bf2(sa[2 * kq][2], sa[2 * kq][3]),
                                pack_bf2(sa[2 * kq + 1][0], sa[2 * kq + 1][1]),
                                pack_bf2(sa[2 * kq + 1][2], sa[2 * kq + 1][3])};
        const uint32_t as[4] = {pack_bf2(pa[2 * kq][0], pa[2 * kq][1]),
                                pack_bf2(pa[2 * kq][2], pa[2 * kq][3]),
                                pack_bf2(pa[2 * kq + 1][0], pa[2 * kq + 1][1]),
                                pack_bf2(pa[2 * kq + 1][2], pa[2 * kq + 1][3])};
#pragma unroll
        for (int n = 0; n < DH / 16; ++n) {
          uint32_t bo[4], bq[4];
          ldsm_x4_t(bo, dOt + (kq * 16 + ar) * LD + d0 + n * 16 + ac);
          ldsm_x4_t(bq, Qt + (kq * 16 + ar) * LD + d0 + n * 16 + ac);
          mma16816(dv[2 * n], ap, bo[0], bo[1]);
          mma16816(dv[2 * n + 1], ap, bo[2], bo[3]);
          mma16816(dk[2 * n], as, bq[0], bq[1]);
          mma16816(dk[2 * n + 1], as, bq[2], bq[3]);
        }
      }
    }
    t = next_tile(t + 1);
  }

  // this warp's keys and dims of dK (scaled) and dV: bf16 when the block
  // is its key tile's only group, else f32 partials
  const size_t plane_elems = (size_t)gridDim.z * p.skv * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = k0 + kv0 + g + 8 * hh;
    if (key >= p.skv) continue;
    const size_t at = ((size_t)kvp * p.skv + key) * D + d0 + 2 * c4;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
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

Params make_params(const void* q, const void* k, const void* v, const void* bias,
                   long long bsb, long long bsh, long long bsr, int b, int h, int hk, int sq,
                   int skv, int causal, float scale, int dropout, unsigned seed,
                   unsigned threshold, float inv_keep, int plane_h, int plane_off) {
  Params p = {};
  p.plane_h = plane_h;
  p.plane_off = plane_off;
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
int launch(Kernel kernel, size_t smem, dim3 grid, const Params& p, void* stream, int threads) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// dK = scale·Σ part_dK, dV = Σ part_dV over ``groups`` groups, on the stream.
template <int D>
int launch_reduce(const Params& p, int groups, void* stream) {
  const long long elems = (long long)p.b * p.hk * p.skv * D;
  const long long threads = (2 * elems / 4 + 255) / 256;
  flash_bwd_reduce_kernel<<<(unsigned)threads, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      p.part, p.dk, p.dv, groups, elems, p.scale);
  return (int)cudaGetLastError();
}

// Routes of the entry points (ops/flash_attention.py::ROUTES).
constexpr int ROUTE_RESIDENT = 0, ROUTE_TILED = 1;

// The backward: the resident kernel with ``groups`` blocks a plane, or
// the tiled dK/dV kernel with ``groups`` blocks a (plane, key tile) and the
// tiled dQ kernel with ``dq_groups`` a plane; then, for groups > 1, the
// group sums.
template <int D>
int launch_bwd(const Params& p, int route, int groups, int dq_groups, void* stream) {
  if (groups < 1 || (groups > 1 && p.part == nullptr)) return (int)cudaErrorInvalidValue;
  int err;
  if (route == ROUTE_TILED) {
    const int nkt = (p.skv + DKV_KEYS - 1) / DKV_KEYS;
    if (dq_groups < 1 || nkt > 65535 || p.b * p.hk > 65535) return (int)cudaErrorInvalidValue;
    err = launch(flash_bwd_dkv_tiled_kernel<D>, dkv_tiled_smem(D), dim3(groups, nkt, p.b * p.hk),
                 p, stream, 4 * dkv_split(D) * 32);
    if (err == 0)
      err = launch(flash_bwd_dq_tiled_kernel<D>, dq_tiled_smem(D), dim3(dq_groups, p.b * p.hk),
                   p, stream, TILE_WARPS * 32);
  } else if constexpr (D > 128) {  // the resident kernels take d <= 128
    return (int)cudaErrorInvalidValue;
  } else {
    if (p.skv > SKV_MAX) return (int)cudaErrorInvalidValue;
    const int nw = (p.skv + KW - 1) / KW;
    err = launch(flash_bwd_kernel<D>, res_smem<D>(nw), dim3(groups, p.b * p.hk), p, stream,
                 32 * nw);
  }
  if (err != 0 || groups == 1) return err;
  return launch_reduce<D>(p, groups, stream);
}

// The forward: the resident or the tiled kernel, ``groups`` blocks a plane.
template <int D>
int launch_fwd(const Params& p, int route, int groups, void* stream) {
  if (route == ROUTE_TILED)
    return launch(flash_fwd_tiled_kernel<D>, fwd_tiled_smem(D), dim3(groups, p.b * p.hk), p,
                  stream, TILE_WARPS * 32);
  if constexpr (D > 128) {  // the resident kernels take d <= 128
    return (int)cudaErrorInvalidValue;
  } else {
    return launch(flash_fwd_res_kernel<D>, fwd_smem(D, p.skv), dim3(groups, p.b * p.hk), p,
                  stream, FWD_WARPS * 32);
  }
}

bool valid(int b, int h, int hk, int sq, int skv, int route, int groups) {
  return b > 0 && h > 0 && sq > 0 && skv > 0 && (hk == 1 || hk == h) && groups > 0 &&
         b * hk <= 65535 && (route == ROUTE_TILED || (route == ROUTE_RESIDENT && skv <= SKV_MAX));
}

}  // namespace

// Out and lse of one forward call: ``route`` 0, the K/V-resident kernel
// (skv <= SKV_MAX, d <= 128), or 1, the tiled kernel, with ``groups``
// blocks per K/V plane.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                void* lse, int route, int groups, I2T_FLASH_ARGS) {
  if (!valid(b, h, hk, sq, skv, route, groups)) return (int)cudaErrorInvalidValue;
  Params p = I2T_FLASH_PARAMS;
  p.o = static_cast<bf16*>(o);
  p.lse_out = static_cast<float*>(lse);
#define FWD(D) return launch_fwd<D>(p, route, groups, stream)
  I2T_DISPATCH(FWD)
#undef FWD
}

// dQ, dK and dV of one backward call: ``route`` 0, the K/V-resident kernel
// (skv <= SKV_MAX, d <= 128; ``groups`` blocks per K/V plane), or 1, the
// tiled kernels (``groups`` dK/dV blocks per K/V plane and key tile,
// ``dq_groups`` dQ blocks per K/V plane).  For groups > 1 ``part`` holds
// 2·groups·b·hk·skv·d f32 partials, summed by a second kernel.  ``pairs``
// (may be null) counts the visited pairs: (32-row query tile, 16-key
// slice) on the resident route, (32-row query tile, 64-key tile) on the
// tiled one.
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* dvec, void* dq, void* dk, void* dv,
                                void* part, void* pairs, int route, int groups, int dq_groups,
                                I2T_FLASH_ARGS) {
  if (!valid(b, h, hk, sq, skv, route, groups)) return (int)cudaErrorInvalidValue;
  Params p = I2T_FLASH_PARAMS;
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.dvec = static_cast<const float*>(dvec);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.part = static_cast<float*>(part);
  p.pairs = static_cast<int*>(pairs);
#define BWD(D) return launch_bwd<D>(p, route, groups, dq_groups, stream)
  I2T_DISPATCH(BWD)
#undef BWD
}
