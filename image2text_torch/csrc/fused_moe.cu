// Eval MoE FFN for Hopper (sm_90a): counterpart of
// image2text_tpu/ops/fused_moe.py::_ffn_kernel.
//
// y = MoELinear_2(gelu(MoELinear_1(LN?(x)))) [+ residual], where each
// MoELinear is: gate MLP gelu(x·g0w + g0b)·g1w + g1b → softmax(lg/√fin) in
// f32 → top-k gate values kept in place (lowest-index ties) → combine c;
// z = gelu(x·l1w + l1b) over the stacked low-rank experts; the output is
// (z ∘ expand(c))·l2w + c·l2b.  Every product accumulates in f32 and is
// rounded to bf16 at its output; bias adds and GELUs round to bf16.
//
// What bounds it on the H100.  At encoder rows (40,960 at hidden 2048):
// operations, about 1 MFLOP a row, 0.04 ms at the bf16 peak; but every
// block streams the FFN's ~1 MB of weights from L2, so the bytes each
// block moves per row decide how close it gets.  At decode rows (256 at
// hidden 4096): bytes, ~2.7 MB of weights and activations, under a
// microsecond of HBM time, so filling the card and the launch decide.
//
// Design.  A warp owns 16 rows and runs the whole chain on them with
// mma.sync m16n8k16 (bf16, f32 accumulators): the gates, top-k and combine
// of a row stay in its quad's registers, and the products' accumulator
// fragments turn into the next product's A fragments in registers, so the
// hidden-wide activation never leaves the SM.  The block's warps share
// the weights: every 64-row slab of [g0w | l1w] (64 x 96), l2w (64 x 64)
// and the l2b columns is brought once into shared memory by cp.async
// (double-buffered) and read by all warps through ldmatrix.  Two regimes,
// picked by the wrapper from the row count (ops/fused_moe.py::moe_regime):
//
// * many rows: a block of 4 warps owns 64 rows and runs everything: LN2
//   prologue, MoELinear 1, the hidden dimension in 64-wide chunks (each
//   chunk of gelu(hw·l2w + c·l2b) consumed at once by MoELinear 2's
//   96-wide accumulators), MoELinear 2's gate, the 64-column output chunks
//   and the residual.  Each byte of weight read from L2 serves 64 rows
//   (16 before).
// * few rows: the hidden dimension is split over blocks.  moe_split_kernel
//   (grid: row tiles x hidden slices, about 128 blocks at 256 rows)
//   recomputes MoELinear 1 for its rows, produces its hidden slice and
//   writes its part of MoELinear 2's 96-wide f32 accumulators to a scratch
//   buffer; moe_finish_kernel (grid: row tiles x column slices) sums the
//   parts in slice order, runs the gate, top-k and combine and its columns
//   of the output.  Deterministic: no atomics.
//
// The switch point, FEW_ROWS = 4096 in ops/fused_moe.py, is measured
// (chip_smoke.py's moe_ffn regimes, 1024 → 2048 → 1024, NVIDIA H100 80GB
// HBM3, 700 W): at 4,096 rows the split (4 slices) took 0.1467 ms and the
// many-rows kernel 0.1917; at 8,192 rows 0.2704 and 0.2420; at 2,048
// 0.1246 and 0.1980; at 40,960 1.0183 and 0.5768.  Any row count works:
// ragged tiles are masked.
//
// The f32 form (moe_ffn_launch_f32, at the end of this file) computes the
// same FFN on f32 operands with SIMT FFMA products, nothing rounded
// narrower; see its own note.
#include "common.cuh"

using namespace i2t;

namespace {

constexpr int AW = 96;    // g + e·r: the first product's width
constexpr int ER = 64;    // e·r: the experts' stacked rank
constexpr int CH = 64;    // slab depth and chunk width
constexpr int MAXE = 8;   // most experts
constexpr int LD96 = AW + 8, LD64 = CH + 8;  // shared-memory row strides (bf16)
constexpr int MAXW = 4;   // warps (16 rows each) per block
// One stage of the slab pipeline: an l2w chunk (64 x 64), a [g0w | l1w]
// slab (64 x 96), an l2b chunk (e rows of 64, zero-padded to the 16 rows
// of an mma k-step), the block's x tile (64 x 64).
constexpr int OFF_WA = CH * LD64, OFF_L2B = OFF_WA + CH * LD96, OFF_X = OFF_L2B + 16 * LD64;
constexpr int STAGE_ELEMS = OFF_X + 16 * MAXW * LD64;
constexpr size_t smem_bytes(int warps) {
  return (size_t)2 * STAGE_ELEMS * 2 + (size_t)warps * 32 * 4;
}

struct MoEW {
  const bf16* wa;   // (fin, 96) = [g0w | l1w]
  const bf16* ba;   // (96) = [g0b | l1b]
  const bf16* g1w;  // (g, e)
  const bf16* g1b;  // (e)
  const bf16* l2w;  // (e·r, fout)
  const bf16* l2b;  // (e, fout)
};

struct Args {
  const bf16* x;
  bf16* out;
  int n, fin, hidden;
  const bf16* ln_w;
  const bf16* ln_b;
  const bf16* res;
  int rpi, orpi;  // output row map: (m / rpi) * orpi + m % rpi
  MoEW m1, m2;
  int e, r, k;
  float sqrt_fin, sqrt_hidden;
  uint8_t* routes;  // optional (n, 2) selected-expert bit masks
  float* part;      // few rows: (slices, n, 96) f32 parts of MoELinear 2's accumulators
  int chunks_per_slice;  // few rows: hidden chunks per slice
  int cols_per_block;    // few rows: output columns per finishing block
};

using Acc96 = float[12][4];   // a warp's 16 x 96 f32 accumulators (12 n8 tiles)
using Frag64 = uint32_t[4][4];  // 16 x 64 bf16 A fragments (4 k16 chunks)

struct Smem {
  bf16* stage[2];
  float* st;   // this warp's LayerNorm mean (16) and rstd (16)
};

// The block's shared memory; the l2b regions' padding rows e..15 are
// zeroed here (the first pipeline step's barrier orders it).
__device__ __forceinline__ Smem carve(unsigned char* raw, int warps, int warp, int e) {
  Smem s;
  bf16* base = reinterpret_cast<bf16*>(raw);
  s.stage[0] = base;
  s.stage[1] = base + STAGE_ELEMS;
  s.st = reinterpret_cast<float*>(base + 2 * STAGE_ELEMS) + warp * 32;
  for (int i = threadIdx.x; i < 2 * (16 - e) * LD64; i += blockDim.x) {
    const int buf = i / ((16 - e) * LD64), j = i % ((16 - e) * LD64);
    s.stage[buf][OFF_L2B + e * LD64 + j] = to_bf(0.f);
  }
  return s;
}

// rows x cols (cols % 8 == 0) from src (row stride lds) to dst (stride ldd)
__device__ __forceinline__ void stage_slab(bf16* dst, int ldd, const bf16* src, size_t lds,
                                           int rows, int cols) {
  const int per_row = cols / 8;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i % per_row) * 8;
    cp_async16(dst + r * ldd + c, src + (size_t)r * lds + c, true);
  }
}

// acc (16 x 8·NT) += A (16 x 64, fragments) · W (64 x 8·NT slab in shared memory)
template <int NT>
__device__ __forceinline__ void mma_slab(float (&acc)[NT][4], const Frag64& a, const bf16* w,
                                         int ldw) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      uint32_t b[4];
      ldsm_x4_t(b, w + (kk * 16 + lane % 16) * ldw + jp * 16 + (lane / 16) * 8);
      mma16816(acc[2 * jp], a[kk], b[0], b[1]);
      mma16816(acc[2 * jp + 1], a[kk], b[2], b[3]);
    }
  }
}

// Pack 8 n8 accumulator tiles (16 x 64, values already final) into A fragments.
__device__ __forceinline__ void to_frag(Frag64& f, const float (&v)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    f[kk][0] = pack_bf2(v[2 * kk][0], v[2 * kk][1]);
    f[kk][1] = pack_bf2(v[2 * kk][2], v[2 * kk][3]);
    f[kk][2] = pack_bf2(v[2 * kk + 1][0], v[2 * kk + 1][1]);
    f[kk][3] = pack_bf2(v[2 * kk + 1][2], v[2 * kk + 1][3]);
  }
}

// Runtime-indexed read of a small register array without local memory.
__device__ __forceinline__ float pick(const float (&c)[MAXE], int q) {
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < MAXE; ++i) v = i == q ? c[i] : v;
  return v;
}

// Gate MLP, softmax, top-k and combine of the warp's 16 rows from acc =
// x·[g0w | l1w] (f32), then hw = z ∘ expand(c) as A fragments.  Thread rows
// g and g + 8 (g = lane / 4); comb[h][q] its rows' combine weights (bf16
// values).  Routes go out for valid rows when ``which`` >= 0.
__device__ __forceinline__ void gate(const Args& p, const MoEW& m, float sqrt_in,
                                     const Acc96& acc, float (&comb)[2][MAXE], Frag64& hw,
                                     int row0, int which) {
  const int lane = threadIdx.x % 32, g = lane / 4, q4 = lane % 4, e = p.e;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lg[MAXE];
#pragma unroll
    for (int q = 0; q < MAXE; ++q) lg[q] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = j * 8 + 2 * q4 + u;
        const float a = rbf(act(rbf(rbf(acc[j][2 * h + u]) + to_f(m.ba[col]))));
#pragma unroll
        for (int q = 0; q < MAXE; ++q)
          if (q < e) lg[q] += a * to_f(m.g1w[col * e + q]);
      }
    }
    float v[MAXE], mx = -INFINITY, sum = 0.f;
#pragma unroll
    for (int q = 0; q < MAXE; ++q) {
      lg[q] += __shfl_xor_sync(0xffffffffu, lg[q], 1);
      lg[q] += __shfl_xor_sync(0xffffffffu, lg[q], 2);
      if (q < e) {
        v[q] = rbf(rbf(lg[q]) + to_f(m.g1b[q])) / sqrt_in;
        mx = fmaxf(mx, v[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < MAXE; ++q) {
      if (q < e) {
        v[q] = expf(v[q] - mx);
        sum += v[q];
      }
    }
    unsigned bits = 0;
#pragma unroll
    for (int q = 0; q < MAXE; ++q) {
      comb[h][q] = 0.f;
      if (q < e) {
        v[q] = v[q] / sum;
      }
    }
#pragma unroll
    for (int q = 0; q < MAXE; ++q) {
      if (q < e) {
        int rank = 0;
#pragma unroll
        for (int j = 0; j < MAXE; ++j)
          if (j < e) rank += (v[j] > v[q]) || (v[j] == v[q] && j < q);
        const bool keep = rank < p.k;
        comb[h][q] = keep ? rbf(v[q]) : 0.f;
        bits |= keep ? (1u << q) : 0u;
      }
    }
    const int row = row0 + g + 8 * h;
    if (which >= 0 && p.routes != nullptr && q4 == 0 && row < p.n)
      p.routes[(size_t)row * 2 + which] = (uint8_t)bits;
  }
  float z[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int h = u >> 1, ecol = j * 8 + 2 * q4 + (u & 1);
      const float zz = rbf(act(rbf(rbf(acc[4 + j][u]) + to_f(m.ba[32 + ecol]))));
      z[j][u] = zz * pick(comb[h], ecol / p.r);
    }
  }
  to_frag(hw, z);
}

// y = bf16(bf16(y) + bf16(c·l2b)) on a 16 x 64 chunk: the c·l2b product
// as one mma k-step, c (16 rows x e experts, bf16 values) against the
// staged l2b chunk (e rows, zero-padded to 16).
__device__ __forceinline__ void add_comb_bias(float (&y)[8][4], const float (&comb)[2][MAXE],
                                              const bf16* l2b) {
  const int lane = threadIdx.x % 32, q4 = lane % 4;
  const uint32_t c[4] = {pack_bf2(pick(comb[0], 2 * q4), pick(comb[0], 2 * q4 + 1)),
                         pack_bf2(pick(comb[1], 2 * q4), pick(comb[1], 2 * q4 + 1)), 0u, 0u};
#pragma unroll
  for (int jp = 0; jp < 4; ++jp) {
    uint32_t b[4];
    ldsm_x4_t(b, l2b + (lane % 16) * LD64 + jp * 16 + (lane / 16) * 8);
    float t[2][4] = {};
    mma16816(t[0], c, b[0], b[1]);
    mma16816(t[1], c, b[2], b[3]);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int u = 0; u < 4; ++u) y[2 * jp + h][u] = rbf(rbf(y[2 * jp + h][u]) + rbf(t[h][u]));
  }
}

// The double-buffered slab pipeline: for chunk i of n, ``load(i, buf)``
// issues its cp.async copies and ``use(i, buf)`` computes on them.
template <class Load, class Use>
__device__ __forceinline__ void pipeline(const Smem& s, int n, Load load, Use use) {
  if (n <= 0) return;
  load(0, s.stage[0]);
  cp_async_commit();
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) {
      load(i + 1, s.stage[(i + 1) & 1]);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    use(i, s.stage[i & 1]);
    __syncthreads();
  }
}

// MoELinear 1 on the warp's rows: acc = LN?(x)·[g0w | l1w] (f32).
__device__ __forceinline__ void first_product(const Args& p, const Smem& s, int row0,
                                              Acc96& acc) {
  const int lane = threadIdx.x % 32, fin = p.fin;
  const bool ln = I2T_LN == 0 && p.ln_w != nullptr;
  if (ln) {
    for (int rr = 0; rr < 16; ++rr) {
      const int row = row0 + rr;
      if (row >= p.n) break;  // uniform across the warp
      const bf16* xr = p.x + (size_t)row * fin;
      float sum = 0.f;
      for (int c = lane * 8; c < fin; c += 256) {
        const Bf16x8 v = *reinterpret_cast<const Bf16x8*>(xr + c);
#pragma unroll
        for (int t = 0; t < 8; ++t) sum += to_f(v.v[t]);
      }
      const float mean = warp_sum(sum) / fin;
      float var = 0.f;
      for (int c = lane * 8; c < fin; c += 256) {
        const Bf16x8 v = *reinterpret_cast<const Bf16x8*>(xr + c);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float d = to_f(v.v[t]) - mean;
          var += d * d;
        }
      }
      var = warp_sum(var) / fin;
      if (lane == 0) {
        s.st[rr] = mean;
        s.st[16 + rr] = rsqrtf(var + 1e-5f);
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int j = 0; j < 12; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int warp = threadIdx.x / 32, blk0 = row0 - warp * 16;
  pipeline(
      s, fin / CH,
      [&](int i, bf16* buf) {
        stage_slab(buf + OFF_WA, LD96, p.m1.wa + (size_t)i * CH * AW, AW, CH, AW);
        // the block's x tile; rows past n are zero-filled
        for (int v = threadIdx.x; v < 16 * MAXW * (CH / 8); v += blockDim.x) {
          const int rr = v / (CH / 8), c = (v % (CH / 8)) * 8, row = blk0 + rr;
          cp_async16(buf + OFF_X + rr * LD64 + c,
                     p.x + (size_t)(row < p.n ? row : 0) * fin + i * CH + c, row < p.n);
        }
      },
      [&](int i, const bf16* cbuf) {
        bf16* xs = const_cast<bf16*>(cbuf) + OFF_X + warp * 16 * LD64;
        if (ln) {
          const int k0 = i * CH;
          for (int v = lane; v < 16 * CH / 8; v += 32) {
            const int rr = v / (CH / 8), c = (v % (CH / 8)) * 8;
            if (row0 + rr >= p.n) continue;
            Bf16x8 pk = *reinterpret_cast<const Bf16x8*>(xs + rr * LD64 + c);
            const float mean = s.st[rr], rstd = s.st[16 + rr];
#pragma unroll
            for (int t = 0; t < 8; ++t) {
              float y = (to_f(pk.v[t]) - mean) * rstd;
              y = y * to_f(p.ln_w[k0 + c + t]);
              if (p.ln_b != nullptr) y = y + to_f(p.ln_b[k0 + c + t]);
              pk.v[t] = to_bf(y);
            }
            *reinterpret_cast<Bf16x8*>(xs + rr * LD64 + c) = pk;
          }
          __syncwarp();
        }
        Frag64 a;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          ldsm_x4(a[kk], xs + (lane % 16) * LD64 + kk * 16 + (lane / 16) * 8);
        mma_slab<12>(acc, a, cbuf + OFF_WA, LD96);
      });
}

// Hidden chunks [c0, c1): acc2 += gelu(hw·l2w1 + c·l2b1) · [g0w2 | l1w2].
__device__ __forceinline__ void hidden_chunks(const Args& p, const Smem& s, const Frag64& hw,
                                              const float (&comb)[2][MAXE], int c0, int c1,
                                              Acc96& acc2) {
  const int hidden = p.hidden;
  pipeline(
      s, c1 - c0,
      [&](int i, bf16* buf) {
        const int h0 = (c0 + i) * CH;
        stage_slab(buf, LD64, p.m1.l2w + h0, hidden, ER, CH);
        stage_slab(buf + OFF_WA, LD96, p.m2.wa + (size_t)h0 * AW, AW, CH, AW);
        stage_slab(buf + OFF_L2B, LD64, p.m1.l2b + h0, hidden, p.e, CH);
      },
      [&](int, const bf16* buf) {
        float y[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) y[j][0] = y[j][1] = y[j][2] = y[j][3] = 0.f;
        mma_slab<8>(y, hw, buf, LD64);
        add_comb_bias(y, comb, buf + OFF_L2B);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int u = 0; u < 4; ++u) y[j][u] = act(y[j][u]);
        Frag64 a;
        to_frag(a, y);
        mma_slab<12>(acc2, a, buf + OFF_WA, LD96);
      });
}

// Output columns [n0, n1) (multiples of 64): hw2·l2w2 + c2·l2b2 [+ residual].
__device__ __forceinline__ void output_chunks(const Args& p, const Smem& s, const Frag64& hw,
                                              const float (&comb)[2][MAXE], int row0, int n0,
                                              int n1) {
  const int lane = threadIdx.x % 32, g = lane / 4, q4 = lane % 4, fin = p.fin;
  pipeline(
      s, (n1 - n0) / CH,
      [&](int i, bf16* buf) {
        const int c0 = n0 + i * CH;
        stage_slab(buf, LD64, p.m2.l2w + c0, fin, ER, CH);
        stage_slab(buf + OFF_L2B, LD64, p.m2.l2b + c0, fin, p.e, CH);
      },
      [&](int i, const bf16* buf) {
        const int c0 = n0 + i * CH;
        float y[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) y[j][0] = y[j][1] = y[j][2] = y[j][3] = 0.f;
        mma_slab<8>(y, hw, buf, LD64);
        add_comb_bias(y, comb, buf + OFF_L2B);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = row0 + g + 8 * h;
          if (m >= p.n) continue;
          const size_t orow = (size_t)(m / p.rpi) * p.orpi + m % p.rpi;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = j * 8 + 2 * q4;
            float o[2] = {y[j][2 * h], y[j][2 * h + 1]};
            if (p.res != nullptr) {
              const __nv_bfloat162 rv =
                  *reinterpret_cast<const __nv_bfloat162*>(p.res + (size_t)m * fin + c0 + col);
              o[0] = rbf(to_f(rv.x) + o[0]);
              o[1] = rbf(to_f(rv.y) + o[1]);
            }
            *reinterpret_cast<uint32_t*>(p.out + orow * fin + c0 + col) = pack_bf2(o[0], o[1]);
          }
        }
      });
}

// Many rows: a block of 16·warps rows runs the whole FFN.
__global__ void __launch_bounds__(128) moe_rows_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32;
  const Smem s = carve(smem_raw, warps, warp, p.e);
  const int row0 = (blockIdx.x * warps + warp) * 16;
  Acc96 acc;
  float comb[2][MAXE];
  Frag64 hw;
  first_product(p, s, row0, acc);
  gate(p, p.m1, p.sqrt_fin, acc, comb, hw, row0, 0);
#pragma unroll
  for (int j = 0; j < 12; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  hidden_chunks(p, s, hw, comb, 0, p.hidden / CH, acc);
  gate(p, p.m2, p.sqrt_hidden, acc, comb, hw, row0, 1);
  output_chunks(p, s, hw, comb, row0, 0, p.fin);
}

// Few rows, first kernel: block (row tile, hidden slice) writes its slice's
// part of MoELinear 2's accumulators to p.part.
__global__ void __launch_bounds__(128) moe_split_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Smem s = carve(smem_raw, warps, warp, p.e);
  const int row0 = (blockIdx.x * warps + warp) * 16, slice = blockIdx.y;
  Acc96 acc;
  float comb[2][MAXE];
  Frag64 hw;
  first_product(p, s, row0, acc);
  gate(p, p.m1, p.sqrt_fin, acc, comb, hw, row0, slice == 0 ? 0 : -1);
#pragma unroll
  for (int j = 0; j < 12; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int c0 = slice * p.chunks_per_slice;
  hidden_chunks(p, s, hw, comb, c0, min(c0 + p.chunks_per_slice, p.hidden / CH), acc);
  const int g = lane / 4, q4 = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = row0 + g + 8 * h;
    if (m >= p.n) continue;
    float* dst = p.part + ((size_t)slice * p.n + m) * AW + 2 * q4;
#pragma unroll
    for (int j = 0; j < 12; ++j)
      *reinterpret_cast<float2*>(dst + j * 8) = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

// Few rows, second kernel: block (row tile, column slice) sums the slices'
// parts in order, runs MoELinear 2's gate and its output columns.
__global__ void __launch_bounds__(128) moe_finish_kernel(Args p, int slices) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Smem s = carve(smem_raw, warps, warp, p.e);
  const int row0 = (blockIdx.x * warps + warp) * 16, g = lane / 4, q4 = lane % 4;
  Acc96 acc;
#pragma unroll
  for (int j = 0; j < 12; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = row0 + g + 8 * h;
    if (m >= p.n) continue;
    for (int sl = 0; sl < slices; ++sl) {
      const float* src = p.part + ((size_t)sl * p.n + m) * AW + 2 * q4;
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const float2 v = *reinterpret_cast<const float2*>(src + j * 8);
        acc[j][2 * h] += v.x;
        acc[j][2 * h + 1] += v.y;
      }
    }
  }
  float comb[2][MAXE];
  Frag64 hw;
  gate(p, p.m2, p.sqrt_hidden, acc, comb, hw, row0, blockIdx.y == 0 ? 1 : -1);
  const int n0 = blockIdx.y * p.cols_per_block;
  output_chunks(p, s, hw, comb, row0, n0, min(n0 + p.cols_per_block, p.fin));
}

}  // namespace

// ``slices`` 1: the many-rows kernel; > 1: the hidden dimension split in
// ``slices`` parts (``part``: slices·n·96 f32 scratch), then the finishing
// kernel over ``col_blocks`` column slices.
extern "C" int moe_ffn_launch(const void* x, void* out, int n, int fin, int hidden,
                              const void* ln_w, const void* ln_b, const void* res,
                              int rpi, int orpi,
                              const void* wa1, const void* ba1, const void* g1w1,
                              const void* g1b1, const void* l2w1, const void* l2b1,
                              const void* wa2, const void* ba2, const void* g1w2,
                              const void* g1b2, const void* l2w2, const void* l2b2,
                              int g, int e, int r, int k, void* routes, int warps, int slices,
                              int col_blocks, void* part, void* stream) {
  if (n <= 0 || fin % CH || hidden % CH || g != AW - ER || e * r != ER || e > MAXE || k < 1 ||
      warps < 1 || warps > 4 || rpi <= 0 || orpi < rpi || slices < 1 || col_blocks < 1 ||
      (slices > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.out = static_cast<bf16*>(out);
  a.n = n;
  a.fin = fin;
  a.hidden = hidden;
  a.ln_w = static_cast<const bf16*>(ln_w);
  a.ln_b = static_cast<const bf16*>(ln_b);
  a.res = static_cast<const bf16*>(res);
  a.rpi = rpi;
  a.orpi = orpi;
  a.m1 = {static_cast<const bf16*>(wa1), static_cast<const bf16*>(ba1),
          static_cast<const bf16*>(g1w1), static_cast<const bf16*>(g1b1),
          static_cast<const bf16*>(l2w1), static_cast<const bf16*>(l2b1)};
  a.m2 = {static_cast<const bf16*>(wa2), static_cast<const bf16*>(ba2),
          static_cast<const bf16*>(g1w2), static_cast<const bf16*>(g1b2),
          static_cast<const bf16*>(l2w2), static_cast<const bf16*>(l2b2)};
  a.e = e;
  a.r = r;
  a.k = k;
  a.sqrt_fin = (float)sqrt((double)fin);
  a.sqrt_hidden = (float)sqrt((double)hidden);
  a.routes = static_cast<uint8_t*>(routes);
  a.part = static_cast<float*>(part);
  const int chunks = hidden / CH;
  a.chunks_per_slice = (chunks + slices - 1) / slices;
  slices = (chunks + a.chunks_per_slice - 1) / a.chunks_per_slice;
  a.cols_per_block = ((fin / CH + col_blocks - 1) / col_blocks) * CH;
  col_blocks = (fin + a.cols_per_block - 1) / a.cols_per_block;
  const size_t smem = smem_bytes(warps);
  const int row_tiles = (n + 16 * warps - 1) / (16 * warps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (slices == 1) {
    err = cudaFuncSetAttribute(moe_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    moe_rows_kernel<<<row_tiles, 32 * warps, smem, st>>>(a);
    return (int)cudaGetLastError();
  }
  err = cudaFuncSetAttribute(moe_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(moe_finish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  moe_split_kernel<<<dim3(row_tiles, slices), 32 * warps, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moe_finish_kernel<<<dim3(row_tiles, col_blocks), 32 * warps, smem, st>>>(a, slices);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The f32 form: the same FFN for f32 operands (the configurations served at
// precision 'no', e.g. local/nano-mini.yaml), every product a true f32 FFMA
// on the SIMT cores (wgmma takes f32 only as TF32) and nothing rounded
// narrower.  One regime at every row count: the hidden dimension split over
// blocks, three kernels, no atomics.
//
// * moe32_first_kernel (block: 16 rows): [LN →] x·[g0w | l1w], MoELinear 1's
//   gate, softmax, top-k and combine c1; writes hw1 = z ∘ expand(c1) (n, e·r)
//   and c1 (n, e) to the scratch buffer.
// * moe32_hidden_kernel (block: 16 rows x a slice of the hidden dimension):
//   for each 32-wide chunk, h = gelu(hw1·l2w1 + c1·l2b1), then its part of
//   MoELinear 2's product h·[g0w2 | l1w2], written (slices, n, g + e·r).
// * moe32_finish_kernel (block: 16 rows x 128 output columns): sums the
//   slices' parts in slice order, MoELinear 2's gate, top-k and combine c2,
//   y = hw2·l2w2 + c2·l2b2 [+ residual] through the output row map.
//
// Widths: any fin and hidden, g + e·r and e·r up to 128, e up to 8.  What
// bounds it at nano-mini's decode (256 rows, 1024 → 2048): operations, 0.25
// GFLOP, 3.9 µs at 67 TFLOP/s of f32 FFMA, over its ~4 MB of bytes (1.2
// µs); the launches and filling the card decide at such sizes.

namespace {

constexpr int F_ROWS = 16;    // rows a block
constexpr int F_THREADS = 128;
constexpr int F_K = 32;       // depth of a staged x / weight chunk
constexpr int F_CHUNK = 32;   // hidden columns a chunk of the hidden kernel
constexpr int F_MAXA = 128;   // most g + e·r (and e·r)
constexpr int F_COLS = 128;   // output columns a finishing block

struct Args32 {
  const float* x;
  float* out;
  int n, fin, hidden;
  const float* ln_w;
  const float* ln_b;
  const float* res;
  int rpi, orpi;
  const float *wa1, *ba1, *g1w1, *g1b1, *l2w1, *l2b1;
  const float *wa2, *ba2, *g1w2, *g1b2, *l2w2, *l2b2;
  int g, e, r, k;
  float sqrt_fin, sqrt_hidden;
  uint8_t* routes;
  float* hw1;   // (n, e·r)
  float* c1;    // (n, e)
  float* part;  // (slices, n, g + e·r)
  int chunks_per_slice;
};

// One row's gate from its f32 accumulators ``acc`` (g + e·r values): the
// gate MLP, softmax(lg / sqrt_in), top-k with lowest-index ties; the kept
// gate values (unnormalised) go to ``comb`` (e values), the bit mask is
// returned.
__device__ unsigned gate32(const float* acc, const float* ba, const float* g1w,
                           const float* g1b, int g, int e, int k, float sqrt_in,
                           float* comb) {
  float lg[MAXE];
#pragma unroll
  for (int q = 0; q < MAXE; ++q) lg[q] = 0.f;
  for (int j = 0; j < g; ++j) {
    const float a = act(acc[j] + ba[j]);
#pragma unroll
    for (int q = 0; q < MAXE; ++q)
      if (q < e) lg[q] = fmaf(a, g1w[j * e + q], lg[q]);
  }
  float v[MAXE], mx = -INFINITY, sum = 0.f;
#pragma unroll
  for (int q = 0; q < MAXE; ++q) {
    if (q < e) {
      v[q] = (lg[q] + g1b[q]) / sqrt_in;
      mx = fmaxf(mx, v[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < MAXE; ++q) {
    if (q < e) {
      v[q] = expf(v[q] - mx);
      sum += v[q];
    }
  }
#pragma unroll
  for (int q = 0; q < MAXE; ++q)
    if (q < e) v[q] = v[q] / sum;
  unsigned bits = 0;
#pragma unroll
  for (int q = 0; q < MAXE; ++q) {
    if (q < e) {
      int rank = 0;
#pragma unroll
      for (int j = 0; j < MAXE; ++j)
        if (j < e) rank += (v[j] > v[q]) || (v[j] == v[q] && j < q);
      const bool keep = rank < k;
      comb[q] = keep ? v[q] : 0.f;
      bits |= keep ? (1u << q) : 0u;
    }
  }
  return bits;
}

__global__ void __launch_bounds__(F_THREADS) moe32_first_kernel(Args32 p) {
  __shared__ float xs[F_K][F_ROWS + 1];   // an x chunk, transposed: [k][row]
  __shared__ float ws[F_K][F_MAXA];       // a [g0w | l1w] chunk
  __shared__ float accs[F_ROWS][F_MAXA + 1];
  __shared__ float stat[2][F_ROWS];       // LayerNorm mean and rstd
  __shared__ float cs[F_ROWS][MAXE];
  const int t = threadIdx.x, tx = t % 32, ty = t / 32, row0 = blockIdx.x * F_ROWS;
  const int A = p.g + p.e * p.r, ER = p.e * p.r, fin = p.fin;
  const bool ln = p.ln_w != nullptr;
  if (ln) {
    // two-pass statistics, one warp a row (rows ty, ty + 4, ...)
    for (int rr = ty; rr < F_ROWS; rr += F_THREADS / 32) {
      const int row = row0 + rr;
      if (row >= p.n) continue;
      const float* xr = p.x + (size_t)row * fin;
      float s = 0.f;
      for (int c = tx; c < fin; c += 32) s += xr[c];
      const float mean = warp_sum(s) / fin;
      float v = 0.f;
      for (int c = tx; c < fin; c += 32) {
        const float d = xr[c] - mean;
        v = fmaf(d, d, v);
      }
      v = warp_sum(v) / fin;
      if (tx == 0) {
        stat[0][rr] = mean;
        stat[1][rr] = rsqrtf(v + 1e-5f);
      }
    }
    __syncthreads();
  }
  float acc[4][4] = {};
  for (int k0 = 0; k0 < fin; k0 += F_K) {
    for (int i = t; i < F_ROWS * F_K; i += F_THREADS) {
      const int rr = i / F_K, kk = i % F_K, row = row0 + rr, gk = k0 + kk;
      float v = 0.f;
      if (row < p.n && gk < fin) {
        v = p.x[(size_t)row * fin + gk];
        if (ln) {
          v = (v - stat[0][rr]) * stat[1][rr] * p.ln_w[gk];
          if (p.ln_b != nullptr) v += p.ln_b[gk];
        }
      }
      xs[kk][rr] = v;
    }
    for (int i = t; i < F_K * F_MAXA; i += F_THREADS) {
      const int kk = i / F_MAXA, c = i % F_MAXA, gk = k0 + kk;
      ws[kk][c] = gk < fin && c < A ? p.wa1[(size_t)gk * A + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < F_K; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = xs[kk][ty + 4 * i];
        b[i] = ws[kk][tx + 32 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) accs[ty + 4 * i][tx + 32 * j] = acc[i][j];
  __syncthreads();
  if (t < F_ROWS && row0 + t < p.n) {
    const int row = row0 + t;
    const unsigned bits = gate32(accs[t], p.ba1, p.g1w1, p.g1b1, p.g, p.e, p.k, p.sqrt_fin,
                                 cs[t]);
    if (p.routes != nullptr) p.routes[(size_t)row * 2] = (uint8_t)bits;
    for (int q = 0; q < p.e; ++q) p.c1[(size_t)row * p.e + q] = cs[t][q];
  }
  __syncthreads();
  for (int i = t; i < F_ROWS * ER; i += F_THREADS) {
    const int rr = i / ER, c = i % ER, row = row0 + rr;
    if (row < p.n)
      p.hw1[(size_t)row * ER + c] = act(accs[rr][p.g + c] + p.ba1[p.g + c]) * cs[rr][c / p.r];
  }
}

__global__ void __launch_bounds__(F_THREADS) moe32_hidden_kernel(Args32 p) {
  __shared__ float hws[F_ROWS][F_MAXA];     // hw1 of the block's rows
  __shared__ float c1s[F_ROWS][MAXE];
  __shared__ float l2ws[F_MAXA][F_CHUNK];   // l2w1's chunk columns
  __shared__ float l2bs[MAXE][F_CHUNK];
  __shared__ float hs[F_ROWS][F_CHUNK + 1];
  __shared__ float was[F_CHUNK][F_MAXA];    // [g0w2 | l1w2]'s chunk rows
  const int t = threadIdx.x, tx = t % 32, ty = t / 32, row0 = blockIdx.x * F_ROWS;
  const int A = p.g + p.e * p.r, ER = p.e * p.r, hidden = p.hidden;
  for (int i = t; i < F_ROWS * ER; i += F_THREADS) {
    const int rr = i / ER, c = i % ER, row = row0 + rr;
    hws[rr][c] = row < p.n ? p.hw1[(size_t)row * ER + c] : 0.f;
  }
  for (int i = t; i < F_ROWS * MAXE; i += F_THREADS) {
    const int rr = i / MAXE, q = i % MAXE, row = row0 + rr;
    c1s[rr][q] = row < p.n && q < p.e ? p.c1[(size_t)row * p.e + q] : 0.f;
  }
  const int chunks = (hidden + F_CHUNK - 1) / F_CHUNK;
  const int c0 = blockIdx.y * p.chunks_per_slice;
  const int c1 = min(c0 + p.chunks_per_slice, chunks);
  float acc[4][4] = {};
  for (int ch = c0; ch < c1; ++ch) {
    const int h0 = ch * F_CHUNK;
    for (int i = t; i < ER * F_CHUNK; i += F_THREADS) {
      const int q = i / F_CHUNK, jj = i % F_CHUNK;
      l2ws[q][jj] = h0 + jj < hidden ? p.l2w1[(size_t)q * hidden + h0 + jj] : 0.f;
    }
    for (int i = t; i < p.e * F_CHUNK; i += F_THREADS) {
      const int q = i / F_CHUNK, jj = i % F_CHUNK;
      l2bs[q][jj] = h0 + jj < hidden ? p.l2b1[(size_t)q * hidden + h0 + jj] : 0.f;
    }
    for (int i = t; i < F_CHUNK * F_MAXA; i += F_THREADS) {
      const int jj = i / F_MAXA, c = i % F_MAXA;
      was[jj][c] = h0 + jj < hidden && c < A ? p.wa2[(size_t)(h0 + jj) * A + c] : 0.f;
    }
    __syncthreads();
    // h = gelu(hw1·l2w1 + c1·l2b1): rows ty + 4i, column tx of the chunk
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = ty + 4 * i;
      float y = 0.f, yb = 0.f;
      for (int q = 0; q < ER; ++q) y = fmaf(hws[rr][q], l2ws[q][tx], y);
      for (int q = 0; q < p.e; ++q) yb = fmaf(c1s[rr][q], l2bs[q][tx], yb);
      hs[rr][tx] = h0 + tx < hidden ? act(y + yb) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int jj = 0; jj < F_CHUNK; ++jj) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = hs[ty + 4 * i][jj];
        b[i] = was[jj][tx + 32 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 4 * i;
    if (row >= p.n) continue;
    float* dst = p.part + ((size_t)blockIdx.y * p.n + row) * A;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (tx + 32 * j < A) dst[tx + 32 * j] = acc[i][j];
  }
}

__global__ void __launch_bounds__(F_THREADS) moe32_finish_kernel(Args32 p, int slices) {
  __shared__ float accs[F_ROWS][F_MAXA + 1];
  __shared__ float hws[F_ROWS][F_MAXA];
  __shared__ float cs[F_ROWS][MAXE];
  const int t = threadIdx.x, tx = t % 32, ty = t / 32, row0 = blockIdx.x * F_ROWS;
  const int A = p.g + p.e * p.r, ER = p.e * p.r, fin = p.fin;
  for (int i = t; i < F_ROWS * A; i += F_THREADS) {
    const int rr = i / A, c = i % A, row = row0 + rr;
    float s = 0.f;
    if (row < p.n)
      for (int sl = 0; sl < slices; ++sl) s += p.part[((size_t)sl * p.n + row) * A + c];
    accs[rr][c] = s;
  }
  __syncthreads();
  if (t < F_ROWS && row0 + t < p.n) {
    const unsigned bits = gate32(accs[t], p.ba2, p.g1w2, p.g1b2, p.g, p.e, p.k,
                                 p.sqrt_hidden, cs[t]);
    if (p.routes != nullptr && blockIdx.y == 0)
      p.routes[(size_t)(row0 + t) * 2 + 1] = (uint8_t)bits;
  }
  __syncthreads();
  for (int i = t; i < F_ROWS * ER; i += F_THREADS) {
    const int rr = i / ER, c = i % ER;
    hws[rr][c] = row0 + rr < p.n ? act(accs[rr][p.g + c] + p.ba2[p.g + c]) * cs[rr][c / p.r]
                                 : 0.f;
  }
  __syncthreads();
  const int n0 = blockIdx.y * F_COLS;
  float y[4][4] = {}, yb[4][4] = {};
  for (int q = 0; q < ER; ++q) {
    float b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 32 * j;
      b[j] = col < fin ? p.l2w2[(size_t)q * fin + col] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) y[i][j] = fmaf(hws[ty + 4 * i][q], b[j], y[i][j]);
  }
  for (int q = 0; q < p.e; ++q) {
    float b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 32 * j;
      b[j] = col < fin ? p.l2b2[(size_t)q * fin + col] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) yb[i][j] = fmaf(cs[ty + 4 * i][q], b[j], yb[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = row0 + ty + 4 * i;
    if (m >= p.n) continue;
    const size_t orow = (size_t)(m / p.rpi) * p.orpi + m % p.rpi;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 32 * j;
      if (col >= fin) continue;
      float o = y[i][j] + yb[i][j];
      if (p.res != nullptr) o = p.res[(size_t)m * fin + col] + o;
      p.out[orow * fin + col] = o;
    }
  }
}

}  // namespace

// The f32 form.  ``scratch`` holds n·e·r + n·e + slices·n·(g + e·r) floats:
// hw1, c1 and the hidden slices' parts.
extern "C" int moe_ffn_launch_f32(const void* x, void* out, int n, int fin, int hidden,
                                  const void* ln_w, const void* ln_b, const void* res,
                                  int rpi, int orpi,
                                  const void* wa1, const void* ba1, const void* g1w1,
                                  const void* g1b1, const void* l2w1, const void* l2b1,
                                  const void* wa2, const void* ba2, const void* g1w2,
                                  const void* g1b2, const void* l2w2, const void* l2b2,
                                  int g, int e, int r, int k, void* routes, int slices,
                                  void* scratch, void* stream) {
  if (n <= 0 || fin <= 0 || hidden <= 0 || g < 1 || e < 1 || e > MAXE || r < 1 ||
      g + e * r > F_MAXA || k < 1 || rpi <= 0 || orpi < rpi || slices < 1 ||
      scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  Args32 a;
  a.x = static_cast<const float*>(x);
  a.out = static_cast<float*>(out);
  a.n = n;
  a.fin = fin;
  a.hidden = hidden;
  a.ln_w = static_cast<const float*>(ln_w);
  a.ln_b = static_cast<const float*>(ln_b);
  a.res = static_cast<const float*>(res);
  a.rpi = rpi;
  a.orpi = orpi;
  a.wa1 = static_cast<const float*>(wa1);
  a.ba1 = static_cast<const float*>(ba1);
  a.g1w1 = static_cast<const float*>(g1w1);
  a.g1b1 = static_cast<const float*>(g1b1);
  a.l2w1 = static_cast<const float*>(l2w1);
  a.l2b1 = static_cast<const float*>(l2b1);
  a.wa2 = static_cast<const float*>(wa2);
  a.ba2 = static_cast<const float*>(ba2);
  a.g1w2 = static_cast<const float*>(g1w2);
  a.g1b2 = static_cast<const float*>(g1b2);
  a.l2w2 = static_cast<const float*>(l2w2);
  a.l2b2 = static_cast<const float*>(l2b2);
  a.g = g;
  a.e = e;
  a.r = r;
  a.k = k;
  a.sqrt_fin = (float)sqrt((double)fin);
  a.sqrt_hidden = (float)sqrt((double)hidden);
  a.routes = static_cast<uint8_t*>(routes);
  float* s = static_cast<float*>(scratch);
  a.hw1 = s;
  a.c1 = s + (size_t)n * e * r;
  a.part = a.c1 + (size_t)n * e;
  const int chunks = (hidden + F_CHUNK - 1) / F_CHUNK;
  a.chunks_per_slice = (chunks + slices - 1) / slices;
  slices = (chunks + a.chunks_per_slice - 1) / a.chunks_per_slice;
  const int row_tiles = (n + F_ROWS - 1) / F_ROWS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  moe32_first_kernel<<<row_tiles, F_THREADS, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moe32_hidden_kernel<<<dim3(row_tiles, slices), F_THREADS, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moe32_finish_kernel<<<dim3(row_tiles, (fin + F_COLS - 1) / F_COLS), F_THREADS, 0, st>>>(a,
                                                                                      slices);
  return (int)cudaGetLastError();
}
