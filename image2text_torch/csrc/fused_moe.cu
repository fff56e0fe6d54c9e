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
