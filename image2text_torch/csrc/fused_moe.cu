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
// same FFN on f32 operands with 3xTF32 tensor-core products, nothing
// rounded narrower, in one launch; see its own note.
#include "flash_common.cuh"

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
// The f32 form: the same FFN on f32 operands (the configurations served at
// precision 'no', e.g. local/nano-mini.yaml, and the f32 encoder blocks'
// composed forward), nothing rounded narrower than f32.  Every product runs
// on the tensor cores as 3xTF32 mma.sync m16n8k8 (flash_common.cuh's mma3:
// each operand split into two TF32 halves, three products, each k-step into
// a zeroed accumulator that an f32 add then adds to the running sum, since
// the tensor cores truncate their accumulation).
//
// What held the first design back (three SIMT FFMA kernels on 16-row
// blocks): at nano-mini's decode (256 rows, 1024 → 2048) its first kernel
// ran 16 blocks on 132 SMs.  Here one kernel, moe32_kernel: a block of
// F_WARPS warps owns F_ROWS rows, its warps splitting each product's depth
// (16 of every 64 deep chunk of x·[g0w | l1w]; 16 of every 64 columns of a
// hidden or output chunk), so every weight is read once a block and split
// into its TF32 halves once.  The hidden dimension is split over the
// ``slices`` blocks of a thread-block cluster (ops/fused_moe.py::
// moe_plan_f32: about a block an SM, at most F_MAX_SLICES; 16 row tiles x
// 8 slices at 256 rows), and the cluster shares the rest of the FFN:
//
// * MoELinear 1: block r takes the r-th share of x·[g0w | l1w]'s depth
//   ([LN →] x staged by cp.async), its warps' partial accumulators summed in
//   warp order, and every block sums the cluster's partials in rank order
//   from their shared memory (distributed shared memory, behind a cluster
//   barrier): the same f32 bits in every block.  Then the gate (its steps
//   spread over the block), softmax, top-k and combine, and hw1 = z ∘
//   expand(c1) in shared memory.
// * the hidden slice: per 64-wide chunk h = gelu(hw1·l2w1 + c1·l2b1) in
//   registers, fed from the accumulator layout as the A operand of
//   h·[g0w2 | l1w2] (the accumulator's columns 2c, 2c + 1 are the A
//   fragment's k c, c + 4: the weight's rows are read in that order); the
//   slices' parts of MoELinear 2's accumulators summed in rank (slice)
//   order as above.
// * MoELinear 2's gate, top-k and combine, then block r's share of the
//   output columns, y = hw2·l2w2 + c2·l2b2 [+ residual] through the output
//   row map.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (probes/kernel_times.py
// --moe-front-f32-only, device time): 0.0531 ms at 256 rows, where the
// three SIMT kernels took 0.1768; 0.137 at 1,280 rows (0.294), 0.045 at 1
// and 17 (0.129, 0.159), 0.224 at 4,097 (0.573).  Tried in throwaway
// builds and slower: every slice's block recomputing MoELinear 1, with a
// second kernel summing the slices' parts; 8-warp blocks (one a SM: 16
// clusters of 8 then take two waves); the gate a warp a row; the three
// products of a k-step chained into one accumulator in the 16-column
// products (only two chains a warp to overlap; hence mma3x there).
// Weights and x are staged in shared memory by cp.async, double-buffered
// (16-byte copies where fin, hidden and g + e·r are multiples of 4, else
// 4-byte ones), rows and columns past the operands zero-filled; the
// hidden-wide activation never leaves the SM.  No atomics: partials are
// summed in a fixed order, so reruns are bitwise equal.  Widths: any fin
// and hidden, g + e·r up to F_MAXA, e up to MAXE; the accumulators' width
// (NT n8 tiles: g + e·r up to 32, 64, 96 or 128) is a template parameter.
// The host's plan reads F_ROWS, F_CHUNK and F_MAX_SLICES from this file.
//
// What bounds it at nano-mini's decode: 0.25 GFLOP (three TF32 products a
// FLOP: 1.6 µs at 495 TFLOP/s) against 4.1 MB of bytes (1.2 µs).

namespace {

constexpr int F_WARPS = 4;              // warps of an f32 block
constexpr int F_THREADS = 32 * F_WARPS;
constexpr int F_ROWS = 16;              // rows a block: one m16 tile
constexpr int F_KD = 64;                // depth of a staged x / [g0w | l1w] chunk: 16 a warp
constexpr int F_CHUNK = 64;             // hidden or output columns a stage: 16 a warp
constexpr int F_MAXA = 128;             // most g + e·r
constexpr int F_MAX_SLICES = 8;         // most hidden slices: a cluster (the portable size)
constexpr int F_LDX = F_KD + 4;         // shared-memory row strides (floats) of A operands,
constexpr int F_LDC = F_CHUNK + 8;      // of an l2w chunk (B read in k order),
constexpr int F_LDA = F_MAXA + 1;       // of the summed accumulators (a row a thread)
static_assert(F_KD == 16 * F_WARPS && F_CHUNK == 16 * F_WARPS, "16 of a chunk a warp");

// Row strides of the [g0w | l1w] stage (B read in k order) and of the
// [g0w2 | l1w2] stage (B read in the accumulator's column order) for NT n8
// tiles: a warp's fragment reads fall on 32 distinct banks.
__host__ __device__ constexpr int ldw1(int nt) { return 8 * nt + 8; }
__host__ __device__ constexpr int ldw2(int nt) { return 8 * nt + 4; }

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
  int A, ER, ERP;        // g + e·r; e·r; e·r rounded up to 8
  int A4;                // g + e·r rounded up to 4: a partial's row stride
  float sqrt_fin, sqrt_hidden;
  uint8_t* routes;
  int slices;            // blocks of a cluster: hidden slices, and shares of the rest
  int kchunks_per_slice; // depth chunks of F_KD of MoELinear 1 a block
  int chunks_per_slice;  // hidden chunks of F_CHUNK columns a block
  int cols_per_block;    // output columns a block (a multiple of F_CHUNK)
  int vec;               // 16-byte copies: fin, hidden and A multiples of 4
  int stage;             // floats of a pipeline stage
};

// Floats of a stage: the larger of MoELinear 1's (an x chunk, a [g0w |
// l1w] chunk) and a hidden chunk's (l2w1 then l2b1: ERP + 8 rows, [g0w2 |
// l1w2]); an output chunk's (l2w2 then l2b2) is smaller.
__host__ __device__ constexpr int stage32(int nt, int erp) {
  return F_ROWS * F_LDX + F_KD * ldw1(nt) > (erp + 8) * F_LDC + F_CHUNK * ldw2(nt)
             ? F_ROWS * F_LDX + F_KD * ldw1(nt)
             : (erp + 8) * F_LDC + F_CHUNK * ldw2(nt);
}
// A block's shared memory: two stages, then hw (F_ROWS x (ERP + 12)), the
// combine weights (F_ROWS x MAXE), the LayerNorm statistics (2 x F_ROWS)
// and, in a cluster, the block's two partials the cluster reads (2 x F_ROWS
// x A4).  Between pipelines the first stage holds the warps' partial
// accumulators (F_WARPS x F_ROWS x (8·NT + 8) floats) and the gate's
// scratch (F_ROWS x (g + 1), g x e, F_ROWS x MAXE, A + e floats; g <
// F_MAXA), the second the summed accumulators (F_ROWS x F_LDA): two blocks
// of the nano-mini widths (NT 12) fit an SM.
__host__ __device__ constexpr size_t smem32(int stage, int erp, int a4, bool cluster) {
  return ((size_t)2 * stage + F_ROWS * (erp + 12) + F_ROWS * MAXE + 2 * F_ROWS +
          (cluster ? 2 * F_ROWS * a4 : 0)) *
         sizeof(float);
}
static_assert(smem32(stage32(16, 128), 128, 128, true) <= 232448,
              "the widest block fits an SM");
static_assert(2 * (smem32(stage32(12, 64), 64, 96, true) + 1024) <= 233472,
              "two blocks of the nano-mini widths fit an SM");
constexpr int GATE_FLOATS = F_ROWS * F_MAXA + F_MAXA * MAXE + F_ROWS * MAXE + F_MAXA + MAXE;
static_assert(F_WARPS * F_ROWS == F_KD && GATE_FLOATS <= stage32(4, 8) &&
                  F_ROWS * F_LDA <= stage32(4, 8),
              "the warps' partials and the gate's scratch fit the first stage, the sums "
              "the second");

// The block's shared memory.  Plain pointers into the one extern array,
// never an array of pointers indexed at run time: such an array goes to
// local memory, and every pointer read from it loses its address space
// (generic loads where shared ones belong).
struct Smem32 {
  float* stage;  // the two stages: stage i at stage + i·stride
  int stride;    // floats of a stage
  float* hw;     // F_ROWS x (ERP + 12): [hw | c] of MoELinear 1, then 2 (the A operands)
  float* acc;    // F_ROWS x F_LDA, in the second stage: a MoELinear's accumulators, summed
  float* c;      // F_ROWS x MAXE: its combine weights
  float* st;     // LayerNorm mean (F_ROWS), then rstd (F_ROWS)
  float* part;   // in a cluster: the block's partials of MoELinear 1, then 2 (F_ROWS x A4 each)
};

__device__ __forceinline__ Smem32 carve32(float* sm, const Args32& p) {
  Smem32 s;
  s.stage = sm;
  s.stride = p.stage;
  s.hw = sm + 2 * p.stage;
  s.acc = sm + p.stage;
  s.c = s.hw + F_ROWS * (p.ERP + 12);
  s.st = s.c + F_ROWS * MAXE;
  s.part = s.st + 2 * F_ROWS;
  return s;
}

// rows x COLS floats of a row-major matrix (row stride lds) from its
// (r0, c0) into dst (row stride ldd) by cp.async, zeros past row nrows and
// column ncols.  vec: 16-byte copies (lds, c0 and ncols multiples of 4).
template <int COLS>
__device__ __forceinline__ void copy32(float* dst, int ldd, const float* src, size_t lds, int r0,
                                       int c0, int rows, int nrows, int ncols, bool vec) {
  if (vec) {
    constexpr int PER = COLS / 4;
    for (int i = threadIdx.x; i < rows * PER; i += F_THREADS) {
      const int r = i / PER, c = (i % PER) * 4;
      const bool in = r0 + r < nrows && c0 + c < ncols;
      cp_async16(dst + r * ldd + c, in ? src + (size_t)(r0 + r) * lds + c0 + c : src, in);
    }
  } else {
    for (int i = threadIdx.x; i < rows * COLS; i += F_THREADS) {
      const int r = i / COLS, c = i % COLS;
      const bool in = r0 + r < nrows && c0 + c < ncols;
      cp_async4(dst + r * ldd + c, in ? src + (size_t)(r0 + r) * lds + c0 + c : src, in);
    }
  }
}

// The double-buffered pipeline: for chunk i of n, ``load(i, buf)`` issues
// its cp.async copies and ``use(i, buf)`` computes on them.
template <class Load, class Use>
__device__ __forceinline__ void pipeline32(const Smem32& s, int n, Load load, Use use) {
  if (n <= 0) return;
  load(0, s.stage);
  cp_async_commit();
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) {
      load(i + 1, s.stage + ((i + 1) & 1) * s.stride);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    use(i, s.stage + (i & 1) * s.stride);
    __syncthreads();
  }
}

// Four floats at ``local`` in the shared memory of the cluster's block
// ``rank``.
__device__ __forceinline__ float4 ld_cluster4(const float* local, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(local))), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

// A MoELinear's accumulators on the block's rows into s.acc: the warps'
// partials (16 x 8·NT each, the mma layout) summed in warp order through the
// stage area; in a cluster the block's sum goes to s.part[which], and every
// block sums the cluster's in rank order from their shared memory, behind
// a cluster barrier (every block's partial is in).
template <int NT>
__device__ __forceinline__ void sum_partials(const Args32& p, const Smem32& s,
                                             const float (&acc)[NT][4], int which) {
  constexpr int W = 8 * NT + 8;  // 8 modulo 32: a warp's float2 stores on distinct banks
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c4 = lane % 4;
  float* red = s.stage;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(red + (warp * F_ROWS + g + 8 * h) * W + 8 * n + 2 * c4) =
          make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
  __syncthreads();
  const bool cluster = p.slices > 1;
  float* dst = cluster ? s.part + which * F_ROWS * p.A4 : s.acc;
  const int ld = cluster ? p.A4 : F_LDA;
  for (int i = threadIdx.x; i < F_ROWS * p.A; i += F_THREADS) {
    const int rr = i / p.A, col = i % p.A;
    float v = red[rr * W + col];
#pragma unroll
    for (int w = 1; w < F_WARPS; ++w) v += red[(w * F_ROWS + rr) * W + col];
    dst[rr * ld + col] = v;
  }
  if (!cluster) {
    __syncthreads();
    return;
  }
  cluster_arrive();
  cluster_wait();
  const float* mine = s.part + which * F_ROWS * p.A4;
  for (int i = threadIdx.x; i < F_ROWS * p.A4 / 4; i += F_THREADS) {
    const int at = 4 * i, rr = at / p.A4, col = at % p.A4;
    float4 u[F_MAX_SLICES];
#pragma unroll
    for (int r = 0; r < F_MAX_SLICES; ++r)
      if (r < p.slices) u[r] = ld_cluster4(mine + at, r);
    float4 v = u[0];
#pragma unroll
    for (int r = 1; r < F_MAX_SLICES; ++r) {
      if (r < p.slices) {
        v.x += u[r].x;
        v.y += u[r].y;
        v.z += u[r].z;
        v.w += u[r].w;
      }
    }
    const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (col + j < p.A) s.acc[rr * F_LDA + col + j] = vs[j];
  }
  __syncthreads();
}

// A row's softmax and top-k (lowest-index ties) of its e scaled gate
// logits ``lg``: the kept gate values (unnormalised) to ``comb`` (e
// values); returns the bit mask.
__device__ __forceinline__ unsigned topk_gate(const float (&lg)[MAXE], int e, int k,
                                              float (&comb)[MAXE]) {
  float v[MAXE], mx = -INFINITY, sum = 0.f;
#pragma unroll
  for (int q = 0; q < MAXE; ++q) {
    if (q < e) {
      v[q] = lg[q];
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
    comb[q] = 0.f;
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

// A MoELinear's gate on the block's rows from s.acc (rows past n too, on
// their zero input, never written out), its steps spread over the block:
// ba, g1w and g1b copied to the first stage (free between pipelines), a =
// gelu(acc[j] + ba[j]) for every (row, j < g), lg = (a·g1w + g1b) /
// sqrt_in for every (row, expert), then a thread a row: softmax, top-k,
// the combine weights to s.c and routes to column ``which`` (>= 0) of
// p.routes; then [hw | c] into s.hw: hw = gelu(acc[g + q] + ba[g + q]) ·
// c[q / r] (zeros from e·r to ERP), then c (zeros from e to 8), so that
// one product gives hw·l2w + c·l2b.  (A warp a row, and these loops
// unrolled to fixed counts, both measured slower.)
__device__ __forceinline__ void gate_block(const Args32& p, const Smem32& s, const float* ba,
                                           const float* g1w, const float* g1b, float sqrt_in,
                                           int row0, int which) {
  const int t = threadIdx.x, g = p.g, e = p.e;
  float* ga = s.stage;                   // F_ROWS x (g + 1)
  float* gw = ga + F_ROWS * (g + 1);     // g x e
  float* lg = gw + g * e;                // F_ROWS x MAXE
  float* bs = lg + F_ROWS * MAXE;        // ba (A), then g1b (e)
  for (int i = t; i < p.A; i += F_THREADS) bs[i] = ba[i];
  for (int i = t; i < e; i += F_THREADS) bs[p.A + i] = g1b[i];
  for (int i = t; i < g * e; i += F_THREADS) gw[i] = g1w[i];
  __syncthreads();
  for (int i = t; i < F_ROWS * g; i += F_THREADS) {
    const int rr = i / g, j = i % g;
    ga[rr * (g + 1) + j] = act(s.acc[rr * F_LDA + j] + bs[j]);
  }
  __syncthreads();
  for (int i = t; i < F_ROWS * e; i += F_THREADS) {
    const int rr = i / e, q = i % e;
    float v = 0.f;
    for (int j = 0; j < g; ++j) v = fmaf(ga[rr * (g + 1) + j], gw[j * e + q], v);
    lg[rr * MAXE + q] = (v + bs[p.A + q]) / sqrt_in;
  }
  __syncthreads();
  if (t < F_ROWS) {
    float v[MAXE], c[MAXE];
#pragma unroll
    for (int q = 0; q < MAXE; ++q) v[q] = lg[t * MAXE + q];
    const unsigned bits = topk_gate(v, e, p.k, c);
#pragma unroll
    for (int q = 0; q < MAXE; ++q) s.c[t * MAXE + q] = c[q];
    if (which >= 0 && p.routes != nullptr && row0 + t < p.n)
      p.routes[(size_t)(row0 + t) * 2 + which] = (uint8_t)bits;
  }
  __syncthreads();
  const int kh = p.ERP + 8, ldh = kh + 4;
  for (int i = t; i < F_ROWS * kh; i += F_THREADS) {
    const int rr = i / kh, q = i % kh;
    s.hw[rr * ldh + q] =
        q < p.ER    ? act(s.acc[rr * F_LDA + g + q] + bs[g + q]) * s.c[rr * MAXE + q / p.r]
        : q < p.ERP ? 0.f
        : q - p.ERP < e ? s.c[rr * MAXE + q - p.ERP]
                        : 0.f;
  }
  __syncthreads();
}

// y (16 x 16: two n8 tiles) = hw (16 x kh, row stride ldh) · B (kh rows of
// stride F_LDC from its column 0), 3xTF32, the three products of a k-step
// independent (mma3x: two tiles give few chains to overlap otherwise).
__device__ __forceinline__ void chunk_product(float (&y)[2][4], const float* hw, int ldh, int kh,
                                              const float* B) {
  const int lane = threadIdx.x % 32, g = lane / 4, c4 = lane % 4;
  const float* a = hw + g * ldh + c4;
  const float* b = B + c4 * F_LDC + g;
#pragma unroll 2
  for (int k0 = 0; k0 < kh; k0 += 8) {
    uint32_t ab[4], as[4];
    split(a[k0], ab[0], as[0]);
    split(a[8 * ldh + k0], ab[1], as[1]);
    split(a[k0 + 4], ab[2], as[2]);
    split(a[8 * ldh + k0 + 4], ab[3], as[3]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t bb[2], bs[2];
      split(b[k0 * F_LDC + 8 * j], bb[0], bs[0]);
      split(b[(k0 + 4) * F_LDC + 8 * j], bb[1], bs[1]);
      mma3x(y[j], ab, as, bb, bs);
    }
  }
}

// MoELinear 1's product on the block's rows, its depth chunks [k0, k1) of
// F_KD: the warps' partial accumulators of [LN(]x[)]·[g0w | l1w].
template <int NT>
__device__ __forceinline__ void first_product32(const Args32& p, const Smem32& s, int row0,
                                                int k0, int k1, float (&acc)[NT][4]) {
  constexpr int LDW = ldw1(NT);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c4 = lane % 4;
  const int fin = p.fin;
  const bool ln = p.ln_w != nullptr;
  if (ln) {  // two-pass statistics of the whole row, a warp a row
    for (int rr = warp; rr < F_ROWS; rr += F_WARPS) {
      const int row = row0 + rr;
      float mean = 0.f, rstd = 0.f;
      if (row < p.n) {
        const float* xr = p.x + (size_t)row * fin;
        float sum = 0.f;
        for (int c = lane; c < fin; c += 32) sum += xr[c];
        mean = warp_sum(sum) / fin;
        float v = 0.f;
        for (int c = lane; c < fin; c += 32) {
          const float d = xr[c] - mean;
          v = fmaf(d, d, v);
        }
        rstd = rsqrtf(warp_sum(v) / fin + 1e-5f);
      }
      if (lane == 0) {
        s.st[rr] = mean;
        s.st[F_ROWS + rr] = rstd;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int kw = 16 * warp;  // the warp's depth in each chunk
  pipeline32(
      s, k1 - k0,
      [&](int i, float* buf) {
        const int d0 = (k0 + i) * F_KD;
        copy32<F_KD>(buf, F_LDX, p.x, fin, row0, d0, F_ROWS, p.n, fin, p.vec);
        copy32<8 * NT>(buf + F_ROWS * F_LDX, LDW, p.wa1, p.A, d0, 0, F_KD, fin, p.A, p.vec);
      },
      [&](int i, float* buf) {
        float* xs = buf;
        const float* ws = buf + F_ROWS * F_LDX;
        if (ln) {  // the warp's 16 columns of the chunk, in place
          for (int v = lane; v < F_ROWS * 16; v += 32) {
            const int rr = v / 16, kk = kw + v % 16, col = (k0 + i) * F_KD + kk;
            if (row0 + rr < p.n && col < fin) {
              float y = (xs[rr * F_LDX + kk] - s.st[rr]) * s.st[F_ROWS + rr] * p.ln_w[col];
              if (p.ln_b != nullptr) y += p.ln_b[col];
              xs[rr * F_LDX + kk] = y;
            }
          }
          __syncwarp();
        }
#pragma unroll
        for (int kk = kw; kk < kw + 16; kk += 8) {
          uint32_t ab[4], as[4];
          split(xs[g * F_LDX + kk + c4], ab[0], as[0]);
          split(xs[(g + 8) * F_LDX + kk + c4], ab[1], as[1]);
          split(xs[g * F_LDX + kk + c4 + 4], ab[2], as[2]);
          split(xs[(g + 8) * F_LDX + kk + c4 + 4], ab[3], as[3]);
          const float* b = ws + (kk + c4) * LDW + g;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            uint32_t bb[2], bs[2];
            split(b[8 * n], bb[0], bs[0]);
            split(b[4 * LDW + 8 * n], bb[1], bs[1]);
            mma3<true>(acc[n], ab, as, bb, bs);
          }
        }
      });
}

// Hidden chunks [c0, c1): acc2 (the warp's part) += gelu([hw1 | c1]·[l2w1;
// l2b1]) · [g0w2 | l1w2], 16 columns of each chunk a warp.
template <int NT>
__device__ __forceinline__ void hidden_slice32(const Args32& p, const Smem32& s, int c0, int c1,
                                               float (&acc2)[NT][4]) {
  constexpr int LDW = ldw2(NT);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c4 = lane % 4;
  const int hidden = p.hidden, erp = p.ERP, off_w = (erp + 8) * F_LDC;
#pragma unroll
  for (int n = 0; n < NT; ++n) acc2[n][0] = acc2[n][1] = acc2[n][2] = acc2[n][3] = 0.f;
  pipeline32(
      s, c1 - c0,
      [&](int i, float* buf) {
        const int h0 = (c0 + i) * F_CHUNK;
        copy32<F_CHUNK>(buf, F_LDC, p.l2w1, hidden, 0, h0, erp, p.ER, hidden, p.vec);
        copy32<F_CHUNK>(buf + erp * F_LDC, F_LDC, p.l2b1, hidden, 0, h0, 8, p.e, hidden, p.vec);
        copy32<8 * NT>(buf + off_w, LDW, p.wa2, p.A, h0, 0, F_CHUNK, hidden, p.A, p.vec);
      },
      [&](int, float* buf) {
        float y[2][4] = {};
        chunk_product(y, s.hw, erp + 12, erp + 8, buf + 16 * warp);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int u = 0; u < 4; ++u) y[j][u] = act(y[j][u]);
#pragma unroll
        for (int kq = 0; kq < 2; ++kq) {
          uint32_t ab[4], as[4];
          split(y[kq][0], ab[0], as[0]);
          split(y[kq][2], ab[1], as[1]);
          split(y[kq][1], ab[2], as[2]);
          split(y[kq][3], ab[3], as[3]);
          const float* b = buf + off_w + (16 * warp + 8 * kq + 2 * c4) * LDW + g;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            uint32_t bb[2], bs[2];
            split(b[8 * n], bb[0], bs[0]);
            split(b[LDW + 8 * n], bb[1], bs[1]);
            mma3<true>(acc2[n], ab, as, bb, bs);
          }
        }
      });
}

// Output columns [n0, n1) of the block's rows from s.acc (MoELinear 2's
// accumulators): its gate (routes where ``routes_here``), then
// y = [hw2 | c2]·[l2w2; l2b2] [+ residual] through the row map, 16 columns
// of each chunk a warp.
__device__ __forceinline__ void output32(const Args32& p, const Smem32& s, int row0, int n0,
                                         int n1, bool routes_here) {
  gate_block(p, s, p.ba2, p.g1w2, p.g1b2, p.sqrt_hidden, row0, routes_here ? 1 : -1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c4 = lane % 4;
  const int fin = p.fin, erp = p.ERP;
  pipeline32(
      s, (n1 - n0 + F_CHUNK - 1) / F_CHUNK,
      [&](int i, float* buf) {
        const int c0 = n0 + i * F_CHUNK;
        copy32<F_CHUNK>(buf, F_LDC, p.l2w2, fin, 0, c0, erp, p.ER, fin, p.vec);
        copy32<F_CHUNK>(buf + erp * F_LDC, F_LDC, p.l2b2, fin, 0, c0, 8, p.e, fin, p.vec);
      },
      [&](int i, float* buf) {
        const int c0 = n0 + i * F_CHUNK;
        float y[2][4] = {};
        chunk_product(y, s.hw, erp + 12, erp + 8, buf + 16 * warp);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rr = g + 8 * h, m = row0 + rr;
          if (m >= p.n) continue;
          const size_t orow = (size_t)(m / p.rpi) * p.orpi + m % p.rpi;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int uu = 0; uu < 2; ++uu) {
              const int col = c0 + 16 * warp + 8 * j + 2 * c4 + uu;
              if (col >= n1) continue;
              float o = y[j][2 * h + uu];
              if (p.res != nullptr) o = p.res[(size_t)m * fin + col] + o;
              p.out[orow * fin + col] = o;
            }
        }
      });
}

// Grid (row tiles, slices), a cluster (1, slices, 1) a row tile: block
// (row tile, r) takes MoELinear 1's r-th share of depth, hidden slice r and
// the r-th share of the output columns.
template <int NT>
__global__ void __launch_bounds__(F_THREADS) moe32_kernel(Args32 p) {
  extern __shared__ __align__(16) float smem32_raw[];
  const Smem32 s = carve32(smem32_raw, p);
  const int row0 = blockIdx.x * F_ROWS, r = blockIdx.y;
  const int kchunks = (p.fin + F_KD - 1) / F_KD, chunks = (p.hidden + F_CHUNK - 1) / F_CHUNK;
  float acc[NT][4];
  const int k0 = r * p.kchunks_per_slice;
  first_product32<NT>(p, s, row0, min(k0, kchunks), min(k0 + p.kchunks_per_slice, kchunks), acc);
  sum_partials<NT>(p, s, acc, 0);
  gate_block(p, s, p.ba1, p.g1w1, p.g1b1, p.sqrt_fin, row0, r == 0 ? 0 : -1);
  const int c0 = r * p.chunks_per_slice;
  hidden_slice32<NT>(p, s, c0, min(c0 + p.chunks_per_slice, chunks), acc);
  sum_partials<NT>(p, s, acc, 1);
  if (p.slices > 1) {  // every block has read the cluster's partials before any goes on
    cluster_arrive();
    cluster_wait();
  }
  const int n0 = r * p.cols_per_block;
  output32(p, s, row0, min(n0, p.fin), min(n0 + p.cols_per_block, p.fin), r == 0);
}

template <int NT>
int launch32(Args32 a, int row_tiles, cudaStream_t st) {
  a.stage = stage32(NT, a.ERP);
  const size_t smem = smem32(a.stage, a.ERP, a.A4, a.slices > 1);
  cudaError_t err = cudaFuncSetAttribute(moe32_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(row_tiles, a.slices, 1);
  cfg.blockDim = dim3(F_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = a.slices;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, moe32_kernel<NT>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The f32 form: one launch, ``slices`` (1 to F_MAX_SLICES) blocks a row
// tile in a cluster, trimmed so that no hidden slice is empty.
extern "C" int moe_ffn_launch_f32(const void* x, void* out, int n, int fin, int hidden,
                                  const void* ln_w, const void* ln_b, const void* res,
                                  int rpi, int orpi,
                                  const void* wa1, const void* ba1, const void* g1w1,
                                  const void* g1b1, const void* l2w1, const void* l2b1,
                                  const void* wa2, const void* ba2, const void* g1w2,
                                  const void* g1b2, const void* l2w2, const void* l2b2,
                                  int g, int e, int r, int k, void* routes, int slices,
                                  void* stream) {
  if (n <= 0 || fin <= 0 || hidden <= 0 || g < 1 || e < 1 || e > MAXE || r < 1 ||
      g + e * r > F_MAXA || k < 1 || rpi <= 0 || orpi < rpi || slices < 1 ||
      slices > F_MAX_SLICES)
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
  a.A = g + e * r;
  a.A4 = (a.A + 3) / 4 * 4;
  a.ER = e * r;
  a.ERP = (a.ER + 7) / 8 * 8;
  a.sqrt_fin = (float)sqrt((double)fin);
  a.sqrt_hidden = (float)sqrt((double)hidden);
  a.routes = static_cast<uint8_t*>(routes);
  a.vec = fin % 4 == 0 && hidden % 4 == 0 && a.A % 4 == 0;
  const int chunks = (hidden + F_CHUNK - 1) / F_CHUNK;
  a.chunks_per_slice = (chunks + slices - 1) / slices;
  a.slices = slices = (chunks + a.chunks_per_slice - 1) / a.chunks_per_slice;
  a.kchunks_per_slice = ((fin + F_KD - 1) / F_KD + slices - 1) / slices;
  a.cols_per_block = ((fin + F_CHUNK - 1) / F_CHUNK + slices - 1) / slices * F_CHUNK;
  const int row_tiles = (n + F_ROWS - 1) / F_ROWS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nt = a.A <= 32 ? 4 : a.A <= 64 ? 8 : a.A <= 96 ? 12 : 16;
  return nt == 4    ? launch32<4>(a, row_tiles, st)
         : nt == 8  ? launch32<8>(a, row_tiles, st)
         : nt == 12 ? launch32<12>(a, row_tiles, st)
                    : launch32<16>(a, row_tiles, st);
}
