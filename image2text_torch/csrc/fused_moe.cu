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
// Design: a thread block owns 16 rows and runs the whole chain on them with
// WMMA bf16 tensor-core products (f32 accumulators).  Its warps split each
// stage's long dimension (fin for the first products, the hidden chunks,
// the output columns) and meet in shared memory for the f32 partial-sum
// reduction and the gates.  The hidden dimension is streamed in 64-wide
// chunks: each chunk of gelu(hw·l2w + c·l2b) is consumed at once by the
// second MoELinear's narrow accumulators (gate 32 + experts 64 columns), so
// the hidden-wide activation never reaches device memory.  Weights are read
// through the L1/L2 caches.  Any row count works: the ragged last tile is
// masked.
#include "common.cuh"

using namespace i2t;

namespace {

constexpr int NA = 6;     // (gate + experts·rank) / 16 = (32 + 64) / 16
constexpr int NE = 4;     // experts·rank / 16
constexpr int ACCW = 96;  // f32 staging width (NA·16, and >= the chunk width)
constexpr int CH = 64;    // hidden chunk width and the x staging width
constexpr int MAXE = 8;   // most experts

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
  int g, e, r, k;
  float sqrt_fin, sqrt_hidden;
  uint8_t* routes;  // optional (n, 2) selected-expert bit masks
};

struct Shared {
  float acc[16 * ACCW];   // reduced f32 accumulators of the current stage
  bf16 hw[16 * 64];       // z ∘ expand(c) of the current MoELinear
  float comb[16 * MAXE];  // combine weights (bf16 values) per row
  float stat[32];         // LayerNorm mean and rstd per row
};
// Per-warp region: the stage's f32 partial sums, or a 16x64 f32 staging
// tile plus a 16x64 bf16 A-operand tile.
constexpr int WARP_BYTES = 16 * ACCW * 4;
static_assert(WARP_BYTES >= 16 * CH * 4 + 16 * CH * 2, "warp region");

// Gate MLP, softmax, top-k combine and z ∘ c for the block's 16 rows, from
// s.acc = x·[g0w | l1w] (f32).  Writes s.comb and s.hw.
__device__ void gate_and_hw(Shared& s, const MoEW& m, const Args& p, float sqrt_in,
                            int row0, int nrows, int which) {
  const int g = p.g, e = p.e, r = p.r, tid = threadIdx.x;
  if (tid < 16) {
    const int row = tid;
    float lg[MAXE];
#pragma unroll
    for (int q = 0; q < MAXE; ++q) lg[q] = 0.f;
    for (int j = 0; j < g; ++j) {
      const float a = rbf(gelu_tanh(rbf(rbf(s.acc[row * ACCW + j]) + to_f(m.ba[j]))));
#pragma unroll
      for (int q = 0; q < MAXE; ++q)
        if (q < e) lg[q] += a * to_f(m.g1w[j * e + q]);
    }
    float v[MAXE];
    float mx = -INFINITY;
#pragma unroll
    for (int q = 0; q < MAXE; ++q) {
      if (q < e) {
        v[q] = rbf(rbf(lg[q]) + to_f(m.g1b[q])) / sqrt_in;
        mx = fmaxf(mx, v[q]);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < MAXE; ++q) {
      if (q < e) {
        v[q] = expf(v[q] - mx);
        sum += v[q];
      }
    }
#pragma unroll
    for (int q = 0; q < MAXE; ++q) {
      if (q < e) v[q] = v[q] / sum;
    }
    unsigned bits = 0;
#pragma unroll
    for (int q = 0; q < MAXE; ++q) {
      if (q < e) {
        int rank = 0;
#pragma unroll
        for (int j = 0; j < MAXE; ++j)
          if (j < e) rank += (v[j] > v[q]) || (v[j] == v[q] && j < q);
        const bool keep = rank < p.k;
        s.comb[row * MAXE + q] = keep ? rbf(v[q]) : 0.f;
        bits |= keep ? (1u << q) : 0u;
      }
    }
    if (p.routes != nullptr && row < nrows)
      p.routes[(size_t)(row0 + row) * 2 + which] = (uint8_t)bits;
  }
  __syncthreads();
  const int er = e * r;
  for (int i = tid; i < 16 * er; i += blockDim.x) {
    const int row = i / er, c = i % er;
    const float z = rbf(gelu_tanh(rbf(rbf(s.acc[row * ACCW + g + c]) + to_f(m.ba[g + c]))));
    s.hw[row * 64 + c] = to_bf(z * s.comb[row * MAXE + c / r]);
  }
  __syncthreads();
}

// Σ_e c_e · l2b[e, col], rounded to bf16 (the c·l2b product).
__device__ __forceinline__ float comb_bias(const Shared& s, const bf16* l2b, int e, int fout,
                                           int row, int col) {
  float acc = 0.f;
  for (int q = 0; q < e; ++q) acc += s.comb[row * MAXE + q] * to_f(l2b[(size_t)q * fout + col]);
  return rbf(acc);
}

// Each warp's partial accumulators to its region, then their sum to s.acc.
__device__ void reduce_partials(Shared& s, unsigned char* regions, FragC (&acc)[NA], int warp) {
  float* part = reinterpret_cast<float*>(regions + warp * WARP_BYTES);
#pragma unroll
  for (int j = 0; j < NA; ++j) wmma::store_matrix_sync(part + j * 16, acc[j], ACCW, wmma::mem_row_major);
  __syncthreads();
  const int nw = blockDim.x / 32;
  for (int i = threadIdx.x; i < 16 * ACCW; i += blockDim.x) {
    float v = 0.f;
    for (int w = 0; w < nw; ++w) v += reinterpret_cast<const float*>(regions + w * WARP_BYTES)[i];
    s.acc[i] = v;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(512) moe_ffn_kernel(Args p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Shared& s = *reinterpret_cast<Shared*>(smem_raw);
  unsigned char* regions = smem_raw + sizeof(Shared);
  const int nw = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* stg = reinterpret_cast<float*>(regions + warp * WARP_BYTES);
  bf16* sa = reinterpret_cast<bf16*>(regions + warp * WARP_BYTES + 16 * CH * 4);
  const int row0 = blockIdx.x * 16;
  const int nrows = min(16, p.n - row0);
  const int fin = p.fin, hidden = p.hidden;

  // LayerNorm prologue statistics (f32, two-pass), a row per warp.
  if (p.ln_w != nullptr) {
    for (int row = warp; row < nrows; row += nw) {
      const bf16* xr = p.x + (size_t)(row0 + row) * fin;
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
        s.stat[row] = mean;
        s.stat[16 + row] = rsqrtf(var + 1e-5f);
      }
    }
    __syncthreads();
  }

  // Phase A: acc = LN?(x) · [g0w | l1w]  (16 x 96); warps split fin.
  FragC acc[NA];
#pragma unroll
  for (int j = 0; j < NA; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int k0 = warp * CH; k0 < fin; k0 += nw * CH) {
    for (int v = lane; v < 16 * CH / 8; v += 32) {
      const int row = v / (CH / 8), c = (v % (CH / 8)) * 8;
      Bf16x8 pk;
      if (row < nrows) {
        pk = *reinterpret_cast<const Bf16x8*>(p.x + (size_t)(row0 + row) * fin + k0 + c);
        if (p.ln_w != nullptr) {
          const float mean = s.stat[row], rstd = s.stat[16 + row];
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            float y = (to_f(pk.v[t]) - mean) * rstd;
            y = y * to_f(p.ln_w[k0 + c + t]);
            if (p.ln_b != nullptr) y = y + to_f(p.ln_b[k0 + c + t]);
            pk.v[t] = to_bf(y);
          }
        }
      } else {
#pragma unroll
        for (int t = 0; t < 8; ++t) pk.v[t] = to_bf(0.f);
      }
      *reinterpret_cast<Bf16x8*>(&sa[row * CH + c]) = pk;
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < CH / 16; ++kk) {
      FragA fa;
      wmma::load_matrix_sync(fa, sa + kk * 16, CH);
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        FragB fb;
        wmma::load_matrix_sync(fb, p.m1.wa + (size_t)(k0 + kk * 16) * ACCW + j * 16, ACCW);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncwarp();
  }
  reduce_partials(s, regions, acc, warp);
  gate_and_hw(s, p.m1, p, p.sqrt_fin, row0, nrows, 0);

  // Phase C: warps split the hidden chunks; each chunk of
  // gelu(hw·l2w + c·l2b) feeds the second MoELinear's accumulators.
  FragA ahw[NE];
#pragma unroll
  for (int kk = 0; kk < NE; ++kk) wmma::load_matrix_sync(ahw[kk], s.hw + kk * 16, 64);
#pragma unroll
  for (int j = 0; j < NA; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int h0 = warp * CH; h0 < hidden; h0 += nw * CH) {
#pragma unroll
    for (int jj = 0; jj < CH / 16; ++jj) {
      FragC c;
      wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int kk = 0; kk < NE; ++kk) {
        FragB fb;
        wmma::load_matrix_sync(fb, p.m1.l2w + (size_t)(kk * 16) * hidden + h0 + jj * 16, hidden);
        wmma::mma_sync(c, ahw[kk], fb, c);
      }
      wmma::store_matrix_sync(stg + jj * 16, c, CH, wmma::mem_row_major);
    }
    __syncwarp();
    for (int v = lane; v < 16 * CH / 8; v += 32) {
      const int row = v / (CH / 8), c = (v % (CH / 8)) * 8;
      Bf16x8 pk;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float y = rbf(stg[row * CH + c + t]);
        const float yb = comb_bias(s, p.m1.l2b, p.e, hidden, row, h0 + c + t);
        pk.v[t] = to_bf(gelu_tanh(rbf(y + yb)));
      }
      *reinterpret_cast<Bf16x8*>(&sa[row * CH + c]) = pk;
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < CH / 16; ++kk) {
      FragA fa;
      wmma::load_matrix_sync(fa, sa + kk * 16, CH);
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        FragB fb;
        wmma::load_matrix_sync(fb, p.m2.wa + (size_t)(h0 + kk * 16) * ACCW + j * 16, ACCW);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncwarp();
  }
  reduce_partials(s, regions, acc, warp);
  gate_and_hw(s, p.m2, p, p.sqrt_hidden, row0, nrows, 1);

  // Phase E: out = hw2·l2w2 + c2·l2b2 [+ residual]; warps split columns.
#pragma unroll
  for (int kk = 0; kk < NE; ++kk) wmma::load_matrix_sync(ahw[kk], s.hw + kk * 16, 64);
  for (int n0 = warp * CH; n0 < fin; n0 += nw * CH) {
#pragma unroll
    for (int jj = 0; jj < CH / 16; ++jj) {
      FragC c;
      wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int kk = 0; kk < NE; ++kk) {
        FragB fb;
        wmma::load_matrix_sync(fb, p.m2.l2w + (size_t)(kk * 16) * fin + n0 + jj * 16, fin);
        wmma::mma_sync(c, ahw[kk], fb, c);
      }
      wmma::store_matrix_sync(stg + jj * 16, c, CH, wmma::mem_row_major);
    }
    __syncwarp();
    for (int v = lane; v < 16 * CH / 8; v += 32) {
      const int row = v / (CH / 8), c = (v % (CH / 8)) * 8;
      if (row < nrows) {
        const int m = row0 + row;
        Bf16x8 rk;
        if (p.res != nullptr) rk = *reinterpret_cast<const Bf16x8*>(p.res + (size_t)m * fin + n0 + c);
        Bf16x8 pk;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float y = rbf(stg[row * CH + c + t]);
          const float yb = comb_bias(s, p.m2.l2b, p.e, fin, row, n0 + c + t);
          float o = rbf(y + yb);
          if (p.res != nullptr) o = rbf(to_f(rk.v[t]) + o);
          pk.v[t] = to_bf(o);
        }
        const size_t orow = (size_t)(m / p.rpi) * p.orpi + m % p.rpi;
        *reinterpret_cast<Bf16x8*>(p.out + orow * fin + n0 + c) = pk;
      }
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int moe_ffn_launch(const void* x, void* out, int n, int fin, int hidden,
                              const void* ln_w, const void* ln_b, const void* res,
                              int rpi, int orpi,
                              const void* wa1, const void* ba1, const void* g1w1,
                              const void* g1b1, const void* l2w1, const void* l2b1,
                              const void* wa2, const void* ba2, const void* g1w2,
                              const void* g1b2, const void* l2w2, const void* l2b2,
                              int g, int e, int r, int k, void* routes, int warps,
                              void* stream) {
  if (n <= 0 || fin % CH || hidden % CH || g + e * r != NA * 16 || e * r != NE * 16 ||
      e > MAXE || k < 1 || warps < 1 || warps > 16 || rpi <= 0 || orpi < rpi)
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
  a.g = g;
  a.e = e;
  a.r = r;
  a.k = k;
  a.sqrt_fin = (float)sqrt((double)fin);
  a.sqrt_hidden = (float)sqrt((double)hidden);
  a.routes = static_cast<uint8_t*>(routes);
  const size_t smem = sizeof(Shared) + (size_t)WARP_BYTES * warps;
  cudaError_t err = cudaFuncSetAttribute(moe_ffn_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  moe_ffn_kernel<<<(n + 15) / 16, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
