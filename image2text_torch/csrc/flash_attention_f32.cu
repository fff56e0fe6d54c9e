// Flash attention in f32 for Hopper (sm_90a): the f32 forms of
// image2text_tpu/ops/flash_attention.py::_fwd_kernel, ::_bwd_dkv_kernel and
// ::_bwd_dq_kernel.  The JAX kernels are dtype-generic (their products take
// preferred_element_type=f32 and the forward writes q's dtype); the
// training configs with ``precision: 'no'`` (training_configs/local/
// synthetic-*.yaml) run them in f32.  The entry semantics are those of the
// bf16 kernels in flash_attention.cu: the (1|b, 1|h, 1|sq, skv) f32 bias
// clamped at NEG_BIG, K/V heads 1 or h, the in-kernel causal mask, the
// murmur3 keep mask of common.cuh::keep_hash, lse out, and a row that sees
// no key averaging every key (p = exp(NEG_BIG − NEG_BIG) = 1 forward, and
// p = exp(s − lse) = 1 backward, where lse rounds to NEG_BIG).  Nothing is
// rounded to a narrower type: p̃ = p · keep / (1 − rate) feeds the V
// product in f32.
//
// Products run on the CUDA cores in true f32 (FFMA), not TF32: Hopper's
// tensor cores take f32 only as TF32, which keeps ten mantissa bits.
//
// What bounds it on the H100: operations.  At the offline training shapes
// (synthetic-smoke.yaml: b 8, 4 heads, one K/V head, s 264, d 16) a
// forward is 2·2·b·h·s²·d = 71 MFLOP against 67 TFLOP/s of f32 FFMA, about
// 1 µs, and moves about 0.7 MB, 0.2 µs: both far below the launch time, so
// the kernels are simple.  One design for every shape:
//
// Forward (flash_fwd_f32_kernel): a block of 128 threads owns 32 query
// rows of one (batch, head), four threads a row, and walks the keys in
// 32-key tiles staged in shared memory with the online softmax of
// FlashAttention-2 (running max m, starting at NEG_BIG so a keyless row
// gives p = 1 as the plain version's clamp does; running sum l; the
// accumulator rescaled by exp(m_old − m_new)).  A thread computes 8 of its
// row's 32 scores, the quad exchanges maxima and sums by shuffles, the
// probabilities go through shared memory and each thread accumulates d/4
// columns of its row's output.  A causal tile without a bias stops at the
// band of its last row once every row sees a key (past it p = 0).
//
// Backward: two kernels, as the JAX package's.  dK/dV
// (flash_bwd_dkv_f32_kernel): a block owns 32 keys of one K/V plane and
// loops over the query heads that share it (multi-query: the sum over
// heads, in a fixed order) and over 32-row query tiles, recomputing
// p = exp(s − lse) and dS = p ∘ (keep·dP/(1 − rate) − D) for its keys;
// dV += p̃ᵀ dO and dK += dSᵀ Q accumulate in registers (d/4 columns a
// thread).  dQ (flash_bwd_dq_f32_kernel): a block owns 32 query rows of
// one (batch, head) and loops over the key tiles.  No atomics: reruns are
// bitwise equal.
#include "common.cuh"

using namespace i2t;

constexpr int F32_ROWS = 32;       // query rows or keys a block owns
constexpr int F32_KEYS = 32;       // keys (or query rows) of a staged tile
constexpr int F32_THREADS = 128;   // four threads a row
constexpr int F32_PLD = F32_KEYS + 1;  // row stride of a probability tile
static_assert(F32_THREADS == 4 * F32_ROWS && F32_KEYS == 32, "a quad a row, 8 columns a lane");

namespace {

constexpr float NEG_BIG = -0.7f * 3.40282346638528859811704183484516925e38f;

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
  int b, h, hk, sq, skv;
  int causal;
  float scale;
  int dropout;
  unsigned seed, threshold;
  float inv_keep;
  int plane_h, plane_off;  // the hash's plane of (batch i, head j): plane_off + i·plane_h + j
};

__device__ __forceinline__ int hash_plane(const Params32& p, int batch, int head) {
  return p.plane_off + batch * p.plane_h + head;
}

// The masked, scaled score of (row, col) from the product ``s``; the
// caller passes row < sq and col < skv.  ``bias`` is the plane's.
__device__ __forceinline__ float score(const Params32& p, const float* bias, float s, int row,
                                       int col) {
  s *= p.scale;
  if (bias != nullptr) s += fmaxf(bias[row * p.bsr + col], NEG_BIG);
  if (p.causal && col > row + p.skv - p.sq) s = NEG_BIG;
  return s;
}

__device__ __forceinline__ float keep(const Params32& p, int row, int col, int plane) {
  return keep_hash(row, col, plane, p.seed) < p.threshold ? p.inv_keep : 0.f;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows [r0, r0 + 32) of a (rows, D) f32 matrix into shared memory (row
// stride D + 1: the quads' rows fall on distinct banks), zeros past ``rows``.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0, int rows) {
  for (int i = threadIdx.x; i < F32_KEYS * D; i += F32_THREADS) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = r0 + r < rows ? src[(size_t)(r0 + r) * D + c] : 0.f;
  }
}

// The plane's bias, or null.
__device__ __forceinline__ const float* plane_bias(const Params32& p, int batch, int head) {
  return p.bias == nullptr ? nullptr : p.bias + batch * p.bsb + head * p.bsh;
}

// Whether a causal call without a bias may skip the pairs of query rows
// [q0, q0 + 32) and keys [k0, k0 + 32): every row sees a key (so none
// averages over all of them) and the tile's last row's band ends before k0.
__device__ __forceinline__ bool band_skips(const Params32& p, int q0, int k0) {
  return p.causal && p.bias == nullptr && q0 + p.skv - p.sq >= 0 &&
         q0 + F32_ROWS - 1 + p.skv - p.sq < k0;
}

template <int D>
struct Smem {
  static constexpr int LD = D + 1;
  static constexpr size_t fwd = (3 * F32_KEYS * LD + F32_ROWS * F32_PLD) * sizeof(float);
  static constexpr size_t dkv = (4 * F32_KEYS * LD + 2 * F32_ROWS * F32_PLD + 2 * F32_KEYS) *
                                sizeof(float);
  static constexpr size_t dq = (4 * F32_KEYS * LD + F32_ROWS * F32_PLD) * sizeof(float);
};

// grid (ceil(sq / 32), b·h)
template <int D>
__global__ void __launch_bounds__(F32_THREADS) flash_fwd_f32_kernel(Params32 p) {
  constexpr int LD = D + 1, NC = D / 4;
  extern __shared__ float sm[];
  float* qs = sm;
  float* ks = qs + F32_KEYS * LD;
  float* vs = ks + F32_KEYS * LD;
  float* ps = vs + F32_KEYS * LD;
  const int bh = blockIdx.y, batch = bh / p.h, head = bh % p.h;
  const int kv_plane = batch * p.hk + (p.hk == 1 ? 0 : head);
  const int q0 = blockIdx.x * F32_ROWS, r = threadIdx.x / 4, quad = threadIdx.x % 4;
  const int row = q0 + r;
  const bool live = row < p.sq;
  const float* k = p.k + (size_t)kv_plane * p.skv * D;
  const float* v = p.v + (size_t)kv_plane * p.skv * D;
  const float* bias = plane_bias(p, batch, head);
  load_rows<D>(qs, p.q + (size_t)bh * p.sq * D, q0, p.sq);
  float m = NEG_BIG, l = 0.f, acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < p.skv && !band_skips(p, q0, k0); k0 += F32_KEYS) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<D>(ks, k, k0, p.skv);
    load_rows<D>(vs, v, k0, p.skv);
    __syncthreads();
    float s[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = 0.f;
    for (int c = 0; c < D; ++c) {
      const float qv = qs[r * LD + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j] = fmaf(qv, ks[(quad + 4 * j) * LD + c], s[j]);
    }
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = k0 + quad + 4 * j;
      s[j] = live && col < p.skv ? score(p, bias, s[j], row, col) : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, quad_max(tmax));
    const float alpha = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = quad + 4 * j;
      float pj = expf(s[j] - m_new);  // 0 for a column past skv
      sum += pj;
      if (p.dropout && pj != 0.f) pj *= keep(p, row, k0 + col, hash_plane(p, batch, head));
      ps[r * F32_PLD + col] = pj;
    }
    l = l * alpha + quad_sum(sum);
    m = m_new;
    __syncwarp();  // a row's four threads are one warp's
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[i] *= alpha;
    for (int j = 0; j < F32_KEYS; ++j) {
      const float pj = ps[r * F32_PLD + j];
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[i] = fmaf(pj, vs[j * LD + quad + 4 * i], acc[i]);
    }
    __syncwarp();
  }
  if (!live) return;
  const float lc = fmaxf(l, 1e-30f);
  float* o = p.o + ((size_t)bh * p.sq + row) * D;
#pragma unroll
  for (int i = 0; i < NC; ++i) o[quad + 4 * i] = acc[i] / lc;
  if (quad == 0) p.lse_out[(size_t)bh * p.sq + row] = m + logf(lc);
}

// p̃ and dS of (query row, key) from the products s = q·k and dp = dO·v;
// zero for a pair outside the call.
__device__ __forceinline__ void grads_of(const Params32& p, const float* bias, float s, float dp,
                                         int row, int col, int plane, float lse, float dvec,
                                         float& pt, float& ds) {
  if (row >= p.sq || col >= p.skv) {
    pt = ds = 0.f;
    return;
  }
  const float pr = expf(score(p, bias, s, row, col) - lse);
  if (p.dropout) {
    const float kf = keep(p, row, col, plane);
    ds = pr * (kf * dp - dvec);
    pt = pr * kf;
  } else {
    ds = pr * (dp - dvec);
    pt = pr;
  }
}

// grid (ceil(skv / 32), b·hk): dK and dV of 32 keys, summed over the query
// heads that share them.
template <int D>
__global__ void __launch_bounds__(F32_THREADS) flash_bwd_dkv_f32_kernel(Params32 p) {
  constexpr int LD = D + 1, NC = D / 4;
  extern __shared__ float sm[];
  float* ks = sm;
  float* vs = ks + F32_KEYS * LD;
  float* qs = vs + F32_KEYS * LD;
  float* dos = qs + F32_KEYS * LD;
  float* pts = dos + F32_KEYS * LD;  // p̃ᵀ: [key][query row]
  float* dss = pts + F32_ROWS * F32_PLD;  // dSᵀ
  float* lse_s = dss + F32_ROWS * F32_PLD;
  float* dvec_s = lse_s + F32_KEYS;
  const int kv_plane = blockIdx.y, batch = kv_plane / p.hk;
  const int k0 = blockIdx.x * F32_ROWS, kr = threadIdx.x / 4, quad = threadIdx.x % 4;
  const int key = k0 + kr;
  load_rows<D>(ks, p.k + (size_t)kv_plane * p.skv * D, k0, p.skv);
  load_rows<D>(vs, p.v + (size_t)kv_plane * p.skv * D, k0, p.skv);
  float dk[NC], dv[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) dk[i] = dv[i] = 0.f;
  const int heads = p.hk == 1 ? p.h : 1;
  const int head0 = p.hk == 1 ? 0 : kv_plane % p.h;
  for (int hh = head0; hh < head0 + heads; ++hh) {
    const int plane = batch * p.h + hh;
    const float* bias = plane_bias(p, batch, hh);
    for (int q0 = 0; q0 < p.sq; q0 += F32_KEYS) {
      if (band_skips(p, q0, k0)) continue;
      __syncthreads();  // the previous tile's readers are done
      load_rows<D>(qs, p.q + (size_t)plane * p.sq * D, q0, p.sq);
      load_rows<D>(dos, p.dout + (size_t)plane * p.sq * D, q0, p.sq);
      if (threadIdx.x < F32_KEYS) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < p.sq ? p.lse[(size_t)plane * p.sq + row] : 0.f;
        dvec_s[threadIdx.x] = row < p.sq ? p.dvec[(size_t)plane * p.sq + row] : 0.f;
      }
      __syncthreads();
      float s[8], dp[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j] = dp[j] = 0.f;
      for (int c = 0; c < D; ++c) {
        const float kv = ks[kr * LD + c], vv = vs[kr * LD + c];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[j] = fmaf(kv, qs[(quad + 4 * j) * LD + c], s[j]);
          dp[j] = fmaf(vv, dos[(quad + 4 * j) * LD + c], dp[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int rr = quad + 4 * j;
        grads_of(p, bias, s[j], dp[j], q0 + rr, key, hash_plane(p, batch, hh), lse_s[rr],
                 dvec_s[rr],
                 pts[kr * F32_PLD + rr], dss[kr * F32_PLD + rr]);
      }
      __syncwarp();  // a key's four threads are one warp's
      for (int rr = 0; rr < F32_KEYS; ++rr) {
        const float pt = pts[kr * F32_PLD + rr], ds = dss[kr * F32_PLD + rr];
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          dv[i] = fmaf(pt, dos[rr * LD + quad + 4 * i], dv[i]);
          dk[i] = fmaf(ds, qs[rr * LD + quad + 4 * i], dk[i]);
        }
      }
      __syncwarp();
    }
  }
  if (key >= p.skv) return;
  const size_t at = ((size_t)kv_plane * p.skv + key) * D;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    p.dk[at + quad + 4 * i] = dk[i] * p.scale;
    p.dv[at + quad + 4 * i] = dv[i];
  }
}

// grid (ceil(sq / 32), b·h): dQ of 32 query rows.
template <int D>
__global__ void __launch_bounds__(F32_THREADS) flash_bwd_dq_f32_kernel(Params32 p) {
  constexpr int LD = D + 1, NC = D / 4;
  extern __shared__ float sm[];
  float* qs = sm;
  float* dos = qs + F32_KEYS * LD;
  float* ks = dos + F32_KEYS * LD;
  float* vs = ks + F32_KEYS * LD;
  float* dss = vs + F32_KEYS * LD;  // dS: [query row][key]
  const int bh = blockIdx.y, batch = bh / p.h, head = bh % p.h;
  const int kv_plane = batch * p.hk + (p.hk == 1 ? 0 : head);
  const int q0 = blockIdx.x * F32_ROWS, r = threadIdx.x / 4, quad = threadIdx.x % 4;
  const int row = q0 + r;
  const bool live = row < p.sq;
  const float* bias = plane_bias(p, batch, head);
  load_rows<D>(qs, p.q + (size_t)bh * p.sq * D, q0, p.sq);
  load_rows<D>(dos, p.dout + (size_t)bh * p.sq * D, q0, p.sq);
  const float lse = live ? p.lse[(size_t)bh * p.sq + row] : 0.f;
  const float dvec = live ? p.dvec[(size_t)bh * p.sq + row] : 0.f;
  float dq[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) dq[i] = 0.f;
  for (int k0 = 0; k0 < p.skv && !band_skips(p, q0, k0); k0 += F32_KEYS) {
    __syncthreads();
    load_rows<D>(ks, p.k + (size_t)kv_plane * p.skv * D, k0, p.skv);
    load_rows<D>(vs, p.v + (size_t)kv_plane * p.skv * D, k0, p.skv);
    __syncthreads();
    float s[8], dp[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = dp[j] = 0.f;
    for (int c = 0; c < D; ++c) {
      const float qv = qs[r * LD + c], gv = dos[r * LD + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j] = fmaf(qv, ks[(quad + 4 * j) * LD + c], s[j]);
        dp[j] = fmaf(gv, vs[(quad + 4 * j) * LD + c], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = quad + 4 * j;
      float pt;
      grads_of(p, bias, s[j], dp[j], row, k0 + col, hash_plane(p, batch, head), lse, dvec, pt,
               dss[r * F32_PLD + col]);
    }
    __syncwarp();
    for (int j = 0; j < F32_KEYS; ++j) {
      const float ds = dss[r * F32_PLD + j];
#pragma unroll
      for (int i = 0; i < NC; ++i) dq[i] = fmaf(ds, ks[j * LD + quad + 4 * i], dq[i]);
    }
    __syncwarp();
  }
  if (!live) return;
  float* out = p.dq + ((size_t)bh * p.sq + row) * D;
#pragma unroll
  for (int i = 0; i < NC; ++i) out[quad + 4 * i] = dq[i] * p.scale;
}

template <typename K>
int launch(K kernel, size_t smem, dim3 grid, const Params32& p, void* stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, F32_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_fwd(const Params32& p, void* stream) {
  return launch(flash_fwd_f32_kernel<D>, Smem<D>::fwd,
                dim3((p.sq + F32_ROWS - 1) / F32_ROWS, p.b * p.h), p, stream);
}

template <int D>
int launch_bwd(const Params32& p, void* stream) {
  const int err = launch(flash_bwd_dkv_f32_kernel<D>, Smem<D>::dkv,
                         dim3((p.skv + F32_ROWS - 1) / F32_ROWS, p.b * p.hk), p, stream);
  if (err != 0) return err;
  return launch(flash_bwd_dq_f32_kernel<D>, Smem<D>::dq,
                dim3((p.sq + F32_ROWS - 1) / F32_ROWS, p.b * p.h), p, stream);
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

bool valid(int b, int h, int hk, int sq, int skv) {
  return b > 0 && h > 0 && sq > 0 && skv > 0 && (hk == 1 || hk == h);
}

}  // namespace

// Out (b, h, sq, d) and lse (b, h, sq) of one f32 forward call.
extern "C" int flash_fwd_f32_launch(const void* q, const void* k, const void* v, void* o,
                                    void* lse, I2T_FLASH_ARGS) {
  if (!valid(b, h, hk, sq, skv)) return (int)cudaErrorInvalidValue;
  Params32 p = I2T_FLASH_PARAMS;
  p.o = static_cast<float*>(o);
  p.lse_out = static_cast<float*>(lse);
#define FWD(D) return launch_fwd<D>(p, stream)
  I2T_DISPATCH(FWD)
#undef FWD
}

// dQ, dK and dV of one f32 backward call: the dK/dV kernel, then the dQ
// kernel.
extern "C" int flash_bwd_f32_launch(const void* q, const void* k, const void* v, const void* dout,
                                    const void* lse, const void* dvec, void* dq, void* dk,
                                    void* dv, I2T_FLASH_ARGS) {
  if (!valid(b, h, hk, sq, skv)) return (int)cudaErrorInvalidValue;
  Params32 p = I2T_FLASH_PARAMS;
  p.dout = static_cast<const float*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.dvec = static_cast<const float*>(dvec);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
#define BWD(D) return launch_bwd<D>(p, stream)
  I2T_DISPATCH(BWD)
#undef BWD
}
