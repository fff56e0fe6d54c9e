// Eval encoder front for Hopper (sm_90a): counterpart of
// image2text_tpu/ops/fused_frontend.py::_frontend_kernel.
//
// For each image, from its (t, din) raw-reshaped patch rows:
//   z = bf16(bf16(x·Wp) + bp)                      projector
//   u = LayerNormND(z)                             f32 stats over the whole (t, d) slab
//   y = bf16(u + wpe)                              positional table
//   out = [cls (n_cls rows); LayerNormND(y)]       the block loop's input
// LayerNormND is the module's: two-pass f32 mean and variance over all t·d
// elements, eps 1e-5, f32 scale and shift by the (t, d) weight and bias,
// rounded to bf16.
//
// What bounds it: operations.  The projector is 2·t·din·d per image (275
// GFLOP at the flagship's b 256, t 256, din 2048, d 1024: 0.28 ms at the
// bf16 peak) against 0.13 ms of bytes.  Two launches:
//   (a) the tiled cp.async bf16 GEMM of gemm.cuh with the bias in its
//       epilogue, writing z straight into rows n_cls.. of each image's
//       output rows;
//   (b) a slab kernel, one thread block per image (the statistics span the
//       whole image, and a block is the unit that can reduce across it):
//       five passes over the image's 2·t·d bytes of z, which stay in L2
//       (mean, variance, then y's mean and variance with y recomputed from
//       z, then the write, in place over z), and the CLS rows.
#include "common.cuh"
#include "gemm.cuh"

using namespace i2t;

namespace {

constexpr int SLAB_THREADS = 1024;

// Sum of ``v`` over the block; every thread gets the total.  ``red`` holds
// 33 floats and is free again when this returns.
__device__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = lane < blockDim.x / 32 ? red[lane] : 0.f;
    s = warp_sum(s);
    if (lane == 0) red[32] = s;
  }
  __syncthreads();
  const float total = red[32];
  __syncthreads();
  return total;
}

struct SlabArgs {
  bf16* out;         // (b, n_cls + t, d); rows n_cls.. hold z on entry
  const bf16* lnw;   // (t, d)
  const bf16* lnb;   // (t, d) or null
  const bf16* wpe;   // (t, d)
  const bf16* cls;   // (n_cls, d)
  int t, d, n_cls;
};

// y = bf16(bf16(LN(z)) + wpe) of 8 consecutive elements at slab offset e.
__device__ __forceinline__ void pos_add(const SlabArgs& p, const Bf16x8& z, size_t e,
                                        float mean, float rstd, float y[8]) {
  const Bf16x8 w = *reinterpret_cast<const Bf16x8*>(p.lnw + e);
  const Bf16x8 pe = *reinterpret_cast<const Bf16x8*>(p.wpe + e);
  Bf16x8 b;
  if (p.lnb != nullptr) b = *reinterpret_cast<const Bf16x8*>(p.lnb + e);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float u = (to_f(z.v[i]) - mean) * rstd * to_f(w.v[i]);
    if (p.lnb != nullptr) u += to_f(b.v[i]);
    y[i] = rbf(rbf(u) + to_f(pe.v[i]));
  }
}

__global__ void __launch_bounds__(SLAB_THREADS) slab_kernel(SlabArgs p) {
  __shared__ float red[33];
  const size_t n = (size_t)p.t * p.d, nv = n / 8;
  const float inv_n = 1.f / (float)n;
  bf16* img = p.out + (size_t)blockIdx.x * (p.n_cls + p.t) * p.d;
  bf16* slab = img + (size_t)p.n_cls * p.d;
  const Bf16x8* zv = reinterpret_cast<const Bf16x8*>(slab);

  for (size_t i = threadIdx.x; i < (size_t)p.n_cls * p.d / 8; i += blockDim.x)
    reinterpret_cast<Bf16x8*>(img)[i] = reinterpret_cast<const Bf16x8*>(p.cls)[i];

  float s = 0.f;
  for (size_t i = threadIdx.x; i < nv; i += blockDim.x) {
    const Bf16x8 z = zv[i];
#pragma unroll
    for (int j = 0; j < 8; ++j) s += to_f(z.v[j]);
  }
  const float mean1 = block_sum(s, red) * inv_n;
  s = 0.f;
  for (size_t i = threadIdx.x; i < nv; i += blockDim.x) {
    const Bf16x8 z = zv[i];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float e = to_f(z.v[j]) - mean1;
      s += e * e;
    }
  }
  const float rstd1 = rsqrtf(block_sum(s, red) * inv_n + 1e-5f);

  float y[8];
  s = 0.f;
  for (size_t i = threadIdx.x; i < nv; i += blockDim.x) {
    pos_add(p, zv[i], i * 8, mean1, rstd1, y);
#pragma unroll
    for (int j = 0; j < 8; ++j) s += y[j];
  }
  const float mean2 = block_sum(s, red) * inv_n;
  s = 0.f;
  for (size_t i = threadIdx.x; i < nv; i += blockDim.x) {
    pos_add(p, zv[i], i * 8, mean1, rstd1, y);
#pragma unroll
    for (int j = 0; j < 8; ++j) s += (y[j] - mean2) * (y[j] - mean2);
  }
  const float rstd2 = rsqrtf(block_sum(s, red) * inv_n + 1e-5f);

  // in place: each thread reads and then writes only its own vectors
  for (size_t i = threadIdx.x; i < nv; i += blockDim.x) {
    pos_add(p, zv[i], i * 8, mean1, rstd1, y);
    const Bf16x8 w = *reinterpret_cast<const Bf16x8*>(p.lnw + i * 8);
    Bf16x8 b, o;
    if (p.lnb != nullptr) b = *reinterpret_cast<const Bf16x8*>(p.lnb + i * 8);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float u = (y[j] - mean2) * rstd2 * to_f(w.v[j]);
      if (p.lnb != nullptr) u += to_f(b.v[j]);
      o.v[j] = to_bf(u);
    }
    reinterpret_cast<Bf16x8*>(slab)[i] = o;
  }
}

}  // namespace

// x (b, t, din) → out (b, n_cls + t, d), all bf16; wp (din, d), bp (d) or
// null, lnw and lnb (t, d) (lnb may be null), wpe (t, d), cls (n_cls, d).
extern "C" int frontend_launch(const void* x, const void* wp, const void* bp, const void* lnw,
                               const void* lnb, const void* wpe, const void* cls, void* out,
                               int b, int t, int din, int d, int n_cls, void* stream) {
  if (b <= 0 || t <= 0 || n_cls < 0 || d % 16 || din % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_gemm(x, nullptr, t, nullptr, wp, bp, nullptr, nullptr, t, out, n_cls + t, n_cls,
                              b, t, d, din, st);
  if (err != 0) return err;
  SlabArgs p;
  p.out = static_cast<bf16*>(out);
  p.lnw = static_cast<const bf16*>(lnw);
  p.lnb = static_cast<const bf16*>(lnb);
  p.wpe = static_cast<const bf16*>(wpe);
  p.cls = static_cast<const bf16*>(cls);
  p.t = t;
  p.d = d;
  p.n_cls = n_cls;
  slab_kernel<<<b, SLAB_THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}
