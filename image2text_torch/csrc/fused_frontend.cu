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
// bf16 peak) against 0.13 ms of bytes (x read once, the output written
// once).  Two launches: gemm.cuh's wgmma/TMA GEMM with the bias in its
// epilogue writes z into rows n_cls.. of each image's output rows, then a
// slab kernel takes each image's slab through the two LayerNorms, writes
// the output over z and the CLS rows in front.  Two slab kernels, chosen
// by shape (ops/fused_frontend.py::front_plan):
//
// Cluster route (cluster_slab_kernel), where an image's slab splits into
// SLAB_CLUSTER chunks of CLUSTER_MIN_CHUNK to SLAB_MAX_CHUNK elements (the
// flagship's 256 x 1024): one thread-block cluster of SLAB_CLUSTER blocks
// an image, each block a contiguous chunk of the slab, persistent (as many
// clusters as the card holds, 15 on an H100, each taking image after
// image).  A block keeps its chunk of the tables lnw, wpe and lnb in
// shared memory for all its images (they are the same for every image:
// read once, not once an image) and its chunk of an image's z in
// registers (SLAB_VECS 16-byte vectors a thread), read once from device
// memory.  Each LayerNorm's statistics take one exchange: a block's sum
// and its sum of squares about its own mean (two passes over its chunk)
// go into a slot of every block of the cluster through distributed shared
// memory behind a cluster barrier, and every block combines the slots in
// rank order (Chan et al.'s pairwise update: the two-pass variance of the
// slab; the same result, bit for bit, in every block and every run).  So
// z crosses device memory twice (written by the GEMM, read once).
//
// Slab route (slab_kernel), every other shape: one 1,024-thread block an
// image makes five passes over its z in device memory (mean, variance,
// y's mean and variance with y recomputed, the write, in place).  At the
// flagship's shape its resident blocks touch about 135 MB against 50 MB of
// L2, so the passes read z from HBM (0.35 ms of device time beside the
// GEMM's 0.41); at GPT-2-medium's 256 x 512 it is 0.143 ms, faster than
// the cluster route's 0.164 (an NVIDIA H100 80GB HBM3 at 700 W), hence
// CLUSTER_MIN_CHUNK.
//
// Why z goes through device memory: with the slab statistics in the
// GEMM's epilogue (an image's tiles in one cluster, z kept on the chip)
// the front was slower on that card, the epilogue not fitting under the
// next image's mainloop in the registers and shared memory the mainloop
// leaves; and why z sits in registers, not in shared memory: the tables
// take that (PERF.md, row 8).
//
// The f32 form (frontend_launch_f32: configs with ``precision: 'no'``, the
// offline synthetic ones, d 64, t 256, din 128): the JAX kernel is
// dtype-generic, so it runs in f32 here too.  The projector is a SIMT f32
// tile product (gemm_f32_kernel; wgmma takes f32 only as TF32), then the
// slab route's kernel instantiated for f32, nothing rounded narrower.
// What bounds it there: operations and bytes about equal (an image's 4.2
// MFLOP take 0.063 µs at 67 TFLOP/s of f32 FFMA, its 195 KB in and out
// 0.058 µs); the tables, read once a call, tip it to bytes at the
// evaluate batch of 4.
#include "common.cuh"
#include "gemm.cuh"

using namespace i2t;

constexpr int SLAB_THREADS = 1024;    // the slab route's block
constexpr int SLAB_CLUSTER = 8;       // the cluster route's blocks an image
constexpr int CLUSTER_THREADS = 512;  // a cluster-route block
constexpr int SLAB_VECS = 8;          // 16-byte vectors of an image's z a thread holds
constexpr int SLAB_MAX_CHUNK = 32768;
// The smallest chunk the cluster route takes: below it the slab route
// measured faster on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's
// device times for 256 images: GPT-2-medium's 256 x 512 slab, chunks of
// 16,384, 0.143 ms against 0.164; the flagship's 256 x 1024, chunks of
// 32,768, 0.36 against 0.24).
constexpr int CLUSTER_MIN_CHUNK = 24576;
static_assert(SLAB_MAX_CHUNK == CLUSTER_THREADS * SLAB_VECS * 8, "a block's chunk");

namespace {

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

// The slab kernels' operands in the storage type T (bf16, or f32 for the
// f32 front).
template <typename T>
struct SlabArgsT {
  T* out;         // (b, n_cls + t, d); rows n_cls.. hold z on entry
  const T* lnw;   // (t, d)
  const T* lnb;   // (t, d) or null
  const T* wpe;   // (t, d)
  const T* cls;   // (n_cls, d)
  int b, t, d, n_cls;
  int chunk;      // cluster route: slab elements a block takes (a multiple of 8)
};
using SlabArgs = SlabArgsT<bf16>;

// 8 consecutive values of T as one (bf16) or two (f32) 16-byte accesses,
// and the rounding to T at an operation's output (none for f32).
struct alignas(16) F32x8 {
  float v[8];
};
template <typename T>
struct Vec8 {
  using type = Bf16x8;
};
template <>
struct Vec8<float> {
  using type = F32x8;
};
__device__ __forceinline__ float val(bf16 v) { return to_f(v); }
__device__ __forceinline__ float val(float v) { return v; }
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return rbf(v);
}
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <typename T>
__device__ __forceinline__ T store_as(float v) {
  return to_bf(v);
}
template <>
__device__ __forceinline__ float store_as<float>(float v) {
  return v;
}

// y = T(T(LN(z)) + wpe) of 8 consecutive elements at slab offset e.
template <typename T>
__device__ __forceinline__ void pos_add(const SlabArgsT<T>& p, const typename Vec8<T>::type& z,
                                        size_t e, float mean, float rstd, float y[8]) {
  using V = typename Vec8<T>::type;
  const V w = *reinterpret_cast<const V*>(p.lnw + e);
  const V pe = *reinterpret_cast<const V*>(p.wpe + e);
  V b;
  if (p.lnb != nullptr) b = *reinterpret_cast<const V*>(p.lnb + e);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float u = (val(z.v[i]) - mean) * rstd * val(w.v[i]);
    if (p.lnb != nullptr) u += val(b.v[i]);
    y[i] = round_to<T>(round_to<T>(u) + val(pe.v[i]));
  }
}

template <typename T>
__global__ void __launch_bounds__(SLAB_THREADS) slab_kernel(SlabArgsT<T> p) {
  using V = typename Vec8<T>::type;
  __shared__ float red[33];
  const size_t n = (size_t)p.t * p.d, nv = n / 8;
  const float inv_n = 1.f / (float)n;
  T* img = p.out + (size_t)blockIdx.x * (p.n_cls + p.t) * p.d;
  T* slab = img + (size_t)p.n_cls * p.d;
  const V* zv = reinterpret_cast<const V*>(slab);

  for (size_t i = threadIdx.x; i < (size_t)p.n_cls * p.d / 8; i += blockDim.x)
    reinterpret_cast<V*>(img)[i] = reinterpret_cast<const V*>(p.cls)[i];

  float s = 0.f;
  for (size_t i = threadIdx.x; i < nv; i += blockDim.x) {
    const V z = zv[i];
#pragma unroll
    for (int j = 0; j < 8; ++j) s += val(z.v[j]);
  }
  const float mean1 = block_sum(s, red) * inv_n;
  s = 0.f;
  for (size_t i = threadIdx.x; i < nv; i += blockDim.x) {
    const V z = zv[i];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float e = val(z.v[j]) - mean1;
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
    const V w = *reinterpret_cast<const V*>(p.lnw + i * 8);
    V b, o;
    if (p.lnb != nullptr) b = *reinterpret_cast<const V*>(p.lnb + i * 8);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float u = (y[j] - mean2) * rstd2 * val(w.v[j]);
      if (p.lnb != nullptr) u += val(b.v[j]);
      o.v[j] = store_as<T>(u);
    }
    reinterpret_cast<V*>(slab)[i] = o;
  }
}

// The f32 front's projector: z = x·Wp (+ bp) for the (b·t, din) f32 rows of
// x, into rows n_cls.. of each image's output rows.  A 64 x 64 output tile
// a block of 256 threads, 4 x 4 a thread, x and Wp staged in 16-deep
// slices; true f32 products (FFMA), the bias added after the sum, as the
// plain version adds it.  At the offline configs' front (b·t = 256 rows an
// image, din 128, d 64) the product is 4.2 MFLOP an image.
constexpr int G32_TILE = 64, G32_DEPTH = 16, G32_THREADS = 256;

__global__ void __launch_bounds__(G32_THREADS) gemm_f32_kernel(const float* x, const float* w,
                                                               const float* bias, float* out,
                                                               int rows, int t, int n_cls,
                                                               int din, int d) {
  __shared__ float xs[G32_DEPTH][G32_TILE + 4];  // x transposed: [k][row]
  __shared__ float ws[G32_DEPTH][G32_TILE + 4];
  const int m0 = blockIdx.y * G32_TILE, n0 = blockIdx.x * G32_TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < din; k0 += G32_DEPTH) {
    for (int i = threadIdx.x; i < G32_TILE * G32_DEPTH; i += G32_THREADS) {
      const int mm = i / G32_DEPTH, kk = i % G32_DEPTH, gm = m0 + mm, gk = k0 + kk;
      xs[kk][mm] = gm < rows && gk < din ? x[(size_t)gm * din + gk] : 0.f;
      const int kw = i / G32_TILE, nn = i % G32_TILE, gkw = k0 + kw, gn = n0 + nn;
      ws[kw][nn] = gkw < din && gn < d ? w[(size_t)gkw * d + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < G32_DEPTH; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = xs[kk][ty + 16 * i];
        b[i] = ws[kk][tx + 16 * i];
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
    const int gm = m0 + ty + 16 * i;
    if (gm >= rows) continue;
    float* dst = out + ((size_t)(gm / t) * (n_cls + t) + n_cls + gm % t) * d;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < d) dst[gn] = bias != nullptr ? acc[i][j] + bias[gn] : acc[i][j];
    }
  }
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// ``v`` into the f32 at ``slot`` in the shared memory of the cluster's
// block ``rank``.
__device__ __forceinline__ void store_remote(float* slot, uint32_t rank, float v) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(slot))), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(a), "f"(v) : "memory");
}

// Keeps the compiler from hoisting the next vector's table reads above
// this point: hoisted, the eight vectors' reads outgrow the registers
// and spill.
__device__ __forceinline__ void order_loads() { asm volatile("" ::: "memory"); }

// Cluster (SLAB_CLUSTER, 1, 1), blockIdx.y the cluster; the block's rank
// is its chunk of every image's slab.
__global__ void __launch_bounds__(CLUSTER_THREADS, 1) cluster_slab_kernel(SlabArgs p) {
  extern __shared__ uint4 tables[];  // the chunk of lnw, wpe, lnb (where given)
  __shared__ float slots[2][2][SLAB_CLUSTER];  // [statistic pair][sum, M2][rank]
  __shared__ float red[2][CLUSTER_THREADS / 32];
  // every block of the cluster has started before one writes into
  // another's slots: waited on before the first exchange
  cluster_arrive();
  const uint32_t rank = cluster_rank();
  const size_t n = (size_t)p.t * p.d;
  const float inv_n = 1.f / (float)n;
  const bool has_lnb = p.lnb != nullptr;
  // the elements of rank r's chunk
  auto count = [&](size_t r) {
    const size_t e = r * p.chunk;
    return e >= n ? 0 : e + p.chunk < n ? (size_t)p.chunk : n - e;
  };
  const size_t e0 = (size_t)rank * p.chunk;
  const int nv = (int)(count(rank) / 8);
  Bf16x8* lnw = reinterpret_cast<Bf16x8*>(tables);
  Bf16x8* wpe = lnw + nv;
  Bf16x8* lnb = wpe + nv;
  for (int i = threadIdx.x; i < nv; i += CLUSTER_THREADS) {
    lnw[i] = reinterpret_cast<const Bf16x8*>(p.lnw + e0)[i];
    wpe[i] = reinterpret_cast<const Bf16x8*>(p.wpe + e0)[i];
    if (has_lnb) lnb[i] = reinterpret_cast<const Bf16x8*>(p.lnb + e0)[i];
  }
  // thread's vector j is i = threadIdx.x + j * CLUSTER_THREADS, where i < nv
  auto mine = [&](int j) { return threadIdx.x + j * CLUSTER_THREADS < nv; };
  // Σ of every thread's v over the block, warps in order; every thread
  // gets it
  auto block_sum = [&](float v, int k) {
    v = warp_sum(v);
    if (threadIdx.x % 32 == 0) red[k][threadIdx.x / 32] = v;
    __syncthreads();
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < CLUSTER_THREADS / 32; ++w) total += red[k][w];
    return total;
  };
  // The slab's mean and 1 / sqrt(variance + eps) from the values v of every
  // thread's vectors: each block's own sum and, about its own mean, sum of
  // squares (two passes over its chunk), exchanged once through slot pair
  // ``s`` of every block of the cluster, then combined in rank order by
  // every thread (Chan et al.'s pairwise update: the two-pass variance of
  // the whole slab).
  auto slab_stats = [&](const Bf16x8(&v)[SLAB_VECS], int s, float& mean, float& rstd) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < SLAB_VECS; ++j)
      if (mine(j))
#pragma unroll
        for (int e = 0; e < 8; ++e) acc += to_f(v[j].v[e]);
    const float sum = block_sum(acc, 0);
    const float own = nv > 0 ? sum / (float)(nv * 8) : 0.f;
    acc = 0.f;
#pragma unroll
    for (int j = 0; j < SLAB_VECS; ++j)
      if (mine(j))
#pragma unroll
        for (int e = 0; e < 8; ++e) acc += (to_f(v[j].v[e]) - own) * (to_f(v[j].v[e]) - own);
    const float m2 = block_sum(acc, 1);
    if (threadIdx.x < SLAB_CLUSTER) {
      store_remote(&slots[s][0][rank], threadIdx.x, sum);
      store_remote(&slots[s][1][rank], threadIdx.x, m2);
    }
    cluster_arrive();
    cluster_wait();
    float total = 0.f;
#pragma unroll
    for (int r = 0; r < SLAB_CLUSTER; ++r) total += slots[s][0][r];
    mean = total * inv_n;
    float sq = 0.f;
#pragma unroll
    for (int r = 0; r < SLAB_CLUSTER; ++r) {
      const float nr = (float)count(r);
      if (nr > 0.f) {
        const float dm = slots[s][0][r] / nr - mean;
        sq += slots[s][1][r] + nr * dm * dm;
      }
    }
    rstd = rsqrtf(sq * inv_n + 1e-5f);
  };

  __syncthreads();  // the tables are in
  cluster_wait();
  for (int img = blockIdx.y; img < p.b; img += gridDim.y) {
    bf16* head = p.out + (size_t)img * (p.n_cls + p.t) * p.d;
    Bf16x8* z = reinterpret_cast<Bf16x8*>(head + (size_t)p.n_cls * p.d + e0);
    Bf16x8 v[SLAB_VECS] = {};
#pragma unroll
    for (int j = 0; j < SLAB_VECS; ++j)
      if (mine(j)) v[j] = z[threadIdx.x + j * CLUSTER_THREADS];
    // the CLS rows, spread over the cluster
    for (int i = rank * CLUSTER_THREADS + threadIdx.x; i < p.n_cls * p.d / 8;
         i += SLAB_CLUSTER * CLUSTER_THREADS)
      reinterpret_cast<Bf16x8*>(head)[i] = reinterpret_cast<const Bf16x8*>(p.cls)[i];

    float mean1, rstd1, mean2, rstd2;
    slab_stats(v, 0, mean1, rstd1);
    // y = bf16(bf16(LN(z)) + wpe) in place
    const float shift1 = -mean1 * rstd1;
#pragma unroll
    for (int j = 0; j < SLAB_VECS; ++j) {
      const int i = threadIdx.x + j * CLUSTER_THREADS;
      if (i >= nv) continue;
      const Bf16x8 w = lnw[i], pe = wpe[i], b = has_lnb ? lnb[i] : Bf16x8{};
#pragma unroll
      for (int e = 0; e < 8; e += 2) {  // pairs: one conversion rounds two values
        float u0 = fmaf(to_f(v[j].v[e]), rstd1, shift1) * to_f(w.v[e]);
        float u1 = fmaf(to_f(v[j].v[e + 1]), rstd1, shift1) * to_f(w.v[e + 1]);
        if (has_lnb) {
          u0 += to_f(b.v[e]);
          u1 += to_f(b.v[e + 1]);
        }
        const float2 r = __bfloat1622float2(__floats2bfloat162_rn(u0, u1));
        const __nv_bfloat162 y =
            __floats2bfloat162_rn(r.x + to_f(pe.v[e]), r.y + to_f(pe.v[e + 1]));
        v[j].v[e] = y.x;
        v[j].v[e + 1] = y.y;
      }
      order_loads();
    }
    slab_stats(v, 1, mean2, rstd2);
    // the output over z
    const float shift2 = -mean2 * rstd2;
#pragma unroll
    for (int j = 0; j < SLAB_VECS; ++j) {
      const int i = threadIdx.x + j * CLUSTER_THREADS;
      if (i >= nv) continue;
      const Bf16x8 w = lnw[i], b = has_lnb ? lnb[i] : Bf16x8{};
      Bf16x8 o;
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        float u0 = fmaf(to_f(v[j].v[e]), rstd2, shift2) * to_f(w.v[e]);
        float u1 = fmaf(to_f(v[j].v[e + 1]), rstd2, shift2) * to_f(w.v[e + 1]);
        if (has_lnb) {
          u0 += to_f(b.v[e]);
          u1 += to_f(b.v[e + 1]);
        }
        const __nv_bfloat162 r = __floats2bfloat162_rn(u0, u1);
        o.v[e] = r.x;
        o.v[e + 1] = r.y;
      }
      z[i] = o;
      order_loads();
    }
  }
}

}  // namespace

static int cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int chunk,
                          bool has_lnb, int n_clusters, cudaStream_t st) {
  const int smem = (has_lnb ? 3 : 2) * chunk * 2;
  const cudaError_t err = cudaFuncSetAttribute(
      cluster_slab_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 3 * SLAB_MAX_CHUNK * 2);
  if (err != cudaSuccess) return (int)err;
  cfg->gridDim = dim3(SLAB_CLUSTER, n_clusters, 1);
  cfg->blockDim = dim3(CLUSTER_THREADS, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = SLAB_CLUSTER;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

// The number of cluster_slab_kernel's clusters the card holds at once
// (cudaOccupancyMaxActiveClusters) for a chunk of ``chunk`` elements, or
// -(cudaError_t).
extern "C" int frontend_clusters(int chunk, int has_lnb) {
  if (chunk <= 0 || chunk % 8 || chunk > SLAB_MAX_CHUNK) return -(int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  const int err = cluster_config(&cfg, &attr, chunk, has_lnb != 0, 1, 0);
  if (err != 0) return -err;
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, cluster_slab_kernel, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

// x (b, t, din) → out (b, n_cls + t, d), all bf16; wp (din, d), bp (d) or
// null, lnw and lnb (t, d) (lnb may be null), wpe (t, d), cls (n_cls, d).
// ``chunk`` > 0: the cluster route, on ``n_clusters`` persistent clusters
// whose blocks take ``chunk`` elements of an image's slab each (a multiple
// of 8, at most SLAB_MAX_CHUNK, SLAB_CLUSTER of them covering t·d);
// ``chunk`` 0: the slab route.
extern "C" int frontend_launch(const void* x, const void* wp, const void* bp, const void* lnw,
                               const void* lnb, const void* wpe, const void* cls, void* out,
                               int b, int t, int din, int d, int n_cls, int chunk, int n_clusters,
                               void* stream) {
  if (b <= 0 || t <= 0 || n_cls < 0 || d % 16 || din % 8 || chunk < 0 || chunk % 8 ||
      chunk > SLAB_MAX_CHUNK ||
      (chunk > 0 && ((size_t)chunk * SLAB_CLUSTER < (size_t)t * d || n_clusters <= 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = launch_gemm(x, nullptr, t, nullptr, wp, bp, nullptr, nullptr, t, out, n_cls + t, n_cls,
                        b, t, d, din, st);
  if (err != 0) return err;
  SlabArgs p;
  p.out = static_cast<bf16*>(out);
  p.lnw = static_cast<const bf16*>(lnw);
  p.lnb = static_cast<const bf16*>(lnb);
  p.wpe = static_cast<const bf16*>(wpe);
  p.cls = static_cast<const bf16*>(cls);
  p.b = b;
  p.t = t;
  p.d = d;
  p.n_cls = n_cls;
  p.chunk = chunk;
  if (chunk == 0) {
    slab_kernel<bf16><<<b, SLAB_THREADS, 0, st>>>(p);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  err = cluster_config(&cfg, &attr, chunk, lnb != nullptr, n_clusters < b ? n_clusters : b, st);
  if (err != 0) return err;
  err = (int)cudaLaunchKernelEx(&cfg, cluster_slab_kernel, p);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

// The f32 front: x (b, t, din) → out (b, n_cls + t, d), all f32; operands
// as frontend_launch's.  gemm_f32_kernel, then the slab route's kernel
// instantiated for f32 (d a multiple of 8).
extern "C" int frontend_launch_f32(const void* x, const void* wp, const void* bp,
                                   const void* lnw, const void* lnb, const void* wpe,
                                   const void* cls, void* out, int b, int t, int din, int d,
                                   int n_cls, void* stream) {
  if (b <= 0 || t <= 0 || din <= 0 || n_cls < 0 || d <= 0 || d % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = b * t;
  gemm_f32_kernel<<<dim3((d + G32_TILE - 1) / G32_TILE, (rows + G32_TILE - 1) / G32_TILE),
                    G32_THREADS, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(wp), static_cast<const float*>(bp),
      static_cast<float*>(out), rows, t, n_cls, din, d);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  SlabArgsT<float> p;
  p.out = static_cast<float*>(out);
  p.lnw = static_cast<const float*>(lnw);
  p.lnb = static_cast<const float*>(lnb);
  p.wpe = static_cast<const float*>(wpe);
  p.cls = static_cast<const float*>(cls);
  p.b = b;
  p.t = t;
  p.d = d;
  p.n_cls = n_cls;
  p.chunk = 0;
  slab_kernel<float><<<b, SLAB_THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}
