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
// offline synthetic ones, d 64, t 256, din 128; the JAX kernel is
// dtype-generic, so it runs in f32 here too), nothing rounded narrower than
// f32.  Two routes, chosen by shape (ops/fused_frontend.py::front_plan_f32):
//
// Cluster route (front32_cluster_kernel), where an image's slab rows split
// over a cluster of at most F32_CLUSTER blocks of at most F32_FRONT_ROWS
// rows (16, 32 or 64) and a block's operands fit F32_FRONT_SMEM bytes of
// shared memory (the offline front: 8 blocks of 32 rows): one launch, a
// cluster an image.  A block stages the projector Wp (din x d), its rows of
// x and its rows of the tables lnw, lnb and wpe by cp.async, computes its
// rows of z = x·Wp + bp on the tensor cores
// as 3xTF32 mma.sync (flash_common.cuh's mma3x: each k-step's three products
// into zeroed accumulators) into
// shared memory, and takes each LayerNorm's statistics over the cluster:
// its sum and its sum of squares about its own mean (two passes over its
// rows) go to every block of the cluster through distributed shared memory
// behind a cluster barrier, and every block combines them in rank order
// (Chan et al.'s pairwise update: the two-pass variance of the slab, the
// same bits in every block and every run).  y = LN(z)·lnw + lnb + wpe
// overwrites z in shared memory; the output is written once, z never.
// The first f32 design's two launches (below) ran the slab passes on one
// block an image: 4 SMs at the evaluate batch of 4.
//
// Slab route, every other shape: the projector as a SIMT f32 tile product
// (gemm_f32_kernel) writing z into the output's token rows, then the slab
// route's kernel instantiated for f32 (slab_kernel<float>).
//
// What bounds it at the offline shapes: bytes, 1.0 MB at the evaluate batch
// of 4 (x, the tables, Wp and the output: 0.31 µs at 3.35 TB/s), against
// 16.8 MFLOP (0.10 µs at 495 TFLOP/s as three TF32 products).  Measured on
// an NVIDIA H100 80GB HBM3 at 700 W (device time): 0.0146 ms at b 4 and b
// 8, where the slab route's two kernels took 0.0315.  Other cluster sizes
// (build variants, probes/flash_variants.py --front-f32) are in PERF.md.
#include "flash_common.cuh"
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
// The f32 cluster route: the most blocks an image (a portable cluster),
// the most slab rows a block, its block and the shared memory a block may
// take.
constexpr int F32_CLUSTER = 8;
constexpr int F32_FRONT_ROWS = 64;
constexpr int F32_FRONT_THREADS = 128;
constexpr int F32_FRONT_SMEM = 230400;

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


// The f32 cluster route's operands.
struct Front32 {
  const float* x;    // (b, t, din)
  const float* wp;   // (din, d)
  const float* bp;   // (d) or null
  const float* lnw;  // (t, d)
  const float* lnb;  // (t, d) or null
  const float* wpe;  // (t, d)
  const float* cls;  // (n_cls, d)
  float* out;        // (b, n_cls + t, d)
  int b, t, din, d, n_cls;
  int rows;          // slab rows a block: 16, 32 or 64
  int dinp, ldw;     // din rounded up to 8; Wp's shared-memory row stride
};

// Wp's shared-memory row stride at width d: the least stride >= d that is 8
// modulo 32 (a warp's B fragment reads fall on 32 distinct banks); x's is
// dinp + 4.  A block holds Wp, its x rows, and z and its rows of lnw, lnb
// and wpe (rows x d each).
__host__ __device__ constexpr int front32_ldw(int d) { return (d + 23) / 32 * 32 + 8; }
__host__ __device__ constexpr size_t front32_smem(int rows, int dinp, int d) {
  return ((size_t)dinp * front32_ldw(d) + (size_t)rows * (dinp + 4) + (size_t)4 * rows * d) *
         sizeof(float);
}
static_assert(front32_smem(32, 128, 64) <= F32_FRONT_SMEM, "the offline front fits");

// Grid (cluster, b), a cluster an image: block rank r takes slab rows
// [r·rows, (r + 1)·rows) of image blockIdx.y.
__global__ void __launch_bounds__(F32_FRONT_THREADS) front32_cluster_kernel(Front32 p) {
  constexpr int WARPS = F32_FRONT_THREADS / 32;
  extern __shared__ __align__(16) float fsm[];
  __shared__ float slots[2][2][F32_CLUSTER];  // [statistic pair][sum, M2][rank]
  __shared__ float red[2][WARPS];
  // every block of the cluster has started before one writes into
  // another's slots: waited on before the first exchange
  cluster_arrive();
  const int rank = (int)cluster_rank(), csize = gridDim.x, d = p.d, ldx = p.dinp + 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c4 = lane % 4;
  float* ws = fsm;                             // Wp: dinp x ldw
  float* xs = ws + (size_t)p.dinp * p.ldw;     // the block's x rows: rows x ldx
  float* zs = xs + (size_t)p.rows * ldx;       // z, then y: rows x d
  float* lw = zs + (size_t)p.rows * d;         // the block's rows of lnw,
  float* lb = lw + (size_t)p.rows * d;         // lnb (where given)
  float* pe = lb + (size_t)p.rows * d;         // and wpe
  const int img = blockIdx.y, r0 = rank * p.rows;
  const int nr = max(0, min(p.rows, p.t - r0));  // the block's rows of the slab
  // Wp, the block's rows of x and of the tables; rows and columns past din,
  // and rows past t, zero-filled
  for (int i = threadIdx.x; i < p.dinp * (d / 4); i += F32_FRONT_THREADS) {
    const int r = i / (d / 4), c = (i % (d / 4)) * 4;
    cp_async16(ws + r * p.ldw + c, p.wp + (r < p.din ? (size_t)r * d + c : 0), r < p.din);
  }
  for (int i = threadIdx.x; i < nr * d / 4; i += F32_FRONT_THREADS) {
    const size_t at = (size_t)r0 * d + 4 * i;
    cp_async16(lw + 4 * i, p.lnw + at, true);
    cp_async16(pe + 4 * i, p.wpe + at, true);
    if (p.lnb != nullptr) cp_async16(lb + 4 * i, p.lnb + at, true);
  }
  const float* xi = p.x + ((size_t)img * p.t + min(r0, p.t)) * p.din;
  if (p.din % 4 == 0) {
    for (int i = threadIdx.x; i < p.rows * (p.dinp / 4); i += F32_FRONT_THREADS) {
      const int r = i / (p.dinp / 4), c = (i % (p.dinp / 4)) * 4;
      const bool in = r < nr && c < p.din;
      cp_async16(xs + r * ldx + c, in ? xi + (size_t)r * p.din + c : p.x, in);
    }
  } else {
    for (int i = threadIdx.x; i < p.rows * p.dinp; i += F32_FRONT_THREADS) {
      const int r = i / p.dinp, c = i % p.dinp;
      const bool in = r < nr && c < p.din;
      cp_async4(xs + r * ldx + c, in ? xi + (size_t)r * p.din + c : p.x, in);
    }
  }
  cp_async_commit();
  // the CLS rows, spread over the cluster
  float* head = p.out + (size_t)img * (p.n_cls + p.t) * d;
  for (int i = rank * F32_FRONT_THREADS + threadIdx.x; i < p.n_cls * d;
       i += csize * F32_FRONT_THREADS)
    head[i] = p.cls[i];
  cp_async_wait<0>();
  __syncthreads();

  // z = x·Wp + bp: warp w takes m16 tile w % mt and its share of the n8
  // tiles, up to 8 at a time in registers
  const int mt = p.rows / 16, groups = WARPS / mt, nt = d / 8;
  const int per = (nt + groups - 1) / groups, m0 = (warp % mt) * 16;
  const int j0 = (warp / mt) * per, j1 = min(j0 + per, nt);
  const float* a = xs + (m0 + g) * ldx + c4;
  for (int jb = j0; jb < j1; jb += 8) {
    float c[8][4] = {};
#pragma unroll 2
    for (int k0 = 0; k0 < p.dinp; k0 += 8) {
      uint32_t ab[4], as[4];
      split(a[k0], ab[0], as[0]);
      split(a[8 * ldx + k0], ab[1], as[1]);
      split(a[k0 + 4], ab[2], as[2]);
      split(a[8 * ldx + k0 + 4], ab[3], as[3]);
      const float* b = ws + (k0 + c4) * p.ldw + g;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (jb + j >= j1) break;
        uint32_t bb[2], bs[2];
        split(b[8 * (jb + j)], bb[0], bs[0]);
        split(b[4 * p.ldw + 8 * (jb + j)], bb[1], bs[1]);
        mma3x(c[j], ab, as, bb, bs);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (jb + j >= j1) break;
      const int col = 8 * (jb + j) + 2 * c4;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int cc = col + (u & 1);
        const float v = c[j][u];
        zs[(m0 + g + 8 * (u >> 1)) * d + cc] = p.bp != nullptr ? v + p.bp[cc] : v;
      }
    }
  }
  __syncthreads();

  const int ne = nr * d;  // the block's elements of the slab
  const float inv_n = 1.f / ((float)p.t * (float)d);
  // Σ of every thread's v over the block, warps in order
  auto block_sum = [&](float v, int k) {
    v = warp_sum(v);
    if (lane == 0) red[k][warp] = v;
    __syncthreads();
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += red[k][w];
    return total;
  };
  // The slab's mean and 1 / sqrt(variance + eps) from zs: the block's sum
  // and its sum of squares about its own mean, exchanged through slot pair
  // ``s`` of every block of the cluster, combined in rank order.
  auto slab_stats = [&](int s, float& mean, float& rstd) {
    float acc = 0.f;
    for (int i = threadIdx.x; i < ne; i += F32_FRONT_THREADS) acc += zs[i];
    const float sum = block_sum(acc, 0);
    const float own = ne > 0 ? sum / (float)ne : 0.f;
    acc = 0.f;
    for (int i = threadIdx.x; i < ne; i += F32_FRONT_THREADS) {
      const float e = zs[i] - own;
      acc = fmaf(e, e, acc);
    }
    const float m2 = block_sum(acc, 1);
    if ((int)threadIdx.x < csize) {
      store_remote(&slots[s][0][rank], threadIdx.x, sum);
      store_remote(&slots[s][1][rank], threadIdx.x, m2);
    }
    cluster_arrive();
    cluster_wait();
    float total = 0.f;
    for (int r = 0; r < csize; ++r) total += slots[s][0][r];
    mean = total * inv_n;
    float sq = 0.f;
    for (int r = 0; r < csize; ++r) {
      const float cnt = (float)(max(0, min(p.rows, p.t - r * p.rows)) * d);
      if (cnt > 0.f) {
        const float dm = slots[s][0][r] / cnt - mean;
        sq += slots[s][1][r] + cnt * dm * dm;
      }
    }
    rstd = rsqrtf(sq * inv_n + 1e-5f);
  };

  const bool has_lnb = p.lnb != nullptr;
  cluster_wait();
  float mean1, rstd1, mean2, rstd2;
  slab_stats(0, mean1, rstd1);
  // y = LN(z) + wpe in place (each thread its own elements)
  for (int i = threadIdx.x; i < ne; i += F32_FRONT_THREADS) {
    float u = (zs[i] - mean1) * rstd1 * lw[i];
    if (has_lnb) u += lb[i];
    zs[i] = u + pe[i];
  }
  slab_stats(1, mean2, rstd2);
  float* o = head + (size_t)(p.n_cls + r0) * d;
  for (int i = threadIdx.x; i < ne; i += F32_FRONT_THREADS) {
    float u = (zs[i] - mean2) * rstd2 * lw[i];
    if (has_lnb) u += lb[i];
    o[i] = u;
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
// as frontend_launch's.  ``cluster`` > 0: the cluster route, ``cluster``
// blocks an image (at most F32_CLUSTER) of ``rows`` slab rows each (16,
// 32 or 64, at most F32_FRONT_ROWS, covering t, their operands within
// F32_FRONT_SMEM); ``cluster`` 0: the slab route (d a multiple of 8 either
// way).
extern "C" int frontend_launch_f32(const void* x, const void* wp, const void* bp,
                                   const void* lnw, const void* lnb, const void* wpe,
                                   const void* cls, void* out, int b, int t, int din, int d,
                                   int n_cls, int cluster, int rows, void* stream) {
  if (b <= 0 || t <= 0 || din <= 0 || n_cls < 0 || d <= 0 || d % 8 || cluster < 0 ||
      cluster > F32_CLUSTER)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cluster > 0) {
    const int dinp = (din + 7) / 8 * 8;
    const size_t smem = front32_smem(rows, dinp, d);
    if ((rows != 16 && rows != 32 && rows != 64) || rows > F32_FRONT_ROWS ||
        (long long)cluster * rows < t || (cluster - 1) * rows >= t || smem > F32_FRONT_SMEM)
      return (int)cudaErrorInvalidValue;
    Front32 p;
    p.x = static_cast<const float*>(x);
    p.wp = static_cast<const float*>(wp);
    p.bp = static_cast<const float*>(bp);
    p.lnw = static_cast<const float*>(lnw);
    p.lnb = static_cast<const float*>(lnb);
    p.wpe = static_cast<const float*>(wpe);
    p.cls = static_cast<const float*>(cls);
    p.out = static_cast<float*>(out);
    p.b = b;
    p.t = t;
    p.din = din;
    p.d = d;
    p.n_cls = n_cls;
    p.rows = rows;
    p.dinp = dinp;
    p.ldw = front32_ldw(d);
    cudaError_t err = cudaFuncSetAttribute(
        front32_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr;
    cfg.gridDim = dim3(cluster, b, 1);
    cfg.blockDim = dim3(F32_FRONT_THREADS, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, front32_cluster_kernel, p);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  const int n_rows = b * t;
  gemm_f32_kernel<<<dim3((d + G32_TILE - 1) / G32_TILE, (n_rows + G32_TILE - 1) / G32_TILE),
                    G32_THREADS, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(wp), static_cast<const float*>(bp),
      static_cast<float*>(out), n_rows, t, n_cls, din, d);
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
