// Int4 dequant-matmul for Hopper (sm_90a): counterpart of
// image2text_tpu/ops/int4_matmul.py::_int4_matmul_kernel.
//
//   y[r, o] = Σ_b s[o, b] · Σ_{c in strip b} ( x[r, c]        · (lo(W[o, c]) − 8)
//                                           + x[r, in/2 + c] · (hi(W[o, c]) − 8) )
//
// W is (out, in/2) packed bytes, s (out, in/64) f32 or bf16 scales, x
// (rows, in) bf16, y (rows, out) bf16 or f32; accumulation in f32.
//
// What bounds it on the H100: operations at the GPT-2-medium shapes (256
// decode rows, in 1,024, out 3,072: 1.6 GFLOP, 1.6 µs at the bf16 peak,
// against 2.3 MB of bytes, 0.7 µs), bytes only at a few rows.  In
// practice the L2 → SM traffic of x, read once per output tile, sets its
// pace (PERF.md §6).
//
// A block owns a BM x BN (rows x outs) tile: 256 x 64 up to 256 rows (one
// block covers every decode row of its output columns), 128 x 128 above
// (ops/int4_matmul.py::int4_plan picks, reading DEC_BM, DEC_BN, TRAIN_BM,
// TRAIN_BN and PAIRS from this file); one warpgroup per 64 rows.  It walks
// the input in stages of PAIRS = 2 strip pairs (128 input columns: 64 low,
// 64 high): a ring of STAGES = 3 stages of the x tile, two TMA boxes a
// stage, kept two stages ahead by one thread; the packed bytes go to
// registers a stage ahead and are unpacked once per block, by all its
// threads, into one of two bf16 tiles in shared memory — a nibble q becomes
// the bf16 128 + q by bit pattern, minus 136 exactly — while the tensor
// cores run the stage before.  x and the unpacked tile lie K-major with the
// 128-byte swizzle that wgmma reads; each warpgroup runs, per strip pair,
// four m64nBNk16 wgmmas into a fresh f32 partial (x·(q − 8) exact) and adds
// the partial times its f32 scale to its accumulator.  The float weight
// never exists in device memory.  When the output tiles alone leave SMs
// idle, the strip pairs are split over ``splits`` blocks (never inside a
// strip); each writes f32 partials and a second kernel sums them in split
// order, so results are bitwise equal from run to run (no atomics).
#include "gemm.cuh"

using namespace i2t;

namespace {

constexpr int DEC_BM = 256;    // rows of a block tile up to DEC_BM rows
constexpr int DEC_BN = 64;     // its outs
constexpr int TRAIN_BM = 128;  // rows of a block tile past DEC_BM rows
constexpr int TRAIN_BN = 128;  // its outs
constexpr int PAIRS = 2;       // 64-column strip pairs a stage
constexpr int STAGES = 3;      // ring depth
constexpr int WB = PAIRS * 32;  // packed bytes a row a stage
constexpr int ATOM = 128;       // bytes of a swizzled K-major row: 64 bf16
static_assert(WB == 64, "a stage's packed row is eight 8-byte pieces");

// Shared memory: the ring's x tiles ([lo|hi atom][BM rows][128 B] a
// stage), two stages' unpacked weights ([lo|hi][BN][128 B]) and scales; 1
// KB to align the swizzled tiles to their 1,024-byte period.
template <int BM, int BN>
struct Smem {
  static constexpr size_t x_stage = (size_t)2 * BM * ATOM;
  static constexpr size_t x = STAGES * x_stage;
  static constexpr size_t wt = (size_t)2 * BN * ATOM;
  static constexpr size_t bytes =
      x + 2 * wt + 2 * PAIRS * BN * sizeof(float) + STAGES * sizeof(uint64_t) + 1024;
};
static_assert(Smem<DEC_BM, DEC_BN>::bytes <= 232448, "decode tile exceeds a block's shared memory");
static_assert(Smem<TRAIN_BM, TRAIN_BN>::bytes <= 232448, "train tile exceeds a block's shared memory");

// d (+)= A·B on m64n64k16 (bf16 in, f32 accumulators), A and B K-major in
// shared memory through their descriptors; d is overwritten when
// ``accumulate`` is 0.
__device__ __forceinline__ void wgmma_m64n64k16_kmajor(float (&d)[32], uint64_t da, uint64_t db,
                                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A·B on m64n128k16 (bf16 in, f32 accumulators), A and B K-major in
// shared memory through their descriptors; d is overwritten when
// ``accumulate`` is 0.
__device__ __forceinline__ void wgmma_m64n128k16_kmajor(float (&d)[64], uint64_t da, uint64_t db,
                                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Two packed bytes (k in bits 0-7, k + 1 in bits 8-15) → the bf16 pair
// (q_k − 8, q_{k+1} − 8) of their low (HI false) or high nibbles.
template <bool HI>
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t w) {
  const uint32_t q = HI ? (((w >> 4) & 0xFu) | ((w & 0xF000u) << 4))
                        : ((w & 0xFu) | ((w & 0xF00u) << 8));
  uint32_t r = 0x43004300u | q;  // bf16 128 + q in each half
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&r);
  v = __hsub2(v, __float2bfloat162_rn(136.f));
  return *reinterpret_cast<uint32_t*>(&v);
}

template <bool SCALE_BF16>
__device__ __forceinline__ float load_scale(const void* scales, size_t at) {
  return SCALE_BF16 ? to_f(static_cast<const bf16*>(scales)[at])
                    : static_cast<const float*>(scales)[at];
}

// Byte offset of 16-byte chunk ``c`` (0-7) of row ``r`` in a 128-byte
// swizzled K-major tile.
__device__ __forceinline__ int swz(int r, int c) { return r * ATOM + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Grid (⌈out/BN⌉, ⌈rows/BM⌉, splits), BM/64 warpgroups.  Split z takes
// strip pairs [z·nb/splits, (z+1)·nb/splits), nb = in_pad/64; with one
// split and a bf16 y it writes y, else f32 partials part[z][rows][out]
// (with one split and no y: the f32 product itself).  Stage st's
// products run on the tensor cores while the block issues the x copies of
// stage st + 2 and unpacks stage st + 1's bytes, which it loaded into
// registers one stage before.
template <int BM, int BN, bool SCALE_BF16>
__global__ void __launch_bounds__(BM * 2, 1)
    int4_matmul_kernel(const __grid_constant__ CUtensorMap tma_x, const uint8_t* __restrict__ w,
                       const void* __restrict__ scales, bf16* __restrict__ y,
                       float* __restrict__ part, int rows, int out, int in_pad) {
  using S = Smem<BM, BN>;
  constexpr int THREADS = BM * 2, NR = BN / 2;  // accumulators a thread
  constexpr int WV = BN * WB / 8 / THREADS;     // 8-byte pieces of a stage's bytes a thread
  static_assert(WV >= 1 && BN * WB == WV * 8 * THREADS, "whole pieces of the packed bytes");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* xs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* wt = xs + S::x;                          // [2][lo|hi][BN][128 B] unpacked
  float* scs = reinterpret_cast<float*>(wt + 2 * S::wt);  // [2][PAIRS][BN]
  uint64_t* full = reinterpret_cast<uint64_t*>(scs + 2 * PAIRS * BN);  // a ring slot's x landed

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32, g = lane / 4, c4 = lane % 4;
  const int wrow = wg * 64 + ((tid % 128) / 32) * 16;  // this warp's first row of the tile
  const int half = in_pad / 2, nb = in_pad / 64;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int split = blockIdx.z, splits = gridDim.z;
  const int sp0 = (int)((long long)split * nb / splits);
  const int sp1 = (int)((long long)(split + 1) * nb / splits);
  const int nst = (sp1 - sp0 + PAIRS - 1) / PAIRS;

  // stage st's x: two TMA boxes of BM rows x 64 columns (the low and the
  // high half's columns of its strip pairs; rows past ``rows`` and columns
  // past in_pad load as zeros), issued by one thread
  auto load_x = [&](int st) {
    const int slot = st % STAGES, pa = sp0 + st * PAIRS;
    unsigned char* xd = xs + slot * S::x_stage;
    mbar_expect_tx(&full[slot], (uint32_t)S::x_stage);
    tma_load_2d(xd, &tma_x, &full[slot], pa * 32, m0);
    tma_load_2d(xd + BM * ATOM, &tma_x, &full[slot], half + pa * 32, m0);
  };
  // stage st's packed bytes: piece v of this thread is row (tid + v·T) / 8,
  // bytes 8·((tid + v·T) % 8) .. + 8 of the stage (zeros past out or the split)
  auto load_w = [&](int st, uint2 (&wr)[WV]) {
    const int pa = sp0 + st * PAIRS, cnt = min(PAIRS, sp1 - pa);
#pragma unroll
    for (int v = 0; v < WV; ++v) {
      const int i = tid + v * THREADS, r = i / 8, c = (i % 8) * 8;
      wr[v] = (st < nst && n0 + r < out && c < cnt * 32)
                  ? __ldg(reinterpret_cast<const uint2*>(w + (size_t)(n0 + r) * half +
                                                         (size_t)pa * 32 + c))
                  : make_uint2(0, 0);
    }
  };
  // a piece's 8 low nibbles to its 16-byte chunk of atom 0, the high to
  // atom 1 of unpacked buffer ``b``
  auto unpack = [&](const uint2 (&wr)[WV], int b) {
    unsigned char* dst = wt + b * S::wt;
#pragma unroll
    for (int v = 0; v < WV; ++v) {
      const int i = tid + v * THREADS, at = swz(i / 8, i % 8);
      *reinterpret_cast<uint4*>(dst + at) =
          make_uint4(nibbles_to_bf16x2<false>(wr[v].x), nibbles_to_bf16x2<false>(wr[v].x >> 16),
                     nibbles_to_bf16x2<false>(wr[v].y), nibbles_to_bf16x2<false>(wr[v].y >> 16));
      *reinterpret_cast<uint4*>(dst + BN * ATOM + at) =
          make_uint4(nibbles_to_bf16x2<true>(wr[v].x), nibbles_to_bf16x2<true>(wr[v].x >> 16),
                     nibbles_to_bf16x2<true>(wr[v].y), nibbles_to_bf16x2<true>(wr[v].y >> 16));
    }
  };
  // stage st's scales: thread tid < PAIRS·BN takes (pair tid / BN, out tid % BN)
  auto scale_of = [&](int st) {
    const int j = tid / BN, n = n0 + tid % BN, pa = sp0 + st * PAIRS + j;
    return (tid < PAIRS * BN && st < nst && pa < sp1 && n < out)
               ? load_scale<SCALE_BF16>(scales, (size_t)n * nb + pa)
               : 0.f;
  };

  float acc[NR], ps[PAIRS][NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] = 0.f;

  uint2 wr[WV];
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int st = 0; st < STAGES - 1 && st < nst; ++st) load_x(st);
  }
  load_w(0, wr);
  unpack(wr, 0);
  if (tid < PAIRS * BN) scs[tid] = scale_of(0);
  load_w(1, wr);
  float next_scale = scale_of(1);
  for (int st = 0; st < nst; ++st) {
    fence_async_smem();
    __syncthreads();  // stage st's bytes and scales ready; stage st - 1's products done
    mbar_wait(&full[st % STAGES], (st / STAGES) & 1);  // stage st's x landed
    const unsigned char* xa = xs + (st % STAGES) * S::x_stage + wg * 64 * ATOM;
    const unsigned char* wb = wt + (st & 1) * S::wt;
    const int cnt = min(PAIRS, sp1 - (sp0 + st * PAIRS));
#pragma unroll
    for (int j = 0; j < PAIRS; ++j) {
      if (j >= cnt) break;
      // the strip pair's 32 low then 32 high columns: four k16 steps
      fence_regs(ps[j]);
      wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        const int atom = kq / 2, kb = j * 64 + (kq % 2) * 32;
        const uint64_t da = wgmma_desc(xa + atom * BM * ATOM + kb, 16, 1024);
        const uint64_t db = wgmma_desc(wb + atom * BN * ATOM + kb, 16, 1024);
        if constexpr (BN == 64)
          wgmma_m64n64k16_kmajor(ps[j], da, db, kq);
        else
          wgmma_m64n128k16_kmajor(ps[j], da, db, kq);
      }
    }
    wgmma_commit();
    // while the tensor cores run: stage st + 2's x, stage st + 1's bytes
    if (tid == 0 && st + STAGES - 1 < nst) load_x(st + STAGES - 1);
    if (st + 1 < nst) {
      unpack(wr, (st + 1) & 1);
      if (tid < PAIRS * BN) scs[((st + 1) & 1) * PAIRS * BN + tid] = next_scale;
      load_w(st + 2, wr);
      next_scale = scale_of(st + 2);
    }
    wgmma_wait<0>();
    const float* scl = scs + (st & 1) * PAIRS * BN + 2 * c4;
#pragma unroll
    for (int j = 0; j < PAIRS; ++j) {
      if (j >= cnt) break;
      fence_regs(ps[j]);
      // ps[j][4·jn + e]: row g + 8(e / 2), column 8·jn + 2·c4 + e % 2
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn) {
        const float2 sc = *reinterpret_cast<const float2*>(scl + j * BN + jn * 8);
        acc[4 * jn] += ps[j][4 * jn] * sc.x;
        acc[4 * jn + 1] += ps[j][4 * jn + 1] * sc.y;
        acc[4 * jn + 2] += ps[j][4 * jn + 2] * sc.x;
        acc[4 * jn + 3] += ps[j][4 * jn + 3] * sc.y;
      }
    }
  }

  // pairs of columns stored together where out is even
  const bool pairs = out % 2 == 0;
#pragma unroll
  for (int jn = 0; jn < BN / 8; ++jn)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = m0 + wrow + g + 8 * hh, c = n0 + jn * 8 + 2 * c4;
      if (r >= rows || c >= out) continue;
      const float v0 = acc[4 * jn + 2 * hh], v1 = acc[4 * jn + 2 * hh + 1];
      if (splits == 1 && y != nullptr) {
        bf16* dst = y + (size_t)r * out + c;
        if (pairs) {
          *reinterpret_cast<uint32_t*>(dst) = pack_bf2(v0, v1);
        } else {
          dst[0] = to_bf(v0);
          if (c + 1 < out) dst[1] = to_bf(v1);
        }
      } else {
        float* dst = part + ((size_t)split * rows + r) * out + c;
        if (pairs) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          dst[0] = v0;
          if (c + 1 < out) dst[1] = v1;
        }
      }
    }
}

__device__ __forceinline__ void store(bf16* y, float v) { *y = to_bf(v); }
__device__ __forceinline__ void store(float* y, float v) { *y = v; }

// y = Σ_z part[z] in split order, as bf16 or f32; ``n`` = rows·out
// elements.
template <typename T>
__global__ void __launch_bounds__(256) int4_reduce_kernel(const float* __restrict__ part,
                                                          T* __restrict__ y, long long n,
                                                          int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = part[i];
  for (int z = 1; z < splits; ++z) s += part[z * n + i];
  store(y + i, s);
}

template <int BM, int BN, bool SCALE_BF16>
int launch(const bf16* x, const uint8_t* w, const void* scales, bf16* y, float* part, int rows,
           int out, int in_pad, int splits, cudaStream_t st) {
  CUtensorMap tma_x;
  const int terr = make_tma_2d(&tma_x, x, rows, in_pad, BM);
  if (terr != 0) return terr;
  auto kernel = int4_matmul_kernel<BM, BN, SCALE_BF16>;
  static bool attr_set = false;  // internal linkage: one flag per instantiation of this library
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<BM, BN>::bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid((out + BN - 1) / BN, (rows + BM - 1) / BM, splits);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  kernel<<<grid, BM * 2, Smem<BM, BN>::bytes, st>>>(tma_x, w, scales, y, part, rows, out, in_pad);
  return (int)cudaGetLastError();
}

}  // namespace

// One int4 dequant-matmul: tile (bm, bn) one of (DEC_BM, DEC_BN) and
// (TRAIN_BM, TRAIN_BN); ``splits`` blocks over the strip pairs of each
// tile (1 to in_pad/64; above 1 ``part`` holds splits·rows·out f32
// partials, summed by a second kernel).  ``y_f32``: y is f32, the sums
// never rounded to bf16 (a row shard's partial product, which the model
// group sums before the one rounding of the unsplit product).
extern "C" int int4_matmul_launch(const void* x, const void* w, const void* scales, int scale_bf16,
                                  void* y, void* part, int rows, int out, int in_pad, int bm,
                                  int bn, int splits, int y_f32, void* stream) {
  if (rows <= 0 || out <= 0 || in_pad <= 0 || in_pad % 64 || splits < 1 ||
      splits > in_pad / 64 || splits > 65535 || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const uint8_t* wb = static_cast<const uint8_t*>(w);
  bf16* yb = y_f32 ? nullptr : static_cast<bf16*>(y);
  float* pb = static_cast<float*>(y_f32 && splits == 1 ? y : part);
  int err;
  if (bm == DEC_BM && bn == DEC_BN)
    err = scale_bf16 ? launch<DEC_BM, DEC_BN, true>(xb, wb, scales, yb, pb, rows, out, in_pad, splits, st)
                     : launch<DEC_BM, DEC_BN, false>(xb, wb, scales, yb, pb, rows, out, in_pad, splits, st);
  else if (bm == TRAIN_BM && bn == TRAIN_BN)
    err = scale_bf16
              ? launch<TRAIN_BM, TRAIN_BN, true>(xb, wb, scales, yb, pb, rows, out, in_pad, splits, st)
              : launch<TRAIN_BM, TRAIN_BN, false>(xb, wb, scales, yb, pb, rows, out, in_pad, splits, st);
  else
    return (int)cudaErrorInvalidValue;
  if (err != 0 || splits == 1) return err;
  const long long n = (long long)rows * out;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  if (y_f32)
    int4_reduce_kernel<float><<<blocks, 256, 0, st>>>(pb, static_cast<float*>(y), n, splits);
  else
    int4_reduce_kernel<bf16><<<blocks, 256, 0, st>>>(pb, yb, n, splits);
  return (int)cudaGetLastError();
}
