// The port's bf16 GEMM for Hopper (sm_90a), shared by the encoder block
// kernels (fused_block.cu) and the encoder front (fused_frontend.cu):
//
//   C[(m / t_g) * c_T + c_off + m % t_g, n] =
//       bf16(bf16(bf16(Σ_k A[arow(m), k] B[k, n]) + bias[n]) + R[rrow(m), n])
//
// A (M, K) and the residual R are read through optional row-index lists
// (row m of image m / t_g is row rows[m % t_g] of that image's T rows); C
// rows land at an offset inside images of c_T rows.  Bias and residual are
// optional.  f32 accumulators; each add is rounded to bf16 as the module
// chain rounds it.
//
// What bounds it: operations (M 40,960, K 1,024, N 1,024–1,280 at the
// serving batch: ~0.1 ms at the 989 TFLOP/s bf16 peak, against ~0.02 ms of
// bytes).  The tensor cores reach that rate only through wgmma fed from
// shared memory, so: 128 x 256 output tiles, BK 64; a ring of 4 stages of
// A (128 x 64) and B (64 x 256) tiles in shared memory, both brought by TMA
// with the 128-byte swizzle that wgmma reads, each stage guarded by a
// "full" mbarrier (TMA's transaction count) and an "empty" one (the
// consumers' release); one producer warp keeps the TMA loads in flight
// while two consumer warpgroups each run m64n256k16 wgmmas on 64 of the
// tile's rows, one wgmma group kept in flight (setmaxnreg moves registers
// from the producer to the consumers' 128 accumulators).  The epilogue
// stages the tile in the ring as bf16 and writes whole 16-byte pieces of
// rows, with the bias and residual read the same way.
//
// A gathered A (a row list: the sparse block's bypass rows) cannot come
// through TMA, which loads boxes, not row lists; a gather pass first
// writes those rows contiguous into a scratch buffer (one read and one
// write of the rows, tens of µs at the serving batch), then the GEMM runs
// on it.  That keeps a single TMA path in the GEMM at the cost of one
// extra pass over 84 MB; a cp.async producer for the gathered case would
// save it.
#pragma once

#include <cuda.h>
#include <dlfcn.h>

#include "common.cuh"

namespace i2t {

constexpr int GEMM_BM = 128, GEMM_BN = 256, GEMM_BK = 64, GEMM_STAGES = 4;
constexpr int GEMM_THREADS = 384;  // warpgroups 0 and 1 consume, 2 produces
constexpr int GEMM_STAGE_BYTES = (GEMM_BM * GEMM_BK + GEMM_BK * GEMM_BN) * 2;
constexpr int GEMM_LDE = GEMM_BN + 8;  // epilogue staging row stride (bf16)
static_assert(GEMM_BM * GEMM_LDE * 2 <= GEMM_STAGES * GEMM_STAGE_BYTES, "epilogue staging");
// + 1 KB to align the ring to the swizzle's 1,024-byte period
constexpr size_t GEMM_SMEM = GEMM_STAGES * GEMM_STAGE_BYTES + 2 * GEMM_STAGES * 8 + 1024;

// ------------------------------------------------------------ Hopper PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Wait until the barrier's phase with parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// 2-D TMA load of the box at (c0 innermost, c1) into shared memory,
// completing on ``bar``'s transaction count.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (each >> 4).
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t)((lbo & 0x3FFFF) >> 4) << 16 |
         (uint64_t)((sbo & 0x3FFFF) >> 4) << 32 | 1ull << 62;
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A·B on m64n256k16 (bf16 in, f32 accumulators), A and B read from
// shared memory through their descriptors; B is MN-major (tnspB 1: its N
// dimension contiguous, as the (K, N) row-major weights are stored).
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// ------------------------------------------------------------------ GEMM
struct GemmArgs {
  const bf16* bias;
  const bf16* R;
  const int* r_rows;
  int r_T;
  bf16* C;
  int c_T, c_off, t_g, M, N, K;
};

// Row of the logical m-th row through an optional index list.
__device__ __forceinline__ size_t map_row(int m, const int* rows, int T, int t_g) {
  return rows != nullptr ? (size_t)(m / t_g) * T + rows[m % t_g] : (size_t)m;
}

__global__ void __launch_bounds__(GEMM_THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_b,
                GemmArgs p) {
  extern __shared__ __align__(128) unsigned char gemm_smem[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(gemm_smem) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + GEMM_STAGES * GEMM_STAGE_BYTES);
  uint64_t* empty = full + GEMM_STAGES;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int m0 = blockIdx.y * GEMM_BM, n0 = blockIdx.x * GEMM_BN;
  const int KT = (p.K + GEMM_BK - 1) / GEMM_BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < GEMM_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer warpgroup: one thread issues the TMA loads of every stage
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % GEMM_STAGES;
        mbar_wait(&empty[s], ((kt / GEMM_STAGES) & 1) ^ 1);
        unsigned char* st = ring + s * GEMM_STAGE_BYTES;
        mbar_expect_tx(&full[s], GEMM_STAGE_BYTES);
        tma_load_2d(st, &tma_a, &full[s], kt * GEMM_BK, m0);
        // B: four 64-column boxes of 64 k-rows of 128 bytes, 8 KB apart
        unsigned char* sb = st + GEMM_BM * GEMM_BK * 2;
#pragma unroll
        for (int c = 0; c < GEMM_BN / 64; ++c)
          tma_load_2d(sb + c * GEMM_BK * 128, &tma_b, &full[s], n0 + c * 64, kt * GEMM_BK);
      }
    }
  } else {
    // consumers: warpgroup wg owns rows m0 + 64 wg .. + 64 of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = tid / 32, lane = tid % 32;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % GEMM_STAGES;
      mbar_wait(&full[s], (kt / GEMM_STAGES) & 1);
      const unsigned char* sa = ring + s * GEMM_STAGE_BYTES + wg * 64 * 128;
      const unsigned char* sb = ring + s * GEMM_STAGE_BYTES + GEMM_BM * GEMM_BK * 2;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < GEMM_BK / 16; ++kk) {
        // A: K-major rows of 128 bytes, 8-row groups 1,024 bytes apart; a
        // k16 step is 32 bytes along the row.  B: MN-major, 8 k-rows of
        // 128 bytes per group (1,024 bytes), the 64-column boxes 8 KB apart.
        wgmma_m64n256k16(acc, wgmma_desc(sa + kk * 32, 16, 1024),
                         wgmma_desc(sb + kk * 16 * 128, GEMM_BK * 128, 1024));
      }
      wgmma_commit();
      fence_regs(acc);
      // one group in flight: the previous stage's products are done
      wgmma_wait<1>();
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % GEMM_STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // Epilogue.  Every load of this CTA's ring has landed and no more come,
    // so once both warpgroups are past it the ring holds the tile's bf16(acc)
    // (thread (warp w, lane l): rows 16 w + l / 4 (+ 8), columns 8 j + 2 (l
    // % 4) (+ 1)); then each row leaves in 16-byte pieces, bias and
    // residual added, coalesced.
    named_barrier(1, 256);
    bf16* stg = reinterpret_cast<bf16*>(ring) + wg * 64 * GEMM_LDE;
#pragma unroll
    for (int j = 0; j < GEMM_BN / 8; ++j) {
      const int r = warp * 16 + lane / 4, c = j * 8 + (lane % 4) * 2;
      *reinterpret_cast<uint32_t*>(stg + r * GEMM_LDE + c) = pack_bf2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(stg + (r + 8) * GEMM_LDE + c) =
          pack_bf2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    named_barrier(2 + wg, 128);
    for (int i = tid; i < 64 * (GEMM_BN / 8); i += 128) {
      const int r = i / (GEMM_BN / 8), c = (i % (GEMM_BN / 8)) * 8;
      const int m = m0 + wg * 64 + r, n = n0 + c;
      if (m >= p.M || n >= p.N) continue;
      Bf16x8 v = *reinterpret_cast<const Bf16x8*>(stg + r * GEMM_LDE + c);
      if (p.bias != nullptr) {
        const Bf16x8 bb = *reinterpret_cast<const Bf16x8*>(p.bias + n);
#pragma unroll
        for (int e = 0; e < 8; ++e) v.v[e] = to_bf(to_f(v.v[e]) + to_f(bb.v[e]));
      }
      if (p.R != nullptr) {
        const Bf16x8 rb = *reinterpret_cast<const Bf16x8*>(
            p.R + map_row(m, p.r_rows, p.r_T, p.t_g) * p.N + n);
#pragma unroll
        for (int e = 0; e < 8; ++e) v.v[e] = to_bf(to_f(rb.v[e]) + to_f(v.v[e]));
      }
      const size_t crow = (size_t)(m / p.t_g) * p.c_T + p.c_off + m % p.t_g;
      *reinterpret_cast<Bf16x8*>(p.C + crow * p.N + n) = v;
    }
  }
}

// out[m] = x[(m / tg) * T + rows[m % tg]] (d columns), a warp per row.
__global__ void __launch_bounds__(256) gather_rows_kernel(const bf16* x, bf16* out,
                                                          const int* rows, int n, int T, int tg,
                                                          int d) {
  const int m = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (m >= n) return;
  const bf16* src = x + map_row(m, rows, T, tg) * d;
  for (int c = lane * 8; c < d; c += 256)
    *reinterpret_cast<Bf16x8*>(out + (size_t)m * d + c) = *reinterpret_cast<const Bf16x8*>(src + c);
}

// cuTensorMapEncodeTiled from libcuda.so.1, which the process has loaded
// (dlsym: no -lcuda at link time).  The host helpers are static: an
// inline function's static local is one symbol across every library a
// process loads, and each kernel library needs its own state.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A 2-D bf16 tensor map (rows x cols, row-major, cols contiguous) with a
// box of box_rows x 64 columns (128 bytes) and the 128-byte swizzle;
// out-of-bounds elements load as zeros.
// Returns 0, or GEMM_TMA_ERROR + the CUresult of the encoding.
constexpr int GEMM_TMA_ERROR = 10000;
static inline int make_tma_2d(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return GEMM_TMA_ERROR + 9999;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : GEMM_TMA_ERROR + (int)r;
}

// Launch on ``stream``; returns the cudaError_t of the launch (or
// GEMM_TMA_ERROR + a CUresult where a tensor map cannot be encoded).  A row list
// on A needs ``a_scratch`` (n_img·t_g x K bf16) for the gathered rows.
// N and K must be positive multiples of 8 (TMA's 16-byte strides).
static inline int launch_gemm(const void* A, const void* a_rows, int a_T, void* a_scratch, const void* B,
                       const void* bias, const void* R, const void* r_rows, int r_T, void* C,
                       int c_T, int c_off, int n_img, int t_g, int N, int K,
                       cudaStream_t stream) {
  const int M = n_img * t_g;
  if (n_img <= 0 || t_g <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8 ||
      (a_rows != nullptr && a_scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (a_rows != nullptr) {
    gather_rows_kernel<<<(M + 7) / 8, 256, 0, stream>>>(
        static_cast<const bf16*>(A), static_cast<bf16*>(a_scratch),
        static_cast<const int*>(a_rows), M, a_T, t_g, K);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    A = a_scratch;
  }
  CUtensorMap ma, mb;
  int terr = make_tma_2d(&ma, A, M, K, GEMM_BM);
  if (terr == 0) terr = make_tma_2d(&mb, B, K, N, GEMM_BK);
  if (terr != 0) return terr;
  GemmArgs p;
  p.bias = static_cast<const bf16*>(bias);
  p.R = static_cast<const bf16*>(R);
  p.r_rows = static_cast<const int*>(r_rows);
  p.r_T = r_T;
  p.C = static_cast<bf16*>(C);
  p.c_T = c_T;
  p.c_off = c_off;
  p.t_g = t_g;
  p.M = M;
  p.N = N;
  p.K = K;
  const cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)GEMM_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + GEMM_BN - 1) / GEMM_BN, (M + GEMM_BM - 1) / GEMM_BM);
  gemm_kernel<<<grid, GEMM_THREADS, GEMM_SMEM, stream>>>(ma, mb, p);
  return (int)cudaGetLastError();
}

}  // namespace i2t
