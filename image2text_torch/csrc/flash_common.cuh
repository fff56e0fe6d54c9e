// Shared device helpers of the flash kernels: flash_attention.cu's bf16
// route and flash_attention_f32.cu's f32 one.  Each is a template over the
// including file's Params, which both give these fields: bias and its
// strides bsb, bsh, bsr; b, h, hk, sq, skv; causal, scale; seed,
// threshold, inv_keep; plane_h, plane_off.  Besides, the 3xTF32 products,
// the 4-byte cp.async and the cluster barriers of every f32 kernel on the
// tensor cores (the f32 flash pair, and the f32 forms of fused_moe.cu and
// fused_frontend.cu).
#pragma once

#include "common.cuh"

namespace i2t {

constexpr float NEG_BIG = -0.7f * 3.40282346638528859811704183484516925e38f;

// -- 3xTF32 products ---------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = big + small to about 21 bits: big rounded to TF32, small the exact
// remainder, whose low 13 bits the tensor core ignores (a cvt.rna of it
// measured slower with no smaller errors against a float64 truth:
// probes/flash_variants.py --f32, small_cvt_rna).
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}
// mma.sync m16n8k8, TF32 in, f32 accumulate: c += a·b.  Fragments (g =
// lane / 4, c = lane % 4): a0 (row g, k c), a1 (row g + 8, k c), a2 (row
// g, k c + 4), a3 (row g + 8, k c + 4); b0 (k c, col g), b1 (k c + 4, col
// g); c0, c1 (row g, cols 2c, 2c + 1), c2, c3 (row g + 8).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c += a·b in 3xTF32: the small terms first, then big·big.  FRESH: into a
// zeroed accumulator that one f32 add (rounded to nearest) then adds to c.
// The tensor cores' accumulation truncates the sum of an mma's products
// and its accumulator to the accumulator's precision, so on a long running
// sum those truncations add up with one sign (all_running in
// probes/flash_variants.py: up to 12× the errors at Llama-2-7B's call);
// FRESH keeps them to one k-step's partial, at the cost of a zeroed
// accumulator for each product in flight (registers).
template <bool FRESH>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  if constexpr (FRESH) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(t, as, bb[0], bb[1]);
    mma_tf32(t, ab, bs[0], bs[1]);
    mma_tf32(t, ab, bb[0], bb[1]);
#pragma unroll
    for (int u = 0; u < 4; ++u) c[u] += t[u];
  } else {
    mma_tf32(c, as, bb[0], bb[1]);
    mma_tf32(c, ab, bs[0], bs[1]);
    mma_tf32(c, ab, bb[0], bb[1]);
  }
}

// -- thread-block clusters (the f32 forms of fused_moe.cu and fused_frontend.cu)

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

// c += a·b in 3xTF32 with the three products independent: each into its
// own zeroed accumulator (the tensor cores may run them at once; chained
// into one, each waits on the one before), the three summed in f32
// (rounded to nearest), small terms first, then added to c.  Where a warp
// has few accumulator tiles to overlap (fused_moe.cu's 16-column products).
__device__ __forceinline__ void mma3x(float (&c)[4], const uint32_t (&ab)[4],
                                      const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                      const uint32_t (&bs)[2]) {
  float t1[4] = {0.f, 0.f, 0.f, 0.f}, t2[4] = {0.f, 0.f, 0.f, 0.f}, t3[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t1, as, bb[0], bb[1]);
  mma_tf32(t2, ab, bs[0], bs[1]);
  mma_tf32(t3, ab, bb[0], bb[1]);
#pragma unroll
  for (int u = 0; u < 4; ++u) c[u] += (t1[u] + t2[u]) + t3[u];
}

// The hash's (global) plane of (batch row bi, head hi).
template <typename P>
__device__ __forceinline__ int hash_plane(const P& p, int bi, int hi) {
  return p.plane_off + bi * p.plane_h + hi;
}

// ``plane`` is the hash's plane: hash_plane(p, batch, head).
template <typename P>
__device__ __forceinline__ float keep_scale(const P& p, int row, int col, int plane) {
  return keep_hash(row, col, plane, p.seed) < p.threshold ? p.inv_keep : 0.f;
}

// Max over the 4 lanes of a quad (the lanes holding one accumulator row).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// 4-byte asynchronous copy; pred false zero-fills and reads nothing.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 4 : 0));
}

// Rows [r0, r0 + n) of a (rows, D) matrix starting at row ``base`` into
// shared memory (row stride D plus 16 bytes) by 16-byte cp.async, zeros
// past ``rows``.
template <int D, typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, size_t base, int r0, int rows,
                                          int n) {
  constexpr int V = 16 / sizeof(T), LD = D + V;
  for (int i = threadIdx.x; i < n * (D / V); i += blockDim.x) {
    const int r = i / (D / V), c = (i % (D / V)) * V;
    const bool in = r0 + r < rows;
    cp_async16(dst + r * LD + c, src + (in ? (base + r0 + r) * D + c : 0), in);
  }
}

// A K/V plane: its batch row, first head and folded query rows (the h
// heads' rows for one K/V head, else its own head's).
struct Plane {
  int bi, h0, nrows;
  size_t base;  // first folded row of (b, h, sq)
};

template <typename P>
__device__ __forceinline__ Plane plane_of(const P& p, int kvp) {
  Plane pl;
  pl.bi = p.hk == 1 ? kvp : kvp / p.h;
  pl.h0 = p.hk == 1 ? 0 : kvp % p.h;
  pl.nrows = (p.hk == 1 ? p.h : 1) * p.sq;
  pl.base = (size_t)(pl.bi * p.h + pl.h0) * p.sq;
  return pl;
}

// A lane's two folded rows (f and f + 8) unfolded to (head, row): the
// hash's plane, the causal limit (the last key the row sees), the bias row.
struct LaneRows {
  int row[2], lim[2], plane[2];
  bool in[2];
  const float* brow[2];
  size_t at[2];  // the row of (b·h·sq) in out, lse, D and dQ
};

template <typename P>
__device__ __forceinline__ LaneRows lane_rows(const P& p, const Plane& pl, int f) {
  LaneRows r;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int fr = f + 8 * hh;
    r.in[hh] = fr < pl.nrows;
    const int head = pl.h0 + (r.in[hh] ? fr / p.sq : 0);
    r.row[hh] = r.in[hh] ? fr % p.sq : 0;
    r.plane[hh] = hash_plane(p, pl.bi, head);
    r.lim[hh] = r.row[hh] + p.skv - p.sq;
    r.brow[hh] = (p.bias != nullptr && r.in[hh])
                     ? p.bias + pl.bi * p.bsb + head * p.bsh + r.row[hh] * p.bsr
                     : nullptr;
    r.at[hh] = pl.base + fr;
  }
  return r;
}

// The score of (the lane's row hh, col): scaled, the bias clamped, the
// causal mask; -inf past skv.
template <typename P>
__device__ __forceinline__ float masked_score(const P& p, const LaneRows& r, int hh, float s,
                                              int col) {
  if (col >= p.skv) return -INFINITY;
  float x = s * p.scale;
  if (r.brow[hh] != nullptr) x += fmaxf(r.brow[hh][col], NEG_BIG);
  if (p.causal && col > r.lim[hh]) x = NEG_BIG;
  return x;
}

// The last key any of folded rows [f0, f1) sees under causal: the limit of
// the largest row among them (sq − 1 where they cross a head's end).
template <typename P>
__device__ __forceinline__ int rows_band(const P& p, int f0, int f1) {
  const int last = f0 / p.sq != (f1 - 1) / p.sq ? p.sq - 1 : (f1 - 1) % p.sq;
  return last + p.skv - p.sq;
}

// The last key every one of folded rows [f0, f1) sees under causal: the
// limit of the smallest row among them (row 0 where they cross a head's end).
template <typename P>
__device__ __forceinline__ int rows_floor(const P& p, int f0, int f1) {
  const int first = f0 / p.sq != (f1 - 1) / p.sq ? 0 : f0 % p.sq;
  return first + p.skv - p.sq;
}

// Keys [k0, k1) are real and seen by every row whose causal floor is
// ``floor``, with no bias: their scores need only the scale.
template <typename P>
__device__ __forceinline__ bool unmasked(const P& p, int k0, int k1, int floor) {
  return p.bias == nullptr && k1 <= p.skv && (!p.causal || k1 - 1 <= floor);
}

}  // namespace i2t
