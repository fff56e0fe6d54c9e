// Fused n-gram ban + exact top-k threshold mask for Hopper (sm_90a):
// counterpart of image2text_tpu/ops/topk_mask.py::_topk_ban_mask_kernel.
//
// Per (B, V) f32 row: the row's banned ids (int32, -1 = empty slot, any
// count M; ids outside [0, V) dropped, a repeated id counted once) become
// -inf; p = the exact k-th largest remaining key; every value whose key is
// below p becomes -inf (ties at p are kept).  Values are compared as
// monotone int32 keys of their bits (non-negative floats order as int32;
// negative ones are re-keyed INT32_MIN - bits), so ±0.0 share key 0 and the
// output equals the reference's float compare `x < kth` bit for bit.  Here
// the key is taken unsigned (key ^ 0x80000000), which orders the same.
//
// What bounds it: bytes (each row read once and written once: 103 MB at
// (256, 50258), 0.031 ms at 3.35 TB/s).  Design: a radix select on the
// key, one block of RADIX_THREADS per row and a few tens of KB of shared
// memory, so every row of a decode batch runs in one wave:
//   pass 0  one 16-byte vector in SAMPLE_STRIDE of the row: a guess at
//           the first digit (the sample's k / SAMPLE_STRIDE +
//           GUESS_MARGIN-th key, bans not counted),
//           low enough that the k-th key's digit is very likely above it;
//   pass 1  the row from device memory in 16-byte loads: a histogram of
//           the key's top RADIX_BITS (2,048 bins) in shared memory, and
//           the keys and indices at or above the guessed digit compacted
//           into a candidate list of CAND_CAP entries;
//   bans    each live ban's contribution moves from its own bin to the
//           -inf bin (no scatter into the row; its original value is read
//           back by id); the live ids (first occurrence, in range) go to a
//           (B, M) scratch the wrapper allocates;
//   select  a block-wide suffix scan finds the bin holding the k-th key
//           and how many keys lie above it (fewer than k);
//   pass 2  only where the guess was above that bin or the list
//           overflowed: the row again (from L2), the keys of that bin and
//           above onto the list;
//   digits  the next 11 and 10 bits, histogrammed over the candidates of
//           the bin (the bans' corrections applied at each level) — or,
//           where the list overflowed (e.g. a row of equal values), over
//           the row re-read from global memory: the same count, exactly;
//   write   the row's output, written only: -inf everywhere, then the
//           listed values whose key is not below p back in place (every
//           kept key is on the list); where the list overflowed, the row
//           read once more and written with key < p → -inf; then, after a
//           block barrier, the live banned ids → -inf.
// The TPU kernel's 32 bisection rounds over the row (33 passes at 3 block
// barriers each) become one read of the row (two where pass 2 runs), one
// write and work on a short list.  Warp-aggregating the histogram's
// increments with __match_any_sync measured slower than the conflicts it
// saves (an ablation build on an NVIDIA H100 80GB HBM3 at 700 W, not kept).
#include "common.cuh"

#include <climits>

using namespace i2t;

namespace {

constexpr int RADIX_THREADS = 512;
constexpr int RADIX_BITS = 11;         // digits: key bits 31..21, 20..10, 9..0
constexpr int RADIX_BINS = 1 << RADIX_BITS;
constexpr int RADIX_LAST_BITS = 10;
constexpr int CAND_CAP = 4096;         // candidate keys kept in shared memory
constexpr int SAMPLE_STRIDE = 16;      // pass 0 reads one 16-byte vector in SAMPLE_STRIDE
constexpr int GUESS_MARGIN = 8;        // the guess: the sample's k / SAMPLE_STRIDE + GUESS_MARGIN-th key
constexpr int BINS_PER_THREAD = RADIX_BINS / RADIX_THREADS;
static_assert(BINS_PER_THREAD * RADIX_THREADS == RADIX_BINS, "bins per thread");
static_assert(2 * RADIX_BITS + RADIX_LAST_BITS == 32, "three digits cover the key");

__device__ __forceinline__ unsigned ukey(float v) {
  const int i = __float_as_int(v);
  return (unsigned)(i >= 0 ? i : INT_MIN - i) ^ 0x80000000u;
}

// Level L's digit: its shift and width; the bits above it are the prefix
// that levels 0..L-1 fixed.
__device__ __forceinline__ int digit_shift(int level) {
  return level == 0 ? 32 - RADIX_BITS : level == 1 ? RADIX_LAST_BITS : 0;
}
__device__ __forceinline__ int digit_bits(int level) {
  return level == 2 ? RADIX_LAST_BITS : RADIX_BITS;
}
__device__ __forceinline__ bool in_prefix(unsigned u, int level, unsigned prefix) {
  const int hi = digit_shift(level) + digit_bits(level);
  return hi == 32 || (u >> hi) == prefix;
}
__device__ __forceinline__ int digit(unsigned u, int level) {
  return (int)((u >> digit_shift(level)) & ((1u << digit_bits(level)) - 1));
}

// hist[bin] += 1 where ``ok``: plain shared-memory atomics (see above).
__device__ __forceinline__ void hist_add(int* hist, int bin, bool ok) {
  if (ok) atomicAdd(&hist[bin], 1);
}

// f(ok, value, index) over the row in warp-uniform steps (every lane of a
// warp calls f the same number of times): the unaligned head and tail one
// value a lane, the body in 16-byte loads, UNROLL of them in flight.
template <class F>
__device__ __forceinline__ void for_row(const float* xr, int V, F f) {
  constexpr int UNROLL = 4;
  const int lane = threadIdx.x % 32;
  const int head = min(V, (int)((16 - (reinterpret_cast<uintptr_t>(xr) & 15)) & 15) / 4);
  const int n4 = (V - head) / 4, tail0 = head + 4 * n4, ends = head + V - tail0;
  for (int i = threadIdx.x; i - lane < ends; i += RADIX_THREADS) {
    const bool ok = i < ends;
    const int idx = i < head ? i : tail0 + i - head;
    f(ok, ok ? xr[idx] : 0.f, idx);
  }
  const float4* x4 = reinterpret_cast<const float4*>(xr + head);
  for (int i = threadIdx.x; i - lane < n4; i += UNROLL * RADIX_THREADS) {
    float4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = i + u * RADIX_THREADS;
      v[u] = j < n4 ? x4[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = i + u * RADIX_THREADS;
      const bool ok = j < n4;
      const int idx = head + 4 * j;
      f(ok, v[u].x, idx);
      f(ok, v[u].y, idx + 1);
      f(ok, v[u].z, idx + 2);
      f(ok, v[u].w, idx + 3);
    }
  }
}

struct Select {
  unsigned prefix;  // the digits fixed so far
  int k;            // rank of the wanted key among the keys under the prefix
};

// Find the bin b with Σ_{b' > b} hist < sel.k <= Σ_{b' >= b} hist; append b
// to the prefix and make k its rank inside bin b.  ``part`` holds one int
// per warp.
__device__ void select_bin(const int* hist, int level, Select* sel, int* part) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int base = threadIdx.x * BINS_PER_THREAD;
  const int k = sel->k;  // read before the barrier: one thread rewrites it after
  int own = 0;
#pragma unroll
  for (int i = 0; i < BINS_PER_THREAD; ++i) own += hist[base + i];
  int incl = own;  // Σ over this lane and the lanes above it
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_down_sync(0xffffffffu, incl, o);
    if (lane + o < 32) incl += v;
  }
  if (lane == 0) part[warp] = incl;
  __syncthreads();
  int above = incl - own;
  for (int w = warp + 1; w < RADIX_THREADS / 32; ++w) above += part[w];
  if (above < k && k <= above + own) {
    for (int b = base + BINS_PER_THREAD - 1; b >= base; --b) {
      if (above + hist[b] >= k) {
        sel->prefix = (sel->prefix << digit_bits(level)) | (unsigned)b;
        sel->k = k - above;
        break;
      }
      above += hist[b];
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(RADIX_THREADS) topk_ban_mask_kernel(const float* x,
                                                                      const int* ban, int* live,
                                                                      float* out, int V, int M,
                                                                      int k) {
  __shared__ int hist[RADIX_BINS];
  __shared__ unsigned cand[CAND_CAP];
  __shared__ int cand_idx[CAND_CAP];
  __shared__ int part[RADIX_THREADS / 32];
  __shared__ int n_live, n_cand;
  __shared__ Select sel, guess;
  const size_t row = blockIdx.x;
  const float* xr = x + row * V;
  const int* br = ban + row * M;
  int* lr = live + row * M;
  const unsigned inf_key = ukey(-INFINITY);
  // the row: an unaligned head, n4 16-byte vectors from x4, the tail
  const int head = min(V, (int)((16 - (reinterpret_cast<uintptr_t>(xr) & 15)) & 15) / 4);
  const int n4 = (V - head) / 4, tail0 = head + 4 * n4;
  const float4* x4 = reinterpret_cast<const float4*>(xr + head);
  // key u at index idx onto the candidate list where ``ok`` (every lane of
  // the warp calls it); the count goes on past CAND_CAP: an overflow
  auto collect = [&](bool ok, unsigned u, int idx) {
    const unsigned m = __ballot_sync(0xffffffffu, ok);
    const int lane = threadIdx.x % 32;
    int at = 0;
    if (lane == __ffs(m) - 1) at = atomicAdd(&n_cand, __popc(m));
    at = __shfl_sync(0xffffffffu, at, m ? __ffs(m) - 1 : 0) + __popc(m & ((1u << lane) - 1));
    if (ok && at < CAND_CAP) {
      cand[at] = u;
      cand_idx[at] = idx;
    }
  };

  for (int i = threadIdx.x; i < RADIX_BINS; i += RADIX_THREADS) hist[i] = 0;
  if (threadIdx.x == 0) {
    n_live = n_cand = 0;
    sel.prefix = 0;
    sel.k = k;
  }
  __syncthreads();
  // live bans: in range, and no earlier slot holds the same id
  for (int j = threadIdx.x; j < M; j += RADIX_THREADS) {
    const int id = br[j];
    bool ok = id >= 0 && id < V;
    for (int e = 0; ok && e < j; ++e) ok = br[e] != id;
    lr[j] = ok ? id : -1;
    if (ok) atomicAdd(&n_live, 1);
  }
  // pass 0: a guess at the first digit, from a sample of the row, low
  // enough that the k-th key's digit is very likely at or above it
  for (int i = threadIdx.x * SAMPLE_STRIDE; i < n4; i += RADIX_THREADS * SAMPLE_STRIDE) {
    const float4 v = x4[i];
    hist_add(hist, (int)(ukey(v.x) >> digit_shift(0)), true);
    hist_add(hist, (int)(ukey(v.y) >> digit_shift(0)), true);
    hist_add(hist, (int)(ukey(v.z) >> digit_shift(0)), true);
    hist_add(hist, (int)(ukey(v.w) >> digit_shift(0)), true);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    guess.prefix = 0;
    guess.k = k / SAMPLE_STRIDE + GUESS_MARGIN;
  }
  __syncthreads();
  select_bin(hist, 0, &guess, part);  // no bin (a short sample): 0, every key
  const unsigned lowest = guess.prefix;
  for (int i = threadIdx.x; i < RADIX_BINS; i += RADIX_THREADS) hist[i] = 0;
  __syncthreads();
  // pass 1: the first digit's histogram, and the keys (and indices) at or
  // above the guessed digit
  for_row(xr, V, [&](bool ok, float v, int idx) {
    const unsigned u = ukey(v);
    hist_add(hist, (int)(u >> digit_shift(0)), ok);
    collect(ok && (u >> digit_shift(0)) >= lowest, u, idx);
  });
  __syncthreads();

  bool listed = false;
  for (int level = 0; level < 3; ++level) {
    const unsigned prefix = sel.prefix;
    if (level > 0) {
      for (int i = threadIdx.x; i < RADIX_BINS; i += RADIX_THREADS) hist[i] = 0;
      __syncthreads();
      auto count = [&](bool ok, unsigned u) {
        ok = ok && in_prefix(u, level, prefix);
        hist_add(hist, digit(ok ? u : 0u, level), ok);
      };
      if (listed) {
        for (int i = threadIdx.x; i - threadIdx.x % 32 < n_cand; i += RADIX_THREADS)
          count(i < n_cand, i < n_cand ? cand[i] : 0u);
      } else {
        for_row(xr, V, [&](bool ok, float v, int) { count(ok, ukey(v)); });
      }
    }
    // bans: each live id's key leaves its bin, n_live keys enter -inf's
    for (int j = threadIdx.x; j < M; j += RADIX_THREADS) {
      const int id = lr[j];
      if (id < 0) continue;
      const unsigned u = ukey(xr[id]);
      if (in_prefix(u, level, prefix)) atomicSub(&hist[digit(u, level)], 1);
    }
    if (threadIdx.x == 0 && n_live > 0 && in_prefix(inf_key, level, prefix))
      atomicAdd(&hist[digit(inf_key, level)], n_live);
    __syncthreads();
    select_bin(hist, level, &sel, part);
    if (level == 0) {
      // the list must hold the chosen top digit's keys and those above it
      // (fewer than k): pass 1's does unless the guess was too high or
      // the list overflowed; then pass 2 reads the row again for them
      const unsigned top = sel.prefix;
      if (lowest > top || n_cand > CAND_CAP) {
        __syncthreads();
        if (threadIdx.x == 0) n_cand = 0;
        __syncthreads();
        for_row(xr, V, [&](bool ok, float v, int idx) {
          const unsigned u = ukey(v);
          collect(ok && (u >> digit_shift(0)) >= top, u, idx);
        });
        __syncthreads();
      }
      listed = n_cand <= CAND_CAP;
    }
  }

  const unsigned p = sel.prefix;
  float* orow = out + row * V;
  if (listed) {
    // every kept key is on the list: the row becomes -inf, written only,
    // then the kept values go back to their places
    const float4 ninf = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    for (int i = threadIdx.x; i < head + V - tail0; i += RADIX_THREADS)
      __stcs(orow + (i < head ? i : tail0 + i - head), -INFINITY);
    float4* o4 = reinterpret_cast<float4*>(orow + head);
    for (int i = threadIdx.x; i < n4; i += RADIX_THREADS) __stcs(o4 + i, ninf);
    __syncthreads();
    for (int i = threadIdx.x; i < n_cand; i += RADIX_THREADS)
      if (cand[i] >= p) orow[cand_idx[i]] = xr[cand_idx[i]];
  } else {
    auto keep = [&](float v) { return ukey(v) < p ? -INFINITY : v; };
    for (int i = threadIdx.x; i < head + V - tail0; i += RADIX_THREADS) {
      const int idx = i < head ? i : tail0 + i - head;
      __stcs(orow + idx, keep(__ldcs(xr + idx)));
    }
    float4* o4 = reinterpret_cast<float4*>(orow + head);
    for (int i = threadIdx.x; i < n4; i += RADIX_THREADS) {
      float4 v = __ldcs(x4 + i);
      v.x = keep(v.x);
      v.y = keep(v.y);
      v.z = keep(v.z);
      v.w = keep(v.w);
      __stcs(o4 + i, v);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < M; j += RADIX_THREADS) {
    const int id = lr[j];
    if (id >= 0) orow[id] = -INFINITY;
  }
}

}  // namespace

// x (B, V) f32, ban (B, M) int32 or null (M 0), live (B, M) int32 scratch,
// out (B, V) f32; 1 <= k <= V.
extern "C" int topk_ban_mask_launch(const void* x, const void* ban, void* live, void* out, int B,
                                    int V, int M, int k, void* stream) {
  if (B <= 0 || V <= 0 || M < 0 || k < 1 || k > V || (M > 0 && (ban == nullptr || live == nullptr)))
    return (int)cudaErrorInvalidValue;
  topk_ban_mask_kernel<<<B, RADIX_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(ban), static_cast<int*>(live),
      static_cast<float*>(out), V, M, k);
  return (int)cudaGetLastError();
}
