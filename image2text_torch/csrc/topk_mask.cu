// Fused n-gram ban + exact top-k threshold mask for Hopper (sm_90a):
// counterpart of image2text_tpu/ops/topk_mask.py::_topk_ban_mask_kernel.
//
// Per (B, V) f32 row: the row's banned ids (int32, -1 = empty slot, any
// count M) become -inf; p = the exact k-th largest remaining value; every
// value below p becomes -inf (ties at p are kept).  Values are compared as
// monotone int32 keys of their bits (non-negative floats order as int32;
// negative ones are re-keyed INT32_MIN - bits), so ±0.0 share key 0 and the
// output equals the reference's float compare `x < kth` bit for bit.
//
// What bounds it: bytes (each row read once and written once: 103 MB at
// (256, 50258), 0.031 ms at 3.35 TB/s).  Design: one thread block per row
// holds the row in shared memory (50258 × 4 bytes = 201 KB of the 227 KB a
// block may use; the values, not their keys, so that -0.0 stays -0.0), so
// device memory sees one read and one write.  Bans are a loop over the
// row's M ids (no scatter; the TPU kernel's static unroll and its 32-slot
// cap do not come across).  The k-th key is found by the TPU kernel's
// bisection: the sign level, then bits 30..0, each round a block-wide count
// of keys >= the candidate (32 rounds over shared memory, three block
// barriers each).
#include "common.cuh"

#include <climits>

using namespace i2t;

namespace {

constexpr int THREADS = 1024;

__device__ __forceinline__ int to_key(float v) {
  const int i = __float_as_int(v);
  return i >= 0 ? i : INT_MIN - i;
}

// Count over the block; every thread gets the total.  ``red`` holds 33
// ints and is free again when this returns.
__device__ int block_count(int c, int* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  c = __reduce_add_sync(0xffffffffu, c);
  if (lane == 0) red[warp] = c;
  __syncthreads();
  if (warp == 0) {
    int s = lane < (int)(blockDim.x / 32) ? red[lane] : 0;
    s = __reduce_add_sync(0xffffffffu, s);
    if (lane == 0) red[32] = s;
  }
  __syncthreads();
  const int total = red[32];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(THREADS) topk_ban_mask_kernel(const float* x, const int* ban,
                                                                float* out, int V, int M, int k) {
  extern __shared__ float vals[];  // this row
  __shared__ int red[33];
  const size_t row = blockIdx.x;
  const float* xr = x + row * V;
  for (int c = threadIdx.x; c < V; c += blockDim.x) vals[c] = xr[c];
  __syncthreads();
  if (ban != nullptr) {
    for (int j = threadIdx.x; j < M; j += blockDim.x) {
      const int id = ban[row * M + j];
      if (id >= 0 && id < V) vals[id] = -INFINITY;
    }
    __syncthreads();
  }

  auto count_at_least = [&](int cand) {
    int c = 0;
    for (int i = threadIdx.x; i < V; i += blockDim.x) c += to_key(vals[i]) >= cand;
    return block_count(c, red);
  };
  int p = count_at_least(0) >= k ? 0 : INT_MIN;
  for (int b = 30; b >= 0; --b) {
    const int cand = p + (1 << b);
    if (count_at_least(cand) >= k) p = cand;
  }

  float* orow = out + row * V;
  for (int c = threadIdx.x; c < V; c += blockDim.x) {
    const float v = vals[c];
    orow[c] = to_key(v) < p ? -INFINITY : v;
  }
}

}  // namespace

extern "C" int topk_ban_mask_launch(const void* x, const void* ban, void* out, int B, int V,
                                    int M, int k, void* stream) {
  const size_t smem = (size_t)V * sizeof(float);
  if (B <= 0 || V <= 0 || M < 0 || k < 1 || k > V || smem > 227 * 1024 - 1024)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(topk_ban_mask_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  topk_ban_mask_kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(ban), static_cast<float*>(out), V,
      M, k);
  return (int)cudaGetLastError();
}
