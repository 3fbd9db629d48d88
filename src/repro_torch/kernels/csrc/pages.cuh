// Shared pieces of the kernels (commit_fused.cu, gf_parity.cu,
// xor_parity.cu): blocks of kThreads threads; for the per-page sweeps one
// CTA per page, Fletcher sums accumulated in uint32 with natural wrap and
// reduced across the CTA with warp shuffles, and the per-rank row digest as
// exact integer atomics; for the flat word kernels, the size of a one-wave
// grid.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace pages {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// CTA-wide sum of K per-thread values; the result is valid in thread 0.
template <int K>
__device__ __forceinline__ void block_sum(uint32_t (&v)[K]) {
  __shared__ uint32_t sh[K][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = warp_sum(v[k]);
    if (lane == 0) sh[k][warp] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      v[k] = warp_sum(lane < kWarps ? sh[k][lane] : 0u);
  }
}

// Fletcher (A, B) of four consecutive words, the first of weight wt
// (weights run bw, bw - 1, ..., 1 over the page).
__device__ __forceinline__ void fletcher_add(const uint4 w, uint32_t wt,
                                             uint32_t& a, uint32_t& b) {
  a += w.x + w.y + w.z + w.w;
  b += wt * w.x + (wt - 1u) * w.y + (wt - 2u) * w.z + (wt - 3u) * w.w;
}

// Add page `local` of a rank's n pages into the rank's digest (A, B):
// checksum.combine's term, B + (n - 1 - local) * bw * A, mod 2^32.
__device__ __forceinline__ void digest_add(uint32_t* digest, int64_t rank,
                                           uint32_t local, uint32_t n,
                                           uint32_t bw, uint32_t a,
                                           uint32_t b) {
  const uint32_t after = (n - 1u - local) * bw;
  atomicAdd(&digest[2 * rank], a);
  atomicAdd(&digest[2 * rank + 1], b + after * a);
}

// Blocks of `kernel` (kThreads threads, no dynamic shared memory) that
// the current device holds at once: the grid of one full wave.
inline int resident_blocks(const void* kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return sms * (per_sm > 0 ? per_sm : 1);
}

}  // namespace pages
