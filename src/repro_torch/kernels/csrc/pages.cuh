// Shared pieces of the kernels (commit_fused.cu, fletcher.cu,
// gf_parity.cu, xor_parity.cu): blocks of kThreads threads; Fletcher sums
// accumulated in uint32 with natural wrap; for the page-run sweeps
// (commit_pages, fletcher_pages, syndrome_pages) a CTA per run of pages of
// one rank, a warp a page, the page's sums reduced in its warp and one
// digest atomic pair a CTA; for the flat word kernels, the size of a
// one-wave grid.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace pages {

constexpr int kThreads = 256;

// Fletcher (A, B) of four consecutive words, the first of weight wt
// (weights run bw, bw - 1, ..., 1 over the page).
__device__ __forceinline__ void fletcher_add(const uint4 w, uint32_t wt,
                                             uint32_t& a, uint32_t& b) {
  a += w.x + w.y + w.z + w.w;
  b += wt * w.x + (wt - 1u) * w.y + (wt - 2u) * w.z + (wt - 3u) * w.w;
}

// -- page runs ---------------------------------------------------------------
// A CTA of kRunThreads threads takes a run of up to kRunPages consecutive
// pages of one rank (the rank's last run is shorter where kRunPages does
// not divide n), a warp a page at a time: warp w takes pages first + w,
// first + w + kRunWarps, ...; a lane loads kLaneUnroll uint4 of its page
// at once.  A page's sums reduce within its warp (one REDUX an operand),
// with no barrier, and the run's digest partials reach the rank's digest
// as one atomic pair a CTA.  CTAs are ordered rank-major, so the CTAs at
// work at any moment cover one window of consecutive pages (and of each
// syndrome plane).  The sizes were timed against other runs, CTA sizes,
// unrolls and CTA orders (scripts/torch_kernel_variants.py, PERF.md §6);
// kernels/fletcher.py's RUN_PAGES mirrors kRunPages.
constexpr int kRunThreads = 256;
constexpr int kRunWarps = kRunThreads / 32;
constexpr int kRunPages = 8;
constexpr int kLaneUnroll = 8;

struct PageRun {
  int64_t rank;          // the rank whose pages this CTA takes
  int first, last;       // its pages [first, last) of the rank's n
};

// CTAs a rank: n pages in runs of kRunPages.
constexpr int runs_per_rank(int n) {
  return (n + kRunPages - 1) / kRunPages;
}

__device__ __forceinline__ PageRun page_run(int n, int runs) {
  const int64_t rank = blockIdx.x / runs;
  const int first = static_cast<int>(blockIdx.x - rank * runs) * kRunPages;
  return {rank, first, first + kRunPages < n ? first + kRunPages : n};
}

// Page `local`'s share of its rank's digest B, checksum.combine's term
// B + (n - 1 - local) * bw * A, mod 2^32 (its share of A is A).
__device__ __forceinline__ uint32_t digest_b(uint32_t local, uint32_t n,
                                             uint32_t bw, uint32_t a,
                                             uint32_t b) {
  return b + (n - 1u - local) * bw * a;
}

// Sum the CTA's warps' digest partials (each valid in its lane 0) and add
// them into digest[rank] with one atomic pair.  Every thread of the CTA
// calls it.
__device__ __forceinline__ void run_digest_add(uint32_t* digest, int64_t rank,
                                               uint32_t a, uint32_t b) {
  __shared__ uint32_t sh[2][kRunWarps];
  if ((threadIdx.x & 31) == 0) {
    sh[0][threadIdx.x >> 5] = a;
    sh[1][threadIdx.x >> 5] = b;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  uint32_t sa = 0, sb = 0;
#pragma unroll
  for (int w = 0; w < kRunWarps; ++w) {
    sa += sh[0][w];
    sb += sh[1][w];
  }
  atomicAdd(&digest[2 * rank], sa);
  atomicAdd(&digest[2 * rank + 1], sb);
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
