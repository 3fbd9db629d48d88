// fletcher_pages<DIGEST>: per-page Fletcher-64 terms on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/fletcher.py:38  fletcher_blocks (_fletcher_kernel, :22)
//   src/repro/kernels/fletcher.py:82  fletcher_stream (_stream_fletcher_kernel, :48)
// The streamed form differs from the flat one only in the whole-row digest
// it adds, so both are one template: DIGEST=false is fletcher_blocks,
// DIGEST=true is fletcher_stream.
//
// Function, per page p of bw u32 words w_0..w_{bw-1}:
//   A = sum_i w_i,   B = sum_i (bw - i) * w_i           (both mod 2^32)
// and, with DIGEST, per rank r over its n pages (p = r*n + local):
//   digest[r] += (A, B + (n - 1 - local) * bw * A)      (mod 2^32)
// which is checksum.combine of the rank's term table.
//
// Bound: memory bytes.  Each word is read once and costs 3 integer ops, far
// below the card's ~16.7 T int32 ops/s; the floor is bytes / 3.35 TB/s.
// Design: one CTA of 256 threads per page; each thread loads one uint4
// (neighbouring threads read neighbouring 16 B, so a warp reads 512 B
// contiguously), accumulates in uint32 with natural wrap, and the CTA
// reduces with warp shuffles.  The digest is an atomicAdd of each page's
// contribution into a zeroed (ranks, 2) table: integer atomics are exact in
// any order, so it is deterministic.  One launch covers every rank's pages.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <bool DIGEST>
__global__ void __launch_bounds__(kThreads)
fletcher_pages(const uint32_t* __restrict__ x, uint32_t* __restrict__ terms,
               uint32_t* __restrict__ digest, int bw, int pages_per_rank) {
  const int64_t page = blockIdx.x;
  const uint4* p = reinterpret_cast<const uint4*>(x + page * bw);
  uint32_t a = 0, b = 0;
  for (int v = threadIdx.x; v < bw / 4; v += kThreads) {
    const uint4 w = p[v];
    const uint32_t wt = static_cast<uint32_t>(bw - 4 * v);  // weight of word 4v
    a += w.x + w.y + w.z + w.w;
    b += wt * w.x + (wt - 1u) * w.y + (wt - 2u) * w.z + (wt - 3u) * w.w;
  }
  __shared__ uint32_t sa[kWarps], sb[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp != 0) return;
  a = warp_sum(lane < kWarps ? sa[lane] : 0u);
  b = warp_sum(lane < kWarps ? sb[lane] : 0u);
  if (lane != 0) return;
  terms[2 * page] = a;
  terms[2 * page + 1] = b;
  if constexpr (DIGEST) {
    const int64_t rank = page / pages_per_rank;
    const uint32_t local = static_cast<uint32_t>(page - rank * pages_per_rank);
    const uint32_t after =
        (static_cast<uint32_t>(pages_per_rank) - 1u - local) *
        static_cast<uint32_t>(bw);
    atomicAdd(&digest[2 * rank], a);
    atomicAdd(&digest[2 * rank + 1], b + after * a);
  }
}

}  // namespace

// x: (n_pages, bw) u32, bw % 4 == 0, 16-byte aligned; terms: (n_pages, 2);
// digest: (n_pages / pages_per_rank, 2), zeroed by the caller (DIGEST only).
// Returns the cudaError_t of the launch.
extern "C" int fletcher_pages_launch(const void* x, void* terms, void* digest,
                                     long long n_pages, int bw,
                                     int pages_per_rank, int with_digest,
                                     void* stream) {
  if (n_pages == 0) return 0;
  const dim3 grid(static_cast<unsigned>(n_pages));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* xp = static_cast<const uint32_t*>(x);
  uint32_t* tp = static_cast<uint32_t*>(terms);
  uint32_t* dp = static_cast<uint32_t*>(digest);
  if (with_digest)
    fletcher_pages<true><<<grid, kThreads, 0, s>>>(xp, tp, dp, bw,
                                                   pages_per_rank);
  else
    fletcher_pages<false><<<grid, kThreads, 0, s>>>(xp, tp, dp, bw,
                                                    pages_per_rank);
  return static_cast<int>(cudaGetLastError());
}
