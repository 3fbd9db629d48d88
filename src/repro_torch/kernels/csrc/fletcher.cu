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
// Design: page runs (pages.cuh) — a CTA of kRunThreads threads takes
// kRunPages consecutive pages of one rank, a warp a page; each lane loads
// kLaneUnroll uint4 of the page at once (a warp reads 512 B contiguously
// a load), accumulates in uint32 with natural wrap, and the warp reduces
// with REDUX.  The digest is summed over the CTA's pages and added into a
// zeroed (ranks, 2) table as one atomic pair a CTA: integer atomics are
// exact in any order, so it is deterministic.  (One CTA a page with an
// atomic pair a page ran twice as long as DIGEST=false: the CTAs at work
// cover a few hundred pages of one rank, so their atomics all meet on the
// same two words and serialise.)  One launch covers every rank's pages.
#include <cstdint>
#include <cuda_runtime.h>

#include "pages.cuh"

namespace {

using pages::kLaneUnroll;
using pages::kRunThreads;
using pages::kRunWarps;

template <bool DIGEST>
__global__ void __launch_bounds__(kRunThreads)
fletcher_pages(const uint32_t* __restrict__ x, uint32_t* __restrict__ terms,
               uint32_t* __restrict__ digest, int bw, int n, int runs) {
  const pages::PageRun run = pages::page_run(n, runs);
  const int lane = threadIdx.x & 31, q = bw / 4;   // q: uint4 a page
  uint32_t da = 0, db = 0;                         // this warp's digest part
  for (int local = run.first + (threadIdx.x >> 5); local < run.last;
       local += kRunWarps) {
    const int64_t page = run.rank * n + local;
    const uint4* p = reinterpret_cast<const uint4*>(x) + page * q;
    uint32_t a = 0, b = 0;
    for (int v0 = lane; v0 < q; v0 += 32 * kLaneUnroll) {
      uint4 w[kLaneUnroll];
#pragma unroll
      for (int u = 0; u < kLaneUnroll; ++u)
        if (v0 + 32 * u < q) w[u] = p[v0 + 32 * u];
#pragma unroll
      for (int u = 0; u < kLaneUnroll; ++u) {
        const int v = v0 + 32 * u;
        if (v < q) pages::fletcher_add(w[u], static_cast<uint32_t>(bw - 4 * v),
                                       a, b);
      }
    }
    a = __reduce_add_sync(0xffffffffu, a);
    b = __reduce_add_sync(0xffffffffu, b);
    if (lane != 0) continue;
    terms[2 * page] = a;
    terms[2 * page + 1] = b;
    if constexpr (DIGEST) {
      da += a;
      db += pages::digest_b(static_cast<uint32_t>(local),
                            static_cast<uint32_t>(n),
                            static_cast<uint32_t>(bw), a, b);
    }
  }
  if constexpr (DIGEST)
    pages::run_digest_add(digest, run.rank, da, db);
}

}  // namespace

// x: (n_pages, bw) u32, bw % 4 == 0, 16-byte aligned, n_pages a multiple
// of pages_per_rank; terms: (n_pages, 2); digest: (n_pages /
// pages_per_rank, 2), zeroed by the caller (DIGEST only).  Returns the
// cudaError_t of the launch.
extern "C" int fletcher_pages_launch(const void* x, void* terms, void* digest,
                                     long long n_pages, int bw,
                                     int pages_per_rank, int with_digest,
                                     void* stream) {
  if (n_pages == 0) return 0;
  const int runs = pages::runs_per_rank(pages_per_rank);
  const dim3 grid(static_cast<unsigned>(n_pages / pages_per_rank * runs));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* xp = static_cast<const uint32_t*>(x);
  uint32_t* tp = static_cast<uint32_t*>(terms);
  uint32_t* dp = static_cast<uint32_t*>(digest);
  if (with_digest)
    fletcher_pages<true><<<grid, kRunThreads, 0, s>>>(xp, tp, dp, bw,
                                                      pages_per_rank, runs);
  else
    fletcher_pages<false><<<grid, kRunThreads, 0, s>>>(xp, tp, dp, bw,
                                                       pages_per_rank, runs);
  return static_cast<int>(cudaGetLastError());
}
