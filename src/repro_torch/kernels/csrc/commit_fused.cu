// commit_pages<VERIFY, DIGEST, ACC>: the fused commit sweep on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/commit_fused.py:83   fused_commit (_fused_kernel, :49)
//   src/repro/kernels/commit_fused.py:103  _verify_call -> fused_verify_commit
//                                          :120, fused_commit_old_terms :134
//                                          (_fused_verify_kernel, :60)
//   src/repro/kernels/commit_fused.py:377  fused_commit_stream
//                                          (_stream_commit_kernel, :284)
//   src/repro/kernels/commit_fused.py:393  _verify_stream_call ->
//                                          fused_verify_commit_stream :406,
//                                          fused_commit_old_terms_stream :417
//                                          (_stream_verify_kernel, :307)
//   src/repro/kernels/commit_fused.py:185  fused_accum_commit (_accum_kernel,
//                                          :147)
//   src/repro/kernels/commit_fused.py:436  fused_accum_commit_stream
//                                          (_stream_accum_kernel, :334)
// Those entry points compute one function; the streamed forms only add the
// digest.  VERIFY=false is fused_commit (fused_commit_stream with DIGEST);
// VERIFY=true is fused_verify_commit (fused_verify_commit_stream with
// DIGEST), and with stored = 0, as the reference does,
// fused_commit_old_terms (fused_commit_old_terms_stream with DIGEST).
// ACC=true is the deferred-epoch engine's accumulate sweep,
// fused_accum_commit (fused_accum_commit_stream with DIGEST): it also reads
// the epoch accumulator, writes acc ^ old ^ new where the others write the
// delta, and writes the old page's raw terms where VERIFY writes
// old ^ stored (no stored table is read).
//
// Function, per page p of bw u32 words:
//   delta[p]  = old[p] ^ new[p]                 (acc[p] ^ old[p] ^ new[p], ACC)
//   terms[p]  = Fletcher (A, B) of new[p]
//   mism[p]   = Fletcher (A, B) of old[p] ^ stored[p]          (VERIFY)
//   mism[p]   = Fletcher (A, B) of old[p]                      (ACC)
//   digest[r] += (A, B + (n - 1 - local) * bw * A) of new[p]   (DIGEST)
// The verdict bad = any(mism != 0) stays outside the kernel, as in the
// reference (commit_fused.py:130).
//
// Bound: memory bytes — two page reads (three with ACC) and one page write
// per page (the term tables are 1/512 of that at bw = 1024); the integer
// work is ~7 ops a word (8 with ACC), far below the card's op rate.
// Design: one CTA of 256 threads per page, one uint4 of old and of new per
// thread (coalesced 16 B a thread), the delta stored as it is formed, the
// two or four Fletcher sums accumulated in uint32 with natural wrap and
// reduced with warp shuffles.  The per-rank digest is an exact integer
// atomicAdd into a zeroed (ranks, 2) table.  One launch covers every rank.
#include <cstdint>
#include <cuda_runtime.h>

#include "pages.cuh"

namespace {

using pages::block_sum;
using pages::fletcher_add;
using pages::kThreads;

template <bool VERIFY, bool DIGEST, bool ACC>
__global__ void __launch_bounds__(kThreads)
commit_pages(const uint32_t* __restrict__ old_w,
             const uint32_t* __restrict__ new_w,
             const uint32_t* __restrict__ stored,
             const uint32_t* __restrict__ acc, uint32_t* __restrict__ delta,
             uint32_t* __restrict__ terms, uint32_t* __restrict__ mism,
             uint32_t* __restrict__ digest, int bw, int pages_per_rank) {
  static_assert(!(VERIFY && ACC), "the accumulate sweep reads no stored");
  constexpr bool OLD = VERIFY || ACC;       // the old page's terms are kept
  const int64_t page = blockIdx.x;
  const uint4* po = reinterpret_cast<const uint4*>(old_w + page * bw);
  const uint4* pn = reinterpret_cast<const uint4*>(new_w + page * bw);
  const uint4* pa =
      ACC ? reinterpret_cast<const uint4*>(acc + page * bw) : nullptr;
  uint4* pd = reinterpret_cast<uint4*>(delta + page * bw);
  // s[0], s[1]: new page's (A, B); s[2], s[3]: old page's (VERIFY, ACC)
  uint32_t s[OLD ? 4 : 2] = {};
  for (int v = threadIdx.x; v < bw / 4; v += kThreads) {
    const uint4 o = po[v];
    const uint4 n = pn[v];
    uint4 d = make_uint4(o.x ^ n.x, o.y ^ n.y, o.z ^ n.z, o.w ^ n.w);
    if constexpr (ACC) {
      const uint4 a = pa[v];
      d = make_uint4(d.x ^ a.x, d.y ^ a.y, d.z ^ a.z, d.w ^ a.w);
    }
    pd[v] = d;
    const uint32_t wt = static_cast<uint32_t>(bw - 4 * v);
    fletcher_add(n, wt, s[0], s[1]);
    if constexpr (OLD) fletcher_add(o, wt, s[2], s[3]);
  }
  block_sum(s);
  if (threadIdx.x != 0) return;
  terms[2 * page] = s[0];
  terms[2 * page + 1] = s[1];
  if constexpr (VERIFY) {
    mism[2 * page] = s[2] ^ stored[2 * page];
    mism[2 * page + 1] = s[3] ^ stored[2 * page + 1];
  }
  if constexpr (ACC) {
    mism[2 * page] = s[2];
    mism[2 * page + 1] = s[3];
  }
  if constexpr (DIGEST) {
    const int64_t rank = page / pages_per_rank;
    pages::digest_add(digest, rank,
                      static_cast<uint32_t>(page - rank * pages_per_rank),
                      static_cast<uint32_t>(pages_per_rank),
                      static_cast<uint32_t>(bw), s[0], s[1]);
  }
}

template <bool VERIFY, bool DIGEST, bool ACC>
void launch(dim3 grid, cudaStream_t st, const void* o, const void* n,
            const void* stored, const void* a, void* d, void* t, void* m,
            void* g, int bw, int ppr) {
  commit_pages<VERIFY, DIGEST, ACC><<<grid, kThreads, 0, st>>>(
      static_cast<const uint32_t*>(o), static_cast<const uint32_t*>(n),
      static_cast<const uint32_t*>(stored), static_cast<const uint32_t*>(a),
      static_cast<uint32_t*>(d), static_cast<uint32_t*>(t),
      static_cast<uint32_t*>(m), static_cast<uint32_t*>(g), bw, ppr);
}

}  // namespace

// old/new/delta (and acc, ACC only): (n_pages, bw) u32, bw % 4 == 0,
// 16-byte aligned; terms: (n_pages, 2); stored: (n_pages, 2) (VERIFY only);
// mism: (n_pages, 2) (VERIFY or ACC); digest: (n_pages / pages_per_rank, 2),
// zeroed by the caller (DIGEST only).  verify and accum are not both set.
// Returns the cudaError_t of the launch.
extern "C" int commit_pages_launch(const void* old_w, const void* new_w,
                                   const void* stored, const void* acc,
                                   void* delta, void* terms, void* mism,
                                   void* digest, long long n_pages, int bw,
                                   int pages_per_rank, int verify,
                                   int accum, int with_digest, void* stream) {
  if (n_pages == 0) return 0;
  if (verify && accum) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n_pages));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define COMMIT_PAGES(V, D, A)                                              \
  launch<V, D, A>(grid, s, old_w, new_w, stored, acc, delta, terms, mism, \
                  digest, bw, pages_per_rank)
  if (accum && with_digest)
    COMMIT_PAGES(false, true, true);
  else if (accum)
    COMMIT_PAGES(false, false, true);
  else if (verify && with_digest)
    COMMIT_PAGES(true, true, false);
  else if (verify)
    COMMIT_PAGES(true, false, false);
  else if (with_digest)
    COMMIT_PAGES(false, true, false);
  else
    COMMIT_PAGES(false, false, false);
#undef COMMIT_PAGES
  return static_cast<int>(cudaGetLastError());
}
