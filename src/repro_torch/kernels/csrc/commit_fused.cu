// commit_pages<MODE, DIGEST>: the fused commit sweep on Hopper (sm_90a).
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
// digest.  MODE says what the sweep writes beside the delta and the new
// page terms:
//   kCommit    nothing: fused_commit (fused_commit_stream with DIGEST);
//   kVerify    the verdict of each old page against its stored terms:
//              fused_verify_commit (fused_verify_commit_stream);
//   kOldTerms  the old page's raw terms, which the reference forms as the
//              verify sweep with stored = 0; no stored table is read:
//              fused_commit_old_terms (fused_commit_old_terms_stream);
//   kAccum     the deferred-epoch engine's accumulate sweep, which also
//              reads the epoch accumulator, writes acc ^ old ^ new in the
//              delta's place and the old page's raw terms:
//              fused_accum_commit (fused_accum_commit_stream).
//
// Function, per page p of bw u32 words (rank = p / n, local = p % n):
//   delta[p]  = old[p] ^ new[p]          (acc[p] ^ old[p] ^ new[p], kAccum)
//   terms[p]  = Fletcher (A, B) of new[p]
//   bad[p]    = Fletcher (A, B) of old[p] != stored[p]            (kVerify)
//   olds[p]   = Fletcher (A, B) of old[p]              (kOldTerms, kAccum)
//   digest[rank] += (A, B + (n - 1 - local) * bw * A) of new[p]   (DIGEST)
// bad is the reference's any(old terms ^ stored != 0) (commit_fused.py:130),
// one byte a page (a torch.bool).
//
// Bound: memory bytes — two page reads (three with kAccum) and one page
// write a page; the term tables are 1/512 of that at bw = 1024, the
// verdicts 1/8192, and the integer work ~7 ops a word (8 with kAccum) is
// far below the card's op rate.
// Design: page runs (pages.cuh), as fletcher_pages and syndrome_pages run:
// a CTA of kRunThreads threads takes kRunPages consecutive pages of one
// rank, a warp a page.  A lane loads kLaneUnroll uint4 of each input at
// once (a whole 1024-word page a warp in one trip), stores the delta as it
// is formed, the page's two or four sums reduce in the warp (REDUX), and
// its lane 0 writes the terms and the verdict or the old terms; with
// kVerify that lane loads the stored pair before the page, so the verdict
// waits on no load of its own.  With DIGEST the digest partials of the
// CTA's pages reach the rank's digest as one atomic pair a CTA.  Timed
// against runs of 4, 2 and 1 pages on as many warps, 16 pages on 8 and
// on 16 warps, and unrolls of 4 and 2 (scripts/torch_kernel_variants.py,
// PERF.md §6): at the 16-page patch's 1,600 pages none was faster than the
// readings' spread (1%; every page's loads are in flight at once whatever
// the run, and the launch and the first loads' latency take the time
// above the bound), at the main path's 260,000 the shorter runs tied and
// the smaller unrolls lost 1%, and runs of one page paid 0.07-0.18 ms for
// their digest atomics.  It replaced one CTA of 256 threads a page (a
// uint4 a thread, a CTA-wide reduction behind a barrier, a digest atomic
// pair a page, and the verdict and the zero stored table as launches of
// their own in the wrapper).
#include <cstdint>
#include <cuda_runtime.h>

#include "pages.cuh"

namespace {

using pages::fletcher_add;
using pages::kLaneUnroll;
using pages::kRunThreads;
using pages::kRunWarps;

enum Mode : int { kCommit = 0, kVerify = 1, kOldTerms = 2, kAccum = 3 };

__device__ __forceinline__ uint4 xor4(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

// A CTA takes a run of a rank's pages.  side: bad (u8 a page, kVerify) or
// the old terms ((pages, 2), kOldTerms, kAccum).
template <int MODE, bool DIGEST>
__global__ void __launch_bounds__(kRunThreads)
commit_pages(const uint32_t* __restrict__ old_w,
             const uint32_t* __restrict__ new_w,
             const uint32_t* __restrict__ stored,
             const uint32_t* __restrict__ acc, uint32_t* __restrict__ delta,
             uint32_t* __restrict__ terms, void* __restrict__ side,
             uint32_t* __restrict__ digest, int bw, int n, int runs) {
  constexpr bool ACC = MODE == kAccum;
  constexpr bool OLD = MODE != kCommit;      // the old page's sums are kept
  const pages::PageRun run = pages::page_run(n, runs);
  const int lane = threadIdx.x & 31, q = bw / 4;   // q: uint4 a page
  uint32_t da = 0, db = 0;                         // this warp's digest part
  for (int local = run.first + (threadIdx.x >> 5); local < run.last;
       local += kRunWarps) {
    const int64_t page = run.rank * n + local;
    uint32_t want_a = 0, want_b = 0;
    if constexpr (MODE == kVerify) {
      if (lane == 0) {
        want_a = stored[2 * page];
        want_b = stored[2 * page + 1];
      }
    }
    const uint4* po = reinterpret_cast<const uint4*>(old_w) + page * q;
    const uint4* pn = reinterpret_cast<const uint4*>(new_w) + page * q;
    const uint4* pa = ACC ? reinterpret_cast<const uint4*>(acc) + page * q
                          : nullptr;
    uint4* pd = reinterpret_cast<uint4*>(delta) + page * q;
    // s[0], s[1]: the new page's (A, B); s[2], s[3]: the old page's
    uint32_t s[OLD ? 4 : 2] = {};
    for (int v0 = lane; v0 < q; v0 += 32 * kLaneUnroll) {
      uint4 o[kLaneUnroll], w[kLaneUnroll], a[ACC ? kLaneUnroll : 1];
#pragma unroll
      for (int u = 0; u < kLaneUnroll; ++u) {
        if (v0 + 32 * u >= q) continue;
        o[u] = po[v0 + 32 * u];
        w[u] = pn[v0 + 32 * u];
        if constexpr (ACC) a[u] = pa[v0 + 32 * u];
      }
#pragma unroll
      for (int u = 0; u < kLaneUnroll; ++u) {
        const int v = v0 + 32 * u;
        if (v >= q) continue;
        uint4 d = xor4(o[u], w[u]);
        if constexpr (ACC) d = xor4(d, a[u]);
        pd[v] = d;
        const uint32_t wt = static_cast<uint32_t>(bw - 4 * v);
        fletcher_add(w[u], wt, s[0], s[1]);
        if constexpr (OLD) fletcher_add(o[u], wt, s[2], s[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < (OLD ? 4 : 2); ++i)
      s[i] = __reduce_add_sync(0xffffffffu, s[i]);
    if (lane != 0) continue;
    terms[2 * page] = s[0];
    terms[2 * page + 1] = s[1];
    if constexpr (MODE == kVerify)
      static_cast<uint8_t*>(side)[page] = (s[2] != want_a) | (s[3] != want_b);
    if constexpr (MODE == kOldTerms || ACC) {
      static_cast<uint32_t*>(side)[2 * page] = s[2];
      static_cast<uint32_t*>(side)[2 * page + 1] = s[3];
    }
    if constexpr (DIGEST) {
      da += s[0];
      db += pages::digest_b(static_cast<uint32_t>(local),
                            static_cast<uint32_t>(n),
                            static_cast<uint32_t>(bw), s[0], s[1]);
    }
  }
  if constexpr (DIGEST) pages::run_digest_add(digest, run.rank, da, db);
}

template <int MODE, bool DIGEST>
void launch(dim3 grid, cudaStream_t st, const void* o, const void* n,
            const void* stored, const void* a, void* d, void* t, void* side,
            void* g, int bw, int ppr, int runs) {
  commit_pages<MODE, DIGEST><<<grid, kRunThreads, 0, st>>>(
      static_cast<const uint32_t*>(o), static_cast<const uint32_t*>(n),
      static_cast<const uint32_t*>(stored), static_cast<const uint32_t*>(a),
      static_cast<uint32_t*>(d), static_cast<uint32_t*>(t), side,
      static_cast<uint32_t*>(g), bw, ppr, runs);
}

}  // namespace

// old/new/delta (and acc, kAccum only): (n_pages, bw) u32, bw % 4 == 0,
// 16-byte aligned, n_pages a multiple of pages_per_rank; terms:
// (n_pages, 2); stored: (n_pages, 2) (kVerify only); side: n_pages bytes
// (kVerify) or (n_pages, 2) u32 (kOldTerms, kAccum); digest:
// (n_pages / pages_per_rank, 2), zeroed by the caller (DIGEST only).
// mode: 0 commit, 1 verify, 2 old terms, 3 accumulate.  Returns the
// cudaError_t of the launch.
extern "C" int commit_pages_launch(const void* old_w, const void* new_w,
                                   const void* stored, const void* acc,
                                   void* delta, void* terms, void* side,
                                   void* digest, long long n_pages, int bw,
                                   int pages_per_rank, int mode,
                                   int with_digest, void* stream) {
  if (n_pages == 0) return 0;
  if (mode < kCommit || mode > kAccum)
    return static_cast<int>(cudaErrorInvalidValue);
  const int runs = pages::runs_per_rank(pages_per_rank);
  const dim3 grid(static_cast<unsigned>(n_pages / pages_per_rank * runs));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define COMMIT_PAGES(M, D)                                                   \
  launch<M, D>(grid, s, old_w, new_w, stored, acc, delta, terms, side,      \
               digest, bw, pages_per_rank, runs)
  switch (2 * mode + (with_digest ? 1 : 0)) {
    case 0: COMMIT_PAGES(kCommit, false); break;
    case 1: COMMIT_PAGES(kCommit, true); break;
    case 2: COMMIT_PAGES(kVerify, false); break;
    case 3: COMMIT_PAGES(kVerify, true); break;
    case 4: COMMIT_PAGES(kOldTerms, false); break;
    case 5: COMMIT_PAGES(kOldTerms, true); break;
    case 6: COMMIT_PAGES(kAccum, false); break;
    default: COMMIT_PAGES(kAccum, true); break;
  }
#undef COMMIT_PAGES
  return static_cast<int>(cudaGetLastError());
}
