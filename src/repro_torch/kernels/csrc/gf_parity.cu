// The GF(2^32)-weighted syndrome sweeps on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/gf_parity.py:
//   :83   gf_scale (_gf_scale_kernel, :68)             -> weight_words<1, false>
//   :151  _s_call -> fused_commit_s :162, fused_verify_commit_s :171,
//         fused_commit_old_terms_s :184 (_make_s_kernel, :107)
//                                                    -> syndrome_pages<R, V, false>
//   :224  sdelta_stack :206 (_make_sdelta_stack_kernel, :196)
//                                                    -> weight_words<R, true>
//   :311  _s_stream_call -> fused_commit_s_stream :321,
//         fused_verify_commit_s_stream :331 (_make_stream_s_kernel, :245)
//                                                    -> syndrome_pages<R, V, true>
//
// Function.  A rank's syndrome delta plane k is c_k · (old ^ new) in
// GF(2^32), with the rank's coefficients c_k = g^(k·rank) from a (ranks, R)
// table; c_0 = g^0 = 1, so plane 0 is the raw delta, written without a
// multiply.  syndrome_pages, per page p of bw u32 words (rank = p / n,
// local = p % n):
//   sdelta[rank, k, local]  = c_k · (old[p] ^ new[p])              k < R
//   terms[p]  = Fletcher (A, B) of new[p]
//   mism[p]   = Fletcher (A, B) of old[p] ^ stored[p]                (VERIFY)
//   digest[rank] += (A, B + (n - 1 - local) * bw * A) of new[p]      (DIGEST)
// with sdelta laid out (ranks, R, n, bw), plane-major within each rank, so
// a rank's planes view as (R, n * bw) rows for the bulk syndrome update and
// as (R, n, bw) pages for the patch.  fused_commit_old_terms_s is the VERIFY
// instance with stored = 0.  weight_words, element-wise over (L, m) words:
//   out[l, k] = c[l, k] · x[l]         (plane 0 raw when RAW0: sdelta_stack)
//   out[0, 0] = c · x                  (one scalar, R = 1: gf_scale)
//
// Bound: both functions are bound by their bytes (5 words of traffic a
// word for the r = 3 fused sweep, 1 + R for weight_words).  Both run the
// table multiply (gf.cuh): 8 conflict-free shared-memory lookups a word a
// weighted plane.  At r = 3 over 266,240,000 words that is 4.26e9 lookups,
// 0.51 ms at 32 lanes an SM a clock (132 SMs, 1.98 GHz), under the bytes'
// 1.27-1.59 ms.  A CTA builds its rank's tables (W x 512 B, 128 entries
// each by gf_mul) before its first lookup.
//   * syndrome_pages: page runs (pages.cuh) — a CTA of kRunThreads
//     threads takes kRunPages consecutive pages of one rank, so it builds
//     the tables once for them, a warp a page; each lane loads kLaneUnroll
//     uint4 of old and of new at once, forms the delta and each weighted
//     plane in registers and stores each as it is formed (old and new are
//     read once whatever R, the planes written plane-major), the Fletcher
//     sums reduced in the warp with REDUX.  The digest partials of the
//     CTA's pages are summed in the CTA and added as one atomic pair a CTA
//     (an atomic pair a page serialises: the CTAs at work share a rank).
//     It replaced one CTA a page on the 32-step gf_mul, bound by the
//     integer ALU at 2.2-4.1x the bytes (PERF.md §6).
//   * weight_words: one pass of exact-sized blocks, each a contiguous share
//     of 4096 words of the (rank, uint4) range; a block builds its rank's
//     tables and rebuilds them only where its share crosses into the next
//     rank; 2 uint4 a thread a trip, the next trip's loads issued before
//     this trip's lookups, plane 0 stored raw.  Timed against one wave of
//     long-lived blocks (a third slower: at any moment they stream from as
//     many places as there are blocks), other unrolls and shares, and a
//     probe with the lookups taken out, the same traffic's ceiling, which
//     it comes within 1% of (scripts/torch_kernel_variants.py; PERF.md §6).
#include <cstdint>
#include <cuda_runtime.h>

#include "gf.cuh"
#include "pages.cuh"

namespace {

using pages::fletcher_add;
using pages::kLaneUnroll;
using pages::kRunThreads;
using pages::kRunWarps;
using pages::kThreads;

__device__ __forceinline__ uint4 xor4(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

// The rank's syndrome delta planes, new terms [, old terms ^ stored]
// [, digest] of a run of its pages.  coeffs: (ranks, R); plane k of page
// `local` starts at word (rank * R + k) * n * bw + local * bw.
template <int R, bool VERIFY, bool DIGEST>
__global__ void __launch_bounds__(kRunThreads)
syndrome_pages(const uint32_t* __restrict__ old_w,
               const uint32_t* __restrict__ new_w,
               const uint32_t* __restrict__ coeffs,
               const uint32_t* __restrict__ stored,
               uint32_t* __restrict__ sdelta, uint32_t* __restrict__ terms,
               uint32_t* __restrict__ mism, uint32_t* __restrict__ digest,
               int bw, int n, int runs) {
  constexpr int W = R - 1;                 // weighted planes (c_0 = 1)
  __shared__ uint32_t tab[W][gf::kTableWords];
  const pages::PageRun run = pages::page_run(n, runs);
#pragma unroll
  for (int k = 0; k < W; ++k)
    gf::build_table(coeffs[run.rank * R + 1 + k], tab[k]);
  __syncthreads();
  const int lane = threadIdx.x & 31, q = bw / 4;   // q: uint4 a page
  const int64_t plane4 = static_cast<int64_t>(n) * q;
  uint32_t da = 0, db = 0;                         // this warp's digest part
  for (int local = run.first + (threadIdx.x >> 5); local < run.last;
       local += kRunWarps) {
    const int64_t page = run.rank * n + local;
    const uint4* po = reinterpret_cast<const uint4*>(old_w) + page * q;
    const uint4* pn = reinterpret_cast<const uint4*>(new_w) + page * q;
    uint4* pd = reinterpret_cast<uint4*>(sdelta) + run.rank * R * plane4 +
                static_cast<int64_t>(local) * q;
    // s[0], s[1]: new page's (A, B); s[2], s[3]: old page's (VERIFY)
    uint32_t s[VERIFY ? 4 : 2] = {};
    for (int v0 = lane; v0 < q; v0 += 32 * kLaneUnroll) {
      uint4 o[kLaneUnroll], w[kLaneUnroll];
#pragma unroll
      for (int u = 0; u < kLaneUnroll; ++u) {
        if (v0 + 32 * u >= q) continue;
        o[u] = po[v0 + 32 * u];
        w[u] = pn[v0 + 32 * u];
      }
#pragma unroll
      for (int u = 0; u < kLaneUnroll; ++u) {
        const int v = v0 + 32 * u;
        if (v >= q) continue;
        const uint4 d = xor4(o[u], w[u]);
        pd[v] = d;
#pragma unroll
        for (int k = 0; k < W; ++k)
          pd[(k + 1) * plane4 + v] = gf::table_mul4(d, tab[k]);
        const uint32_t wt = static_cast<uint32_t>(bw - 4 * v);
        fletcher_add(w[u], wt, s[0], s[1]);
        if constexpr (VERIFY) fletcher_add(o[u], wt, s[2], s[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < (VERIFY ? 4 : 2); ++i)
      s[i] = __reduce_add_sync(0xffffffffu, s[i]);
    if (lane != 0) continue;
    terms[2 * page] = s[0];
    terms[2 * page + 1] = s[1];
    if constexpr (VERIFY) {
      mism[2 * page] = s[2] ^ stored[2 * page];
      mism[2 * page + 1] = s[3] ^ stored[2 * page + 1];
    }
    if constexpr (DIGEST) {
      da += s[0];
      db += pages::digest_b(static_cast<uint32_t>(local),
                            static_cast<uint32_t>(n),
                            static_cast<uint32_t>(bw), s[0], s[1]);
    }
  }
  if constexpr (DIGEST)
    pages::run_digest_add(digest, run.rank, da, db);
}

constexpr int kWordUnroll = 2;                        // uint4 a thread a trip
constexpr int64_t kWordSpan4 = kThreads * kWordUnroll;  // uint4 a block a trip
constexpr int64_t kShare4 = 2 * kWordSpan4;  // uint4 a block: 4096 words

// x[l]'s uint4 at v + u * kThreads (u < kWordUnroll), those below stop.
__device__ __forceinline__ void load_trip(const uint4* px, int64_t v,
                                          int64_t stop,
                                          uint4 (&w)[kWordUnroll]) {
#pragma unroll
  for (int u = 0; u < kWordUnroll; ++u)
    if (v + u * kThreads < stop) w[u] = px[v + u * kThreads];
}

// out[l, k] = c[l, k]·x[l] from one read of x.  The lead * m4 uint4 of x
// are cut into gridDim.x equal contiguous shares, one a block.  A block
// builds the tables of the W weighted coefficients of the rank its share
// starts in (shared memory, 512 B each), walks its part of that rank's
// uint4s, kWordUnroll a thread a trip with the next trip's loads issued
// before this trip's lookups, and rebuilds the tables where its share
// crosses into the next rank.  coeffs: (lead, R) table, or nullptr for
// `scalar` on every plane.
template <int R, bool RAW0>
__global__ void __launch_bounds__(kThreads)
weight_words(const uint32_t* __restrict__ x,
             const uint32_t* __restrict__ coeffs, uint32_t scalar,
             uint32_t* __restrict__ out, int64_t lead, int64_t m4) {
  constexpr int K0 = RAW0 ? 1 : 0;         // the first weighted plane
  constexpr int W = R - K0;                // weighted planes
  __shared__ uint32_t tab[W][gf::kTableWords];
  const int64_t total = lead * m4;
  const int64_t share = (total + gridDim.x - 1) / gridDim.x;
  const int64_t last = (blockIdx.x + 1) * share;
  const int64_t end = last < total ? last : total;
  for (int64_t pos = blockIdx.x * share; pos < end;) {
    const int64_t l = pos / m4;            // the same in every thread
    const int64_t stop = ((l + 1) * m4 < end ? (l + 1) * m4 : end) - l * m4;
#pragma unroll
    for (int k = 0; k < W; ++k)
      gf::build_table(coeffs != nullptr ? coeffs[l * R + K0 + k] : scalar,
                      tab[k]);
    __syncthreads();
    const uint4* px = reinterpret_cast<const uint4*>(x) + l * m4;
    uint4* po = reinterpret_cast<uint4*>(out) + l * R * m4;
    uint4 w[kWordUnroll], next[kWordUnroll];
    int64_t v = pos - l * m4 + threadIdx.x;
    load_trip(px, v, stop, w);
    for (; v < stop; v += kWordSpan4) {
      load_trip(px, v + kWordSpan4, stop, next);
#pragma unroll
      for (int u = 0; u < kWordUnroll; ++u) {
        const int64_t j = v + u * kThreads;
        if (j >= stop) continue;
        if constexpr (RAW0) po[j] = w[u];
#pragma unroll
        for (int k = 0; k < W; ++k)
          po[(K0 + k) * m4 + j] = gf::table_mul4(w[u], tab[k]);
      }
#pragma unroll
      for (int u = 0; u < kWordUnroll; ++u) w[u] = next[u];
    }
    __syncthreads();                       // before the next rank's tables
    pos = l * m4 + stop;
  }
}

struct PageArgs {
  const void *old_w, *new_w, *coeffs, *stored;
  void *sdelta, *terms, *mism, *digest;
  int bw, ppr, runs;
};

template <int R, bool VERIFY, bool DIGEST>
void launch_pages(dim3 grid, cudaStream_t st, const PageArgs& a) {
  syndrome_pages<R, VERIFY, DIGEST><<<grid, kRunThreads, 0, st>>>(
      static_cast<const uint32_t*>(a.old_w),
      static_cast<const uint32_t*>(a.new_w),
      static_cast<const uint32_t*>(a.coeffs),
      static_cast<const uint32_t*>(a.stored), static_cast<uint32_t*>(a.sdelta),
      static_cast<uint32_t*>(a.terms), static_cast<uint32_t*>(a.mism),
      static_cast<uint32_t*>(a.digest), a.bw, a.ppr, a.runs);
}

template <int R>
void launch_pages_r(dim3 grid, cudaStream_t st, const PageArgs& a, int verify,
                    int with_digest) {
  if (verify && with_digest)
    launch_pages<R, true, true>(grid, st, a);
  else if (verify)
    launch_pages<R, true, false>(grid, st, a);
  else if (with_digest)
    launch_pages<R, false, true>(grid, st, a);
  else
    launch_pages<R, false, false>(grid, st, a);
}

// One pass of exact-sized blocks, a share of kShare4 uint4 each (the last
// shorter), as PyTorch sizes its element-wise grids: the blocks at work at
// any moment cover one contiguous window of x and of each plane.
template <int R, bool RAW0>
void launch_words(cudaStream_t st, const void* x, const void* coeffs,
                  uint32_t scalar, void* out, int64_t lead, int64_t m4) {
  const int64_t blocks = (lead * m4 + kShare4 - 1) / kShare4;
  weight_words<R, RAW0><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(coeffs),
      scalar, static_cast<uint32_t*>(out), lead, m4);
}

}  // namespace

// old/new: (n_pages, bw) u32, bw % 4 == 0, 16-byte aligned, n_pages a
// multiple of pages_per_rank; coeffs: (n_pages / pages_per_rank, r);
// sdelta: (n_pages / pages_per_rank, r, pages_per_rank, bw); terms:
// (n_pages, 2); stored/mism: (n_pages, 2) (verify only); digest:
// (n_pages / pages_per_rank, 2), zeroed by the caller (with_digest only).
// r is 2, 3 or 4.  Returns the cudaError_t of the launch.
extern "C" int syndrome_pages_launch(const void* old_w, const void* new_w,
                                     const void* coeffs, const void* stored,
                                     void* sdelta, void* terms, void* mism,
                                     void* digest, long long n_pages, int bw,
                                     int pages_per_rank, int r, int verify,
                                     int with_digest, void* stream) {
  if (n_pages == 0) return 0;
  const int runs = pages::runs_per_rank(pages_per_rank);
  const dim3 grid(static_cast<unsigned>(n_pages / pages_per_rank * runs));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PageArgs a{old_w, new_w, coeffs, stored, sdelta, terms,
                   mism,  digest, bw,    pages_per_rank,  runs};
  switch (r) {
    case 2: launch_pages_r<2>(grid, s, a, verify, with_digest); break;
    case 3: launch_pages_r<3>(grid, s, a, verify, with_digest); break;
    case 4: launch_pages_r<4>(grid, s, a, verify, with_digest); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: (lead, m) u32, m % 4 == 0, 16-byte aligned; out: (lead, r, m).
// raw0 = 1 (sdelta_stack, r = 2..4): plane 0 is x, plane k is coeffs[l, k] · x.
// raw0 = 0 (gf_scale, r = 1): out = scalar · x; coeffs is unused.
// Returns the cudaError_t of the launch.
extern "C" int weight_words_launch(const void* x, const void* coeffs,
                                   unsigned scalar, void* out,
                                   long long lead, long long m, int r,
                                   int raw0, void* stream) {
  if (lead == 0 || m == 0) return 0;
  const int64_t m4 = m / 4;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!raw0 && r == 1)
    launch_words<1, false>(s, x, nullptr, scalar, out, lead, m4);
  else if (raw0 && r == 2)
    launch_words<2, true>(s, x, coeffs, 0u, out, lead, m4);
  else if (raw0 && r == 3)
    launch_words<3, true>(s, x, coeffs, 0u, out, lead, m4);
  else if (raw0 && r == 4)
    launch_words<4, true>(s, x, coeffs, 0u, out, lead, m4);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
