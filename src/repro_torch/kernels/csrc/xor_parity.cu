// xor_words: out = a ^ b over n u32 words, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/xor_parity.py:41  _xor2 (_xor2_kernel, :25), behind
//                                       xor_delta (:54) and xor_accum (:60)
// One element-wise body serves both entry points, as `_xor2` does: the
// parity patch delta = old ^ new, and its application parity ^ patch.
//
// Bound: memory bytes — two reads and one write a word, one integer op,
// no reuse (3,194,880,000 B at the main path's (100, 1, 2600, 1024), 0.954
// ms at 3.35 TB/s).  Shared memory, TMA or tensor cores buy nothing; what
// counts is how many bytes are in flight and how little sits around them.
// Design (each choice timed against its alternatives on the H100 by
// scripts/torch_kernel_variants.py and scripts/torch_xor_cost.py; PERF.md
// §6):
//   * xor_vec: one uint4 of each operand a thread (2 and 4 in flight ran
//     no faster), loads through the read-only path (__ldg), ordinary
//     stores — the evict-first hints (__ldcs / __stcs) ran 2-3% slower;
//   * one pass of exact-sized blocks (kSpan4 uint4 each), as PyTorch sizes
//     its element-wise grids: a grid of the resident blocks striding over
//     the run ran 5% slower at the main shape;
//   * the alignment test is the launcher's, once: xor_vec only ever sees
//     three 16-byte aligned pointers, and does the n % 4 tail words in its
//     last block; any other run (a slice that starts off a 16-byte
//     boundary) takes xor_scalar, one word a thread a trip.
// The TPU kernel's (rows, 1024) tiling has no counterpart: the words are
// one flat range.
#include <cstdint>
#include <cuda_runtime.h>

#include "pages.cuh"

namespace {

using pages::kThreads;
using pages::resident_blocks;
constexpr int kUnroll = 1;                   // uint4 a thread a trip
constexpr int64_t kSpan4 = kThreads * kUnroll;   // uint4 a block a trip

__device__ __forceinline__ uint4 xor4(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

__device__ __forceinline__ uint4 load(const uint4* p) { return __ldg(p); }

__device__ __forceinline__ void store(uint4* p, uint4 v) { *p = v; }

// a, b, out 16-byte aligned; n4 = n / 4 uint4, then n % 4 tail words.
__global__ void __launch_bounds__(kThreads)
xor_vec(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
        uint32_t* __restrict__ out, int64_t n) {
  const int64_t n4 = n >> 2;
  const uint4* a4 = reinterpret_cast<const uint4*>(a);
  const uint4* b4 = reinterpret_cast<const uint4*>(b);
  uint4* o4 = reinterpret_cast<uint4*>(out);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kSpan4;
  for (int64_t v = blockIdx.x * kSpan4 + threadIdx.x; v < n4; v += stride) {
    uint4 x[kUnroll], y[kUnroll];
    if (v + (kUnroll - 1) * kThreads < n4) {         // a whole trip
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        x[u] = load(a4 + v + u * kThreads);
        y[u] = load(b4 + v + u * kThreads);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        store(o4 + v + u * kThreads, xor4(x[u], y[u]));
    } else {                                         // the ragged last trip
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t j = v + u * kThreads;
        if (j < n4) store(o4 + j, xor4(load(a4 + j), load(b4 + j)));
      }
    }
  }
  const int64_t tail = 4 * n4 + threadIdx.x;
  if (blockIdx.x == gridDim.x - 1 && tail < n) out[tail] = a[tail] ^ b[tail];
}

// Any alignment: one word a thread a trip.
__global__ void __launch_bounds__(kThreads)
xor_scalar(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
           uint32_t* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
       i < n; i += stride)
    out[i] = a[i] ^ b[i];
}

}  // namespace

// a, b, out: n u32 words each, contiguous (any 4-byte alignment).
// Returns the cudaError_t of the launch.
extern "C" int xor_words_launch(const void* a, const void* b, void* out,
                                long long n, void* stream) {
  if (n == 0) return 0;
  const auto* pa = static_cast<const uint32_t*>(a);
  const auto* pb = static_cast<const uint32_t*>(b);
  auto* po = static_cast<uint32_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = ((reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (aligned) {
    long long blocks = (n / 4 + kSpan4 - 1) / kSpan4;
    if (blocks == 0) blocks = 1;                     // n < 4: the tail only
    xor_vec<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(pa, pb, po,
                                                               n);
  } else {
    static const int resident = resident_blocks(
        reinterpret_cast<const void*>(xor_scalar));
    long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > resident) blocks = resident;
    xor_scalar<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(pa, pb, po,
                                                                  n);
  }
  return static_cast<int>(cudaGetLastError());
}
