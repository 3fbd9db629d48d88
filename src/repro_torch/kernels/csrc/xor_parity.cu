// xor_words: out = a ^ b over n u32 words, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/xor_parity.py:41  _xor2 (_xor2_kernel, :25), behind
//                                       xor_delta (:54) and xor_accum (:60)
// One element-wise body serves both entry points, as `_xor2` does: the
// parity patch delta = old ^ new, and its application parity ^ patch.
//
// Bound: memory bytes — two reads and one write a word, one integer op.
// Design: a grid-stride loop of 16-byte uint4 loads and stores (coalesced,
// 16 B a thread), with the n % 4 tail words done one a thread after it.
// A pointer that is not 16-byte aligned (a tensor that starts inside an
// allocation, e.g. a slice) takes a scalar grid-stride loop instead, so any
// contiguous int32 tensor is taken.  The TPU kernel's (rows, 1024) tiling
// has no counterpart: the words are one flat range.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;   // 16 blocks an SM on the H100

__global__ void __launch_bounds__(kThreads)
xor_words(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
          uint32_t* __restrict__ out, int64_t n) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const bool aligned = ((reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  int64_t done = 0;                     // words covered by the uint4 loop
  if (aligned) {
    const int64_t n4 = n / 4;
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    const uint4* b4 = reinterpret_cast<const uint4*>(b);
    uint4* o4 = reinterpret_cast<uint4*>(out);
    for (int64_t v = tid; v < n4; v += stride) {
      const uint4 x = a4[v];
      const uint4 y = b4[v];
      o4[v] = make_uint4(x.x ^ y.x, x.y ^ y.y, x.z ^ y.z, x.w ^ y.w);
    }
    done = 4 * n4;
  }
  for (int64_t i = done + tid; i < n; i += stride) out[i] = a[i] ^ b[i];
}

}  // namespace

// a, b, out: n u32 words each, contiguous (any alignment).  Returns the
// cudaError_t of the launch.
extern "C" int xor_words_launch(const void* a, const void* b, void* out,
                                long long n, void* stream) {
  if (n == 0) return 0;
  const long long per_block = 4LL * kThreads;
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  xor_words<<<static_cast<unsigned>(blocks), kThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), static_cast<int64_t>(n));
  return static_cast<int>(cudaGetLastError());
}
