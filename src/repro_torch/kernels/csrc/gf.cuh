// GF(2^32) multiply on the card, as core/gf.py defines the field: GF(2)[x]
// modulo x^32 + x^22 + x^2 + x + 1 (POLY = 0x400007), generator g = x.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace gf {

constexpr uint32_t kPoly = 0x400007u;

// y = c·x: 32 branch-free steps of shift-and-conditional-XOR, bit-identical
// to core/gf.py's mul_int lane for lane.  Step i adds x·g^i when bit i of c
// is set; cur >> 31 is a logical shift on uint32_t, so it is 0 or 1.
__device__ __forceinline__ uint32_t gf_mul(uint32_t x, uint32_t c) {
  uint32_t acc = 0u, cur = x;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    acc ^= cur & (0u - ((c >> i) & 1u));
    cur = (cur << 1) ^ ((cur >> 31) * kPoly);
  }
  return acc;
}

// gf_mul of four words by one coefficient (after unrolling, the compiler
// forms each step's bit mask of c once for the four lanes).
__device__ __forceinline__ uint4 gf_mul4(uint4 x, uint32_t c) {
  return make_uint4(gf_mul(x.x, c), gf_mul(x.y, c), gf_mul(x.z, c),
                    gf_mul(x.w, c));
}

}  // namespace gf
