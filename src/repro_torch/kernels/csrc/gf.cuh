// GF(2^32) multiply on the card, as core/gf.py defines the field: GF(2)[x]
// modulo x^32 + x^22 + x^2 + x + 1 (POLY = 0x400007), generator g = x.
//
// Two forms of y = c·x:
//   * gf_mul, 32 branch-free steps of shift-and-conditional-XOR: about
//     2 + (planes) ALU instructions a word a step once compiled, so a
//     sweep that ran it on every word was bound by the integer ALU, not by
//     its bytes (syndrome_pages until it took the table multiply: PERF.md
//     §6).  Only build_table runs it now, 128 times a coefficient a CTA.
//   * the table multiply.  c·x is linear in x over GF(2), so with x cut
//     into eight 4-bit chunks x_j (x = XOR_j x_j << 4j),
//         c·x = XOR_j T_j[x_j],   T_j[v] = c·(v << 4j),
//     one coefficient's eight 16-entry tables: kTableWords = 128 u32,
//     512 B of shared memory.  A word costs 8 lookups and 7 XORs a
//     coefficient, its 8 chunk offsets shared by every coefficient.  T_j
//     starts at a multiple of 16 words, so a warp's 32 lookups into one T_j
//     touch at most 16 words in 16 distinct banks (equal chunks broadcast):
//     one shared-memory wavefront whatever the data.  weight_words and
//     syndrome_pages run it.
//     (Byte tables — four of 256 entries, 4 KB a coefficient — halve the
//     lookups, but a warp's 32 random indices into 256 words meet 3-4 to
//     a bank: some 14 wavefronts a word against 8, and 8x the table to
//     build.)
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace gf {

constexpr uint32_t kPoly = 0x400007u;
constexpr int kChunks = 8;                   // 4-bit chunks of a word
constexpr int kTableWords = 16 * kChunks;    // one coefficient's tables

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

// Fill `table` (kTableWords words of shared memory) with c's tables,
// table[16 j + v] = c·(v << 4j), by the threads of the block, each entry
// with gf_mul.  The caller synchronises the block before the first lookup.
__device__ __forceinline__ void build_table(uint32_t c, uint32_t* table) {
  for (int e = threadIdx.x; e < kTableWords; e += blockDim.x)
    table[e] = gf_mul(static_cast<uint32_t>(e & 15) << (4 * (e >> 4)), c);
}

// c·x from c's tables in shared memory.  Each chunk's offset is taken as
// a byte offset, (x >> 4j) & 15 scaled by 4, in one shift and one AND.
__device__ __forceinline__ uint32_t table_mul(uint32_t x,
                                              const uint32_t* table) {
  const char* t = reinterpret_cast<const char*>(table);
  uint32_t acc = *reinterpret_cast<const uint32_t*>(t + ((x << 2) & 60u));
#pragma unroll
  for (int j = 1; j < kChunks; ++j)
    acc ^= *reinterpret_cast<const uint32_t*>(
        t + 64 * j + ((x >> (4 * j - 2)) & 60u));
  return acc;
}

__device__ __forceinline__ uint4 table_mul4(uint4 x, const uint32_t* table) {
  return make_uint4(table_mul(x.x, table), table_mul(x.y, table),
                    table_mul(x.z, table), table_mul(x.w, table));
}

}  // namespace gf
