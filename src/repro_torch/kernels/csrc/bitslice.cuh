// Bit-sliced vertical counters over 32-bit words of packed bits, shared
// by packed_count.cu and token_count.cu.
//
// A thread keeps, for one 32-bit word of packed columns (column j of the
// word is bit j, LSB-first), kPlanes bit planes P[0..kPlanes): the count
// of column j is sum_q bit_j(P[q]) << q.  add8 adds eight rows' words
// with a Harley-Seal carry-save tree: seven full adders (sum = a^b^c and
// carry = maj(a, b, c), one LOP3 each) fold the rows into the ones, twos
// and fours planes and give one word of eights, which ripples into the
// higher planes (two LOP3 a plane).  That is 14 + 2 * (kPlanes - 3) = 24
// logic instructions for 8 rows of 32 columns, against ~40 a word a row
// for byte-lane arithmetic.  The planes hold counts up to 2^kPlanes - 1,
// so a caller expands them (`expand`) into int32 counts at least every
// kMaxSteps calls of add8.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kPlanes = 8;
constexpr int kStepRows = 8;
constexpr int kMaxSteps = ((1 << kPlanes) - 1) / kStepRows;   // 31
static_assert(kPlanes <= 8, "expand keeps a column's count in a byte lane");

// full adder on 32 lanes: lo = a ^ b ^ c, hi = maj(a, b, c)
__device__ __forceinline__ void csa(uint32_t& hi, uint32_t& lo, uint32_t a,
                                    uint32_t b, uint32_t c) {
  const uint32_t u = a ^ b;
  lo = u ^ c;
  hi = (a & b) | (u & c);
}

// P += the eight words x[0..8), column by column
__device__ __forceinline__ void add8(uint32_t P[kPlanes],
                                     const uint32_t x[kStepRows]) {
  uint32_t twos_a, twos_b, fours_a, fours_b, eights;
  csa(twos_a, P[0], P[0], x[0], x[1]);
  csa(twos_b, P[0], P[0], x[2], x[3]);
  csa(fours_a, P[1], P[1], twos_a, twos_b);
  csa(twos_a, P[0], P[0], x[4], x[5]);
  csa(twos_b, P[0], P[0], x[6], x[7]);
  csa(fours_b, P[1], P[1], twos_a, twos_b);
  csa(eights, P[2], P[2], fours_a, fours_b);
#pragma unroll
  for (int q = 3; q < kPlanes; ++q) {
    const uint32_t carry = P[q] & eights;
    P[q] ^= eights;
    eights = carry;
  }
}

// Hand column j of the word (count sum_q bit_j(P[q]) << q) to
// emit(j, count) for every column whose count is not zero, then clear
// the planes.  Eight shifts and masks gather bit j, j + 8, j + 16 and
// j + 24 of every plane into the byte lanes of one word, so four columns
// come out together.
template <typename Emit>
__device__ __forceinline__ void expand(uint32_t P[kPlanes], Emit emit) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t v = 0;
#pragma unroll
    for (int q = 0; q < kPlanes; ++q)
      v |= ((P[q] >> j) & 0x01010101u) << q;
    if (v) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = (v >> (8 * i)) & 0xFF;
        if (c) emit(8 * i + j, c);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kPlanes; ++q) P[q] = 0;
}

}  // namespace repro_torch
