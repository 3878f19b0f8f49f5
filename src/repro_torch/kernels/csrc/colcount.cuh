// Column counts over a uint8 bitmap arena, shared by coverage_matvec.cu
// and fused_select.cu.
//
// A block is kColThreads x kRowGroups threads and owns a tile of
// kTileCols = 512 columns.  Each thread owns 16 consecutive columns and
// reads them with one 16-byte load per row; the kRowGroups warps of the
// block stride over the rows, so one row's 512 bytes come from one warp
// in four full 128-byte lines.  Rows whose alive flag is 0 are not read
// at all, so later greedy rounds move fewer bytes.
//
// Bitmap bytes are 0 or 1, so the 16 column counts of a thread live as
// byte lanes of four 32-bit words: one add per word counts four columns.
// A lane holds at most 255, so the words drain into int32 counters every
// kDrainEvery rows.  Bytes past column n (the row padding) are masked to
// zero and never reach a count.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kColThreads = 32;
constexpr int kRowGroups = 8;
constexpr int kColsPerThread = 16;
constexpr int kTileCols = kColThreads * kColsPerThread;
constexpr int kUnroll = 4;
constexpr int kDrainEvery = 252;   // a multiple of kUnroll, at most 255
static_assert(kDrainEvery % kUnroll == 0 && kDrainEvery <= 255, "lanes");

// 0x01 in each byte lane whose column is < n, 0x00 past the edge.
__device__ __forceinline__ uint4 low_bit_mask(int64_t c0, int n) {
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t m = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (c0 + 4 * q + b < n) m |= 1u << (8 * b);
    w[q] = m;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void drain(uint4& w, int acc[kColsPerThread]) {
  const uint32_t v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[4 * q + b] += (v[q] >> (8 * b)) & 0xFFu;
  w = make_uint4(0u, 0u, 0u, 0u);
}

// acc[j] = sum of R[t, c0 + j] over rows t = row0, row0 + step, ... < theta
// with alive[t] != 0.  R rows are 16-byte aligned with stride ld.
__device__ __forceinline__ void column_counts(
    const uint8_t* __restrict__ R, int64_t ld,
    const uint8_t* __restrict__ alive, int theta, int row0, int step,
    int64_t c0, int n, int acc[kColsPerThread]) {
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) acc[j] = 0;
  if (c0 >= n) return;
  const uint4 m = low_bit_mask(c0, n);
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  int since = 0;
  for (int t = row0; t < theta; t += step * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int tt = t + u * step;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (tt < theta && alive[tt])
        v[u] = __ldg(reinterpret_cast<const uint4*>(R + (int64_t)tt * ld + c0));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      w.x += v[u].x & m.x;
      w.y += v[u].y & m.y;
      w.z += v[u].z & m.z;
      w.w += v[u].w & m.w;
    }
    since += kUnroll;
    if (since == kDrainEvery) {
      drain(w, acc);
      since = 0;
    }
  }
  drain(w, acc);
}

// Sum the kRowGroups partial counts of each column through shared memory;
// the totals of this thread's 16 columns land in the threads of warp 0
// (threadIdx.y == 0).  Layout part[g][j][lane] keeps the stores and
// loads free of bank conflicts.
__device__ __forceinline__ void reduce_row_groups(
    int acc[kColsPerThread],
    int (*part)[kColsPerThread][kColThreads]) {
  const int lane = threadIdx.x, g = threadIdx.y;
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) part[g][j][lane] = acc[j];
  __syncthreads();
  if (g != 0) return;
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) {
    int s = 0;
#pragma unroll
    for (int q = 0; q < kRowGroups; ++q) s += part[q][j][lane];
    acc[j] = s;
  }
}

}  // namespace repro_torch
