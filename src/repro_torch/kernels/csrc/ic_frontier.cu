// ic_frontier_step: one probabilistic reverse-BFS step of the dense IC
// sampler, new = (rand < -expm1(frontier @ logq)) & ~visited, as a (B, n)
// uint8 block.  Replaces the TPU kernel src/repro/kernels/ic_frontier.py:
// ic_frontier_step (_kernel), written from the math, not block by block.
//
// Contract: for each output (b, u), acc = sum_v frontier[b, v] * logq[v, u]
// in float32, in ascending v, one term at a time, from +0.0.  frontier is
// 0/1, so fmaf(f, q, acc) is acc + q or acc exactly; a zero term leaves acc
// unchanged bit for bit, which is why a v-tile whose frontier block is all
// zero is skipped without reading logq.  Epilogue: p = (float)(-expm1(
// (double)acc)), new = rand < p && !visited.  The plain PyTorch version
// (kernels/ic_frontier.py) sums logq's nonzeros in the same order and
// shares the epilogue, so the two agree bitwise.
//
// Bound on an H100: bytes, 4 n^2 + 7 B n (logq read once) at 3.35 TB/s;
// the useful adds, one per frontier entry and nonzero of logq's row, are
// far fewer on a sparse graph.  Design: one block of 256 threads per 32-row x
// 128-column output tile (row tiles vary fastest, so the blocks that read
// one logq column strip run together and share it in L2).  Each v-tile of
// 32 stages the block's 32 x 32 frontier bytes as floats and, unless they
// are all zero, the 32 x 128 logq tile in shared memory; a thread owns
// 4 rows x 4 columns (rows warp + 8i, columns lane + 32j), so the
// frontier reads are warp broadcasts and the logq reads conflict-free.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTb = 32;    // output rows per block
constexpr int kTn = 128;   // output columns per block
constexpr int kTk = 32;    // v per shared-memory stage
constexpr int kRows = kTb / (kThreads / 32);   // 4 rows a thread
constexpr int kCols = kTn / 32;                // 4 columns a thread

__global__ void __launch_bounds__(kThreads)
ic_frontier_kernel(const uint8_t* __restrict__ frontier, int64_t ld_f,
                   const uint8_t* __restrict__ visited, int64_t ld_v,
                   const float* __restrict__ logq,
                   const float* __restrict__ rand, int64_t ld_r,
                   uint8_t* __restrict__ out, int64_t ld_o, int B, int n) {
  __shared__ float f_s[kTb][kTk];
  __shared__ float q_s[kTk][kTn];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kTb, col0 = blockIdx.y * kTn;

  float acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < n; k0 += kTk) {
    int any = 0;
    for (int e = threadIdx.x; e < kTb * kTk; e += kThreads) {
      const int r = e / kTk, k = e % kTk;
      const int gr = row0 + r, gk = k0 + k;
      const uint8_t f =
          (gr < B && gk < n) ? frontier[(int64_t)gr * ld_f + gk] : 0;
      f_s[r][k] = f ? 1.0f : 0.0f;
      any |= f;
    }
    // every thread sees the same answer, so the whole block skips together
    if (!__syncthreads_or(any)) continue;
    for (int e = threadIdx.x; e < kTk * kTn; e += kThreads) {
      const int k = e / kTn, c = e % kTn;
      const int gk = k0 + k, gc = col0 + c;
      q_s[k][c] = (gk < n && gc < n) ? __ldg(logq + (int64_t)gk * n + gc)
                                     : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kTk; ++k) {
      float q[kCols], f[kRows];
#pragma unroll
      for (int j = 0; j < kCols; ++j) q[j] = q_s[k][lane + 32 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i) f[i] = f_s[warp + 8 * i][k];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          acc[i][j] = fmaf(f[i], q[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = row0 + warp + 8 * i;
    if (r >= B) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = col0 + lane + 32 * j;
      if (c >= n) continue;
      const float p = (float)(-expm1((double)acc[i][j]));
      const bool fire = rand[(int64_t)r * ld_r + c] < p;
      out[(int64_t)r * ld_o + c] =
          (fire && visited[(int64_t)r * ld_v + c] == 0) ? 1 : 0;
    }
  }
}

}  // namespace

extern "C" int repro_ic_frontier_step(const void* frontier, long long ld_f,
                                      const void* visited, long long ld_v,
                                      const void* logq, const void* rand,
                                      long long ld_r, void* out,
                                      long long ld_o, int batch, int n,
                                      void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const dim3 grid((unsigned)((batch + kTb - 1) / kTb),
                  (unsigned)((n + kTn - 1) / kTn));
  ic_frontier_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)frontier, (int64_t)ld_f, (const uint8_t*)visited,
      (int64_t)ld_v, (const float*)logq, (const float*)rand, (int64_t)ld_r,
      (uint8_t*)out, (int64_t)ld_o, batch, n);
  return (int)cudaGetLastError();
}
