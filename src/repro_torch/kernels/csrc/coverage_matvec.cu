// coverage_matvec: counter[v] = sum_t alive[t] * R[t, v] over a
// (theta, n) uint8 bitmap arena, exact in int32 and returned as float32.
// Replaces the Pallas kernel src/repro/kernels/coverage_matvec.py
// (coverage_matvec).  Bound by bytes: it reads each alive row once
// (theta * n bytes with every row alive: 5.49 GB at theta = 16,384,
// n = 334,863).  One block per 512-column tile streams every row; the
// tile's counts meet in shared memory and are written once, so no
// partial counter reaches device memory and no atomics are needed.
#include "colcount.cuh"

using namespace repro_torch;

__global__ void __launch_bounds__(kColThreads * kRowGroups)
coverage_matvec_kernel(const uint8_t* __restrict__ R, int64_t ld,
                       const uint8_t* __restrict__ alive, int theta, int n,
                       float* __restrict__ out) {
  __shared__ int part[kRowGroups][kColsPerThread][kColThreads];
  const int64_t c0 =
      (int64_t)blockIdx.x * kTileCols + threadIdx.x * kColsPerThread;
  int acc[kColsPerThread];
  column_counts(R, ld, alive, theta, threadIdx.y, kRowGroups, c0, n, acc);
  reduce_row_groups(acc, part);
  if (threadIdx.y != 0) return;
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j)
    if (c0 + j < n) out[c0 + j] = (float)acc[j];
}

extern "C" int repro_coverage_matvec(const void* R, long long ld,
                                     const void* alive, int theta, int n,
                                     void* out, void* stream) {
  if (n <= 0) return 0;
  const dim3 block(kColThreads, kRowGroups);
  const dim3 grid((n + kTileCols - 1) / kTileCols);
  coverage_matvec_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)R, (int64_t)ld, (const uint8_t*)alive, theta, n,
      (float*)out);
  return (int)cudaGetLastError();
}
