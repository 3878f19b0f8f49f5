// fused_select: one greedy round's reduction, (max, argmax) of
// counter = alive @ R, without the counter ever reaching device memory.
// Replaces the Pallas kernel src/repro/kernels/fused_select.py
// (fused_select).  Bound by bytes, as coverage_matvec: theta * n bytes
// read when every row is alive.
//
// Pass 1: a block owns a 512-column tile, loops over all theta rows
// (colcount.cuh), sums its row groups in shared memory and reduces the
// tile to one (count, first column) pair.  Pass 2: one block picks the
// largest count, ties going to the smallest column — jnp.argmax's
// first-maximum rule, so an all-zero alive answers column 0.
#include <climits>

#include "colcount.cuh"

using namespace repro_torch;

// (a, ai) beats (b, bi): larger count, then smaller column
__device__ __forceinline__ bool better(int a, int ai, int b, int bi) {
  return a > b || (a == b && ai < bi);
}

__device__ __forceinline__ void warp_best(int& best, int& idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ob = __shfl_down_sync(0xFFFFFFFFu, best, off);
    const int oi = __shfl_down_sync(0xFFFFFFFFu, idx, off);
    if (better(ob, oi, best, idx)) {
      best = ob;
      idx = oi;
    }
  }
}

__global__ void __launch_bounds__(kColThreads * kRowGroups)
fused_select_tiles(const uint8_t* __restrict__ R, int64_t ld,
                   const uint8_t* __restrict__ alive, int theta, int n,
                   int* __restrict__ tile_max, int* __restrict__ tile_idx) {
  __shared__ int part[kRowGroups][kColsPerThread][kColThreads];
  const int64_t c0 =
      (int64_t)blockIdx.x * kTileCols + threadIdx.x * kColsPerThread;
  int acc[kColsPerThread];
  column_counts(R, ld, alive, theta, threadIdx.y, kRowGroups, c0, n, acc);
  reduce_row_groups(acc, part);
  if (threadIdx.y != 0) return;
  int best = -1, idx = INT_MAX;
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j)
    if (c0 + j < n && acc[j] > best) {
      best = acc[j];
      idx = (int)(c0 + j);
    }
  warp_best(best, idx);
  if (threadIdx.x == 0) {
    tile_max[blockIdx.x] = best;
    tile_idx[blockIdx.x] = idx;
  }
}

constexpr int kReduceThreads = 256;

__global__ void __launch_bounds__(kReduceThreads)
fused_select_pick(const int* __restrict__ tile_max,
                  const int* __restrict__ tile_idx, int tiles,
                  float* __restrict__ out_max, int* __restrict__ out_idx) {
  __shared__ int sb[kReduceThreads / 32], si[kReduceThreads / 32];
  int best = -1, idx = INT_MAX;
  for (int i = threadIdx.x; i < tiles; i += kReduceThreads)
    if (better(tile_max[i], tile_idx[i], best, idx)) {
      best = tile_max[i];
      idx = tile_idx[i];
    }
  warp_best(best, idx);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sb[warp] = best;
    si[warp] = idx;
  }
  __syncthreads();
  if (warp != 0) return;
  best = lane < kReduceThreads / 32 ? sb[lane] : -1;
  idx = lane < kReduceThreads / 32 ? si[lane] : INT_MAX;
  warp_best(best, idx);
  if (lane == 0) {
    *out_max = (float)best;
    *out_idx = idx;
  }
}

extern "C" int repro_fused_select(const void* R, long long ld,
                                  const void* alive, int theta, int n,
                                  void* tile_max, void* tile_idx,
                                  void* out_max, void* out_idx,
                                  void* stream) {
  if (n <= 0) return 0;
  const int tiles = (n + kTileCols - 1) / kTileCols;
  cudaStream_t s = (cudaStream_t)stream;
  fused_select_tiles<<<tiles, dim3(kColThreads, kRowGroups), 0, s>>>(
      (const uint8_t*)R, (int64_t)ld, (const uint8_t*)alive, theta, n,
      (int*)tile_max, (int*)tile_idx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_select_pick<<<1, kReduceThreads, 0, s>>>(
      (const int*)tile_max, (const int*)tile_idx, tiles, (float*)out_max,
      (int*)out_idx);
  return (int)cudaGetLastError();
}
