// packed_count: counter[v] = sum_t alive[t] * bit(R[t, v >> 3], v & 7)
// over a (theta, ceil(n / 8)) uint8 bit-packed arena (LSB-first), exact
// in int32.  Replaces the Pallas kernel src/repro/kernels/packed_count.py
// (packed_count, _packed_kernel), which unpacks a byte tile to f32 bits
// and accumulates alive @ bits on the MXU.  Bound by bytes: it reads each
// alive row once (theta * ceil(n / 8) bytes with every row alive: 686 MB
// at theta = 16,384, n = 334,863, 0.20 ms at 3.35 TB/s); dead rows are
// not read.
//
// A block owns a tile of kTileBytes = 128 packed bytes (1,024 columns)
// and all theta rows.  Each thread owns 16 bytes (128 columns) of the
// tile and reads them with one 16-byte load per row; the kRowGroups
// row groups stride over the rows, so a warp reads four rows' 128-byte
// lines.  A byte's 8 bits spread into the byte lanes of two 32-bit words
// with one multiply each, so one add counts four columns; the lanes hold
// at most 255, so every kDrainEvery rows they drain into the tile's
// int32 counts in shared memory (shared atomics: the row groups share
// columns).  The tile's counts go to device memory once, with no global
// atomics.  Bits past column n (the last byte's pad bits and the row
// padding) land in columns that are never written out.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kColThreads = 8;
constexpr int kRowGroups = 32;
constexpr int kThreads = kColThreads * kRowGroups;
constexpr int kBytesPerThread = 16;
constexpr int kTileBytes = kColThreads * kBytesPerThread;
constexpr int kTileCols = kTileBytes * 8;
constexpr int kLaneWords = kBytesPerThread * 2;
constexpr int kUnroll = 4;
constexpr int kDrainEvery = 252;   // a multiple of kUnroll, at most 255
static_assert(kDrainEvery % kUnroll == 0 && kDrainEvery <= 255, "lanes");

// bit i of the low nibble of x -> byte lane i (0x00 or 0x01)
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return ((x & 0xFu) * 0x00204081u) & 0x01010101u;
}

__device__ __forceinline__ void add_row(const uint4 v,
                                        uint32_t lanes[kLaneWords]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint32_t byte = (w[q] >> (8 * b)) & 0xFFu;
      lanes[2 * (4 * q + b)] += spread4(byte);
      lanes[2 * (4 * q + b) + 1] += spread4(byte >> 4);
    }
}

// lane word L, byte lane i counts tile column col0 + 4 * L + i
__device__ __forceinline__ void drain(uint32_t lanes[kLaneWords], int* acc,
                                      int col0) {
#pragma unroll
  for (int L = 0; L < kLaneWords; ++L) {
    if (lanes[L]) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int cnt = (lanes[L] >> (8 * i)) & 0xFF;
        if (cnt) atomicAdd(acc + col0 + 4 * L + i, cnt);
      }
      lanes[L] = 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
packed_count_kernel(const uint8_t* __restrict__ R, int64_t ld,
                    const uint8_t* __restrict__ alive, int theta, int nb,
                    int n, int* __restrict__ out) {
  __shared__ int acc[kTileCols];
  const int tid = threadIdx.y * kColThreads + threadIdx.x;
  for (int i = tid; i < kTileCols; i += kThreads) acc[i] = 0;
  __syncthreads();
  const int64_t b0 =
      (int64_t)blockIdx.x * kTileBytes + threadIdx.x * kBytesPerThread;
  if (b0 < nb) {
    uint32_t lanes[kLaneWords];
#pragma unroll
    for (int L = 0; L < kLaneWords; ++L) lanes[L] = 0;
    int since = 0;
    for (int t = threadIdx.y; t < theta; t += kRowGroups * kUnroll) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int tt = t + u * kRowGroups;
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (tt < theta && alive[tt])
          v[u] = __ldg(reinterpret_cast<const uint4*>(R + (int64_t)tt * ld + b0));
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add_row(v[u], lanes);
      since += kUnroll;
      if (since == kDrainEvery) {
        drain(lanes, acc, threadIdx.x * kBytesPerThread * 8);
        since = 0;
      }
    }
    drain(lanes, acc, threadIdx.x * kBytesPerThread * 8);
  }
  __syncthreads();
  for (int i = tid; i < kTileCols; i += kThreads) {
    const int64_t col = (int64_t)blockIdx.x * kTileCols + i;
    if (col < n) out[col] = acc[i];
  }
}

}  // namespace

// R rows are nb = ceil(n / 8) bytes wide, 16-byte aligned with stride ld
// (the storage runs to the row's 16-byte padded width)
extern "C" int repro_packed_count(const void* R, long long ld,
                                  const void* alive, int theta, int n,
                                  void* out, void* stream) {
  if (n <= 0) return 0;
  const int nb = (n + 7) / 8;
  const dim3 grid((nb + kTileBytes - 1) / kTileBytes);
  packed_count_kernel<<<grid, dim3(kColThreads, kRowGroups), 0,
                        (cudaStream_t)stream>>>(
      (const uint8_t*)R, (int64_t)ld, (const uint8_t*)alive, theta, nb, n,
      (int*)out);
  return (int)cudaGetLastError();
}
