// packed_count: counter[v] = sum_t alive[t] * bit(R[t, v >> 3], v & 7)
// over a (theta, ceil(n / 8)) uint8 bit-packed arena (LSB-first), exact
// in int32.  Replaces the Pallas kernel src/repro/kernels/packed_count.py
// (packed_count, _packed_kernel), which unpacks a byte tile to f32 bits
// and accumulates alive @ bits on the MXU.
//
// Bound on an H100: bytes.  It reads each alive row once (theta *
// ceil(n / 8) bytes with every row alive: 686 MB at theta = 16,384,
// n = 334,863, 0.205 ms at 3.35 TB/s); dead rows are not read.  The
// counting must stay under that: 16 bytes a row cost a lane 4 words of
// bit-sliced carry-save adds (bitslice.cuh), about 3 logic instructions
// a word a row, against ~10 a byte for the byte-lane arithmetic of the
// earlier design, whose integer work (about 0.33 ms, reckoned from its
// source) sat above its bytes.
//
// Work: the columns are cut into tiles of kTileBytes = 512 bytes (4,096
// columns, one warp-row of 16-byte loads) and the rows into units of 32;
// the (tile, unit) pairs, tile-major, are split evenly over a persistent
// grid of as many blocks as fit on the card at once, so every SM gets the
// same share whatever the shape.  A block walks its range one tile at a
// time; its warps take the tile's units in turn.  A warp reads the 32
// alive flags of a unit as one byte a lane and one ballot, then loads
// only the alive rows, eight at a time (4 KB in flight a warp), and adds
// them into its planes.  The planes expand into the block's int32 counts
// in shared memory (shared atomics; a skewed layout keeps them free of
// bank conflicts) every kMaxSteps steps and at the end of the tile; the
// block then adds each column's count into `out` with one integer atomic
// (out starts at zero), so a column meets as many atomics as blocks
// share its tile (five or six at the kernel rows' arena, 16,384 rows on
// 396 blocks).  Bits past column n (the last byte's pad bits, the row
// padding) land in columns that are never written out.
#include <cstdint>
#include <cuda_runtime.h>

#include "bitslice.cuh"

namespace {

using repro_torch::kMaxSteps;
using repro_torch::kPlanes;
using repro_torch::kStepRows;

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLaneBytes = 16;
constexpr int kWords = kLaneBytes / 4;
constexpr int kTileBytes = 32 * kLaneBytes;
constexpr int kTileCols = kTileBytes * 8;
constexpr int kLaneCols = kLaneBytes * 8;     // 128 columns a lane
constexpr int kUnitRows = 32;
constexpr int kSkew = 33;                     // cnt[k * 33 + lane]

__device__ __forceinline__ void expand_words(uint32_t P[kWords][kPlanes],
                                             int* cnt, int lane) {
#pragma unroll
  for (int w = 0; w < kWords; ++w)
    repro_torch::expand(P[w], [&](int j, int c) {
      atomicAdd(cnt + (32 * w + j) * kSkew + lane, c);
    });
}

__global__ void __launch_bounds__(kThreads)
packed_count_kernel(const uint8_t* __restrict__ R, int64_t ld,
                    const uint8_t* __restrict__ alive, int theta, int nb,
                    int n, int64_t unit_per_tile, int64_t units,
                    int* __restrict__ out) {
  __shared__ int cnt[kLaneCols * kSkew];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t u_lo = units * blockIdx.x / gridDim.x;
  const int64_t u_hi = units * (blockIdx.x + 1) / gridDim.x;
  for (int i = threadIdx.x; i < kLaneCols * kSkew; i += kThreads) cnt[i] = 0;
  for (int64_t seg = u_lo; seg < u_hi;) {
    const int64_t tile = seg / unit_per_tile;
    const int64_t seg_end = min(u_hi, (tile + 1) * unit_per_tile);
    const int64_t b0 = tile * kTileBytes + lane * kLaneBytes;
    const bool cols = b0 < nb;
    __syncthreads();                      // cnt is clear
    uint32_t P[kWords][kPlanes];
#pragma unroll
    for (int w = 0; w < kWords; ++w)
#pragma unroll
      for (int q = 0; q < kPlanes; ++q) P[w][q] = 0;
    int steps = 0;
    // this warp's units of the segment, their alive rows eight at a time
    int64_t u = seg + warp;
    unsigned bits = 0;
    int rbase = 0;
    uint8_t flag = 0;                     // alive flag of unit u, row lane
    int frow = (int)((u % unit_per_tile) * kUnitRows) + lane;
    if (u < seg_end && frow < theta) flag = alive[frow];
    bool more = true;
    while (more) {
      int rows[kStepRows];
#pragma unroll
      for (int k = 0; k < kStepRows; ++k) {
        while (bits == 0 && u < seg_end) {        // warp-uniform
          bits = __ballot_sync(kFull, flag != 0);
          rbase = frow - lane;
          u += kWarps;
          frow = (int)((u % unit_per_tile) * kUnitRows) + lane;
          flag = (u < seg_end && frow < theta) ? alive[frow] : 0;
        }
        rows[k] = -1;
        if (bits) {
          rows[k] = rbase + __ffs(bits) - 1;
          bits &= bits - 1;
        }
      }
      if (rows[0] < 0) break;
      more = rows[kStepRows - 1] >= 0;
      uint4 v[kStepRows];
#pragma unroll
      for (int k = 0; k < kStepRows; ++k) {
        v[k] = make_uint4(0u, 0u, 0u, 0u);
        if (cols && rows[k] >= 0)
          v[k] = __ldg(reinterpret_cast<const uint4*>(
              R + (int64_t)rows[k] * ld + b0));
      }
      uint32_t x[kStepRows];
#pragma unroll
      for (int k = 0; k < kStepRows; ++k) x[k] = v[k].x;
      repro_torch::add8(P[0], x);
#pragma unroll
      for (int k = 0; k < kStepRows; ++k) x[k] = v[k].y;
      repro_torch::add8(P[1], x);
#pragma unroll
      for (int k = 0; k < kStepRows; ++k) x[k] = v[k].z;
      repro_torch::add8(P[2], x);
#pragma unroll
      for (int k = 0; k < kStepRows; ++k) x[k] = v[k].w;
      repro_torch::add8(P[3], x);
      if (++steps == kMaxSteps) {
        expand_words(P, cnt, lane);
        steps = 0;
      }
    }
    expand_words(P, cnt, lane);
    __syncthreads();
    // lane l's column k of the tile is l * 128 + k, kept at k * 33 + l
    for (int c = threadIdx.x; c < kTileCols; c += kThreads) {
      const int64_t col = tile * kTileCols + c;
      const int at = (c & (kLaneCols - 1)) * kSkew + (c >> 7);
      const int val = cnt[at];
      cnt[at] = 0;
      if (val && col < n) atomicAdd(out + col, val);
    }
    seg = seg_end;
  }
}

int resident_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, packed_count_kernel, kThreads, 0);
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  return blocks;
}

}  // namespace

// R rows are nb = ceil(n / 8) bytes wide, 16-byte aligned with stride ld
// (the storage runs to the row's 16-byte padded width); out holds n
// int32 zeros.
extern "C" int repro_packed_count(const void* R, long long ld,
                                  const void* alive, int theta, int n,
                                  void* out, void* stream) {
  if (n <= 0 || theta <= 0) return 0;
  const int nb = (n + 7) / 8;
  const int64_t unit_per_tile = (theta + kUnitRows - 1) / kUnitRows;
  const int64_t tiles = (nb + kTileBytes - 1) / kTileBytes;
  const int64_t units = unit_per_tile * tiles;
  const int blocks = resident_blocks();
  const int grid = (int)(units < blocks ? units : blocks);
  packed_count_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)R, (int64_t)ld, (const uint8_t*)alive, theta, nb, n,
      unit_per_tile, units, (int*)out);
  return (int)cudaGetLastError();
}
