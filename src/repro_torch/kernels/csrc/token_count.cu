// token_count: counter[v] = sum_t alive[t] * bit_t(v) over a
// (theta, s_pad) int32 token arena (src/repro/core/pack/codec.py
// format: token = block * 512 + code; code < 256 is a literal byte at
// `block`, code 256 a saturated 32-byte run starting at `block`, the
// sentinel block n_blocks_padded * 512 ends a row), exact in int32.
// Replaces the Pallas kernel src/repro/kernels/packed_count.py
// (token_count, _token_kernel).  That kernel compares every token of a
// row with every column of a tile, O(theta * s_pad * n) work; this one
// works from the format instead.  Within a row the literals come first,
// sorted by block, then the run tokens, then sentinels; no two tokens of
// a row set the same bit, so the counts add exactly.
//
// Pass 1 (token_scan): one warp per alive row reads the row's tokens up
// to its first sentinel.  It records where each column tile's literals
// start (off[tile * theta + row], tiles + 1 entries: tile j's literals
// are tokens off[j] .. off[j + 1] - 1) and adds each run token into a
// per-superblock count (run_cnt, integer atomics).
// Pass 2 (token_tiles): a block owns a tile of kTileBytes = 128 packed
// bytes (1,024 columns) and all theta rows.  A warp takes 32 rows at a
// time; for each alive row with literals in the tile it scatters them
// into a 128-byte staging tile in shared memory, then each lane adds its
// 4 bytes' 32 bits into byte-lane counters, as packed_count does.  The
// warps' counts meet in shared memory; each column adds its
// superblock's run count and is written once.
//
// Bound by bytes: the real tokens of the alive rows, each read once
// (about 0.62 GB with every row alive at the com-Amazon cell, theta =
// 16,384 and s_pad = 32,768), plus the alive mask and the counter.  The
// kernel reads every real token twice (pass 1 all of them, pass 2 the
// literals) and the tile offsets (4 * (tiles + 1) * theta bytes, kept
// in L2); it never reads the sentinel tail of a row.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kShift = 9;          // block = token >> 9
constexpr int kCodeMask = 511;
constexpr int kSat = 256;
constexpr int kSuper = 32;         // bytes per run superblock
constexpr int kTileBytes = 128;
constexpr int kTileShift = 7;      // tile = block >> 7
constexpr int kTileCols = kTileBytes * 8;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunks = 4;         // 32-token chunks loaded per step

__global__ void __launch_bounds__(kThreads)
token_scan_kernel(const int* __restrict__ T, int64_t ld,
                  const uint8_t* __restrict__ alive, int theta, int s_pad,
                  int nbp, int tiles, int* __restrict__ off,
                  int* __restrict__ run_cnt) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= theta || !alive[row]) return;          // uniform per warp
  const int* tr = T + (int64_t)row * ld;
  const int sentinel = nbp << kShift;
  int carry = -1;       // tile of the last literal before this chunk
  bool in_lits = true;  // still inside the row's literal section
  for (int base = 0; base < s_pad; base += 32 * kChunks) {
    int tok[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int idx = base + 32 * c + lane;
      tok[c] = idx < s_pad ? __ldg(tr + idx) : sentinel;
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int idx = base + 32 * c + lane;
      const int blk = tok[c] >> kShift, code = tok[c] & kCodeMask;
      const bool sent = blk >= nbp;
      if (in_lits) {
        const bool lit = !sent && code < kSat;
        const unsigned non_lit = __ballot_sync(kFull, !lit);
        const int first = non_lit ? __ffs(non_lit) - 1 : 32;
        const int t = blk >> kTileShift;
        int tp = __shfl_up_sync(kFull, t, 1);
        if (lane == 0) tp = carry;
        // tiles (tp, t] start at this literal; past the last literal,
        // tiles (tp, tiles] start (and end) at the first non-literal
        const int upto = lane < first ? t : lane == first ? tiles : tp;
        for (int u = tp + 1; u <= upto; ++u)
          off[(int64_t)u * theta + row] = idx;
        carry = __shfl_sync(kFull, t, 31);
        in_lits = first == 32;
      }
      if (!sent && code == kSat) atomicAdd(run_cnt + blk / kSuper, 1);
      if (__ballot_sync(kFull, sent)) return;        // the row has ended
    }
  }
  if (in_lits && lane == 0)                           // no terminator
    for (int u = carry + 1; u <= tiles; ++u)
      off[(int64_t)u * theta + row] = s_pad;
}

// bit i of the low nibble of x -> byte lane i (0x00 or 0x01)
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return ((x & 0xFu) * 0x00204081u) & 0x01010101u;
}

// lane word 2b + h, byte lane i counts the lane's column 8b + 4h + i
__device__ __forceinline__ void drain(uint32_t lanes[8], int acc[32]) {
#pragma unroll
  for (int L = 0; L < 8; ++L) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[4 * L + i] += (lanes[L] >> (8 * i)) & 0xFF;
    lanes[L] = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
token_tiles_kernel(const int* __restrict__ T, int64_t ld,
                   const uint8_t* __restrict__ alive, int theta,
                   const int* __restrict__ off,
                   const int* __restrict__ run_cnt, int n,
                   int* __restrict__ out) {
  __shared__ uint32_t stage[kWarps][kTileBytes / 4];
  __shared__ int part[kWarps][kTileCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = blockIdx.x;
  const int b0 = tile * kTileBytes;
  const int* off0 = off + (int64_t)tile * theta;
  const int* off1 = off0 + theta;
  uint8_t* sbytes = reinterpret_cast<uint8_t*>(stage[warp]);
  uint32_t lanes[8];
  int acc[32];
#pragma unroll
  for (int L = 0; L < 8; ++L) lanes[L] = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0;
  int since = 0;
  for (int r0 = warp * 32; r0 < theta; r0 += kWarps * 32) {
    const int r = r0 + lane;
    int s = 0, e = 0;
    if (r < theta && alive[r]) {
      s = off0[r];
      e = off1[r];
    }
    unsigned todo = __ballot_sync(kFull, e > s);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const int rs = __shfl_sync(kFull, s, src);
      const int re = __shfl_sync(kFull, e, src);
      const int* tr = T + (int64_t)(r0 + src) * ld;
      stage[warp][lane] = 0u;
      __syncwarp();
      for (int i = rs + lane; i < re; i += 32) {
        const int tk = __ldg(tr + i);
        sbytes[(tk >> kShift) - b0] = (uint8_t)(tk & 0xFF);
      }
      __syncwarp();
      const uint32_t w = stage[warp][lane];
      __syncwarp();                 // read before the next row zeroes it
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const uint32_t byte = (w >> (8 * b)) & 0xFFu;
        lanes[2 * b] += spread4(byte);
        lanes[2 * b + 1] += spread4(byte >> 4);
      }
      if (++since == 255) {
        drain(lanes, acc);
        since = 0;
      }
    }
  }
  drain(lanes, acc);
  // the lane's column j of the tile is lane * 32 + j
#pragma unroll
  for (int j = 0; j < 32; ++j) part[warp][j * 32 + lane] = acc[j];
  __syncthreads();
  for (int c = threadIdx.x; c < kTileCols; c += kThreads) {
    const int64_t col = (int64_t)tile * kTileCols + c;
    if (col >= n) continue;
    int sum = run_cnt[col >> 8];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += part[w][(c & 31) * 32 + (c >> 5)];
    out[col] = sum;
  }
}

}  // namespace

// T rows hold s_pad tokens with stride ld (in tokens).  off is
// (tiles + 1) * theta int32 scratch, run_cnt n_superblocks int32 zeros.
extern "C" int repro_token_count(const void* T, long long ld,
                                 const void* alive, int theta, int s_pad,
                                 int n, void* off, void* run_cnt, void* out,
                                 void* stream) {
  if (n <= 0) return 0;
  const int nb = (n + 7) / 8;
  const int nbp = (nb + kSuper - 1) / kSuper * kSuper;
  const int tiles = (nb + kTileBytes - 1) / kTileBytes;
  cudaStream_t s = (cudaStream_t)stream;
  if (theta > 0) {
    token_scan_kernel<<<(theta + kWarps - 1) / kWarps, kThreads, 0, s>>>(
        (const int*)T, (int64_t)ld, (const uint8_t*)alive, theta, s_pad, nbp,
        tiles, (int*)off, (int*)run_cnt);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  token_tiles_kernel<<<tiles, kThreads, 0, s>>>(
      (const int*)T, (int64_t)ld, (const uint8_t*)alive, theta,
      (const int*)off, (const int*)run_cnt, n, (int*)out);
  return (int)cudaGetLastError();
}
