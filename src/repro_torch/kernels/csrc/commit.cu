// arena_commit: write a sampled (B, n) uint8 0/1 batch into its arena
// rows, add its int32 column sums into the store counter and, when asked,
// write its row sums into the store's sizes, in one pass over the batch.
// Replaces the Pallas kernel src/repro/kernels/commit.py (arena_commit:
// _bitmap_kernel for kind="bitmap", _packed_kernel for kind="packed");
// the JAX chain's separate stored -> _commit_write copy collapses into
// this kernel's stores, and its row sums (core/fused.py) into its counts.
//
// Bitmap kind: the identity store.  Bound by bytes: B * n read + B * n
// written, the n-entry counter read and written, 4 * B bytes of sizes:
// 174 MB at B = 256, n = 334,863.  Packed kind: LSB-first packing, bit j
// of byte b is column 8 * b + j, bitwise the reference's pack_bits; the
// TPU packs with an MXU product against a {0, 2^j} weight matrix, here
// four multiplies pack a 16-byte load into two bytes.  Bound by bytes:
// B * n read + B * ceil(n / 8) written (+ counter and sizes): 99 MB.
//
// Design.  A persistent grid (the occupancy's blocks a SM, at most
// kBlocksPerSM) splits the batch's (column strip, row) pairs, in
// strip-major order, into one contiguous range a block, balanced to a
// row.  A strip is 1,024 columns: 64 column threads of 16 columns times
// 4 row lanes.  A block walks its range 32 rows at a time; a thread
// issues its 8 rows' 16-byte loads before it uses any, then stores each
// row (16 bytes, or 2 packed bytes) and counts it.
//  - Column counts ride in byte lanes for a step (at most 8 rows), then
//    in 16-bit lanes for the strip (at most kMaxRows / 4 rows a thread),
//    and reach the counter once a strip a block through shared memory:
//    a plain add where the block holds every row of the strip, a
//    coalesced integer atomic where it shares the strip with a neighbour.
//  - Row sums: a chunk's byte sum (one dp4a), reduced over the warp for
//    its 8 rows with 9 shuffles (a butterfly that halves the rows a lane
//    keeps), added into a shared row array, and added into sizes with one
//    coalesced atomic a row at the block's end; the launch zeroes sizes
//    on its stream first.  Integer sums commute, so counter and sizes do
//    not depend on any order.
// A row's last, partial chunk stores byte by byte so nothing past the
// row's width is written; loads may read a row's padding up to its
// 16-byte stride, and mask it.  Batches above kMaxRows rows run as one
// launch per kMaxRows rows.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColThreads = 64;                        // 16 columns each
constexpr int kRowLanes = kThreads / kColThreads;      // 4
constexpr int kStrip = kColThreads * 16;               // 1,024 columns
constexpr int kRows = 8;                               // a thread's step
constexpr int kStepRows = kRowLanes * kRows;           // 32
constexpr int kMaxRows = 4096;                         // rows a launch
constexpr int kBlocksPerSM = 4;
static_assert(kMaxRows / kRowLanes <= 0xFFFF, "16-bit column lanes");

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

__device__ __forceinline__ uint4 and4(uint4 a, uint4 b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}

__device__ __forceinline__ uint4 add4(uint4 a, uint4 b) {
  return make_uint4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Bits 0..3 of the result are the low bits of the four bytes of a word
// whose bytes are 0 or 1: the multiply moves byte j's bit to bit 24 + j
// and no two partial products share a bit, so nothing carries.
__device__ __forceinline__ uint32_t pack_nibble(uint32_t w) {
  return ((w * 0x01020408u) >> 24) & 0xFu;
}

// The first `valid` bytes of a 16-byte chunk, as byte masks and as masks
// of their low bits.
struct Lanes {
  uint4 keep, low;
  __device__ explicit Lanes(int valid) {
    uint32_t k[4], l[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      k[q] = 0;
      l[q] = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (4 * q + b < valid) {
          k[q] |= 0xFFu << (8 * b);
          l[q] |= 0x01u << (8 * b);
        }
    }
    keep = make_uint4(k[0], k[1], k[2], k[3]);
    low = make_uint4(l[0], l[1], l[2], l[3]);
  }
};

// the first `valid` (< 16) bytes of v at dst, one at a time
__device__ __forceinline__ void store_bytes(uint8_t* dst, uint4 v,
                                            int valid) {
  for (int b = 0; b < valid; ++b) {
    const uint32_t word = b < 4 ? v.x : b < 8 ? v.y : b < 12 ? v.z : v.w;
    dst[b] = (uint8_t)(word >> (8 * (b & 3)));
  }
}

// p[u] is this lane's partial of the warp's row u; returns, in the lanes
// whose two low bits are 0, the warp's sum for row lane >> 2.  A
// butterfly that halves the rows a lane keeps at each of its first three
// steps: 4 + 2 + 1 + 2 shuffles.
__device__ __forceinline__ int warp_row_sums(int (&p)[kRows], int lane) {
  int off = 16;
#pragma unroll
  for (int h = kRows / 2; h >= 1; h /= 2, off /= 2) {
    const bool up = lane & off;
#pragma unroll
    for (int i = 0; i < h; ++i)
      p[i] = (up ? p[i + h] : p[i]) +
             __shfl_xor_sync(0xFFFFFFFFu, up ? p[i] : p[i + h], off);
  }
  p[0] += __shfl_xor_sync(0xFFFFFFFFu, p[0], 2);
  p[0] += __shfl_xor_sync(0xFFFFFFFFu, p[0], 1);
  return p[0];
}

// A thread's 16 column counts in 16-bit lanes: lo[k] holds columns
// 4k and 4k + 2, hi[k] columns 4k + 1 and 4k + 3.
struct ColCounts {
  uint32_t lo[4] = {0, 0, 0, 0}, hi[4] = {0, 0, 0, 0};
  // adds a step's byte-lane sums (each byte at most kRows)
  __device__ __forceinline__ void add(uint4 w) {
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      lo[k] += ws[k] & 0x00FF00FFu;
      hi[k] += (ws[k] >> 8) & 0x00FF00FFu;
    }
  }
  __device__ __forceinline__ void put(uint32_t* dst) const {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      reinterpret_cast<uint4*>(dst)[k] =
          make_uint4(lo[k] & 0xFFFFu, hi[k] & 0xFFFFu, lo[k] >> 16,
                     hi[k] >> 16);
  }
};

struct Chunk {
  int64_t c0;  // first column
  int valid;   // columns of the chunk inside the row: 0 .. 16
};

// A step's loads: rows r0, r0 + 4, ..., r0 + 28 (those below r_end) of
// this thread's chunk.
__device__ __forceinline__ void load_step(uint4 (&v)[kRows],
                                          const uint8_t* __restrict__ rows,
                                          int64_t ld_in, const Chunk& ch,
                                          int r0, int r_end) {
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int r = r0 + kRowLanes * u;
    v[u] = ch.valid > 0 && r < r_end
               ? __ldcs(reinterpret_cast<const uint4*>(
                     rows + (int64_t)r * ld_in + ch.c0))
               : make_uint4(0u, 0u, 0u, 0u);
  }
}

// A step's stores and counts, of the rows load_step read.
template <bool kPacked>
__device__ __forceinline__ void use_step(
    uint4 (&v)[kRows], uint8_t* __restrict__ out, int64_t ld_out,
    const Chunk& ch, const Lanes& m, int r0, int r_end, int lane,
    ColCounts& cnt, int* srow) {
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  int part[kRows];
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int r = r0 + kRowLanes * u;
    v[u] = and4(v[u], m.keep);
    const uint4 c = and4(v[u], m.low);
    w = add4(w, c);
    part[u] = (int)__dp4a(c.x + c.y + c.z + c.w, 0x01010101u, 0u);
    if (ch.valid == 0 || r >= r_end) continue;
    uint8_t* row_out = out + (int64_t)r * ld_out;
    if (kPacked) {
      // columns c0 .. c0 + 15 are bytes c0 / 8 and c0 / 8 + 1 of the row
      const uint32_t bits = pack_nibble(c.x) | (pack_nibble(c.y) << 4) |
                            (pack_nibble(c.z) << 8) |
                            (pack_nibble(c.w) << 12);
      uint8_t* dst = row_out + ch.c0 / 8;
      if (ch.valid > 8) {
        *reinterpret_cast<uint16_t*>(dst) = (uint16_t)bits;
      } else {
        dst[0] = (uint8_t)bits;
      }
    } else if (ch.valid == 16) {
      __stcs(reinterpret_cast<uint4*>(row_out + ch.c0), v[u]);
    } else {
      store_bytes(row_out + ch.c0, v[u], ch.valid);
    }
  }
  cnt.add(w);
  if (srow != nullptr) {
    const int z = warp_row_sums(part, lane);
    const int r = r0 + kRowLanes * (lane >> 2);
    if ((lane & 3) == 0 && r < r_end && z) atomicAdd(&srow[r], z);
  }
}

// Adds strip s's column counts (its 4 row lanes in scol) into counter:
// a plain add where the block held every row of the strip (`whole`),
// else an integer atomic.
__device__ __forceinline__ void add_strip(const uint32_t (*scol)[kStrip],
                                          int* __restrict__ counter,
                                          int64_t s, int n, bool whole,
                                          int tid) {
  for (int j = tid; j < kStrip && s * kStrip + j < n; j += kThreads) {
    const int t = scol[0][j] + scol[1][j] + scol[2][j] + scol[3][j];
    int* dst = counter + s * kStrip + j;
    if (t == 0) continue;
    if (whole) {
      *dst += t;
    } else {
      atomicAdd(dst, t);
    }
  }
}

template <bool kPacked>
__global__ void __launch_bounds__(kThreads)
commit_kernel(const uint8_t* __restrict__ rows, int64_t ld_in,
              uint8_t* __restrict__ out, int64_t ld_out,
              int* __restrict__ counter, int* __restrict__ sizes, int B,
              int n) {
  __shared__ __align__(16) uint32_t scol[kRowLanes][kStrip];
  __shared__ int srow_buf[kMaxRows];
  int* srow = sizes == nullptr ? nullptr : srow_buf;
  const int tid = threadIdx.x, lane = tid & 31;
  const int ct = tid % kColThreads, q = tid / kColThreads;
  const int64_t strips = (n + kStrip - 1) / kStrip;
  const int64_t total = strips * B;
  const int64_t a = total * blockIdx.x / gridDim.x;
  const int64_t b = total * (blockIdx.x + 1) / gridDim.x;
  if (srow != nullptr)
    for (int i = tid; i < B; i += kThreads) srow[i] = 0;
  __syncthreads();

  for (int64_t L = a; L < b;) {
    // rows [r_begin, r_end) of strip s
    const int64_t s = L / B;
    const int r_begin = (int)(L - s * B);
    const int r_end = (int)min64(B, r_begin + (b - L));
    Chunk ch;
    ch.c0 = s * kStrip + ct * 16;
    ch.valid = (int)max64(0, min64(16, n - ch.c0));
    const Lanes m(ch.valid);
    ColCounts cnt;
    // this thread's rows r_begin + q + 4i, 8 of them a step
    for (int r0 = r_begin + q; r0 - q < r_end; r0 += kStepRows) {
      uint4 v[kRows];
      load_step(v, rows, ld_in, ch, r0, r_end);
      use_step<kPacked>(v, out, ld_out, ch, m, r0, r_end, lane, cnt, srow);
    }
    // this strip's column counts: the 4 row lanes summed in shared
    // memory, then one add a column
    cnt.put(&scol[q][ct * 16]);
    __syncthreads();
    add_strip(scol, counter, s, n, r_begin == 0 && r_end == B, tid);
    __syncthreads();
    L += r_end - r_begin;
  }
  if (srow != nullptr)
    for (int i = tid; i < B; i += kThreads)
      if (srow[i]) atomicAdd(sizes + i, srow[i]);
}

// blocks a SM: the occupancy calculator's, at most kBlocksPerSM
template <bool kPacked>
int blocks_per_sm() {
  static int cached = 0;
  if (cached == 0) {
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, commit_kernel<kPacked>, kThreads, 0) != cudaSuccess ||
        per_sm < 1)
      per_sm = 1;
    cached = per_sm < kBlocksPerSM ? per_sm : kBlocksPerSM;
  }
  return cached;
}

template <bool kPacked>
int launch(const void* rows, long long ld_in, void* out, long long ld_out,
           void* counter, void* sizes, int B, int n, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t strips = (n + kStrip - 1) / kStrip;
  const int64_t cap = (int64_t)sms * blocks_per_sm<kPacked>();
  for (int r0 = 0; r0 < B; r0 += kMaxRows) {
    const int Bc = B - r0 < kMaxRows ? B - r0 : kMaxRows;
    int* sz = sizes == nullptr ? nullptr : (int*)sizes + r0;
    if (sz != nullptr) {
      err = cudaMemsetAsync(sz, 0, sizeof(int) * (size_t)Bc, st);
      if (err != cudaSuccess) return (int)err;
    }
    const int64_t units = strips * Bc;
    const int grid = (int)(units < cap ? units : cap);
    commit_kernel<kPacked><<<grid, kThreads, 0, st>>>(
        (const uint8_t*)rows + (int64_t)r0 * ld_in, (int64_t)ld_in,
        (uint8_t*)out + (int64_t)r0 * ld_out, (int64_t)ld_out, (int*)counter,
        sz, Bc, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// sizes may be null: then only the arena rows and the counter are written
extern "C" int repro_commit_bitmap(const void* rows, long long ld_in,
                                   void* out, long long ld_out,
                                   void* counter, void* sizes, int B, int n,
                                   void* stream) {
  return launch<false>(rows, ld_in, out, ld_out, counter, sizes, B, n,
                       stream);
}

// out rows are ceil(n / 8) bytes wide, 16-byte aligned with stride ld_out
extern "C" int repro_commit_packed(const void* rows, long long ld_in,
                                   void* out, long long ld_out,
                                   void* counter, void* sizes, int B, int n,
                                   void* stream) {
  return launch<true>(rows, ld_in, out, ld_out, counter, sizes, B, n,
                      stream);
}
