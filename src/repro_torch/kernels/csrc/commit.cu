// arena_commit: write a sampled (B, n) uint8 0/1 batch into its arena
// rows and add its int32 column sums into the store counter, in one pass
// over the batch.  Replaces the Pallas kernel src/repro/kernels/commit.py
// (arena_commit: _bitmap_kernel for kind="bitmap", _packed_kernel for
// kind="packed"); the JAX chain's separate stored -> _commit_write copy
// collapses into this kernel's stores.
//
// Bitmap kind: the identity store.  Bound by bytes: B * n read + B * n
// written (+ the n-entry counter): 171 MB at B = 256, n = 334,863.
// Packed kind: LSB-first packing, bit j of byte b is column 8 * b + j,
// bitwise the reference's pack_bits; the TPU packs with an MXU product
// against a {0, 2^j} weight matrix, here four multiplies pack a 16-byte
// load into two bytes.  Bound by bytes: B * n read + B * ceil(n / 8)
// written (+ the counter): 99 MB at the same shape.
//
// A thread owns 16 consecutive columns of kRowsPerBlock rows: one
// 16-byte load per row, then one 16-byte store (bitmap) or one 2-byte
// store (packed); a row's last, partial chunk stores byte by byte so
// nothing past the row's width is written.  The column counts ride in
// byte lanes (kRowsPerBlock < 256) and reach the counter with one atomic
// add per nonzero column per block; integer atomics commute, so the
// result does not depend on their order.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowsPerBlock = 64;
static_assert(kRowsPerBlock <= 255, "byte lanes");

__device__ __forceinline__ uint4 and4(uint4 a, uint4 b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}

// Bits 0..3 of the result are the low bits of the four bytes of a word
// whose bytes are 0 or 1: the multiply moves byte j's bit to bit 24 + j
// and no two partial products share a bit, so nothing carries.
__device__ __forceinline__ uint32_t pack_nibble(uint32_t w) {
  return ((w * 0x01020408u) >> 24) & 0xFu;
}

template <bool kPacked>
__global__ void __launch_bounds__(kThreads)
commit_kernel(const uint8_t* __restrict__ rows, int64_t ld_in,
              uint8_t* __restrict__ out, int64_t ld_out,
              int* __restrict__ counter, int B, int n) {
  const int64_t c0 = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * 16;
  if (c0 >= n) return;
  const int r0 = blockIdx.y * kRowsPerBlock;
  const int r1 = min(B, r0 + kRowsPerBlock);
  const int64_t rem = n - c0;
  const int valid = rem < 16 ? (int)rem : 16;
  uint32_t keep[4], low[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    keep[q] = 0;
    low[q] = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (4 * q + b < valid) {
        keep[q] |= 0xFFu << (8 * b);
        low[q] |= 0x01u << (8 * b);
      }
  }
  const uint4 keep4 = make_uint4(keep[0], keep[1], keep[2], keep[3]);
  const uint4 low4 = make_uint4(low[0], low[1], low[2], low[3]);
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 4
  for (int r = r0; r < r1; ++r) {
    const uint4 v = and4(
        __ldg(reinterpret_cast<const uint4*>(rows + (int64_t)r * ld_in + c0)),
        keep4);
    const uint4 c = and4(v, low4);
    if (kPacked) {
      // columns c0 .. c0 + 15 are bytes c0 / 8 and c0 / 8 + 1 of the row
      const uint32_t bits = pack_nibble(c.x) | (pack_nibble(c.y) << 4) |
                            (pack_nibble(c.z) << 8) | (pack_nibble(c.w) << 12);
      uint8_t* dst = out + (int64_t)r * ld_out + c0 / 8;
      if (valid > 8) {
        *reinterpret_cast<uint16_t*>(dst) = (uint16_t)bits;
      } else {
        dst[0] = (uint8_t)bits;
      }
    } else {
      uint8_t* dst = out + (int64_t)r * ld_out + c0;
      if (valid == 16) {
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
        const uint8_t* vb = reinterpret_cast<const uint8_t*>(&v);
        for (int b = 0; b < valid; ++b) dst[b] = vb[b];
      }
    }
    w.x += c.x;
    w.y += c.y;
    w.z += c.z;
    w.w += c.w;
  }
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int cnt = (ws[q] >> (8 * b)) & 0xFF;
      if (cnt) atomicAdd(counter + c0 + 4 * q + b, cnt);
    }
}

template <bool kPacked>
int launch(const void* rows, long long ld_in, void* out, long long ld_out,
           void* counter, int B, int n, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  const int chunks = (n + 15) / 16;
  const dim3 grid((chunks + kThreads - 1) / kThreads,
                  (B + kRowsPerBlock - 1) / kRowsPerBlock);
  commit_kernel<kPacked><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)rows, (int64_t)ld_in, (uint8_t*)out, (int64_t)ld_out,
      (int*)counter, B, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_commit_bitmap(const void* rows, long long ld_in,
                                   void* out, long long ld_out,
                                   void* counter, int B, int n,
                                   void* stream) {
  return launch<false>(rows, ld_in, out, ld_out, counter, B, n, stream);
}

// out rows are ceil(n / 8) bytes wide, 16-byte aligned with stride ld_out
extern "C" int repro_commit_packed(const void* rows, long long ld_in,
                                   void* out, long long ld_out,
                                   void* counter, int B, int n,
                                   void* stream) {
  return launch<true>(rows, ld_in, out, ld_out, counter, B, n, stream);
}
