// ic_sparse_hits: the positional IC coin test of one sparse BFS step,
// hit[b, e] = uniform(key, (B, m))[b, e] < edge_prob[e], written as a
// (B, m) bool block.  It stands for the jax.random.uniform draw of
// src/repro/core/sampler.py:_sparse_loop (no Pallas kernel: XLA fuses
// that draw on the TPU).  The bits are the partitionable threefry2x32 of
// jax 0.9 (jax_threefry_partitionable=True): element i = b * m + e hashes
// the 64-bit counter (i >> 32, i & 0xFFFFFFFF) and keeps x0 ^ x1, so each
// element is independent and no (B, m) float draw is ever stored.  A
// launch may compute a row block [row0, row0 + rows) of the (B, m) draw
// (a theta shard's rows of a mesh batch): its counters start at row0 * m
// and its output holds just the block.  Bound
// by operations: 20 rounds of add/rotate/xor plus key injection is ~80
// 32-bit ALU operations per element against one byte written.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define ROUND(r)        \
  x0 += x1;             \
  x1 = rotl32(x1, r);   \
  x1 ^= x0;

__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t hi, uint32_t lo) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = hi + k0, x1 = lo + k1;
  ROUND(13) ROUND(15) ROUND(26) ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  ROUND(17) ROUND(29) ROUND(16) ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  ROUND(13) ROUND(15) ROUND(26) ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  ROUND(17) ROUND(29) ROUND(16) ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  ROUND(13) ROUND(15) ROUND(26) ROUND(6)
  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

#undef ROUND

__global__ void __launch_bounds__(kThreads)
ic_sparse_hits_kernel(uint32_t k0, uint32_t k1,
                      const float* __restrict__ prob,
                      uint8_t* __restrict__ out, int64_t m, int64_t row0) {
  const uint64_t row = (uint64_t)blockIdx.y * (uint64_t)m;
  const uint64_t base = (uint64_t)(row0 + blockIdx.y) * (uint64_t)m;
  for (int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x; e < m;
       e += (int64_t)gridDim.x * kThreads) {
    const uint64_t i = base + (uint64_t)e;
    const uint32_t bits =
        threefry_bits(k0, k1, (uint32_t)(i >> 32), (uint32_t)i);
    // jax's _uniform: 23 mantissa bits in [1, 2), minus 1 (exact)
    const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
    out[row + (uint64_t)e] = u < __ldg(prob + e) ? 1 : 0;
  }
}

// uniform_draw: the float32 draw jax.random.uniform(key, shape) itself,
// element i = the same bits as above for counter i, for the positional
// coins of the dense and pallas backends (the (B, n) draw of
// src/repro/core/sampler.py:_dense_loop; no Pallas kernel either), for the
// flat elements [start, start + count) of the draw.  Bound by operations
// (~80 per element) against 4 bytes written each.
__global__ void __launch_bounds__(kThreads)
uniform_kernel(uint32_t k0, uint32_t k1, float* __restrict__ out,
               int64_t count, int64_t start) {
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < count;
       i += (int64_t)gridDim.x * kThreads) {
    const uint64_t c = (uint64_t)(start + i);
    const uint32_t bits =
        threefry_bits(k0, k1, (uint32_t)(c >> 32), (uint32_t)c);
    out[i] = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  }
}

}  // namespace

extern "C" int repro_uniform(uint32_t k0, uint32_t k1, void* out,
                             long long count, long long start,
                             void* stream) {
  if (count <= 0) return 0;
  const long long blocks = (count + kThreads - 1) / kThreads;
  uniform_kernel<<<(unsigned)(blocks < (1LL << 20) ? blocks : (1LL << 20)),
                   kThreads, 0, (cudaStream_t)stream>>>(
      k0, k1, (float*)out, (int64_t)count, (int64_t)start);
  return (int)cudaGetLastError();
}

extern "C" int repro_ic_sparse_hits(uint32_t k0, uint32_t k1,
                                    const void* prob, void* out,
                                    long long m, int rows, long long row0,
                                    void* stream) {
  if (m <= 0 || rows <= 0) return 0;
  const long long blocks = (m + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)(blocks < (1LL << 20) ? blocks : (1LL << 20)),
                  (unsigned)rows);
  ic_sparse_hits_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      k0, k1, (const float*)prob, (uint8_t*)out, (int64_t)m,
      (int64_t)row0);
  return (int)cudaGetLastError();
}
