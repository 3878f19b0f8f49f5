// ic_frontier_step: one probabilistic reverse-BFS step of the dense IC
// sampler, new = (rand < -expm1(frontier @ logq)) & ~visited, as a (B, n)
// uint8 block.  Replaces the TPU kernel src/repro/kernels/ic_frontier.py:
// ic_frontier_step (_kernel), written from the math, not block by block:
// the TPU's dense product becomes a gather over logq's nonzeros.
//
// Contract: for each output (b, u), acc is the float32 sum of logq[v, u]
// over frontier[b, v] != 0, in ascending v, one term at a time, from
// +0.0.  A zero logq entry leaves acc unchanged bit for bit, so the walk
// below, over the nonzeros of column u in ascending v (the column form:
// col_ptr, rows, vals, built by kernels/ic_frontier.py:column_form), adding
// q where row b's frontier holds v, is that sum to the bit; the add is
// predicated, never an FMA with a 0/1 float.  Epilogue: p = (float)(
// -expm1((double)acc)), new = rand < p && !visited.  The plain PyTorch
// version walks the same form in the same order and shares the epilogue,
// so the two agree bitwise.  No atomics, no tensor cores, no TF32.
// A meshed BFS hands a column block of logq: n frontier vertices (the
// form's rows) and n_out output columns (its columns); each column's sum
// is the same as in the whole table.
//
// Bound on an H100: bytes, 7 B n (frontier, visited, out one byte a cell,
// rand four) + 8 nnz + 4 (n + 1) (the form) at 3.35 TB/s, against one f32
// add per frontier entry and nonzero of logq's row.  Design: a first
// kernel packs the frontier vertex-major, one 32-bit word a vertex holding
// the bits of 32 batch rows (a warp loads 32 bytes of each row, one row a
// lane, and transposes the 32 x 32 bits with shuffles), so the main kernel
// reads B n / 8 bytes where it would read B n again for every column tile.
// In the main kernel a block of 16 warps owns 32 batch rows (lane = row)
// and a run of output columns, cut so that every block carries about the
// same nonzeros (hub columns of a skewed graph get blocks of their own).
// It copies its rows' packed words into shared memory, in chunks of
// 49,152 vertices when n is larger, acc carried across chunks, and sums
// 128 columns at a time, the warps splitting them by weight too.  A warp
// loads a column's nonzeros 32 at a time, one a lane (the next batch, or
// the next column's first, in flight meanwhile); lane t reads vertex v_t's
// word, a second transpose gives each row-lane its bits over the batch,
// and each lane adds the q_t (broadcast by shuffle) whose bit is set, in
// order.  A batch no row's frontier touches, and a row tile whose
// frontier is empty, add nothing and skip.  The 32 x 128 sums go through
// shared memory, so the epilogue reads rand and visited and writes out
// along rows.  About two blocks a SM run.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kTb = 32;                 // batch rows a block (one a lane)
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kRound = 128;             // output columns a block sums at once
constexpr int kAccLd = kRound + 1;      // padded row of the acc tile
constexpr int kChunkV = 49152;          // frontier vertices staged at once
constexpr int kBlocksPerSm = 2;
constexpr int kNone = 0x7FFFFFFF;       // a lane past its column's end
constexpr int kColW = 16;               // a column's weight, in nonzeros

// the 32 x 32 bit matrix held one row a lane (bit c of lane r), transposed:
// afterwards lane c holds bit r = the old bit c of lane r.  Each stage
// swaps the off-diagonal j x j blocks.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  const uint32_t lo_bits[5] = {0x0000FFFFu, 0x00FF00FFu, 0x0F0F0F0Fu,
                               0x33333333u, 0x55555555u};
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int j = 16 >> s;
    const uint32_t lo = lo_bits[s], hi = ~lo;
    const uint32_t y = __shfl_xor_sync(kFull, x, j);
    x = (lane & j) ? (x & hi) | ((y & hi) >> j) : (x & lo) | ((y & lo) << j);
  }
  return x;
}

// 32 frontier bytes of one row from v0 as bits (bit k = byte v0 + k
// nonzero), none at or past hi
__device__ __forceinline__ uint32_t row_bits(const uint8_t* __restrict__ f,
                                             int v0, int hi, bool aligned) {
  uint32_t m = 0;
  if (aligned && v0 + 32 <= hi) {
    const uint4 a = *reinterpret_cast<const uint4*>(f + v0);
    const uint4 b = *reinterpret_cast<const uint4*>(f + v0 + 16);
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      // one bit a nonzero byte, bytes 0..3 to bits 0..3
      const uint32_t t = __vcmpne4(w[i], 0u) & 0x01010101u;
      m |= ((t * 0x01020408u) >> 24) << (4 * i);
    }
  } else {
    for (int k = 0; k < 32 && v0 + k < hi; ++k)
      m |= (f[v0 + k] != 0 ? 1u : 0u) << k;
  }
  return m;
}

// the frontier packed vertex-major: words[t * ldw + v] bit r is
// frontier[32 t + r, v] != 0, zero for v in [n, ldw).  A warp packs 32
// vertices of one row tile: a lane loads 32 bytes of its row and the warp
// transposes the 32 x 32 bits.  The first block also zeroes the output's
// row padding [n_out, ld_o).
__global__ void __launch_bounds__(256)
pack_frontier_kernel(const uint8_t* __restrict__ frontier, int64_t ld_f,
                     uint32_t* __restrict__ words, int ldw,
                     uint8_t* __restrict__ out, int64_t ld_o, int B, int n,
                     int n_out, int aligned) {
  const int lane = threadIdx.x & 31;
  const int g = 32 * (blockIdx.x * 8 + (threadIdx.x >> 5));
  if (g >= ldw) return;
  const int row = blockIdx.y * kTb + lane;
  const uint32_t m =
      row < B ? row_bits(frontier + (int64_t)row * ld_f, g, n, aligned != 0)
              : 0u;
  const uint32_t w = transpose32(m, lane);       // lane k: vertex g + k
  if (g + lane < ldw) words[(int64_t)blockIdx.y * ldw + g + lane] = w;
  if (g == 0 && row < B)
    for (int64_t c = n_out; c < ld_o; ++c) out[row * ld_o + c] = 0;
}

// copy a row tile's packed words for vertices [lo, lo + span) into fw
// (whole 16-byte groups; ldw and kChunkV are multiples of 4).  Returns
// whether any bit is set.
__device__ __forceinline__ int stage(uint32_t* fw,
                                     const uint32_t* __restrict__ tile,
                                     int lo, int span) {
  const uint4* src = reinterpret_cast<const uint4*>(tile + lo);
  uint4* dst = reinterpret_cast<uint4*>(fw);
  uint32_t any = 0;
  for (int i = threadIdx.x; i < (span + 3) >> 2; i += kThreads) {
    const uint4 x = __ldg(src + i);
    dst[i] = x;
    any |= x.x | x.y | x.z | x.w;
  }
  return __syncthreads_or(any != 0);
}

// a batch of 32 nonzeros of a column from p, one a lane: v relative to
// the chunk's lo, kNone past the column's end
__device__ __forceinline__ void load_batch(const int* __restrict__ rows,
                                           const float* __restrict__ vals,
                                           int p, int end, int lo, int& v,
                                           float& q) {
  const int i = p + (threadIdx.x & 31);
  v = kNone;
  q = 0.0f;
  if (i < end) {
    v = __ldg(rows + i) - lo;
    q = __ldg(vals + i);
  }
}

// the first column u in [0, n] with col_ptr[u] + kColW * u >= target: the
// columns before it carry that much of the work
__device__ __forceinline__ int weighted_bound(const int* __restrict__ col_ptr,
                                              int n, long long target) {
  int a = 0, b = n;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (__ldg(col_ptr + mid) + (long long)kColW * mid < target) a = mid + 1;
    else b = mid;
  }
  return a;
}

__global__ void __launch_bounds__(kThreads)
ic_frontier_kernel(const uint32_t* __restrict__ words, int ldw,
                   const uint8_t* __restrict__ visited, int64_t ld_v,
                   const int* __restrict__ col_ptr,
                   const int* __restrict__ rows,
                   const float* __restrict__ vals,
                   const float* __restrict__ rand, int64_t ld_r,
                   uint8_t* __restrict__ out, int64_t ld_o, int B, int n,
                   int n_out, int fw_words) {
  extern __shared__ uint32_t smem[];
  __shared__ int cols_s[2];                // this block's columns
  __shared__ int ptr_s[kRound + 1];        // col_ptr over the round
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* fw = smem;                                     // fw_words
  float* acc_s = reinterpret_cast<float*>(smem + fw_words);  // kTb x kAccLd
  const int row0 = blockIdx.y * kTb;
  const int nchunks = (n + kChunkV - 1) / kChunkV;
  // blocks split the columns by weight (nonzeros, plus kColW a column),
  // so a block of hub columns is no longer than the others
  if (threadIdx.x < 2) {
    const int x = blockIdx.x + threadIdx.x;
    const long long total =
        __ldg(col_ptr + n_out) + (long long)kColW * n_out;
    cols_s[threadIdx.x] =
        x == 0 ? 0 : x == (int)gridDim.x
                         ? n_out
                         : weighted_bound(col_ptr, n_out,
                                          (total * x + gridDim.x - 1) /
                                              gridDim.x);
  }
  const uint32_t* tile = words + (int64_t)blockIdx.y * ldw;
  int any = 0;
  if (nchunks == 1)
    any = stage(fw, tile, 0, n);
  else
    __syncthreads();
  const int col0 = cols_s[0], col1 = cols_s[1];

  for (int rb = col0; rb < col1; rb += kRound) {
    const int rcols = min(kRound, col1 - rb);
    for (int i = threadIdx.x; i <= rcols; i += kThreads)
      ptr_s[i] = __ldg(col_ptr + rb + i);
    __syncthreads();
    // the warps split the round's columns by weight too, each taking a
    // run of neighbours: [first, last)
    int first, last;
    {
      const int base = ptr_s[0];
      const int total = ptr_s[rcols] - base + kColW * rcols;
      int bounds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int target = (total * (warp + e) + kWarps - 1) / kWarps;
        int a = 0, b = rcols;
        while (a < b) {
          const int mid = (a + b) >> 1;
          if (ptr_s[mid] - base + kColW * mid < target) a = mid + 1;
          else b = mid;
        }
        bounds[e] = a;
      }
      first = bounds[0];
      last = warp == kWarps - 1 ? rcols : bounds[1];
    }
    for (int k = 0; k < nchunks; ++k) {
      const int lo = k * kChunkV, span = min(n, lo + kChunkV) - lo;
      if (nchunks > 1) {
        __syncthreads();                    // the last chunk's reads are done
        any = stage(fw, tile, lo, span);
      }
      for (int c0 = first; c0 < last; c0 += 32) {
        const int ncol = min(32, last - c0);
        // lane j < ncol holds column rb + c0 + j's nonzeros in this chunk
        int my_p = 0, my_end = 0;
        if (lane < ncol) {
          my_p = ptr_s[c0 + lane];
          my_end = ptr_s[c0 + lane + 1];
          if (k > 0) {   // the first nonzero at or past lo
            int b = my_end;
            while (my_p < b) {
              const int mid = (my_p + b) >> 1;
              if (__ldg(rows + mid) < lo) my_p = mid + 1; else b = mid;
            }
          }
        }
        int p = __shfl_sync(kFull, my_p, 0);
        int end = __shfl_sync(kFull, my_end, 0);
        int v;
        float q;
        load_batch(rows, vals, p, end, lo, v, q);
        for (int j = 0; j < ncol; ++j) {
          // the next column's first batch, loaded while this one is summed
          const int pn = __shfl_sync(kFull, my_p, (j + 1) & 31);
          const int en_j = __shfl_sync(kFull, my_end, (j + 1) & 31);
          const int en = j + 1 < ncol ? en_j : pn;
          int vn;
          float qn;
          load_batch(rows, vals, pn, en, lo, vn, qn);
          float* acc_at = acc_s + lane * kAccLd + c0 + j;
          float acc = k == 0 ? 0.0f : *acc_at;
          if (any) {
            for (;;) {
              // rows ascend, so the entries of this chunk are a prefix
              const int cnt = __popc(__ballot_sync(kFull, v < span));
              const bool more = cnt == 32;
              int v2 = kNone;
              float q2 = 0.0f;
              if (more) load_batch(rows, vals, p + 32, end, lo, v2, q2);
              // lane t: the rows whose frontier holds v_t; todo bit t: any
              const uint32_t col = lane < cnt ? fw[v] : 0u;
              const uint32_t todo = __ballot_sync(kFull, col != 0);
              if (todo) {
                // lane = row again: bit t set where its frontier holds v_t
                const uint32_t hit = transpose32(col, lane);
#pragma unroll
                for (int g = 0; g < 32; g += 8) {
                  if ((todo >> g) & 0xFFu) {
                    // eight broadcasts in flight, then eight adds in order
                    float qt[8];
#pragma unroll
                    for (int i = 0; i < 8; ++i)
                      qt[i] = __shfl_sync(kFull, q, g + i);
#pragma unroll
                    for (int i = 0; i < 8; ++i)
                      if ((hit >> (g + i)) & 1u) acc += qt[i];
                  }
                }
              }
              if (!more) break;
              p += 32;
              v = v2;
              q = q2;
            }
          }
          *acc_at = acc;
          p = pn;
          end = en;
          v = vn;
          q = qn;
        }
      }
    }
    __syncthreads();                        // the round's sums are in acc_s
    // epilogue along rows: a warp reads 32 neighbouring columns of a row
#pragma unroll
    for (int e = threadIdx.x; e < kTb * kRound; e += kThreads) {
      const int r = e / kRound, c = e % kRound;
      if (c < rcols && row0 + r < B) {
        const int64_t row = row0 + r;
        const int col = rb + c;
        const float a = acc_s[r * kAccLd + c];
        // -expm1(+0.0) is -0.0: most cells of a sparse step skip the
        // float64 expm1
        const float pr = a == 0.0f ? -0.0f : (float)(-expm1((double)a));
        const bool fire = rand[row * ld_r + col] < pr;
        out[row * ld_o + col] =
            (fire && visited[row * ld_v + col] == 0) ? 1 : 0;
      }
    }
    __syncthreads();                        // before the next round's sums
  }
}

}  // namespace

extern "C" int repro_ic_frontier_step(const void* frontier, long long ld_f,
                                      const void* visited, long long ld_v,
                                      const void* col_ptr, const void* rows,
                                      const void* vals, const void* rand,
                                      long long ld_r, void* out,
                                      long long ld_o, void* words, int ldw,
                                      int batch, int n, int n_out,
                                      void* stream) {
  if (batch <= 0 || n <= 0 || n_out <= 0) return 0;
  // the SM count and the dynamic shared memory allowance are a device's
  // own: read and set once for each device a launch lands on
  constexpr int kMaxDevices = 64;
  static int sms_of[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int sms = dev < kMaxDevices ? sms_of[dev] : 0;
  if (sms == 0) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
    cudaFuncSetAttribute(ic_frontier_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (kChunkV + kTb * kAccLd) * 4);
    if (dev < kMaxDevices) sms_of[dev] = sms;
  }
  const long long row_tiles = (batch + kTb - 1) / kTb;
  const int aligned =
      ((uintptr_t)frontier % 16 == 0) && (ld_f % 16 == 0) ? 1 : 0;
  const dim3 pgrid((unsigned)((ldw + 255) / 256), (unsigned)row_tiles);
  pack_frontier_kernel<<<pgrid, 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)frontier, (int64_t)ld_f, (uint32_t*)words, ldw,
      (uint8_t*)out, (int64_t)ld_o, batch, n, n_out, aligned);
  // about kBlocksPerSm blocks a SM over the grid, a column tile no
  // narrower than 32 columns on average
  const long long widths = (n_out + 31) / 32;
  const long long want =
      (kBlocksPerSm * (long long)sms + row_tiles - 1) / row_tiles;
  const long long col_tiles = want < widths ? want : widths;
  const int fw_words = n < kChunkV ? (n + 3) / 4 * 4 : kChunkV;
  const size_t smem = (size_t)(fw_words + kTb * kAccLd) * 4;
  const dim3 grid((unsigned)col_tiles, (unsigned)row_tiles);
  ic_frontier_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)words, ldw, (const uint8_t*)visited, (int64_t)ld_v,
      (const int*)col_ptr, (const int*)rows, (const float*)vals,
      (const float*)rand, (int64_t)ld_r, (uint8_t*)out, (int64_t)ld_o,
      batch, n, n_out, fw_words);
  return (int)cudaGetLastError();
}
