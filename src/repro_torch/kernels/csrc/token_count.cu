// token_count: counter[v] = sum_t alive[t] * bit_t(v) over a
// (theta, s_pad) int32 token arena (src/repro/core/pack/codec.py
// format: token = block * 512 + code; code < 256 is a literal byte at
// `block`, code 256 a saturated 32-byte run starting at `block`, the
// sentinel block n_blocks_padded * 512 ends a row), exact in int32.
// Replaces the Pallas kernel src/repro/kernels/packed_count.py
// (token_count, _token_kernel).  That kernel compares every token of a
// row with every column of a tile, O(theta * s_pad * n) work; this one
// works from the format instead.  Within a row the literals come first,
// sorted by block (so at most one a block), then the run tokens sorted
// by block, then sentinels; no two tokens of a row set the same bit, so
// the counts add exactly.
//
// Bound on an H100: bytes, the real tokens (up to each row's first
// sentinel) of the alive rows, each read once: 1.17 GB at the kernel
// rows' arena (theta = 16,384, n = 334,863, s_pad = 65,536, every row
// alive), 0.348 ms at 3.35 TB/s; plus the alive mask and the counter.
//
// Design.  The packed bytes are cut into spans of kSpanBytes = 1,024
// (8,192 columns), the spans into G groups and the rows into C chunks; one
// block of 256 threads owns a (group, chunk) pair, two blocks run on each
// SM, and G * C is as many blocks as fit on the card (G = kGroups = 2:
// more groups cost more binary searches, fewer more atomics;
// scripts/count_probe.py times G = 1, 2, 4, 8).  A block keeps, in shared
// memory, each alive row's cursor (its next literal) and the token there
// once read; a group's cursors start with one binary search a row (group 0
// starts at token 0).  For each span of its group the block lists the rows
// whose next literal lies in the span, then takes them 8 at a time, one a
// warp: the warp reads the row's literals of the span with 16-byte loads,
// at most as many tokens as the span has bytes left past the row's next
// literal (8 loads a lane in flight), and scatters them as bytes into its
// 1 KB stage, so the stage holds the row's packed bytes of the span.  Then
// each thread adds its stage word of the 8 rows into its bit-sliced
// carry-save planes (bitslice.cuh), and at the end of the span the planes
// expand into int32 counts in shared memory, which meet the other chunks'
// through one integer atomic a column into `out` (zeros on entry).  No
// offset table and no second pass: each real token is read in the span it
// belongs to, once.  The loads of a segment run on to its read limit, so
// where a row's bytes are sparse they take in tokens of later spans, which
// those spans load again (chip_smoke.py prints the bytes asked for,
// segment_read_bytes, beside the real ones).  The last group's blocks end
// with the run tokens, which start at each row's first non-literal: they
// count runs per superblock in shared memory and add those counts into
// `run_total` (one atomic a superblock a block); a last small kernel adds
// run_total[v >> 8] into every column.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "bitslice.cuh"

namespace {

using repro_torch::kMaxSteps;
using repro_torch::kPlanes;
using repro_torch::kStepRows;

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kShift = 9;          // block = token >> 9
constexpr int kCodeMask = 511;
constexpr int kSat = 256;          // run code; a literal has this bit clear
constexpr int kSuperShift = 5;     // 32 bytes a run superblock
constexpr int kSpanBytes = 1024;
constexpr int kGroups = 2;         // span groups (G)
constexpr int kSpanWords = kSpanBytes / 4;
constexpr int kWarps = kStepRows;  // a batch is one row a warp
constexpr int kThreads = kWarps * 32;
static_assert(kThreads == kSpanWords, "a thread counts one stage word");
constexpr int kVec = 8;            // 16-byte loads a lane a round
constexpr int kRound = 32 * kVec * 4;
constexpr int kMaxRows = 2048;     // rows of a chunk held at a time
constexpr int kSkew = kSpanWords + 1;
constexpr int kCntInts = 32 * kSkew;
constexpr int kUnknown = -1;       // tokens are never negative
constexpr int kPast = INT_MAX;     // a position past the range: never valid

struct Smem {
  uint32_t stage[kWarps][kSpanWords];  // one span of packed bytes a warp
  int cnt[kCntInts];   // a span's counts (column 32w + j at j * 257 + w);
                       // the run phase's per-superblock counts
  int row[kMaxRows];   // alive rows of the chunk
  int cur[kMaxRows];   // each row's cursor
  int nxt[kMaxRows];   // the token at the cursor, or kUnknown
  int act[kMaxRows];   // rows with work in the current span
  int nact;
};

template <bool kVec4>
__device__ __forceinline__ int4 load4(const int* __restrict__ tr, int p,
                                      int limit) {
  int4 v;
  if (kVec4) {
    v = p < limit ? __ldg(reinterpret_cast<const int4*>(tr + p))
                  : make_int4(kPast, kPast, kPast, kPast);
    if (p + 1 >= limit) v.y = kPast;
    if (p + 2 >= limit) v.z = kPast;
    if (p + 3 >= limit) v.w = kPast;
    return v;
  }
  v.x = p < limit ? __ldg(tr + p) : kPast;
  v.y = p + 1 < limit ? __ldg(tr + p + 1) : kPast;
  v.z = p + 2 < limit ? __ldg(tr + p + 2) : kPast;
  v.w = p + 3 < limit ? __ldg(tr + p + 3) : kPast;
  return v;
}

__device__ __forceinline__ int elem(const int4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Append the items i < count with pred(i) to list (in no fixed order)
// and return how many; every thread of the block calls it.
template <typename Pred>
__device__ __forceinline__ int compact(int count, int* list, int* total,
                                       Pred pred) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) *total = 0;
  __syncthreads();
  for (int i0 = 0; i0 < count; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    const bool take = i < count && pred(i);
    const unsigned m = __ballot_sync(kFull, take);
    int at = 0;
    if (lane == 0 && m) at = atomicAdd(total, __popc(m));
    at = __shfl_sync(kFull, at, 0);
    if (take) list[at + __popc(m & ((1u << lane) - 1u))] = i;
  }
  __syncthreads();
  return *total;
}

// One warp: the literals of row `tr` in blocks [b0, b1) from cursor *cur
// (whose token, when known, is *nxt) into the stage bytes `sb`; moves the
// cursor past them and records the token there (kUnknown if not read).
template <bool kVec4>
__device__ void stage_literals(const int* __restrict__ tr, int s_pad, int b0,
                               int b1, int* cur, int* nxt, uint8_t* sb) {
  const int lane = threadIdx.x & 31;
  int c = *cur;
  const int known = *nxt;
  const int lo_blk = known == kUnknown ? b0 : max(b0, known >> kShift);
  // literal blocks are distinct, so the span holds at most b1 - lo_blk
  // of them; one more token shows where the segment ends
  const int limit = (int)min((int64_t)s_pad, (int64_t)c + (b1 - lo_blk) + 1);
  // a literal of the span lies in [tok_lo, tok_lo + tok_len) as a token
  const int tok_lo = b0 << kShift;
  const unsigned tok_len = (unsigned)(b1 - b0) << kShift;
  int base = c & ~3;
  int nx = kUnknown;
  while (true) {
    int4 v[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      v[k] = load4<kVec4>(tr, base + 4 * (32 * k + lane), limit);
    if (lane == 0) {                 // the (at most 3) tokens before c
      if (c - base > 0) v[0].x = kPast;
      if (c - base > 1) v[0].y = kPast;
      if (c - base > 2) v[0].z = kPast;
    }
    int valid = 0;
#pragma unroll
    for (int k = 0; k < kVec; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tok = elem(v[k], e);
        if ((unsigned)(tok - tok_lo) < tok_len && (tok & kSat) == 0) {
          ++valid;
          sb[(tok >> kShift) - b0] = (uint8_t)(tok & 0xFF);
        }
      }
    const int c2 = c + __reduce_add_sync(kFull, valid);
    const int round_end = min(limit, base + kRound);
    if (c2 < round_end) {            // the segment ends in this round
      nx = __ldg(tr + c2);           // just read: from cache
      c = c2;
      break;
    }
    c = c2;
    if (round_end >= limit) break;   // the row's s_pad tokens are read
    base += kRound;
  }
  if (lane == 0) {
    *cur = c;
    *nxt = nx;
  }
}

// One warp: the run tokens of row `tr` from cursor c (its first
// non-literal) into the per-superblock counts of window [w0, w0 + len).
template <bool kVec4>
__device__ void count_runs(const int* __restrict__ tr, int s_pad, int c,
                           int nbp, int w0, int len, int* cnt) {
  const int lane = threadIdx.x & 31;
  int base = c & ~3;
  while (true) {
    int4 v[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      v[k] = load4<kVec4>(tr, base + 4 * (32 * k + lane), s_pad);
    int valid = 0;
#pragma unroll
    for (int k = 0; k < kVec; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = base + 4 * (32 * k + lane) + e;
        const int tok = elem(v[k], e);
        const int blk = tok >> kShift;
        if (p >= c && (tok & kCodeMask) == kSat && blk < nbp) {
          ++valid;
          const int sb = (blk >> kSuperShift) - w0;
          if (sb >= 0 && sb < len) atomicAdd(cnt + sb, 1);
        }
      }
    const int c2 = c + __reduce_add_sync(kFull, valid);
    const int round_end = min(s_pad, base + kRound);
    if (c2 < round_end || round_end >= s_pad) return;
    c = c2;
    base += kRound;
  }
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads, 2)
token_count_kernel(const int* __restrict__ T, int64_t ld,
                   const uint8_t* __restrict__ alive, int theta, int s_pad,
                   int n, int nbp, int groups, int chunks,
                   int* __restrict__ out, int* __restrict__ run_total) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = blockIdx.x % groups, chunk = blockIdx.x / groups;
  const int spans = (nbp + kSpanBytes - 1) / kSpanBytes;
  const int span_lo = (int)((int64_t)spans * g / groups);
  const int span_hi = (int)((int64_t)spans * (g + 1) / groups);
  const int byte_lo = span_lo * kSpanBytes;
  const int r_lo = (int)((int64_t)theta * chunk / chunks);
  const int r_hi = (int)((int64_t)theta * (chunk + 1) / chunks);
  const int word = threadIdx.x;
  uint8_t* sb = reinterpret_cast<uint8_t*>(s.stage[warp]);
  for (int i = threadIdx.x; i < kCntInts; i += kThreads) s.cnt[i] = 0;

  for (int sub = r_lo; sub < r_hi; sub += kMaxRows) {
    const int sub_n = min(kMaxRows, r_hi - sub);
    // this chunk's alive rows, their cursors at the group's first byte
    for (int i = threadIdx.x; i < sub_n; i += kThreads)
      s.act[i] = alive[sub + i];
    __syncthreads();
    const int nrows = compact(sub_n, s.row, &s.nact,
                              [&](int i) { return s.act[i] != 0; });
    for (int i = threadIdx.x; i < nrows; i += kThreads) {
      const int r = sub + s.row[i];
      s.row[i] = r;
      int lo = 0;
      if (byte_lo > 0) {     // first token that is not a literal < byte_lo
        const int* tr = T + (int64_t)r * ld;
        int hi = min(s_pad, byte_lo);
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          const int t = __ldg(tr + mid);
          if ((t & kSat) == 0 && (t >> kShift) < byte_lo) lo = mid + 1;
          else hi = mid;
        }
      }
      s.cur[i] = lo;
      s.nxt[i] = kUnknown;
    }
    __syncthreads();

    for (int span = span_lo; span < span_hi; ++span) {
      const int b0 = span * kSpanBytes;
      const int b1 = min(b0 + kSpanBytes, nbp);
      const int nact = compact(nrows, s.act, &s.nact, [&](int i) {
        const int nx = s.nxt[i];
        return s.cur[i] < s_pad &&
               (nx == kUnknown || ((nx & kSat) == 0 && (nx >> kShift) < b1));
      });
      uint32_t P[kPlanes];
#pragma unroll
      for (int q = 0; q < kPlanes; ++q) P[q] = 0;
      int steps = 0;
      for (int base = 0; base < nact; base += kWarps) {
        uint4* z = reinterpret_cast<uint4*>(s.stage[warp]);
        z[lane] = make_uint4(0u, 0u, 0u, 0u);
        z[lane + 32] = make_uint4(0u, 0u, 0u, 0u);
        __syncwarp();
        if (base + warp < nact) {
          const int i = s.act[base + warp];
          stage_literals<kVec4>(T + (int64_t)s.row[i] * ld, s_pad, b0, b1,
                                &s.cur[i], &s.nxt[i], sb);
        }
        __syncthreads();
        uint32_t x[kStepRows];
#pragma unroll
        for (int r = 0; r < kStepRows; ++r) x[r] = s.stage[r][word];
        repro_torch::add8(P, x);
        if (++steps == kMaxSteps) {
          repro_torch::expand(P, [&](int j, int v) {
            atomicAdd(&s.cnt[j * kSkew + word], v);
          });
          steps = 0;
        }
        __syncthreads();
      }
      if (steps)
        repro_torch::expand(P, [&](int j, int v) {
          atomicAdd(&s.cnt[j * kSkew + word], v);
        });
      __syncthreads();
      for (int c = threadIdx.x; c < kSpanBytes * 8; c += kThreads) {
        const int at = (c & 31) * kSkew + (c >> 5);
        const int v = s.cnt[at];
        s.cnt[at] = 0;
        const int64_t col = (int64_t)b0 * 8 + c;
        if (v && col < n) atomicAdd(out + col, v);
      }
      __syncthreads();
    }

    if (g == groups - 1) {   // the cursors stand at the first non-literal
      const int nsb = nbp >> kSuperShift;
      for (int w0 = 0; w0 < nsb; w0 += kCntInts) {
        const int len = min(kCntInts, nsb - w0);
        for (int i = warp; i < nrows; i += kWarps) {
          const int c = s.cur[i], nx = s.nxt[i];
          if (c < s_pad && (nx == kUnknown || (nx & kCodeMask) == kSat))
            count_runs<kVec4>(T + (int64_t)s.row[i] * ld, s_pad, c, nbp, w0,
                              len, s.cnt);
        }
        __syncthreads();
        for (int x = threadIdx.x; x < len; x += kThreads) {
          const int v = s.cnt[x];
          s.cnt[x] = 0;
          if (v) atomicAdd(run_total + w0 + x, v);
        }
        __syncthreads();
      }
    }
  }
}

// out[v] += run_total[v >> 8]: a run covers its superblock's 256 columns
__global__ void token_runs_kernel(const int* __restrict__ run_total, int n,
                                  int* __restrict__ out) {
  for (int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; c < n;
       c += (int64_t)gridDim.x * blockDim.x) {
    const int r = run_total[c >> 8];
    if (r) out[c] += r;
  }
}

template <bool kVec4>
int resident_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(token_count_kernel<kVec4>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)sizeof(Smem));
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, token_count_kernel<kVec4>, kThreads, sizeof(Smem));
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  return blocks;
}

template <bool kVec4>
int launch(const int* T, int64_t ld, const uint8_t* alive, int theta,
           int s_pad, int n, int nbp, int* out, int* run_total,
           cudaStream_t s) {
  const int spans = (nbp + kSpanBytes - 1) / kSpanBytes;
  const int groups = kGroups < spans ? kGroups : spans;
  int chunks = resident_blocks<kVec4>() / groups;
  chunks = chunks < 1 ? 1 : chunks < theta ? chunks : theta;
  token_count_kernel<kVec4><<<groups * chunks, kThreads, sizeof(Smem), s>>>(
      T, ld, alive, theta, s_pad, n, nbp, groups, chunks, out, run_total);
  return (int)cudaGetLastError();
}

}  // namespace

// T rows hold s_pad tokens with stride ld (in tokens).  out holds n int32
// zeros, run_total nbp / 32 int32 zeros (nbp = ceil(ceil(n / 8) / 32) *
// 32, the padded byte count).
extern "C" int repro_token_count(const void* T, long long ld,
                                 const void* alive, int theta, int s_pad,
                                 int n, void* out, void* run_total,
                                 void* stream) {
  if (n <= 0) return 0;
  const int nb = (n + 7) / 8;
  const int nbp = (nb + 31) / 32 * 32;
  cudaStream_t s = (cudaStream_t)stream;
  if (theta > 0 && s_pad > 0) {
    const bool vec = (uintptr_t)T % 16 == 0 && ld % 4 == 0 && s_pad % 4 == 0;
    const int err =
        vec ? launch<true>((const int*)T, ld, (const uint8_t*)alive, theta,
                           s_pad, n, nbp, (int*)out, (int*)run_total, s)
            : launch<false>((const int*)T, ld, (const uint8_t*)alive, theta,
                            s_pad, n, nbp, (int*)out, (int*)run_total, s);
    if (err != cudaSuccess) return err;
  }
  const int grid = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  token_runs_kernel<<<grid, 256, 0, s>>>((const int*)run_total, n,
                                         (int*)out);
  return (int)cudaGetLastError();
}
