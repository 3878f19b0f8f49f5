// fm_interaction: the FM 2-way term (Rendle, ICDM'10) by the sum-square
// trick, out[b] = sum_k 0.5 * ((sum_f v[b,f,k])^2 - sum_f v[b,f,k]^2), for a
// contiguous (B, F, K) float32 or bfloat16 batch -> (B,) float32.  Replaces
// the TPU kernel src/repro/kernels/fm_interaction.py: fm_interaction
// (_kernel), which reads its batch tile once and keeps both field sums out
// of device memory; this kernel does the same.  A second entry point,
// repro_fm_gather_interaction (below), fuses the embedding gathers in front
// of it: the FM logit of a request batch from its ids in one launch.
//
// Contract: the order of summation and every rounding are fixed, so the
// plain PyTorch version (kernels/fm_interaction.py) gives the same bits.
// Inputs are read as float32.  For each (b, k): s = sum of v[b, f, k] and
// s2 = sum of v[b, f, k] * v[b, f, k] over f = 0..F-1 in order, each from
// +0.0; t_k = 0.5 * (s * s - s2), one rounding per operation; out[b] = the
// sum of t_k over k = 0..K-1 in order, from +0.0.  The _rn intrinsics keep
// nvcc from contracting a multiply and an add into an FMA.
//
// Bound on an H100: bytes, B * F * K * itemsize read once and 4 B written
// (410 MB at B 262,144 x 39 x 10 f32, 0.122 ms at 3.35 TB/s); the
// 3 F K + 4 K operations a row are far below that.  Design: a block of 256 threads
// owns R consecutive rows (R * K <= 256, and the rows' floats within
// 48 KB of shared memory: R = 25 at F 39, K 10).  The R rows are one
// contiguous span, loaded with coalesced reads into shared memory as
// float32; then thread (r, k) walks f for its two sums, and thread r adds
// its row's K terms.  Vector loads, more rows in flight and a warp per
// row are later work.
//
// fm_gather_interaction: logit[b] = b + sum_f w[row] + the pair term of
// the rows v[row], row = idx[b, f] + f * V, for ids idx (B, F) int32 or
// int64 and a table v (n, K), w (n,), b () of one dtype, float32 or
// bfloat16 -> (B,) float32.  The ids follow jnp.take: a row in [-n, 0)
// wraps to row + n, a row outside [-n, n) makes its batch row's logit NaN
// (0x7fc00000) while the others are served.  The pair term is the contract
// above on the gathered rows.  The linear term lin sums w[row] as float32
// over f = 0..F-1 in order from +0.0; then the rounding of PyTorch's dtype
// promotion in the model's b + w.sum(-1) + pair: in float32
// (b + lin) + pair; in bfloat16 f32(bf16(b + f32(bf16(lin)))) + pair, each
// bf16() a round to nearest even.
//
// Bound on an H100 (serve_bulk, B 262,144 x F 39, K 10): the ids, the v
// and w rows and b read once, 4 B a row written: 262,144 x 39 x (4 + 40 +
// 4) + 4 x 262,144 = 491,782,144 B in f32 with int32 ids, 0.147 ms at
// 3.35 TB/s; 266,862,592 B (0.080 ms) in bf16.  The gathers are random, so
// a 40-byte row touches two 32-byte sectors and a w entry one: moving no
// less than ~1.02 GB (f32) or ~0.86 GB (bf16) of sectors, ~0.306 ms and
// ~0.257 ms.  At serve_p99 (B 512) 960,512 B, 0.29 us: a launch's fixed
// cost sets the time.  Design: a persistent grid (the occupancy's blocks
// a SM over the SMs) whose blocks walk tiles of R batch rows (R K <= 256).
// A block reads a tile's R x F ids with coalesced loads, turns them into
// wrapped row ids in shared memory (-1 where out of range), and each
// thread issues cp.async copies of the v and w rows of the ids it read,
// in the table's own dtype, into a ring of three shared-memory stages:
// tiles t + 1 and t + 2 are in flight while tile t is reduced.  A copy is the
// widest granule (16, 8 or 4 B) that divides the row's bytes and the
// table's alignment; a row that is not 4-byte aligned (bfloat16 with K
// odd) is copied as the aligned 4-byte words that cover it, and read at
// its offset in them.  Thread (r, k) walks f over shared memory (laid out
// field-major, so a warp reads neighbouring rows), thread r adds its K
// terms and its F weights and writes one float.  No (B, F, K) tensor, no
// int64 row tensor and no float32 copy of a bfloat16 table reach device
// memory.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kSharedBytes = 48 * 1024;   // no opt-in above the default

__device__ __forceinline__ float as_f32(float x) { return x; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fm_interaction_kernel(const T* __restrict__ v, float* __restrict__ out,
                      int batch, int F, int K, int rows_per_block) {
  extern __shared__ float smem[];
  const int row_len = F * K;
  float* v_s = smem;                               // R x F x K
  float* t_s = smem + rows_per_block * row_len;    // R x K
  const int64_t row0 = (int64_t)blockIdx.x * rows_per_block;
  const int rows = (int)min((int64_t)rows_per_block, (int64_t)batch - row0);

  const T* src = v + row0 * row_len;
  const int n = rows * row_len;
  for (int e = threadIdx.x; e < n; e += kThreads) v_s[e] = as_f32(src[e]);
  __syncthreads();

  for (int e = threadIdx.x; e < rows * K; e += kThreads) {
    const int r = e / K, k = e - r * K;
    const float* x = v_s + r * row_len + k;
    float s = 0.0f, s2 = 0.0f;
    for (int f = 0; f < F; ++f) {
      const float a = x[f * K];
      s = __fadd_rn(s, a);
      s2 = __fadd_rn(s2, __fmul_rn(a, a));
    }
    t_s[e] = __fmul_rn(0.5f, __fsub_rn(__fmul_rn(s, s), s2));
  }
  __syncthreads();

  for (int r = threadIdx.x; r < rows; r += kThreads) {
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) acc = __fadd_rn(acc, t_s[r * K + k]);
    out[row0 + r] = acc;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a row that does not fit the block.
extern "C" int repro_fm_interaction(const void* v, int dtype, void* out,
                                    int batch, int F, int K, void* stream) {
  if (batch <= 0) return 0;
  const int row_bytes = 4 * K * (F + 1);
  if (F <= 0 || K <= 0 || K > kThreads || row_bytes > kSharedBytes)
    return (int)cudaErrorInvalidValue;
  int rows = kThreads / K;
  if (rows > kSharedBytes / row_bytes) rows = kSharedBytes / row_bytes;
  const size_t smem = (size_t)rows * row_bytes;
  const unsigned grid = (unsigned)(((long long)batch + rows - 1) / rows);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    fm_interaction_kernel<float><<<grid, kThreads, smem, st>>>(
        (const float*)v, (float*)out, batch, F, K, rows);
  else
    fm_interaction_kernel<__nv_bfloat16><<<grid, kThreads, smem, st>>>(
        (const __nv_bfloat16*)v, (float*)out, batch, F, K, rows);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------- fm_gather_interaction

namespace {

constexpr int kStages = 3;                 // the ring: tiles in flight + 1
constexpr int kMaxSmem = 232448;           // 227 KB, Hopper's opt-in limit
constexpr unsigned kNanBits = 0x7fc00000u; // the NaN PyTorch's fill writes

// Where a tile's arrays sit in a stage, and how a v row is copied.
struct GatherLayout {
  int rows;         // R batch rows a tile
  int slot;         // bytes of shared memory a gathered v row takes
  int chunks;       // copies of `granule` bytes a v row (0 when covered)
  int cover;        // 1: copy the aligned 4-byte words covering the row
  int w_off;        // byte offset of the R x F w words in a stage
  int r_off;        // byte offset of the R x F int64 row ids in a stage
  int stage_bytes;  // one stage; the ring is kStages of them
  int t_off;        // byte offset of the R x K pair terms, after the ring
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "n"(kBytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// bias + lin + pair with the roundings of PyTorch's promotion in the
// model (see the note at the top of the file)
template <typename T>
__device__ __forceinline__ float fm_logit(float bias, float lin, float pair) {
  if constexpr (std::is_same_v<T, float>) {
    return __fadd_rn(__fadd_rn(bias, lin), pair);
  } else {
    const float lb = __bfloat162float(__float2bfloat16_rn(lin));
    const float base =
        __bfloat162float(__float2bfloat16_rn(__fadd_rn(bias, lb)));
    return __fadd_rn(base, pair);
  }
}

// T the table's dtype, I the ids', kGranule the bytes of a v row copy
template <typename T, typename I, int kGranule>
__global__ void __launch_bounds__(kThreads)
fm_gather_kernel(const I* __restrict__ idx, const T* __restrict__ v,
                 const T* __restrict__ w, const T* __restrict__ bias,
                 float* __restrict__ out, int batch, int F, int K,
                 long long V, long long n, GatherLayout L) {
  extern __shared__ __align__(16) unsigned char ring[];
  const int tid = threadIdx.x;
  const int R = L.rows;
  const int rb = K * (int)sizeof(T);
  const int tiles = (int)(((long long)batch + R - 1) / R);
  const int mine = (int)blockIdx.x < tiles
                       ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  float* t_s = reinterpret_cast<float*>(ring + L.t_off);
  const float b32 = as_f32(bias[0]);

  // ids of the block's i-th tile -> row ids (field-major: slot f * R + r),
  // then the cp.async copies of their v and w rows, all into stage i % S
  auto issue = [&](int i) {
    const long long r0 = (long long)(blockIdx.x + i * gridDim.x) * R;
    const int rows = (int)min((long long)R, (long long)batch - r0);
    unsigned char* st = ring + (i % kStages) * L.stage_bytes;
    unsigned char* v_s = st;
    unsigned char* w_s = st + L.w_off;
    long long* r_s = reinterpret_cast<long long*>(st + L.r_off);
    const I* src = idx + r0 * F;
    const int count = rows * F;
    for (int e = tid; e < count; e += kThreads) {
      const int r = e / F, f = e - r * F;
      const long long row = (long long)((unsigned long long)(long long)src[e]
                                        + (unsigned long long)f
                                              * (unsigned long long)V);
      r_s[f * R + r] = row < -n || row >= n ? -1 : (row < 0 ? row + n : row);
    }
    // a thread copies the rows of the ids it read: no barrier between
    for (int e = tid; e < count; e += kThreads) {
      const int r = e / F, f = e - r * F, j = f * R + r;
      const long long row = r_s[j];
      if (row < 0) continue;
      const char* vrow = reinterpret_cast<const char*>(v) + row * rb;
      unsigned char* dst = v_s + j * L.slot;
      if (L.cover) {
        const uintptr_t first = (uintptr_t)vrow & ~(uintptr_t)3;
        const uintptr_t end = ((uintptr_t)vrow + rb + 3) & ~(uintptr_t)3;
        for (uintptr_t a = first; a < end; a += 4, dst += 4)
          cp_async<4>(dst, reinterpret_cast<const void*>(a));
      } else {
        for (int q = 0; q < L.chunks; ++q)
          cp_async<kGranule>(dst + q * kGranule, vrow + q * kGranule);
      }
      const uintptr_t wa = (uintptr_t)(w + row);
      cp_async<4>(w_s + 4 * j, reinterpret_cast<const void*>(
                                   wa & ~(uintptr_t)3));
    }
  };

  auto reduce = [&](int i) {
    const long long r0 = (long long)(blockIdx.x + i * gridDim.x) * R;
    const int rows = (int)min((long long)R, (long long)batch - r0);
    const unsigned char* st = ring + (i % kStages) * L.stage_bytes;
    const unsigned char* v_s = st;
    const unsigned char* w_s = st + L.w_off;
    const long long* r_s = reinterpret_cast<const long long*>(st + L.r_off);
    for (int e = tid; e < rows * K; e += kThreads) {
      const int r = e / K, k = e - r * K;
      float s = 0.0f, s2 = 0.0f;
      for (int f = 0; f < F; ++f) {
        const int j = f * R + r;
        int off = j * L.slot + k * (int)sizeof(T);
        if (L.cover && r_s[j] >= 0)
          off += (int)(((uintptr_t)v + r_s[j] * rb) & 3);
        const float a = as_f32(*reinterpret_cast<const T*>(v_s + off));
        s = __fadd_rn(s, a);
        s2 = __fadd_rn(s2, __fmul_rn(a, a));
      }
      t_s[e] = __fmul_rn(0.5f, __fsub_rn(__fmul_rn(s, s), s2));
    }
    __syncthreads();
    for (int r = tid; r < rows; r += kThreads) {
      float pair = 0.0f;
      for (int k = 0; k < K; ++k) pair = __fadd_rn(pair, t_s[r * K + k]);
      float lin = 0.0f;
      bool bad = false;
      for (int f = 0; f < F; ++f) {
        const int j = f * R + r;
        const long long row = r_s[j];
        bad |= row < 0;
        const int half = row < 0 ? 0 : (int)(((uintptr_t)(w + row)) & 3);
        lin = __fadd_rn(lin, as_f32(*reinterpret_cast<const T*>(
                                 w_s + 4 * j + half)));
      }
      out[r0 + r] = bad ? __uint_as_float(kNanBits)
                        : fm_logit<T>(b32, lin, pair);
    }
  };

  for (int p = 0; p < kStages - 1; ++p) {
    if (p < mine) issue(p);
    cp_async_commit();
  }
  for (int i = 0; i < mine; ++i) {
    if (i + kStages - 1 < mine) issue(i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();   // tile i's copies (this thread's) landed
    __syncthreads();                // ... and every other thread's
    reduce(i);
    __syncthreads();                // stage i % S is free for tile i + S
  }
}

constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// The layout of an R-row tile; its shared memory in *smem
GatherLayout gather_layout(int R, int F, int K, int itemsize, int granule,
                           int cover, size_t* smem) {
  GatherLayout L;
  const int rb = K * itemsize;
  L.rows = R;
  L.cover = cover;
  L.slot = cover ? (rb + 3) / 4 * 4 + 4 : rb;
  L.chunks = cover ? 0 : rb / granule;
  L.w_off = round16(R * F * L.slot);
  L.r_off = round16(L.w_off + R * F * 4);
  L.stage_bytes = round16(L.r_off + R * F * 8);
  L.t_off = kStages * L.stage_bytes;
  *smem = (size_t)L.t_off + (size_t)R * K * 4;
  return L;
}

template <typename T, typename I, int kGranule>
int launch_gather(const void* idx, const void* v, const void* w,
                  const void* bias, void* out, int batch, int F, int K,
                  long long V, long long n, int cover, cudaStream_t st) {
  const auto kernel = fm_gather_kernel<T, I, kGranule>;
  constexpr int kMaxDevices = 64;
  static int sms_of[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int sms = dev < kMaxDevices ? sms_of[dev] : 0;
  if (sms == 0) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) sms_of[dev] = sms;
  }
  // R K <= 256 threads, no more rows than spread the batch over the SMs,
  // and the ring within the block's shared memory
  int R = K > 0 ? kThreads / K : kThreads;
  const long long spread = ((long long)batch + sms - 1) / sms;
  if (spread < R) R = (int)spread;
  size_t smem = 0;
  GatherLayout L = gather_layout(R, F, K, (int)sizeof(T), kGranule, cover,
                                 &smem);
  while (smem > (size_t)kMaxSmem && R > 1)
    L = gather_layout(--R, F, K, (int)sizeof(T), kGranule, cover, &smem);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  // the occupancy's blocks a SM, for the last shared-memory size asked
  static size_t last_smem[kMaxDevices] = {};
  static int last_blocks[kMaxDevices] = {};
  int per_sm = 0;
  if (dev < kMaxDevices && last_smem[dev] == smem && last_blocks[dev] > 0) {
    per_sm = last_blocks[dev];
  } else {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, kThreads, smem) != cudaSuccess || per_sm < 1)
      per_sm = 1;
    if (dev < kMaxDevices) {
      last_smem[dev] = smem;
      last_blocks[dev] = per_sm;
    }
  }
  const long long tiles = ((long long)batch + R - 1) / R;
  const long long slots = (long long)per_sm * sms;
  const unsigned grid = (unsigned)(tiles < slots ? tiles : slots);
  fm_gather_kernel<T, I, kGranule><<<grid, kThreads, smem, st>>>(
      (const I*)idx, (const T*)v, (const T*)w, (const T*)bias, (float*)out,
      batch, F, K, V, n, L);
  return (int)cudaGetLastError();
}

template <typename T, typename I>
int launch_gather_granule(const void* idx, const void* v, const void* w,
                          const void* bias, void* out, int batch, int F,
                          int K, long long V, long long n, cudaStream_t st) {
  const int rb = K * (int)sizeof(T);
  const uintptr_t base = (uintptr_t)v;
  if (rb % 16 == 0 && base % 16 == 0)
    return launch_gather<T, I, 16>(idx, v, w, bias, out, batch, F, K, V, n,
                                   0, st);
  if (rb % 8 == 0 && base % 8 == 0)
    return launch_gather<T, I, 8>(idx, v, w, bias, out, batch, F, K, V, n, 0,
                                  st);
  const int cover = rb % 4 != 0 || base % 4 != 0;
  return launch_gather<T, I, 4>(idx, v, w, bias, out, batch, F, K, V, n,
                                cover, st);
}

}  // namespace

// idx (B, F) contiguous ids, idx_dtype 0 int32, 1 int64; v (n, K), w (n,)
// and bias () contiguous, dtype 0 float32, 1 bfloat16; out (B,) float32.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for what the kernel does not take (K > 256, B >= 2^31, an R = 1 tile's
// ring beyond 227 KB of shared memory).
extern "C" int repro_fm_gather_interaction(const void* idx, int idx_dtype,
                                           const void* v, const void* w,
                                           const void* bias, int dtype,
                                           void* out, long long batch,
                                           int F, int K, long long V,
                                           long long n, void* stream) {
  if (batch <= 0) return 0;
  if (batch >= (1LL << 31) || F < 0 || K < 0 || K > kThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int B = (int)batch;
  if (dtype == 0)
    return idx_dtype == 0
               ? launch_gather_granule<float, int32_t>(idx, v, w, bias, out,
                                                       B, F, K, V, n, st)
               : launch_gather_granule<float, int64_t>(idx, v, w, bias, out,
                                                       B, F, K, V, n, st);
  return idx_dtype == 0
             ? launch_gather_granule<__nv_bfloat16, int32_t>(
                   idx, v, w, bias, out, B, F, K, V, n, st)
             : launch_gather_granule<__nv_bfloat16, int64_t>(
                   idx, v, w, bias, out, B, F, K, V, n, st);
}
