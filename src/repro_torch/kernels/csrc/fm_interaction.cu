// fm_interaction: the FM 2-way term (Rendle, ICDM'10) by the sum-square
// trick, out[b] = sum_k 0.5 * ((sum_f v[b,f,k])^2 - sum_f v[b,f,k]^2), for a
// contiguous (B, F, K) float32 or bfloat16 batch -> (B,) float32.  Replaces
// the TPU kernel src/repro/kernels/fm_interaction.py: fm_interaction
// (_kernel), which reads its batch tile once and keeps both field sums out
// of device memory; this kernel does the same.
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
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
