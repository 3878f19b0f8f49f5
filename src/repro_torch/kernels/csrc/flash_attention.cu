// flash_attention: causal grouped-query attention with an online softmax
// and an optional sliding window, q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D)
// -> (B, Hq, Sq, D), float32 only.  Replaces the TPU kernel
// src/repro/kernels/flash_attention.py: flash_attention (_kernel) for f32,
// written from the math, not block by block; bf16 runs on the tensor cores
// (csrc/flash_attention_tc.cu).  f32 stays here, on SIMT FMAs: the tensor
// cores would round its operands to TF32, outside the f32 contract (1e-4,
// and f32 greedy tokens equal to the reference's).
//
// Function: scale 1/sqrt(D); query i sits at absolute position
// i + Skv - Sq; key j is admitted when j < Skv, j <= qpos (causal) and
// j > qpos - window (window > 0); query head h reads KV head h / (Hq/Hkv)
// in place.  All arithmetic in f32.  Rows with no admitted key (causal
// and Sq > Skv) are refused by the wrapper (kernels/flash_attention.py),
// so l > 0 here.
//
// Bound on an H100: operations.  Each admitted (q, k) pair costs 4 D
// flops (2 D for q.k, 2 D for p.v); a (b, h) has Sq(Sq+1)/2 pairs causal
// and sum_i min(i+1, W) with a window W.  At the f32 rate of 67 TFLOP/s
// outside the tensor cores that is 33 ms at B 1 x 16 heads x S 32,768 x
// D 64; the bytes (q, k, v read once, out written once) take 0.08 ms at
// 3.35 TB/s.
//
// Design, right and simple first: one block of 256 threads per
// (b * Hq + h, 64-query tile), heaviest causal tiles first.  The block
// walks its 64-key tiles in ascending order from the first tile the
// window admits to the last one causality admits; a tile outside that
// range holds no admitted pair, so skipping it adds nothing, as alpha = 0
// erases it on the TPU.  Q (once), K and V tiles are staged in shared
// memory as f32 with 16-byte loads; the running (m, l, acc) stay in
// registers.  Thread (ty, tx) of the 16 x 16 grid owns query rows
// ty + 16 i (i < 4) and, for q.k, keys tx + 16 j (j < 4); for p.v, the
// float4 column groups 4 tx + 64 g (g < DM / 64).  Both products are SIMT
// f32 FMAs from 16-byte shared-memory loads (64 FMAs per 8 loads).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTq = 64;            // queries per block
constexpr int kTk = 64;            // keys per shared-memory stage
constexpr int kPStride = kTk + 4;  // P row stride (floats), 16-byte rows

__device__ __forceinline__ void stage16(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}

__device__ __forceinline__ void zero16(float* dst, int n) {
  for (int i = 0; i < n; i += 4)
    *reinterpret_cast<float4*>(dst + i) = make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}

// max / sum over the 16 lanes (tx) that share a query row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int DM>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(kTq * (DM + 4) + kTk * (DM + 4) + kTk * DM + kTq * kPStride);
}

template <int DM>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int Hq,
             int Hkv, int Sq, int Skv, int D, int causal, int window,
             float scale) {
  constexpr int KS = DM + 4;          // Q and K row stride (floats)
  constexpr int NG = DM / 64;         // float4 column groups a thread owns
  constexpr int EPC = 4;              // floats in a 16-byte chunk
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kTq * KS;
  float* Vs = Ks + kTk * KS;
  float* Ps = Vs + kTk * DM;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTq;
  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq;
  const int off = Skv - Sq;
  const int64_t kv_head = (int64_t)b * Hkv + h / (Hq / Hkv);
  const float* qb = q + (int64_t)bh * Sq * D;
  const float* kb = k + kv_head * Skv * D;
  const float* vb = v + kv_head * Skv * D;
  float* ob = out + (int64_t)bh * Sq * D;
  const int cpr = D / EPC;            // 16-byte chunks in a row

  // zero Q, K and V once: the pad columns [D, DM) and the pad query rows
  // stay zero, so they add nothing to either product
  for (int i = tid; i < kTq * KS + kTk * KS + kTk * DM; i += kThreads)
    Qs[i] = 0.f;
  __syncthreads();
  for (int e = tid; e < kTq * cpr; e += kThreads) {
    const int r = e / cpr, c = (e % cpr) * EPC;
    if (q0 + r < Sq) stage16(qb + (int64_t)(q0 + r) * D + c, Qs + r * KS + c);
  }

  const int qlo = q0 + off;
  const int qhi = min(q0 + kTq, Sq) - 1 + off;
  const int k_last = causal ? min(Skv - 1, qhi) : Skv - 1;
  const int k_first = window > 0 ? max(0, qlo - window + 1) : 0;

  float m[4], l[4], acc[4][NG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][g][c] = 0.f;
  }

  for (int kt = k_first / kTk; k_last >= 0 && kt <= k_last / kTk; ++kt) {
    const int k0 = kt * kTk;
    __syncthreads();  // the last tile's readers are done with Ks, Vs, Ps
    for (int e = tid; e < kTk * cpr; e += kThreads) {
      const int r = e / cpr, c = (e % cpr) * EPC;
      if (k0 + r < Skv) {
        stage16(kb + (int64_t)(k0 + r) * D + c, Ks + r * KS + c);
        stage16(vb + (int64_t)(k0 + r) * D + c, Vs + r * DM + c);
      } else {  // past Skv: zeros, so p = 0 meets a finite v
        zero16(Ks + r * KS + c, EPC);
        zero16(Vs + r * DM + c, EPC);
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DM; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * KS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * KS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i + off;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < Skv && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      // a row with nothing admitted so far keeps p = 0 and acc = 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_use);
        rs += s[i][j];
        Ps[(ty + 16 * i) * kPStride + tx + 16 * j] = s[i][j];
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][g][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kTk; kk += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * kPStride
                                                 + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(
              Vs + (kk + u) * DM + 64 * g + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = u == 0 ? p4[i].x : u == 1 ? p4[i].y
                          : u == 2 ? p4[i].z : p4[i].w;
            acc[i][g][0] = fmaf(p, vv.x, acc[i][g][0]);
            acc[i][g][1] = fmaf(p, vv.y, acc[i][g][1]);
            acc[i][g][2] = fmaf(p, vv.z, acc[i][g][2]);
            acc[i][g][3] = fmaf(p, vv.w, acc[i][g][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int c = 64 * g + 4 * tx;
      if (c >= D) continue;
      store4(ob + (int64_t)r * D + c,
             make_float4(acc[i][g][0] / l[i], acc[i][g][1] / l[i],
                         acc[i][g][2] / l[i], acc[i][g][3] / l[i]));
    }
  }
}

template <int DM>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int Sq, int Skv, int D, int causal, int window,
           float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DM>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<DM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Sq + kTq - 1) / kTq), (unsigned)(B * Hq));
  flash_kernel<DM><<<grid, kThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, Hq,
      Hkv, Sq, Skv, D, causal, window, scale);
  return (int)cudaGetLastError();
}

int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int Hq, int Hkv, int Sq, int Skv, int D, int causal, int window,
             float scale, cudaStream_t stream) {
  if (D <= 64)
    return launch<64>(q, k, v, out, B, Hq, Hkv, Sq, Skv, D, causal, window,
                      scale, stream);
  if (D <= 128)
    return launch<128>(q, k, v, out, B, Hq, Hkv, Sq, Skv, D, causal,
                       window, scale, stream);
  return launch<256>(q, k, v, out, B, Hq, Hkv, Sq, Skv, D, causal, window,
                     scale, stream);
}

}  // namespace

// Contiguous (B, H, S, D) float32 operands on 16-byte boundaries, D a
// multiple of 8 up to 256, Hq a multiple of Hkv (the wrapper checks all of
// these).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int batch,
                                     int hq, int hkv, int sq, int skv, int d,
                                     int causal, int window, float scale,
                                     void* stream) {
  if (batch <= 0 || sq <= 0) return 0;
  if (d <= 0 || d > 256 || d % 8 != 0 || hkv <= 0 || hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  return launch_d(q, k, v, out, batch, hq, hkv, sq, skv, d, causal, window,
                  scale, (cudaStream_t)stream);
}
