// flash_attention_bwd: the gradient of the f32 flash_attention on SIMT
// FMAs.  Given q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D), the output's
// cotangent dout (B, Hq, Sq, D), all f32, and each row's logsumexp lse
// (B, Hq, Sq), which the forward (flash_attention.cu) writes for a
// gradient, it writes dq (B, Hq, Sq, D), dk and dv (B, Hkv, Skv, D) in
// f32.  The TPU kernel it differentiates is src/repro/kernels/
// flash_attention.py:72 flash_attention; the reference has no backward
// kernel (JAX differentiates its plain attention), so the function is the
// gradient of the forward's: scale 1/sqrt(D), queries right-aligned to the
// keys, the causal and window mask, query head h on KV head h / (Hq/Hkv),
// dk and dv summed over each KV head's query group.  bf16 runs on the
// tensor cores (flash_attention_bwd_tc.cu); f32 stays here, as the forward
// does: the tensor cores would round f32 operands to TF32.
//
// Math, the plain version's (kernels/flash_attention.py:
// flash_attention_backward_plain): P = exp(S - lse) with S = q k^T scale,
// dV = P^T dO, dP = dO V^T, delta = rowsum(P * dP), dS = P (dP - delta),
// dQ = dS K scale, dK = dS^T Q scale.  All arithmetic in f32.
//
// Bound on an H100: operations.  10 D flops per admitted (q, k) pair for
// the gradient, 18 D as done here (the dQ pass computes S and dP twice,
// once for delta), at the f32 rate of 67 TFLOP/s outside the tensor
// cores.
//
// Design, right and simple first, on the forward's thread layout (a 16 x
// 16 grid of threads, operands staged in shared memory as f32 with 16-byte
// loads, 64-row tiles; 32 at D 256, for shared memory), two launches and
// no atomics, so two calls give the same bits:
// - dQ (first): one block per (b * Hq + h, query tile) keeps Q and dO and
//   walks the key tiles its rows admit twice, in order: S and dP (thread
//   (ty, tx): rows ty + 16 i, keys tx + 16 j) and P; the first walk sums
//   delta (written out for the dK/dV pass), the second puts dS in shared
//   memory and adds dQ += dS K (rows ty + 16 i, float4 column groups 4 tx
//   + 64 g).
// - dK/dV: one block per (b * Hkv + hk, key tile) keeps K and V and walks
//   each query head of the group and the query tiles that admit one of
//   its keys, in order: S^T and dP^T, P^T and dS^T into shared memory,
//   then dV += P^T dO and dK += dS^T Q; the group sum stays in registers.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void stage16(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}

__device__ __forceinline__ void zero16(float* dst) {
  *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float a, float4 x, float (&y)[4]) {
  y[0] = fmaf(a, x.x, y[0]);
  y[1] = fmaf(a, x.y, y[1]);
  y[2] = fmaf(a, x.z, y[2]);
  y[3] = fmaf(a, x.w, y[3]);
}

__device__ __forceinline__ float pick(float4 v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// rows [r0, r0 + T) of a (rows, D) matrix into a T x KS shared tile; rows
// past `rows` are zeros (columns past D were zeroed once and stay so)
template <int T, int KS>
__device__ __forceinline__ void stage_rows(const float* src, float* dst,
                                           int r0, int rows, int D) {
  const int cpr = D / 4;
  for (int e = threadIdx.x; e < T * cpr; e += kThreads) {
    const int r = e / cpr, c = (e % cpr) * 4;
    if (r0 + r < rows)
      stage16(src + (int64_t)(r0 + r) * D + c, dst + r * KS + c);
    else
      zero16(dst + r * KS + c);
  }
}

__device__ __forceinline__ bool admitted(int kp, int qp, int causal,
                                         int window) {
  return (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// sum over the 16 lanes (tx) that share a row
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// DM: the head dim padded to a multiple of 64; T: rows of a tile
template <int DM, int T>
struct Layout {
  static constexpr int KS = DM + 4;     // operand row stride (floats)
  static constexpr int PS = T + 4;      // P / dS row stride (floats)
  static constexpr int RT = T / 16;     // rows a thread owns
  static constexpr int NG = DM / 64;    // float4 column groups a thread owns
  static constexpr size_t DQ_SMEM = sizeof(float) * (4 * T * KS + T * PS);
  static constexpr size_t DKV_SMEM =
      sizeof(float) * (4 * T * KS + 2 * T * PS + 2 * T);
};

template <int DM, int T>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, float* __restrict__ delta,
          float* __restrict__ dq, int Hq, int Hkv, int Sq, int Skv, int D,
          int causal, int window, float scale) {
  using L = Layout<DM, T>;
  constexpr int KS = L::KS, PS = L::PS, RT = L::RT, NG = L::NG;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + T * KS;
  float* Ks = dOs + T * KS;
  float* Vs = Ks + T * KS;
  float* DSs = Vs + T * KS;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x, b = bh / Hq, h = bh % Hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * T;
  const int off = Skv - Sq;
  const int64_t kvh = (int64_t)b * Hkv + h / (Hq / Hkv);
  const float* kb = k + kvh * Skv * D;
  const float* vb = v + kvh * Skv * D;

  for (int i = tid; i < 4 * T * KS; i += kThreads) Qs[i] = 0.f;
  __syncthreads();
  stage_rows<T, KS>(q + (int64_t)bh * Sq * D, Qs, q0, Sq, D);
  stage_rows<T, KS>(dout + (int64_t)bh * Sq * D, dOs, q0, Sq, D);

  // rows past Sq hold zeros: an lse of 0 keeps them finite; dr is this
  // thread's keys' share of delta until the first walk ends
  float lr[RT], dr[RT], acc[RT][NG][4];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = q0 + ty + 16 * i;
    lr[i] = r < Sq ? lse[(int64_t)bh * Sq + r] : 0.f;
    dr[i] = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][g][c] = 0.f;
  }

  const int qlo = q0 + off, qhi = min(q0 + T, Sq) - 1 + off;
  const int k_last = causal ? min(Skv - 1, qhi) : Skv - 1;
  const int k_first = window > 0 ? max(0, qlo - window + 1) : 0;

  // walk 0 sums delta = rowsum(P * dP); walk 1 takes dS and dQ
  const int kt0 = k_first / T, ntiles = k_last / T - kt0 + 1;
  for (int t = 0; t < 2 * ntiles; ++t) {
    const int walk = t / ntiles;
    const int k0 = (kt0 + t % ntiles) * T;
    if (t == ntiles) {
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        dr[i] = row_sum(dr[i]);
        const int r = q0 + ty + 16 * i;
        if (tx == 0 && r < Sq) delta[(int64_t)bh * Sq + r] = dr[i];
      }
    }
    __syncthreads();  // the last tile's readers are done with Ks, Vs, DSs
    stage_rows<T, KS>(kb, Ks, k0, Skv, D);
    stage_rows<T, KS>(vb, Vs, k0, Skv, D);
    __syncthreads();

    float s[RT][RT], dp[RT][RT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DM; d += 4) {
      float4 qv[RT], ov[RT], kv[RT], vv[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        qv[i] = load4(Qs + (ty + 16 * i) * KS + d);
        ov[i] = load4(dOs + (ty + 16 * i) * KS + d);
        kv[i] = load4(Ks + (tx + 16 * i) * KS + d);
        vv[i] = load4(Vs + (tx + 16 * i) * KS + d);
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < RT; ++j) {
          s[i][j] = dot4(qv[i], kv[j], s[i][j]);
          dp[i][j] = dot4(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int qp = q0 + ty + 16 * i + off;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const int kp = k0 + tx + 16 * j;
        const float p = kp < Skv && admitted(kp, qp, causal, window)
                            ? expf(s[i][j] * scale - lr[i]) : 0.f;
        if (walk == 0)
          dr[i] = fmaf(p, dp[i][j], dr[i]);
        else
          DSs[(ty + 16 * i) * PS + tx + 16 * j] = p * (dp[i][j] - dr[i]);
      }
    }
    if (walk == 0) continue;
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < T; kk += 4) {
      float4 d4[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
        d4[i] = load4(DSs + (ty + 16 * i) * PS + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 kv = load4(Ks + (kk + u) * KS + 64 * g + 4 * tx);
#pragma unroll
          for (int i = 0; i < RT; ++i) axpy4(pick(d4[i], u), kv, acc[i][g]);
        }
    }
  }

  float* out = dq + (int64_t)bh * Sq * D;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int c = 64 * g + 4 * tx;
      if (c >= D) continue;
      *reinterpret_cast<float4*>(out + (int64_t)r * D + c) =
          make_float4(acc[i][g][0] * scale, acc[i][g][1] * scale,
                      acc[i][g][2] * scale, acc[i][g][3] * scale);
    }
  }
}

template <int DM, int T>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int Hq, int Hkv,
            int Sq, int Skv, int D, int causal, int window, float scale) {
  using L = Layout<DM, T>;
  constexpr int KS = L::KS, PS = L::PS, RT = L::RT, NG = L::NG;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + T * KS;
  float* Qs = Vs + T * KS;
  float* dOs = Qs + T * KS;
  float* PTs = dOs + T * KS;
  float* DSTs = PTs + T * PS;
  float* lse_s = DSTs + T * PS;
  float* dl_s = lse_s + T;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int kvh = blockIdx.x, b = kvh / Hkv, hk = kvh % Hkv;
  const int group = Hq / Hkv;
  const int k0 = blockIdx.y * T;
  const int off = Skv - Sq;
  // the queries that admit a key of the block, in T tiles
  const int k_hi = min(k0 + T, Skv) - 1;
  const int q_first = causal ? max(0, k0 - off) : 0;
  const int q_last = window > 0 ? min(Sq - 1, k_hi + window - 1 - off)
                                : Sq - 1;
  const int qt0 = q_first / T;
  const int ntq = q_last >= q_first ? q_last / T - qt0 + 1 : 0;

  for (int i = tid; i < 4 * T * KS; i += kThreads) Ks[i] = 0.f;
  __syncthreads();
  stage_rows<T, KS>(k + (int64_t)kvh * Skv * D, Ks, k0, Skv, D);
  stage_rows<T, KS>(v + (int64_t)kvh * Skv * D, Vs, k0, Skv, D);

  float dka[RT][NG][4], dva[RT][NG][4];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) dka[i][g][c] = dva[i][g][c] = 0.f;

  for (int t = 0; t < group * ntq; ++t) {
    const int bh = b * Hq + hk * group + t / ntq;
    const int q0 = (qt0 + t % ntq) * T;
    __syncthreads();  // the last tile's readers are done with Qs .. dl_s
    stage_rows<T, KS>(q + (int64_t)bh * Sq * D, Qs, q0, Sq, D);
    stage_rows<T, KS>(dout + (int64_t)bh * Sq * D, dOs, q0, Sq, D);
    if (tid < T) {
      const bool in = q0 + tid < Sq;
      lse_s[tid] = in ? lse[(int64_t)bh * Sq + q0 + tid] : 0.f;
      dl_s[tid] = in ? delta[(int64_t)bh * Sq + q0 + tid] : 0.f;
    }
    __syncthreads();

    // S^T and dP^T: thread (ty, tx) has keys ty + 16 i, queries tx + 16 j
    float st[RT][RT], dpt[RT][RT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DM; d += 4) {
      float4 kv[RT], vv[RT], qv[RT], ov[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        kv[i] = load4(Ks + (ty + 16 * i) * KS + d);
        vv[i] = load4(Vs + (ty + 16 * i) * KS + d);
        qv[i] = load4(Qs + (tx + 16 * i) * KS + d);
        ov[i] = load4(dOs + (tx + 16 * i) * KS + d);
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < RT; ++j) {
          st[i][j] = dot4(kv[i], qv[j], st[i][j]);
          dpt[i][j] = dot4(vv[i], ov[j], dpt[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int kp = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const int qc = tx + 16 * j, qi = q0 + qc;
        const float p = kp < Skv && qi < Sq &&
                                admitted(kp, qi + off, causal, window)
                            ? expf(st[i][j] * scale - lse_s[qc]) : 0.f;
        PTs[(ty + 16 * i) * PS + qc] = p;
        DSTs[(ty + 16 * i) * PS + qc] = p * (dpt[i][j] - dl_s[qc]);
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q: keys ty + 16 i, columns 4 tx + 64 g
#pragma unroll 2
    for (int kk = 0; kk < T; kk += 4) {
      float4 p4[RT], d4[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        p4[i] = load4(PTs + (ty + 16 * i) * PS + kk);
        d4[i] = load4(DSTs + (ty + 16 * i) * PS + kk);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 ov = load4(dOs + (kk + u) * KS + 64 * g + 4 * tx);
          const float4 qv = load4(Qs + (kk + u) * KS + 64 * g + 4 * tx);
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            axpy4(pick(p4[i], u), ov, dva[i][g]);
            axpy4(pick(d4[i], u), qv, dka[i][g]);
          }
        }
    }
  }

  // a key no query admits gets zeros
  const int64_t base = (int64_t)kvh * Skv * D;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= Skv) continue;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int c = 64 * g + 4 * tx;
      if (c >= D) continue;
      *reinterpret_cast<float4*>(dk + base + (int64_t)r * D + c) =
          make_float4(dka[i][g][0] * scale, dka[i][g][1] * scale,
                      dka[i][g][2] * scale, dka[i][g][3] * scale);
      *reinterpret_cast<float4*>(dv + base + (int64_t)r * D + c) =
          make_float4(dva[i][g][0], dva[i][g][1], dva[i][g][2],
                      dva[i][g][3]);
    }
  }
}

template <int DM, int T>
int launch(const void* q, const void* k, const void* v, const void* lse,
           const void* dout, void* dq, void* dk, void* dv, void* delta, int B,
           int Hq, int Hkv, int Sq, int Skv, int D, int causal, int window,
           float scale, cudaStream_t stream) {
  using L = Layout<DM, T>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<DM, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::DQ_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkdv_kernel<DM, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L::DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  const float *fq = (const float*)q, *fk = (const float*)k,
              *fv = (const float*)v, *fdo = (const float*)dout,
              *flse = (const float*)lse;
  dq_kernel<DM, T><<<dim3((unsigned)(B * Hq), (unsigned)((Sq + T - 1) / T)),
                     kThreads, L::DQ_SMEM, stream>>>(
      fq, fk, fv, fdo, flse, (float*)delta, (float*)dq, Hq, Hkv, Sq, Skv, D,
      causal, window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dkdv_kernel<DM, T><<<dim3((unsigned)(B * Hkv),
                            (unsigned)((Skv + T - 1) / T)),
                       kThreads, L::DKV_SMEM, stream>>>(
      fq, fk, fv, fdo, flse, (const float*)delta, (float*)dk, (float*)dv, Hq,
      Hkv, Sq, Skv, D, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Contiguous (B, H, S, D) float32 operands and gradients on 16-byte
// boundaries, D a multiple of 8 up to 256, Hq a multiple of Hkv, no fully
// masked row; lse (B, Hq, Sq) from the forward and delta (B, Hq, Sq)
// scratch, f32, written by the dQ pass for the dK/dV pass (the wrapper
// checks all of these).  The same arguments as the tensor-core backward's
// (repro_flash_attention_bwd_tc).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* lse,
    const void* dout, void* dq, void* dk, void* dv, void* delta, int batch,
    int hq, int hkv, int sq, int skv, int d, int causal, int window,
    float scale, void* stream) {
  if (batch <= 0 || sq <= 0) return 0;
  if (d <= 0 || d > 256 || d % 8 != 0 || hkv <= 0 || hq % hkv != 0 ||
      skv <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (d <= 64)
    return launch<64, 64>(q, k, v, lse, dout, dq, dk, dv, delta, batch, hq,
                          hkv, sq, skv, d, causal, window, scale, s);
  if (d <= 128)
    return launch<128, 64>(q, k, v, lse, dout, dq, dk, dv, delta, batch, hq,
                           hkv, sq, skv, d, causal, window, scale, s);
  return launch<256, 32>(q, k, v, lse, dout, dq, dk, dv, delta, batch, hq,
                         hkv, sq, skv, d, causal, window, scale, s);
}
