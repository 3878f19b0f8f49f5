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
// so l > 0 here.  For a gradient it also writes each row's logsumexp of
// its scaled scores, natural log (f32, (B, Hq, Sq)), which the backward
// (flash_attention_bwd.cu) reads; with a null pointer it writes none.
//
// Bound on an H100: operations.  Each admitted (q, k) pair costs 4 D
// flops (2 D for q.k, 2 D for p.v); a (b, h) has Sq(Sq+1)/2 pairs causal
// and sum_i min(i+1, W) with a window W.  At the f32 rate of 67 TFLOP/s
// outside the tensor cores that is 2.05 ms at B 1 x 16 heads x S 8,192 x
// D 64; the bytes (q, k, v read once, out written once) take 0.04 ms at
// 3.35 TB/s.  So the design feeds the FMA pipes:
//
// - A 16 x 16 grid of 256 threads; thread (ty, tx) owns query rows
//   ty + 16 i (i < RPT: 8 in a tile of 128 queries, 4 in one of 64) and,
//   for q.k, keys tx + 16 j (j < 4) of each 64-key tile; for p.v, the same
//   rows and the float4 column groups 4 tx + 64 g (g < DM / 64).  A query
//   row lives in one half-warp: its max and sums are shuffles, and P goes
//   through shared memory from the 16 lanes that write it to the same 16
//   lanes that read it.
// - Every operand load is an LDS.128 with no bank conflict beyond the
//   bytes it must bring: Q, K and V rows at stride DM + 4 floats, P rows
//   at 80 (a warp's two rows 16 banks apart; P's stores are scalar, one
//   wavefront each).  At RPT 8, q.k takes 8 Q loads (one wavefront each)
//   and 4 K loads (two) per 128 FFMA, p.v 8 P loads and 4 x NG V loads
//   (two each) per 128 x NG: 8 wavefronts per 64 FFMA a warp at DM 64 (6
//   at DM 128), against 12 for the 4 x 4 tile this design replaced.
// - K and V stream through two 64-key stages filled by cp.async.cg (16
//   bytes a copy; rows past Skv and columns past D written as zeros):
//   K_t waits in stage 0; after the tile's first barrier V_t is issued
//   into stage 1 and lands while q.k runs; after the second, K_t+1 is
//   issued into stage 0 and lands while p.v runs.  Two block barriers a
//   tile.  (Four stages, K and V of two tiles, take one barrier a tile
//   but allow one block an SM at 128 queries: slower on an H100 at 700
//   W, 3.57-3.65 ms against 3.45-3.52 at 1 x 16 x 8,192 x 64.)
// - Only the tiles that straddle the causal diagonal, a window edge or
//   Skv evaluate the mask.  P = 2^(s c - m c) with c = scale log2(e)
//   folded into one FFMA and ex2.approx.ftz (relative error ~2^-22); the
//   row sum stays a per-lane partial until the end; lse = (m c +
//   log2 l) ln 2.
// - One block per (query tile, b * Hq + h), the grid one axis of them,
//   heaviest causal query tiles first across every head; the block walks
//   its 64-key tiles in ascending order from the first the window admits
//   to the last causality admits (a tile outside holds no admitted pair).
//   Every sum runs in a fixed order and nothing is atomic, so two calls
//   give the same bits.
//
// Tiles, chosen by D and Sq (128 queries from Sq 1,024 on, else 64), as
// nvcc builds them for sm_90a (ptxas -v; repro_flash_attention_config
// reports them on the card):
//   D <= 64:  128 queries, 110,592 B of shared memory, 128 registers (56
//             B of stack, 136 B of spill stores), 2 blocks an SM;
//             64 queries, 72,704 B, 128 registers, no spill, 2 blocks;
//   D <= 128: 128 queries, 176,128 B, 254 registers, no spill, 1 block;
//             64 queries, 121,856 B, 186 registers, 1 block;
//   D <= 256: 64 queries, 220,160 B, 254 registers, no spill, 1 block.
// Times on an H100 (700 W): PERF.md §6, from
// scripts/attention_bwd_probe.py --forward.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16: ty rows, tx keys / columns
constexpr int kTk = 64;         // keys a ring stage
constexpr int kPS = kTk + 16;   // P row stride (floats)
constexpr int kWideSq = 1024;   // from this Sq on, 128 queries a block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// RPT query rows a thread (16 RPT a block)
template <int DM_, int RPT_>
struct Tile {
  static constexpr int DM = DM_, RPT = RPT_;
  static constexpr int TQ = 16 * RPT;     // query rows a block
  static constexpr int KS = DM + 4;       // Q, K, V row stride (floats)
  static constexpr int STAGE = kTk * KS;  // floats a ring stage
  static constexpr int NG = DM / 64;      // float4 column groups a thread
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)TQ * KS + 2 * (size_t)STAGE +
                       (size_t)TQ * kPS);
  // two blocks an SM where their shared memory fits
  static constexpr int MIN_BLOCKS = SMEM <= 113 * 1024 ? 2 : 1;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, around L1 and the registers; with n = 0 it
// reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// rows [r0, r0 + ROWS) of a (rows, D) f32 matrix into ROWS rows of
// shared memory at stride DM + 4; rows past `rows` and columns past D
// are zeros, so they add nothing to either product
template <int ROWS, int DM>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int r0, int rows, int D,
                                           int tid) {
  constexpr int CPR = DM / 4, KS = DM + 4;
  static_assert(ROWS * CPR % kThreads == 0, "whole copies a thread");
  const int cpr = D / 4;
#pragma unroll
  for (int n = 0; n < ROWS * CPR / kThreads; ++n) {
    const int e = tid + n * kThreads, r = e / CPR, c = e % CPR;
    const bool ok = r0 + r < rows && c < cpr;
    cp_async16(dst + r * KS + 4 * c,
               ok ? src + (int64_t)(r0 + r) * D + 4 * c : src, ok ? 16 : 0);
  }
}

template <class L>
__global__ void __launch_bounds__(kThreads, L::MIN_BLOCKS)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out,
             float* __restrict__ lse, int Hq, int Hkv, int Sq, int Skv,
             int D, int causal, int window, float scale, int BH, int nqt) {
  constexpr int DM = L::DM, RPT = L::RPT, TQ = L::TQ;
  constexpr int KS = L::KS, STAGE = L::STAGE, NG = L::NG;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + TQ * KS;  // stage 0: K_t, then K_t+1
  float* Vs = Ks + STAGE;    // stage 1: V_t
  float* Ps = Vs + STAGE;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // heaviest query tiles first, across every (b, h)
  const int bh = (int)(blockIdx.x % (unsigned)BH);
  const int q0 = (nqt - 1 - (int)(blockIdx.x / (unsigned)BH)) * TQ;
  const int b = bh / Hq, h = bh % Hq;
  const int off = Skv - Sq;
  const int64_t kv_head = (int64_t)b * Hkv + h / (Hq / Hkv);
  const float* qb = q + (int64_t)bh * Sq * D;
  const float* kb = k + kv_head * Skv * D;
  const float* vb = v + kv_head * Skv * D;
  float* ob = out + (int64_t)bh * Sq * D;

  const int qlo = q0 + off;
  const int qhi = min(q0 + TQ, Sq) - 1 + off;
  const int k_last = causal ? min(Skv - 1, qhi) : Skv - 1;
  const int k_first = window > 0 ? max(0, qlo - window + 1) : 0;
  const int t_first = k_first / kTk;
  const int t_end = k_last >= 0 ? k_last / kTk + 1 : t_first;
  const float c2 = scale * kLog2e;

  // Q and the first tile's K in one group
  stage_rows<TQ, DM>(Qs, qb, q0, Sq, D, tid);
  if (t_first < t_end) stage_rows<kTk, DM>(Ks, kb, t_first * kTk, Skv, D, tid);
  cp_async_commit();

  float m[RPT], l[RPT], acc[RPT][NG][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][g][c] = 0.f;
  }
  const float* qr = Qs + ty * KS;
  float* pr = Ps + ty * kPS;

  for (int t = t_first; t < t_end; ++t) {
    const int k0 = t * kTk;
    cp_async_wait_all();
    __syncthreads();  // K_t staged; every thread done with V_t-1 and P
    stage_rows<kTk, DM>(Vs, vb, k0, Skv, D, tid);  // lands during q.k
    cp_async_commit();

    // S = Q K^T (unscaled) for rows ty + 16 i, keys tx + 16 j
    float s[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    const float* kr = Ks + tx * KS;
#pragma unroll 4
    for (int d = 0; d < DM; d += 4) {
      float4 kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(kr + 16 * j * KS + d);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qr + 16 * i * KS + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
        }
      }
    }

    // the mask, on the tiles that straddle the diagonal, a window edge
    // or Skv only
    const bool edge = !(k0 + kTk <= Skv && (!causal || k0 + kTk - 1 <= qlo)
                        && (window <= 0 || k0 > qhi - window));
    if (edge) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int qpos = q0 + ty + 16 * i + off;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kpos = k0 + tx + 16 * j;
          const bool ok = kpos < Skv && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          if (!ok) s[i][j] = -INFINITY;
        }
      }
    }

    // online softmax: m in unscaled units, P = 2^(s c - m c)
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float mx = row_max(fmaxf(fmaxf(s[i][0], s[i][1]),
                                     fmaxf(s[i][2], s[i][3])));
      const float m_new = fmaxf(m[i], mx);
      // a row with nothing admitted so far keeps p = 0 and acc = 0
      const float mc = (m_new == -INFINITY ? 0.f : m_new) * c2;
      const float alpha = ex2(fmaf(m[i], c2, -mc));
      m[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ex2(fmaf(s[i][j], c2, -mc));
        rs += p;
        pr[16 * i * kPS + tx + 16 * j] = p;
      }
      l[i] = fmaf(l[i], alpha, rs);
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][g][c] *= alpha;
    }

    cp_async_wait_all();
    __syncthreads();  // V_t staged and P written; every thread done with K_t
    if (t + 1 < t_end)  // lands during p.v
      stage_rows<kTk, DM>(Ks, kb, k0 + kTk, Skv, D, tid);
    cp_async_commit();

    // O += P V for rows ty + 16 i, columns 4 tx + 64 g
    const float* vc = Vs + 4 * tx;
#pragma unroll 2
    for (int kk = 0; kk < kTk; kk += 4) {
      float4 vv[4][NG];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int g = 0; g < NG; ++g)
          vv[u][g] =
              *reinterpret_cast<const float4*>(vc + (kk + u) * KS + 64 * g);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(pr + 16 * i * kPS + kk);
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          acc[i][g][0] = fmaf(p4.x, vv[0][g].x, acc[i][g][0]);
          acc[i][g][1] = fmaf(p4.x, vv[0][g].y, acc[i][g][1]);
          acc[i][g][2] = fmaf(p4.x, vv[0][g].z, acc[i][g][2]);
          acc[i][g][3] = fmaf(p4.x, vv[0][g].w, acc[i][g][3]);
          acc[i][g][0] = fmaf(p4.y, vv[1][g].x, acc[i][g][0]);
          acc[i][g][1] = fmaf(p4.y, vv[1][g].y, acc[i][g][1]);
          acc[i][g][2] = fmaf(p4.y, vv[1][g].z, acc[i][g][2]);
          acc[i][g][3] = fmaf(p4.y, vv[1][g].w, acc[i][g][3]);
          acc[i][g][0] = fmaf(p4.z, vv[2][g].x, acc[i][g][0]);
          acc[i][g][1] = fmaf(p4.z, vv[2][g].y, acc[i][g][1]);
          acc[i][g][2] = fmaf(p4.z, vv[2][g].z, acc[i][g][2]);
          acc[i][g][3] = fmaf(p4.z, vv[2][g].w, acc[i][g][3]);
          acc[i][g][0] = fmaf(p4.w, vv[3][g].x, acc[i][g][0]);
          acc[i][g][1] = fmaf(p4.w, vv[3][g].y, acc[i][g][1]);
          acc[i][g][2] = fmaf(p4.w, vv[3][g].z, acc[i][g][2]);
          acc[i][g][3] = fmaf(p4.w, vv[3][g].w, acc[i][g][3]);
        }
      }
    }
  }
  cp_async_wait_all();  // no copy outlives the block

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const float lt = row_sum(l[i]);
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    if (lse != nullptr && tx == 0)
      lse[(int64_t)bh * Sq + r] = fmaf(m[i], c2, log2f(lt)) * kLn2;
    const float inv = 1.f / lt;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int c = 64 * g + 4 * tx;
      if (c >= D) continue;
      *reinterpret_cast<float4*>(ob + (int64_t)r * D + c) =
          make_float4(acc[i][g][0] * inv, acc[i][g][1] * inv,
                      acc[i][g][2] * inv, acc[i][g][3] * inv);
    }
  }
}

// the tile of each head dim and Sq (the header's table)
template <class F>
int with_tile(int Sq, int D, F&& f) {
  const bool wide = Sq >= kWideSq;
  if (D <= 64) return wide ? f(Tile<64, 8>{}) : f(Tile<64, 4>{});
  if (D <= 128) return wide ? f(Tile<128, 8>{}) : f(Tile<128, 4>{});
  return f(Tile<256, 4>{});
}

template <class L>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(flash_kernel<L>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)L::SMEM);
}

}  // namespace

// Contiguous (B, H, S, D) float32 operands on 16-byte boundaries, D a
// multiple of 8 up to 256, Hq a multiple of Hkv (the wrapper checks all of
// these).  lse (B, Hq, Sq) f32 may be null; given, the kernel writes the
// rows' logsumexp there too.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, void* lse,
                                     int batch, int hq, int hkv, int sq,
                                     int skv, int d, int causal, int window,
                                     float scale, void* stream) {
  if (batch <= 0 || sq <= 0) return 0;
  if (d <= 0 || d > 256 || d % 8 != 0 || hkv <= 0 || hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  return with_tile(sq, d, [&](auto tile) {
    using L = decltype(tile);
    const int BH = batch * hq, nqt = (sq + L::TQ - 1) / L::TQ;
    if ((int64_t)BH * nqt > INT_MAX) return (int)cudaErrorInvalidValue;
    cudaError_t err = allow_smem<L>();
    if (err != cudaSuccess) return (int)err;
    flash_kernel<L><<<(unsigned)(BH * nqt), kThreads, L::SMEM,
                      (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out,
        (float*)lse, hq, hkv, sq, skv, d, causal, window, scale, BH, nqt);
    return (int)cudaGetLastError();
  });
}

// What a launch at (sq, d) runs, for the records: info[0] query rows a
// block, [1] shared memory bytes, [2] registers a thread, [3] local
// (stack and spill) bytes a thread, [4] resident blocks an SM.
extern "C" int repro_flash_attention_config(int sq, int d, int* info) {
  if (d <= 0 || d > 256 || d % 8 != 0) return (int)cudaErrorInvalidValue;
  return with_tile(sq, d, [&](auto tile) {
    using L = decltype(tile);
    cudaError_t err = allow_smem<L>();
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, flash_kernel<L>);
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, flash_kernel<L>, kThreads, L::SMEM);
    if (err != cudaSuccess) return (int)err;
    info[0] = L::TQ;
    info[1] = (int)L::SMEM;
    info[2] = attr.numRegs;
    info[3] = (int)attr.localSizeBytes;
    info[4] = blocks;
    return 0;
  });
}
