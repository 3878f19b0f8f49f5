// flash_attention_bwd: the gradient of the f32 flash_attention on SIMT
// FMAs.  Given q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D), the forward's
// output o and its cotangent dout (B, Hq, Sq, D), all f32, and each row's
// logsumexp lse (B, Hq, Sq), which the forward (flash_attention.cu)
// writes for a gradient, it writes dq (B, Hq, Sq, D), dk and dv (B, Hkv,
// Skv, D) in f32.  The TPU kernel it differentiates is src/repro/kernels/
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
// dQ = dS K scale, dK = dS^T Q scale.  All arithmetic in f32.  Here delta
// is rowsum(dO * O), equal in exact arithmetic: the f32 forward's O is not
// rounded (the bf16 route sums delta from P, as its output is).
//
// Bound on an H100: operations.  10 D flops per admitted (q, k) pair for
// the gradient, 14 D as done here (S and dP are formed in both passes:
// the dQ pass's S, dP and dQ, the dK/dV pass's S, dP, dV and dK), at the
// f32 rate of 67 TFLOP/s outside the tensor cores: 5.13 ms at 10 D, 7.18
// at 14 D for B 1 x 16 heads x S 8,192 x D 64.
//
// Design, on the forward's tiling (csrc/flash_attention.cu), two launches
// and no atomics, so two calls give the same bits:
// - A pass is blocks that each keep R rows of their own in shared memory
//   (the dQ pass query rows: Q, dO; the dK/dV pass key rows: K, V) and
//   walk W-row tiles of the other side (keys: K, V; queries: Q, dO, lse,
//   delta) in ascending order through cp.async.cg stages (16 bytes a
//   copy; rows past S and columns past D land as zeros).
// - A block is a grid of NTY x 16 threads (ty, tx), 8 x 16 at D <= 64.
//   Thread (ty, tx) owns own rows ty + NTY i (i < R / NTY) and walked rows
//   tx + 16 j (j < W / 16) of S and dP, and of its products the own rows
//   and the float4 column groups 4 tx + 64 g.  A warp spans 4 ty by 8 tx,
//   so each operand load is an LDS.128 of 4 or 8 rows at stride D + 4
//   floats, in distinct bank groups: one wavefront, 6 a warp per 64 FFMA
//   at 8 x 4 (8 at 4 x 4; 12 in the design this replaced, 4 x 4 in a
//   warp of 2 ty by 16 tx).  P and dS rows at stride W + 8: a warp's
//   scalar stores fill the 32 banks and its float4 loads 4 groups.
// - No row statistic crosses lanes in the walk: lse comes from the
//   forward, and the dQ pass's prologue sums delta = rowsum(dO * O) (16
//   lanes a row, a fixed order) and writes it for the dK/dV pass.  So the
//   dQ pass walks its key tiles once (the design this replaced walked them
//   twice, the first time for delta = rowsum(P * dP): 18 D a pair).
// - The dQ pass: dP = dO V_t^T while K_t lands; after that barrier V_t+1
//   is issued and lands during S, dS and dQ += dS K_t; after dQ's barrier
//   K_t+1.  Three barriers a tile.  The dK/dV pass: dP^T = V dO_t^T while
//   Q_t, lse_t and delta_t land; S^T, then P^T and dS^T into shared
//   memory; dV += P^T dO_t, then dO_t+1 is issued and lands during dK +=
//   dS^T Q_t, then Q_t+1.  Four barriers a tile.
// - Only tiles that straddle the causal diagonal, a window edge, Sq or Skv
//   evaluate the mask.  P = 2^(S c - lse log2 e), c = scale log2 e, one
//   FFMA and ex2.approx.ftz (relative error ~2^-22).
// - Grids of one axis: the dQ pass's blocks are (query tile, b * Hq + h),
//   the heaviest causal tiles (the last) first; the dK/dV pass's (key
//   tile, b * Hkv + hk), the heaviest (the first) first, each walking its
//   group's query heads in turn and, of each, the query tiles that admit
//   one of its keys; the group sum stays in registers.
//
// Tiles, own rows R x walked rows W and the thread tile, by D, as nvcc
// builds them for sm_90a (ptxas -v; repro_flash_attention_bwd_config
// reports them on the card), dQ pass / dK/dV pass:
//   D <= 64:  64 x 64, 8 x 4 in 128 threads, 88,320 / 107,008 B of shared
//             memory, 254 / 254 registers, no spill, 2 blocks an SM;
//   D <= 128: 64 x 64, 4 x 4 in 256 threads, 153,856 / 172,544 B, 208 /
//             234 registers, no spill, 1 block;
//   D <= 256: 32 x 32, 2 x 2 in 256 threads, 138,368 / 143,616 B, 208 /
//             196 registers, no spill, 1 block.
// At D <= 64 that tile beat, in one call on an H100 (700 W; the probe
// below): 4 x 4 in 256 threads (2 blocks an SM, 128 registers, 28 and 8 B
// spilled), and 8 x 4 in 256 threads, 128 own rows (1 block an SM), from
// Sq 1,024.  Times: PERF.md §6, from scripts/attention_bwd_probe.py
// --f32-backward.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// THREADS threads a block, a grid of NTY ty (own rows) by 16 tx (walked
// rows); RPT own rows a thread (NTY RPT a block), CPT walked rows (16 CPT
// a tile)
template <int DM_, int RPT_, int CPT_, int THREADS_>
struct Tile {
  static constexpr int DM = DM_, RPT = RPT_, CPT = CPT_;
  static constexpr int THREADS = THREADS_, NTY = THREADS / 16;
  static constexpr int TR = NTY * RPT;  // own rows a block
  static constexpr int TW = 16 * CPT;   // walked rows a tile
  static constexpr int KS = DM + 4;     // operand row stride (floats)
  static constexpr int PS = TW + 8;     // P / dS row stride (floats)
  static constexpr int NG = DM / 64;    // float4 column groups a thread
  static constexpr size_t DQ_SMEM =
      sizeof(float) * (2 * (size_t)TR * KS + 2 * (size_t)TW * KS +
                       (size_t)TR * PS + TR);
  static constexpr size_t DKV_SMEM =
      sizeof(float) * (2 * (size_t)TR * KS + 2 * (size_t)TW * KS +
                       2 * (size_t)TR * PS + 2 * TW);
  // two blocks an SM where their shared memory fits
  static constexpr int DQ_BLOCKS = DQ_SMEM <= 113 * 1024 ? 2 : 1;
  static constexpr int DKV_BLOCKS = DKV_SMEM <= 113 * 1024 ? 2 : 1;
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

// one float, likewise (lse and delta rows start anywhere)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the newest N has landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// sum over the 16 lanes that share bits 4 and up of the lane; every lane
// ends with the same bits
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool admitted(int kp, int qp, int causal,
                                         int window) {
  return (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// thread (ty, tx) of the NTY x 16 grid; a warp spans 4 ty by 8 tx
__device__ __forceinline__ void coords(int tid, int& ty, int& tx) {
  const int lane = tid & 31, w = tid >> 5;
  tx = (lane & 7) | ((w & 1) << 3);
  ty = (lane >> 3) | ((w >> 1) << 2);
}

// rows [r0, r0 + ROWS) of a (rows, D) f32 matrix into ROWS rows of
// shared memory at stride DM + 4; rows past `rows` and columns past D
// are zeros, so they add nothing to any product
template <int ROWS, int DM, int THREADS>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int r0, int rows, int D,
                                           int tid) {
  constexpr int CPR = DM / 4, KS = DM + 4;
  static_assert(ROWS * CPR % THREADS == 0, "whole copies a thread");
  const int cpr = D / 4;
#pragma unroll
  for (int n = 0; n < ROWS * CPR / THREADS; ++n) {
    const int e = tid + n * THREADS, r = e / CPR, c = e % CPR;
    const bool ok = r0 + r < rows && c < cpr;
    cp_async16(dst + r * KS + 4 * c,
               ok ? src + (int64_t)(r0 + r) * D + 4 * c : src, ok ? 16 : 0);
  }
}

// acc[i][j] = a_i . b_j over DM columns: rows a + RS i KS, b + 16 j KS
template <int R, int C, int DM, int KS, int RS>
__device__ __forceinline__ void dots(const float* a, const float* b,
                                     float (&acc)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DM; d += 4) {
    float4 bv[C];
#pragma unroll
    for (int j = 0; j < C; ++j) bv[j] = load4(b + 16 * j * KS + d);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float4 av = load4(a + RS * i * KS + d);
#pragma unroll
      for (int j = 0; j < C; ++j) acc[i][j] = dot4(av, bv[j], acc[i][j]);
    }
  }
}

// acc[i][g] += sum over k < W of w[i][k] m[k][64 g .. 64 g + 3]: w rows at
// w + RS i PS, m rows at m + k KS (m at the thread's column 4 tx)
template <int R, int NG, int W, int PS, int KS, int RS>
__device__ __forceinline__ void outer(const float* w, const float* m,
                                      float (&acc)[R][NG][4]) {
#pragma unroll 2
  for (int kk = 0; kk < W; kk += 4) {
    float4 mv[4][NG];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int g = 0; g < NG; ++g) mv[u][g] = load4(m + (kk + u) * KS + 64 * g);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float4 w4 = load4(w + RS * i * PS + kk);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        axpy4(w4.x, mv[0][g], acc[i][g]);
        axpy4(w4.y, mv[1][g], acc[i][g]);
        axpy4(w4.z, mv[2][g], acc[i][g]);
        axpy4(w4.w, mv[3][g], acc[i][g]);
      }
    }
  }
}

// rows r0 + ty + RS i of an (rows, D) f32 matrix from acc * s
template <int RS, int R, int NG>
__device__ __forceinline__ void write_rows(float* dst,
                                           const float (&acc)[R][NG][4],
                                           float s, int r0, int rows, int D,
                                           int ty, int tx) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = r0 + ty + RS * i;
    if (r >= rows) continue;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int c = 64 * g + 4 * tx;
      if (c >= D) continue;
      *reinterpret_cast<float4*>(dst + (int64_t)r * D + c) =
          make_float4(acc[i][g][0] * s, acc[i][g][1] * s, acc[i][g][2] * s,
                      acc[i][g][3] * s);
    }
  }
}

template <class L>
__global__ void __launch_bounds__(L::THREADS, L::DQ_BLOCKS)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ o, const float* __restrict__ lse,
          float* __restrict__ delta, float* __restrict__ dq, int Hq,
          int Hkv, int Sq, int Skv, int D, int causal, int window,
          float scale, int BH, int nqt) {
  constexpr int DM = L::DM, RPT = L::RPT, CPT = L::CPT, TR = L::TR;
  constexpr int TW = L::TW, KS = L::KS, PS = L::PS, NG = L::NG;
  constexpr int NT = L::THREADS, RS = L::NTY;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + TR * KS;
  float* Ks = dOs + TR * KS;  // K_t
  float* Vs = Ks + TW * KS;   // V_t
  float* DSs = Vs + TW * KS;
  float* dls = DSs + TR * PS;

  const int tid = threadIdx.x;
  int ty, tx;
  coords(tid, ty, tx);
  // heaviest query tiles first, across every (b, h)
  const int bh = (int)(blockIdx.x % (unsigned)BH);
  const int q0 = (nqt - 1 - (int)(blockIdx.x / (unsigned)BH)) * TR;
  const int b = bh / Hq, h = bh % Hq;
  const int off = Skv - Sq;
  const int64_t row0 = (int64_t)bh * Sq;
  const int64_t kv_head = (int64_t)b * Hkv + h / (Hq / Hkv);
  const float* dob = dout + row0 * D;
  const float* kb = k + kv_head * Skv * D;
  const float* vb = v + kv_head * Skv * D;

  const int qlo = q0 + off;
  const int qhi = min(q0 + TR, Sq) - 1 + off;
  const int k_last = causal ? min(Skv - 1, qhi) : Skv - 1;
  const int k_first = window > 0 ? max(0, qlo - window + 1) : 0;
  const int t_first = k_first / TW;
  const int t_end = k_last >= k_first ? k_last / TW + 1 : t_first;

  // Q, dO and the first tile's V in one group, its K in the next
  stage_rows<TR, DM, NT>(Qs, q + row0 * D, q0, Sq, D, tid);
  stage_rows<TR, DM, NT>(dOs, dob, q0, Sq, D, tid);
  if (t_first < t_end)
    stage_rows<TW, DM, NT>(Vs, vb, t_first * TW, Skv, D, tid);
  cp_async_commit();
  if (t_first < t_end)
    stage_rows<TW, DM, NT>(Ks, kb, t_first * TW, Skv, D, tid);
  cp_async_commit();

  // delta = rowsum(dO * O) for the block's rows: 16 lanes a row, each
  // summing float4 columns c, c + 16, .. in order, then a butterfly
  {
    const int c0 = tid & 15, cpr = D / 4;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int rr = (tid >> 4) + RS * i, r = q0 + rr;
      float s = 0.f;
      if (r < Sq) {
        const float* orow = o + (row0 + r) * D;
        const float* drow = dob + (int64_t)r * D;
        for (int c = c0; c < cpr; c += 16)
          s = dot4(__ldg(reinterpret_cast<const float4*>(orow) + c),
                   __ldg(reinterpret_cast<const float4*>(drow) + c), s);
      }
      s = sum16(s);
      if (c0 == 0) {
        dls[rr] = s;
        if (r < Sq) delta[row0 + r] = s;
      }
    }
  }

  // rows past Sq hold zeros: an lse and a delta of 0 keep them finite
  const float c2 = scale * kLog2e;
  float lse2[RPT], dl[RPT], acc[RPT][NG][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + ty + RS * i;
    lse2[i] = r < Sq ? lse[row0 + r] * kLog2e : 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][g][c] = 0.f;
  }
  cp_async_wait<1>();  // Q, dO, V_first
  __syncthreads();     // ... for every thread, and delta
#pragma unroll
  for (int i = 0; i < RPT; ++i) dl[i] = dls[ty + RS * i];

  const float* qr = Qs + ty * KS;
  const float* dor = dOs + ty * KS;
  float* dsr = DSs + ty * PS;
  for (int t = t_first; t < t_end; ++t) {
    const int k0 = t * TW;
    float dp[RPT][CPT];
    dots<RPT, CPT, DM, KS, RS>(dor, Vs + tx * KS, dp);  // K_t lands meanwhile
    cp_async_wait<0>();
    __syncthreads();  // K_t staged; every thread done with V_t
    if (t + 1 < t_end)  // lands during S and dQ
      stage_rows<TW, DM, NT>(Vs, vb, k0 + TW, Skv, D, tid);
    cp_async_commit();

    float s[RPT][CPT];
    dots<RPT, CPT, DM, KS, RS>(qr, Ks + tx * KS, s);
    // the mask, on the tiles that straddle the diagonal, a window edge
    // or Skv only
    const bool edge = !(k0 + TW <= Skv && (!causal || k0 + TW - 1 <= qlo)
                        && (window <= 0 || k0 > qhi - window));
    if (edge) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int qp = q0 + ty + RS * i + off;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int kp = k0 + tx + 16 * j;
          if (!(kp < Skv && admitted(kp, qp, causal, window)))
            s[i][j] = -INFINITY;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = ex2(fmaf(s[i][j], c2, -lse2[i]));
        dsr[RS * i * PS + tx + 16 * j] = p * (dp[i][j] - dl[i]);
      }
    __syncthreads();  // dS written

    // dQ += dS K_t for rows ty + 16 i, columns 4 tx + 64 g
    outer<RPT, NG, TW, PS, KS, RS>(dsr, Ks + 4 * tx, acc);
    cp_async_wait<0>();
    __syncthreads();  // V_t+1 staged; every thread done with K_t and dS
    if (t + 1 < t_end)  // lands during dP
      stage_rows<TW, DM, NT>(Ks, kb, k0 + TW, Skv, D, tid);
    cp_async_commit();
  }
  cp_async_wait<0>();  // no copy outlives the block
  write_rows<RS>(dq + row0 * D, acc, scale, q0, Sq, D, ty, tx);
}

template <class L>
__global__ void __launch_bounds__(L::THREADS, L::DKV_BLOCKS)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int Hq, int Hkv,
            int Sq, int Skv, int D, int causal, int window, float scale,
            int BHkv) {
  constexpr int DM = L::DM, RPT = L::RPT, CPT = L::CPT, TR = L::TR;
  constexpr int TW = L::TW, KS = L::KS, PS = L::PS, NG = L::NG;
  constexpr int NT = L::THREADS, RS = L::NTY;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + TR * KS;
  float* Qs = Vs + TR * KS;   // Q_t
  float* dOs = Qs + TW * KS;  // dO_t
  float* PTs = dOs + TW * KS;
  float* DSTs = PTs + TR * PS;
  float* lse_s = DSTs + TR * PS;
  float* dl_s = lse_s + TW;

  const int tid = threadIdx.x;
  int ty, tx;
  coords(tid, ty, tx);
  // the first key tiles (the most queries admit them) first
  const int kvh = (int)(blockIdx.x % (unsigned)BHkv);
  const int k0 = (int)(blockIdx.x / (unsigned)BHkv) * TR;
  const int b = kvh / Hkv, hk = kvh % Hkv, group = Hq / Hkv;
  const int off = Skv - Sq;
  // the queries that admit a key of the block, in TW tiles
  const int k_hi = min(k0 + TR, Skv) - 1;
  const int q_first = causal ? max(0, k0 - off) : 0;
  const int q_last = window > 0 ? min(Sq - 1, k_hi + window - 1 - off)
                                : Sq - 1;
  const int qt0 = q_first / TW;
  const int ntq = q_last >= q_first ? q_last / TW - qt0 + 1 : 0;
  const int n = group * ntq;
  const int64_t kv_row0 = (int64_t)kvh * Skv;

  // walked tile t: query head b * Hq + hk * group + t / ntq, rows from q0
  auto head = [&](int t) { return (int64_t)b * Hq + hk * group + t / ntq; };
  auto first_row = [&](int t) { return (qt0 + t % ntq) * TW; };
  auto stage_dout = [&](int t) {
    stage_rows<TW, DM, NT>(dOs, dout + head(t) * Sq * D, first_row(t), Sq, D,
                       tid);
  };
  auto stage_q = [&](int t) {  // Q_t, lse_t and delta_t
    const int64_t r0 = head(t) * Sq;
    const int q0 = first_row(t);
    stage_rows<TW, DM, NT>(Qs, q + r0 * D, q0, Sq, D, tid);
    if (tid < 2 * TW) {  // (every thread of a 128-thread block)
      const int i = tid % TW;
      const bool ok = q0 + i < Sq;
      const float* src = (tid < TW ? lse : delta) + r0;
      cp_async4((tid < TW ? lse_s : dl_s) + i, ok ? src + q0 + i : src,
                ok ? 4 : 0);
    }
  };

  // K, V and the first tile's dO in one group, its Q in the next
  stage_rows<TR, DM, NT>(Ks, k + kv_row0 * D, k0, Skv, D, tid);
  stage_rows<TR, DM, NT>(Vs, v + kv_row0 * D, k0, Skv, D, tid);
  if (n > 0) stage_dout(0);
  cp_async_commit();
  if (n > 0) stage_q(0);
  cp_async_commit();

  const float c2 = scale * kLog2e;
  float dka[RPT][NG][4], dva[RPT][NG][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) dka[i][g][c] = dva[i][g][c] = 0.f;
  cp_async_wait<1>();
  __syncthreads();  // K, V and dO_0 staged

  const float* kr = Ks + ty * KS;
  const float* vr = Vs + ty * KS;
  float* ptr = PTs + ty * PS;
  float* dstr = DSTs + ty * PS;
  for (int t = 0; t < n; ++t) {
    const int q0 = first_row(t);
    // dP^T and S^T: keys ty + 16 i, queries tx + 16 j
    float dpt[RPT][CPT];
    dots<RPT, CPT, DM, KS, RS>(vr, dOs + tx * KS, dpt);  // Q_t lands meanwhile
    cp_async_wait<0>();
    __syncthreads();  // Q_t, lse_t, delta_t staged

    float st[RPT][CPT];
    dots<RPT, CPT, DM, KS, RS>(kr, Qs + tx * KS, st);
    const bool edge = !(k0 + TR <= Skv && q0 + TW <= Sq &&
                        (!causal || k0 + TR - 1 <= q0 + off) &&
                        (window <= 0 || k0 > q0 + TW - 1 + off - window));
    if (edge) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int kp = k0 + ty + RS * i;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int qi = q0 + tx + 16 * j;
          if (!(kp < Skv && qi < Sq &&
                admitted(kp, qi + off, causal, window)))
            st[i][j] = -INFINITY;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float l2 = lse_s[tx + 16 * j] * kLog2e;
      const float dl = dl_s[tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = ex2(fmaf(st[i][j], c2, -l2));
        ptr[RS * i * PS + tx + 16 * j] = p;
        dstr[RS * i * PS + tx + 16 * j] = p * (dpt[i][j] - dl);
      }
    }
    __syncthreads();  // P^T and dS^T written

    // dV += P^T dO_t, then dK += dS^T Q_t: keys ty + 16 i, columns
    // 4 tx + 64 g
    outer<RPT, NG, TW, PS, KS, RS>(ptr, dOs + 4 * tx, dva);
    __syncthreads();  // every thread done with dO_t
    if (t + 1 < n) stage_dout(t + 1);  // lands during dK
    cp_async_commit();
    outer<RPT, NG, TW, PS, KS, RS>(dstr, Qs + 4 * tx, dka);
    cp_async_wait<0>();
    __syncthreads();  // dO_t+1 staged; every thread done with Q_t .. dS^T
    if (t + 1 < n) stage_q(t + 1);  // lands during dP^T
    cp_async_commit();
  }
  cp_async_wait<0>();  // no copy outlives the block

  // a key no query admits gets zeros
  write_rows<RS>(dk + kv_row0 * D, dka, scale, k0, Skv, D, ty, tx);
  write_rows<RS>(dv + kv_row0 * D, dva, 1.f, k0, Skv, D, ty, tx);
}

// the tiles of each head dim (the header's table): f gets the dQ pass's
// and the dK/dV pass's
template <class F>
int with_tiles(int D, F&& f) {
  if (D <= 64) return f(Tile<64, 8, 4, 128>{}, Tile<64, 8, 4, 128>{});
  if (D <= 128) return f(Tile<128, 4, 4, 256>{}, Tile<128, 4, 4, 256>{});
  return f(Tile<256, 2, 2, 256>{}, Tile<256, 2, 2, 256>{});
}

template <class LQ, class LK>
cudaError_t allow_smem() {
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<LQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)LQ::DQ_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkdv_kernel<LK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)LK::DKV_SMEM);
  return err;
}

}  // namespace

// Contiguous (B, H, S, D) float32 operands and gradients on 16-byte
// boundaries, D a multiple of 8 up to 256, Hq a multiple of Hkv, no fully
// masked row; lse (B, Hq, Sq) from the forward, out (B, Hq, Sq, D) its
// output, and delta (B, Hq, Sq) f32 scratch, written by the dQ pass for
// the dK/dV pass (the wrapper checks all of these).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* lse,
    const void* dout, const void* out, void* dq, void* dk, void* dv,
    void* delta, int batch, int hq, int hkv, int sq, int skv, int d,
    int causal, int window, float scale, void* stream) {
  if (batch <= 0 || sq <= 0) return 0;
  if (d <= 0 || d > 256 || d % 8 != 0 || hkv <= 0 || hq % hkv != 0 ||
      skv <= 0)
    return (int)cudaErrorInvalidValue;
  return with_tiles(d, [&](auto tq, auto tk) {
    using LQ = decltype(tq);
    using LK = decltype(tk);
    const int64_t BH = (int64_t)batch * hq, BHkv = (int64_t)batch * hkv;
    const int64_t nqt = (sq + LQ::TR - 1) / LQ::TR;
    const int64_t nkt = (skv + LK::TR - 1) / LK::TR;
    if (BH * nqt > INT_MAX || BHkv * nkt > INT_MAX)
      return (int)cudaErrorInvalidValue;
    cudaError_t err = allow_smem<LQ, LK>();
    if (err != cudaSuccess) return (int)err;
    const cudaStream_t s = (cudaStream_t)stream;
    const float *fq = (const float*)q, *fk = (const float*)k,
                *fv = (const float*)v, *fdo = (const float*)dout,
                *flse = (const float*)lse;
    dq_kernel<LQ><<<(unsigned)(BH * nqt), LQ::THREADS, LQ::DQ_SMEM, s>>>(
        fq, fk, fv, fdo, (const float*)out, flse, (float*)delta, (float*)dq,
        hq, hkv, sq, skv, d, causal, window, scale, (int)BH, (int)nqt);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    dkdv_kernel<LK><<<(unsigned)(BHkv * nkt), LK::THREADS, LK::DKV_SMEM,
                      s>>>(
        fq, fk, fv, fdo, flse, (const float*)delta, (float*)dk, (float*)dv,
        hq, hkv, sq, skv, d, causal, window, scale, (int)BHkv);
    return (int)cudaGetLastError();
  });
}

// What a launch at head dim d runs in pass 0 (dQ) or 1 (dK/dV), for the
// records: info[0] own rows a block, [1] walked rows a tile, [2] shared
// memory bytes, [3] registers a thread, [4] local (stack and spill) bytes
// a thread, [5] resident blocks an SM, [6] threads a block.
extern "C" int repro_flash_attention_bwd_config(int d, int pass, int* info) {
  if (d <= 0 || d > 256 || d % 8 != 0 || pass < 0 || pass > 1)
    return (int)cudaErrorInvalidValue;
  return with_tiles(d, [&](auto tq, auto tk) {
    using LQ = decltype(tq);
    using LK = decltype(tk);
    cudaError_t err = allow_smem<LQ, LK>();
    const void* fn = pass == 0 ? (const void*)dq_kernel<LQ>
                               : (const void*)dkdv_kernel<LK>;
    const size_t smem = pass == 0 ? LQ::DQ_SMEM : LK::DKV_SMEM;
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, fn, pass == 0 ? LQ::THREADS : LK::THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    info[0] = pass == 0 ? LQ::TR : LK::TR;
    info[1] = pass == 0 ? LQ::TW : LK::TW;
    info[2] = (int)smem;
    info[3] = attr.numRegs;
    info[4] = (int)attr.localSizeBytes;
    info[5] = blocks;
    info[6] = pass == 0 ? LQ::THREADS : LK::THREADS;
    return 0;
  });
}
