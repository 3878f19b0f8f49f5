// flash_attention_bwd_tc: the gradient of the bf16 flash_attention on
// Hopper's tensor cores.  Given q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D) and
// the output's cotangent dout (B, Hq, Sq, D), all bf16, and each row's
// logsumexp lse (B, Hq, Sq, f32), which the forward (flash_attention_tc.cu)
// writes for a gradient, it writes dq (B, Hq, Sq, D), dk and dv (B, Hkv,
// Skv, D) in bf16.  The TPU kernel it differentiates is src/repro/kernels/
// flash_attention.py:72 flash_attention; the reference has no backward
// kernel (JAX differentiates its plain attention), so the function is the
// gradient of the forward's: scale 1/sqrt(D), queries right-aligned to the
// keys, the causal and window mask, query head h on KV head h / (Hq/Hkv),
// dk and dv summed over each KV head's query group.  Accumulators and
// softmax statistics are f32; each gradient is rounded to bf16 once.
//
// Math, the plain version's (kernels/flash_attention.py:
// flash_attention_backward_plain): P = exp(S - lse) with S = q k^T scale,
// dV = P^T dO, dP = dO V^T, delta = rowsum(P * dP), dS = P (dP - delta),
// dQ = dS K scale, dK = dS^T Q scale.  Precision, against the plain
// version on f32 copies (the 1e-2 (1 + |ref|) bound;
// scripts/attention_bwd_rounding.py emulates each choice on the host):
// delta comes from the recomputed f32 P, not from the output:
// rowsum(dO * O) from the forward's O, whose P.V rounds P to bf16, put dq
// at up to 0.0097 with O kept in f32 (an f32 copy of O; the 2 x 4 x 256 x
// 64 gradient case) and dk at up to 0.0137 with O rounded to bf16 (GQA
// 48:8), where delta from P leaves 0.0030 at most; and P and dS enter
// their products as two bf16 operands each, the rounding and what it left
// (bf16(x) + bf16(x - bf16(x)) is x within 2**-16), since P rounded once
// put dV at 0.0109 (GQA 48:8) and dS rounded once dK at 0.0072.
//
// Bound on an H100: operations.  The gradient needs 10 D flops per
// admitted (q, k) pair (S, dP, dV, dQ, dK); this design does 24 D: the dQ
// pass computes S and dP twice (once for delta), and the three products
// with P or dS as the A operand run twice (hi and lo parts).  At 989
// TFLOP/s, B 4 x 16 heads x S 4,096 x D 64 causal is 0.348 ms at 10 D and
// 0.834 ms at 24 D; its bytes take 0.07 ms at 3.35 TB/s.
//
// Design: two launches, no atomics, so two calls on the same inputs give
// the same bits (a TrainLoop's replay is bitwise):
// - dQ (first): a block keeps 64 query rows a consumer warpgroup of Q and
//   dO, and walks the key tiles its rows admit twice, as the forward walks
//   them: S = Q K^T, dP = dO V^T, P; the first walk sums delta (written
//   out for the dK/dV pass), the second forms dS and dQ += dS K (K read
//   MN-major through the descriptor's transpose).
// - dK/dV: a block keeps one key tile (64 keys a consumer warpgroup) of K
//   and V in shared memory and dK, dV in f32 registers, and walks each
//   query head of its KV head's group and, for each, the 64-query tiles
//   that admit one of its keys (the causal diagonal to the window's far
//   edge), in order: S^T = K Q^T and dP^T = V dO^T (wgmma, both operands
//   K-major from shared memory), P^T and dS^T in registers, then dV +=
//   P^T dO and dK += dS^T Q (Q and dO MN-major).  One producer warp loads
//   K/V once and Q, dO tiles into a ring of stages by TMA, and stages
//   each tile's lse and delta beside them.  The group sum stays in
//   registers.  A block keeps 64 of dK's and dV's columns (the grid's
//   third axis at D 128 and 256; registers), recomputing S^T and dP^T
//   for each, and at D 256 has one consumer warpgroup (shared memory).
// Only the tiles that straddle the diagonal, the window's edge, Sq or Skv
// are masked (their loop is compiled apart); a warpgroup skips a tile that
// admits none of its rows.  P's exp2 is ex2.approx.ftz (2**-22 relative)
// and a tile's hi and lo products are one commit group: at the shape
// above the single group took 3.29-3.36 ms to 3.14-3.24, then ex2 and the
// apart-compiled mask to 2.19-2.24 (an H100 at 700 W,
// scripts/attention_bwd_probe.py).  Tiles are the forward's 128-byte
// swizzled 64-column sub-tiles, ragged D and rows zero-filled by TMA.
#include <type_traits>

#include "hopper_tc.cuh"

namespace {

using namespace repro_torch;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTile = 64;   // queries of a dK/dV stage, keys of a dQ one

// P = exp2(S scale_log2 - lse2), 0 where masked, into s, and dS = P (dP -
// delta) into dp, for a 64 x N score tile.  stat(j, r, l2, dl) gives
// register 4 j + r's logsumexp (log2 units) and delta; ok(j, r) says
// whether it is admitted (asked on edge tiles only: the loop is written
// twice, so that the other tiles carry no mask arithmetic).
template <int N, typename Stat, typename Ok>
__device__ __forceinline__ void p_and_ds(float (&s)[N / 2],
                                         float (&dp)[N / 2],
                                         float scale_log2, bool edge,
                                         Stat stat, Ok ok) {
  auto run = [&](auto masked) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float l2, dl, p;
        stat(j, r, l2, dl);
        asm("ex2.approx.ftz.f32 %0, %1;\n"
            : "=f"(p) : "f"(fmaf(s[4 * j + r], scale_log2, -l2)));
        if constexpr (decltype(masked)::value)
          if (!ok(j, r)) p = 0.f;
        s[4 * j + r] = p;
        dp[4 * j + r] = p * (dp[4 * j + r] - dl);
      }
  };
  if (edge)
    run(std::true_type{});
  else
    run(std::false_type{});
}

// A 64 x N f32 accumulator as two sets of bf16 A fragments of N / 16
// k-steps: its rounding to bf16 (hi) and what that rounding left (lo), so
// that the products of the two sum to the f32 one's within 2**-16 of it.
template <int N>
__device__ __forceinline__ void split_frags(const float (&x)[N / 2],
                                            uint32_t (&hi)[N / 16][4],
                                            uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    float h[4], l[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      h[r] = __bfloat162float(__float2bfloat16_rn(x[4 * j + r]));
      l[r] = x[4 * j + r] - h[r];
    }
    hi[j / 2][(j % 2) * 2] = pack_bf16(h[0], h[1]);
    hi[j / 2][(j % 2) * 2 + 1] = pack_bf16(h[2], h[3]);
    lo[j / 2][(j % 2) * 2] = pack_bf16(l[0], l[1]);
    lo[j / 2][(j % 2) * 2 + 1] = pack_bf16(l[2], l[3]);
  }
}

// ---- dK/dV --------------------------------------------------------------

// DP: the head dim padded to whole sub-tiles; DH: the dK/dV columns a block
// keeps; NW: consumer warpgroups, 64 keys each
template <int DP, int DH, int NW>
struct KVTiles {
  static constexpr int NC = DP / kSub;
  static constexpr int ST = DP == 64 ? 4 : 2;          // ring stages
  static constexpr int KV_BYTES = 64 * NW * DP * 2;    // the block's K or V
  static constexpr int Q_BYTES = kTile * DP * 2;       // one Q or dO tile
  static constexpr int STAT_FLOATS = 2 * kTile;        // a stage's lse, delta
  static constexpr int BAR_BYTES = 8 * (2 * ST + 1);
  static constexpr int SMEM = 2 * KV_BYTES + ST * 2 * Q_BYTES +
                              ST * STAT_FLOATS * 4 + BAR_BYTES + 1024;
};

template <int DP, int DH, int NW>
__global__ void __launch_bounds__(128 * (NW + 1), 1)
dkdv_kernel(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const __grid_constant__ CUtensorMap tdo,
            const float* __restrict__ lse, const float* __restrict__ delta,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
            int Hq, int Hkv, int Sq, int Skv, int D, int causal, int window,
            float scale_log2, float scale) {
  using T = KVTiles<DP, DH, NW>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* Vs = Ks + T::KV_BYTES;
  uint8_t* Qs = Vs + T::KV_BYTES;      // stage s: Q, then dO
  float* stats = reinterpret_cast<float*>(Qs + T::ST * 2 * T::Q_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + T::ST * T::STAT_FLOATS);
  uint64_t* empty = full + T::ST;
  uint64_t* kvbar = empty + T::ST;

  const int tid = threadIdx.x;
  const int kvh = blockIdx.x, b = kvh / Hkv, hk = kvh % Hkv;
  const int group = Hq / Hkv;
  const int k0 = blockIdx.y * 64 * NW;
  const int c0 = blockIdx.z * DH;
  const int off = Skv - Sq;
  // the queries that admit a key of the block, in kTile tiles
  const int k_hi = min(k0 + 64 * NW, Skv) - 1;
  const int q_first = causal ? max(0, k0 - off) : 0;
  const int q_last = window > 0 ? min(Sq - 1, k_hi + window - 1 - off)
                                : Sq - 1;
  const int qt0 = q_first / kTile;
  const int ntq = q_last >= q_first ? q_last / kTile - qt0 + 1 : 0;
  const int ntiles = group * ntq;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < T::ST; ++s) {
      bar_init(&full[s], 32);           // the producer warp's lanes
      bar_init(&empty[s], 4 * NW);      // every consumer warp
    }
    bar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  const int lane = tid % 32;
  if (wg == NW) {
    // ---- producer: its first warp loads K/V once, then each tile's Q and
    // dO by TMA (lane 0) and its lse (log2 units) and delta (every lane)
    // (one consumer warpgroup has registers enough without it)
    if constexpr (NW > 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid / 32 == 4 * NW) {
      if (lane == 0) {
        bar_expect(kvbar, 2 * T::KV_BYTES);
        for (int w = 0; w < NW; ++w)
          for (int c = 0; c < T::NC; ++c) {
            tma_load(Ks + (w * T::NC + c) * 64 * 128, &tk, c * kSub,
                     k0 + 64 * w, kvh, kvbar);
            tma_load(Vs + (w * T::NC + c) * 64 * 128, &tv, c * kSub,
                     k0 + 64 * w, kvh, kvbar);
          }
      }
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % T::ST;
        if (i >= T::ST) bar_wait(&empty[s], (i / T::ST - 1) & 1);
        const int bh = b * Hq + hk * group + i / ntq;
        const int q0 = (qt0 + i % ntq) * kTile;
        float* st = stats + s * T::STAT_FLOATS;
        for (int e = lane; e < kTile; e += 32) {
          const bool in = q0 + e < Sq;
          const int64_t at = (int64_t)bh * Sq + q0 + e;
          st[e] = in ? lse[at] * kLog2e : 0.f;
          st[kTile + e] = in ? delta[at] : 0.f;
        }
        if (lane == 0) {
          bar_expect(&full[s], 2 * T::Q_BYTES);
          uint8_t* qt = Qs + s * 2 * T::Q_BYTES;
          for (int c = 0; c < T::NC; ++c) {
            tma_load(qt + c * kTile * 128, &tq, c * kSub, q0, bh, &full[s]);
            tma_load(qt + T::Q_BYTES + c * kTile * 128, &tdo, c * kSub, q0,
                     bh, &full[s]);
          }
        } else {
          bar_arrive(&full[s]);
        }
      }
    }
  } else {
    // ---- consumer warpgroup wg: keys [kw0, kw0 + 64)
    if constexpr (NW > 1)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (tid % 128) / 32;
    const int kw0 = k0 + 64 * wg;
    const int ka = kw0 + 16 * warp + lane / 4, kb = ka + 8;
    const int kw_hi = min(kw0 + 63, Skv - 1);
    const bool active = kw0 < Skv;
    const uint8_t* Kw = Ks + wg * T::NC * 64 * 128;
    const uint8_t* Vw = Vs + wg * T::NC * 64 * 128;
    // dO's and Q's sub-tiles from column c0 on: the B operand of dV, dK
    const int csub = (c0 / kSub) * kTile * 128;

    float dka[DH / 2], dva[DH / 2], st[kTile / 2], dpt[kTile / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dka[i] = dva[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kTile / 2; ++i) st[i] = dpt[i] = 0.f;

    bar_wait(kvbar, 0);
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % T::ST;
      const int q0 = (qt0 + i % ntq) * kTile;
      bar_wait(&full[s], (i / T::ST) & 1);
      const int qlo = q0 + off, qhi = min(q0 + kTile, Sq) - 1 + off;
      const bool skip = !active || (causal && kw0 > qhi) ||
                        (window > 0 && kw_hi <= qlo - window);
      if (!skip) {
        const uint8_t* Qt = Qs + s * 2 * T::Q_BYTES;
        const uint8_t* dOt = Qt + T::Q_BYTES;
        const float* lse2 = stats + s * T::STAT_FLOATS;
        const float* dlt = lse2 + kTile;
        // S^T = K Q^T and dP^T = V dO^T, K-major both
        fence_regs(st);
        fence_regs(dpt);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wgmma_ss<kTile>(
              st, desc(Kw + (kk / 4) * 64 * 128 + (kk % 4) * 32, 16, 1024),
              desc(Qt + (kk / 4) * kTile * 128 + (kk % 4) * 32, 16, 1024),
              kk > 0);
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wgmma_ss<kTile>(
              dpt, desc(Vw + (kk / 4) * 64 * 128 + (kk % 4) * 32, 16, 1024),
              desc(dOt + (kk / 4) * kTile * 128 + (kk % 4) * 32, 16, 1024),
              kk > 0);
        wg_commit();
        wg_wait0();
        fence_regs(st);
        fence_regs(dpt);

        // rows are keys (ka, kb), columns queries q0 + 8 j + 2 (lane % 4)
        // + r % 2, whose lse and delta the producer staged
        const bool edge = kw0 + 63 >= Skv || q0 + kTile > Sq ||
                          (causal && kw0 + 63 > qlo) ||
                          (window > 0 && kw0 <= qhi - window);
        p_and_ds<kTile>(
            st, dpt, scale_log2, edge,
            [&](int j, int r, float& l2, float& dl) {
              const int c = 8 * j + 2 * (lane % 4) + r % 2;
              l2 = lse2[c];
              dl = dlt[c];
            },
            [&](int j, int r) {
              const int qi = q0 + 8 * j + 2 * (lane % 4) + r % 2;
              const int qp = qi + off, kp = r / 2 ? kb : ka;
              return kp < Skv && qi < Sq && (!causal || kp <= qp) &&
                     (window <= 0 || kp > qp - window);
            });

        // dV += P^T dO and dK += dS^T Q, each A operand in two bf16 parts,
        // one commit group; dO and Q MN-major: k-step kk is 16 query rows
        // on, 64-column sub-tiles kTile * 128 bytes apart
        uint32_t ph[kTile / 16][4], pl[kTile / 16][4];
        uint32_t dh[kTile / 16][4], dl[kTile / 16][4];
        split_frags<kTile>(st, ph, pl);
        split_frags<kTile>(dpt, dh, dl);
        fence_regs(dva);
        fence_regs(dka);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          const uint64_t bo =
              desc(dOt + csub + kk * 16 * 128, kTile * 128, 1024);
          wgmma_rs<DH>(dva, ph[kk], bo);
          wgmma_rs<DH>(dva, pl[kk], bo);
        }
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          const uint64_t bq =
              desc(Qt + csub + kk * 16 * 128, kTile * 128, 1024);
          wgmma_rs<DH>(dka, dh[kk], bq);
          wgmma_rs<DH>(dka, dl[kk], bq);
        }
        wg_commit();
        wg_wait0();
        fence_regs(dva);
        fence_regs(dka);
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[s]);
    }

    // a key no query admits gets zeros
    const int64_t base = (int64_t)kvh * Skv * D;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int c = c0 + 8 * j + 2 * (lane % 4);
      if (c0 + 8 * j >= D) break;
      if (ka < Skv) {
        *reinterpret_cast<uint32_t*>(dk + base + (int64_t)ka * D + c) =
            pack_bf16(dka[4 * j] * scale, dka[4 * j + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + base + (int64_t)ka * D + c) =
            pack_bf16(dva[4 * j], dva[4 * j + 1]);
      }
      if (kb < Skv) {
        *reinterpret_cast<uint32_t*>(dk + base + (int64_t)kb * D + c) =
            pack_bf16(dka[4 * j + 2] * scale, dka[4 * j + 3] * scale);
        *reinterpret_cast<uint32_t*>(dv + base + (int64_t)kb * D + c) =
            pack_bf16(dva[4 * j + 2], dva[4 * j + 3]);
      }
    }
  }
}

// ---- dQ -----------------------------------------------------------------

// DP: the head dim padded to whole sub-tiles; NW: consumer warpgroups, 64
// query rows each
template <int DP, int NW>
struct QTiles {
  static constexpr int NC = DP / kSub;
  static constexpr int ST = DP == 64 ? 4 : 2;          // ring stages
  static constexpr int Q_BYTES = 64 * NW * DP * 2;     // the block's Q or dO
  static constexpr int KV_BYTES = kTile * DP * 2;      // one K or V tile
  static constexpr int BAR_BYTES = 8 * (2 * ST + 1);
  static constexpr int SMEM =
      2 * Q_BYTES + 2 * ST * KV_BYTES + BAR_BYTES + 1024;
};

template <int DP, int NW>
__global__ void __launch_bounds__(128 * (NW + 1), 1)
dq_kernel(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const __grid_constant__ CUtensorMap tdo,
          const float* __restrict__ lse, float* __restrict__ delta,
          __nv_bfloat16* __restrict__ dq, int Hq, int Hkv, int Sq, int Skv,
          int D, int causal, int window, float scale_log2, float scale) {
  using T = QTiles<DP, NW>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* dOs = Qs + T::Q_BYTES;
  uint8_t* Ks = dOs + T::Q_BYTES;
  uint8_t* Vs = Ks + T::ST * T::KV_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + T::ST * T::KV_BYTES);
  uint64_t* empty = full + T::ST;
  uint64_t* qbar = empty + T::ST;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / Hq, h = bh % Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 64 * NW;
  const int off = Skv - Sq;
  const int qlo = q0 + off, qhi = min(q0 + 64 * NW, Sq) - 1 + off;
  const int k_last = causal ? min(Skv - 1, qhi) : Skv - 1;
  const int k_first = window > 0 ? max(0, qlo - window + 1) : 0;
  const int kt0 = k_first / kTile;
  const int ntiles = k_last / kTile - kt0 + 1;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < T::ST; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 4 * NW);      // every consumer warp
    }
    bar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == NW) {
    // ---- producer: one thread loads Q and dO once, then the K/V tiles
    // of both walks into a ring
    if constexpr (NW > 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 128 * NW) {
      bar_expect(qbar, 2 * T::Q_BYTES);
      for (int w = 0; w < NW; ++w)
        for (int c = 0; c < T::NC; ++c) {
          tma_load(Qs + (w * T::NC + c) * 64 * 128, &tq, c * kSub,
                   q0 + 64 * w, bh, qbar);
          tma_load(dOs + (w * T::NC + c) * 64 * 128, &tdo, c * kSub,
                   q0 + 64 * w, bh, qbar);
        }
      for (int i = 0; i < 2 * ntiles; ++i) {
        const int s = i % T::ST;
        if (i >= T::ST) bar_wait(&empty[s], (i / T::ST - 1) & 1);
        bar_expect(&full[s], 2 * T::KV_BYTES);
        const int k0 = (kt0 + i % ntiles) * kTile;
        for (int c = 0; c < T::NC; ++c) {
          tma_load(Ks + s * T::KV_BYTES + c * kTile * 128, &tk, c * kSub,
                   k0, kvh, &full[s]);
          tma_load(Vs + s * T::KV_BYTES + c * kTile * 128, &tv, c * kSub,
                   k0, kvh, &full[s]);
        }
      }
    }
  } else {
    // ---- consumer warpgroup wg: query rows [q0 + 64 wg, q0 + 64 wg + 64)
    if constexpr (NW > 1)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int row0 = q0 + 64 * wg;
    const int ra = row0 + 16 * warp + lane / 4, rb = ra + 8;
    const int qa = ra + off, qb = rb + off;
    const int wlo = row0 + off, whi = min(row0 + 63, Sq - 1) + off;
    const bool active = row0 < Sq;
    const uint8_t* Qw = Qs + wg * T::NC * 64 * 128;
    const uint8_t* dOw = dOs + wg * T::NC * 64 * 128;
    // rows past Sq hold zeros in Q and dO: an lse of 0 keeps them finite
    const int64_t at = (int64_t)bh * Sq;
    const float l2a = ra < Sq ? lse[at + ra] * kLog2e : 0.f;
    const float l2b = rb < Sq ? lse[at + rb] * kLog2e : 0.f;
    // delta: this thread's columns' share until the first walk ends
    float dla = 0.f, dlb = 0.f;

    float dqa[DP / 2], sc[kTile / 2], dp[kTile / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dqa[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kTile / 2; ++i) sc[i] = dp[i] = 0.f;

    bar_wait(qbar, 0);
    // walk 0 sums delta = rowsum(P * dP); walk 1 takes dS and dQ
    for (int i = 0; i < 2 * ntiles; ++i) {
      const int s = i % T::ST;
      const int walk = i / ntiles;
      const int k0 = (kt0 + i % ntiles) * kTile;
      if (i == ntiles) {
        dla = quad_sum(dla);
        dlb = quad_sum(dlb);
        if (lane % 4 == 0) {
          if (ra < Sq) delta[at + ra] = dla;
          if (rb < Sq) delta[at + rb] = dlb;
        }
      }
      bar_wait(&full[s], (i / T::ST) & 1);
      const bool skip = !active || (causal && k0 > whi) ||
                        (window > 0 && k0 + kTile - 1 <= wlo - window);
      if (!skip) {
        const uint8_t* Kt = Ks + s * T::KV_BYTES;
        const uint8_t* Vt = Vs + s * T::KV_BYTES;
        // S = Q K^T and dP = dO V^T, K-major both
        fence_regs(sc);
        fence_regs(dp);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wgmma_ss<kTile>(
              sc, desc(Qw + (kk / 4) * 64 * 128 + (kk % 4) * 32, 16, 1024),
              desc(Kt + (kk / 4) * kTile * 128 + (kk % 4) * 32, 16, 1024),
              kk > 0);
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wgmma_ss<kTile>(
              dp, desc(dOw + (kk / 4) * 64 * 128 + (kk % 4) * 32, 16, 1024),
              desc(Vt + (kk / 4) * kTile * 128 + (kk % 4) * 32, 16, 1024),
              kk > 0);
        wg_commit();
        wg_wait0();
        fence_regs(sc);
        fence_regs(dp);

        const bool edge = k0 + kTile > Skv ||
                          (causal && k0 + kTile - 1 > wlo) ||
                          (window > 0 && k0 <= whi - window);
        // walk 0 takes delta 0, so dp becomes P * dP
        p_and_ds<kTile>(
            sc, dp, scale_log2, edge,
            [&](int, int r, float& l2, float& dl) {
              l2 = r / 2 ? l2b : l2a;
              dl = walk == 0 ? 0.f : r / 2 ? dlb : dla;
            },
            [&](int j, int r) {
              const int kp = k0 + 8 * j + 2 * (lane % 4) + r % 2;
              const int qp = r / 2 ? qb : qa;
              return kp < Skv && (!causal || kp <= qp) &&
                     (window <= 0 || kp > qp - window);
            });
        if (walk == 0) {
#pragma unroll
          for (int j = 0; j < kTile / 8; ++j) {
            dla += dp[4 * j] + dp[4 * j + 1];
            dlb += dp[4 * j + 2] + dp[4 * j + 3];
          }
        } else {
          // dQ += dS K, dS in two bf16 parts, one commit group; K
          // MN-major: k-step kk is 16 key rows on
          uint32_t dh[kTile / 16][4], dl[kTile / 16][4];
          split_frags<kTile>(dp, dh, dl);
          fence_regs(dqa);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < kTile / 16; ++kk) {
            const uint64_t bk = desc(Kt + kk * 16 * 128, kTile * 128, 1024);
            wgmma_rs<DP>(dqa, dh[kk], bk);
            wgmma_rs<DP>(dqa, dl[kk], bk);
          }
          wg_commit();
          wg_wait0();
          fence_regs(dqa);
        }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[s]);
    }

    __nv_bfloat16* out = dq + (int64_t)bh * Sq * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      if (8 * j >= D) break;
      if (ra < Sq)
        *reinterpret_cast<uint32_t*>(out + (int64_t)ra * D + c) =
            pack_bf16(dqa[4 * j] * scale, dqa[4 * j + 1] * scale);
      if (rb < Sq)
        *reinterpret_cast<uint32_t*>(out + (int64_t)rb * D + c) =
            pack_bf16(dqa[4 * j + 2] * scale, dqa[4 * j + 3] * scale);
    }
  }
}

// ---- host ---------------------------------------------------------------

template <int DP, int DH, int NW>
int launch(const void* q, const void* k, const void* v, const void* lse,
           const void* dout, void* dq, void* dk, void* dv, void* delta, int B,
           int Hq, int Hkv, int Sq, int Skv, int D, int causal, int window,
           float scale, cudaStream_t stream) {
  using KV = KVTiles<DP, DH, NW>;
  using Q = QTiles<DP, NW>;
  static bool sized = false;
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        dkdv_kernel<DP, DH, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        KV::SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dq_kernel<DP, NW>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 Q::SMEM);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  // every map in boxes of 64 rows: a consumer warpgroup's, or a tile's
  CUtensorMap maps[4];
  int err = encode(&maps[0], q, D, Sq, B * Hq, 64);
  if (err == 0) err = encode(&maps[1], k, D, Skv, B * Hkv, 64);
  if (err == 0) err = encode(&maps[2], v, D, Skv, B * Hkv, 64);
  if (err == 0) err = encode(&maps[3], dout, D, Sq, B * Hq, 64);
  if (err != 0) return err;

  const float scale_log2 = scale * kLog2e;
  const dim3 qgrid((unsigned)(B * Hq),
                   (unsigned)((Sq + 64 * NW - 1) / (64 * NW)));
  dq_kernel<DP, NW><<<qgrid, 128 * (NW + 1), Q::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], (const float*)lse, (float*)delta,
      (__nv_bfloat16*)dq, Hq, Hkv, Sq, Skv, D, causal, window, scale_log2,
      scale);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  const dim3 kgrid((unsigned)(B * Hkv),
                   (unsigned)((Skv + 64 * NW - 1) / (64 * NW)),
                   (unsigned)(DP / DH));
  dkdv_kernel<DP, DH, NW><<<kgrid, 128 * (NW + 1), KV::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], (const float*)lse,
      (const float*)delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, Hq, Hkv,
      Sq, Skv, D, causal, window, scale_log2, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Contiguous (B, H, S, D) bf16 q, k, v, dout and dq, dk, dv on 16-byte
// boundaries, D a multiple of 8 up to 256, Hq a multiple of Hkv, no fully
// masked row; lse (B, Hq, Sq) f32 from the forward; delta (B, Hq, Sq) f32
// scratch, written by the dQ pass for the dK/dV pass (the wrapper checks
// all of these).  Returns the runtime's error code, or 10000 when the
// driver's cuTensorMapEncodeTiled is not found, or 20000 + the driver's
// code when it refuses a map.
extern "C" int repro_flash_attention_bwd_tc(
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
    return launch<64, 64, 2>(q, k, v, lse, dout, dq, dk, dv, delta, batch,
                             hq, hkv, sq, skv, d, causal, window, scale, s);
  if (d <= 128)
    return launch<128, 64, 2>(q, k, v, lse, dout, dq, dk, dv, delta, batch,
                              hq, hkv, sq, skv, d, causal, window, scale, s);
  return launch<256, 64, 1>(q, k, v, lse, dout, dq, dk, dv, delta, batch, hq,
                            hkv, sq, skv, d, causal, window, scale, s);
}
