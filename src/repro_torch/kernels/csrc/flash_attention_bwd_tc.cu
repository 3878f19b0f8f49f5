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
// scripts/attention_bwd_rounding.py emulates each choice on the host, its
// "design" row this kernel's): delta comes from the recomputed f32 P, not
// from the output (rowsum(dO * O) from the forward's O, whose P.V rounds
// P to bf16, put dq at up to 0.0097 with O kept in f32 and dk at up to
// 0.0137 with O in bf16); P enters dV as two bf16 operands, the rounding
// and what it left (bf16(x) + bf16(x - bf16(x)) is x within 2**-16),
// since P rounded once puts dV at 0.0109 (GQA 48:8); dS is rounded once
// for dQ, and for dK at D <= 64; above D 64 dK takes dS's residue too
// (rounded once it put dk at 0.0103 at grok's heads, 1 x 48:8 x 2,048 x
// 128, against 0.0029 with it; dq 0.0048).
//
// Bound on an H100: operations.  The gradient needs 10 D flops per
// admitted (q, k) pair (S, dP, dV, dQ, dK).  At D <= 64 this design does
// 16 D: the delta pass's S and dP, then S^T, dP^T, dV (P's two parts), dK
// and dQ; above D 64, 22 D (its dQ pass computes S and dP twice, and dK
// takes dS in two parts).  At 989
// TFLOP/s, B 4 x 16 heads x S 4,096 x D 64 causal is 0.348 ms at 10 D and
// 0.556 ms at 16 D; its bytes take 0.07 ms at 3.35 TB/s.
//
// Design at D <= 64: a delta pass, a dK/dV pass that also forms dQ, an
// epilogue:
// - delta: a block keeps 64 query rows a consumer warpgroup of Q and dO
//   and walks the key tiles its rows admit, as the forward walks them:
//   S = Q K^T, dP = dO V^T, P, delta = rowsum(P * dP).
// - dK/dV: a block keeps 128 keys (64 a consumer warpgroup) of K and V in
//   shared memory and dK, dV in f32 registers, and walks each query head
//   of its KV head's group and the 64-query tiles that admit one of its
//   keys, the last tile first: S^T = K Q^T and dP^T = V dO^T (wgmma, both
//   operands K-major from shared memory), P^T and dS^T in registers, dV +=
//   P^T dO and dK += dS^T Q (Q and dO MN-major).  dS^T goes to shared
//   memory in bf16, and dQ^T = K^T dS^T (both operands MN-major) is the
//   warpgroup's share of the tile's dQ; the second warpgroup adds its
//   share to the first's in shared memory (the first alternates by tile).
//   One producer warp loads K/V once and Q, dO tiles into a ring of stages
//   by TMA and stages each tile's lse and delta beside them; one lane of
//   another (the writer) adds the block's share into dq_acc (f32, device
//   memory) by a TMA bulk reduction in L2 (the first key block's copies).
// - dQ in a fixed order: each (head, query tile) has a counter in device
//   memory; the writer adds its share when the counter equals its key
//   block's rank among the blocks that walk the tile (ascending), waits
//   for the reduction to land, fences, and advances the counter.  The f32
//   sums run in one order, so two calls give the same bits (a TrainLoop's
//   replay is bitwise).  Progress: a block takes its (KV head, key block)
//   from a ticket (an atomic counter) in the order blocks start, key
//   blocks ascending, so every block it waits on started before it and
//   is resident or done.
// - an epilogue scales dq_acc and rounds it to bf16.
// Design above D 64: the dQ pass (a block keeps 64 query rows a consumer
// warpgroup and walks their key tiles twice: delta, then dS and dQ += dS
// K) and the dK/dV pass as above without the shares (dK with dS's
// residue), one block a 64-column
// slice of dK and dV (the grid's third axis; registers), recomputing S^T
// and dP^T for each, at D 256 with one consumer warpgroup.  The shares
// lose there: with the slices the share path's staging costs more than
// the dQ pass's second walk (grok's heads 0.742-0.744 ms against
// 0.679-0.685).
// Only the tiles that straddle the diagonal, the window's edge, Sq or Skv
// are masked (their loop is compiled apart); a warpgroup skips a tile that
// admits none of its keys.  P's exp2 is ex2.approx.ftz (2**-22 relative).
// The consumers' mbarrier waits carry no trap: a __trap() on their path
// keeps ptxas at the launch bound's 168 registers a thread whatever
// setmaxnreg.inc asks (ptxas -v, as build.py keeps it: 196-296 bytes of
// spill stores a two-warpgroup dK/dV kernel with the trap, 12-32 without).
//
// Times of the redesign's steps at the shape above, grok's heads (1 x
// 48:8 x 2,048 x 128) and Danube's (1 x 32:8 x 6,144 x 120, window 4,096)
// on an H100 80GB HBM3 at 700 W (scripts/attention_bwd_probe.py, each
// beside its predecessor in one call, 3 repeats): the earlier design (24
// D) 2.194-2.219 / 0.764-0.772 / 3.969-4.146 ms; dS rounded once (20 D)
// 2.004-2.022 / 0.673-0.684 / 3.506-3.634; the dQ shares at every D
// (first form: ptxas's 168-register cap, a share a warpgroup)
// 2.065-2.087 / 0.963-0.969 / 4.647-4.759; without the trap 1.998-2.021 /
// 0.755-0.760 / 3.534-3.634; one share a block, the first copied
// 1.712-1.731 / 0.738-0.743 / 3.470-3.559; the shares at D <= 64 only
// 1.719-1.730 / 0.677-0.682 / 3.519-3.644, and with dK's residue above D
// 64 (the 1e-2 bound) 1.713-1.740 / 0.735-0.767 / 3.782-3.930 (two
// calls).  Dropped: dQ's residue above D 64 too (1.718-1.725 /
// 0.772-0.779 / 4.002-4.574; dq 0.0025 at grok's heads), each
// warpgroup's next S^T/dP^T issued before its dV/dK/dQ are waited on
// (ptxas then serializes the wgmmas: 2.035-2.053 and 2.178-2.208 in two
// forms), the two warpgroups' products in turns on named barriers
// (1.727-1.744 against 1.722-1.731; 2.174-2.198 against 2.178-2.208),
// and a 128-column dK/dV block at D 128 (spills; grok 1.558-1.581).
#include <type_traits>

#include "hopper_tc.cuh"

namespace {

using namespace repro_torch;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTile = 64;   // queries of a dK/dV stage, keys of a delta one
constexpr int kChunk = kTile * kSub;   // f32 of a dQ share: 64 x 64

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
        float l2, dl;
        stat(j, r, l2, dl);
        float p = ex2(fmaf(s[4 * j + r], scale_log2, -l2));
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

// a warpgroup's 64 x 64 f32 dQ^T share (zeros without one) into a staging
// buffer, or added to the one there: row d = the column, pairs of queries
// swizzled by d % 8 (dq_epilogue undoes it)
template <bool kAdd>
__device__ __forceinline__ void stage_share(float* out,
                                            const float (&q)[kTile / 2],
                                            bool has, int warp, int lane) {
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = 16 * warp + lane / 4 + 8 * h;
      const int pr = (4 * j + lane % 4) ^ ((d % 8) << 2);
      float2* at = reinterpret_cast<float2*>(out + d * kTile + 2 * pr);
      float2 v = has ? make_float2(q[4 * j + 2 * h], q[4 * j + 2 * h + 1])
                     : make_float2(0.f, 0.f);
      if constexpr (kAdd) {
        const float2 was = *at;
        v = make_float2(was.x + v.x, was.y + v.y);
      }
      *at = v;
    }
}

// ---- delta ---------------------------------------------------------------

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

// delta = rowsum(P * dP) of each query row, from S = Q K^T and dP = dO V^T
// over the key tiles the row admits
template <int DP, int NW>
__global__ void __launch_bounds__(128 * (NW + 1), 1)
delta_kernel(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap tdo,
             const float* __restrict__ lse, float* __restrict__ delta,
             int Hq, int Hkv, int Sq, int Skv, int causal, int window,
             float scale_log2) {
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
    // into a ring
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
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % T::ST;
        if (i >= T::ST) bar_wait(&empty[s], (i / T::ST - 1) & 1);
        bar_expect(&full[s], 2 * T::KV_BYTES);
        const int k0 = (kt0 + i) * kTile;
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
    float dla = 0.f, dlb = 0.f;   // this thread's columns' share

    float sc[kTile / 2], dp[kTile / 2];
#pragma unroll
    for (int i = 0; i < kTile / 2; ++i) sc[i] = dp[i] = 0.f;

    bar_wait_spin(qbar, 0);
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % T::ST;
      const int k0 = (kt0 + i) * kTile;
      bar_wait_spin(&full[s], (i / T::ST) & 1);
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
        wg_wait<0>();
        fence_regs(sc);
        fence_regs(dp);

        const bool edge = k0 + kTile > Skv ||
                          (causal && k0 + kTile - 1 > wlo) ||
                          (window > 0 && k0 <= whi - window);
        // a delta of 0 makes dp P * dP
        p_and_ds<kTile>(
            sc, dp, scale_log2, edge,
            [&](int, int r, float& l2, float& dl) {
              l2 = r / 2 ? l2b : l2a;
              dl = 0.f;
            },
            [&](int j, int r) {
              const int kp = k0 + 8 * j + 2 * (lane % 4) + r % 2;
              const int qp = r / 2 ? qb : qa;
              return kp < Skv && (!causal || kp <= qp) &&
                     (window <= 0 || kp > qp - window);
            });
#pragma unroll
        for (int j = 0; j < kTile / 8; ++j) {
          dla += dp[4 * j] + dp[4 * j + 1];
          dlb += dp[4 * j + 2] + dp[4 * j + 3];
        }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[s]);
    }
    dla = quad_sum(dla);
    dlb = quad_sum(dlb);
    if (lane % 4 == 0) {
      if (ra < Sq) delta[at + ra] = dla;
      if (rb < Sq) delta[at + rb] = dlb;
    }
  }
}

// ---- dQ (D > 64) -----------------------------------------------------------


// delta as delta_kernel sums it, then a second walk forms dS and dQ =
// dS K scale, into dq (bf16)
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

    bar_wait_spin(qbar, 0);
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
      bar_wait_spin(&full[s], (i / T::ST) & 1);
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
        wg_wait<0>();
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
          // dQ += dS K, dS rounded once, one commit group; K
          // MN-major: k-step kk is 16 key rows on
          uint32_t dh[kTile / 16][4];
          round_frags<kTile>(dp, dh);
          fence_regs(dqa);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < kTile / 16; ++kk) {
            const uint64_t bk = desc(Kt + kk * 16 * 128, kTile * 128, 1024);
            wgmma_rs<DP>(dqa, dh[kk], bk);
          }
          wg_commit();
          wg_wait<0>();
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

// ---- dK/dV and dQ's shares -----------------------------------------------

// DP: the head dim padded to whole sub-tiles; NW: consumer warpgroups, 64
// keys each; kShare: the block also forms its dQ shares.  A block keeps 64
// of dK's and dV's columns (kSub; the grid's Z column blocks at D 128 and
// 256) and the same 64 of dQ's.
template <int DP, int NW, bool kShare>
struct KVTiles {
  static constexpr int NC = DP / kSub;
  static constexpr int Z = DP / kSub;                  // column blocks
  static constexpr int ST = DP == 64 ? 4 : 2;          // ring stages
  static constexpr int SB = kShare ? 3 : 0;            // dQ staging buffers
  static constexpr int KV_BYTES = 64 * NW * DP * 2;    // the block's K or V
  static constexpr int Q_BYTES = kTile * DP * 2;       // one Q or dO tile
  static constexpr int DS_BYTES = 64 * kTile * 2;      // a warpgroup's dS^T
  static constexpr int STAGE_BYTES = kChunk * 4;       // a dQ^T share, f32
  static constexpr int STAT_FLOATS = 2 * kTile;        // a stage's lse, delta
  static constexpr int BAR_BYTES = 8 * (2 * ST + 1 + 3 * SB);
  static constexpr int SMEM = 2 * KV_BYTES + ST * 2 * Q_BYTES +
                              (kShare ? NW * DS_BYTES : 0) +
                              SB * STAGE_BYTES + ST * STAT_FLOATS * 4 +
                              BAR_BYTES + 16 + 1024;
};

// the first key block whose walk holds query tile t: a window's far edge
// (every key block from it to the causal diagonal walks t)
__device__ __forceinline__ int first_block(int t, int window, int off,
                                           int keys) {
  return window > 0 ? max(0, t * kTile - window + 1 + off) / keys : 0;
}

template <int DP, int NW, bool kShare>
__global__ void __launch_bounds__(128 * (NW + 1), 1)
dkdv_kernel(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const __grid_constant__ CUtensorMap tdo,
            const float* __restrict__ lse, const float* __restrict__ delta,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
            float* __restrict__ dq_acc, int* __restrict__ counters,
            int nkv, int Hq, int Hkv, int Sq, int Skv, int D, int causal,
            int window, float scale_log2, float scale) {
  using T = KVTiles<DP, NW, kShare>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* Vs = Ks + T::KV_BYTES;
  uint8_t* Qs = Vs + T::KV_BYTES;      // stage s: Q, then dO
  uint8_t* dSs = Qs + T::ST * 2 * T::Q_BYTES;
  float* stage =
      reinterpret_cast<float*>(dSs + (kShare ? NW * T::DS_BYTES : 0));
  float* stats = stage + T::SB * kChunk;
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + T::ST * T::STAT_FLOATS);
  uint64_t* empty = full + T::ST;
  uint64_t* kvbar = empty + T::ST;
  uint64_t* dqfull = kvbar + 1;        // a staging buffer's share is in
  uint64_t* dqempty = dqfull + T::SB;  // its reduction has read it
  uint64_t* dqhalf = dqempty + T::SB;  // the first warpgroup's part is in
  int* ticket_s = reinterpret_cast<int*>(dqhalf + T::SB);

  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < T::ST; ++s) {
      bar_init(&full[s], 32);           // the producer warp's lanes
      bar_init(&empty[s], 4 * NW);      // every consumer warp
    }
    bar_init(kvbar, 1);
    for (int e = 0; e < T::SB; ++e) {
      bar_init(&dqfull[e], 128);        // the last warpgroup's threads
      bar_init(&dqempty[e], 1);         // the writer
      bar_init(&dqhalf[e], 128);        // the first warpgroup's threads
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // with shares, blocks take their work in the order they start: a
    // block waits only on the dQ shares of blocks that started before it
    if constexpr (kShare) *ticket_s = atomicAdd(counters, 1);
  }
  __syncthreads();
  // the block's KV head, key block and column block: by ticket, key
  // blocks in ascending order (with shares), else the grid's
  const int ticket = kShare ? *ticket_s : 0;
  const int z = kShare ? ticket % T::Z : (int)blockIdx.z;
  const int kvh = kShare ? (ticket / T::Z) % nkv : (int)blockIdx.x;
  const int yb = kShare ? ticket / (T::Z * nkv) : (int)blockIdx.y;
  const int b = kvh / Hkv, hk = kvh % Hkv;
  const int group = Hq / Hkv;
  const int keys = 64 * NW;
  const int k0 = yb * keys;
  const int c0 = z * kSub;
  const int off = Skv - Sq;
  const int NT = (Sq + kTile - 1) / kTile;
  // the queries that admit a key of the block, in kTile tiles
  const int k_hi = min(k0 + keys, Skv) - 1;
  const int q_first = causal ? max(0, k0 - off) : 0;
  const int q_last = window > 0 ? min(Sq - 1, k_hi + window - 1 - off)
                                : Sq - 1;
  const int qt0 = q_first / kTile;
  const int ntq = q_last >= q_first ? q_last / kTile - qt0 + 1 : 0;
  const int ntiles = group * ntq;
  // walk i: with shares, query tile qt0 + ntq - 1 - i / group (the last
  // first, so that every block reaches a tile about when its predecessors
  // do) of query head hk group + i % group; else query tile qt0 + i % ntq
  // of head hk group + i / ntq
  auto tile_of = [&](int i) {
    return kShare ? qt0 + ntq - 1 - i / group : qt0 + i % ntq;
  };
  auto head_of = [&](int i) {
    return b * Hq + hk * group + (kShare ? i % group : i / ntq);
  };
  // whether warpgroup w's keys [kw0, kw0 + 64) see none of tile t's rows
  auto skips = [&](int w, int t) {
    const int kw0 = k0 + 64 * w;
    const int qlo = t * kTile + off;
    const int qhi = min(t * kTile + kTile, Sq) - 1 + off;
    return kw0 >= Skv || (causal && kw0 > qhi) ||
           (window > 0 && min(kw0 + 63, Skv - 1) <= qlo - window);
  };

  const int wg = tid / 128;
  const int lane = tid % 32;
  if (wg == NW) {
    // ---- producer: its first warp loads K/V once, then each tile's Q and
    // dO by TMA (lane 0) and its lse (log2 units) and delta (every lane);
    // with shares, lane 0 of its second warp (the writer) adds the block's
    // dQ shares into dq_acc in their turn
    if constexpr (NW > 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    const int pw = tid / 32 - 4 * NW;
    if (pw == 0) {
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
        const int bh = head_of(i);
        const int q0 = tile_of(i) * kTile;
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
    } else if (kShare && pw == 1 && lane == 0) {
      // the writer: tile t's dQ^T share (both warpgroups' keys) goes into
      // chunk (head, t, z) of dq_acc as link yb - first block of that
      // chunk's chain once the links before it have landed (the first
      // link writes the chunk, the others add to it).  The staging buffer
      // goes back once the copy has read it, and the link is passed on
      // (the counter advanced) once it has landed.
      for (int i = 0; i < ntiles; ++i) {
        const int t = tile_of(i);
        const int64_t chunk = ((int64_t)head_of(i) * NT + t) * T::Z + z;
        int* const ctr = counters + 1 + chunk;
        const int link = yb - first_block(t, window, off, keys);
        const int sb = i % T::SB;
        bar_wait(&dqfull[sb], (i / T::SB) & 1);
        wait_until_eq(ctr, link);
        fence_async_global();
        if (link == 0)
          bulk_copy_f32(dq_acc + chunk * kChunk, stage + sb * kChunk,
                        T::STAGE_BYTES);
        else
          bulk_reduce_add_f32(dq_acc + chunk * kChunk, stage + sb * kChunk,
                              T::STAGE_BYTES);
        bulk_commit();
        bulk_wait_read<0>();
        bar_arrive(&dqempty[sb]);
        bulk_wait<0>();
        fence_async_global();
        add_release(ctr, 1);
      }
    }
  } else {
    // ---- consumer warpgroup wg: keys [kw0, kw0 + 64)
    if constexpr (NW > 1)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (tid % 128) / 32;
    const int kw0 = k0 + 64 * wg;
    const int ka = kw0 + 16 * warp + lane / 4, kb = ka + 8;
    const uint8_t* Kw = Ks + wg * T::NC * 64 * 128;
    const uint8_t* Vw = Vs + wg * T::NC * 64 * 128;
    uint8_t* dSw = dSs + wg * T::DS_BYTES;
    // dO's, Q's and K's sub-tile of columns c0 on: the B operands of dV and
    // dK, the A operand of dQ^T
    const int csub = z * kTile * 128;

    float dka[kSub / 2], dva[kSub / 2];
#pragma unroll
    for (int i = 0; i < kSub / 2; ++i) dka[i] = dva[i] = 0.f;

    bar_wait_spin(kvbar, 0);
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % T::ST;
      const int t = tile_of(i);
      const int q0 = t * kTile;
      const bool has = !skips(wg, t);
      float dqt[kTile / 2];
      bar_wait_spin(&full[s], (i / T::ST) & 1);
      if (has) {
        const int qlo = q0 + off, qhi = min(q0 + kTile, Sq) - 1 + off;
        const uint8_t* Qt = Qs + s * 2 * T::Q_BYTES;
        const uint8_t* dOt = Qt + T::Q_BYTES;
        const float* lse2 = stats + s * T::STAT_FLOATS;
        const float* dlt = lse2 + kTile;
        // S^T = K Q^T and dP^T = V dO^T, K-major both (their first k-step
        // and dQ^T's ignore what the registers held)
        float st[kTile / 2], dpt[kTile / 2];
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
        wg_wait<0>();
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

        // dV += P^T dO (P in two bf16 parts) and dK += dS^T Q (dS rounded
        // once; without shares, also what that rounding left), one commit
        // group; dO and Q MN-major: k-step kk is 16 query rows on
        uint32_t ph[kTile / 16][4], pl[kTile / 16][4], dh[kTile / 16][4];
        uint32_t dl[kTile / 16][4];
        split_frags<kTile>(st, ph, pl);
        if constexpr (kShare)
          round_frags<kTile>(dpt, dh);
        else
          split_frags<kTile>(dpt, dh, dl);
        fence_regs(dva);
        fence_regs(dka);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          const uint64_t bo =
              desc(dOt + csub + kk * 16 * 128, kTile * 128, 1024);
          wgmma_rs<kSub>(dva, ph[kk], bo);
          wgmma_rs<kSub>(dva, pl[kk], bo);
        }
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          const uint64_t bq =
              desc(Qt + csub + kk * 16 * 128, kTile * 128, 1024);
          wgmma_rs<kSub>(dka, dh[kk], bq);
          if constexpr (!kShare) wgmma_rs<kSub>(dka, dl[kk], bq);
        }
        wg_commit();
        if constexpr (kShare) {
          // dS^T (keys x queries) into shared memory, 128-byte swizzled: the
          // B operand of dQ^T = K^T dS^T, whose last product has completed
          // (the wait below) in every warp (the barrier)
          named_sync(1 + wg, 128);
#pragma unroll
          for (int j = 0; j < kTile / 8; ++j) {
            const int ra = 16 * warp + lane / 4, rb = ra + 8;
            const int cb = 4 * (lane % 4);
            *reinterpret_cast<uint32_t*>(dSw + ra * 128 +
                                         ((j ^ (ra % 8)) << 4) + cb) =
                dh[j / 2][(j % 2) * 2];
            *reinterpret_cast<uint32_t*>(dSw + rb * 128 +
                                         ((j ^ (rb % 8)) << 4) + cb) =
                dh[j / 2][(j % 2) * 2 + 1];
        }
        fence_async_smem();
        named_sync(1 + wg, 128);
        // dQ^T (64 of its columns x 64 queries) = K^T dS^T over this
        // warpgroup's keys: K (from column c0) and dS^T MN-major, k-step
        // kk 16 keys on
        fence_regs(dqt);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_mn64(dqt, desc(Kw + csub + kk * 16 * 128, 64 * 128, 1024),
                        desc(dSw + kk * 16 * 128, kTile * 128, 1024), kk > 0);
        wg_commit();
        }
        wg_wait<0>();
        fence_regs(dva);
        fence_regs(dka);
        fence_regs(dqt);
      }
      if constexpr (kShare) {
        // the block's share of tile t: one warpgroup's part into the staging
        // buffer once the writer has sent the buffer's last share, then the
        // other's added to it (warpgroup i % 2 first: neither waits on the
        // other every tile)
        const int sb = i % T::SB;
        float* const out = stage + sb * kChunk;
        if (wg == (NW == 1 ? 0 : i % 2)) {
          if (i >= T::SB) bar_wait_spin(&dqempty[sb], (i / T::SB - 1) & 1);
          stage_share<false>(out, dqt, has, warp, lane);
          fence_async_smem();
          bar_arrive(NW == 1 ? &dqfull[sb] : &dqhalf[sb]);
      } else {
        bar_wait_spin(&dqhalf[sb], (i / T::SB) & 1);
        if (has) stage_share<true>(out, dqt, true, warp, lane);
        fence_async_smem();
        bar_arrive(&dqfull[sb]);
      }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[s]);
    }

    // a key no query admits gets zeros
    const int64_t base = (int64_t)kvh * Skv * D;
#pragma unroll
    for (int j = 0; j < kSub / 8; ++j) {
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

// dq = scale * dq_acc in bf16: one 64 x 64 chunk (head, query tile, column
// block) a block, transposed through shared memory
__global__ void __launch_bounds__(256)
dq_epilogue(const float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dq,
            int Sq, int D, int NT, int Z, float scale) {
  __shared__ float tile[kTile][kSub + 1];    // [query][column]
  const int64_t chunk = blockIdx.x;
  const int z = (int)(chunk % Z);
  const int t = (int)((chunk / Z) % NT);
  const int64_t bh = chunk / ((int64_t)Z * NT);
  const float* src = dq_acc + chunk * kChunk;
  for (int e = threadIdx.x; e < kChunk; e += 256) {
    const int d = e / kTile, slot = e % kTile;
    const int q = 2 * ((slot / 2) ^ ((d % 8) << 2)) + slot % 2;
    tile[q][d] = src[e];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kTile * kSub / 2; e += 256) {
    const int q = e / (kSub / 2), d = 2 * (e % (kSub / 2));
    const int row = t * kTile + q, col = z * kSub + d;
    if (row < Sq && col < D)
      *reinterpret_cast<uint32_t*>(dq + (bh * Sq + row) * D + col) =
          pack_bf16(tile[q][d] * scale, tile[q][d + 1] * scale);
  }
}

// ---- host ---------------------------------------------------------------

// the workspace (4-byte words, each part on a 16-byte boundary): delta
// (B Hq Sq f32), the counters (the blocks' ticket, then one a dq_acc
// chunk) and dq_acc (B Hq NT chunks of kChunk f32), the last two at D <=
// 64 only (the dQ shares' route); what kernels/flash_attention.py's
// _bwd_workspace_words computes
struct Workspace {
  float* delta;
  int* counters;
  float* dq_acc;
  int64_t chunks;
};

inline int64_t up4(int64_t n) { return (n + 3) / 4 * 4; }

inline Workspace carve(void* ws, int B, int Hq, int Sq, bool shares) {
  Workspace w;
  w.chunks = shares ? (int64_t)B * Hq * ((Sq + kTile - 1) / kTile) : 0;
  w.delta = static_cast<float*>(ws);
  w.counters = reinterpret_cast<int*>(w.delta + up4((int64_t)B * Hq * Sq));
  w.dq_acc = reinterpret_cast<float*>(w.counters + up4(1 + w.chunks));
  return w;
}

// kShare (D <= 64): the delta pass, the dK/dV pass with the dQ shares and
// their epilogue; else the dQ pass (delta, then dQ) and the dK/dV pass
template <int DP, int NW, bool kShare>
int launch(const void* q, const void* k, const void* v, const void* lse,
           const void* dout, void* dq, void* dk, void* dv, void* workspace,
           int B, int Hq, int Hkv, int Sq, int Skv, int D, int causal,
           int window, float scale, cudaStream_t stream) {
  using KV = KVTiles<DP, NW, kShare>;
  using Q = QTiles<DP, NW>;
  static bool sized = false;
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        dkdv_kernel<DP, NW, kShare>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, KV::SMEM);
    if (err == cudaSuccess)
      err = kShare ? cudaFuncSetAttribute(
                         delta_kernel<DP, NW>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, Q::SMEM)
                   : cudaFuncSetAttribute(
                         dq_kernel<DP, NW>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, Q::SMEM);
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

  const Workspace ws = carve(workspace, B, Hq, Sq, kShare);
  const float scale_log2 = scale * kLog2e;
  const dim3 qgrid((unsigned)(B * Hq),
                   (unsigned)((Sq + 64 * NW - 1) / (64 * NW)));
  const int nkv = B * Hkv;
  const int nyb = (Skv + 64 * NW - 1) / (64 * NW);
  dim3 kgrid((unsigned)nkv, (unsigned)nyb, (unsigned)KV::Z);
  if constexpr (kShare) {
    if ((err = (int)cudaMemsetAsync(ws.counters, 0, 4 * (1 + ws.chunks),
                                    stream)) != 0)
      return err;
    delta_kernel<DP, NW><<<qgrid, 128 * (NW + 1), Q::SMEM, stream>>>(
        maps[0], maps[1], maps[2], maps[3], (const float*)lse, ws.delta,
        Hq, Hkv, Sq, Skv, causal, window, scale_log2);
    kgrid = dim3((unsigned)((int64_t)nkv * nyb * KV::Z));
  } else {
    dq_kernel<DP, NW><<<qgrid, 128 * (NW + 1), Q::SMEM, stream>>>(
        maps[0], maps[1], maps[2], maps[3], (const float*)lse, ws.delta,
        (__nv_bfloat16*)dq, Hq, Hkv, Sq, Skv, D, causal, window,
        scale_log2, scale);
  }
  if ((err = (int)cudaGetLastError()) != 0) return err;
  dkdv_kernel<DP, NW, kShare><<<kgrid, 128 * (NW + 1), KV::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], (const float*)lse, ws.delta,
      (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, ws.dq_acc, ws.counters, nkv,
      Hq, Hkv, Sq, Skv, D, causal, window, scale_log2, scale);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  if constexpr (kShare) {
    dq_epilogue<<<(unsigned)ws.chunks, 256, 0, stream>>>(
        ws.dq_acc, (__nv_bfloat16*)dq, Sq, D, (Sq + kTile - 1) / kTile,
        KV::Z, scale);
    err = (int)cudaGetLastError();
  }
  return err;
}

}  // namespace

// Contiguous (B, H, S, D) bf16 q, k, v, dout and dq, dk, dv on 16-byte
// boundaries, D a multiple of 8 up to 256, Hq a multiple of Hkv, no fully
// masked row; lse (B, Hq, Sq) f32 from the forward; workspace the scratch
// that carve() lays out (the wrapper checks all of these and sizes it).
// Returns the runtime's error code, or 10000 when the driver's
// cuTensorMapEncodeTiled is not found, or 20000 + the driver's code when
// it refuses a map.
extern "C" int repro_flash_attention_bwd_tc(
    const void* q, const void* k, const void* v, const void* lse,
    const void* dout, void* dq, void* dk, void* dv, void* workspace,
    int batch, int hq, int hkv, int sq, int skv, int d, int causal,
    int window, float scale, void* stream) {
  if (batch <= 0 || sq <= 0) return 0;
  if (d <= 0 || d > 256 || d % 8 != 0 || hkv <= 0 || hq % hkv != 0 ||
      skv <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (d <= 64)
    return launch<64, 2, true>(q, k, v, lse, dout, dq, dk, dv, workspace,
                               batch, hq, hkv, sq, skv, d, causal, window,
                               scale, s);
  if (d <= 128)
    return launch<128, 2, false>(q, k, v, lse, dout, dq, dk, dv, workspace,
                                 batch, hq, hkv, sq, skv, d, causal, window,
                                 scale, s);
  return launch<256, 1, false>(q, k, v, lse, dout, dq, dk, dv, workspace,
                               batch, hq, hkv, sq, skv, d, causal, window,
                               scale, s);
}
