// flash_attention_tc: the bf16 flash_attention on Hopper's tensor cores.
// Causal grouped-query attention with an online softmax and an optional
// sliding window, q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D) bf16 -> (B, Hq,
// Sq, D) bf16.  Replaces the TPU kernel src/repro/kernels/
// flash_attention.py:72 flash_attention (_kernel) for bf16; f32 stays on
// the SIMT kernel of csrc/flash_attention.cu (tensor cores would mean
// TF32, which the f32 contract of 1e-4 does not allow).
//
// Function, as the SIMT kernel's: scale 1/sqrt(D); query i sits at
// absolute position i + Skv - Sq; key j is admitted when j < Skv,
// j <= qpos (causal) and j > qpos - window (window > 0); query head h
// reads KV head h / (Hq/Hkv) in place.  Softmax statistics (m, l) and the
// output accumulator are f32; the output is rounded once to bf16.  One
// deliberate difference from the TPU kernel, which multiplies p in f32:
// P is rounded to bf16 as the A operand of the P.V product (a relative
// error of at most 2**-9 a term, far inside the bf16 tolerance).  Rows
// with no admitted key are refused by the wrapper, so l > 0 here.
//
// Bound on an H100: operations.  Each admitted (q, k) pair costs 4 D flops
// (kernels/flash_attention.py: admitted_pairs); at the bf16 tensor-core
// rate of 989 TFLOP/s, B 1 x 16 heads x S 32,768 x D 64 (2.2 TFLOP) takes
// 2.2 ms, and its bytes take 0.04 ms at 3.35 TB/s.  The softmax is a
// second bound beside it: each pair also costs one exp2 on the MUFU, 16 a
// clock an SM (~3.9 T/s on the card), ~0.26 ps a pair, which at D 64 is
// as long as its 256 tensor-core flops (0.26 ps).  With the products and
// the softmax in series a kernel cannot pass ~50% of the bound at D 64;
// only running them at once can.
//
// Design, for those bounds:
// - Both products run on the tensor cores as wgmma (sm_90a): S = Q.K^T is
//   m64nTk k16 with Q and K read from shared memory (K-major); O += P.V is
//   m64nDP k16 with P in registers (the S accumulator's layout is the A
//   fragment's, so P never touches shared memory) and V read MN-major
//   through the descriptor's transpose.
// - A block is consumer warpgroups of 64 query rows and one producer
//   warpgroup whose single thread issues TMA loads (setmaxnreg moves
//   registers from it to the consumers).  A consumer holds S, P and O in
//   registers: at D 64 (128-key tiles: 64 + 32 + 32) and D 128 (64-key
//   tiles: 32 + 16 + 64) three consumers fit 160 registers each, 192
//   queries a block; at D 256 (64-key tiles: 32 + 16 + 128) two fit 240.
//   At D 128 the 64-key tile is what lets a third warpgroup in: 192 rows
//   read each staged K/V tile where 128 did, a third fewer bytes from L2
//   for the same flops (Danube's heads went from 0.804-0.810 ms to
//   0.735-0.757; L2's own rate is not measured).  Q is loaded
//   once; K and V tiles go through a ring of as many stages as shared
//   memory holds (6, 5 and 2), each with a "full" mbarrier (TMA bytes) and
//   an "empty" one (every consumer warp).
// - A consumer issues tile i's S and tile i - 1's P.V back to back, waits
//   for S alone (wgmma.wait_group 1), and runs tile i's softmax while that
//   P.V and the other consumers' products run on the tensor cores; then
//   it waits for the P.V, releases tile i - 1's stage, rescales O and
//   rounds P to bf16.  The softmax takes 2**x by ex2.approx.ftz (relative
//   error 2**-22, as the backward's).  Only the tiles that straddle the
//   diagonal, the window's edge or Skv run the masked softmax, compiled
//   apart: each row's admitted keys as two bounds, held against the
//   columns a register holds, which are constants.
// - Every wgmma is issued, committed and waited on unconditionally, and
//   every branch near one depends on the block and the tile alone (the
//   warpgroup is a template argument): ptxas serializes every wgmma of a
//   kernel where a branch it takes for divergent writes registers a wgmma
//   reads (its C7518 and C7520 notes).  A warpgroup walks the tiles that
//   admit its rows in one loop and only waits on and releases the others.
// - The consumers' mbarrier waits spin without a trap (the producer's
//   keep one): a __trap() on their path holds ptxas at the launch bound's
//   registers whatever setmaxnreg.inc asks.  ptxas -v (build.py keeps it):
//   0 bytes of spills in all three kernels, 128 registers a thread at
//   launch at D 64 and D 128 (512 threads), 168 at D 256 (384).
// - Tiles are 128-byte swizzled: 64 columns (128 bytes) a sub-tile, so D 64
//   is one sub-tile, D 120 and 128 two, D 256 four.  TMA fills the columns
//   past D (120 -> 128) and the rows past Sq or Skv with zeros, so the
//   ragged edges cost no code in the loop.  The tensor maps are encoded on
//   the host per call (cuTensorMapEncodeTiled through the runtime's driver
//   entry point, no -lcuda) and passed as __grid_constant__ parameters.
// - The grid is (B * Hq, query tiles), the query tiles reversed, so the
//   heaviest causal tiles of every head start first.
// - For a gradient the kernel also writes each row's logsumexp (natural
//   log, f32, (B, Hq, Sq)), which the backward (flash_attention_bwd_tc.cu)
//   reads; with a null pointer it writes none, so serving's prefill does
//   no extra work.  Nothing is atomic and every sum runs in one order:
//   two calls give the same bits.
//
// Times on an H100 80GB HBM3 at 700 W, each step beside the others in one
// call, 6 timings each (scripts/attention_bwd_probe.py --forward-tc; ms,
// 1 x 16 x 8,192 x 64 / 1 x 16 x 32,768 x 64 / Danube's 32:8 x 8,192 x
// 120, window 4,096 / 4 x 16 x 4,096 x 64): the earlier design 0.427-0.432
// / 6.26-6.43 / 0.844-0.875 / 0.481-0.488; consumer waits without the trap
// 0.406 / 6.03-6.10 / 0.839-0.900 / 0.460-0.469; ex2.approx and the masked
// softmax compiled apart 0.389-0.394 / 5.82-5.96 / 0.827-0.850 /
// 0.443-0.447; S issued with the previous P.V, every wgmma unconditional,
// the cheaper mask 0.316-0.318 / 4.99-5.07 / 0.818-0.843 / 0.353-0.368;
// three consumers at D 64 0.293-0.295 / 4.41-4.51 / - / 0.332-0.337 (with
// the pingpong below); 64-key tiles and three consumers at D 128: this
// kernel, 0.293-0.294 / 4.43-4.56 / 0.735-0.757 / 0.326-0.335 (SDPA in
// the same runs 0.341-0.342 / 4.68-5.00 / 3.90-4.01 with a boolean mask /
// 0.325-0.338).  Dropped: the next tile's S issued under this tile's
// softmax into a second S register set at D 64 (76 bytes of spills,
// 0.419-0.423 against one set's 0.352-0.357), the consumers issuing their
// products in turns on named barriers (two consumers at D 64: 0.341-0.347
// against 0.316-0.318; three: 0.295-0.302 against 0.293-0.294), O
// rescaled between issuing S and P.V (no gain), O rescaled only where a
// warp's row maxima moved (part of the second step; a branch ptxas takes
// for divergent, dropped with the others), and four consumers of 64-key
// tiles at D 64 (did not finish).
// Left for later: a block serving all query heads of a KV head (GQA
// sharing of the staged K/V), a TMA store of the output, persistent
// blocks that load the next tile's Q under the current one, and fp8.
#include <type_traits>

#include "hopper_tc.cuh"

namespace {

using namespace repro_torch;

constexpr int kProducerRegs = 24;          // setmaxnreg.dec of the producer

// keys a K/V tile at padded head dim DP
constexpr int tile_keys_of(int DP) { return DP == 64 ? 128 : 64; }

// DP: the head dim padded to whole sub-tiles; TK: keys a K/V tile
template <int DP, int TK>
struct Tiles {
  static constexpr int NC = DP / kSub;             // sub-tiles a row
  // a consumer thread's tile state in registers: S, P (bf16 pairs), O
  static constexpr int STATE = TK / 2 + TK / 4 + DP / 2;
  // consumer warpgroups of 64 query rows each, and the registers a
  // consumer thread takes (setmaxnreg.inc): three at 160 where the state
  // fits (D 64: 128; D 128: 112), else two at 240 (D 256: 176)
  static constexpr int CW = STATE <= 128 ? 3 : 2;
  static constexpr int REGS = CW == 3 ? 160 : 240;
  static constexpr int THREADS = 128 * (CW + 1);   // and a producer's
  static constexpr int TQ = 64 * CW;               // queries a block
  static constexpr int Q_BYTES = TQ * DP * 2;      // every warpgroup's Q
  static constexpr int KV_BYTES = TK * DP * 2;     // one K or V tile
  // ring stages: as many as the 232,448 bytes of a block hold, up to 6 (a
  // consumer holds two at once)
  static constexpr int ST_FIT =
      (232448 - 1024 - 8 * 13 - Q_BYTES) / (2 * KV_BYTES);
  static constexpr int ST = ST_FIT < 6 ? ST_FIT : 6;
  static constexpr int BAR_BYTES = 8 * (2 * ST + 1);
  // + 1024: the swizzled tiles start on 1,024-byte boundaries
  static constexpr int SMEM = Q_BYTES + 2 * ST * KV_BYTES + BAR_BYTES + 1024;
  static_assert(ST >= 2 && SMEM <= 232448, "the ring does not fit");
};

// What a consumer warpgroup carries through its key tiles: the f32 output
// accumulator, S, P as bf16 A fragments, and the online softmax's
// statistics of this thread's two rows (ra and ra + 8).
//
// Every wgmma is issued, committed and waited on unconditionally: a step's
// shape (whether it issues P.V) is a template argument, and the only
// runtime branches near them depend on the block and the tile alone
// (uniform: consume's warpgroup is a template argument).  A branch ptxas
// takes for divergent that writes registers a wgmma reads makes it insert
// waits and fences of its own, and then it serializes every wgmma of the
// kernel (its C7518 and C7520).  So a warpgroup walks the tiles that admit
// its rows in one loop and idles through the others in loops of their
// own, all their bounds uniform.
template <int DP, int TK>
struct Consumer {
  using T = Tiles<DP, TK>;
  const uint8_t* Qw;
  const uint8_t* Ks;
  const uint8_t* Vs;
  uint64_t* full;
  uint64_t* empty;
  int kt0, ntiles, lane, qa, qb, wlo, whi, Skv, causal, window;
  float scale_log2;

  float o[DP / 2], s[TK / 2];
  uint32_t pa[TK / 16][4];
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  // tile t straddles the diagonal, the window's edge or Skv
  __device__ __forceinline__ bool edge(int t) const {
    const int k0 = (kt0 + t) * TK;
    return k0 + TK > Skv || (causal && k0 + TK - 1 > wlo) ||
           (window > 0 && k0 <= whi - window);
  }

  // s = Q . K_t^T, K-major both: k-step kk is 32 bytes into sub-tile
  // kk / 4; 8-row groups 1,024 bytes apart; one commit group
  __device__ __forceinline__ void qk(float (&s)[TK / 2], int t) {
    const uint8_t* Kt = Ks + (t % T::ST) * T::KV_BYTES;
    fence_regs(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss<TK>(s, desc(Qw + (kk / 4) * 64 * 128 + (kk % 4) * 32, 16, 1024),
                   desc(Kt + (kk / 4) * TK * 128 + (kk % 4) * 32, 16, 1024),
                   kk > 0);
    wg_commit();
  }

  // O += P . V_t, V MN-major: k-step kk is 16 key rows (2,048 bytes) on;
  // 8-row groups 1,024 bytes apart, 64-column sub-tiles TK * 128; one
  // commit group
  __device__ __forceinline__ void pv(int t) {
    const uint8_t* Vt = Vs + (t % T::ST) * T::KV_BYTES;
    fence_regs(o);
    fence_regs(pa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      wgmma_rs<DP>(o, pa[kk], desc(Vt + kk * 16 * 128, TK * 128, 1024));
    wg_commit();
  }

  __device__ __forceinline__ void release(int t) {
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[t % T::ST]);
  }

  __device__ __forceinline__ void wait_full(int t) {
    bar_wait_spin(&full[t % T::ST], (t / T::ST) & 1);
  }

  // the online softmax of tile t in log2 units: P = 2**(S scale - m) in
  // place of S, l and m updated, al_* the factors O's rows are to be
  // rescaled by.  A row with nothing admitted so far keeps p = 0.  The
  // masked form is compiled apart and runs on edge tiles only.
  // Register i of a 64 x N accumulator: row ra + 8 ((i / 2) % 2), column
  // 8 (i / 4) + 2 (lane % 4) + i % 2.
  template <bool MASKED>
  __device__ __forceinline__ void softmax(float (&s)[TK / 2], int t,
                                          float& al_a, float& al_b) {
    if constexpr (MASKED) {
      // each row's admitted keys as [lo, hi) past this thread's first key
      // of the tile, c0: register r holds key c0 + 8 (r / 4) + r % 2
      const int c0 = (kt0 + t) * TK + 2 * (lane % 4);
      const int hi_a = causal ? min(Skv, qa + 1) - c0 : Skv - c0;
      const int hi_b = causal ? min(Skv, qb + 1) - c0 : Skv - c0;
      const int lo_a = window > 0 ? qa - window + 1 - c0 : -TK;
      const int lo_b = window > 0 ? qb - window + 1 - c0 : -TK;
#pragma unroll
      for (int r = 0; r < TK / 2; ++r) {
        const int c = 8 * (r / 4) + r % 2;
        const bool b = (r / 2) % 2;
        if (c < (b ? lo_b : lo_a) || c >= (b ? hi_b : hi_a)) s[r] = -INFINITY;
      }
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a) * scale_log2);
    const float mn_b = fmaxf(m_b, quad_max(mx_b) * scale_log2);
    const float mu_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float mu_b = mn_b == -INFINITY ? 0.f : mn_b;
    al_a = ex2(m_a - mu_a);
    al_b = ex2(m_b - mu_b);
    m_a = mn_a;
    m_b = mn_b;
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
      s[4 * j] = ex2(fmaf(s[4 * j], scale_log2, -mu_a));
      s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], scale_log2, -mu_a));
      s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], scale_log2, -mu_b));
      s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], scale_log2, -mu_b));
      ps_a += s[4 * j] + s[4 * j + 1];
      ps_b += s[4 * j + 2] + s[4 * j + 3];
    }
    // l stays a partial sum over this thread's columns until the end
    l_a = l_a * al_a + ps_a;
    l_b = l_b * al_b + ps_b;
  }

  // tile i: the warpgroup issues S_i = Q . K_i^T and, but for the first
  // tile (PV), P_{i-1} . V_{i-1}; the softmax of tile i waits for S_i alone
  // and runs under P_{i-1} . V_{i-1} and the other warpgroups' products.
  // Tile i-1's stage is released once its P.V has completed.
  template <bool PV>
  __device__ __forceinline__ void step(int i) {
    wait_full(i);
    qk(s, i);
    if constexpr (PV) pv(i - 1);
    wg_wait<PV ? 1 : 0>();   // S_i
    fence_regs(s);
    float al_a, al_b;
    if (edge(i))
      softmax<true>(s, i, al_a, al_b);
    else
      softmax<false>(s, i, al_a, al_b);
    if constexpr (PV) {
      wg_wait<0>();   // P_{i-1} . V_{i-1}
      fence_regs(o);
      fence_regs(pa);
      release(i - 1);
    }
#pragma unroll
    for (int r = 0; r < DP / 2; ++r) o[r] *= (r / 2) % 2 ? al_b : al_a;
    round_frags<TK>(s, pa);
  }

  // a tile that admits none of this warpgroup's rows: waited on (so that
  // its release counts in its own phase of the ring) and released
  __device__ __forceinline__ void idle(int i) {
    wait_full(i);
    release(i);
  }

  // tiles [first, last] of the block's admit rows of this warpgroup (none
  // where first > last); the others it only idles through
  __device__ __forceinline__ void run(int first, int last) {
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < TK / 2; ++i) s[i] = 0.f;
    int i = 0;
    for (; i < first && i < ntiles; ++i) idle(i);
    if (first <= last) {
      step<false>(first);
      for (i = first + 1; i <= last; ++i) step<true>(i);
      pv(last);
      wg_wait<0>();
      fence_regs(o);
      release(last);
    }
    for (; i < ntiles; ++i) idle(i);
  }
};

// consumer warpgroup WG of a block: query rows [q0 + 64 WG, q0 + 64 WG +
// 64).  Its waits spin without a trap, so that ptxas gives it the
// registers setmaxnreg.inc asks for.
template <int DP, int TK, int WG>
__device__ __forceinline__ void consume(
    const uint8_t* Qs, const uint8_t* Ks, const uint8_t* Vs, uint64_t* full,
    uint64_t* empty, uint64_t* qbar, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int bh, int q0, int off, int kt0, int ntiles,
    int Sq, int Skv, int D, int causal, int window, float scale_log2) {
  const int tid = threadIdx.x;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int row0 = q0 + 64 * WG;
  // this thread's two rows of every accumulator: ra and ra + 8
  const int ra = row0 + 16 * warp + lane / 4;
  Consumer<DP, TK> c;
  c.Qw = Qs + WG * Tiles<DP, TK>::NC * 64 * 128;
  c.Ks = Ks;
  c.Vs = Vs;
  c.full = full;
  c.empty = empty;
  c.kt0 = kt0;
  c.ntiles = ntiles;
  c.lane = lane;
  c.qa = ra + off;
  c.qb = ra + 8 + off;
  c.wlo = row0 + off;
  c.whi = min(row0 + 63, Sq - 1) + off;
  c.Skv = Skv;
  c.causal = causal;
  c.window = window;
  c.scale_log2 = scale_log2;
  // the keys the rows [wlo, whi] (positions) admit, in tiles of the block
  const int k_lo = window > 0 ? max(0, c.wlo - window + 1) : 0;
  const int k_hi = causal ? min(Skv - 1, c.whi) : Skv - 1;
  const bool any = row0 < Sq;
  bar_wait_spin(qbar, 0);
  c.run(any ? k_lo / TK - kt0 : ntiles, any ? k_hi / TK - kt0 : -1);

  const float l_a = quad_sum(c.l_a), l_b = quad_sum(c.l_b);
  const float ia = 1.f / l_a, ib = 1.f / l_b;
  __nv_bfloat16* ob = out + (int64_t)bh * Sq * D;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    if (8 * j >= D) break;
    if (ra < Sq)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)ra * D + col) =
          pack_bf16(c.o[4 * j] * ia, c.o[4 * j + 1] * ia);
    if (ra + 8 < Sq)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)(ra + 8) * D + col) =
          pack_bf16(c.o[4 * j + 2] * ib, c.o[4 * j + 3] * ib);
  }
  // m is in log2 units of the scaled score: lse = (m + log2 l) ln 2
  if (lse != nullptr && lane % 4 == 0) {
    constexpr float kLn2 = 0.6931471805599453f;
    if (ra < Sq) lse[(int64_t)bh * Sq + ra] = (c.m_a + log2f(l_a)) * kLn2;
    if (ra + 8 < Sq)
      lse[(int64_t)bh * Sq + ra + 8] = (c.m_b + log2f(l_b)) * kLn2;
  }
}

template <int DP, int TK>
__global__ void __launch_bounds__(Tiles<DP, TK>::THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                int Hq, int Hkv, int Sq, int Skv, int D, int causal,
                int window, float scale_log2) {
  using T = Tiles<DP, TK>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* Ks = Qs + T::Q_BYTES;
  uint8_t* Vs = Ks + T::ST * T::KV_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + T::ST * T::KV_BYTES);
  uint64_t* empty = full + T::ST;
  uint64_t* qbar = empty + T::ST;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / Hq, h = bh % Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * T::TQ;
  const int off = Skv - Sq;
  const int qlo = q0 + off, qhi = min(q0 + T::TQ, Sq) - 1 + off;
  const int k_last = causal ? min(Skv - 1, qhi) : Skv - 1;
  const int k_first = window > 0 ? max(0, qlo - window + 1) : 0;
  const int kt0 = k_first / TK;
  const int ntiles = k_last / TK - kt0 + 1;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < T::ST; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 4 * T::CW);  // every consumer warp
    }
    bar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == T::CW) {
    // ---- producer: one thread issues every TMA load of the block; its
    // waits alone keep the trap (a load that never lands)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 128 * T::CW) {
      bar_expect(qbar, T::Q_BYTES);
      for (int w = 0; w < T::CW; ++w)
        for (int c = 0; c < T::NC; ++c)
          tma_load(Qs + (w * T::NC + c) * 64 * 128, &tq, c * kSub,
                   q0 + 64 * w, bh, qbar);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % T::ST;
        if (i >= T::ST) bar_wait(&empty[s], (i / T::ST - 1) & 1);
        bar_expect(&full[s], 2 * T::KV_BYTES);
        const int k0 = (kt0 + i) * TK;
        for (int c = 0; c < T::NC; ++c) {
          tma_load(Ks + s * T::KV_BYTES + c * TK * 128, &tk, c * kSub, k0,
                   kvh, &full[s]);
          tma_load(Vs + s * T::KV_BYTES + c * TK * 128, &tv, c * kSub, k0,
                   kvh, &full[s]);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: setmaxnreg before the branch on which one
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::REGS));
#define REPRO_CONSUME(W)                                                   \
  consume<DP, TK, W>(Qs, Ks, Vs, full, empty, qbar, out, lse, bh, q0, off, \
                     kt0, ntiles, Sq, Skv, D, causal, window, scale_log2)
    if (wg == 0) {
      REPRO_CONSUME(0);
    } else if constexpr (T::CW == 2) {
      REPRO_CONSUME(1);
    } else {
      if (wg == 1)
        REPRO_CONSUME(1);
      else
        REPRO_CONSUME(2);
    }
#undef REPRO_CONSUME
  }
}

// ---- host ---------------------------------------------------------------

// f(DP, TK) with the kernel's padded head dim and keys a tile for head dim
// d, each a std::integral_constant
template <typename F>
int with_tile(int d, F f) {
  using std::integral_constant;
  if (d <= 64)
    return f(integral_constant<int, 64>{},
             integral_constant<int, tile_keys_of(64)>{});
  if (d <= 128)
    return f(integral_constant<int, 128>{},
             integral_constant<int, tile_keys_of(128)>{});
  return f(integral_constant<int, 256>{},
           integral_constant<int, tile_keys_of(256)>{});
}

// Q's map in boxes of 64 rows (a consumer warpgroup's), K's and V's in
// boxes of a K/V tile, tk keys
int encode_all(CUtensorMap* maps, const void* q, const void* k,
               const void* v, int B, int Hq, int Hkv, int Sq, int Skv,
               int D, int tk) {
  int err = encode(&maps[0], q, D, Sq, B * Hq, 64);
  if (err == 0) err = encode(&maps[1], k, D, Skv, B * Hkv, tk);
  if (err == 0) err = encode(&maps[2], v, D, Skv, B * Hkv, tk);
  return err;
}

// lets the kernel of (DP, TK) take its shared memory (once)
template <int DP, int TK>
cudaError_t allow_smem() {
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tc_kernel<DP, TK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tiles<DP, TK>::SMEM);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  return cudaSuccess;
}

template <int DP, int TK>
int launch(const void* q, const void* k, const void* v, void* out,
           void* lse, int B, int Hq, int Hkv, int Sq, int Skv, int D,
           int causal, int window, float scale, cudaStream_t stream) {
  using T = Tiles<DP, TK>;
  const cudaError_t smem_err = allow_smem<DP, TK>();
  if (smem_err != cudaSuccess) return (int)smem_err;
  CUtensorMap maps[3];
  const int err = encode_all(maps, q, k, v, B, Hq, Hkv, Sq, Skv, D, TK);
  if (err != 0) return err;
  const dim3 grid((unsigned)(B * Hq), (unsigned)((Sq + T::TQ - 1) / T::TQ));
  flash_tc_kernel<DP, TK><<<grid, T::THREADS, T::SMEM, stream>>>(
      maps[0], maps[1], maps[2], (__nv_bfloat16*)out, (float*)lse, Hq, Hkv,
      Sq, Skv, D, causal, window, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

bool valid(int d, int hq, int hkv) {
  return d > 0 && d <= 256 && d % 8 == 0 && hkv > 0 && hq % hkv == 0;
}

}  // namespace

// Contiguous (B, H, S, D) bf16 operands on 16-byte boundaries, D a
// multiple of 8 up to 256, Hq a multiple of Hkv, no fully masked row (the
// wrapper checks all of these).  lse (B, Hq, Sq) f32 may be null; given,
// the kernel writes the rows' logsumexp there too.  Returns the runtime's
// error code, or 10000 when the driver's cuTensorMapEncodeTiled is not
// found, or 20000 + the driver's code when it refuses a map.
extern "C" int repro_flash_attention_tc(const void* q, const void* k,
                                        const void* v, void* out, void* lse,
                                        int batch, int hq, int hkv, int sq,
                                        int skv, int d, int causal,
                                        int window, float scale,
                                        void* stream) {
  if (batch <= 0 || sq <= 0) return 0;
  if (!valid(d, hq, hkv) || skv <= 0) return (int)cudaErrorInvalidValue;
  return with_tile(d, [&](auto dp, auto tk) {
    return launch<decltype(dp)::value, decltype(tk)::value>(
        q, k, v, out, lse, batch, hq, hkv, sq, skv, d, causal, window, scale,
        (cudaStream_t)stream);
  });
}

// What a launch at head dim d runs, for the records: info[0] query rows a
// block, [1] shared memory bytes, [2] registers a thread at launch (the
// launch bound's), [3] local (stack and spill) bytes a thread, [4]
// resident blocks an SM, [5] registers a consumer thread and [6] a
// producer thread after setmaxnreg, [7] keys a K/V tile, [8] ring stages.
extern "C" int repro_flash_attention_tc_config(int d, int* info) {
  if (!valid(d, 1, 1)) return (int)cudaErrorInvalidValue;
  return with_tile(d, [&](auto dp, auto tk) {
    constexpr int DP = decltype(dp)::value, TK = decltype(tk)::value;
    using T = Tiles<DP, TK>;
    cudaError_t err = allow_smem<DP, TK>();
    cudaFuncAttributes attr;
    if (err == cudaSuccess)
      err = cudaFuncGetAttributes(&attr, flash_tc_kernel<DP, TK>);
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, flash_tc_kernel<DP, TK>, T::THREADS, T::SMEM);
    if (err != cudaSuccess) return (int)err;
    const int vals[9] = {T::TQ, T::SMEM, attr.numRegs,
                         (int)attr.localSizeBytes, blocks, T::REGS,
                         kProducerRegs, TK, T::ST};
    for (int i = 0; i < 9; ++i) info[i] = vals[i];
    return 0;
  });
}

// The three tensor maps of a call, encoded and dropped: the host cost of
// the encoding alone, for timing.
extern "C" int repro_flash_attention_tc_encode(const void* q, const void* k,
                                               const void* v, int batch,
                                               int hq, int hkv, int sq,
                                               int skv, int d) {
  if (!valid(d, hq, hkv) || batch <= 0 || sq <= 0 || skv <= 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  return with_tile(d, [&](auto, auto tk) {
    return encode_all(maps, q, k, v, batch, hq, hkv, sq, skv, d,
                      decltype(tk)::value);
  });
}
