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
// 2.2 ms, and its bytes take 0.04 ms at 3.35 TB/s.
//
// Design, for that bound:
// - Both products run on the tensor cores as wgmma (sm_90a): S = Q.K^T is
//   m64nTk k16 with Q and K read from shared memory (K-major); O += P.V is
//   m64nDP k16 with P in registers (the S accumulator's layout is the A
//   fragment's, so P never touches shared memory) and V read MN-major
//   through the descriptor's transpose.
// - A block is three warpgroups: two consumers of 64 query rows each (128
//   queries a block) and one producer whose single thread issues TMA loads
//   (setmaxnreg moves registers from it to the consumers).  Q is loaded
//   once; K and V tiles of Tk keys (128 for D <= 128, 64 for D 256, which
//   keeps S and O in registers) go through a ring of ST stages, each with a
//   "full" mbarrier (TMA bytes) and an "empty" one (the consumer warps).
// - Tiles are 128-byte swizzled: 64 columns (128 bytes) a sub-tile, so D 64
//   is one sub-tile, D 120 and 128 two, D 256 four.  TMA fills the columns
//   past D (120 -> 128) and the rows past Sq or Skv with zeros, so the
//   ragged edges cost no code in the loop.  The tensor maps are encoded on
//   the host per call (cuTensorMapEncodeTiled through the runtime's driver
//   entry point, no -lcuda) and passed as __grid_constant__ parameters.
// - A block walks the tiles from the first one the window admits to the
//   last one causality admits; only the tiles that straddle the diagonal,
//   the window's edge or Skv apply the mask, and a warpgroup skips a tile
//   that admits none of its rows.  The grid is (B * Hq, query tiles), the
//   query tiles reversed, so the heaviest causal tiles of every head start
//   first.
// - For a gradient the kernel also writes each row's logsumexp (natural
//   log, f32, (B, Hq, Sq)), which the backward (flash_attention_bwd_tc.cu)
//   reads; with a null pointer it writes none, so serving's prefill does
//   no extra work.
// Left for later: a pingpong of softmax and GEMM between the two consumer
// warpgroups and inside one, a block serving all query heads of a KV head
// (GQA sharing of the staged K/V), a TMA store of the output, and fp8.
#include "hopper_tc.cuh"

namespace {

using namespace repro_torch;

constexpr int kConsumers = 2;              // consumer warpgroups a block
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kTq = 64 * kConsumers;       // queries a block

// DP: the head dim padded to whole sub-tiles; TK: keys a K/V tile
template <int DP, int TK>
struct Tiles {
  static constexpr int NC = DP / kSub;             // sub-tiles a row
  static constexpr int ST = DP == 64 ? 4 : 2;      // ring stages
  static constexpr int Q_BYTES = kTq * DP * 2;     // both warpgroups' Q
  static constexpr int KV_BYTES = TK * DP * 2;     // one K or V tile
  static constexpr int BAR_BYTES = 8 * (2 * ST + 1);
  // + 1024: the swizzled tiles start on 1,024-byte boundaries
  static constexpr int SMEM = Q_BYTES + 2 * ST * KV_BYTES + BAR_BYTES + 1024;
};

template <int DP, int TK>
__global__ void __launch_bounds__(kThreads, 1)
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
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTq;
  const int off = Skv - Sq;
  const int qlo = q0 + off, qhi = min(q0 + kTq, Sq) - 1 + off;
  const int k_last = causal ? min(Skv - 1, qhi) : Skv - 1;
  const int k_first = window > 0 ? max(0, qlo - window + 1) : 0;
  const int kt0 = k_first / TK;
  const int ntiles = k_last / TK - kt0 + 1;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < T::ST; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 4 * kConsumers);  // every consumer warp
    }
    bar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread issues every TMA load of the block
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 128 * kConsumers) {
      bar_expect(qbar, T::Q_BYTES);
      for (int w = 0; w < kConsumers; ++w)
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
    // ---- consumer warpgroup wg: query rows [q0 + 64 wg, q0 + 64 wg + 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int row0 = q0 + 64 * wg;
    // this thread's two rows of every accumulator: ra and ra + 8
    const int ra = row0 + 16 * warp + lane / 4;
    const int qa = ra + off, qb = qa + 8;
    const int wlo = row0 + off, whi = min(row0 + 63, Sq - 1) + off;
    const bool active = row0 < Sq;
    const uint8_t* Qw = Qs + wg * T::NC * 64 * 128;

    float o[DP / 2], sc[TK / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < TK / 2; ++i) sc[i] = 0.f;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

    bar_wait(qbar, 0);
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % T::ST;
      const int k0 = (kt0 + i) * TK;
      bar_wait(&full[s], (i / T::ST) & 1);
      // a tile that admits none of this warpgroup's rows is skipped
      const bool skip = !active || (causal && k0 > whi) ||
                        (window > 0 && k0 + TK - 1 <= wlo - window);
      if (!skip) {
        const uint8_t* Kt = Ks + s * T::KV_BYTES;
        const uint8_t* Vt = Vs + s * T::KV_BYTES;
        // S = Q . K^T, K-major both: k-step kk is 32 bytes into sub-tile
        // kk / 4; 8-row groups 1,024 bytes apart
        fence_regs(sc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wgmma_ss<TK>(sc,
                       desc(Qw + (kk / 4) * 64 * 128 + (kk % 4) * 32, 16,
                            1024),
                       desc(Kt + (kk / 4) * TK * 128 + (kk % 4) * 32, 16,
                            1024),
                       kk > 0);
        wg_commit();
        wg_wait0();
        fence_regs(sc);

        // register i of a 64 x N accumulator: row ra + 8 ((i / 2) % 2),
        // column 8 (i / 4) + 2 (lane % 4) + i % 2
        const bool edge = k0 + TK > Skv || (causal && k0 + TK - 1 > wlo) ||
                          (window > 0 && k0 <= whi - window);
        if (edge) {
#pragma unroll
          for (int r = 0; r < TK / 2; ++r) {
            const int kp = k0 + 8 * (r / 4) + 2 * (lane % 4) + r % 2;
            const int qp = (r / 2) % 2 ? qb : qa;
            const bool ok = kp < Skv && (!causal || kp <= qp) &&
                            (window <= 0 || kp > qp - window);
            if (!ok) sc[r] = -INFINITY;
          }
        }

        // online softmax in log2 units; a row with nothing admitted so
        // far keeps p = 0 and o = 0
        float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
        for (int j = 0; j < TK / 8; ++j) {
          mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
          mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
        const float mn_a = fmaxf(m_a, quad_max(mx_a) * scale_log2);
        const float mn_b = fmaxf(m_b, quad_max(mx_b) * scale_log2);
        const float mu_a = mn_a == -INFINITY ? 0.f : mn_a;
        const float mu_b = mn_b == -INFINITY ? 0.f : mn_b;
        const float al_a = exp2f(m_a - mu_a), al_b = exp2f(m_b - mu_b);
        m_a = mn_a;
        m_b = mn_b;
        // P as bf16 pairs in the A-fragment layout of m64n*k16: k-step kk
        // holds columns 16 kk .. 16 kk + 15, i.e. accumulator chunks 2 kk
        // (registers 0, 1) and 2 kk + 1 (registers 2, 3)
        uint32_t pa[TK / 16][4];
        float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
        for (int j = 0; j < TK / 8; ++j) {
          const float p0 = exp2f(fmaf(sc[4 * j], scale_log2, -mu_a));
          const float p1 = exp2f(fmaf(sc[4 * j + 1], scale_log2, -mu_a));
          const float p2 = exp2f(fmaf(sc[4 * j + 2], scale_log2, -mu_b));
          const float p3 = exp2f(fmaf(sc[4 * j + 3], scale_log2, -mu_b));
          ps_a += p0 + p1;
          ps_b += p2 + p3;
          pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
          pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
        }
        // l stays a partial sum over this thread's columns until the end
        l_a = l_a * al_a + ps_a;
        l_b = l_b * al_b + ps_b;
#pragma unroll
        for (int r = 0; r < DP / 2; ++r) o[r] *= (r / 2) % 2 ? al_b : al_a;

        // O += P . V, V MN-major: k-step kk is 16 key rows (2,048 bytes)
        // on; 8-row groups 1,024 bytes apart, 64-column sub-tiles TK * 128
        fence_regs(o);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk)
          wgmma_rs<DP>(o, pa[kk], desc(Vt + kk * 16 * 128, TK * 128, 1024));
        wg_commit();
        wg_wait0();
        fence_regs(o);
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[s]);
    }

    l_a = quad_sum(l_a);
    l_b = quad_sum(l_b);
    const float ia = 1.f / l_a, ib = 1.f / l_b;
    __nv_bfloat16* ob = out + (int64_t)bh * Sq * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      if (8 * j >= D) break;
      if (ra < Sq)
        *reinterpret_cast<uint32_t*>(ob + (int64_t)ra * D + c) =
            pack_bf16(o[4 * j] * ia, o[4 * j + 1] * ia);
      if (ra + 8 < Sq)
        *reinterpret_cast<uint32_t*>(ob + (int64_t)(ra + 8) * D + c) =
            pack_bf16(o[4 * j + 2] * ib, o[4 * j + 3] * ib);
    }
    // m is in log2 units of the scaled score: lse = (m + log2 l) ln 2
    if (lse != nullptr && lane % 4 == 0) {
      constexpr float kLn2 = 0.6931471805599453f;
      if (ra < Sq) lse[(int64_t)bh * Sq + ra] = (m_a + log2f(l_a)) * kLn2;
      if (ra + 8 < Sq)
        lse[(int64_t)bh * Sq + ra + 8] = (m_b + log2f(l_b)) * kLn2;
    }
  }
}

// ---- host ---------------------------------------------------------------


// keys a K/V tile of the kernel that takes head dim D
int tile_keys(int D) { return D <= 128 ? 128 : 64; }

// Q's map in boxes of 64 rows (a consumer warpgroup's), K's and V's in
// boxes of a K/V tile
int encode_all(CUtensorMap* maps, const void* q, const void* k,
               const void* v, int B, int Hq, int Hkv, int Sq, int Skv,
               int D) {
  const int tk = tile_keys(D);
  int err = encode(&maps[0], q, D, Sq, B * Hq, 64);
  if (err == 0) err = encode(&maps[1], k, D, Skv, B * Hkv, tk);
  if (err == 0) err = encode(&maps[2], v, D, Skv, B * Hkv, tk);
  return err;
}

template <int DP, int TK>
int launch(const void* q, const void* k, const void* v, void* out,
           void* lse, int B, int Hq, int Hkv, int Sq, int Skv, int D,
           int causal, int window, float scale, cudaStream_t stream) {
  using T = Tiles<DP, TK>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tc_kernel<DP, TK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::SMEM);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  CUtensorMap maps[3];
  const int err = encode_all(maps, q, k, v, B, Hq, Hkv, Sq, Skv, D);
  if (err != 0) return err;
  const dim3 grid((unsigned)(B * Hq), (unsigned)((Sq + kTq - 1) / kTq));
  flash_tc_kernel<DP, TK><<<grid, kThreads, T::SMEM, stream>>>(
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
  const cudaStream_t s = (cudaStream_t)stream;
  if (d <= 64)
    return launch<64, 128>(q, k, v, out, lse, batch, hq, hkv, sq, skv, d,
                           causal, window, scale, s);
  if (d <= 128)
    return launch<128, 128>(q, k, v, out, lse, batch, hq, hkv, sq, skv, d,
                            causal, window, scale, s);
  return launch<256, 64>(q, k, v, out, lse, batch, hq, hkv, sq, skv, d,
                         causal, window, scale, s);
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
  return encode_all(maps, q, k, v, batch, hq, hkv, sq, skv, d);
}
