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
// Left for later: a pingpong of softmax and GEMM between the two consumer
// warpgroups and inside one, a block serving all query heads of a KV head
// (GQA sharing of the staged K/V), a TMA store of the output, fp8, and a
// backward kernel.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kConsumers = 2;              // consumer warpgroups a block
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kTq = 64 * kConsumers;       // queries a block
constexpr int kSub = 64;                   // bf16 columns a swizzled sub-tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----------------------------------------------------------

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

// returns once the phase of parity `parity` has completed; a wait of
// seconds means a load that never lands, and traps rather than hang
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

// ---- TMA ----------------------------------------------------------------

// one box of a 3-D tensor map {column, row, head} into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2) : "memory");
}

// ---- wgmma --------------------------------------------------------------

// shared-memory matrix descriptor, 128-byte swizzle; lbo and sbo in bytes
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulator reads and writes across the
// asynchronous wgmma (its results are defined only after the wait)
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (m64 x N, f32) = or += A (m64 x k16, K-major smem) . B (k16 x N,
// K-major smem)
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
// d (m64 x N, f32) += A (m64 x k16, bf16 pairs in registers) . B (k16 x N,
// MN-major smem)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db);

// ---- the wgmma shapes used here, one operand list each

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69,"
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89,"
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99,"
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109,"
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

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
                __nv_bfloat16* __restrict__ out, int Hq, int Hkv, int Sq,
                int Skv, int D, int causal, int window, float scale_log2) {
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
  }
}

// ---- host ---------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// errors of the host-side encoding, apart from the runtime's codes
constexpr int kNoEntryPoint = 10000;
constexpr int kEncodeFailed = 20000;   // + the driver's CUresult

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the 3-D map {D, S, heads} of a contiguous (B, H, S, D) bf16 tensor,
// boxes of 64 columns x `rows` rows of one head, 128-byte swizzle; reads
// past D or S fill zeros
int encode(CUtensorMap* map, const void* ptr, int D, int S, int heads,
           int rows) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return kNoEntryPoint;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kSub, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)r;
}

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
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int Sq, int Skv, int D, int causal, int window,
           float scale, cudaStream_t stream) {
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
      maps[0], maps[1], maps[2], (__nv_bfloat16*)out, Hq, Hkv, Sq, Skv, D,
      causal, window, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

bool valid(int d, int hq, int hkv) {
  return d > 0 && d <= 256 && d % 8 == 0 && hkv > 0 && hq % hkv == 0;
}

}  // namespace

// Contiguous (B, H, S, D) bf16 operands on 16-byte boundaries, D a
// multiple of 8 up to 256, Hq a multiple of Hkv, no fully masked row (the
// wrapper checks all of these).  Returns the runtime's error code, or
// 10000 when the driver's cuTensorMapEncodeTiled is not found, or 20000 +
// the driver's code when it refuses a map.
extern "C" int repro_flash_attention_tc(const void* q, const void* k,
                                        const void* v, void* out, int batch,
                                        int hq, int hkv, int sq, int skv,
                                        int d, int causal, int window,
                                        float scale, void* stream) {
  if (batch <= 0 || sq <= 0) return 0;
  if (!valid(d, hq, hkv) || skv <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (d <= 64)
    return launch<64, 128>(q, k, v, out, batch, hq, hkv, sq, skv, d, causal,
                           window, scale, s);
  if (d <= 128)
    return launch<128, 128>(q, k, v, out, batch, hq, hkv, sq, skv, d,
                            causal, window, scale, s);
  return launch<256, 64>(q, k, v, out, batch, hq, hkv, sq, skv, d, causal,
                         window, scale, s);
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
