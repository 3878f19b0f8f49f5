// A second design of arena_commit, built only by scripts/commit_probe.py
// to time it beside the kernel of src/repro_torch/kernels/csrc/commit.cu:
// the same partition, counting and stores (this file includes that one),
// but rows reach shared memory through a ring of kStages stages of 32
// rows of a strip, each filled by 1-D bulk copies (cp.async.bulk, one a
// row segment) that one producer thread issues, with a full and an empty
// mbarrier a stage; the 256 consumer threads read their 8 rows of a stage
// from shared memory instead of from device memory.
#include "commit.cu"

namespace {

constexpr int kStages = 2;
constexpr int kRingThreads = kThreads + 32;
constexpr int kStageBytes = kStepRows * kStrip;
constexpr int kRingSmem =
    kStages * kStageBytes + kRowLanes * kStrip * 4 + kMaxRows * 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
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
// returns once the phase of parity `parity` has completed; traps rather
// than hang on a copy that never lands
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
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}
// the consumer threads alone (the producer warp takes no part)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

template <bool kPacked>
__global__ void __launch_bounds__(kRingThreads)
ring_kernel(const uint8_t* __restrict__ rows, int64_t ld_in,
            uint8_t* __restrict__ out, int64_t ld_out,
            int* __restrict__ counter, int* __restrict__ sizes, int B,
            int n) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  uint8_t* ring = smem;
  uint32_t(*scol)[kStrip] =
      reinterpret_cast<uint32_t(*)[kStrip]>(smem + kStages * kStageBytes);
  int* srow = sizes == nullptr
                  ? nullptr
                  : reinterpret_cast<int*>(smem + kStages * kStageBytes +
                                           kRowLanes * kStrip * 4);
  const int tid = threadIdx.x, lane = tid & 31;
  const int64_t strips = (n + kStrip - 1) / kStrip;
  const int64_t total = strips * B;
  const int64_t a = total * blockIdx.x / gridDim.x;
  const int64_t b = total * (blockIdx.x + 1) / gridDim.x;
  if (tid == 0) {
    for (int k = 0; k < kStages; ++k) {
      bar_init(&full[k], 1);
      bar_init(&empty[k], kThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (srow != nullptr)
    for (int i = tid; i < B; i += kRingThreads) srow[i] = 0;
  __syncthreads();

  if (tid >= kThreads) {
    // producer: one thread fills the ring, a row segment a bulk copy
    if (tid == kThreads) {
      const int64_t pw = ((int64_t)n + 15) / 16 * 16;  // readable bytes
      int i = 0;
      for (int64_t L = a; L < b;) {
        const int64_t s = L / B;
        const int r_begin = (int)(L - s * B);
        const int r_end = (int)min64(B, r_begin + (b - L));
        const uint32_t seg = (uint32_t)min64(kStrip, pw - s * kStrip);
        for (int r0 = r_begin; r0 < r_end; r0 += kStepRows, ++i) {
          const int st = i % kStages;
          if (i >= kStages) bar_wait(&empty[st], (i / kStages - 1) & 1);
          const int nr = min(kStepRows, r_end - r0);
          bar_expect(&full[st], nr * seg);
          for (int k = 0; k < nr; ++k)
            bulk_load(ring + (st * kStepRows + k) * kStrip,
                      rows + (int64_t)(r0 + k) * ld_in + s * kStrip, seg,
                      &full[st]);
        }
        L += r_end - r_begin;
      }
    }
    return;
  }

  const int ct = tid % kColThreads, q = tid / kColThreads;
  int i = 0;
  for (int64_t L = a; L < b;) {
    const int64_t s = L / B;
    const int r_begin = (int)(L - s * B);
    const int r_end = (int)min64(B, r_begin + (b - L));
    Chunk ch;
    ch.c0 = s * kStrip + ct * 16;
    ch.valid = (int)max64(0, min64(16, n - ch.c0));
    const Lanes m(ch.valid);
    ColCounts cnt;
    for (int r0 = r_begin; r0 < r_end; r0 += kStepRows, ++i) {
      const int st = i % kStages;
      bar_wait(&full[st], (i / kStages) & 1);
      uint4 v[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int k = q + kRowLanes * u;
        v[u] = ch.valid > 0 && r0 + k < r_end
                   ? *reinterpret_cast<const uint4*>(
                         ring + (st * kStepRows + k) * kStrip + ct * 16)
                   : make_uint4(0u, 0u, 0u, 0u);
      }
      use_step<kPacked>(v, out, ld_out, ch, m, r0 + q, r_end, lane, cnt,
                        srow);
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[st]);
    }
    cnt.put(&scol[q][ct * 16]);
    consumers_sync();
    add_strip(scol, counter, s, n, r_begin == 0 && r_end == B, tid);
    consumers_sync();
    L += r_end - r_begin;
  }
  if (srow != nullptr)
    for (int j = tid; j < B; j += kThreads)
      if (srow[j]) atomicAdd(sizes + j, srow[j]);
}

template <bool kPacked>
int ring_launch(const void* rows, long long ld_in, void* out,
                long long ld_out, void* counter, void* sizes, int B, int n,
                void* stream) {
  if (B <= 0 || n <= 0) return 0;
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        ring_kernel<kPacked>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kRingSmem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, ring_kernel<kPacked>, kRingThreads, kRingSmem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) per_sm = 1;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t strips = (n + kStrip - 1) / kStrip;
  for (int r0 = 0; r0 < B; r0 += kMaxRows) {
    const int Bc = B - r0 < kMaxRows ? B - r0 : kMaxRows;
    int* sz = sizes == nullptr ? nullptr : (int*)sizes + r0;
    if (sz != nullptr) {
      err = cudaMemsetAsync(sz, 0, sizeof(int) * (size_t)Bc, st);
      if (err != cudaSuccess) return (int)err;
    }
    const int64_t units = strips * Bc, cap = (int64_t)sms * per_sm;
    const int grid = (int)(units < cap ? units : cap);
    ring_kernel<kPacked><<<grid, kRingThreads, kRingSmem, st>>>(
        (const uint8_t*)rows + (int64_t)r0 * ld_in, (int64_t)ld_in,
        (uint8_t*)out + (int64_t)r0 * ld_out, (int64_t)ld_out, (int*)counter,
        sz, Bc, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_commit_ring_bitmap(const void* rows, long long ld_in,
                                        void* out, long long ld_out,
                                        void* counter, void* sizes, int B,
                                        int n, void* stream) {
  return ring_launch<false>(rows, ld_in, out, ld_out, counter, sizes, B, n,
                            stream);
}

extern "C" int repro_commit_ring_packed(const void* rows, long long ld_in,
                                        void* out, long long ld_out,
                                        void* counter, void* sizes, int B,
                                        int n, void* stream) {
  return ring_launch<true>(rows, ld_in, out, ld_out, counter, sizes, B, n,
                           stream);
}
