// The whole-log copy floor: both deep logs read and written back whole, in
// place, with no compute — the identity, timed as the floor under a
// whole-log write pass.
//
// Replaces the JAX package's probe kernel
// scripts/probe_write_floor.py::copy_floor_kernel (pallas_call at :89),
// which moved every (Cb, tile) slab of both (N*C, G) logs HBM -> VMEM -> HBM
// over the grid (N, G/tile, C/Cb) with its input aliased to its output.
// Its plain PyTorch version is
// raft_kotlin_tpu_torch/ops/copy_floor.py::copy_floor_plain; the two are
// held bit-equal (both leave the logs as they were).
//
// Design: the card's memory path, not the TPU's tiling. Each log is one
// flat byte range (the tensors are contiguous); blockIdx.y picks the log.
// Its 16-byte-aligned body goes through a Hopper bulk-copy ring: one
// thread a block issues cp.async.bulk global -> shared into kStages stages
// of kChunk bytes, each completing on its own mbarrier, and cp.async.bulk
// shared -> global of each chunk back where it came from as a bulk group,
// refilling the previous chunk's stage once that chunk's store has read it
// (so one store and kStages - 1 loads stay in flight). Persistent blocks,
// as many as fit an SM's shared memory on every SM, half on each log, walk
// the chunks. No thread spends registers or instructions on the bytes.
// Chunk and depth: 32 KB x 3, the fastest ring measured on the H100; rings
// of 32-64 KB x 3-4, with the logs side by side or in turn, came within
// 0.3% of it, and 16-byte-vector kernels at several depths and cache hints
// 2-4% slower (PERF.md §6).
//
// The unaligned head and the tail that is not a whole vector go as 2-byte
// units (both log dtypes are whole multiples of 2 bytes). A store of the
// value just loaded is a no-op the compiler may delete, which would time
// nothing: those loads and stores are `asm volatile`, which the compiler
// keeps as written.
//
// Bound: bytes — each log read once and written once, 4 x 14.3 GB at
// BASELINE config 5 (102,400 x 7 x 10,000 int16), 17.1 ms at 3.35 TB/s.
// chip_smoke.py and raft_kotlin_tpu_torch/probe_write_floor.py compute it
// from the logs' sizes.
//
// Plain C interface (bound with ctypes): raft_copy_floor_launch() launches
// on the caller's stream without synchronising and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kChunk = 32 * 1024;
constexpr int kStages = 3;

__device__ __forceinline__ void copy2(char* p) {
  unsigned short v;
  asm volatile("ld.global.u16 %0, [%1];" : "=h"(v) : "l"(p) : "memory");
  asm volatile("st.global.u16 [%0], %1;" : : "l"(p), "h"(v) : "memory");
}

// A log's split: the bytes before its first 16-byte boundary, the whole
// vectors after it, and where the tail starts.
struct Split {
  char* base;
  int64_t head, nvec, tail;
};

__device__ __forceinline__ Split split(char* base, int64_t bytes) {
  const int64_t mis = static_cast<int64_t>(
      reinterpret_cast<uintptr_t>(base) & 15u);
  const int64_t head = mis == 0 ? 0 : (16 - mis < bytes ? 16 - mis : bytes);
  const int64_t nvec = (bytes - head) / 16;
  return {base, head, nvec, head + nvec * 16};
}

// The head and the tail: fewer than 8 two-byte units each, by the first
// threads of the log's first block.
__device__ __forceinline__ void edges(const Split& sp, int64_t bytes) {
  if (blockIdx.x != 0) return;
  const int64_t t = threadIdx.x;
  if (t < sp.head / 2) copy2(sp.base + 2 * t);
  if (t < (bytes - sp.tail) / 2) copy2(sp.base + sp.tail + 2 * t);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Wait for phase `parity` of the mbarrier at `bar`. Bounded: a phase that
// never completes (a miscounted transaction) traps, failing the launch,
// rather than spinning the card forever.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long long spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1ll << 28)) __trap();
  }
}

__global__ void __launch_bounds__(kThreads)
copy_tma_kernel(char* a, char* b, int64_t bytes) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) unsigned long long bar[kStages];
  const Split sp = split(blockIdx.y == 0 ? a : b, bytes);
  // Job j: chunk blockIdx.x + j * gridDim.x of the log; it rides stage
  // j % kStages.
  const int64_t n = (sp.nvec * 16 + kChunk - 1) / kChunk;
  const int64_t total =
      blockIdx.x < n ? (n - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  if (threadIdx.x == 0 && total > 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :
                   : "r"(smem_addr(&bar[s]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    char* const body = sp.base + sp.head;
    auto at = [&](int64_t j) {
      return (static_cast<int64_t>(blockIdx.x) + j * gridDim.x) * kChunk;
    };
    auto size = [&](int64_t j) {
      const int64_t left = sp.nvec * 16 - at(j);
      return static_cast<uint32_t>(left < kChunk ? left : kChunk);
    };
    auto stage = [&](int64_t j) {
      return smem_addr(ring + (j % kStages) * static_cast<int64_t>(kChunk));
    };
    auto load = [&](int64_t j) {
      const uint32_t b_ = smem_addr(&bar[j % kStages]), m = size(j);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :
                   : "r"(b_), "r"(m)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];"
          :
          : "r"(stage(j)), "l"(body + at(j)), "r"(m), "r"(b_)
          : "memory");
    };
    for (int64_t j = 0; j < kStages && j < total; ++j) load(j);
    for (int64_t j = 0; j < total; ++j) {
      mbar_wait(smem_addr(&bar[j % kStages]),
                static_cast<uint32_t>((j / kStages) & 1));
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                   :
                   : "l"(body + at(j)), "r"(stage(j)), "r"(size(j))
                   : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      // Refill the stage of job j - 1 once its store (one group back) has
      // read it; job j's store stays in flight meanwhile.
      if (j >= 1 && j - 1 + kStages < total) {
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
        load(j - 1 + kStages);
      }
    }
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
  edges(sp, bytes);
}

}  // namespace

// ptrs: log_term, log_cmd (contiguous, the same size). ints: the bytes of
// one log (a whole multiple of 2), threads_per_block (kThreads), device
// (set here: the library links its own static CUDA runtime).
extern "C" int raft_copy_floor_launch(void* const* ptrs, const long long* ints,
                                      void* stream) {
  const int dev = static_cast<int>(ints[2]);
  cudaError_t err = cudaSetDevice(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t bytes = ints[0];
  if (bytes <= 0) return 0;
  if (bytes % 2 != 0 || ints[1] != kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(kChunk) * kStages;
  err = cudaFuncSetAttribute(copy_tma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, copy_tma_kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
  // Persistent: the blocks that fit every SM at once, half on each log.
  const int64_t fit = static_cast<int64_t>(sms) * per_sm;
  copy_tma_kernel<<<dim3(static_cast<unsigned>((fit + 1) / 2), 2), kThreads,
                     smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(ptrs[0]), static_cast<char*>(ptrs[1]), bytes);
  return static_cast<int>(cudaGetLastError());
}
