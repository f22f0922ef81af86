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
// Threads walk it grid-stride in 16-byte vectors, four vectors in flight a
// thread per step, neighbouring threads on neighbouring vectors; the
// unaligned head and the tail that is not a whole vector go as 2-byte
// units (both log dtypes are whole multiples of 2 bytes). A store of the
// value just loaded is a no-op the compiler may delete, which would time
// nothing: every load and store is an `asm volatile` ld.global / st.global,
// which the compiler keeps as written.
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

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ void load16(const char* p, uint4& v) {
  asm volatile("ld.global.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
}

__device__ __forceinline__ void store16(char* p, const uint4& v) {
  asm volatile("st.global.v4.u32 [%0], {%1, %2, %3, %4};"
               :
               : "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void copy2(char* p) {
  unsigned short v;
  asm volatile("ld.global.u16 %0, [%1];" : "=h"(v) : "l"(p) : "memory");
  asm volatile("st.global.u16 [%0], %1;" : : "l"(p), "h"(v) : "memory");
}

__global__ void __launch_bounds__(kThreads)
copy_floor_kernel(char* a, char* b, int64_t bytes) {
  char* const base = blockIdx.y == 0 ? a : b;
  const int64_t mis = static_cast<int64_t>(
      reinterpret_cast<uintptr_t>(base) & 15u);
  const int64_t head = mis == 0 ? 0 : (16 - mis < bytes ? 16 - mis : bytes);
  const int64_t nvec = (bytes - head) / 16;
  char* const vec = base + head;
  const int64_t tail = head + nvec * 16;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  int64_t i = i0;
  // kUnroll vectors per thread per step: all loads issued, then all stores.
  for (; i + (kUnroll - 1) * stride < nvec; i += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load16(vec + 16 * (i + u * stride), v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) store16(vec + 16 * (i + u * stride), v[u]);
  }
  for (; i < nvec; i += stride) {
    uint4 v;
    load16(vec + 16 * i, v);
    store16(vec + 16 * i, v);
  }
  // The head before the first 16-byte boundary and the tail after the last
  // whole vector: fewer than 8 two-byte units each.
  if (i0 < head / 2) copy2(base + 2 * i0);
  if (i0 < (bytes - tail) / 2) copy2(base + tail + 2 * i0);
}

}  // namespace

// ptrs: log_term, log_cmd (contiguous, the same size). ints: the bytes of
// one log (a whole multiple of 2), threads_per_block, device (set here: the
// library links its own static CUDA runtime).
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
  // Enough resident blocks to fill every SM (2,048 threads each), no more:
  // the grid-stride loop covers the rest.
  const int64_t need = (bytes / 16 + kThreads - 1) / kThreads;
  const int64_t full = static_cast<int64_t>(sms) * (2048 / kThreads);
  const unsigned blocks =
      static_cast<unsigned>(need < 1 ? 1 : (need < full ? need : full));
  copy_floor_kernel<<<dim3(blocks, 2), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(ptrs[0]), static_cast<char*>(ptrs[1]), bytes);
  return static_cast<int>(cudaGetLastError());
}
