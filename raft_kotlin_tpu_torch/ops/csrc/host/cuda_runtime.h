// A host stand-in for the CUDA runtime, for running the port's kernel
// sources on the CPU (ops/host_build.py; g++ -std=c++20 -DRAFT_HOST_STUB).
// It is not the CUDA runtime: a launch runs its blocks in turn, each as
// blockDim.x host threads with a barrier for __syncthreads, so a kernel's
// arithmetic, its shared-memory staging and its barriers run as written;
// warp intrinsics see one lane (a warp reduction returns its argument),
// and the launch and occupancy queries answer with fixed numbers. The
// kernels' bulk copies (tile.cuh) are memcpy under RAFT_HOST_STUB.
#pragma once
#include <algorithm>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
#define __restrict__

struct dim3 {
  unsigned x, y, z;
  constexpr dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
// The kernels' 16-byte vector word.
struct __align__(16) int4 {
  int x, y, z, w;
};
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
inline std::barrier<>* host_block_barrier = nullptr;
inline std::vector<unsigned char> host_dyn_smem;
inline std::mutex host_atomic_mu;

inline void __syncthreads() { host_block_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = ~0u) {}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
template <typename T> inline T __ldg(const T* p) { return *p; }
inline unsigned __funnelshift_l(unsigned lo, unsigned hi, unsigned s) {
  s &= 31;
  return s ? (hi << s) | (lo >> (32 - s)) : hi;
}
inline unsigned __umulhi(unsigned a, unsigned b) {
  return static_cast<unsigned>((static_cast<unsigned long long>(a) * b) >> 32);
}
inline void __trap() { std::abort(); }
inline int __reduce_min_sync(unsigned, int v) { return v; }
inline int __reduce_max_sync(unsigned, int v) { return v; }
inline int __reduce_add_sync(unsigned, int v) { return v; }
template <typename T> T atomicMin(T* p, T v) {
  std::lock_guard<std::mutex> g(host_atomic_mu);
  const T o = *p;
  if (v < o) *p = v;
  return o;
}
template <typename T> T atomicMax(T* p, T v) {
  std::lock_guard<std::mutex> g(host_atomic_mu);
  const T o = *p;
  if (v > o) *p = v;
  return o;
}
template <typename T> T atomicAdd(T* p, T v) {
  std::lock_guard<std::mutex> g(host_atomic_mu);
  const T o = *p;
  *p = o + v;
  return o;
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorInvalidConfiguration = 9 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
struct cudaFuncAttributes {
  int numRegs = 0;
  size_t localSizeBytes = 0;
};
// The H100's limit on a block's shared memory: the occupancy query and
// the attribute call answer by it.
constexpr size_t kHostSmemLimit = 232448;
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 2;
  return cudaSuccess;
}
template <typename K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int v) {
  return static_cast<size_t>(v) > kHostSmemLimit ? cudaErrorInvalidValue
                                                 : cudaSuccess;
}
template <typename K>
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, K) {
  *a = cudaFuncAttributes{};
  return cudaSuccess;
}
template <typename K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K,
                                                          int threads,
                                                          size_t smem) {
  const size_t by_smem = smem ? kHostSmemLimit / smem : 32;
  *n = static_cast<int>(std::min<size_t>(2048 / threads, by_smem));
  return cudaSuccess;
}
inline unsigned char* host_shared_memory() { return host_dyn_smem.data(); }

// kern<<<grid, threads, smem, stream>>>(args...), as ops/host_build.py
// rewrites it (a block count converts to a 1-D grid): the blocks in turn,
// x fastest, then y, then z, each as `threads` host threads.
template <typename K, typename... A>
void host_launch(K kern, dim3 grid, unsigned threads, size_t smem,
                 cudaStream_t, A... args) {
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        host_dyn_smem.assign(smem + 16, 0xCD);
        std::barrier<> bar(threads);
        host_block_barrier = &bar;
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < threads; ++t)
          ts.emplace_back([&, t] {
            threadIdx = dim3(t, 0, 0);
            blockIdx = dim3(bx, by, bz);
            blockDim = dim3(threads);
            gridDim = grid;
            kern(args...);
            bar.arrive_and_drop();
          });
        for (auto& th : ts) th.join();
      }
}
