// The deep-log engine's deferred log writes, both logs in one launch, in
// place:
//
//   log_x[n*C + rows[n*K + k, g], g] = vals_x[n*K + k, g]
//
// for every node n, write k < K and group g; logs (N*C, G) and values in
// the log's storage dtype (int16 or int32), rows (N*K, G) int32 local
// slots. Row == C means "dropped" (a masked write); any row outside
// [0, C) writes nothing, so no write leaves its node's C rows.
//
// Replaces the JAX package's Pallas scatter
// raft_kotlin_tpu/ops/deep_scatter.py::build_scatter — its DMA form
// (_build_scatter_dma, pallas_call at :263) and grid form
// (_build_scatter_grid, :136), which ran a K-deep one-hot select chain over
// (Cb, tile) log slabs because Mosaic has no scatter. Here a write is one
// store. The plain PyTorch version is
// raft_kotlin_tpu_torch/ops/deep_scatter.py::scatter_plain; the two are
// held bit-equal.
//
// Design: a 3-D grid, (G / (4 * threads), K, N): blockIdx.z is the node
// and blockIdx.y the write k, so no thread divides. Each thread takes 4
// neighbouring groups of one (n, k) and reads their 4 rows in one 16-byte
// load; only the lanes whose row lies in [0, C) read their two values and
// store them into both logs at the 64-bit offset (n*C + row)*G + g (it
// passes 2^31 at BASELINE config 5). At config 5 nearly every row is
// dropped, so a thread costs one 16-byte load and the kept writes' bytes
// alone follow — what chip_smoke.py's bound counts.
//
// Duplicates: equal rows within one group lie in different threads
// (different k), and the engine resolves them to the value of the last
// write at their row first (ops/tick.phase_body), so they carry equal
// values and the order the stores land in does not matter.
//
// The 16-byte row load needs G to be a multiple of 4 and the rows' base
// 16-byte aligned (values and logs are read and written one element at a
// time); the launcher checks that once for the launch
// (raft_deep_scatter_vector), and where it does not hold each thread reads
// its 4 rows one at a time, bounded by G — one body, one uniform branch. No
// warp intrinsics: the host stand-in (csrc/host/cuda_runtime.h) runs this
// source on the CPU as written.
//
// Bound: memory. The least time is the bytes the launch needs — every row,
// the kept writes' value sectors in both planes, and each distinct 32-byte
// log sector written read and written once per log — over the card's
// memory rate; chip_smoke.py counts the sectors from the run's own rows.
//
// Plain C interface (bound with ctypes): raft_deep_scatter_launch()
// launches on the caller's stream without synchronising and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int V = 4;  // groups a thread: one 16-byte word of int32 rows
constexpr int kMaxGridYZ = 65535;

template <typename T>
__global__ void __launch_bounds__(256)
deep_scatter_kernel(T* __restrict__ lt, T* __restrict__ lc,
                    const int32_t* __restrict__ rows,
                    const T* __restrict__ vt, const T* __restrict__ vc,
                    int G, int C, bool vec) {
  const unsigned g0u = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (g0u >= static_cast<unsigned>(G)) return;
  const int g0 = static_cast<int>(g0u);
  const int n = blockIdx.z, k = blockIdx.y, K = gridDim.y;
  const int64_t GG = G;
  const int left = G - g0;  // groups of this thread that exist: >= V if vec
  const int64_t at = (static_cast<int64_t>(n) * K + k) * GG + g0;
  int32_t row[V];
  if (vec) {
    const int4 q = *reinterpret_cast<const int4*>(rows + at);
    row[0] = q.x;
    row[1] = q.y;
    row[2] = q.z;
    row[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) row[i] = i < left ? rows[at + i] : C;
  }
  const int64_t node = static_cast<int64_t>(n) * C * GG + g0;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (static_cast<uint32_t>(row[i]) < static_cast<uint32_t>(C)) {
      const int64_t dst = node + row[i] * GG + i;
      lt[dst] = vt[at + i];
      lc[dst] = vc[at + i];
    }
  }
}

}  // namespace

// ptrs: log_term, log_cmd, rows, vals_t, vals_c.
// ints: G, N, C, K, log_is_int16, threads_per_block, device.

// 1 if the launch reads its rows in 16-byte words: G a multiple of 4 and
// the rows' base 16-byte aligned.
extern "C" int raft_deep_scatter_vector(void* const* ptrs,
                                        const long long* ints) {
  return ints[0] % V == 0 &&
         (reinterpret_cast<uintptr_t>(ptrs[2]) & 15) == 0;
}

// The device is set here (the library links its own static CUDA runtime).
// A grid the card cannot launch (K or N past 65,535, G past 2^31 - 1)
// returns cudaErrorInvalidConfiguration; the wrapper raises before that.
extern "C" int raft_deep_scatter_launch(void* const* ptrs,
                                        const long long* ints, void* stream) {
  const cudaError_t set = cudaSetDevice(static_cast<int>(ints[6]));
  if (set != cudaSuccess) return static_cast<int>(set);
  const long long G = ints[0];
  const int N = static_cast<int>(ints[1]);
  const int C = static_cast<int>(ints[2]);
  const int K = static_cast<int>(ints[3]);
  const bool log16 = ints[4] != 0;
  const int threads = static_cast<int>(ints[5]);
  if (G == 0 || N == 0 || K == 0) return 0;
  if (G >= (1LL << 31) || K > kMaxGridYZ || N > kMaxGridYZ)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool vec = raft_deep_scatter_vector(ptrs, ints) != 0;
  const long long per_block = static_cast<long long>(threads) * V;
  const dim3 grid(static_cast<unsigned>((G + per_block - 1) / per_block),
                  static_cast<unsigned>(K), static_cast<unsigned>(N));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* rows = static_cast<const int32_t*>(ptrs[2]);
  if (log16)
    deep_scatter_kernel<int16_t><<<grid, threads, 0, s>>>(
        static_cast<int16_t*>(ptrs[0]), static_cast<int16_t*>(ptrs[1]), rows,
        static_cast<const int16_t*>(ptrs[3]),
        static_cast<const int16_t*>(ptrs[4]), static_cast<int>(G), C, vec);
  else
    deep_scatter_kernel<int32_t><<<grid, threads, 0, s>>>(
        static_cast<int32_t*>(ptrs[0]), static_cast<int32_t*>(ptrs[1]), rows,
        static_cast<const int32_t*>(ptrs[3]),
        static_cast<const int32_t*>(ptrs[4]), static_cast<int>(G), C, vec);
  return static_cast<int>(cudaGetLastError());
}
