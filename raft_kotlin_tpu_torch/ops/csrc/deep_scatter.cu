// The deep-log engine's deferred log writes, both logs in one launch, in
// place:
//
//   log_x[n*C + rows[n*K + k, g], g] = vals_x[n*K + k, g]
//
// for every node n, write k < K and group g; logs (N*C, G) and values in
// the log's storage dtype (int16 or int32), rows (N*K, G) int32 local
// slots. Row == C means "dropped" (a masked write); any row outside
// [0, C) writes nothing, so no write leaves its node's C rows. Duplicate
// rows within one lane carry identical values (the engine resolves them
// chronologically first), so the order the stores land in does not matter.
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
// Design: one thread per (node*K + k, group), groups-minor, so a warp
// loads 32 neighbouring rows and values (coalesced) and stores into 32
// lanes' own log columns. Dropped writes cost the thread its three loads
// and no store.
//
// Bound: memory. The least time is the bytes the launch needs — rows and
// both value planes read, and each distinct 32-byte log sector written
// read and written once per log — over the card's memory rate;
// chip_smoke.py counts the sectors from the run's own rows.
//
// Plain C interface (bound with ctypes): raft_deep_scatter_launch()
// launches on the caller's stream without synchronising and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void __launch_bounds__(256)
deep_scatter_kernel(T* __restrict__ lt, T* __restrict__ lc,
                    const int32_t* __restrict__ rows,
                    const T* __restrict__ vt, const T* __restrict__ vc,
                    int64_t G, int C, int K, int64_t n_all) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n_all) return;
  const int32_t row = rows[i];
  if (row < 0 || row >= C) return;
  const int64_t slot = i / G;  // n*K + k
  const int64_t g = i - slot * G;
  const int64_t at = (slot / K * C + row) * G + g;
  lt[at] = vt[i];
  lc[at] = vc[i];
}

}  // namespace

// ptrs: log_term, log_cmd, rows, vals_t, vals_c.
// ints: G, N, C, K, log_is_int16, threads_per_block, device (set here: the
// library links its own static CUDA runtime).
extern "C" int raft_deep_scatter_launch(void* const* ptrs,
                                        const long long* ints, void* stream) {
  const cudaError_t set = cudaSetDevice(static_cast<int>(ints[6]));
  if (set != cudaSuccess) return static_cast<int>(set);
  const int64_t G = ints[0];
  const int64_t N = ints[1];
  const int C = static_cast<int>(ints[2]);
  const int K = static_cast<int>(ints[3]);
  const bool log16 = ints[4] != 0;
  const int threads = static_cast<int>(ints[5]);
  const int64_t n_all = N * K * G;
  if (n_all == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((n_all + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* rows = static_cast<const int32_t*>(ptrs[2]);
  if (log16)
    deep_scatter_kernel<int16_t><<<blocks, threads, 0, s>>>(
        static_cast<int16_t*>(ptrs[0]), static_cast<int16_t*>(ptrs[1]), rows,
        static_cast<const int16_t*>(ptrs[3]),
        static_cast<const int16_t*>(ptrs[4]), G, C, K, n_all);
  else
    deep_scatter_kernel<int32_t><<<blocks, threads, 0, s>>>(
        static_cast<int32_t*>(ptrs[0]), static_cast<int32_t*>(ptrs[1]), rows,
        static_cast<const int32_t*>(ptrs[3]),
        static_cast<const int32_t*>(ptrs[4]), G, C, K, n_all);
  return static_cast<int>(cudaGetLastError());
}
