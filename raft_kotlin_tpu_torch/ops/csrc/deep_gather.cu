// The deep-log engine's batched log-row read, for both logs in one launch:
//
//   vals_t[n*Rt + r, g] = log_term[n*C + rows[n*Rt + r, g], g]
//   vals_c[n*N + r, g] = log_cmd[n*C + rows[n*Rt + N + r, g], g]
//
// one row tensor for both logs: the cmd rows of node n are its term rows
// [N, 2N), the deep engine's entry rows. Logs (N*C, G) and values in the
// log's storage dtype (int16 or int32), rows (N*Rt, G) int32 local slots.
// A row outside [0, C) reads 0 (the engine clips its rows to [0, C) first;
// the guard keeps every read inside the node's own slots).
//
// Replaces the JAX package's Pallas gather
// raft_kotlin_tpu/ops/deep_gather.py::build_gather (pallas_call at :139),
// which ran only in interpret mode: Mosaic's dynamic_gather takes 8 rows,
// so that kernel streamed whole (Cb, tile) log slabs through VMEM and
// extracted rows there. A gather is native here. The plain PyTorch version
// is raft_kotlin_tpu_torch/ops/deep_gather.py::gather_plain; the two are
// held bit-equal.
//
// Design: one thread per output element, groups-minor — element i of the
// concatenated [term; cmd] outputs is (row-slot i / G, group i % G), so a
// warp's 32 neighbouring groups load 32 neighbouring row indices and store
// 32 neighbouring values (coalesced), and each reads one log element of
// its own lane: a 2- or 4-byte read from a 32-byte sector that its
// neighbours' rows mostly do not share (each lane's row differs). A cmd
// thread reads its row from the term rows' cmd window.
//
// Bound: memory. No arithmetic beyond the address; the least time is the
// bytes the launch needs — the rows read, the values written, and the
// distinct 32-byte log sectors the rows touch — over the card's memory
// rate. chip_smoke.py counts those sectors from the run's own rows.
//
// Plain C interface (bound with ctypes): raft_deep_gather_launch() launches
// on the caller's stream without synchronising and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void __launch_bounds__(256)
deep_gather_kernel(const T* __restrict__ lt, const T* __restrict__ lc,
                   const int32_t* __restrict__ rows, T* __restrict__ vt,
                   T* __restrict__ vc, int64_t G, int C, int Rt, int N,
                   int64_t n_term, int64_t n_all) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n_all) return;
  const bool term = i < n_term;
  const int64_t j = term ? i : i - n_term;
  const int64_t slot = j / G;  // n*Rt + r, or n*N + r
  const int64_t g = j - slot * G;
  const int64_t n = slot / (term ? Rt : N);
  const int64_t rslot = term ? slot : n * Rt + N + (slot - n * N);
  const int32_t row = rows[rslot * G + g];
  T v = 0;
  if (row >= 0 && row < C) {
    const T* log = term ? lt : lc;
    v = log[(n * C + row) * G + g];
  }
  (term ? vt : vc)[j] = v;
}

}  // namespace

// ptrs: log_term, log_cmd, rows, vals_t, vals_c.
// ints: G, N, C, Rt, log_is_int16, threads_per_block, device. The
// library links its own (static) CUDA runtime, whose current device is not
// the caller's: it is set here to the device the operands and stream are
// on.
extern "C" int raft_deep_gather_launch(void* const* ptrs,
                                       const long long* ints, void* stream) {
  const cudaError_t set = cudaSetDevice(static_cast<int>(ints[6]));
  if (set != cudaSuccess) return static_cast<int>(set);
  const int64_t G = ints[0];
  const int N = static_cast<int>(ints[1]);
  const int C = static_cast<int>(ints[2]);
  const int Rt = static_cast<int>(ints[3]);
  const bool log16 = ints[4] != 0;
  const int threads = static_cast<int>(ints[5]);
  const int64_t n_term = static_cast<int64_t>(N) * Rt * G;
  const int64_t n_all = n_term + static_cast<int64_t>(N) * N * G;
  if (n_all == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((n_all + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* rows = static_cast<const int32_t*>(ptrs[2]);
  if (log16)
    deep_gather_kernel<int16_t><<<blocks, threads, 0, s>>>(
        static_cast<const int16_t*>(ptrs[0]),
        static_cast<const int16_t*>(ptrs[1]), rows,
        static_cast<int16_t*>(ptrs[3]), static_cast<int16_t*>(ptrs[4]), G, C,
        Rt, N, n_term, n_all);
  else
    deep_gather_kernel<int32_t><<<blocks, threads, 0, s>>>(
        static_cast<const int32_t*>(ptrs[0]),
        static_cast<const int32_t*>(ptrs[1]), rows,
        static_cast<int32_t*>(ptrs[3]), static_cast<int32_t*>(ptrs[4]), G, C,
        Rt, N, n_term, n_all);
  return static_cast<int>(cudaGetLastError());
}
