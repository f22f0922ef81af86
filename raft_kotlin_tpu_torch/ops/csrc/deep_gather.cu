// The deep-log engine's batched log-row read, for both logs in one launch:
//
//   vals_t[n*Rt + r, g] = log_term[n*C + rows[n*Rt + r, g], g]
//   vals_c[n*Rc + r, g] = log_cmd[n*C + rows[n*Rt + N + r, g], g]
//
// one row tensor for both logs: the Rc cmd rows of node n are its term rows
// [N, N + Rc), the deep engine's entry rows — Rc = N in the synchronous
// batch (Rt = 4N+1), Rc = 3N in the known-delivery mailbox batch (Rt =
// 6N+1, three entry candidates a pair). Logs (N*C, G) and values in the
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
// Design: a 3-D grid, (G / (V * threads), Rt, N): blockIdx.z is the node
// and blockIdx.y the term row, so no thread divides. Each thread takes V =
// 16 / sizeof(T) neighbouring groups of one row (8 for int16, 4 for
// int32): it reads their V rows in 16-byte loads, issues all V log reads
// before it uses one (V loads in flight a thread), and writes the V values
// in one 16-byte store. A thread of a cmd row (r in [N, N + Rc)) reads
// log_cmd at the same V rows too, so every row is read once; the row test
// is uniform over a block. Log offsets are 64-bit ((n*C + row)*G + g passes
// 2^31 at BASELINE config 5); group indices are 32-bit.
//
// The 16-byte path needs G to be a multiple of V and every operand's base
// 16-byte aligned; the launcher checks that once for the launch
// (raft_deep_gather_vector), and where it does not hold each thread reads
// and writes its V groups one element at a time, bounded by G — one body,
// one uniform branch. No warp intrinsics: the neighbouring lanes' rows
// differ, and the host stand-in (csrc/host/cuda_runtime.h) runs this
// source on the CPU as written.
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

constexpr int kMaxGridYZ = 65535;

// The V values of a thread as one 16-byte word.
__device__ __forceinline__ int4 pack(const int32_t (&v)[4]) {
  return make_int4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ int4 pack(const int16_t (&v)[8]) {
  int w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = static_cast<int>(static_cast<uint16_t>(v[2 * i]) |
                            (static_cast<uint32_t>(static_cast<uint16_t>(
                                 v[2 * i + 1])) << 16));
  return make_int4(w[0], w[1], w[2], w[3]);
}

// out[i] = log[row[i] * G + i] for the V groups at `log` (the node's slot
// 0, column g0), 0 where row[i] is outside [0, C).
template <typename T, int V>
__device__ __forceinline__ void read_rows(const T* __restrict__ log,
                                          const int32_t (&row)[V], int C,
                                          int64_t G, T (&out)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i)
    out[i] = static_cast<uint32_t>(row[i]) < static_cast<uint32_t>(C)
                 ? log[row[i] * G + i]
                 : T(0);
}

template <typename T, int V>
__device__ __forceinline__ void write_vals(T* __restrict__ dst,
                                           const T (&v)[V], bool vec,
                                           int left) {
  if (vec) {
    *reinterpret_cast<int4*>(dst) = pack(v);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (i < left) dst[i] = v[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
deep_gather_kernel(const T* __restrict__ lt, const T* __restrict__ lc,
                   const int32_t* __restrict__ rows, T* __restrict__ vt,
                   T* __restrict__ vc, int G, int C, int N, int Rc,
                   bool vec) {
  constexpr int V = 16 / sizeof(T);
  const unsigned g0u = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (g0u >= static_cast<unsigned>(G)) return;
  const int g0 = static_cast<int>(g0u);
  const int n = blockIdx.z, r = blockIdx.y, Rt = gridDim.y;
  const int64_t GG = G;
  const int left = G - g0;  // groups of this thread that exist: >= V if vec
  const int32_t* rw = rows + (static_cast<int64_t>(n) * Rt + r) * GG + g0;
  int32_t row[V];
  if (vec) {
#pragma unroll
    for (int j = 0; j < V / 4; ++j) {
      const int4 q = reinterpret_cast<const int4*>(rw)[j];
      row[4 * j] = q.x;
      row[4 * j + 1] = q.y;
      row[4 * j + 2] = q.z;
      row[4 * j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) row[i] = i < left ? rw[i] : C;
  }
  const int64_t node = static_cast<int64_t>(n) * C * GG + g0;
  T out[V];
  read_rows<T, V>(lt + node, row, C, GG, out);
  write_vals<T, V>(vt + (static_cast<int64_t>(n) * Rt + r) * GG + g0, out,
                   vec, left);
  if (r >= N && r < N + Rc) {
    read_rows<T, V>(lc + node, row, C, GG, out);
    write_vals<T, V>(vc + (static_cast<int64_t>(n) * Rc + r - N) * GG + g0,
                     out, vec, left);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// ptrs: log_term, log_cmd, rows, vals_t, vals_c.
// ints: G, N, C, Rt, log_is_int16, threads_per_block, device, Rc. Rc is
// last, so a caller of a library built before it (which read seven ints
// and ran Rc = N) passes the same first seven.

// 1 if the launch takes the 16-byte path: G a multiple of V and every
// operand's base 16-byte aligned.
extern "C" int raft_deep_gather_vector(void* const* ptrs,
                                       const long long* ints) {
  const int V = ints[4] ? 8 : 4;
  if (ints[0] % V) return 0;
  for (int i = 0; i < 5; ++i)
    if (!aligned16(ptrs[i])) return 0;
  return 1;
}

// The library links its own (static) CUDA runtime, whose current device is
// not the caller's: it is set here to the device the operands and stream
// are on. A grid the card cannot launch (Rt or N past 65,535, G past
// 2^31 - 1) returns cudaErrorInvalidConfiguration, as does a cmd window
// outside the term rows (Rc < 1 or N + Rc > Rt); the wrapper raises
// before that.
extern "C" int raft_deep_gather_launch(void* const* ptrs,
                                       const long long* ints, void* stream) {
  const cudaError_t set = cudaSetDevice(static_cast<int>(ints[6]));
  if (set != cudaSuccess) return static_cast<int>(set);
  const long long G = ints[0];
  const int N = static_cast<int>(ints[1]);
  const int C = static_cast<int>(ints[2]);
  const int Rt = static_cast<int>(ints[3]);
  const bool log16 = ints[4] != 0;
  const int threads = static_cast<int>(ints[5]);
  const int Rc = static_cast<int>(ints[7]);
  if (G == 0 || N == 0) return 0;
  if (G >= (1LL << 31) || Rt > kMaxGridYZ || N > kMaxGridYZ || Rc < 1 ||
      N + Rc > Rt)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool vec = raft_deep_gather_vector(ptrs, ints) != 0;
  const long long per_block = static_cast<long long>(threads) *
                              (log16 ? 8 : 4);
  const dim3 grid(static_cast<unsigned>((G + per_block - 1) / per_block),
                  static_cast<unsigned>(Rt), static_cast<unsigned>(N));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* rows = static_cast<const int32_t*>(ptrs[2]);
  if (log16)
    deep_gather_kernel<int16_t><<<grid, threads, 0, s>>>(
        static_cast<const int16_t*>(ptrs[0]),
        static_cast<const int16_t*>(ptrs[1]), rows,
        static_cast<int16_t*>(ptrs[3]), static_cast<int16_t*>(ptrs[4]),
        static_cast<int>(G), C, N, Rc, vec);
  else
    deep_gather_kernel<int32_t><<<grid, threads, 0, s>>>(
        static_cast<const int32_t*>(ptrs[0]),
        static_cast<const int32_t*>(ptrs[1]), rows,
        static_cast<int32_t*>(ptrs[3]), static_cast<int32_t*>(ptrs[4]),
        static_cast<int>(G), C, N, Rc, vec);
  return static_cast<int>(cudaGetLastError());
}
