// One Raft tick (SEMANTICS.md phases F, 0-5) for every group, in place.
//
// Replaces the JAX package's Pallas megakernel
// raft_kotlin_tpu/ops/pallas_tick.py::make_pallas_core (the T=1, staged-aux,
// unpacked-compute body, pallas_call at :724), whose body is
// ops/tick.py::phase_body. The plain PyTorch version of this kernel is
// raft_kotlin_tpu_torch/ops/tick.py::phase_body; the two are held bit-equal.
//
// Design: one thread per group; the tick itself is tick_body.cuh's
// tick_body, shared with the fused-T kernel. The state is groups-minor
// ((N, G), (N*N, G), (N*C, G) rows), so row r of group g sits at r*G + g and
// a warp's 32 neighbouring groups read and write one coalesced segment per
// row. The TPU form's one-hot row selects, columnar stacks and ILP slabs
// existed only because Mosaic lacks gather and scatter; here a node's log
// slot is one load. This kernel reads its randomness from the staged aux
// tensors (ops/tick.make_aux), the §10 send delays included.
//
// Bound: memory. A tick does a few hundred integer operations per group
// against the non-log state read and written (405 B per group at N=5), the
// staged aux read (184 B), el_dirty written (5 B) and the few log slots it
// needs (the last-term reads, the prevLog/entry reads of the exchanges that
// go ahead, the appends) — not the whole (N, C) logs. The least time is
// those bytes over the card's memory bandwidth; chip_smoke.py counts them
// from the run's own data (phase_body's `touched` masks). Under the §10
// mailbox a tick also reads and writes the two due planes (100 B per group
// at N=5), reads the payload of each slot it delivers and writes that of
// each slot it sends; chip_smoke.py counts those too. The kernel
// reads and writes every state field in its STORAGE dtype
// (int16 / bool as uint8 / int32) and computes in int32; narrowing a value
// back to int16 wraps, as numpy's astype does.
//
// Plain C interface (bound with ctypes): raft_tick_launch() fills the
// parameter block from a pointer array and an integer array, launches on
// the caller's stream without synchronising, and returns cudaGetLastError().

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "tick_body.cuh"

namespace {

using namespace raft;

// Pointer order = the wrapper's operand order (ops/cuda_tick.py
// kernel_operands): the state, the mailbox slots (null without the
// mailbox), the aux channels, el_dirty.
struct Params {
  StatePtrs st;
  MailPtrs mb;
  const int16_t* edge_iid; const uint8_t* crash_m; const uint8_t* restart_m;
  const int16_t* link_fail; const int16_t* link_heal;
  const int16_t* el_draw_f; const int16_t* bdraw; const int32_t* periodic;
  const int32_t* inject; const int16_t* delay;
  uint8_t* el_dirty;
};
constexpr int kPointers = kStateFields + kMailFields + 11;
static_assert(sizeof(Params) == kPointers * sizeof(void*),
              "Params must be exactly kPointers pointers");

// The staged aux of one tick: (rows, G) tensors read at group g.
struct StagedAux {
  static constexpr bool kLoads = true;
  const Params& p;
  int64_t G, g;
  __device__ __forceinline__ int64_t at(int row) const {
    return static_cast<int64_t>(row) * G + g;
  }
  __device__ __forceinline__ bool edge(int a, int b) const {
    return p.edge_iid[at(a * N + b)] != 0;
  }
  __device__ __forceinline__ bool crash(int n) const {
    return p.crash_m[at(n)] != 0;
  }
  __device__ __forceinline__ bool restart(int n) const {
    return p.restart_m[at(n)] != 0;
  }
  __device__ __forceinline__ bool link_fail(int a, int b) const {
    return p.link_fail[at(a * N + b)] != 0;
  }
  __device__ __forceinline__ bool link_heal(int a, int b) const {
    return p.link_heal[at(a * N + b)] != 0;
  }
  __device__ __forceinline__ int el_draw_f(int n, int) const {
    return p.el_draw_f[at(n)];
  }
  __device__ __forceinline__ int bdraw(int n, int) const {
    return p.bdraw[at(n)];
  }
  __device__ __forceinline__ int periodic() const { return p.periodic[g]; }
  __device__ __forceinline__ int inject(int n) const {
    return p.inject[at(n)];
  }
  __device__ __forceinline__ int delay(int a, int b) const {
    return p.delay[at(a * N + b)];
  }
};

template <typename LT, bool kMail>
__global__ void __launch_bounds__(128) raft_tick_kernel(const Params p,
                                                        const Consts k) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (g >= k.G) return;
  Group s;
  load_group(p.st, k.G, g, s);
  StagedAux aux{p, k.G, g};
  tick_body<LT, kMail>(s, static_cast<LT*>(p.st.log_term),
                       static_cast<LT*>(p.st.log_cmd), k, g, aux, p.mb);
  store_group(p.st, k.G, g, s);
#pragma unroll
  for (int n = 0; n < N; ++n) p.el_dirty[node_at(k.G, g, n)] = s.dirty[n];
}

}  // namespace

extern "C" int raft_tick_nodes() { return N; }

// ptrs: kPointers device pointers in Params order (null for aux channels
// whose flag is off). ints: G, C, maj, hb_ticks, round_ticks, retry_ticks,
// cmd_node, flags, log_is_int16, threads_per_block, device, delay_lo,
// delay_hi. The library
// links its own (static) CUDA runtime, whose current device is not the
// caller's: it is set here to the device the operands and stream are on.
extern "C" int raft_tick_launch(void* const* ptrs, const long long* ints,
                                void* stream) {
  const cudaError_t set = cudaSetDevice(static_cast<int>(ints[10]));
  if (set != cudaSuccess) return static_cast<int>(set);
  Params p;
  void** dst = reinterpret_cast<void**>(&p);
  for (int i = 0; i < kPointers; ++i) dst[i] = ptrs[i];
  Consts k;
  k.G = ints[0];
  k.C = static_cast<int>(ints[1]);
  k.maj = static_cast<int>(ints[2]);
  k.hb_ticks = static_cast<int>(ints[3]);
  k.round_ticks = static_cast<int>(ints[4]);
  k.retry_ticks = static_cast<int>(ints[5]);
  k.cmd_node = static_cast<int>(ints[6]);
  k.flags = static_cast<int>(ints[7]);
  k.delay_lo = static_cast<int>(ints[11]);
  k.delay_hi = static_cast<int>(ints[12]);
  const bool log16 = ints[8] != 0;
  const bool mail = (k.flags & FLAG_DELAY) != 0;
  const int threads = static_cast<int>(ints[9]);
  const unsigned blocks = static_cast<unsigned>((k.G + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (log16 && mail)
    raft_tick_kernel<int16_t, true><<<blocks, threads, 0, s>>>(p, k);
  else if (log16)
    raft_tick_kernel<int16_t, false><<<blocks, threads, 0, s>>>(p, k);
  else if (mail)
    raft_tick_kernel<int32_t, true><<<blocks, threads, 0, s>>>(p, k);
  else
    raft_tick_kernel<int32_t, false><<<blocks, threads, 0, s>>>(p, k);
  return static_cast<int>(cudaGetLastError());
}
