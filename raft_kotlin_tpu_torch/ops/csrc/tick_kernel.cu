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
// Two forms, chosen per instantiation at compile time (tile_form):
// - the row form (raft_tick_kernel): blocks of 128 threads, each thread's
//   state loaded into registers and stored back in place, the aux and the
//   §10 slots read and written in device memory where the chain needs
//   them;
// - the tile form (raft_tick_tile, tile.cuh), under the §10 mailbox with
//   unpacked compute: a block of 64 threads runs a tile of 64 groups with
//   the tile's staged aux rows and its two due planes copied into shared
//   memory before the lattice starts (cp.async.bulk where rows are 16-byte
//   aligned, else per thread), so the due reads that every pair's
//   delivery and the countdown make on the serial chain, and the aux
//   reads, are shared-memory reads; the due rows some thread wrote go
//   back. The payload fields, touched only by a delivery or a send, and
//   the state (loaded into registers once) stay in device memory.
// The one-call A/Bs (raft_kotlin_tpu_torch/kernel_ab.py, PERF.md §6; one
// NVIDIA H100 80GB HBM3, 700 W) chose it: at the mailbox's 102,400 groups
// 0.4921 → 0.3947 ms (0.4932 → 0.3568 in its final code); the state staged too 0.4189, the aux left out 0.5122, all 13 slot
// planes (105 KB a block, 2 blocks an SM) 0.8171. Without the mailbox
// every staging lost to the row form (headline 0.1436 → 0.23-0.32 ms,
// with the register budget lowered to 168 or 128 too), and under §18
// packed compute the tile tied it (0.4197 → 0.4233).
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
// each slot it sends; chip_smoke.py counts those too. The tile form
// stages only rows the bound counts once (the aux in, the due planes in
// and out), so its own byte floor is the bound (chip_smoke.py's
// [kernel=plain] lines print the staged rows' share of it). The kernel
// reads and writes every state field in its STORAGE dtype
// (int16 / bool as uint8 / int32) and computes in int32; narrowing a value
// back to int16 wraps, as numpy's astype does.
//
// Built twice (ops/build.py): for the wide layout, and with -DRAFT_PACKED=1
// for the §14 packed layout (tick_body.cuh PackedMem), whose launches also
// take the §18 packed compute (kernel #4, the JAX package's
// _enter/_exit_packed_lattice, pallas_tick.py:135/:152, inlined in
// make_pallas_core under compute="packed"). The packed build reads and
// writes the packed tensors in place and ORs its width-overflow latch into
// the group's `ov` byte; its plain version is ops/cuda_tick.py
// tick_plain_packed. Its bound is the same kind (bytes), over the packed
// state's fewer bytes.
//
// The §15 forms (compaction and the §16 ring window; tick_body.cuh's Snap)
// are the row form with the three snapshot planes in registers — the JAX
// package's make_pallas_core with the snapshot operands (:603) — in every
// form the non-§15 lattice has: int32 or int16 logs, synchronous or under
// the §10 mailbox (an InstallSnapshot rides the append slot), the wide
// layout (int32 positions) or the packed one (latched int16 positions,
// §18 packed compute too). They are their own library, built with
// -DRAFT_COMPACT=1 in its own nvcc process (ops/build.py): the build that
// holds them compiles no other instantiation, and the other builds none of
// them. Their plain version is phase_body under BodyFlags.compact. Bound:
// bytes, as above, plus the snapshot planes read and written once (12 B
// per node wide, 8 B packed).
//
// Plain C interface (bound with ctypes): raft_tick_launch() fills the
// parameter block from a pointer array and an integer array, launches on
// the caller's stream without synchronising, and returns cudaGetLastError().

#include <cstddef>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "tick_body.cuh"
#include "tile.cuh"

#ifndef RAFT_PACKED
#define RAFT_PACKED 0
#endif
#ifndef RAFT_COMPACT
#define RAFT_COMPACT 0
#endif

namespace {

using namespace raft;

#if RAFT_PACKED
using StateP = PackedPtrs;
using MailP = PackedMailPtrs;
using SnapP = PackedSnapPtrs;
constexpr int kStatePointers = kPackedFields;
#else
using StateP = StatePtrs;
using MailP = MailPtrs;
using SnapP = SnapPtrs;
constexpr int kStatePointers = kStateFields;
#endif

// Pointer order = the wrapper's operand order (ops/cuda_tick.py
// kernel_operands): the state, the mailbox slots (null without the
// mailbox), the aux channels, el_dirty.
struct Params {
  StateP st;
  MailP mb;
  const int16_t* edge_iid; const uint8_t* crash_m; const uint8_t* restart_m;
  const int16_t* link_fail; const int16_t* link_heal;
  const int16_t* el_draw_f; const int16_t* bdraw; const int32_t* periodic;
  const int32_t* inject; const int16_t* delay;
  uint8_t* el_dirty;
  SnapP sn;  // §15 (null without compaction)
};
constexpr int kPointers = kStatePointers + kMailFields + 14;
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

// LT: the logs' type (the wide build); kPC: §18 packed compute (the
// packed build). The row form: one thread a group, the state read and
// written in place (the instantiations the A/B keeps on it, tile_form).
template <typename LT, bool kMail, bool kPC, bool kCompact>
__global__ void __launch_bounds__(128) raft_tick_kernel(const Params p,
                                                        const Consts k) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (g >= k.G) return;
  Group<kPC> s;
  StagedAux aux{p, k.G, g};
  std::conditional_t<kCompact, Snap, NoSnap> sn;
#if RAFT_PACKED
  PackedMemT<NoTrack, kCompact> mem{p.st.log_term, p.st.log_cmd, p.mb, k, g,
                                    0};
  load_group(p.st, k.narrow8, k.G, g, s);
  if constexpr (kCompact) load_snap(p.sn, k.G, g, sn);
  tick_body<kMail>(s, mem, k, aux, sn);
  int ov = store_group(p.st, k.narrow8, k.G, g, s) | mem.ov;
  if constexpr (kCompact) ov |= store_snap(p.sn, k.G, g, sn);
  if (ov) p.st.ov[g] = 1;
#else
  WideMem<LT, NoTrack, kCompact> mem{static_cast<LT*>(p.st.log_term),
                                     static_cast<LT*>(p.st.log_cmd), p.mb, k,
                                     g, 0};
  load_group<kCompact>(p.st, k.G, g, s);
  if constexpr (kCompact) load_snap(p.sn, k.G, g, sn);
  tick_body<kMail>(s, mem, k, aux, sn);
  store_group<kCompact>(p.st, k.G, g, s);
  if constexpr (kCompact) store_snap(p.sn, k.G, g, sn);
#endif
#pragma unroll
  for (int n = 0; n < N; ++n) p.el_dirty[node_at(k.G, g, n)] = s.dirty[n];
}

// ---------------------------------------------------------------------------
// The tile form (tile.cuh): the plan's segments are the two due planes
// (VQ_DUE, AQ_DUE) and, from kAux0, the 10 aux channels in Params order.
constexpr int kSlot0 = kStatePointers;
constexpr int kAux0 = 2;
constexpr int kPlanSegs = kAux0 + 10;
using TickPlan = tile::Plan<kPlanSegs>;

// The staged aux of one tick from the tile buffer ([row][lane]).
struct TileAux : StagedAux {
  const char* buf;
  const TickPlan* pl;
  int lane;
  template <typename T>
  __device__ __forceinline__ T ld(int a, int row) const {
    return *reinterpret_cast<const T*>(
        buf + pl->seg[kAux0 + a].off +
        (row * tile::B + lane) * static_cast<int>(sizeof(T)));
  }
  __device__ __forceinline__ bool edge(int a, int b) const {
    return ld<int16_t>(0, a * N + b) != 0;
  }
  __device__ __forceinline__ bool crash(int n) const {
    return ld<uint8_t>(1, n) != 0;
  }
  __device__ __forceinline__ bool restart(int n) const {
    return ld<uint8_t>(2, n) != 0;
  }
  __device__ __forceinline__ bool link_fail(int a, int b) const {
    return ld<int16_t>(3, a * N + b) != 0;
  }
  __device__ __forceinline__ bool link_heal(int a, int b) const {
    return ld<int16_t>(4, a * N + b) != 0;
  }
  __device__ __forceinline__ int el_draw_f(int n, int) const {
    return ld<int16_t>(5, n);
  }
  __device__ __forceinline__ int bdraw(int n, int) const {
    return ld<int16_t>(6, n);
  }
  __device__ __forceinline__ int periodic() const {
    return ld<int32_t>(7, 0);
  }
  __device__ __forceinline__ int inject(int n) const {
    return ld<int32_t>(8, n);
  }
  __device__ __forceinline__ int delay(int a, int b) const {
    return ld<int16_t>(9, a * N + b);
  }
};

// A block of tile::B threads a tile of the §10 mailbox's instantiation
// with unpacked compute: the tile's aux rows and due planes in
// (tile.cuh), the lattice on them with the state in registers and the
// payloads and logs in device memory, the written due rows out.
template <typename LT>
__global__ void __launch_bounds__(tile::B)
    raft_tick_tile(const Params p, const Consts k, const TickPlan pl) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ uint8_t flags[tile::kFlags];
  char* const buf = reinterpret_cast<char*>(smem_raw);
  const int lane = threadIdx.x;
  const int64_t G = k.G;
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * tile::B;
  const int nb = static_cast<int>(min(static_cast<int64_t>(tile::B),
                                      G - g0));
  if (lane == 0) tile::bar_init(&bar);
  __syncthreads();
  tile::issue_loads(pl, buf, G, g0, nb, &bar);
  tile::load_rest(pl, buf, G, g0, nb);
  for (int i = lane; i < tile::kFlags; i += tile::B) flags[i] = 0;
  __syncthreads();
  tile::bar_wait(&bar, 0);
  if (lane < nb) {
    const int64_t g = g0 + lane;
    Group<false> s;
    TileAux aux{{p, G, g}, buf, &pl, lane};
#if RAFT_PACKED
    tile::TileMem<PackedMem, 0, kPlanSegs> mem{
        {p.st.log_term, p.st.log_cmd, p.mb, k, g, 0}, buf, &pl, flags, lane};
    load_group(p.st, k.narrow8, G, g, s);
    tick_body<true>(s, mem, k, aux);
    if (store_group(p.st, k.narrow8, G, g, s) | mem.ov) p.st.ov[g] = 1;
#else
    tile::TileMem<WideMem<LT>, 0, kPlanSegs> mem{
        {static_cast<LT*>(p.st.log_term), static_cast<LT*>(p.st.log_cmd),
         p.mb, k, g, 0},
        buf, &pl, flags, lane};
    load_group(p.st, G, g, s);
    tick_body<true>(s, mem, k, aux);
    store_group(p.st, G, g, s);
#endif
#pragma unroll
    for (int n = 0; n < N; ++n) p.el_dirty[node_at(G, g, n)] = s.dirty[n];
  }
  tile::fence_async();
  __syncthreads();
  tile::write_back(pl, buf, G, g0, nb, flags);
  if (lane < 32) tile::bulk_wait();
}

// Which instantiations launch the tile form (else the row form), as the
// one-call A/B found them faster at their path's shape (PERF.md §6): the
// §10 mailbox's with unpacked compute, where the tile's due
// planes and aux rows in shared memory take the serial chain's loads off
// device memory. Without the mailbox every staging lost to the row form,
// and under §18 packed compute the tile only tied it.
constexpr bool tile_form(bool mail, bool pc) { return mail && !pc; }

constexpr tile::FieldShape kAuxShape[10] = {
    {2, 2}, {1, 1}, {1, 1}, {2, 2}, {2, 2},
    {2, 1}, {2, 1}, {4, 4}, {4, 1}, {2, 2}};

// The plan of one tile-form launch, from its pointers (Params order) and
// widths: the due planes (packed: int8 or int16 by W8_DUE), then the aux.
void make_plan(TickPlan& pl, const Params& p, const Consts& k) {
  void* const* ptr = reinterpret_cast<void* const*>(&p);
  const int due_es = RAFT_PACKED && (k.narrow8 & W8_DUE) ? 1 : 2;
  tile::clear(pl);
  tile::add_seg(pl, 0, ptr[kSlot0 + VQ_DUE], N * N, due_es, 1, 0, k.G);
  tile::add_seg(pl, 1, ptr[kSlot0 + AQ_DUE], N * N, due_es, 1, N * N, k.G);
  for (int i = 0; i < 10; ++i)
    tile::add_seg(pl, kAux0 + i, ptr[kSlot0 + kMailFields + i],
                  tile::shape_rows(kAuxShape[i]),
                  tile::shape_es(kAuxShape[i], k.narrow8), 0, 0, k.G);
}

// Launch (or, with `info`, only describe) one instantiation in its form.
template <typename LT, bool MAIL, bool PC, bool COMPACT = false>
cudaError_t launch(const Params& p, const Consts& k, int threads,
                   cudaStream_t s, long long* info) {
  if constexpr (tile_form(MAIL, PC) && !COMPACT) {
    TickPlan pl;
    make_plan(pl, p, k);
    auto kern = raft_tick_tile<LT>;
    const size_t smem = pl.bytes;
    const int64_t blocks = (k.G + tile::B - 1) / tile::B;
    if (info) {
      const cudaError_t e = tile::describe(kern, tile::B, smem, info);
      info[0] = 1;
      info[6] = blocks;
      info[7] = 0;
      for (int i = 0; i < pl.nseg; ++i)
        info[7] += tile::bulk_ok(pl.seg[i], tile::B) ? 1 : 0;
      info[8] = tile::group_bytes(pl, false);
      info[9] = tile::group_bytes(pl, true);
      return e;
    }
    kern<<<static_cast<unsigned>(blocks), tile::B, smem, s>>>(p, k, pl);
  } else {
    auto kern = raft_tick_kernel<LT, MAIL, PC, COMPACT>;
    const unsigned blocks =
        static_cast<unsigned>((k.G + threads - 1) / threads);
    if (info) {
      const cudaError_t e = tile::describe(kern, threads, 0, info);
      info[0] = 0;
      info[6] = blocks;
      info[7] = info[8] = info[9] = 0;
      return e;
    }
    kern<<<blocks, threads, 0, s>>>(p, k);
  }
  return cudaGetLastError();
}

// ptrs: kPointers device pointers in Params order (null for aux channels
// whose flag is off). ints: G, C, maj, hb_ticks, round_ticks, retry_ticks,
// cmd_node, flags, log_is_int16, threads_per_block (the row form's),
// device, delay_lo, delay_hi, narrow8 and packed_compute (both read by the
// packed build only), the §15 watermark (0: no compaction) and chunk. A
// §15 launch needs the RAFT_COMPACT build and any other launch the other
// (cudaErrorInvalidValue). The library links its own (static) CUDA runtime,
// whose current device is not the caller's: it is set here to the device
// the operands and stream are on.
int run(void* const* ptrs, const long long* ints, void* stream,
        long long* info) {
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
  k.narrow8 = static_cast<int>(ints[13]);
  k.compact_w = static_cast<int>(ints[15]);
  k.compact_ch = static_cast<int>(ints[16]);
  const bool compact = k.compact_w > 0;
  const bool log16 = ints[8] != 0;
  const bool mail = (k.flags & FLAG_DELAY) != 0;
  const int threads = static_cast<int>(ints[9]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  constexpr bool C = RAFT_COMPACT;
  if (compact != C) return static_cast<int>(cudaErrorInvalidValue);
#if RAFT_PACKED
  // The packed layout's logs are int8 / int16 whatever log_dtype is; LT is
  // unused.
  (void)log16;
  const bool pc = ints[14] != 0;
  if (mail && pc) e = launch<int32_t, true, true, C>(p, k, threads, s, info);
  else if (mail) e = launch<int32_t, true, false, C>(p, k, threads, s, info);
  else if (pc) e = launch<int32_t, false, true, C>(p, k, threads, s, info);
  else e = launch<int32_t, false, false, C>(p, k, threads, s, info);
#else
  if (log16 && mail)
    e = launch<int16_t, true, false, C>(p, k, threads, s, info);
  else if (log16) e = launch<int16_t, false, false, C>(p, k, threads, s, info);
  else if (mail) e = launch<int32_t, true, false, C>(p, k, threads, s, info);
  else e = launch<int32_t, false, false, C>(p, k, threads, s, info);
#endif
  return static_cast<int>(e);
}

}  // namespace

extern "C" int raft_tick_nodes() { return N; }
extern "C" int raft_tick_packed() { return RAFT_PACKED; }
extern "C" int raft_tick_compact() { return RAFT_COMPACT; }

// Launch on the caller's stream without synchronising; returns the CUDA
// error of the launch.
extern "C" int raft_tick_launch(void* const* ptrs, const long long* ints,
                                void* stream) {
  return run(ptrs, ints, stream, nullptr);
}

// The same arguments, nothing launched: fills out[0..9] (the form, threads
// a block, shared memory a block, resident blocks an SM, registers, local
// bytes a thread, blocks, bulk-copied segments, and a group's staged bytes
// in and out: 0 in the row form) for that launch.
extern "C" int raft_tick_info(void* const* ptrs, const long long* ints,
                              long long* out) {
  return run(ptrs, ints, nullptr, out);
}
