// T Raft ticks (SEMANTICS.md phases F, 0-5, then the §7 election draws) per
// launch for every group, in place, with per-tick snapshots of the fields
// the observers read.
//
// Replaces the JAX package's fused-T Pallas kernel
// raft_kotlin_tpu/ops/pallas_tick.py::_make_fused_core (pallas_call at
// :999), unpacked compute, in both of its aux forms, and with it the
// in-kernel aux of _kt_aux / the kt_* threefry twins (:439-513,
// utils/rng.py:489-649) inlined there. Its plain PyTorch version is
// raft_kotlin_tpu_torch/ops/cuda_tick.py::fused_tick_plain; the two are
// held bit-equal.
//
// Design: one thread per group, as the one-tick kernel; the tick is
// tick_body.cuh's tick_body, shared with it. A thread loads its group's
// non-log state into registers once, runs T ticks (T is a runtime value),
// and stores the state and its overflow counts once. Each tick it draws the
// tick's randomness (a compile-time choice of source), runs the body,
// materializes el_left of the nodes whose timer reset (the draw at
// t_ctr - 1), and stores the tick's snapshot rows:
//
// - in-kernel draws: every aux channel is a counted threefry draw from the
//   key table (base-key words, launch tick, global group index) and the
//   timeout/backoff key-word planes (kt_rng.cuh), drawn only where the tick
//   uses it; live counters have no table window, so the overflow counts
//   stay 0. A §12 scenario bank (the kScen instantiations) adds its rows to
//   the key table: per-group thresholds read at the point of use, the
//   delay window once a tick, the partition program as one cut mask a group
//   a tick (kt::cut_mask, its leader program on the live leaders taken at
//   each tick's start, before phase F), and the warmup-down schedule on
//   crash / restart;
// - staged: the channels arrive T-stacked from ops/tick.event_channels and
//   the counter-keyed draws as tables over the counter windows a launch can
//   reach (ops/cuda_tick.draw_tables); an offset past a table's window is
//   clamped and counted into `overflow` — the caller must discard the
//   launch — and a negative offset (el_left's select for a node with no
//   reset yet this launch, never used) reads 0 and counts nothing.
//
// Under the §10 mailbox (tick_body's kMail) the slots stay in device
// memory, read and written in place at each pair's point in the lattice;
// the delays come T-stacked (staged) or from kt::delay_draw at each send
// (in-kernel); and in place of the two due planes (2 x 25 x G int32 a
// tick) the observers get two int32 per group a tick: the slots in flight
// and the bitmask of nodes owning an append slot in flight.
//
// Bound: with the observers on, the snapshots (~1.7 KB per group per tick
// at the headline shape, both logs included) dominate the bytes; the
// in-kernel form adds ~60 threefry blocks per group per tick of 32-bit
// integer work (the mailbox's delays two more per send), so its operations
// bound is close to its bytes bound. chip_smoke.py computes both from the
// run's own data.
//
// Built twice (ops/build.py): for the wide layout, and with -DRAFT_PACKED=1
// for the §14 packed layout (tick_body.cuh PackedMem) with the §18 packed
// compute as its kPC instantiations — kernel #4, the JAX package's
// _enter/_exit_packed_lattice (pallas_tick.py:135/:152) inlined in
// _make_fused_core under compute="packed" (:794-954). The packed build
// loads its group from the packed tensors once a launch and stores it once
// (narrowing, the width-overflow latch ORed into the group's `ov` byte at
// the launch's end, as the JAX package's scan packs at each launch's end;
// a log or §10 slot value is narrowed and checked where it is written, so
// a miss overwritten within the launch latches too: tick_body.cuh).
// Its snapshots hold the same wide values as the wide build's: int32, the
// logs in the wide log dtype (log_is_int16), votes and responses under
// packed compute the popcounts of the words. Its plain version is
// ops/cuda_tick.py fused_tick_plain(layout="packed"). A §12 bank (kScen) is
// not built packed: ops/cuda_scan refuses that pair. Bound: bytes again, the
// packed state's read and write once a launch plus the snapshots.
//
// A §15 compaction config runs the kCompact instantiations (the JAX
// package's _make_fused_core with the snapshot operands, :817) —
// tick_body.cuh's Snap, the group's snapshot planes in registers across
// the launch — in every form the non-§15 kernel has: int32 or int16 logs,
// synchronous, kScen or kMail (an InstallSnapshot rides the append slot),
// staged and in-kernel, the wide layout (int32 positions) and the packed
// one (latched int16 positions, kPC too), each with its observer build,
// and kernel #7's Snap form (wide, staged, as the JAX package's). They are
// built apart, with -DRAFT_COMPACT=1 (ops/build.py: one library and one
// nvcc process per layout and observer choice, as the others), and only
// there. Their observers add the recorder's §15 counters (folds, installs)
// and invariant 6, and address the logs by position (obs_tick).
//
// The wide build also holds kernel #7, the JAX package's archival K-tick
// kernel (raft_k_tick_kernel: the staged form's K ticks with no snapshot,
// key table or in-flight code; staged_tick is the tick both share), and
// two draws alone, each timed on its own: the §10 delay draw
// (delay_draw_kernel) and a §12 bank's edge lattice with its partition
// programs' cut masks (part_down_kernel).
//
// Plain C interface (bound with ctypes): raft_fused_launch() and
// raft_k_tick_launch() fill the parameter block from a pointer array and
// an integer array (parse_launch), launch on the caller's stream without
// synchronising, and return cudaGetLastError(); so do the draws' entries.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "kt_rng.cuh"
#include "tick_body.cuh"
#include "tile.cuh"

#ifndef RAFT_PACKED
#define RAFT_PACKED 0
#endif
#ifndef RAFT_OBSERVE
#define RAFT_OBSERVE 0
#endif
#ifndef RAFT_COMPACT
#define RAFT_COMPACT 0
#endif
// RAFT_MAIL=1 builds the §10 mailbox's instantiations alone, =0 the
// synchronous ones alone, unset both (ops/build.py splits each fused
// library in two so that the halves compile side by side).
#ifndef RAFT_MAIL
#define RAFT_MAIL -1
#endif

namespace {

using namespace raft;

// Whether this build holds the mailbox's (`mail`) or the synchronous
// instantiations.
constexpr bool built(bool mail) {
  return mail ? RAFT_MAIL != 0 : RAFT_MAIL != 1;
}

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

constexpr int KIND_FAULT = 2, KIND_CRASH = 3, KIND_RESTART = 4,
              KIND_LINK_FAIL = 5, KIND_LINK_HEAL = 6;

// Field ids in STATE_FIELDS order (the snapshot pointer slots).
enum Field {
  F_TERM, F_VOTED_FOR, F_ROLE, F_COMMIT, F_LAST_INDEX, F_PHYS_LEN,
  F_LOG_TERM, F_LOG_CMD, F_LAST_TERM, F_EL_ARMED, F_EL_LEFT, F_ROUND_STATE,
  F_ROUND_LEFT, F_ROUND_AGE, F_VOTES, F_RESPONSES, F_RESPONDED, F_BO_LEFT,
  F_NEXT_INDEX, F_MATCH_INDEX, F_HB_ARMED, F_HB_LEFT, F_UP, F_LINK_UP,
  F_T_CTR, F_B_CTR, F_ROUNDS, F_CAP_OV
};

// Pointer order = the wrapper's operand order (ops/cuda_tick.py
// fused_operands).
struct Params {
  StateP st;
  MailP mb;  // null without the mailbox
  // Per-field (T, rows, G) snapshot outputs, null where not snapshotted:
  // int32 for every field but the logs, which keep their storage dtype.
  void* snap[kStateFields];
  // Staged draws (null under in-kernel draws or for a channel that is off).
  const int16_t* edge_iid; const uint8_t* crash_m; const uint8_t* restart_m;
  const int16_t* link_fail; const int16_t* link_heal;
  const int32_t* periodic; const int16_t* el_table; const int16_t* b_table;
  const int16_t* delay;
  // In-kernel draws: key table (4 + bank rows, G) and key-word planes
  // (2N, G).
  const int32_t* ktab; const int32_t* tkw; const int32_t* bkw;
  int32_t* overflow;
  // (T, 2, G) int32: the §10 slots in flight after each tick and the
  // bitmask of nodes owning an append slot in flight (tick_body's
  // Inflight), or null.
  int32_t* inflight;
  // The in-kernel observers (the observer build; null in the other): the
  // (T, kObsR) int64 rows, the monitor's (G,) taints (bool as uint8) or
  // null without the monitor, its (G,) per-group counters or null, and the
  // shadow logs of the write tracking (the logs' layout and dtypes).
  int64_t* obs_rows;
  uint8_t* taint_restart;
  uint8_t* taint_unsafe;
  int32_t* grp_elections;
  int32_t* grp_fault_events;
  int32_t* grp_violations;
  void* start_term;
  void* start_cmd;
  // The §15 snapshot planes (null without compaction).
  SnapP sn;
};
constexpr int kPointers = kStatePointers + kStateFields + kMailFields + 25;
static_assert(sizeof(Params) == kPointers * sizeof(void*),
              "Params must be exactly kPointers pointers");

struct FusedConsts {
  int T, W, cmd_period, el_lo, el_hi, bo_lo, bo_hi;
  // 23-bit thresholds; 0 = the channel's constant fast path (an edge
  // always survives, an event never fires), as make_aux's p <= 0 path.
  int drop_t, crash_t, restart_t, lfail_t, lheal_t;
  // §12 bank rows (kScen): key-table row offsets from row 4 of each
  // channel's thresholds, of the delay window's [lo; hi] and of the
  // partition program's [kind; cut; src; dst; period; duty; phase]; -1
  // where the bank has none (the scalar above applies). A row's 0 is a
  // threshold, not "off": the compare makes it never fire.
  int drop_r, crash_r, restart_r, lfail_r, lheal_r, delay_r, part_r;
  int warmup;  // §15 warmup-down W (0 = none)
  bool log16;  // the snapshots' log dtype is int16 (else int32)
};

// Whether a channel is drawn: a bank row or a positive scalar threshold.
__device__ __forceinline__ bool drawn(int row, int scalar) {
  return row >= 0 || scalar > 0;
}

// Tick t of a staged launch: the T-stacked channels and the draw tables.
struct StagedAux {
  static constexpr bool kLoads = true;
  const Params& p;
  const FusedConsts& f;
  int64_t G, g;
  int t;
  const int* t0;  // the launch's first t_ctr / b_ctr, per node
  const int* b0;
  __device__ __forceinline__ int64_t at(int rows, int row) const {
    return (static_cast<int64_t>(t) * rows + row) * G + g;
  }
  // Node n's entry at offset delta of a (N*Wn, G) table: 0 below the
  // window, clamped above it (the caller counts the overflow).
  __device__ __forceinline__ int sel(const int16_t* tab, int Wn, int n,
                                     int delta) const {
    if (delta < 0) return 0;
    const int d = delta < Wn - 1 ? delta : Wn - 1;
    return tab[(static_cast<int64_t>(n) * Wn + d) * G + g];
  }
  __device__ __forceinline__ bool edge(int a, int b) const {
    return p.edge_iid[at(N * N, a * N + b)] != 0;
  }
  __device__ __forceinline__ bool crash(int n) const {
    return p.crash_m[at(N, n)] != 0;
  }
  __device__ __forceinline__ bool restart(int n) const {
    return p.restart_m[at(N, n)] != 0;
  }
  __device__ __forceinline__ bool link_fail(int a, int b) const {
    return p.link_fail[at(N * N, a * N + b)] != 0;
  }
  __device__ __forceinline__ bool link_heal(int a, int b) const {
    return p.link_heal[at(N * N, a * N + b)] != 0;
  }
  __device__ __forceinline__ int el_draw_f(int n, int tctr) const {
    return sel(p.el_table, f.W, n, tctr - t0[n]);
  }
  __device__ __forceinline__ int bdraw(int n, int bctr) const {
    return sel(p.b_table, f.T, n, bctr - b0[n]);
  }
  __device__ __forceinline__ int periodic() const {
    return p.periodic[static_cast<int64_t>(t) * G + g];
  }
  __device__ __forceinline__ int inject(int) const { return -1; }
  __device__ __forceinline__ int delay(int a, int b) const {
    return p.delay[at(N * N, a * N + b)];
  }
};

// Tick `tick` drawn in the kernel: each channel from its (kind, tick) key
// at the group's flat lattice index, each counted draw from the node's key.
struct InkernelAux {
  static constexpr bool kLoads = false;
  const FusedConsts& f;
  kt::Key k_edge, k_crash, k_restart, k_fail, k_heal;
  const kt::Key* tk;
  const kt::Key* bk;
  uint32_t gidx;
  int tick;
  kt::DelayKey k_delay;  // the tick's delay channel (the mailbox, lo < hi)
  int delay_lo, delay_hi;
  __device__ __forceinline__ uint32_t pair_idx(int a, int b) const {
    return gidx * static_cast<uint32_t>(N * N) + static_cast<uint32_t>(a * N + b);
  }
  __device__ __forceinline__ uint32_t node_idx(int n) const {
    return gidx * static_cast<uint32_t>(N) + static_cast<uint32_t>(n);
  }
  __device__ __forceinline__ bool edge(int a, int b) const {
    return f.drop_t <= 0 || kt::bits23(k_edge, pair_idx(a, b)) >= f.drop_t;
  }
  __device__ __forceinline__ bool crash(int n) const {
    return f.crash_t > 0 && kt::bits23(k_crash, node_idx(n)) < f.crash_t;
  }
  __device__ __forceinline__ bool restart(int n) const {
    return f.restart_t > 0 &&
           kt::bits23(k_restart, node_idx(n)) < f.restart_t;
  }
  __device__ __forceinline__ bool link_fail(int a, int b) const {
    return f.lfail_t > 0 && kt::bits23(k_fail, pair_idx(a, b)) < f.lfail_t;
  }
  __device__ __forceinline__ bool link_heal(int a, int b) const {
    return f.lheal_t > 0 && kt::bits23(k_heal, pair_idx(a, b)) < f.lheal_t;
  }
  __device__ __forceinline__ int el_draw_f(int n, int tctr) const {
    return kt::draw_uniform(tk[n], tctr, f.el_lo, f.el_hi);
  }
  __device__ __forceinline__ int bdraw(int n, int bctr) const {
    return kt::draw_uniform(bk[n], bctr, f.bo_lo, f.bo_hi);
  }
  __device__ __forceinline__ int periodic() const {
    const bool due = floor_mod(tick, f.cmd_period) == 0 && tick > 0;
    return due ? tick : -1;
  }
  __device__ __forceinline__ int inject(int) const { return -1; }
  __device__ __forceinline__ int delay(int a, int b) const {
    return kt::delay_draw(k_delay, pair_idx(a, b), delay_lo, delay_hi);
  }
};

// The group's §12 partition program at `tick` as its cut mask
// (kt::cut_mask): the bank's seven partition rows [kind; cut; src; dst;
// period; duty; phase], from key-table row 4 + part_r, read once and the
// flapping window's floor_mod evaluated once a group a tick. `lead`: bit n
// where node n was a live leader at the tick's start. I is the offset type:
// 64-bit in the fused kernel, 32-bit where the launcher has checked that
// every offset fits.
template <typename I>
__device__ __forceinline__ kt::CutMask<N> scen_cut(
    const int32_t* ktab, I G, I g, int part_r, int tick, unsigned lead) {
  if (part_r < 0) return 0;
  // All seven loads issued together, with no branch on the kind between
  // them; a group without a program (kind 0) divides by 1.
  const int32_t* row = ktab + (4 + static_cast<I>(part_r)) * G + g;
  int r[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) r[i] = __ldg(row + i * G);
  const bool active =
      floor_mod(tick + r[6], r[0] != 0 ? r[4] : 1) < r[5];
  return kt::cut_mask<N>(r[0], r[1], r[2], r[3], active, lead);
}

// A §12 bank's threshold: its key-table row r (-1: none) at group g, else
// the scalar.
template <typename I>
__device__ __forceinline__ int scen_thresh(const int32_t* ktab, I G, I g,
                                           int r, int scalar) {
  return r >= 0 ? __ldg(ktab + (4 + r) * G + g) : scalar;
}

// The §12 drop draw of edge q = a*N + b of group gidx: its 23-bit uniform
// under the tick's KIND_FAULT key k_edge (the edge is down where this is
// under the bank's threshold). The one definition for both callers:
// ScenAux::edge, on the out-of-line block, and part_down_kernel with
// kInline, the block inlined so that a thread's N*N draws overlap. The
// threshold is compared at the call, after the draw: loaded before it, the
// fused kernel's observer build held it across the out-of-line call and
// went from 168 to 192 registers and 0.41 to 0.43 ms a farm launch (one
// H100, raft_kotlin_tpu_torch/kernel_ab.py --config farm).
template <bool kInline>
__device__ __forceinline__ int scen_drop_bits(kt::Key k_edge, uint32_t gidx,
                                              int q) {
  return kt::bits23<kInline>(k_edge, gidx * static_cast<uint32_t>(N * N) +
                                         static_cast<uint32_t>(q));
}

// Tick `tick` drawn in the kernel through a §12 scenario bank: the
// InkernelAux channels with each threshold taken from the group's key-table
// row where the bank has one (read at the point of use: per group,
// coalesced, and not worth a register each — with all five in registers
// the farm's observer build went from 168 to 195 registers and its launch
// from 0.385 to 0.429 ms, one H100, raft_kotlin_tpu_torch/kernel_ab.py), the
// delay window read once a tick where the aux is built (InkernelAux's
// window: the farm mailbox's launch 1.03 → 0.90 ms there), the partition
// program as the tick's cut mask (scen_cut, built where the aux is), and
// the warmup-down schedule on crash and restart
// (utils/rng.apply_warmup_faults). The draws keep the global group index
// gidx; the universe id keyed only the bank, sampled on the host.
struct ScenAux : InkernelAux {
  const int32_t* ktab;
  int64_t G, g;
  int cmd;             // cmd_node - 1
  kt::CutMask<N> cut;  // bit a*N + b: the program cuts a -> b this tick
  __device__ __forceinline__ int thresh(int r, int scalar) const {
    return scen_thresh(ktab, G, g, r, scalar);
  }
  __device__ __forceinline__ bool held(int n) const {  // warmup: t < W
    return f.warmup > 0 && n != cmd && tick < f.warmup;
  }
  __device__ __forceinline__ bool edge(int a, int b) const {
    if (drawn(f.drop_r, f.drop_t) &&
        scen_drop_bits<false>(k_edge, gidx, a * N + b) <
            thresh(f.drop_r, f.drop_t))
      return false;
    return !((cut >> (a * N + b)) & 1u);
  }
  __device__ __forceinline__ bool crash(int n) const {
    return held(n) || (drawn(f.crash_r, f.crash_t) &&
                       kt::bits23(k_crash, node_idx(n)) <
                           thresh(f.crash_r, f.crash_t));
  }
  __device__ __forceinline__ bool restart(int n) const {
    if (f.warmup > 0 && n != cmd && tick <= f.warmup)
      return tick == f.warmup;  // held down, then rejoins at t == W
    return drawn(f.restart_r, f.restart_t) &&
           kt::bits23(k_restart, node_idx(n)) <
               thresh(f.restart_r, f.restart_t);
  }
  __device__ __forceinline__ bool link_fail(int a, int b) const {
    return drawn(f.lfail_r, f.lfail_t) &&
           kt::bits23(k_fail, pair_idx(a, b)) < thresh(f.lfail_r, f.lfail_t);
  }
  __device__ __forceinline__ bool link_heal(int a, int b) const {
    return drawn(f.lheal_r, f.lheal_t) &&
           kt::bits23(k_heal, pair_idx(a, b)) < thresh(f.lheal_r, f.lheal_t);
  }
};

// Tick t of a staged launch (the fused kernel's staged form, and kernel
// #7): the tick's channels from the T-stacked slabs, its counted draws
// from the tables. Every table select is counted into ov, used or not, as
// the plain version counts them: the restart draw at t_ctr (under the
// fault channels), the backoff draw at b_ctr, and el_left's draw at
// t_ctr - 1, materialized where the tick reset the node's timer.
template <bool kMail, bool kPC, typename Mem, typename Sn>
__device__ __forceinline__ Inflight staged_tick(
    const Params& p, const Consts& k, const FusedConsts& f, Group<kPC>& s,
    Mem& mem, int64_t G, int64_t g, int t, const int* t0, const int* b0,
    int* ov, Sn& sn) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if (k.flags & FLAG_FAULTS) ov[n] += s.tctr[n] - t0[n] >= f.W;
    ov[n] += s.bctr[n] - b0[n] >= f.T;
  }
  StagedAux aux{p, f, G, g, t, t0, b0};
  const Inflight inflight = tick_body<kMail>(s, mem, k, aux, sn);
#pragma unroll
  for (int n = 0; n < N; ++n) {  // §7: the draw at t_ctr - 1
    const int d = s.tctr[n] - 1 - t0[n];
    ov[n] += d >= f.W;
    if (s.dirty[n]) s.el_left[n] = aux.sel(p.el_table, f.W, n, d);
  }
  return inflight;
}

// Rows of a node's log copied into a (rows, G) snapshot.
template <typename D, typename S>
__device__ __forceinline__ void copy_log(D* d, const S* src, int64_t rows,
                                         int64_t G, int64_t g) {
#pragma unroll 4
  for (int64_t r = 0; r < rows; ++r)
    d[r * G] = static_cast<D>(src[r * G + g]);
}

// Tick t's snapshot rows of every field with an output. The logs keep the
// wide log dtype LT; under the packed layout they are read from its int8 /
// int16 logs and widened to int16 or int32 by log16.
template <typename LT, bool kMail, bool kPC, typename Mem>
__device__ __forceinline__ void snapshot(const Params& p, const Group<kPC>& s,
                                         const Mem& mem, bool log16,
                                         int64_t G, int64_t g, int C,
                                         int t, const Inflight& inflight) {
  if constexpr (kMail) {
    if (p.inflight) {
      int32_t* d = p.inflight + static_cast<int64_t>(t) * 2 * G + g;
      d[0] = inflight.count;
      d[G] = inflight.aq_owners;
    }
  }
#define SNAP_ROWS(F, rows, value)                                        \
  if (p.snap[F]) {                                                       \
    int32_t* d = static_cast<int32_t*>(p.snap[F]) +                      \
                 static_cast<int64_t>(t) * (rows) * G + g;               \
    _Pragma("unroll") for (int r = 0; r < (rows); ++r) d[r * G] = (value); \
  }
  SNAP_ROWS(F_TERM, N, s.term[r])
  SNAP_ROWS(F_VOTED_FOR, N, s.vf[r])
  SNAP_ROWS(F_ROLE, N, s.role[r])
  SNAP_ROWS(F_COMMIT, N, s.commit[r])
  SNAP_ROWS(F_LAST_INDEX, N, s.li[r])
  SNAP_ROWS(F_PHYS_LEN, N, s.pl[r])
  SNAP_ROWS(F_LAST_TERM, N, s.ltc[r])
  SNAP_ROWS(F_EL_ARMED, N, s.ela[r])
  SNAP_ROWS(F_EL_LEFT, N, s.el_left[r])
  SNAP_ROWS(F_ROUND_STATE, N, s.rs[r])
  SNAP_ROWS(F_ROUND_LEFT, N, s.rl[r])
  SNAP_ROWS(F_ROUND_AGE, N, s.ra[r])
  if constexpr (kPC) {  // §18: the tallies are the words' popcounts
    SNAP_ROWS(F_VOTES, N, __popc(s.vb[r]))
    SNAP_ROWS(F_RESPONSES, N, __popc(s.rb[r]))
    SNAP_ROWS(F_RESPONDED, N * N, (s.rb[r / N] >> (r % N)) & 1u)
  } else {
    SNAP_ROWS(F_VOTES, N, s.votes[r])
    SNAP_ROWS(F_RESPONSES, N, s.resps[r])
    SNAP_ROWS(F_RESPONDED, N * N, s.resp_d[r])
  }
  SNAP_ROWS(F_BO_LEFT, N, s.bo[r])
  SNAP_ROWS(F_NEXT_INDEX, N * N, s.ni[r])
  SNAP_ROWS(F_MATCH_INDEX, N * N, s.mi[r])
  SNAP_ROWS(F_HB_ARMED, N, s.hba[r])
  SNAP_ROWS(F_HB_LEFT, N, s.hbl[r])
  SNAP_ROWS(F_UP, N, s.up[r])
  SNAP_ROWS(F_LINK_UP, N * N, s.link[r])
  SNAP_ROWS(F_T_CTR, N, s.tctr[r])
  SNAP_ROWS(F_B_CTR, N, s.bctr[r])
  SNAP_ROWS(F_ROUNDS, N, s.rounds[r])
  SNAP_ROWS(F_CAP_OV, N, s.capov[r])
#undef SNAP_ROWS
  const int64_t rows = static_cast<int64_t>(N) * C;
  void* const dst[2] = {p.snap[F_LOG_TERM], p.snap[F_LOG_CMD]};
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    if (!dst[w]) continue;
    const int64_t off = t * rows * G + g;
    if constexpr (Mem::kPacked) {
      if (log16) {
        int16_t* d = static_cast<int16_t*>(dst[w]) + off;
        if (w == 0) copy_log(d, mem.lt(), rows, G, g);
        else copy_log(d, mem.lc(), rows, G, g);
      } else {
        int32_t* d = static_cast<int32_t*>(dst[w]) + off;
        if (w == 0) copy_log(d, mem.lt(), rows, G, g);
        else copy_log(d, mem.lc(), rows, G, g);
      }
    } else {
      copy_log(static_cast<LT*>(dst[w]) + off, w == 0 ? mem.lt() : mem.lc(),
               rows, G, g);
    }
  }
}


// ---------------------------------------------------------------------------
// The in-kernel observers (the observer build, RAFT_OBSERVE=1): the flight
// recorder's and the safety monitor's step (utils/telemetry.py
// telemetry_step_arrays, monitor_step_arrays / invariant_matrix) computed
// for every tick and group from the tick's pre-state, kept in shared memory
// at the tick's start, and its post-state in registers. Its plain form is
// utils/telemetry.obs_tick_rows; the two are held bit-equal.
//
// Shared memory is [word][threadIdx.x] (a thread's words a block-width
// apart, so a warp's accesses hit 32 banks): the pre-tick view, the
// group's monitor carry, the tick's contributions and the write-tracking
// masks (tick_body.cuh LogTrack), after a (warps, kObsR) int64 scratch for
// the block's partial reductions.

// The row's columns (utils/telemetry OBS_*): the recorder's 10 sums, the
// slots in flight, the 7 invariants' violations, the latch key's minimum,
// the frontier's minimum and maximum, the live leaders.
constexpr int kObsSums = 10, kObsInflight = 10, kObsViol = 11,
              kObsLatch = 18, kObsFrMin = 19, kObsFrMax = 20,
              kObsLeaders = 21, kObsR = 22;
constexpr int kNInv = 7;
constexpr int kBig = 0x7fffffff;

// A thread's shared words.
enum : int {
  O_BITS0 = 0,                // up (bit n), hb_armed (bit N + n)
  O_BITS1 = 1,                // role == LEADER (bit n), cap_ov != 0 (N + n)
  O_TERM = 2,
  O_LI = O_TERM + N,
  O_CM = O_LI + N,
  O_VOTES = O_CM + N,
  O_ROUNDS = O_VOTES + N,
  O_NI = O_ROUNDS + N,
  O_MI = O_NI + N * N,
  O_TAINT = O_MI + N * N,     // bit 0 taint_restart, bit 1 taint_unsafe
  O_GV, O_GF, O_GE,           // the per-group counters
  O_OWN,                      // §10: append owners at the tick's start
  O_SI,                       // §15: snap_index at the tick's start (N)
  O_C = O_SI + N,             // kObsR contributions of the tick
  O_MASKS = O_C + kObsR       // then 2 * N * cw mask words
};

__device__ __forceinline__ bool bit_of(unsigned m, int i) {
  return (m >> i) & 1u;
}

// The pre-tick view of the group in `s` (and `sn`), and the tick's masks
// cleared.
template <bool kPC, typename Sn>
__device__ __forceinline__ void obs_pre(uint32_t* o, int st, int cw,
                                        const Group<kPC>& s, const Sn& sn) {
  unsigned b0 = 0u, b1 = 0u;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    b0 |= (s.up[n] ? 1u << n : 0u) | (s.hba[n] ? 1u << (N + n) : 0u);
    b1 |= (s.role[n] == LEADER ? 1u << n : 0u) |
          (s.capov[n] != 0 ? 1u << (N + n) : 0u);
    o[(O_TERM + n) * st] = s.term[n];
    o[(O_LI + n) * st] = s.li[n];
    o[(O_CM + n) * st] = s.commit[n];
    if constexpr (kPC) o[(O_VOTES + n) * st] = __popc(s.vb[n]);
    else o[(O_VOTES + n) * st] = s.votes[n];
    o[(O_ROUNDS + n) * st] = s.rounds[n];
    if constexpr (Sn::kOn) o[(O_SI + n) * st] = sn.si[n];
  }
#pragma unroll
  for (int q = 0; q < N * N; ++q) {
    o[(O_NI + q) * st] = s.ni[q];
    o[(O_MI + q) * st] = s.mi[q];
  }
  o[O_BITS0 * st] = b0;
  o[O_BITS1 * st] = b1;
#pragma unroll 1
  for (int w = 0; w < 2 * N * cw; ++w) o[(O_MASKS + w) * st] = 0u;
}

// The tick's contributions of a thread with no group: the identities.
__device__ __forceinline__ void obs_idle(uint32_t* o, int st) {
#pragma unroll
  for (int r = 0; r < kObsR; ++r)
    o[(O_C + r) * st] = static_cast<uint32_t>(
        r == kObsLatch || r == kObsFrMin ? kBig
        : r == kObsFrMax               ? -kBig - 1
                                       : 0);
}

// The tick's step of the recorder and (`monitor`) the monitor, from the
// pre-tick view in `o` and the post-tick state in `s` (its logs through
// `mem`, under §15 its snapshot planes in `sn`): the contributions into
// `o`'s O_C words, the carry updated in `o`. `cur`: the §10 slots in
// flight at the tick's end. Under §15 the monitor addresses the logs by
// position, as utils/telemetry.invariant_matrix does: slot x of a node
// with base b holds position b + floor_mod(x - b, C).
template <bool kMail, bool kPC, typename Mem, typename Sn>
__device__ __forceinline__ void obs_tick(uint32_t* o, int st, int cw,
                                         const Group<kPC>& s, const Mem& mem,
                                         const Consts& k, int64_t g,
                                         bool monitor, bool per_group,
                                         const Inflight& cur, const Sn& sn) {
  constexpr bool kC = Sn::kOn;
  constexpr unsigned kAll = (1u << N) - 1u;
  auto P = [&](int w) -> int { return static_cast<int>(o[w * st]); };
  auto put = [&](int r, int v) { o[(O_C + r) * st] = static_cast<uint32_t>(v); };
  const unsigned b0 = o[O_BITS0 * st], b1 = o[O_BITS1 * st];
  unsigned cu = 0u, lc = 0u;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    cu |= s.up[n] ? 1u << n : 0u;
    lc |= (s.role[n] == LEADER && s.up[n]) ? 1u << n : 0u;
  }
  const unsigned pu = b0 & kAll, lp = b1 & pu, rs = cu & ~pu;
  const unsigned nl = lc & ~lp, reset = nl | rs;
  // -- the recorder (telemetry_step_arrays)
  int el = 0, vg = 0, ca = 0, ce = 0, aa = 0, ar = 0;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int r0 = P(O_ROUNDS + n);
    el += s.rounds[n] - r0;
    const int base = (s.rounds[n] > r0 || bit_of(rs, n)) ? 0 : P(O_VOTES + n);
    int votes;
    if constexpr (kPC) votes = __popc(s.vb[n]);
    else votes = s.votes[n];
    vg += max(votes - base, 0);
    ca += max(s.commit[n] - P(O_CM + n), 0);
    ce += s.capov[n] != 0 && !bit_of(b1, N + n);
  }
#pragma unroll
  for (int q = 0; q < N * N; ++q) {
    if (bit_of(reset, q / N)) continue;
    aa += max(s.mi[q] - P(O_MI + q), 0);
    ar += max(P(O_NI + q) - s.ni[q], 0);
  }
  const int fe = __popc(pu ^ cu);
  // §15 snapshot events (telemetry.snap_transitions): a fold advances
  // snap_index within the pre-tick log; an install jumps it past the
  // node's last_index and re-seats last_index at it. A restarted node
  // counts from the wiped baseline.
  int folds = 0, installs = 0;
  if constexpr (kC) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const bool r = bit_of(rs, n);
      const int si_p = r ? 0 : P(O_SI + n), li_p = r ? 0 : P(O_LI + n);
      const bool adv = sn.si[n] > si_p;
      const bool inst = adv && sn.si[n] > li_p && sn.si[n] <= s.li[n];
      folds += adv && !inst;
      installs += inst;
    }
  }
  put(0, el);
  put(1, __popc(nl));
  put(2, vg);
  put(3, ca);
  put(4, aa);
  put(5, ar);
  put(6, fe);
  put(7, ce);
  put(8, folds);
  put(9, installs);
  put(kObsInflight, kMail ? cur.count : 0);
  int fr = s.commit[0];
#pragma unroll
  for (int n = 1; n < N; ++n) fr = max(fr, s.commit[n]);
  put(kObsFrMin, fr);
  put(kObsFrMax, fr);
  put(kObsLeaders, __popc(lc));
  unsigned vbits = 0u;
  if (monitor) {
    // -- the monitor (invariant_matrix): the taints first.
    const unsigned taint = o[O_TAINT * st];
    const bool tr = (taint & 1u) || rs != 0u;
    bool tu = (taint & 2u) != 0u, unsafe = false, justify = false;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      if (!(s.commit[n] > P(O_CM + n) && bit_of(lc, n) && !bit_of(rs, n)))
        continue;
      const int c1 = s.commit[n] - 1;
      int top;
      if constexpr (kC) {  // a fully folded committed prefix: snap_term
        top = s.commit[n] == sn.si[n] ? sn.st[n]
              : (c1 >= sn.si[n] && c1 < sn.si[n] + k.C)
                  ? mem.log_term(n, c1 % k.C)
                  : 0;
      } else {
        top = (c1 >= 0 && c1 < k.C) ? mem.log_term(n, c1) : 0;
      }
      if (top == s.term[n]) justify = true;
      else unsafe = true;
    }
    tu = (tu || unsafe) && !(justify && !unsafe);
    bool hazard = false;
#pragma unroll
    for (int n = 0; n < N; ++n)
      hazard = hazard ||
               (bit_of(b0, N + n) && bit_of(pu, n) && !bit_of(b1, n));
    if constexpr (kMail) hazard = hazard || (P(O_OWN) & ~lp & kAll) != 0u;
    // 0 — Election Safety.
    bool v0 = false;
#pragma unroll
    for (int a = 0; a < N; ++a)
#pragma unroll
      for (int b = a + 1; b < N; ++b)
        v0 = v0 || (bit_of(lc, a) && bit_of(lc, b) && s.term[a] == s.term[b]);
    v0 = v0 && !tr;
    // Whether node n's log changed (its changed mask) below `bound`. Under
    // §15 only a slot whose position did not move counts (a recycled slot
    // is the digest's), its position taken post-tick or (`at_pre`)
    // pre-tick.
    auto changed_below = [&](int n, int bound, bool at_pre) -> bool {
      bool any = false;
      if constexpr (kC) {
        const int bc = sn.si[n], bp = P(O_SI + n);
#pragma unroll 1
        for (int w = 0; w < cw && !any; ++w) {
          uint32_t m = o[(O_MASKS + N * cw + n * cw + w) * st];
          while (m != 0u && !any) {
            const int x = 32 * w + __ffs(m) - 1;
            m &= m - 1u;
            const int pc = bc + floor_mod(x - bc, k.C);
            const int pp = bp + floor_mod(x - bp, k.C);
            any = pc == pp && (at_pre ? pp : pc) < bound;
          }
        }
      } else {
        (void)at_pre;
#pragma unroll 1
        for (int w = 0; w < cw; ++w) {
          const int lim = bound - 32 * w;
          if (lim <= 0) break;
          const uint32_t m = lim >= 32 ? ~0u : (1u << lim) - 1u;
          any = any || (o[(O_MASKS + N * cw + n * cw + w) * st] & m) != 0u;
        }
      }
      return any;
    };
    // 1 — Leader Append-Only: from the tick's own writes.
    bool v1 = false;
#pragma unroll
    for (int n = 0; n < N; ++n)
      if (bit_of(lc & lp, n) && s.term[n] == P(O_TERM + n))
        v1 = v1 || changed_below(n, min(P(O_LI + n), s.li[n]), false);
    // 4 — the commit frontier (restart-masked prev side).
    int fr_p = bit_of(rs, 0) ? 0 : P(O_CM);
#pragma unroll
    for (int n = 1; n < N; ++n)
      fr_p = max(fr_p, bit_of(rs, n) ? 0 : P(O_CM + n));
    const bool v4 = fr < fr_p;
    // 5 — committed-prefix immutability: from the tick's own writes.
    bool v5 = false;
    if (!tr && !tu && !hazard) {
#pragma unroll
      for (int n = 0; n < N; ++n)
        if (!bit_of(rs, n))
          v5 = v5 || changed_below(n, min(P(O_CM + n), P(O_LI + n)), true);
    }
    // 2 / 3 — Log Matching and Leader Completeness over pristine logs:
    // one pass over the slots below the pairs' common prefix, each node's
    // slot read once.
    bool v2 = false, v3 = false;
    if (!tr) {
      unsigned pr = 0u;
#pragma unroll
      for (int n = 0; n < N; ++n) pr |= s.pl[n] == s.li[n] ? 1u << n : 0u;
      const bool v3on = !tu && !hazard;
      // Pair (l, n) answers to invariant 3: l a live leader, both logs
      // pristine, n not restarted.
      auto rel = [&](int l, int n) {
        return v3on && bit_of(lc, l) && bit_of(pr, l) && bit_of(pr, n) &&
               !bit_of(rs, n);
      };
      int L = 0;
#pragma unroll
      for (int a = 0; a < N; ++a)
#pragma unroll
        for (int b = a + 1; b < N; ++b) {
          if (bit_of(pr, a) && bit_of(pr, b))
            L = max(L, min(s.li[a], s.li[b]));
          if (rel(a, b) && min(s.commit[b], s.li[b]) > s.li[a]) v3 = true;
          if (rel(b, a) && min(s.commit[a], s.li[a]) > s.li[b]) v3 = true;
        }
      if constexpr (kC) {
        // §15: per pair, the positions in both live windows below both
        // last indices, in position order from the larger base.
        (void)L;
#pragma unroll
        for (int a = 0; a < N; ++a)
#pragma unroll
          for (int b = a + 1; b < N; ++b) {
            if (!(bit_of(pr, a) && bit_of(pr, b))) continue;
            const int lo = max(sn.si[a], sn.si[b]);
            const int hi = min(min(sn.si[a], sn.si[b]) + k.C,
                               min(s.li[a], s.li[b]));
            const int lim_ab = rel(a, b)
                ? min(min(s.commit[b], s.li[b]), s.li[a]) : lo;
            const int lim_ba = rel(b, a)
                ? min(min(s.commit[a], s.li[a]), s.li[b]) : lo;
            bool seen = false;
#pragma unroll 1
            for (int x = lo; x < hi; ++x) {
              const int slot = x % k.C;
              const int ta = mem.log_term(a, slot), tb = mem.log_term(b, slot);
              const bool mism =
                  ta != tb || mem.log_cmd(a, slot) != mem.log_cmd(b, slot);
              seen = seen || mism;
              if (seen && ta == tb) v2 = true;
              if (mism && (x < lim_ab || x < lim_ba)) v3 = true;
            }
          }
      } else {
      unsigned long long seen = 0ull;  // bit of pair (a, b): a mismatch so far
#pragma unroll 1
      for (int x = 0; x < L; ++x) {
        int tv[N], cv[N];
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const bool rd = bit_of(pr, n) && x < s.li[n];
          tv[n] = rd ? mem.log_term(n, x) : 0;
          cv[n] = rd ? mem.log_cmd(n, x) : 0;
        }
        int pi = 0;
#pragma unroll
        for (int a = 0; a < N; ++a)
#pragma unroll
          for (int b = a + 1; b < N; ++b, ++pi) {
            if (!(bit_of(pr, a) && bit_of(pr, b) &&
                  x < min(s.li[a], s.li[b])))
              continue;
            const bool mism = tv[a] != tv[b] || cv[a] != cv[b];
            if (mism) seen |= 1ull << pi;
            if (((seen >> pi) & 1ull) && tv[a] == tv[b]) v2 = true;
            if (mism && ((rel(a, b) &&
                          x < min(min(s.commit[b], s.li[b]), s.li[a])) ||
                         (rel(b, a) &&
                          x < min(min(s.commit[a], s.li[a]), s.li[b]))))
              v3 = true;
          }
      }
      }
    }
    // 6 — §15 snapshot consistency: equal nonzero bases fold equal
    // prefixes. Gated like 3 and 5, and off in a capacity-latched group.
    bool v6 = false;
    if constexpr (kC) {
      bool cap_any = false;
#pragma unroll
      for (int n = 0; n < N; ++n) cap_any = cap_any || s.capov[n] != 0;
      if (!tr && !tu && !hazard && !cap_any) {
#pragma unroll
        for (int a = 0; a < N; ++a)
#pragma unroll
          for (int b = a + 1; b < N; ++b)
            v6 = v6 || (sn.si[a] == sn.si[b] && sn.si[a] > 0 &&
                        (sn.st[a] != sn.st[b] || sn.sd[a] != sn.sd[b]));
      }
    }
    vbits = (v0 ? 1u : 0u) | (v1 ? 2u : 0u) | (v2 ? 4u : 0u) |
            (v3 ? 8u : 0u) | (v4 ? 16u : 0u) | (v5 ? 32u : 0u) |
            (v6 ? 64u : 0u);
    o[O_TAINT * st] = (tr ? 1u : 0u) | (tu ? 2u : 0u);
  }
#pragma unroll
  for (int i = 0; i < kNInv; ++i) put(kObsViol + i, bit_of(vbits, i));
  put(kObsLatch, vbits ? static_cast<int>(g) * kNInv + __ffs(vbits) - 1
                       : kBig);
  if (per_group) {
    o[O_GV * st] += __popc(vbits);
    o[O_GF * st] += fe;
    o[O_GE * st] += el;
  }
  if constexpr (kMail) o[O_OWN * st] = cur.aq_owners;
}

// The block's contributions of the tick reduced (warp, then block) and
// added into its row with one atomic a column: sums, the latch key's and
// the frontier's minimum, the frontier's maximum — integer operations, so
// the order they land in changes no bit. Every thread of the block calls
// it; `words` is the shared word array (column 0), `red` the scratch.
__device__ __forceinline__ void obs_reduce(const uint32_t* words,
                                           long long* red, int64_t* row) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int st = blockDim.x, nw = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int r = 0; r < kObsR; ++r) {
    const int v = static_cast<int>(words[(O_C + r) * st + tid]);
    const int x = (r == kObsLatch || r == kObsFrMin) ? __reduce_min_sync(~0u, v)
                  : r == kObsFrMax                  ? __reduce_max_sync(~0u, v)
                                                    : __reduce_add_sync(~0u, v);
    if (lane == 0) red[warp * kObsR + r] = x;
  }
  __syncthreads();
  for (int r = tid; r < kObsR; r += st) {
    const bool mn = r == kObsLatch || r == kObsFrMin, mx = r == kObsFrMax;
    long long acc = red[r];
    for (int w = 1; w < nw; ++w) {
      const long long v = red[w * kObsR + r];
      acc = mn ? (v < acc ? v : acc) : mx ? (v > acc ? v : acc) : acc + v;
    }
    if (mn) {
      if (acc != kBig) atomicMin(reinterpret_cast<long long*>(row + r), acc);
    } else if (mx) {
      if (acc != -static_cast<long long>(kBig) - 1)
        atomicMax(reinterpret_cast<long long*>(row + r), acc);
    } else if (acc != 0) {
      atomicAdd(reinterpret_cast<unsigned long long*>(row + r),
                static_cast<unsigned long long>(acc));
    }
  }
  __syncthreads();
}

// LT: the wide log dtype (the wide build's logs; the snapshots' in both
// builds); kPC: §18 packed compute (the packed build); kCompact: the §15
// form (the RAFT_COMPACT build: the snapshot planes in registers).
template <typename LT, bool kInkernel, bool kMail, bool kScen, bool kPC,
          bool kCompact = false>
__global__ void __launch_bounds__(128) raft_fused_kernel(
    const Params p, const Consts k, const FusedConsts f) {
  constexpr bool kObs = RAFT_OBSERVE;
  std::conditional_t<kCompact, Snap, NoSnap> sn;
  const int64_t G = k.G;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  // The observer build keeps every thread of a block to its reductions.
  const bool valid = g < G;
  if (!kObs && !valid) return;
  extern __shared__ long long dyn_smem[];
  const int st = blockDim.x, cw = (k.C + 31) / 32;
  uint32_t* const words =
      reinterpret_cast<uint32_t*>(dyn_smem + ((blockDim.x + 31) / 32) * kObsR);
  uint32_t* const o = words + threadIdx.x;
  const bool monitor = p.taint_restart != nullptr;
  const bool per_group = p.grp_violations != nullptr;
  Group<kPC> s;
#if RAFT_PACKED
#if RAFT_OBSERVE
  using Track = LogTrack<int8_t, int16_t>;
  PackedMemT<Track, kCompact> mem{
      p.st.log_term, p.st.log_cmd, p.mb, k, g, 0,
      Track{o + O_MASKS * st, o + (O_MASKS + N * cw) * st, st, cw,
            static_cast<int8_t*>(p.start_term),
            static_cast<int16_t*>(p.start_cmd)}};
#else
  PackedMemT<NoTrack, kCompact> mem{p.st.log_term, p.st.log_cmd, p.mb, k, g,
                                    0};
#endif
  if (valid) load_group(p.st, k.narrow8, G, g, s);
#else
#if RAFT_OBSERVE
  using Track = LogTrack<LT, LT>;
  WideMem<LT, Track, kCompact> mem{
      static_cast<LT*>(p.st.log_term), static_cast<LT*>(p.st.log_cmd), p.mb,
      k, g, 0,
      Track{o + O_MASKS * st, o + (O_MASKS + N * cw) * st, st, cw,
            static_cast<LT*>(p.start_term), static_cast<LT*>(p.start_cmd)}};
#else
  WideMem<LT, NoTrack, kCompact> mem{static_cast<LT*>(p.st.log_term),
                                     static_cast<LT*>(p.st.log_cmd), p.mb, k,
                                     g, 0};
#endif
  if (valid) load_group<kCompact>(p.st, G, g, s);
#endif
  if constexpr (kCompact) {
    if (valid) load_snap(p.sn, G, g, sn);
  }
  if constexpr (kObs) {
    if (valid) {
      // The monitor's per-group carry, and (§10) the nodes owning an
      // append slot in flight at the launch's start, from its due planes.
      o[O_TAINT * st] = monitor ? (p.taint_restart[g] ? 1u : 0u) |
                                      (p.taint_unsafe[g] ? 2u : 0u)
                                : 0u;
      o[O_GV * st] = per_group ? p.grp_violations[g] : 0;
      o[O_GF * st] = per_group ? p.grp_fault_events[g] : 0;
      o[O_GE * st] = per_group ? p.grp_elections[g] : 0;
      unsigned own = 0u;
      if constexpr (kMail) {
#pragma unroll
        for (int q = 0; q < N * N; ++q)
          own |= mem.get(AQ_DUE, q) >= 0 ? 1u << (q / N) : 0u;
      }
      o[O_OWN * st] = own;
    }
  }
  int ov[N], t0[N], b0[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    ov[n] = 0; t0[n] = s.tctr[n]; b0[n] = s.bctr[n];
  }
  kt::Key base{0u, 0u}, tk[N], bk[N];
  int tick0 = 0;
  uint32_t gidx = 0;
  if constexpr (kInkernel) {
    if (valid) {
      base = {static_cast<uint32_t>(p.ktab[g]),
              static_cast<uint32_t>(p.ktab[G + g])};
      tick0 = p.ktab[2 * G + g];
      gidx = static_cast<uint32_t>(p.ktab[3 * G + g]);
#pragma unroll
      for (int n = 0; n < N; ++n) {
        tk[n] = {static_cast<uint32_t>(p.tkw[node_at(G, g, n)]),
                 static_cast<uint32_t>(p.tkw[node_at(G, g, N + n)])};
        bk[n] = {static_cast<uint32_t>(p.bkw[node_at(G, g, n)]),
                 static_cast<uint32_t>(p.bkw[node_at(G, g, N + n)])};
      }
    }
  }

#pragma unroll 1
  for (int t = 0; t < f.T; ++t) {
    if (valid) {
      if constexpr (kObs) obs_pre(o, st, cw, s, sn);
      Inflight inflight;
      if constexpr (kInkernel) {
        const int tick = tick0 + t;
        const kt::Key none{0u, 0u};
        if constexpr (kScen) {
          // The leader program's live leaders, from the registers before
          // phase F changes them: the tick's cut mask is built from them.
          unsigned lead = 0u;
#pragma unroll
          for (int n = 0; n < N; ++n)
            lead |= (s.role[n] == LEADER && s.up[n]) ? 1u << n : 0u;
          ScenAux aux{
              {f,
               drawn(f.drop_r, f.drop_t)
                   ? kt::event_key(base, KIND_FAULT, tick) : none,
               drawn(f.crash_r, f.crash_t)
                   ? kt::event_key(base, KIND_CRASH, tick) : none,
               drawn(f.restart_r, f.restart_t)
                   ? kt::event_key(base, KIND_RESTART, tick) : none,
               drawn(f.lfail_r, f.lfail_t)
                   ? kt::event_key(base, KIND_LINK_FAIL, tick) : none,
               drawn(f.lheal_r, f.lheal_t)
                   ? kt::event_key(base, KIND_LINK_HEAL, tick) : none,
               tk, bk, gidx, tick,
               kMail && k.delay_lo < k.delay_hi ? kt::delay_key(base, tick)
                                                : kt::DelayKey{none, none},
               f.delay_r >= 0 ? __ldg(p.ktab + (4 + f.delay_r) * G + g)
                              : k.delay_lo,
               f.delay_r >= 0 ? __ldg(p.ktab + (5 + f.delay_r) * G + g)
                              : k.delay_hi},
              p.ktab, G, g, k.cmd_node - 1,
              scen_cut(p.ktab, G, g, f.part_r, tick, lead)};
          inflight = tick_body<kMail>(s, mem, k, aux, sn);
        } else {
          InkernelAux aux{
              f,
              f.drop_t > 0 ? kt::event_key(base, KIND_FAULT, tick) : none,
              f.crash_t > 0 ? kt::event_key(base, KIND_CRASH, tick) : none,
              f.restart_t > 0 ? kt::event_key(base, KIND_RESTART, tick)
                              : none,
              f.lfail_t > 0 ? kt::event_key(base, KIND_LINK_FAIL, tick)
                            : none,
              f.lheal_t > 0 ? kt::event_key(base, KIND_LINK_HEAL, tick)
                            : none,
              tk, bk, gidx, tick,
              kMail && k.delay_lo < k.delay_hi ? kt::delay_key(base, tick)
                                               : kt::DelayKey{none, none},
              k.delay_lo, k.delay_hi};
          inflight = tick_body<kMail>(s, mem, k, aux, sn);
        }
#pragma unroll
        for (int n = 0; n < N; ++n) {  // §7: the draw at t_ctr - 1
          if (s.dirty[n])
            s.el_left[n] = kt::draw_uniform(tk[n], s.tctr[n] - 1, f.el_lo,
                                            f.el_hi);
        }
      } else {
        inflight = staged_tick<kMail>(p, k, f, s, mem, G, g, t, t0, b0, ov,
                                      sn);
      }
      snapshot<LT, kMail>(p, s, mem, f.log16, G, g, k.C, t, inflight);
      if constexpr (kObs)
        obs_tick<kMail>(o, st, cw, s, mem, k, g, monitor, per_group,
                        inflight, sn);
    } else if constexpr (kObs) {
      obs_idle(o, st);
    }
    if constexpr (kObs)
      obs_reduce(words, dyn_smem, p.obs_rows + static_cast<int64_t>(t) * kObsR);
  }
  if (!valid) return;
#if RAFT_PACKED
  int wov = store_group(p.st, k.narrow8, G, g, s) | mem.ov;
  if constexpr (kCompact) wov |= store_snap(p.sn, G, g, sn);
  if (wov) p.st.ov[g] = 1;
#else
  store_group<kCompact>(p.st, G, g, s);
  if constexpr (kCompact) store_snap(p.sn, G, g, sn);
#endif
#pragma unroll
  for (int n = 0; n < N; ++n) p.overflow[node_at(G, g, n)] = ov[n];
  if constexpr (kObs) {
    if (monitor) {
      const unsigned taint = o[O_TAINT * st];
      p.taint_restart[g] = taint & 1u;
      p.taint_unsafe[g] = (taint >> 1) & 1u;
    }
    if (per_group) {
      p.grp_violations[g] = static_cast<int>(o[O_GV * st]);
      p.grp_fault_events[g] = static_cast<int>(o[O_GF * st]);
      p.grp_elections[g] = static_cast<int>(o[O_GE * st]);
    }
  }
}

#if !RAFT_OBSERVE && !RAFT_COMPACT && RAFT_MAIL != 0
// kt::delay_draw over one tick's whole (N*N, G) pair lattice, alone: the
// §10 delay channel as ops/tick.make_aux stages it (utils/rng.delay_mask,
// transposed to groups-minor), from the same key table the fused kernel
// reads — in a §12 bank's per-group window where the table has one
// (delay_r >= 0, as FusedConsts). One thread per group.
__global__ void __launch_bounds__(128) delay_draw_kernel(
    const int32_t* ktab, int16_t* out, int64_t G, int lo, int hi,
    int delay_r) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (g >= G) return;
  const kt::Key base{static_cast<uint32_t>(ktab[g]),
                     static_cast<uint32_t>(ktab[G + g])};
  const kt::DelayKey dk = kt::delay_key(base, ktab[2 * G + g]);
  const uint32_t gidx = static_cast<uint32_t>(ktab[3 * G + g]);
  if (delay_r >= 0) {
    lo = ktab[(4 + delay_r) * G + g];
    hi = ktab[(5 + delay_r) * G + g];
  }
#pragma unroll 1
  for (int q = 0; q < N * N; ++q)
    out[q * G + g] = static_cast<int16_t>(kt::delay_draw(
        dk, gidx * static_cast<uint32_t>(N * N) + q, lo, hi));
}

#endif  // !RAFT_OBSERVE && !RAFT_COMPACT && RAFT_MAIL != 0

#if !RAFT_PACKED && !RAFT_OBSERVE
// Kernel #7: K ticks per launch with staged aux and nothing else — the JAX
// package's archival K-tick kernel
// raft_kotlin_tpu/ops/pallas_tick.py::make_pallas_core_k (pallas_call at
// :1473), whose body is phase_body under flags with the deep-log, batched,
// sharded and inject engines off. The channels arrive K-stacked, the
// counted draws as tables (ops/cuda_tick.draw_tables), every select counted
// into `overflow` as the fused staged form counts them (staged_tick). Its
// plain version is ops/cuda_tick.py::k_tick_plain; the two are held
// bit-equal.
//
// Design: the fused kernel's staged form with what only observers need
// taken out — no snapshot stores, no key table, no §10 in-flight rows (the
// tick's Inflight is dead code here), no packed build — so it times what K
// ticks per launch cost on this card without the snapshot traffic. One
// thread per group, the group's non-log state in registers across the K
// ticks, the logs and §10 slots in place. Wide layout only, synchronous
// (kSync) and §10 mailbox (kMail) instantiations for each log dtype; under
// §15 (the RAFT_COMPACT build, kCompact) the same with tick_body.cuh's
// Snap, the snapshot planes in registers across the K ticks and int32
// positions — make_pallas_core_k's snapshot operands (:1378). An install
// resets no more election timers than the append it replaces, so the draw
// tables' window stays resets_per_tick_bound × K.
//
// Bound: bytes — the non-log state read and written once a launch, the
// entries of the K-stacked slabs and of the draw tables the launch's ticks
// select, the log and slot bytes they touch, the overflow counts written;
// chip_smoke.py counts them from the launch's own data (fused_bytes).
//
// A tile form on the one-tick kernel's design (tile.cuh: a tile's slot
// planes and, optionally, its state rows staged in shared memory once a
// launch, each tick's aux slab brought in while the tick before ran) lost
// to this form in the one-call A/B (PERF.md §6; one H100, K=4,
// 102,400 groups): kMail 1.893 → 1.877 ms with all slot planes staged (a
// tie), 2.29-2.53 with the due planes alone or everything; kSync 0.398 →
// 0.57-0.65. Only this form is kept.
template <typename LT, bool kMail, bool kCompact>
__global__ void __launch_bounds__(128) raft_k_tick_kernel(
    const Params p, const Consts k, const FusedConsts f) {
  const int64_t G = k.G;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (g >= G) return;
  Group<false> s;
  WideMem<LT, NoTrack, kCompact> mem{static_cast<LT*>(p.st.log_term),
                                     static_cast<LT*>(p.st.log_cmd), p.mb, k,
                                     g, 0};
  std::conditional_t<kCompact, Snap, NoSnap> sn;
  load_group<kCompact>(p.st, G, g, s);
  if constexpr (kCompact) load_snap(p.sn, G, g, sn);
  int ov[N], t0[N], b0[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    ov[n] = 0; t0[n] = s.tctr[n]; b0[n] = s.bctr[n];
  }
#pragma unroll 1
  for (int t = 0; t < f.T; ++t)
    staged_tick<kMail>(p, k, f, s, mem, G, g, t, t0, b0, ov, sn);
  store_group<kCompact>(p.st, G, g, s);
  if constexpr (kCompact) store_snap(p.sn, G, g, sn);
#pragma unroll
  for (int n = 0; n < N; ++n) p.overflow[node_at(G, g, n)] = ov[n];
}

// The §12 edge channel alone, over one tick's whole (N*N, G) link lattice:
// what ScenAux's edge gives each pair of a §12 bank's in-kernel launch
// (the drop draw under the bank's threshold row, then the partition
// program's cut mask, its leader program on `lead_m`, the (N, G) live
// leaders at the tick's start), from the key table the fused kernel reads
// at its launch tick. Its plain version is ops/cuda_tick.py::
// part_down_plain (the edge lattice of _kt_aux).
//
// Design: one thread a group, a warp's lanes on consecutive groups
// (coalesced), in blocks of one warp. The group's cut mask is built once
// (scen_cut: its loads issued together, no branch on the kind), and its
// N*N drop draws are ScenAux's (scen_drop_bits) with the block inlined
// (kInline), in an unrolled loop, so that the pairs' independent threefry
// chains overlap in the thread where the fused kernel's out-of-line block
// keeps them one after another.
// Every pair is drawn, cut or not. Offsets are 32-bit: the launcher refuses
// a G at which a row offset passes 2^31 - 1. Blocks of 64-256 threads, two
// groups a thread, 16-byte stores through shared memory and rotates by
// multiplication were each as fast or slower (one H100, farm shape,
// raft_kotlin_tpu_torch/kernel_ab.py --draws).
constexpr int kPartDownThreads = 32;

#if !RAFT_COMPACT && RAFT_MAIL != 1
__global__ void __launch_bounds__(kPartDownThreads) part_down_kernel(
    const int32_t* __restrict__ ktab, const uint8_t* __restrict__ lead_m,
    uint8_t* __restrict__ out, const FusedConsts f, uint32_t G) {
  const uint32_t g = blockIdx.x * kPartDownThreads + threadIdx.x;
  if (g >= G) return;
  const kt::Key base{static_cast<uint32_t>(__ldg(ktab + g)),
                     static_cast<uint32_t>(__ldg(ktab + G + g))};
  const int tick = __ldg(ktab + 2 * G + g);
  const uint32_t gidx = static_cast<uint32_t>(__ldg(ktab + 3 * G + g));
  unsigned lead = 0u;
#pragma unroll
  for (int n = 0; n < N; ++n) lead |= lead_m[n * G + g] ? 1u << n : 0u;
  const kt::CutMask<N> cut = scen_cut(ktab, G, g, f.part_r, tick, lead);
  bool ok[N * N];
#pragma unroll
  for (int q = 0; q < N * N; ++q) ok[q] = true;
  if (drawn(f.drop_r, f.drop_t)) {
    const int thr = scen_thresh(ktab, G, g, f.drop_r, f.drop_t);
    const kt::Key k_edge = kt::event_key<true>(base, KIND_FAULT, tick);
#pragma unroll
    for (int q = 0; q < N * N; ++q)
      ok[q] = scen_drop_bits<true>(k_edge, gidx, q) >= thr;
  }
#pragma unroll
  for (int q = 0; q < N * N; ++q)
    out[q * G + g] = ok[q] && !((cut >> q) & 1u) ? 1 : 0;
}
#endif  // !RAFT_COMPACT && RAFT_MAIL != 1
#endif  // !RAFT_PACKED && !RAFT_OBSERVE

// One launch of the fused kernel or of kernel #7, parsed. ptrs: kPointers
// device pointers in Params order (null where unused). ints: G, C, maj,
// hb_ticks, round_ticks, retry_ticks, cmd_node, flags, log_is_int16,
// threads_per_block, device, T, W, inkernel, cmd_period, el_lo, el_hi,
// bo_lo, bo_hi, drop_t, crash_t, restart_t, lfail_t, lheal_t, delay_lo,
// delay_hi, then the bank's row offsets drop_r, crash_r, restart_r,
// lfail_r, lheal_r, delay_r, part_r (-1 = none), the warmup-down W,
// narrow8 and packed_compute (both read by the packed build only), and the
// §15 watermark (0: no compaction) and chunk. The
// library links its own (static) CUDA runtime, so the device the operands
// and the stream are on is set here.
struct Launch {
  Params p;
  Consts k;
  FusedConsts f;
  bool inkernel, bank, log16, mail;
  unsigned blocks;
  int threads;
};

cudaError_t parse_launch(void* const* ptrs, const long long* ints,
                         Launch& L) {
  const cudaError_t set = cudaSetDevice(static_cast<int>(ints[10]));
  if (set != cudaSuccess) return set;
  void** dst = reinterpret_cast<void**>(&L.p);
  for (int i = 0; i < kPointers; ++i) dst[i] = ptrs[i];
  Consts& k = L.k;
  FusedConsts& f = L.f;
  k.G = ints[0];
  k.C = static_cast<int>(ints[1]);
  k.maj = static_cast<int>(ints[2]);
  k.hb_ticks = static_cast<int>(ints[3]);
  k.round_ticks = static_cast<int>(ints[4]);
  k.retry_ticks = static_cast<int>(ints[5]);
  k.cmd_node = static_cast<int>(ints[6]);
  k.flags = static_cast<int>(ints[7]);
  L.log16 = ints[8] != 0;
  L.threads = static_cast<int>(ints[9]);
  f.T = static_cast<int>(ints[11]);
  f.W = static_cast<int>(ints[12]);
  L.inkernel = ints[13] != 0;
  f.cmd_period = static_cast<int>(ints[14]);
  f.el_lo = static_cast<int>(ints[15]);
  f.el_hi = static_cast<int>(ints[16]);
  f.bo_lo = static_cast<int>(ints[17]);
  f.bo_hi = static_cast<int>(ints[18]);
  f.drop_t = static_cast<int>(ints[19]);
  f.crash_t = static_cast<int>(ints[20]);
  f.restart_t = static_cast<int>(ints[21]);
  f.lfail_t = static_cast<int>(ints[22]);
  f.lheal_t = static_cast<int>(ints[23]);
  k.delay_lo = static_cast<int>(ints[24]);
  k.delay_hi = static_cast<int>(ints[25]);
  int* const rows[7] = {&f.drop_r, &f.crash_r, &f.restart_r, &f.lfail_r,
                        &f.lheal_r, &f.delay_r, &f.part_r};
  L.bank = false;
  for (int i = 0; i < 7; ++i) {
    *rows[i] = static_cast<int>(ints[26 + i]);
    L.bank = L.bank || *rows[i] >= 0;
  }
  f.warmup = static_cast<int>(ints[33]);
  k.narrow8 = static_cast<int>(ints[34]);
  k.compact_w = static_cast<int>(ints[36]);
  k.compact_ch = static_cast<int>(ints[37]);
  f.log16 = L.log16;
  L.mail = (k.flags & FLAG_DELAY) != 0;
  L.blocks = static_cast<unsigned>((k.G + L.threads - 1) / L.threads);
  return cudaSuccess;
}

}  // namespace

extern "C" int raft_fused_nodes() { return N; }
extern "C" int raft_fused_packed() { return RAFT_PACKED; }
extern "C" int raft_fused_observe() { return RAFT_OBSERVE; }
extern "C" int raft_fused_compact() { return RAFT_COMPACT; }
extern "C" int raft_fused_mail() { return RAFT_MAIL; }

#if !RAFT_OBSERVE && !RAFT_COMPACT && RAFT_MAIL != 0
// ptrs: the key table (4 + bank rows, G) int32 and the (N*N, G) int16
// output. ints: G, delay_lo, delay_hi (lo < hi), threads_per_block, device,
// the delay window's bank row (-1: none).
extern "C" int raft_delay_draw_launch(void* const* ptrs, const long long* ints,
                                      void* stream) {
  const cudaError_t set = cudaSetDevice(static_cast<int>(ints[4]));
  if (set != cudaSuccess) return static_cast<int>(set);
  const int64_t G = ints[0];
  const int threads = static_cast<int>(ints[3]);
  const unsigned blocks = static_cast<unsigned>((G + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  delay_draw_kernel<<<blocks, threads, 0, s>>>(
      static_cast<const int32_t*>(ptrs[0]), static_cast<int16_t*>(ptrs[1]), G,
      static_cast<int>(ints[1]), static_cast<int>(ints[2]),
      static_cast<int>(ints[5]));
  return static_cast<int>(cudaGetLastError());
}
#endif  // !RAFT_OBSERVE && !RAFT_COMPACT && RAFT_MAIL != 0

namespace {

// One fused instantiation's launch from a parsed Launch, its dynamic shared
// memory `smem`; cudaErrorInvalidValue where this build does not hold the
// instantiation (RAFT_MAIL).
template <typename LT, bool IN, bool MAIL, bool SCEN, bool PC, bool C>
cudaError_t launch_fused(const Launch& L, size_t smem, cudaStream_t s) {
  if constexpr (!built(MAIL)) {
    return cudaErrorInvalidValue;
  } else {
    auto kern = raft_fused_kernel<LT, IN, MAIL, SCEN, PC, C>;
    // Above 48 KB a block's dynamic shared memory must be opted into.
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    kern<<<L.blocks, L.threads, smem, s>>>(L.p, L.k, L.f);
    return cudaGetLastError();
  }
}

}  // namespace

// ptrs, ints: parse_launch's. The observer build takes the observer
// pointers (obs_rows required) and sizes its shared memory from the
// block's width and the log capacity. A §15 launch needs the RAFT_COMPACT
// build and any other launch the other (cudaErrorInvalidValue).
extern "C" int raft_fused_launch(void* const* ptrs, const long long* ints,
                                 void* stream) {
  Launch L;
  const cudaError_t parsed = parse_launch(ptrs, ints, L);
  if (parsed != cudaSuccess) return static_cast<int>(parsed);
  const Consts& k = L.k;
  const FusedConsts& f = L.f;
  const bool inkernel = L.inkernel, log16 = L.log16, mail = L.mail;
  const int threads = L.threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool scen = inkernel && (L.bank || f.warmup > 0);
#if RAFT_OBSERVE
  if (L.p.obs_rows == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      static_cast<size_t>((threads + 31) / 32) * kObsR * sizeof(long long) +
      static_cast<size_t>(threads) * (O_MASKS + 2 * N * ((k.C + 31) / 32)) *
          sizeof(uint32_t);
#else
  const size_t smem = 0;
#endif
#define RAFT_LAUNCH(LT, IN, MAIL, SCEN, PC, C) \
  e = launch_fused<LT, IN, MAIL, SCEN, PC, C>(L, smem, s)
  cudaError_t e;
  constexpr bool C = RAFT_COMPACT;
  if ((k.compact_w > 0) != C) return static_cast<int>(cudaErrorInvalidValue);
#if RAFT_PACKED
  // No kScen instantiation (ops/cuda_scan refuses a bank with the packed
  // layout; a launch that asks for one fails); the snapshots' log dtype is
  // the runtime f.log16.
  if (scen) return static_cast<int>(cudaErrorInvalidValue);
  const bool pc = ints[35] != 0;
  if (mail) {
    if (inkernel && pc) RAFT_LAUNCH(int32_t, true, true, false, true, C);
    else if (inkernel) RAFT_LAUNCH(int32_t, true, true, false, false, C);
    else if (pc) RAFT_LAUNCH(int32_t, false, true, false, true, C);
    else RAFT_LAUNCH(int32_t, false, true, false, false, C);
  } else {
    if (inkernel && pc) RAFT_LAUNCH(int32_t, true, false, false, true, C);
    else if (inkernel) RAFT_LAUNCH(int32_t, true, false, false, false, C);
    else if (pc) RAFT_LAUNCH(int32_t, false, false, false, true, C);
    else RAFT_LAUNCH(int32_t, false, false, false, false, C);
  }
#else
  if (scen) {
    if (log16 && mail) RAFT_LAUNCH(int16_t, true, true, true, false, C);
    else if (log16) RAFT_LAUNCH(int16_t, true, false, true, false, C);
    else if (mail) RAFT_LAUNCH(int32_t, true, true, true, false, C);
    else RAFT_LAUNCH(int32_t, true, false, true, false, C);
  } else if (mail) {
    if (log16 && inkernel) RAFT_LAUNCH(int16_t, true, true, false, false, C);
    else if (log16) RAFT_LAUNCH(int16_t, false, true, false, false, C);
    else if (inkernel) RAFT_LAUNCH(int32_t, true, true, false, false, C);
    else RAFT_LAUNCH(int32_t, false, true, false, false, C);
  } else {
    if (log16 && inkernel) RAFT_LAUNCH(int16_t, true, false, false, false, C);
    else if (log16) RAFT_LAUNCH(int16_t, false, false, false, false, C);
    else if (inkernel) RAFT_LAUNCH(int32_t, true, false, false, false, C);
    else RAFT_LAUNCH(int32_t, false, false, false, false, C);
  }
#endif
#undef RAFT_LAUNCH
  return static_cast<int>(e);
}

#if !RAFT_PACKED && !RAFT_OBSERVE
namespace {

// Launch (or, with `info`, only describe: raft_tick_info's words) one
// instantiation of kernel #7.
template <typename LT, bool MAIL>
cudaError_t k_launch(const Launch& L, cudaStream_t s, long long* info) {
  if constexpr (!built(MAIL)) {
    return cudaErrorInvalidValue;
  } else {
    auto kern = raft_k_tick_kernel<LT, MAIL, RAFT_COMPACT>;
    if (info) {
      const cudaError_t e = tile::describe(kern, L.threads, 0, info);
      info[0] = 0;
      info[6] = L.blocks;
      info[7] = info[8] = info[9] = 0;
      return e;
    }
    kern<<<L.blocks, L.threads, 0, s>>>(L.p, L.k, L.f);
    return cudaGetLastError();
  }
}

int k_run(void* const* ptrs, const long long* ints, void* stream,
          long long* info) {
  Launch L;
  const cudaError_t parsed = parse_launch(ptrs, ints, L);
  if (parsed != cudaSuccess) return static_cast<int>(parsed);
  // Staged draws only (a §12 bank rides the staged slabs; its rows in the
  // parameter block are not read): the JAX kernel's surface. Its §15 form
  // is the RAFT_COMPACT build's.
  if (L.inkernel || (L.k.compact_w > 0) != RAFT_COMPACT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (L.log16 && L.mail) e = k_launch<int16_t, true>(L, s, info);
  else if (L.log16) e = k_launch<int16_t, false>(L, s, info);
  else if (L.mail) e = k_launch<int32_t, true>(L, s, info);
  else e = k_launch<int32_t, false>(L, s, info);
  return static_cast<int>(e);
}

}  // namespace

// Kernel #7. ptrs, ints: parse_launch's, as the staged fused launch takes
// them (the snapshot and in-kernel pointers unused); T is the launch's K.
// A §15 launch needs the RAFT_COMPACT build and any other launch the
// other.
extern "C" int raft_k_tick_launch(void* const* ptrs, const long long* ints,
                                  void* stream) {
  return k_run(ptrs, ints, stream, nullptr);
}

// The same arguments, nothing launched: raft_tick_info's words
// (tick_kernel.cu) for that launch.
extern "C" int raft_k_tick_info(void* const* ptrs, const long long* ints,
                                long long* out) {
  return k_run(ptrs, ints, nullptr, out);
}

#if !RAFT_COMPACT && RAFT_MAIL != 1
namespace {

// part_down_kernel's launch from raft_part_down_launch's ints, or
// cudaErrorInvalidValue where a row offset would pass 32 bits.
struct PartDownLaunch {
  FusedConsts f;
  uint32_t G;
  unsigned blocks;
};

cudaError_t part_down_parse(const long long* ints, PartDownLaunch& L) {
  const long long G = ints[0];
  L.f = FusedConsts{};
  L.f.drop_t = static_cast<int>(ints[1]);
  L.f.drop_r = static_cast<int>(ints[2]);
  L.f.part_r = static_cast<int>(ints[3]);
  const long long rows = std::max<long long>(
      {static_cast<long long>(N) * N, 4 + L.f.drop_r + 1,
       4 + L.f.part_r + 7});
  if (G < 1 || rows * G > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  L.G = static_cast<uint32_t>(G);
  L.blocks = static_cast<unsigned>((G + kPartDownThreads - 1) /
                                   kPartDownThreads);
  return cudaSuccess;
}

}  // namespace

// ptrs: the key table (4 + bank rows, G) int32, the (N, G) live-leader mask
// (bool as uint8) and the (N*N, G) bool output. ints: G, drop_t, drop_r,
// part_r (the bank's row offsets, -1 = none), threads_per_block (not read:
// the kernel's block is kPartDownThreads), device. Refuses
// (cudaErrorInvalidValue) a G at which the table's or the output's rows
// pass 2^31 - 1 elements.
extern "C" int raft_part_down_launch(void* const* ptrs, const long long* ints,
                                     void* stream) {
  const cudaError_t set = cudaSetDevice(static_cast<int>(ints[5]));
  if (set != cudaSuccess) return static_cast<int>(set);
  PartDownLaunch L;
  const cudaError_t parsed = part_down_parse(ints, L);
  if (parsed != cudaSuccess) return static_cast<int>(parsed);
  part_down_kernel<<<L.blocks, kPartDownThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ptrs[0]),
      static_cast<const uint8_t*>(ptrs[1]), static_cast<uint8_t*>(ptrs[2]),
      L.f, L.G);
  return static_cast<int>(cudaGetLastError());
}

// The same arguments, nothing launched: raft_tick_info's words
// (tick_kernel.cu) for part_down_kernel's launch (row form, no shared
// memory).
extern "C" int raft_part_down_info(void* const* ptrs, const long long* ints,
                                   long long* out) {
  (void)ptrs;
  const cudaError_t set = cudaSetDevice(static_cast<int>(ints[5]));
  if (set != cudaSuccess) return static_cast<int>(set);
  PartDownLaunch L;
  cudaError_t e = part_down_parse(ints, L);
  if (e == cudaSuccess)
    e = tile::describe(part_down_kernel, kPartDownThreads, 0, out);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = 0;
  out[6] = L.blocks;
  out[7] = out[8] = out[9] = 0;
  return cudaSuccess;
}
#endif  // !RAFT_COMPACT && RAFT_MAIL != 1
#endif  // !RAFT_PACKED && !RAFT_OBSERVE
