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
//   the key table: per-group thresholds and delay windows read at the point
//   of use, the partition program cut into every edge (kt::part_down, its
//   leader program on the live leaders taken at each tick's start, before
//   phase F), and the warmup-down schedule on crash / restart;
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
// Plain C interface (bound with ctypes): raft_fused_launch() fills the
// parameter block from a pointer array and an integer array, launches on
// the caller's stream without synchronising, and returns cudaGetLastError().

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "kt_rng.cuh"
#include "tick_body.cuh"

namespace {

using namespace raft;

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
  StatePtrs st;
  MailPtrs mb;  // null without the mailbox
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
};
constexpr int kPointers = 2 * kStateFields + kMailFields + 14;
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

// Tick `tick` drawn in the kernel through a §12 scenario bank: the
// InkernelAux channels with each threshold and the delay window taken from
// the group's key-table row where the bank has one (read at the point of
// use: per group, coalesced, and not worth a register each), the partition
// program cut into every edge, and the warmup-down schedule on crash and
// restart (utils/rng.apply_warmup_faults). The draws keep the global group
// index gidx; the universe id keyed only the bank, sampled on the host.
struct ScenAux : InkernelAux {
  const int32_t* ktab;
  int64_t G, g;
  int cmd;        // cmd_node - 1
  unsigned lead;  // bit n: node n was a live leader at the tick's start
  __device__ __forceinline__ int row(int r) const {
    return __ldg(ktab + (4 + r) * G + g);
  }
  __device__ __forceinline__ int thresh(int r, int scalar) const {
    return r >= 0 ? row(r) : scalar;
  }
  __device__ __forceinline__ bool held(int n) const {  // warmup: t < W
    return f.warmup > 0 && n != cmd && tick < f.warmup;
  }
  __device__ __forceinline__ bool edge(int a, int b) const {
    if (drawn(f.drop_r, f.drop_t) &&
        kt::bits23(k_edge, pair_idx(a, b)) < thresh(f.drop_r, f.drop_t))
      return false;
    if (f.part_r < 0) return true;
    const int kind = row(f.part_r);
    if (kind == 0) return true;
    const bool active = floor_mod(tick + row(f.part_r + 6),
                                  row(f.part_r + 4)) < row(f.part_r + 5);
    return !kt::part_down(kind, row(f.part_r + 1), row(f.part_r + 2),
                          row(f.part_r + 3), active, a + 1, b + 1,
                          (lead >> a) & 1u, (lead >> b) & 1u);
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
  __device__ __forceinline__ int delay(int a, int b) const {
    return f.delay_r < 0
               ? kt::delay_draw(k_delay, pair_idx(a, b), delay_lo, delay_hi)
               : kt::delay_draw(k_delay, pair_idx(a, b), row(f.delay_r),
                                row(f.delay_r + 1));
  }
};

// Tick t's snapshot rows of every field with an output.
template <typename LT, bool kMail>
__device__ __forceinline__ void snapshot(const Params& p, const Group& s,
                                         const LT* lt, const LT* lc,
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
  SNAP_ROWS(F_VOTES, N, s.votes[r])
  SNAP_ROWS(F_RESPONSES, N, s.resps[r])
  SNAP_ROWS(F_RESPONDED, N * N, s.resp_d[r])
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
  const LT* const src[2] = {lt, lc};
  const int fid[2] = {F_LOG_TERM, F_LOG_CMD};
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    if (!p.snap[fid[w]]) continue;
    LT* d = static_cast<LT*>(p.snap[fid[w]]) + t * rows * G + g;
#pragma unroll 4
    for (int64_t r = 0; r < rows; ++r) d[r * G] = src[w][r * G + g];
  }
}

template <typename LT, bool kInkernel, bool kMail, bool kScen>
__global__ void __launch_bounds__(128) raft_fused_kernel(
    const Params p, const Consts k, const FusedConsts f) {
  const int64_t G = k.G;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (g >= G) return;
  LT* const lt = static_cast<LT*>(p.st.log_term);
  LT* const lc = static_cast<LT*>(p.st.log_cmd);
  Group s;
  load_group(p.st, G, g, s);
  int ov[N], t0[N], b0[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    ov[n] = 0; t0[n] = s.tctr[n]; b0[n] = s.bctr[n];
  }
  kt::Key base{0u, 0u}, tk[N], bk[N];
  int tick0 = 0;
  uint32_t gidx = 0;
  if constexpr (kInkernel) {
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

#pragma unroll 1
  for (int t = 0; t < f.T; ++t) {
    Inflight inflight;
    if constexpr (kInkernel) {
      const int tick = tick0 + t;
      const kt::Key none{0u, 0u};
      if constexpr (kScen) {
        // The leader program's mask, from the registers before phase F
        // changes them, held for the whole tick.
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
             k.delay_lo, k.delay_hi},
            p.ktab, G, g, k.cmd_node - 1, lead};
        inflight = tick_body<LT, kMail>(s, lt, lc, k, g, aux, p.mb);
      } else {
        InkernelAux aux{
            f,
            f.drop_t > 0 ? kt::event_key(base, KIND_FAULT, tick) : none,
            f.crash_t > 0 ? kt::event_key(base, KIND_CRASH, tick) : none,
            f.restart_t > 0 ? kt::event_key(base, KIND_RESTART, tick) : none,
            f.lfail_t > 0 ? kt::event_key(base, KIND_LINK_FAIL, tick) : none,
            f.lheal_t > 0 ? kt::event_key(base, KIND_LINK_HEAL, tick) : none,
            tk, bk, gidx, tick,
            kMail && k.delay_lo < k.delay_hi ? kt::delay_key(base, tick)
                                             : kt::DelayKey{none, none},
            k.delay_lo, k.delay_hi};
        inflight = tick_body<LT, kMail>(s, lt, lc, k, g, aux, p.mb);
      }
#pragma unroll
      for (int n = 0; n < N; ++n) {  // §7: the draw at t_ctr - 1
        if (s.dirty[n])
          s.el_left[n] = kt::draw_uniform(tk[n], s.tctr[n] - 1, f.el_lo,
                                          f.el_hi);
      }
    } else {
      // Every table select is counted, used or not, as the plain version
      // counts them: the restart draw at t_ctr, the backoff draw at b_ctr.
#pragma unroll
      for (int n = 0; n < N; ++n) {
        if (k.flags & FLAG_FAULTS) ov[n] += s.tctr[n] - t0[n] >= f.W;
        ov[n] += s.bctr[n] - b0[n] >= f.T;
      }
      StagedAux aux{p, f, G, g, t, t0, b0};
      inflight = tick_body<LT, kMail>(s, lt, lc, k, g, aux, p.mb);
#pragma unroll
      for (int n = 0; n < N; ++n) {  // §7: the draw at t_ctr - 1
        const int d = s.tctr[n] - 1 - t0[n];
        ov[n] += d >= f.W;
        if (s.dirty[n]) s.el_left[n] = aux.sel(p.el_table, f.W, n, d);
      }
    }
    snapshot<LT, kMail>(p, s, lt, lc, G, g, k.C, t, inflight);
  }
  store_group(p.st, G, g, s);
#pragma unroll
  for (int n = 0; n < N; ++n) p.overflow[node_at(G, g, n)] = ov[n];
}

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

}  // namespace

extern "C" int raft_fused_nodes() { return N; }

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

// ptrs: kPointers device pointers in Params order (null where unused).
// ints: G, C, maj, hb_ticks, round_ticks, retry_ticks, cmd_node, flags,
// log_is_int16, threads_per_block, device, T, W, inkernel, cmd_period,
// el_lo, el_hi, bo_lo, bo_hi, drop_t, crash_t, restart_t, lfail_t,
// lheal_t, delay_lo, delay_hi, then the bank's row offsets drop_r,
// crash_r, restart_r, lfail_r, lheal_r, delay_r, part_r (-1 = none) and the
// warmup-down W. The library links its own (static) CUDA runtime, so the
// device the operands and the stream are on is set here.
extern "C" int raft_fused_launch(void* const* ptrs, const long long* ints,
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
  const bool log16 = ints[8] != 0;
  const int threads = static_cast<int>(ints[9]);
  FusedConsts f;
  f.T = static_cast<int>(ints[11]);
  f.W = static_cast<int>(ints[12]);
  const bool inkernel = ints[13] != 0;
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
  bool bank = false;
  for (int i = 0; i < 7; ++i) {
    *rows[i] = static_cast<int>(ints[26 + i]);
    bank = bank || *rows[i] >= 0;
  }
  f.warmup = static_cast<int>(ints[33]);
  const bool scen = inkernel && (bank || f.warmup > 0);
  const bool mail = (k.flags & FLAG_DELAY) != 0;
  const unsigned blocks = static_cast<unsigned>((k.G + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RAFT_LAUNCH(LT, IN, MAIL, SCEN) \
  raft_fused_kernel<LT, IN, MAIL, SCEN><<<blocks, threads, 0, s>>>(p, k, f)
  if (scen) {
    if (log16 && mail) RAFT_LAUNCH(int16_t, true, true, true);
    else if (log16) RAFT_LAUNCH(int16_t, true, false, true);
    else if (mail) RAFT_LAUNCH(int32_t, true, true, true);
    else RAFT_LAUNCH(int32_t, true, false, true);
  } else if (mail) {
    if (log16 && inkernel) RAFT_LAUNCH(int16_t, true, true, false);
    else if (log16) RAFT_LAUNCH(int16_t, false, true, false);
    else if (inkernel) RAFT_LAUNCH(int32_t, true, true, false);
    else RAFT_LAUNCH(int32_t, false, true, false);
  } else {
    if (log16 && inkernel) RAFT_LAUNCH(int16_t, true, false, false);
    else if (log16) RAFT_LAUNCH(int16_t, false, false, false);
    else if (inkernel) RAFT_LAUNCH(int32_t, true, false, false);
    else RAFT_LAUNCH(int32_t, false, false, false);
  }
#undef RAFT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
