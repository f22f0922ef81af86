// The Raft tick body (SEMANTICS.md phases F, 0-5) for one group, shared by
// the one-tick kernel (tick_kernel.cu) and the fused-T kernel
// (fused_tick_kernel.cu). Its plain PyTorch version is
// raft_kotlin_tpu_torch/ops/tick.py::phase_body; the two are held bit-equal.
//
// One thread runs one group. The group's node and pair fields live in
// registers (a Group, N a compile-time constant, every node/pair loop
// unrolled); its log rows are read and written in place in device memory by
// direct index — each thread owns its group's column, so there are no
// races. The exchanges run in the canonical (owner, peer) order, as the
// plain version and the scalar oracle do.
//
// Where the tick's randomness comes from is the `Aux` template parameter: a
// type with the methods edge(a, b), crash(n), restart(n), link_fail(a, b),
// link_heal(a, b), el_draw_f(n, t_ctr), bdraw(n, b_ctr), periodic() and
// inject(n), and a constant kLoads. Where kLoads is false (a draw is a
// threefry block evaluated in the kernel), the body calls each only where
// its value is used (a crash draw only for a live node, an edge draw only
// where the link and both ends are up, ...), so the kernel draws only what
// the tick needs. Where kLoads is true (a draw is a load of a staged
// tensor), the per-node and per-pair channels of phase F and the edges
// are read unconditionally and first, so their loads issue together
// instead of each waiting on the branch before it (the one-tick kernel:
// 0.2048 ms with the loads behind their branches, 0.1419 ms with them
// first, one H100 at the headline shape, raft_kotlin_tpu_torch/
// kernel_ab.py). Every draw is a pure function of its key and counter, so
// the bits do not depend on which draws are skipped.
//
// Fields are read and written in their STORAGE dtypes (int16 / bool as
// uint8 / int32) and computed in int32; narrowing a value back to int16
// wraps, as numpy's astype does.
//
// The §10 mailbox (template flag kMail; the host picks it from FLAG_DELAY)
// adds 13 (N*N, G) slot planes. They do not join the Group: every N=5
// instantiation already uses 255 registers. A pair's slot is read and
// written only by its own delivery and then its own send, so each slot is
// read and written in place in device memory at that pair's point in the
// lattice; the countdown pass at the tick's end touches only the two due
// planes. The kMail = false instantiations compile the synchronous lattice
// alone, as before.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#ifndef RAFT_N
#error "build with -DRAFT_N=<nodes per group>"
#endif

namespace raft {

constexpr int N = RAFT_N;
static_assert(N >= 1 && N <= 9, "1 <= n_nodes <= 9");

constexpr int FOLLOWER = 0, CANDIDATE = 1, LEADER = 2;
constexpr int IDLE = 0, BACKOFF = 1, ACTIVE = 2;
constexpr int FLAG_FAULTS = 1, FLAG_LINKS = 2, FLAG_PERIODIC = 4,
              FLAG_INJECT = 8, FLAG_DELAY = 16;

// The state tensors, in ops/tick.py STATE_FIELDS order (the wrappers pass
// pointers in this order).
constexpr int kStateFields = 28;
struct StatePtrs {
  int32_t* term; int16_t* voted_for; int16_t* role; int16_t* commit;
  int16_t* last_index; int16_t* phys_len; void* log_term; void* log_cmd;
  int32_t* last_term; uint8_t* el_armed; int16_t* el_left;
  int16_t* round_state; int16_t* round_left; int16_t* round_age;
  int16_t* votes; int16_t* responses; uint8_t* responded; int16_t* bo_left;
  int16_t* next_index; int16_t* match_index; uint8_t* hb_armed;
  int16_t* hb_left; uint8_t* up; uint8_t* link_up; int32_t* t_ctr;
  int32_t* b_ctr; int32_t* rounds; int16_t* cap_ov;
};
static_assert(sizeof(StatePtrs) == kStateFields * sizeof(void*),
              "StatePtrs must be exactly kStateFields pointers");

// The §10 mailbox slots, in models/state.py MAILBOX_FIELDS order; (N*N, G)
// planes, [owner-1, peer-1] at row (owner-1)*N + peer-1.
constexpr int kMailFields = 13;
struct MailPtrs {
  int16_t* vq_due; int32_t* vq_term; int16_t* vq_lli; int32_t* vq_llt;
  int32_t* vq_round; int16_t* aq_due; int32_t* aq_term; int16_t* aq_pli;
  int32_t* aq_plt; int16_t* aq_hase; int32_t* aq_ent_t; int32_t* aq_ent_c;
  int16_t* aq_commit;
};
static_assert(sizeof(MailPtrs) == kMailFields * sizeof(void*),
              "MailPtrs must be exactly kMailFields pointers");

struct Consts {
  int64_t G;
  int C, maj, hb_ticks, round_ticks, retry_ticks, cmd_node, flags;
  int delay_lo, delay_hi;  // the §10 send-delay window
};

// One group's non-log state, in registers.
struct Group {
  int term[N], vf[N], role[N], commit[N], li[N], pl[N], ltc[N], el_left[N];
  int rs[N], rl[N], ra[N], votes[N], resps[N], bo[N], hbl[N];
  int tctr[N], bctr[N], rounds[N], capov[N];
  bool ela[N], hba[N], up[N], dirty[N];
  bool resp_d[N * N], link[N * N];
  int ni[N * N], mi[N * N];
};

// Floor modulo (numpy's %, torch.remainder); C++ % truncates.
__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return (r != 0 && ((r < 0) != (m < 0))) ? r + m : r;
}

__device__ __forceinline__ int64_t node_at(int64_t G, int64_t g, int n) {
  return static_cast<int64_t>(n) * G + g;
}

__device__ __forceinline__ void load_group(const StatePtrs& p, int64_t G,
                                           int64_t g, Group& s) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int64_t i = node_at(G, g, n);
    s.term[n] = p.term[i];         s.vf[n] = p.voted_for[i];
    s.role[n] = p.role[i];         s.commit[n] = p.commit[i];
    s.li[n] = p.last_index[i];     s.pl[n] = p.phys_len[i];
    s.ltc[n] = p.last_term[i];     s.el_left[n] = p.el_left[i];
    s.rs[n] = p.round_state[i];    s.rl[n] = p.round_left[i];
    s.ra[n] = p.round_age[i];      s.votes[n] = p.votes[i];
    s.resps[n] = p.responses[i];   s.bo[n] = p.bo_left[i];
    s.hbl[n] = p.hb_left[i];       s.tctr[n] = p.t_ctr[i];
    s.bctr[n] = p.b_ctr[i];        s.rounds[n] = p.rounds[i];
    s.capov[n] = p.cap_ov[i];
    s.ela[n] = p.el_armed[i] != 0; s.hba[n] = p.hb_armed[i] != 0;
    s.up[n] = p.up[i] != 0;        s.dirty[n] = false;
  }
#pragma unroll
  for (int k = 0; k < N * N; ++k) {
    const int64_t i = node_at(G, g, k);
    s.resp_d[k] = p.responded[i] != 0;
    s.link[k] = p.link_up[i] != 0;
    s.ni[k] = p.next_index[i];
    s.mi[k] = p.match_index[i];
  }
}

__device__ __forceinline__ void store_group(const StatePtrs& p, int64_t G,
                                            int64_t g, const Group& s) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int64_t i = node_at(G, g, n);
    p.term[i] = s.term[n];
    p.voted_for[i] = static_cast<int16_t>(s.vf[n]);
    p.role[i] = static_cast<int16_t>(s.role[n]);
    p.commit[i] = static_cast<int16_t>(s.commit[n]);
    p.last_index[i] = static_cast<int16_t>(s.li[n]);
    p.phys_len[i] = static_cast<int16_t>(s.pl[n]);
    p.last_term[i] = s.ltc[n];
    p.el_armed[i] = s.ela[n];
    p.el_left[i] = static_cast<int16_t>(s.el_left[n]);
    p.round_state[i] = static_cast<int16_t>(s.rs[n]);
    p.round_left[i] = static_cast<int16_t>(s.rl[n]);
    p.round_age[i] = static_cast<int16_t>(s.ra[n]);
    p.votes[i] = static_cast<int16_t>(s.votes[n]);
    p.responses[i] = static_cast<int16_t>(s.resps[n]);
    p.bo_left[i] = static_cast<int16_t>(s.bo[n]);
    p.hb_armed[i] = s.hba[n];
    p.hb_left[i] = static_cast<int16_t>(s.hbl[n]);
    p.up[i] = s.up[n];
    p.t_ctr[i] = s.tctr[n];
    p.b_ctr[i] = s.bctr[n];
    p.rounds[i] = s.rounds[n];
    p.cap_ov[i] = static_cast<int16_t>(s.capov[n]);
  }
#pragma unroll
  for (int k = 0; k < N * N; ++k) {
    const int64_t i = node_at(G, g, k);
    p.responded[i] = s.resp_d[k];
    p.link_up[i] = s.link[k];
    p.next_index[i] = static_cast<int16_t>(s.ni[k]);
    p.match_index[i] = static_cast<int16_t>(s.mi[k]);
  }
}

// What the observers read of the §10 slots at a tick's end: the slots in
// flight, and the bitmask of nodes that own an append slot in flight (the
// monitor's stale-append hazard, for a deposed leader's late appends).
struct Inflight {
  int count, aq_owners;
};

// One tick of the phase lattice on group g (state in `s`, logs lt/lc and,
// under kMail, the mailbox slots `m` in place). Marks s.dirty for nodes
// whose election timer reset in phases 2-5: the caller materializes their
// el_left (§7). Returns the §10 slots in flight at the tick's end (zeros
// without the mailbox).
template <typename LT, bool kMail = false, typename Aux>
__device__ __forceinline__ Inflight tick_body(Group& s, LT* const lt,
                                              LT* const lc, const Consts& k,
                                              int64_t g, Aux& aux,
                                              const MailPtrs& m) {
  const int64_t G = k.G;
  const int C = k.C;
#define LOG(n, slot) ((static_cast<int64_t>(n) * C + (slot)) * G + g)
#define PAIR(q) (static_cast<int64_t>(q) * G + g)
#pragma unroll
  for (int n = 0; n < N; ++n) s.dirty[n] = false;

  // §7: a reset consumes one counted draw; el_left is drawn afterwards.
  auto reset_timer = [&](int n, bool m) {
    if (m) { s.tctr[n] += 1; s.ela[n] = true; s.dirty[n] = true; }
  };
  // Physical slot idx of node n's log; 0 outside [0, C).
  auto log_term_at = [&](int n, int idx) -> int {
    return (idx >= 0 && idx < C) ? static_cast<int>(lt[LOG(n, idx)]) : 0;
  };
  auto log_cmd_at = [&](int n, int idx) -> int {
    return (idx >= 0 && idx < C) ? static_cast<int>(lc[LOG(n, idx)]) : 0;
  };
  // SEMANTICS.md §3 add(): append at the PHYSICAL end (slot phys_len — the
  // ghost-append quirk) when i == last_index and there is room; overwrite +
  // truncate when 0 <= i < last_index; a rejected append latches cap_ov.
  auto log_add = [&](int n, int i, int tv, int cv, bool mask) {
    if (!mask) return;
    if (i == s.li[n]) {
      if (s.pl[n] >= C) { s.capov[n] |= 1; return; }
      lt[LOG(n, s.pl[n])] = static_cast<LT>(tv);
      lc[LOG(n, s.pl[n])] = static_cast<LT>(cv);
      s.pl[n] += 1;
      s.li[n] = i + 1;
    } else if (i < s.li[n] && i >= 0) {
      lt[LOG(n, i)] = static_cast<LT>(tv);
      lc[LOG(n, i)] = static_cast<LT>(cv);
      s.li[n] = i + 1;
    }
  };

  // -- phase F: fault events (§9) --------------------------------------
  if (k.flags & FLAG_FAULTS) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const bool crash = Aux::kLoads ? aux.crash(n) && s.up[n]
                                     : s.up[n] && aux.crash(n);
      const bool rst = Aux::kLoads ? aux.restart(n) && !s.up[n]
                                   : !s.up[n] && aux.restart(n);
      s.up[n] = (s.up[n] && !crash) || rst;
      if (rst) {
        s.term[n] = 0; s.vf[n] = -1; s.role[n] = FOLLOWER; s.commit[n] = 0;
        s.li[n] = 0; s.pl[n] = 0; s.rs[n] = IDLE; s.votes[n] = 0;
        s.resps[n] = 0; s.rl[n] = 0; s.ra[n] = 0; s.bo[n] = 0; s.ltc[n] = 0;
        s.hbl[n] = 0;
#pragma unroll
        for (int b = 0; b < N; ++b) {
          s.resp_d[n * N + b] = false; s.ni[n * N + b] = 0;
          s.mi[n * N + b] = 0;
        }
        s.hba[n] = false;
        if constexpr (kMail) {
          // §10: the slots the node OWNS die with it (a crash clears none).
#pragma unroll
          for (int b = 0; b < N; ++b) {
            m.vq_due[PAIR(n * N + b)] = -1;
            m.aq_due[PAIR(n * N + b)] = -1;
          }
        }
        // Immediate reset: el_draw_f is the draw at the pre-tick t_ctr.
        s.el_left[n] = aux.el_draw_f(n, s.tctr[n]);
        s.ela[n] = true;
        s.tctr[n] += 1;
      }
    }
  }
  if (k.flags & FLAG_LINKS) {
#pragma unroll
    for (int a = 0; a < N; ++a) {
#pragma unroll
      for (int b = 0; b < N; ++b) {
        const int q = a * N + b;
        if constexpr (Aux::kLoads) {
          const bool fail = aux.link_fail(a, b), heal = aux.link_heal(a, b);
          s.link[q] = s.link[q] ? !fail : heal;
        } else {
          s.link[q] = s.link[q] ? !aux.link_fail(a, b) : aux.link_heal(a, b);
        }
      }
    }
  }
  // Effective edge health: link health ∧ both ends up ∧ iid survival.
  bool eok[N * N];
#pragma unroll
  for (int a = 0; a < N; ++a) {
#pragma unroll
    for (int b = 0; b < N; ++b) {
      const bool live = s.link[a * N + b] && s.up[a] && s.up[b];
      if constexpr (Aux::kLoads)
        eok[a * N + b] = aux.edge(a, b) && live;
      else
        eok[a * N + b] = live && aux.edge(a, b);
    }
  }

  // -- phase 0: command injection (quirk k) ----------------------------
  if (k.flags & FLAG_PERIODIC) {
    const int n = k.cmd_node - 1;
    const int cmd = aux.periodic();
#pragma unroll
    for (int m = 0; m < N; ++m)  // keep node arrays in registers
      if (m == n) log_add(m, s.li[m], s.term[m], cmd, cmd >= 0 && s.up[m]);
  }
  if (k.flags & FLAG_INJECT) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int cmd = aux.inject(n);
      log_add(n, s.li[n], s.term[n], cmd, cmd >= 0 && s.up[n]);
    }
  }
  // lastLogTerm cache refresh for nodes phase 0 may have appended to.
  if (k.flags & (FLAG_PERIODIC | FLAG_INJECT)) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      if ((k.flags & FLAG_INJECT) || n == k.cmd_node - 1)
        s.ltc[n] = log_term_at(n, s.li[n] - 1);  // slot -1 reads as 0
    }
  }

  // -- phase 1: timers (independent countdowns) ------------------------
  bool start_round[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const bool armed = s.ela[n] && s.up[n];
    if (armed) s.el_left[n] -= 1;
    const bool fire = armed && s.el_left[n] <= 0;
    if (fire) { s.ela[n] = false; s.role[n] = CANDIDATE; }
    const bool in_bo = s.rs[n] == BACKOFF && s.up[n];
    if (in_bo) s.bo[n] -= 1;
    const bool bfire = in_bo && s.bo[n] <= 0;
    if (bfire) s.rs[n] = IDLE;
    start_round[n] = fire || bfire;
  }

  // -- phase 2: round starts -------------------------------------------
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if (!start_round[n]) continue;
    if (s.role[n] == CANDIDATE) {
      s.term[n] += 1; s.vf[n] = n + 1; s.votes[n] = 0; s.resps[n] = 0;
#pragma unroll
      for (int b = 0; b < N; ++b) s.resp_d[n * N + b] = false;
      s.rl[n] = k.round_ticks; s.ra[n] = 0; s.rs[n] = ACTIVE;
      s.rounds[n] += 1;
    } else {  // demoted while backing off
      s.rs[n] = IDLE;
      reset_timer(n, true);
    }
  }

  // -- phase 3: vote exchanges, canonical (candidate, peer) order ------
  // Last-log position/term are phase-3 invariants (no vote touches a log).
  int lli[N], llt[N];
#pragma unroll
  for (int n = 0; n < N; ++n) { lli[n] = s.li[n]; llt[n] = s.ltc[n]; }
  // §10: this tick's send delay of pair (a, b) (a constant when lo == hi).
  auto delay_for = [&](int a, int b) -> int {
    return k.delay_lo == k.delay_hi ? k.delay_lo : aux.delay(a, b);
  };
  if constexpr (kMail) {
    // The vote exchange of a delivered slot (c, q): the §6.1 handler on q,
    // and c's tally only while the round that sent it is still ACTIVE (the
    // rounds stamp — straggler cancellation, RaftServer.kt:214-215). The
    // response leg is taken now; its failure voids the whole exchange.
    auto vote_deliver = [&](int c, int q) {
      const int kk = c * N + q;
      if (m.vq_due[PAIR(kk)] != 0) return;
      m.vq_due[PAIR(kk)] = -1;
      if (!eok[q * N + c]) return;
      const int req_term = m.vq_term[PAIR(kk)];
      const int req_lli = m.vq_lli[PAIR(kk)];
      const int req_llt = m.vq_llt[PAIR(kk)];
      const bool guard = s.rs[c] == ACTIVE && m.vq_round[PAIR(kk)] == s.rounds[c];
      const bool rej_stale = lli[q] >= 1 && req_llt < llt[q];
      const bool rej_short = lli[q] >= 1 && req_llt == llt[q] &&
                             req_lli < lli[q];
      const bool grant_gt = req_term > s.term[q] && !(rej_stale || rej_short);
      const bool granted =
          (req_term == s.term[q] && s.vf[q] == c + 1) || grant_gt;
      if (grant_gt) {
        s.term[q] = req_term; s.vf[q] = c + 1; s.role[q] = FOLLOWER;
        reset_timer(q, true);
      }
      if (!guard) return;
      s.resp_d[kk] = true;
      s.resps[c] += 1;
      if (s.term[q] > s.term[c]) s.role[c] = FOLLOWER;  // quirk f, live term
      if (granted) s.votes[c] += 1;
    };
#pragma unroll
    for (int c = 0; c < N; ++c) {
      const bool attempting =
          s.rs[c] == ACTIVE && floor_mod(s.ra[c], k.retry_ticks) == 0;
#pragma unroll
      for (int q = 0; q < N; ++q) {
        const int kk = c * N + q;
        vote_deliver(c, q);  // the slot an earlier tick filled
        // The request leg at the send; responded may have just been set by
        // this pair's delivery.
        if (!(attempting && eok[kk] && !s.resp_d[kk])) continue;
        const int d = delay_for(c, q);
        m.vq_term[PAIR(kk)] = s.term[c];
        m.vq_lli[PAIR(kk)] = static_cast<int16_t>(lli[c]);
        m.vq_llt[PAIR(kk)] = llt[c];
        m.vq_round[PAIR(kk)] = s.rounds[c];
        m.vq_due[PAIR(kk)] = static_cast<int16_t>(d);
        if (d == 0) vote_deliver(c, q);  // τ=0: the fresh slot, same pair
      }
    }
  } else {
#pragma unroll
  for (int c = 0; c < N; ++c) {
    if (!(s.rs[c] == ACTIVE && floor_mod(s.ra[c], k.retry_ticks) == 0))
      continue;
#pragma unroll
    for (int q = 0; q < N; ++q) {
      if (s.resp_d[c * N + q] || !(eok[c * N + q] && eok[q * N + c]))
        continue;
      const int req_term = s.term[c];
      const bool rej_stale = lli[q] >= 1 && llt[c] < llt[q];
      const bool rej_short = lli[q] >= 1 && llt[c] == llt[q] &&
                             lli[c] < lli[q];
      const bool grant_gt = req_term > s.term[q] && !(rej_stale || rej_short);
      const bool granted =
          (req_term == s.term[q] && s.vf[q] == c + 1) || grant_gt;
      if (grant_gt) {
        s.term[q] = req_term; s.vf[q] = c + 1; s.role[q] = FOLLOWER;
        reset_timer(q, true);
      }
      s.resp_d[c * N + q] = true;
      s.resps[c] += 1;
      if (s.term[q] > s.term[c]) s.role[c] = FOLLOWER;  // quirk f, live term
      if (granted) s.votes[c] += 1;
    }
  }
  }

  // -- phase 4: round conclusions --------------------------------------
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if (!(s.rs[n] == ACTIVE && s.up[n])) continue;
    if (s.resps[n] >= k.maj || s.rl[n] <= 0) {
      if (s.role[n] == CANDIDATE && s.votes[n] >= k.maj) {
        s.role[n] = LEADER;
#pragma unroll
        for (int b = 0; b < N; ++b) {  // quirk b
          s.ni[n * N + b] = s.commit[n] + 1; s.mi[n * N + b] = 0;
        }
        s.hba[n] = true; s.hbl[n] = 0; s.rs[n] = IDLE;
      } else if (s.role[n] == CANDIDATE) {
        // Backoff draw at the pre-tick b_ctr (b_ctr moves only here).
        s.rs[n] = BACKOFF; s.bo[n] = aux.bdraw(n, s.bctr[n]);
        s.bctr[n] += 1;
      } else {
        s.rs[n] = IDLE;
        reset_timer(n, true);
      }
    } else {
      s.rl[n] -= 1; s.ra[n] += 1;
    }
  }

  // -- phase 5: append / heartbeat, canonical (leader, peer) order -----
  if constexpr (kMail) {
    // The append exchange of a delivered slot (l, q): the §6.2 handler on q
    // and l's response processing on l's LIVE state (appends are never
    // cancelled). The response leg is taken now; its failure voids it.
    auto append_deliver = [&](int l, int q) {
      const int kk = l * N + q;
      if (m.aq_due[PAIR(kk)] != 0) return;
      m.aq_due[PAIR(kk)] = -1;
      if (!eok[q * N + l]) return;
      const int req_term = m.aq_term[PAIR(kk)];
      const int req_commit = m.aq_commit[PAIR(kk)];
      const int pli = m.aq_pli[PAIR(kk)];
      const int plt = m.aq_plt[PAIR(kk)];
      const bool has_entry = m.aq_hase[PAIR(kk)] != 0;
      if (q != l) {
        if (req_term > s.term[q]) {
          s.term[q] = req_term; s.vf[q] = -1; reset_timer(q, true);
        }
        s.role[q] = FOLLOWER;  // quirk d: any foreign append demotes
        reset_timer(q, true);
      }
      if (req_commit > s.commit[q])
        s.commit[q] = min(req_commit, s.li[q]);  // quirk e
      const bool succ =
          pli == -1 ||
          (s.li[q] > pli && pli >= 0 && log_term_at(q, pli) == plt);
      if (has_entry && succ)
        log_add(q, pli + 1, m.aq_ent_t[PAIR(kk)], m.aq_ent_c[PAIR(kk)], true);
      // Leader processes the response (RaftServer.kt:146-168).
      if (q != l && s.term[q] > s.term[l]) {
        s.term[l] = s.term[q]; s.role[l] = FOLLOWER; reset_timer(l, true);
        return;
      }
      if (succ) {
        if (has_entry) {
          s.ni[kk] += 1; s.mi[kk] += 1;
          int cnt = 0;  // quirk a: #{m : match[m] > commit} >= maj
#pragma unroll
          for (int r = 0; r < N; ++r) cnt += s.mi[l * N + r] > s.commit[l];
          if (cnt >= k.maj) s.commit[l] += 1;
        } else {
          s.mi[kk] = pli + 1;  // quirk h
        }
      } else {
        s.ni[kk] -= 1;  // quirk i
      }
    };
#pragma unroll
    for (int l = 0; l < N; ++l) {
      // Heartbeat timer: which of l's pairs send this tick is fixed here,
      // before l's deliveries (which may demote l).
      const bool armed = s.hba[l] && s.up[l];
      const bool fire = armed && s.hbl[l] <= 0;
      if (armed && !fire) s.hbl[l] -= 1;
      if (fire) {
        if (s.role[l] == FOLLOWER) s.hba[l] = false;  // this round still goes
        else s.hbl[l] = k.hb_ticks - 1;
      }
#pragma unroll
      for (int q = 0; q < N; ++q) {
        const int kk = l * N + q;
        append_deliver(l, q);  // the slot an earlier tick filled
        if (!fire) continue;
        // The request, from l's live state at the send.
        const int i = s.ni[kk];
        const int pli = i - 2;
        if (pli >= 0 && pli >= s.li[l]) continue;  // invalid prevLog -> skip
        const bool has_entry = s.li[l] >= i;
        if (has_entry && i <= 0) continue;         // quirk i underflow
        if (!eok[kk]) continue;                    // the request leg
        // The slot snapshots the PHYSICAL row i - 1, entry or not.
        const int d = delay_for(l, q);
        m.aq_term[PAIR(kk)] = s.term[l];
        m.aq_commit[PAIR(kk)] = static_cast<int16_t>(s.commit[l]);
        m.aq_pli[PAIR(kk)] = static_cast<int16_t>(pli);
        m.aq_plt[PAIR(kk)] = pli >= 0 ? log_term_at(l, pli) : -1;
        m.aq_hase[PAIR(kk)] = has_entry;
        m.aq_ent_t[PAIR(kk)] = log_term_at(l, i - 1);
        m.aq_ent_c[PAIR(kk)] = log_cmd_at(l, i - 1);
        m.aq_due[PAIR(kk)] = static_cast<int16_t>(d);
        if (d == 0) append_deliver(l, q);  // τ=0: the fresh slot, same pair
      }
    }
  } else {
#pragma unroll
  for (int l = 0; l < N; ++l) {
    if (!(s.hba[l] && s.up[l])) continue;
    if (s.hbl[l] > 0) { s.hbl[l] -= 1; continue; }
    // FOLLOWER cancels future firings, but this round still goes out.
    if (s.role[l] == FOLLOWER) s.hba[l] = false;
    else s.hbl[l] = k.hb_ticks - 1;
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const int kk = l * N + q;
      const int i = s.ni[kk];
      const int pli = i - 2;
      if (pli >= 0 && pli >= s.li[l]) continue;  // invalid prevLog -> skip
      const int plt = pli >= 0 ? log_term_at(l, pli) : -1;
      const bool has_entry = s.li[l] >= i;
      if (has_entry && i <= 0) continue;         // quirk i underflow
      if (!(eok[kk] && eok[q * N + l])) continue;
      const int ent_t = log_term_at(l, i - 1);
      const int ent_c = log_cmd_at(l, i - 1);
      const int req_term = s.term[l];
      const int req_commit = s.commit[l];
      // §6.2 handler on q.
      if (q != l) {
        if (req_term > s.term[q]) {
          s.term[q] = req_term; s.vf[q] = -1; reset_timer(q, true);
        }
        s.role[q] = FOLLOWER;  // quirk d: any foreign append demotes
        reset_timer(q, true);
      }
      if (req_commit > s.commit[q])
        s.commit[q] = min(req_commit, s.li[q]);  // quirk e
      const int p_plt = log_term_at(q, pli);
      const bool succ =
          pli == -1 || (s.li[q] > pli && pli >= 0 && p_plt == plt);
      log_add(q, pli + 1, ent_t, ent_c, has_entry && succ);
      // Leader processes the response (RaftServer.kt:146-168).
      if (q != l && s.term[q] > s.term[l]) {
        s.term[l] = s.term[q]; s.role[l] = FOLLOWER; reset_timer(l, true);
        continue;
      }
      if (succ) {
        if (has_entry) {
          s.ni[kk] += 1; s.mi[kk] += 1;
          int cnt = 0;  // quirk a: #{m : match[m] > commit} >= maj
#pragma unroll
          for (int m = 0; m < N; ++m) cnt += s.mi[l * N + m] > s.commit[l];
          if (cnt >= k.maj) s.commit[l] += 1;
        } else {
          s.mi[kk] = pli + 1;  // quirk h
        }
      } else {
        s.ni[kk] -= 1;  // quirk i
      }
    }
  }
  }

  // lastLogTerm cache from the FINAL log (a log read, not accumulated).
#pragma unroll
  for (int n = 0; n < N; ++n) s.ltc[n] = log_term_at(n, s.li[n] - 1);
  Inflight inflight{0, 0};
  if constexpr (kMail) {
    // §10 tick end: the in-flight countdowns advance once (a send at t with
    // delay d is due, 0, at tick t + d's delivery).
#pragma unroll
    for (int q = 0; q < N * N; ++q) {
      int16_t* const due[2] = {m.vq_due + PAIR(q), m.aq_due + PAIR(q)};
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const int d = *due[w];
        if (d > 0) *due[w] = static_cast<int16_t>(d - 1);
        inflight.count += d >= 0;
        if (w == 1 && d >= 0) inflight.aq_owners |= 1 << (q / N);
      }
    }
  }
  return inflight;
#undef PAIR
#undef LOG
}

}  // namespace raft
