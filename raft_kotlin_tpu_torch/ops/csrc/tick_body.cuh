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
//
// Where the state rests is the `Mem` template parameter. WideMem<LT> reads
// and writes RaftState's storage dtypes (both logs of type LT). PackedMem
// reads and writes the §14 packed layout (models/state.py PackedRaftState):
// role / round_state / the three flag planes as three u32 ctrl words, the
// responded / link / aq_hase planes as u8 N-bit peer masks, int8 or int16
// narrow fields (the width of each config-gated field group is a bit of
// Consts::narrow8: one uniform branch at each narrow load and store, not an
// instantiation per combination), int16 terms and counters, an int8
// log_term and an int16 log_cmd. The Group in registers holds the wide
// values either way: load_group widens, store_group narrows, and every
// narrowed value is compared with its range (the 2-bit ctrl lanes too) —
// a miss sets the group's `ov` byte, the width-overflow latch the runner
// reads once at its end. A log slot or a §10 slot is narrowed and checked
// where it is written, since it lives in device memory. So the latch takes
// every such write that misses its range, even one overwritten in range
// later in the launch, where the JAX package's packed scan (and the plain
// version) latch only the values left at the launch's end: the kernel's
// latch holds theirs, and its extra groups are those that read a wrapped
// value back, whose state may differ from the wide run's. The runners
// (ops/cuda_scan.make_cuda_scan, ops/tick.make_run) take a set latch as
// the trigger to rerun the call wide from its entry state under the JAX
// rule, so what they return is the JAX package's result.
//
// §18 packed compute (kernel #4, template flag kPC; the JAX package's
// _enter/_exit_packed_lattice inside its tick kernels): the Group holds the
// round's vote-exchange set as two words a node, rb (responded: bit q of
// node c = pair (c, q) exchanged) and vb (the granted subset), in place of
// the responded plane and the votes / responses tallies. On load vb is the
// lowest `votes` bits of rb (models/state.synth_vote_bits); an exchange ORs
// bit q into the words, a restart or round start clears them, the phase-4
// quorum compares are __popc, and the store writes the popcounts back as
// the tallies.

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

// The §14 packed layout, in models/state.py PACKED_FIELDS order (the
// wrappers pass pointers in this order). `void*` fields are int8 or int16
// by their Consts::narrow8 bit; peer masks are u8 (N <= 8).
using PeerMask = uint8_t;
constexpr int kPackedFields = 25;
struct PackedPtrs {
  uint32_t* ctrl; int16_t* term; int16_t* last_term; int8_t* voted_for;
  void* commit; void* last_index; void* phys_len; int8_t* log_term;
  int16_t* log_cmd; void* el_left; void* round_left; void* round_age;
  int8_t* votes; int8_t* responses; PeerMask* responded_bits; void* bo_left;
  void* next_index; void* match_index; void* hb_left; PeerMask* link_bits;
  int16_t* t_ctr; int16_t* b_ctr; int16_t* rounds; int16_t* cap_ov;
  int8_t* ov;
};
static_assert(sizeof(PackedPtrs) == kPackedFields * sizeof(void*),
              "PackedPtrs must be exactly kPackedFields pointers");

// The packed §10 slots, in PACKED_MAILBOX_FIELDS order: aq_hase is an
// (N, G) peer mask, the rest (N*N, G) planes.
struct PackedMailPtrs {
  void* vq_due; int16_t* vq_term; void* vq_lli; int16_t* vq_llt;
  int16_t* vq_round; void* aq_due; int16_t* aq_term; void* aq_pli;
  int16_t* aq_plt; PeerMask* aq_hase_bits; int16_t* aq_ent_t;
  int16_t* aq_ent_c; void* aq_commit;
};
static_assert(sizeof(PackedMailPtrs) == kMailFields * sizeof(void*),
              "PackedMailPtrs must be exactly kMailFields pointers");

// Consts::narrow8 bits, in models/state.py NARROW_GATES order: the field
// groups stored int8 (else int16) under the packed layout.
constexpr int W8_POS = 1, W8_EL = 2, W8_BO = 4, W8_ROUND = 8, W8_HB = 16,
              W8_DUE = 32;

struct Consts {
  int64_t G;
  int C, maj, hb_ticks, round_ticks, retry_ticks, cmd_node, flags;
  int delay_lo, delay_hi;  // the §10 send-delay window
  int narrow8;             // packed layout: the W8_* bits
};

// The round's vote-exchange set: the tallies and the responded plane, or
// (§18, kPC) two N-bit words a node.
template <bool kPC>
struct VoteSet {
  int votes[N], resps[N];
  bool resp_d[N * N];
};
template <>
struct VoteSet<true> {
  unsigned rb[N], vb[N];
};

// One group's non-log state, in registers.
template <bool kPC = false>
struct Group : VoteSet<kPC> {
  int term[N], vf[N], role[N], commit[N], li[N], pl[N], ltc[N], el_left[N];
  int rs[N], rl[N], ra[N], bo[N], hbl[N];
  int tctr[N], bctr[N], rounds[N], capov[N];
  bool ela[N], hba[N], up[N], dirty[N];
  bool link[N * N];
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
                                           int64_t g, Group<false>& s) {
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
                                            int64_t g, const Group<false>& s) {
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

// A narrow field's element: int8 or int16 by its width bit (uniform across
// the launch, so the branch is predicted).
__device__ __forceinline__ int ld_w(const void* p, bool w8, int64_t i) {
  return w8 ? static_cast<int>(static_cast<const int8_t*>(p)[i])
            : static_cast<int>(static_cast<const int16_t*>(p)[i]);
}
// Store v narrowed (wrapping, as a narrowing cast does); a value outside
// the width's range sets `ov`.
__device__ __forceinline__ void st_w(void* p, bool w8, int64_t i, int v,
                                     int& ov) {
  if (w8) {
    ov |= v < -128 || v > 127;
    static_cast<int8_t*>(p)[i] = static_cast<int8_t>(v);
  } else {
    ov |= v < -32768 || v > 32767;
    static_cast<int16_t*>(p)[i] = static_cast<int16_t>(v);
  }
}
__device__ __forceinline__ void st8(int8_t* p, int64_t i, int v, int& ov) {
  st_w(p, true, i, v, ov);
}
__device__ __forceinline__ void st16(int16_t* p, int64_t i, int v, int& ov) {
  st_w(p, false, i, v, ov);
}

// models/state.synth_vote_bits: the lowest `votes` set bits of rb.
__device__ __forceinline__ unsigned synth_vote_bits(unsigned rb, int votes) {
  unsigned out = 0u;
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (((rb >> j) & 1u) && cnt < votes) { out |= 1u << j; ++cnt; }
  }
  return out;
}

// The packed layout's load (widening) and store (narrowing, latched).
// Returns nothing; the store returns the latch bit of its narrowings.
template <bool kPC>
__device__ __forceinline__ void load_group(const PackedPtrs& p, int w8,
                                           int64_t G, int64_t g,
                                           Group<kPC>& s) {
  const uint32_t c0 = p.ctrl[g], c1 = p.ctrl[G + g], c2 = p.ctrl[2 * G + g];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int64_t i = node_at(G, g, n);
    s.term[n] = p.term[i];          s.vf[n] = p.voted_for[i];
    s.role[n] = (c0 >> (2 * n)) & 3u;
    s.commit[n] = ld_w(p.commit, w8 & W8_POS, i);
    s.li[n] = ld_w(p.last_index, w8 & W8_POS, i);
    s.pl[n] = ld_w(p.phys_len, w8 & W8_POS, i);
    s.ltc[n] = p.last_term[i];
    s.el_left[n] = ld_w(p.el_left, w8 & W8_EL, i);
    s.rs[n] = (c1 >> (2 * n)) & 3u;
    s.rl[n] = ld_w(p.round_left, w8 & W8_ROUND, i);
    s.ra[n] = ld_w(p.round_age, w8 & W8_ROUND, i);
    s.bo[n] = ld_w(p.bo_left, w8 & W8_BO, i);
    s.hbl[n] = ld_w(p.hb_left, w8 & W8_HB, i);
    s.tctr[n] = p.t_ctr[i];         s.bctr[n] = p.b_ctr[i];
    s.rounds[n] = p.rounds[i];      s.capov[n] = p.cap_ov[i];
    s.ela[n] = (c2 >> n) & 1u;      s.hba[n] = (c2 >> (N + n)) & 1u;
    s.up[n] = (c2 >> (2 * N + n)) & 1u;
    s.dirty[n] = false;
    const unsigned rbits = p.responded_bits[i], lbits = p.link_bits[i];
#pragma unroll
    for (int b = 0; b < N; ++b) s.link[n * N + b] = (lbits >> b) & 1u;
    if constexpr (kPC) {
      s.rb[n] = rbits & ((1u << N) - 1u);
      s.vb[n] = synth_vote_bits(s.rb[n], p.votes[i]);
    } else {
      s.votes[n] = p.votes[i];
      s.resps[n] = p.responses[i];
#pragma unroll
      for (int b = 0; b < N; ++b) s.resp_d[n * N + b] = (rbits >> b) & 1u;
    }
  }
#pragma unroll
  for (int q = 0; q < N * N; ++q) {
    const int64_t i = node_at(G, g, q);
    s.ni[q] = ld_w(p.next_index, w8 & W8_POS, i);
    s.mi[q] = ld_w(p.match_index, w8 & W8_POS, i);
  }
}

template <bool kPC>
__device__ __forceinline__ int store_group(const PackedPtrs& p, int w8,
                                           int64_t G, int64_t g,
                                           const Group<kPC>& s) {
  int ov = 0;
  // The ctrl words are sums of shifted lanes (the JAX package's pack: an
  // out-of-range lane, latched, carries into its neighbours).
  uint32_t c0 = 0u, c1 = 0u, c2 = 0u;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int64_t i = node_at(G, g, n);
    ov |= static_cast<unsigned>(s.role[n]) > 3u;
    ov |= static_cast<unsigned>(s.rs[n]) > 3u;
    c0 += static_cast<uint32_t>(s.role[n]) << (2 * n);
    c1 += static_cast<uint32_t>(s.rs[n]) << (2 * n);
    c2 |= (s.ela[n] ? 1u << n : 0u) | (s.hba[n] ? 1u << (N + n) : 0u) |
          (s.up[n] ? 1u << (2 * N + n) : 0u);
    st16(p.term, i, s.term[n], ov);
    st8(p.voted_for, i, s.vf[n], ov);
    st_w(p.commit, w8 & W8_POS, i, s.commit[n], ov);
    st_w(p.last_index, w8 & W8_POS, i, s.li[n], ov);
    st_w(p.phys_len, w8 & W8_POS, i, s.pl[n], ov);
    st16(p.last_term, i, s.ltc[n], ov);
    st_w(p.el_left, w8 & W8_EL, i, s.el_left[n], ov);
    st_w(p.round_left, w8 & W8_ROUND, i, s.rl[n], ov);
    st_w(p.round_age, w8 & W8_ROUND, i, s.ra[n], ov);
    st_w(p.bo_left, w8 & W8_BO, i, s.bo[n], ov);
    st_w(p.hb_left, w8 & W8_HB, i, s.hbl[n], ov);
    st16(p.t_ctr, i, s.tctr[n], ov);
    st16(p.b_ctr, i, s.bctr[n], ov);
    st16(p.rounds, i, s.rounds[n], ov);
    st16(p.cap_ov, i, s.capov[n], ov);
    unsigned lbits = 0u;
#pragma unroll
    for (int b = 0; b < N; ++b) lbits |= s.link[n * N + b] ? 1u << b : 0u;
    p.link_bits[i] = static_cast<PeerMask>(lbits);
    if constexpr (kPC) {
      p.responded_bits[i] = static_cast<PeerMask>(s.rb[n]);
      p.votes[i] = static_cast<int8_t>(__popc(s.vb[n]));
      p.responses[i] = static_cast<int8_t>(__popc(s.rb[n]));
    } else {
      unsigned rbits = 0u;
#pragma unroll
      for (int b = 0; b < N; ++b) rbits |= s.resp_d[n * N + b] ? 1u << b : 0u;
      p.responded_bits[i] = static_cast<PeerMask>(rbits);
      st8(p.votes, i, s.votes[n], ov);
      st8(p.responses, i, s.resps[n], ov);
    }
  }
  p.ctrl[g] = c0;
  p.ctrl[G + g] = c1;
  p.ctrl[2 * G + g] = c2;
#pragma unroll
  for (int q = 0; q < N * N; ++q) {
    const int64_t i = node_at(G, g, q);
    st_w(p.next_index, w8 & W8_POS, i, s.ni[q], ov);
    st_w(p.match_index, w8 & W8_POS, i, s.mi[q], ov);
  }
  return ov;
}

// The §10 slot fields, in MAILBOX_FIELDS order.
enum Slot {
  VQ_DUE, VQ_TERM, VQ_LLI, VQ_LLT, VQ_ROUND, AQ_DUE, AQ_TERM, AQ_PLI,
  AQ_PLT, AQ_HASE, AQ_ENT_T, AQ_ENT_C, AQ_COMMIT
};

// How a log write is tracked. NoTrack: not at all (every kernel but the
// fused kernel's observer build). LogTrack: the in-kernel monitor's write
// tracking (fused_tick_kernel.cu, RAFT_OBSERVE): per node a C-bit mask of
// the slots this tick wrote (`wm`) and of those whose stored value now
// differs from the tick's start (`dm`), in shared memory, word
// n * cw + slot / 32 at [word * stride] of the thread's column; each
// written slot's tick-start value is kept at its first write in the shadow
// logs `st` / `sc` (the logs' layout), and every write sets the slot's
// changed bit to whether the value it stores differs from that start
// value. So a slot written twice, or written back with its old value, ends
// as the full comparison of the tick's two logs gives it, and no log is
// copied. The caller zeroes the masks at each tick's start.
struct NoTrack {
  template <typename TT, typename TC>
  __device__ __forceinline__ void put(const TT*, const TC*, int64_t, int,
                                      int, TT, TC) {}
};

template <typename TT, typename TC>
struct LogTrack {
  uint32_t* wm;
  uint32_t* dm;
  int stride, cw;
  TT* st;
  TC* sc;
  __device__ __forceinline__ void put(const TT* lt, const TC* lc, int64_t at,
                                      int n, int slot, TT nt, TC nc) {
    const int w = (n * cw + (slot >> 5)) * stride;
    const uint32_t bit = 1u << (slot & 31);
    const uint32_t wv = wm[w];
    TT t0;
    TC c0;
    if (wv & bit) {
      t0 = st[at];
      c0 = sc[at];
    } else {
      t0 = lt[at];
      c0 = lc[at];
      st[at] = t0;
      sc[at] = c0;
      wm[w] = wv | bit;
    }
    const uint32_t dv = dm[w];
    dm[w] = (nt != t0 || nc != c0) ? (dv | bit) : (dv & ~bit);
  }
};

// Where the logs and the §10 slots rest, read and written in place by one
// thread's group g: the wide layout (both logs of type LT, RaftState's
// slot dtypes). Writes narrow by wrapping, as numpy's astype does. The log
// pointers are held by value; the slot pointers and the constants stay
// references into the kernel's parameters, read from the constant bank at
// each use. Copying the 13 slot pointers into the struct took registers
// the kMail instantiations did not have: their fused launch ran 12% slower
// in the wide layout and 45% in the packed one (one H100, mailbox_config(),
// raft_kotlin_tpu_torch/kernel_ab.py). Track: how log writes are tracked.
template <typename LT, typename Track = NoTrack>
struct WideMem {
  static constexpr bool kPacked = false;
  LT* const lt_;
  LT* const lc_;
  const MailPtrs& m;
  const Consts& k;
  int64_t g;
  int ov;  // unused: the wide layout has no latch
  Track tr;
  __device__ __forceinline__ LT* lt() const { return lt_; }
  __device__ __forceinline__ LT* lc() const { return lc_; }
  __device__ __forceinline__ int64_t log_at(int n, int slot) const {
    return (static_cast<int64_t>(n) * k.C + slot) * k.G + g;
  }
  __device__ __forceinline__ int log_term(int n, int slot) const {
    return lt()[log_at(n, slot)];
  }
  __device__ __forceinline__ int log_cmd(int n, int slot) const {
    return lc()[log_at(n, slot)];
  }
  __device__ __forceinline__ void log_put(int n, int slot, int tv, int cv) {
    const int64_t at = log_at(n, slot);
    const LT nt = static_cast<LT>(tv), nc = static_cast<LT>(cv);
    tr.put(lt(), lc(), at, n, slot, nt, nc);
    lt()[at] = nt;
    lc()[at] = nc;
  }
  __device__ __forceinline__ int get(Slot f, int q) const {
    const int64_t i = static_cast<int64_t>(q) * k.G + g;
    switch (f) {
      case VQ_DUE: return m.vq_due[i];
      case VQ_TERM: return m.vq_term[i];
      case VQ_LLI: return m.vq_lli[i];
      case VQ_LLT: return m.vq_llt[i];
      case VQ_ROUND: return m.vq_round[i];
      case AQ_DUE: return m.aq_due[i];
      case AQ_TERM: return m.aq_term[i];
      case AQ_PLI: return m.aq_pli[i];
      case AQ_PLT: return m.aq_plt[i];
      case AQ_HASE: return m.aq_hase[i];
      case AQ_ENT_T: return m.aq_ent_t[i];
      case AQ_ENT_C: return m.aq_ent_c[i];
      default: return m.aq_commit[i];
    }
  }
  __device__ __forceinline__ void put(Slot f, int q, int v) {
    const int64_t i = static_cast<int64_t>(q) * k.G + g;
    switch (f) {
      case VQ_DUE: m.vq_due[i] = static_cast<int16_t>(v); break;
      case VQ_TERM: m.vq_term[i] = v; break;
      case VQ_LLI: m.vq_lli[i] = static_cast<int16_t>(v); break;
      case VQ_LLT: m.vq_llt[i] = v; break;
      case VQ_ROUND: m.vq_round[i] = v; break;
      case AQ_DUE: m.aq_due[i] = static_cast<int16_t>(v); break;
      case AQ_TERM: m.aq_term[i] = v; break;
      case AQ_PLI: m.aq_pli[i] = static_cast<int16_t>(v); break;
      case AQ_PLT: m.aq_plt[i] = v; break;
      case AQ_HASE: m.aq_hase[i] = static_cast<int16_t>(v); break;
      case AQ_ENT_T: m.aq_ent_t[i] = v; break;
      case AQ_ENT_C: m.aq_ent_c[i] = v; break;
      default: m.aq_commit[i] = static_cast<int16_t>(v); break;
    }
  }
};

// The packed layout's logs (int8 terms, int16 commands) and slots; every
// narrowed write is range-checked into `ov`, the group's latch bit. Track:
// how log writes are tracked (as WideMem's).
template <typename Track = NoTrack>
struct PackedMemT {
  static constexpr bool kPacked = true;
  int8_t* const lt_;
  int16_t* const lc_;
  const PackedMailPtrs& m;
  const Consts& k;
  int64_t g;
  int ov;
  Track tr;
  __device__ __forceinline__ int8_t* lt() const { return lt_; }
  __device__ __forceinline__ int16_t* lc() const { return lc_; }
  __device__ __forceinline__ int64_t log_at(int n, int slot) const {
    return (static_cast<int64_t>(n) * k.C + slot) * k.G + g;
  }
  __device__ __forceinline__ int log_term(int n, int slot) const {
    return lt()[log_at(n, slot)];
  }
  __device__ __forceinline__ int log_cmd(int n, int slot) const {
    return lc()[log_at(n, slot)];
  }
  __device__ __forceinline__ void log_put(int n, int slot, int tv, int cv) {
    const int64_t at = log_at(n, slot);
    tr.put(lt(), lc(), at, n, slot, static_cast<int8_t>(tv),
           static_cast<int16_t>(cv));
    st8(lt(), at, tv, ov);
    st16(lc(), at, cv, ov);
  }
  __device__ __forceinline__ int get(Slot f, int q) const {
    const int64_t i = static_cast<int64_t>(q) * k.G + g;
    const int w8 = k.narrow8;
    switch (f) {
      case VQ_DUE: return ld_w(m.vq_due, w8 & W8_DUE, i);
      case VQ_TERM: return m.vq_term[i];
      case VQ_LLI: return ld_w(m.vq_lli, w8 & W8_POS, i);
      case VQ_LLT: return m.vq_llt[i];
      case VQ_ROUND: return m.vq_round[i];
      case AQ_DUE: return ld_w(m.aq_due, w8 & W8_DUE, i);
      case AQ_TERM: return m.aq_term[i];
      case AQ_PLI: return ld_w(m.aq_pli, w8 & W8_POS, i);
      case AQ_PLT: return m.aq_plt[i];
      case AQ_HASE:
        return (m.aq_hase_bits[static_cast<int64_t>(q / N) * k.G + g] >>
                (q % N)) & 1;
      case AQ_ENT_T: return m.aq_ent_t[i];
      case AQ_ENT_C: return m.aq_ent_c[i];
      default: return ld_w(m.aq_commit, w8 & W8_POS, i);
    }
  }
  __device__ __forceinline__ void put(Slot f, int q, int v) {
    const int64_t i = static_cast<int64_t>(q) * k.G + g;
    const int w8 = k.narrow8;
    switch (f) {
      case VQ_DUE: st_w(m.vq_due, w8 & W8_DUE, i, v, ov); break;
      case VQ_TERM: st16(m.vq_term, i, v, ov); break;
      case VQ_LLI: st_w(m.vq_lli, w8 & W8_POS, i, v, ov); break;
      case VQ_LLT: st16(m.vq_llt, i, v, ov); break;
      case VQ_ROUND: st16(m.vq_round, i, v, ov); break;
      case AQ_DUE: st_w(m.aq_due, w8 & W8_DUE, i, v, ov); break;
      case AQ_TERM: st16(m.aq_term, i, v, ov); break;
      case AQ_PLI: st_w(m.aq_pli, w8 & W8_POS, i, v, ov); break;
      case AQ_PLT: st16(m.aq_plt, i, v, ov); break;
      case AQ_HASE: {
        PeerMask* w = m.aq_hase_bits + static_cast<int64_t>(q / N) * k.G + g;
        const unsigned bit = 1u << (q % N);
        *w = static_cast<PeerMask>(v != 0 ? (*w | bit) : (*w & ~bit));
        break;
      }
      case AQ_ENT_T: st16(m.aq_ent_t, i, v, ov); break;
      case AQ_ENT_C: st16(m.aq_ent_c, i, v, ov); break;
      default: st_w(m.aq_commit, w8 & W8_POS, i, v, ov); break;
    }
  }
};
using PackedMem = PackedMemT<>;

// What the observers read of the §10 slots at a tick's end: the slots in
// flight, and the bitmask of nodes that own an append slot in flight (the
// monitor's stale-append hazard, for a deposed leader's late appends).
struct Inflight {
  int count, aq_owners;
};

// One tick of the phase lattice on one group (state in `s`; its logs and,
// under kMail, its mailbox slots in place through `mem`). Marks s.dirty for
// nodes whose election timer reset in phases 2-5: the caller materializes
// their el_left (§7). Returns the §10 slots in flight at the tick's end
// (zeros without the mailbox).
template <bool kMail, bool kPC, typename Mem, typename Aux>
__device__ __forceinline__ Inflight tick_body(Group<kPC>& s, Mem& mem,
                                              const Consts& k, Aux& aux) {
  const int C = k.C;
#pragma unroll
  for (int n = 0; n < N; ++n) s.dirty[n] = false;

  // §7: a reset consumes one counted draw; el_left is drawn afterwards.
  auto reset_timer = [&](int n, bool m) {
    if (m) { s.tctr[n] += 1; s.ela[n] = true; s.dirty[n] = true; }
  };
  // Physical slot idx of node n's log; 0 outside [0, C).
  auto log_term_at = [&](int n, int idx) -> int {
    return (idx >= 0 && idx < C) ? mem.log_term(n, idx) : 0;
  };
  auto log_cmd_at = [&](int n, int idx) -> int {
    return (idx >= 0 && idx < C) ? mem.log_cmd(n, idx) : 0;
  };
  // The round's exchange set: whether pair (c, q) exchanged, the tally of
  // one exchange, and its reset.
  auto responded = [&](int c, int q) -> bool {
    if constexpr (kPC) return (s.rb[c] >> q) & 1u;
    else return s.resp_d[c * N + q];
  };
  auto tally = [&](int c, int q, bool granted) {
    if constexpr (kPC) {
      s.rb[c] |= 1u << q;
      if (granted) s.vb[c] |= 1u << q;
    } else {
      s.resp_d[c * N + q] = true;
      s.resps[c] += 1;
      if (granted) s.votes[c] += 1;
    }
  };
  auto clear_votes = [&](int n) {
    if constexpr (kPC) {
      s.rb[n] = 0u; s.vb[n] = 0u;
    } else {
      s.votes[n] = 0; s.resps[n] = 0;
#pragma unroll
      for (int b = 0; b < N; ++b) s.resp_d[n * N + b] = false;
    }
  };
  // SEMANTICS.md §3 add(): append at the PHYSICAL end (slot phys_len — the
  // ghost-append quirk) when i == last_index and there is room; overwrite +
  // truncate when 0 <= i < last_index; a rejected append latches cap_ov.
  auto log_add = [&](int n, int i, int tv, int cv, bool mask) {
    if (!mask) return;
    if (i == s.li[n]) {
      if (s.pl[n] >= C) { s.capov[n] |= 1; return; }
      mem.log_put(n, s.pl[n], tv, cv);
      s.pl[n] += 1;
      s.li[n] = i + 1;
    } else if (i < s.li[n] && i >= 0) {
      mem.log_put(n, i, tv, cv);
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
        s.li[n] = 0; s.pl[n] = 0; s.rs[n] = IDLE; s.rl[n] = 0; s.ra[n] = 0;
        s.bo[n] = 0; s.ltc[n] = 0; s.hbl[n] = 0;
        clear_votes(n);
#pragma unroll
        for (int b = 0; b < N; ++b) {
          s.ni[n * N + b] = 0; s.mi[n * N + b] = 0;
        }
        s.hba[n] = false;
        if constexpr (kMail) {
          // §10: the slots the node OWNS die with it (a crash clears none).
#pragma unroll
          for (int b = 0; b < N; ++b) {
            mem.put(VQ_DUE, n * N + b, -1);
            mem.put(AQ_DUE, n * N + b, -1);
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
      s.term[n] += 1; s.vf[n] = n + 1;
      clear_votes(n);
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
      if (mem.get(VQ_DUE, kk) != 0) return;
      mem.put(VQ_DUE, kk, -1);
      if (!eok[q * N + c]) return;
      const int req_term = mem.get(VQ_TERM, kk);
      const int req_lli = mem.get(VQ_LLI, kk);
      const int req_llt = mem.get(VQ_LLT, kk);
      const bool guard =
          s.rs[c] == ACTIVE && mem.get(VQ_ROUND, kk) == s.rounds[c];
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
      tally(c, q, granted);
      if (s.term[q] > s.term[c]) s.role[c] = FOLLOWER;  // quirk f, live term
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
        if (!(attempting && eok[kk] && !responded(c, q))) continue;
        const int d = delay_for(c, q);
        mem.put(VQ_TERM, kk, s.term[c]);
        mem.put(VQ_LLI, kk, lli[c]);
        mem.put(VQ_LLT, kk, llt[c]);
        mem.put(VQ_ROUND, kk, s.rounds[c]);
        mem.put(VQ_DUE, kk, d);
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
      if (responded(c, q) || !(eok[c * N + q] && eok[q * N + c]))
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
      tally(c, q, granted);
      if (s.term[q] > s.term[c]) s.role[c] = FOLLOWER;  // quirk f, live term
    }
  }
  }

  // -- phase 4: round conclusions --------------------------------------
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if (!(s.rs[n] == ACTIVE && s.up[n])) continue;
    // The tallies: §18's popcount compares on the words.
    int resps, votes;
    if constexpr (kPC) {
      resps = __popc(s.rb[n]); votes = __popc(s.vb[n]);
    } else {
      resps = s.resps[n]; votes = s.votes[n];
    }
    if (resps >= k.maj || s.rl[n] <= 0) {
      if (s.role[n] == CANDIDATE && votes >= k.maj) {
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
      if (mem.get(AQ_DUE, kk) != 0) return;
      mem.put(AQ_DUE, kk, -1);
      if (!eok[q * N + l]) return;
      const int req_term = mem.get(AQ_TERM, kk);
      const int req_commit = mem.get(AQ_COMMIT, kk);
      const int pli = mem.get(AQ_PLI, kk);
      const int plt = mem.get(AQ_PLT, kk);
      const bool has_entry = mem.get(AQ_HASE, kk) != 0;
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
        log_add(q, pli + 1, mem.get(AQ_ENT_T, kk), mem.get(AQ_ENT_C, kk),
                true);
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
        mem.put(AQ_TERM, kk, s.term[l]);
        mem.put(AQ_COMMIT, kk, s.commit[l]);
        mem.put(AQ_PLI, kk, pli);
        mem.put(AQ_PLT, kk, pli >= 0 ? log_term_at(l, pli) : -1);
        mem.put(AQ_HASE, kk, has_entry);
        mem.put(AQ_ENT_T, kk, log_term_at(l, i - 1));
        mem.put(AQ_ENT_C, kk, log_cmd_at(l, i - 1));
        mem.put(AQ_DUE, kk, d);
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
      const Slot due[2] = {VQ_DUE, AQ_DUE};
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const int d = mem.get(due[w], q);
        if (d > 0) mem.put(due[w], q, d - 1);
        inflight.count += d >= 0;
        if (w == 1 && d >= 0) inflight.aq_owners |= 1 << (q / N);
      }
    }
  }
  return inflight;
}

}  // namespace raft
