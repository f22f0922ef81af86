// One Raft tick (SEMANTICS.md phases F, 0-5) for every group, in place.
//
// Replaces the JAX package's Pallas megakernel
// raft_kotlin_tpu/ops/pallas_tick.py::make_pallas_core (the T=1, staged-aux,
// unpacked-compute body, pallas_call at :724), whose body is
// ops/tick.py::phase_body. The plain PyTorch version of this kernel is
// raft_kotlin_tpu_torch/ops/tick.py::phase_body; the two are held bit-equal.
//
// Design: one thread per group. The state is groups-minor ((N, G), (N*N, G),
// (N*C, G) rows), so row r of group g sits at r*G + g and a warp's 32
// neighbouring groups read and write one coalesced segment per row. Node and
// pair fields live in registers (N is a compile-time constant, -DRAFT_N, so
// every node/pair loop unrolls); log rows are read and written in place in
// device memory by direct index — each thread owns its group's column, so
// there are no races. The TPU form's one-hot row selects, columnar stacks
// and ILP slabs existed only because Mosaic lacks gather and scatter; here a
// node's log slot is one load. The exchanges run in the canonical (owner,
// peer) order, exactly as the plain version and the scalar oracle do.
//
// Bound: memory. A tick does a few hundred integer operations per group
// against the non-log state read and written (405 B per group at N=5), the
// staged aux read (184 B), el_dirty written (5 B) and the few log slots it
// needs (the last-term reads, the prevLog/entry reads of the exchanges that
// go ahead, the appends) — not the whole (N, C) logs. The least time is
// those bytes over the card's memory bandwidth; chip_smoke.py counts them
// from the run's own data (phase_body's `touched` masks). The kernel
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

#ifndef RAFT_N
#error "build with -DRAFT_N=<nodes per group>"
#endif

namespace {

constexpr int N = RAFT_N;
static_assert(N >= 1 && N <= 9, "1 <= n_nodes <= 9");

constexpr int FOLLOWER = 0, CANDIDATE = 1, LEADER = 2;
constexpr int IDLE = 0, BACKOFF = 1, ACTIVE = 2;
constexpr int FLAG_FAULTS = 1, FLAG_LINKS = 2, FLAG_PERIODIC = 4,
              FLAG_INJECT = 8;

// Pointer order = the wrapper's operand order (ops/cuda_tick.py OPERANDS).
struct Params {
  int32_t* term; int16_t* voted_for; int16_t* role; int16_t* commit;
  int16_t* last_index; int16_t* phys_len; void* log_term; void* log_cmd;
  int32_t* last_term; uint8_t* el_armed; int16_t* el_left;
  int16_t* round_state; int16_t* round_left; int16_t* round_age;
  int16_t* votes; int16_t* responses; uint8_t* responded; int16_t* bo_left;
  int16_t* next_index; int16_t* match_index; uint8_t* hb_armed;
  int16_t* hb_left; uint8_t* up; uint8_t* link_up; int32_t* t_ctr;
  int32_t* b_ctr; int32_t* rounds; int16_t* cap_ov;
  const int16_t* edge_iid; const uint8_t* crash_m; const uint8_t* restart_m;
  const int16_t* link_fail; const int16_t* link_heal;
  const int16_t* el_draw_f; const int16_t* bdraw; const int32_t* periodic;
  const int32_t* inject;
  uint8_t* el_dirty;
  int64_t G;
  int C, maj, hb_ticks, round_ticks, retry_ticks, cmd_node, flags;
};
constexpr int kPointers = 38;
static_assert(offsetof(Params, G) == kPointers * sizeof(void*),
              "Params must open with exactly kPointers pointers");

// Floor modulo (numpy's %, torch.remainder); C++ % truncates.
__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return (r != 0 && ((r < 0) != (m < 0))) ? r + m : r;
}

template <typename LT>
__global__ void __launch_bounds__(128) raft_tick_kernel(const Params p) {
  const int64_t G = p.G;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const int C = p.C;
  LT* const lt = static_cast<LT*>(p.log_term);
  LT* const lc = static_cast<LT*>(p.log_cmd);
#define NODE(n) (static_cast<int64_t>(n) * G + g)
#define PAIR(a, b) (static_cast<int64_t>((a) * N + (b)) * G + g)
#define LOG(n, slot) ((static_cast<int64_t>(n) * C + (slot)) * G + g)

  int term[N], vf[N], role[N], commit[N], li[N], pl[N], ltc[N], el_left[N];
  int rs[N], rl[N], ra[N], votes[N], resps[N], bo[N], hbl[N];
  int tctr[N], bctr[N], rounds[N], capov[N];
  bool ela[N], hba[N], up[N], dirty[N];
  bool resp_d[N * N], link[N * N], eok[N * N];
  int ni[N * N], mi[N * N];

#pragma unroll
  for (int n = 0; n < N; ++n) {
    term[n] = p.term[NODE(n)];         vf[n] = p.voted_for[NODE(n)];
    role[n] = p.role[NODE(n)];         commit[n] = p.commit[NODE(n)];
    li[n] = p.last_index[NODE(n)];     pl[n] = p.phys_len[NODE(n)];
    ltc[n] = p.last_term[NODE(n)];     el_left[n] = p.el_left[NODE(n)];
    rs[n] = p.round_state[NODE(n)];    rl[n] = p.round_left[NODE(n)];
    ra[n] = p.round_age[NODE(n)];      votes[n] = p.votes[NODE(n)];
    resps[n] = p.responses[NODE(n)];   bo[n] = p.bo_left[NODE(n)];
    hbl[n] = p.hb_left[NODE(n)];       tctr[n] = p.t_ctr[NODE(n)];
    bctr[n] = p.b_ctr[NODE(n)];        rounds[n] = p.rounds[NODE(n)];
    capov[n] = p.cap_ov[NODE(n)];
    ela[n] = p.el_armed[NODE(n)] != 0; hba[n] = p.hb_armed[NODE(n)] != 0;
    up[n] = p.up[NODE(n)] != 0;        dirty[n] = false;
  }
#pragma unroll
  for (int a = 0; a < N; ++a) {
#pragma unroll
    for (int b = 0; b < N; ++b) {
      resp_d[a * N + b] = p.responded[PAIR(a, b)] != 0;
      link[a * N + b] = p.link_up[PAIR(a, b)] != 0;
      ni[a * N + b] = p.next_index[PAIR(a, b)];
      mi[a * N + b] = p.match_index[PAIR(a, b)];
    }
  }

  // §7: a reset consumes one counted draw; el_left is drawn afterwards.
  auto reset_timer = [&](int n, bool m) {
    if (m) { tctr[n] += 1; ela[n] = true; dirty[n] = true; }
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
    if (i == li[n]) {
      if (pl[n] >= C) { capov[n] |= 1; return; }
      lt[LOG(n, pl[n])] = static_cast<LT>(tv);
      lc[LOG(n, pl[n])] = static_cast<LT>(cv);
      pl[n] += 1;
      li[n] = i + 1;
    } else if (i < li[n] && i >= 0) {
      lt[LOG(n, i)] = static_cast<LT>(tv);
      lc[LOG(n, i)] = static_cast<LT>(cv);
      li[n] = i + 1;
    }
  };

  // -- phase F: fault events (§9) --------------------------------------
  if (p.flags & FLAG_FAULTS) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const bool crash = up[n] && p.crash_m[NODE(n)] != 0;
      const bool rst = !up[n] && p.restart_m[NODE(n)] != 0;
      up[n] = (up[n] && !crash) || rst;
      if (rst) {
        term[n] = 0; vf[n] = -1; role[n] = FOLLOWER; commit[n] = 0;
        li[n] = 0; pl[n] = 0; rs[n] = IDLE; votes[n] = 0; resps[n] = 0;
        rl[n] = 0; ra[n] = 0; bo[n] = 0; ltc[n] = 0; hbl[n] = 0;
#pragma unroll
        for (int b = 0; b < N; ++b) {
          resp_d[n * N + b] = false; ni[n * N + b] = 0; mi[n * N + b] = 0;
        }
        hba[n] = false;
        // Immediate reset: el_draw_f is the draw at the pre-tick t_ctr.
        el_left[n] = p.el_draw_f[NODE(n)];
        ela[n] = true;
        tctr[n] += 1;
      }
    }
  }
  if (p.flags & FLAG_LINKS) {
#pragma unroll
    for (int a = 0; a < N; ++a) {
#pragma unroll
      for (int b = 0; b < N; ++b) {
        const int k = a * N + b;
        link[k] = link[k] ? p.link_fail[PAIR(a, b)] == 0
                          : p.link_heal[PAIR(a, b)] != 0;
      }
    }
  }
  // Effective edge health: iid survival ∧ link health ∧ both ends up.
#pragma unroll
  for (int a = 0; a < N; ++a) {
#pragma unroll
    for (int b = 0; b < N; ++b) {
      eok[a * N + b] = p.edge_iid[PAIR(a, b)] != 0 && link[a * N + b] &&
                       up[a] && up[b];
    }
  }

  // -- phase 0: command injection (quirk k) ----------------------------
  if (p.flags & FLAG_PERIODIC) {
    const int n = p.cmd_node - 1;
    const int cmd = p.periodic[g];
#pragma unroll
    for (int m = 0; m < N; ++m)  // keep node arrays in registers
      if (m == n) log_add(m, li[m], term[m], cmd, cmd >= 0 && up[m]);
  }
  if (p.flags & FLAG_INJECT) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int cmd = p.inject[NODE(n)];
      log_add(n, li[n], term[n], cmd, cmd >= 0 && up[n]);
    }
  }
  // lastLogTerm cache refresh for nodes phase 0 may have appended to.
  if (p.flags & (FLAG_PERIODIC | FLAG_INJECT)) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      if ((p.flags & FLAG_INJECT) || n == p.cmd_node - 1)
        ltc[n] = log_term_at(n, li[n] - 1);  // slot -1 reads as 0
    }
  }

  // -- phase 1: timers (independent countdowns) ------------------------
  bool start_round[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const bool armed = ela[n] && up[n];
    if (armed) el_left[n] -= 1;
    const bool fire = armed && el_left[n] <= 0;
    if (fire) { ela[n] = false; role[n] = CANDIDATE; }
    const bool in_bo = rs[n] == BACKOFF && up[n];
    if (in_bo) bo[n] -= 1;
    const bool bfire = in_bo && bo[n] <= 0;
    if (bfire) rs[n] = IDLE;
    start_round[n] = fire || bfire;
  }

  // -- phase 2: round starts -------------------------------------------
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if (!start_round[n]) continue;
    if (role[n] == CANDIDATE) {
      term[n] += 1; vf[n] = n + 1; votes[n] = 0; resps[n] = 0;
#pragma unroll
      for (int b = 0; b < N; ++b) resp_d[n * N + b] = false;
      rl[n] = p.round_ticks; ra[n] = 0; rs[n] = ACTIVE; rounds[n] += 1;
    } else {  // demoted while backing off
      rs[n] = IDLE;
      reset_timer(n, true);
    }
  }

  // -- phase 3: vote exchanges, canonical (candidate, peer) order ------
  // Last-log position/term are phase-3 invariants (no vote touches a log).
  int lli[N], llt[N];
#pragma unroll
  for (int n = 0; n < N; ++n) { lli[n] = li[n]; llt[n] = ltc[n]; }
#pragma unroll
  for (int c = 0; c < N; ++c) {
    if (!(rs[c] == ACTIVE && floor_mod(ra[c], p.retry_ticks) == 0)) continue;
#pragma unroll
    for (int q = 0; q < N; ++q) {
      if (resp_d[c * N + q] || !(eok[c * N + q] && eok[q * N + c])) continue;
      const int req_term = term[c];
      const bool rej_stale = lli[q] >= 1 && llt[c] < llt[q];
      const bool rej_short = lli[q] >= 1 && llt[c] == llt[q] && lli[c] < lli[q];
      const bool grant_gt = req_term > term[q] && !(rej_stale || rej_short);
      const bool granted = (req_term == term[q] && vf[q] == c + 1) || grant_gt;
      if (grant_gt) {
        term[q] = req_term; vf[q] = c + 1; role[q] = FOLLOWER;
        reset_timer(q, true);
      }
      resp_d[c * N + q] = true;
      resps[c] += 1;
      if (term[q] > term[c]) role[c] = FOLLOWER;  // quirk f, live term
      if (granted) votes[c] += 1;
    }
  }

  // -- phase 4: round conclusions --------------------------------------
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if (!(rs[n] == ACTIVE && up[n])) continue;
    if (resps[n] >= p.maj || rl[n] <= 0) {
      if (role[n] == CANDIDATE && votes[n] >= p.maj) {
        role[n] = LEADER;
#pragma unroll
        for (int b = 0; b < N; ++b) {  // quirk b
          ni[n * N + b] = commit[n] + 1; mi[n * N + b] = 0;
        }
        hba[n] = true; hbl[n] = 0; rs[n] = IDLE;
      } else if (role[n] == CANDIDATE) {
        rs[n] = BACKOFF; bo[n] = p.bdraw[NODE(n)]; bctr[n] += 1;
      } else {
        rs[n] = IDLE;
        reset_timer(n, true);
      }
    } else {
      rl[n] -= 1; ra[n] += 1;
    }
  }

  // -- phase 5: append / heartbeat, canonical (leader, peer) order -----
#pragma unroll
  for (int l = 0; l < N; ++l) {
    if (!(hba[l] && up[l])) continue;
    if (hbl[l] > 0) { hbl[l] -= 1; continue; }
    // FOLLOWER cancels future firings, but this round still goes out.
    if (role[l] == FOLLOWER) hba[l] = false; else hbl[l] = p.hb_ticks - 1;
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const int k = l * N + q;
      const int i = ni[k];
      const int pli = i - 2;
      if (pli >= 0 && pli >= li[l]) continue;  // invalid prevLog -> skip
      const int plt = pli >= 0 ? log_term_at(l, pli) : -1;
      const bool has_entry = li[l] >= i;
      if (has_entry && i <= 0) continue;       // quirk i underflow
      if (!(eok[k] && eok[q * N + l])) continue;
      const int ent_t = log_term_at(l, i - 1);
      const int ent_c = log_cmd_at(l, i - 1);
      const int req_term = term[l];
      const int req_commit = commit[l];
      // §6.2 handler on q.
      if (q != l) {
        if (req_term > term[q]) {
          term[q] = req_term; vf[q] = -1; reset_timer(q, true);
        }
        role[q] = FOLLOWER;  // quirk d: any foreign append demotes
        reset_timer(q, true);
      }
      if (req_commit > commit[q])
        commit[q] = min(req_commit, li[q]);  // quirk e
      const int p_plt = log_term_at(q, pli);
      const bool succ = pli == -1 || (li[q] > pli && pli >= 0 && p_plt == plt);
      log_add(q, pli + 1, ent_t, ent_c, has_entry && succ);
      // Leader processes the response (RaftServer.kt:146-168).
      if (q != l && term[q] > term[l]) {
        term[l] = term[q]; role[l] = FOLLOWER; reset_timer(l, true);
        continue;
      }
      if (succ) {
        if (has_entry) {
          ni[k] += 1; mi[k] += 1;
          int cnt = 0;  // quirk a: #{m : match[m] > commit} >= maj
#pragma unroll
          for (int m = 0; m < N; ++m) cnt += mi[l * N + m] > commit[l];
          if (cnt >= p.maj) commit[l] += 1;
        } else {
          mi[k] = pli + 1;  // quirk h
        }
      } else {
        ni[k] -= 1;  // quirk i
      }
    }
  }

  // lastLogTerm cache from the FINAL log (a log read, not accumulated).
#pragma unroll
  for (int n = 0; n < N; ++n) ltc[n] = log_term_at(n, li[n] - 1);

#pragma unroll
  for (int n = 0; n < N; ++n) {
    p.term[NODE(n)] = term[n];
    p.voted_for[NODE(n)] = static_cast<int16_t>(vf[n]);
    p.role[NODE(n)] = static_cast<int16_t>(role[n]);
    p.commit[NODE(n)] = static_cast<int16_t>(commit[n]);
    p.last_index[NODE(n)] = static_cast<int16_t>(li[n]);
    p.phys_len[NODE(n)] = static_cast<int16_t>(pl[n]);
    p.last_term[NODE(n)] = ltc[n];
    p.el_armed[NODE(n)] = ela[n];
    p.el_left[NODE(n)] = static_cast<int16_t>(el_left[n]);
    p.round_state[NODE(n)] = static_cast<int16_t>(rs[n]);
    p.round_left[NODE(n)] = static_cast<int16_t>(rl[n]);
    p.round_age[NODE(n)] = static_cast<int16_t>(ra[n]);
    p.votes[NODE(n)] = static_cast<int16_t>(votes[n]);
    p.responses[NODE(n)] = static_cast<int16_t>(resps[n]);
    p.bo_left[NODE(n)] = static_cast<int16_t>(bo[n]);
    p.hb_armed[NODE(n)] = hba[n];
    p.hb_left[NODE(n)] = static_cast<int16_t>(hbl[n]);
    p.up[NODE(n)] = up[n];
    p.t_ctr[NODE(n)] = tctr[n];
    p.b_ctr[NODE(n)] = bctr[n];
    p.rounds[NODE(n)] = rounds[n];
    p.cap_ov[NODE(n)] = static_cast<int16_t>(capov[n]);
    p.el_dirty[NODE(n)] = dirty[n];
  }
#pragma unroll
  for (int a = 0; a < N; ++a) {
#pragma unroll
    for (int b = 0; b < N; ++b) {
      p.responded[PAIR(a, b)] = resp_d[a * N + b];
      p.link_up[PAIR(a, b)] = link[a * N + b];
      p.next_index[PAIR(a, b)] = static_cast<int16_t>(ni[a * N + b]);
      p.match_index[PAIR(a, b)] = static_cast<int16_t>(mi[a * N + b]);
    }
  }
#undef NODE
#undef PAIR
#undef LOG
}

}  // namespace

extern "C" int raft_tick_nodes() { return N; }

// ptrs: kPointers device pointers in Params order (null for aux channels
// whose flag is off). ints: G, C, maj, hb_ticks, round_ticks, retry_ticks,
// cmd_node, flags, log_is_int16, threads_per_block, device. The library
// links its own (static) CUDA runtime, whose current device is not the
// caller's: it is set here to the device the operands and stream are on.
extern "C" int raft_tick_launch(void* const* ptrs, const long long* ints,
                                void* stream) {
  const cudaError_t set = cudaSetDevice(static_cast<int>(ints[10]));
  if (set != cudaSuccess) return static_cast<int>(set);
  Params p;
  void** dst = reinterpret_cast<void**>(&p);
  for (int i = 0; i < kPointers; ++i) dst[i] = ptrs[i];
  p.G = ints[0];
  p.C = static_cast<int>(ints[1]);
  p.maj = static_cast<int>(ints[2]);
  p.hb_ticks = static_cast<int>(ints[3]);
  p.round_ticks = static_cast<int>(ints[4]);
  p.retry_ticks = static_cast<int>(ints[5]);
  p.cmd_node = static_cast<int>(ints[6]);
  p.flags = static_cast<int>(ints[7]);
  const bool log16 = ints[8] != 0;
  const int threads = static_cast<int>(ints[9]);
  const unsigned blocks = static_cast<unsigned>((p.G + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (log16)
    raft_tick_kernel<int16_t><<<blocks, threads, 0, s>>>(p);
  else
    raft_tick_kernel<int32_t><<<blocks, threads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
