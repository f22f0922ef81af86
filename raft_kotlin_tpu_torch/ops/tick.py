"""The lockstep tick in PyTorch: all (groups x nodes) advance one SEMANTICS.md
tick.

- `phase_body(cfg, s, aux, flags)` — the plain PyTorch version of the tick
  kernel: the whole phase lattice (F, 0-5) as (G,)-wide tensor ops on the
  flat state dict, in the canonical node and pair order. It consumes no
  randomness: every draw arrives pre-drawn in `aux`, except the deferred
  election draws, which it reports back through the returned el_dirty mask.
  The CPU runs it; `ops/cuda_tick.py` holds the CUDA kernel that computes the
  same function on the card and is tested against it.
- `make_aux` — the staged per-tick draws (counted threefry, canonical
  (G, ...) shapes transposed to groups-minor), plain tensor code.
- `make_tick` / `make_run` — the drivers: draw aux, run the lattice,
  materialize the deferred election draws (§7), bump the tick.

The port updates a state IN PLACE (the JAX package's states are immutable):
at the headline shape a second copy of the state is ~170 MB of traffic per
tick. `make_run` clones what its trace and recorder need.

Only the shallow single-device path is ported: BodyFlags with `delay`,
`dyn_log`, `batched`, `compact` or `packed_compute` raise
NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from raft_kotlin_tpu_torch.constants import (
    ACTIVE, BACKOFF, CANDIDATE, FOLLOWER, IDLE, LEADER)
from raft_kotlin_tpu_torch.models.state import (
    LOG_FIELDS, PAIR_FIELDS, STATE_FIELDS, RaftState, check_supported,
    require_device)
from raft_kotlin_tpu_torch.utils import rng as rngmod
from raft_kotlin_tpu_torch.utils import telemetry as telemetry_mod
from raft_kotlin_tpu_torch.utils.config import RaftConfig

_I32 = torch.int32

# Pre-drawn randomness + driver inputs consumed by phase_body (flat layouts:
# pair rows (s-1)*N + r-1).
AUX_FIELDS = (
    "edge_iid",   # (N*N, G) i16 — §4 iid survival
    "crash_m",    # (N, G) bool — §9 crash events (random ∨ driver cmd)
    "restart_m",  # (N, G) bool
    "link_fail",  # (N*N, G) i16
    "link_heal",  # (N*N, G) i16
    "el_draw_f",  # (N, G) i16 — timeout draw at pre-tick t_ctr (restarts)
    "bdraw",      # (N, G) i16 — backoff draw at pre-tick b_ctr (phase 4)
    "periodic",   # (1, G) i32 — phase-0 workload command, -1 = none
    "inject",     # (N, G) i32 — driver commands, -1 = none
)

# Node fields the lattice reads as int32 / as bool.
_INT_NODE = ("term", "voted_for", "role", "commit", "last_index", "phys_len",
             "last_term", "el_left", "round_state", "round_left", "round_age",
             "votes", "responses", "bo_left", "hb_left", "t_ctr", "b_ctr",
             "rounds", "cap_ov")
_BOOL_NODE = ("el_armed", "hb_armed", "up")


@dataclasses.dataclass(frozen=True)
class BodyFlags:
    """Static switches: which optional phases the tick includes. The last
    five name JAX-package engines the port does not carry yet."""
    faults: bool = False
    links: bool = False
    periodic: bool = False
    inject: bool = False
    delay: bool = False
    dyn_log: bool = False
    batched: bool = False
    compact: bool = False
    packed_compute: bool = False


_UNPORTED = ("delay", "dyn_log", "batched", "compact", "packed_compute")


def check_flags(flags: BodyFlags) -> None:
    bad = [k for k in _UNPORTED if getattr(flags, k)]
    if bad:
        raise NotImplementedError(
            f"BodyFlags {bad}: only the shallow single-device lattice is "
            "ported (the §10 mailbox, deep-log engines, §15 compaction and "
            "§18 packed compute are not)")


def make_flags(cfg: RaftConfig, inject_present: bool = False,
               fault_present: bool = False) -> BodyFlags:
    """The BodyFlags a tick over `cfg` runs with (the JAX package's
    make_flags on the configs the port supports)."""
    dyn = cfg.uses_dyn_log
    return BodyFlags(
        faults=cfg.p_crash > 0 or cfg.p_restart > 0 or fault_present,
        links=cfg.p_link_fail > 0 or cfg.p_link_heal > 0,
        periodic=cfg.cmd_period > 0,
        inject=inject_present,
        delay=cfg.uses_mailbox,
        dyn_log=dyn,
        batched=dyn and not cfg.uses_mailbox,
        compact=cfg.uses_compaction,
    )


def phase_body(cfg: RaftConfig, s: dict, aux: dict, flags: BodyFlags,
               cut: Optional[int] = None,
               touched: Optional[dict] = None) -> torch.Tensor:
    """Advance the phase lattice F, 0-5 one tick, updating `s` in place.

    `s` maps STATE_FIELDS to rank-2 tensors (see flatten_state): (N, G) node
    grids, (N*N, G) pair grids (row (a-1)*N + b-1; bool or int 0/1), (N*C, G)
    logs (row (n-1)*C + slot). Values are read widened to int32 and written
    back in each tensor's own dtype (narrowing wraps, as `astype` does);
    log writes narrow at once, so a read in the same tick sees the stored
    value. `aux` maps AUX_FIELDS to tensors (only the enabled ones are read).
    Returns el_dirty (N, G) bool: nodes whose election timer reset in phases
    2-5; the caller materializes their el_left as the draw at t_ctr - 1
    (SEMANTICS.md §7 — el_left's only reader is phase 1).

    `cut` stops the lattice after phase `cut` (0 = phases F and 0), for
    phase-by-phase comparison; None runs the whole tick.

    `touched`, when given, receives three (N*C, G) bool masks of log slots:
    "log_term_read" and "log_cmd_read", the slots whose stored value the
    tick needs (read before this tick writes them), and "log_written", the
    slots it writes (both logs) — the log bytes a tick must move, for the
    kernel's memory bound."""
    check_flags(flags)
    N, C, maj = cfg.n_nodes, cfg.phys_capacity, cfg.majority
    G = s["term"].shape[-1]
    dev = s["term"].device
    ldt = s["log_term"].dtype

    nd = {k: [s[k][i].to(_I32) for i in range(N)] for k in _INT_NODE}
    nd.update({k: [s[k][i] != 0 for i in range(N)] for k in _BOOL_NODE})
    pr = {k: [s[k][i].to(_I32) for i in range(N * N)]
          for k in ("next_index", "match_index")}
    pr.update({k: [s[k][i] != 0 for i in range(N * N)]
               for k in ("responded", "link_up")})
    lt = [s["log_term"][n * C:(n + 1) * C].to(_I32) for n in range(N)]
    lc = [s["log_cmd"][n * C:(n + 1) * C].to(_I32) for n in range(N)]
    dirty = [torch.zeros(G, dtype=torch.bool, device=dev) for _ in range(N)]
    zero = torch.zeros(G, dtype=_I32, device=dev)
    rd_t = rd_c = wm = None
    if touched is not None:
        rd_t, rd_c, wm = (torch.zeros((N * C, G), dtype=torch.bool,
                                      device=dev) for _ in range(3))
        touched.update(log_term_read=rd_t, log_cmd_read=rd_c, log_written=wm)

    def mark(plane, n, idx, need=None):
        # `touched` bookkeeping: plane[n*C + idx] |= need, for idx in range;
        # a read of a slot this tick already wrote needs no stored value.
        if plane is None:
            return
        ok = (idx >= 0) & (idx < C)
        if need is not None:
            ok = ok & need
        rows = (n * C + idx.clamp(0, C - 1)).long()[None]
        if plane is not wm:
            ok = ok & ~torch.gather(wm, 0, rows)[0]
        plane.scatter_(0, rows, (torch.gather(plane, 0, rows)[0] | ok)[None])

    def finish():
        for k in _INT_NODE + _BOOL_NODE:
            for i in range(N):
                s[k][i].copy_(nd[k][i])
        for k in pr:
            for i in range(N * N):
                s[k][i].copy_(pr[k][i])
        for n in range(N):
            s["log_term"][n * C:(n + 1) * C].copy_(lt[n])
            s["log_cmd"][n * C:(n + 1) * C].copy_(lc[n])
        return torch.stack(dirty)

    def pair(a, b):  # 0-based owner a, peer b
        return a * N + b

    def sel(mask, v, x):
        return torch.where(mask, v, x)

    def reset_timer(n, mask):
        # §7 deferral: a reset consumes one counted draw; phase 1 is
        # el_left's only reader, so only t_ctr moves now.
        nd["t_ctr"][n] = nd["t_ctr"][n] + mask.to(_I32)
        nd["el_armed"][n] = nd["el_armed"][n] | mask
        dirty[n] = dirty[n] | mask

    def log_read(store, idx):
        # Physical slot idx of one node's (C, G) log; 0 outside [0, C).
        ok = (idx >= 0) & (idx < C)
        v = torch.gather(store, 0, idx.clamp(0, C - 1).long()[None])[0]
        return torch.where(ok, v, zero)

    def log_write(store, slot, v, wr):
        sl = slot.clamp(0, C - 1).long()[None]
        cur = torch.gather(store, 0, sl)[0]
        new = torch.where(wr, v.to(ldt).to(_I32), cur)  # narrow at write
        store.scatter_(0, sl, new[None])

    def log_add(n, i, term_v, cmd_v, mask):
        # SEMANTICS.md §3 add(): append at the PHYSICAL end when
        # i == last_index and there is room (the ghost-append quirk writes
        # slot phys_len while last_index may point elsewhere), overwrite +
        # truncate when 0 <= i < last_index; a rejected append latches
        # cap_ov.
        li, pl = nd["last_index"][n], nd["phys_len"][n]
        has_room = pl < C
        app = (i == li) & has_room & mask
        ovw = (i < li) & (i >= 0) & mask
        cap_hit = mask & (i == li) & ~has_room
        nd["cap_ov"][n] = sel(cap_hit, nd["cap_ov"][n] | 1, nd["cap_ov"][n])
        wr = app | ovw
        slot = sel(app, pl, i)
        mark(wm, n, slot, wr)
        log_write(lt[n], slot, term_v, wr)
        log_write(lc[n], slot, cmd_v, wr)
        nd["last_index"][n] = sel(wr, i + 1, li)
        nd["phys_len"][n] = sel(app, pl + 1, pl)

    def refresh_last_term(n):
        # The lastLogTerm cache is log_term[last_index - 1] (0 for an empty
        # log: slot -1 reads as 0) — a LOG read, never an accumulated value,
        # because a ghost append leaves last_index pointing elsewhere.
        mark(rd_t, n, nd["last_index"][n] - 1)
        nd["last_term"][n] = log_read(lt[n], nd["last_index"][n] - 1)

    # -- phase F: fault events (SEMANTICS.md §9) ----------------------------
    if flags.faults:
        for n in range(N):
            up = nd["up"][n]
            crash_ev = up & (aux["crash_m"][n] != 0)
            rst = ~up & (aux["restart_m"][n] != 0)
            nd["up"][n] = (up & ~crash_ev) | rst
            for k, v in (("term", 0), ("voted_for", -1), ("role", FOLLOWER),
                         ("commit", 0), ("last_index", 0), ("phys_len", 0),
                         ("round_state", IDLE), ("votes", 0),
                         ("responses", 0), ("round_left", 0),
                         ("round_age", 0), ("bo_left", 0), ("last_term", 0),
                         ("hb_left", 0)):
                nd[k][n] = sel(rst, v, nd[k][n])
            for b in range(N):
                pi = pair(n, b)
                pr["responded"][pi] = pr["responded"][pi] & ~rst
                pr["next_index"][pi] = sel(rst, 0, pr["next_index"][pi])
                pr["match_index"][pi] = sel(rst, 0, pr["match_index"][pi])
            nd["hb_armed"][n] = nd["hb_armed"][n] & ~rst
            # Immediate reset: el_draw_f is the draw at pre-tick t_ctr.
            nd["el_left"][n] = sel(rst, aux["el_draw_f"][n].to(_I32),
                                   nd["el_left"][n])
            nd["el_armed"][n] = nd["el_armed"][n] | rst
            nd["t_ctr"][n] = nd["t_ctr"][n] + rst.to(_I32)
    if flags.links:
        for pi in range(N * N):
            lu = pr["link_up"][pi]
            pr["link_up"][pi] = sel(lu, aux["link_fail"][pi] == 0,
                                    aux["link_heal"][pi] != 0)

    # Effective edge health (§9): iid survival ∧ link health ∧ both ends up —
    # all fixed after phase F.
    eok = [[(aux["edge_iid"][pair(a, b)] != 0) & pr["link_up"][pair(a, b)]
            & nd["up"][a] & nd["up"][b] for b in range(N)] for a in range(N)]

    # -- phase 0: command injection (quirk k) -------------------------------
    if flags.periodic:
        n = cfg.cmd_node - 1
        cmd = aux["periodic"][0].to(_I32)
        log_add(n, nd["last_index"][n], nd["term"][n], cmd,
                (cmd >= 0) & nd["up"][n])
    if flags.inject:
        for n in range(N):
            cmd = aux["inject"][n].to(_I32)
            log_add(n, nd["last_index"][n], nd["term"][n], cmd,
                    (cmd >= 0) & nd["up"][n])
    # lastLogTerm cache refresh for the nodes phase 0 may have appended to.
    if flags.inject:
        for n in range(N):
            refresh_last_term(n)
    elif flags.periodic:
        refresh_last_term(cfg.cmd_node - 1)
    if cut is not None and cut < 1:
        return finish()

    # -- phase 1: timers (independent countdowns) ---------------------------
    start_round = []
    for n in range(N):
        up = nd["up"][n]
        armed = nd["el_armed"][n] & up
        left = nd["el_left"][n] - armed.to(_I32)
        fire = armed & (left <= 0)
        nd["el_left"][n] = left
        nd["el_armed"][n] = nd["el_armed"][n] & ~fire
        nd["role"][n] = sel(fire, CANDIDATE, nd["role"][n])
        in_bo = (nd["round_state"][n] == BACKOFF) & up
        bleft = nd["bo_left"][n] - in_bo.to(_I32)
        bfire = in_bo & (bleft <= 0)
        nd["bo_left"][n] = bleft
        nd["round_state"][n] = sel(bfire, IDLE, nd["round_state"][n])
        start_round.append(fire | bfire)
    if cut is not None and cut < 2:
        return finish()

    # -- phase 2: round starts ----------------------------------------------
    for n in range(N):
        is_cand = nd["role"][n] == CANDIDATE
        init = start_round[n] & is_cand
        nd["term"][n] = nd["term"][n] + init.to(_I32)
        nd["voted_for"][n] = sel(init, n + 1, nd["voted_for"][n])
        nd["votes"][n] = sel(init, 0, nd["votes"][n])
        nd["responses"][n] = sel(init, 0, nd["responses"][n])
        for b in range(N):
            pr["responded"][pair(n, b)] = pr["responded"][pair(n, b)] & ~init
        nd["round_left"][n] = sel(init, cfg.round_ticks, nd["round_left"][n])
        nd["round_age"][n] = sel(init, 0, nd["round_age"][n])
        nd["round_state"][n] = sel(init, ACTIVE, nd["round_state"][n])
        nd["rounds"][n] = nd["rounds"][n] + init.to(_I32)
        demoted = start_round[n] & ~is_cand
        nd["round_state"][n] = sel(demoted, IDLE, nd["round_state"][n])
        reset_timer(n, demoted)
    if cut is not None and cut < 3:
        return finish()

    # -- phase 3: vote exchanges (canonical (candidate, peer) order) ---------
    # Last-log position/term are invariant in phase 3 (no vote path touches
    # a log); last_term is the state-carried cache.
    lli = list(nd["last_index"])
    llt = list(nd["last_term"])
    for c in range(N):
        attempting = (nd["round_state"][c] == ACTIVE) & (
            torch.remainder(nd["round_age"][c], cfg.retry_ticks) == 0)
        for p in range(N):
            att = attempting & ~pr["responded"][pair(c, p)] \
                & eok[c][p] & eok[p][c]
            req_term = nd["term"][c]
            p_term = nd["term"][p]
            rej_stale = (lli[p] >= 1) & (llt[c] < llt[p])
            rej_short = (lli[p] >= 1) & (llt[c] == llt[p]) & (lli[c] < lli[p])
            grant_gt = (req_term > p_term) & ~(rej_stale | rej_short)
            granted = ((req_term == p_term) & (nd["voted_for"][p] == c + 1)) \
                | grant_gt
            adopt = att & grant_gt
            nd["term"][p] = sel(adopt, req_term, p_term)
            nd["voted_for"][p] = sel(adopt, c + 1, nd["voted_for"][p])
            nd["role"][p] = sel(adopt, FOLLOWER, nd["role"][p])
            reset_timer(p, adopt)
            resp_term = nd["term"][p]
            # Candidate tally (RaftServer.kt:209-211), against c's LIVE term.
            pr["responded"][pair(c, p)] = pr["responded"][pair(c, p)] | att
            nd["responses"][c] = nd["responses"][c] + att.to(_I32)
            nd["role"][c] = sel(att & (resp_term > nd["term"][c]), FOLLOWER,
                                nd["role"][c])  # quirk f
            nd["votes"][c] = nd["votes"][c] + (att & granted).to(_I32)
    if cut is not None and cut < 4:
        return finish()

    # -- phase 4: round conclusions -----------------------------------------
    for n in range(N):
        act = (nd["round_state"][n] == ACTIVE) & nd["up"][n]
        concl = act & ((nd["responses"][n] >= maj)
                       | (nd["round_left"][n] <= 0))
        is_cand = nd["role"][n] == CANDIDATE
        win = concl & is_cand & (nd["votes"][n] >= maj)
        lose = concl & is_cand & ~win
        dem = concl & ~is_cand
        nd["role"][n] = sel(win, LEADER, nd["role"][n])
        for b in range(N):  # quirk b
            pi = pair(n, b)
            pr["next_index"][pi] = sel(win, nd["commit"][n] + 1,
                                       pr["next_index"][pi])
            pr["match_index"][pi] = sel(win, 0, pr["match_index"][pi])
        nd["hb_armed"][n] = nd["hb_armed"][n] | win
        nd["hb_left"][n] = sel(win, 0, nd["hb_left"][n])  # initial delay 0
        nd["round_state"][n] = sel(win | dem, IDLE, nd["round_state"][n])
        nd["round_state"][n] = sel(lose, BACKOFF, nd["round_state"][n])
        nd["bo_left"][n] = sel(lose, aux["bdraw"][n].to(_I32),
                               nd["bo_left"][n])
        nd["b_ctr"][n] = nd["b_ctr"][n] + lose.to(_I32)
        reset_timer(n, dem)
        ongoing = act & ~concl
        nd["round_left"][n] = nd["round_left"][n] - ongoing.to(_I32)
        nd["round_age"][n] = nd["round_age"][n] + ongoing.to(_I32)
    if cut is not None and cut < 5:
        return finish()

    # -- phase 5: append / heartbeat (canonical (leader, peer) order) --------
    for l in range(N):
        raw_armed = nd["hb_armed"][l]
        armed = raw_armed & nd["up"][l]
        waiting = armed & (nd["hb_left"][l] > 0)
        fire = armed & ~waiting
        nd["hb_left"][l] = sel(waiting, nd["hb_left"][l] - 1, nd["hb_left"][l])
        # FOLLOWER cancels future firings, but this round still goes out
        # (TimerTask.cancel semantics, RaftServer.kt:117).
        l_is_f = nd["role"][l] == FOLLOWER
        nd["hb_armed"][l] = raw_armed & ~(fire & l_is_f)
        nd["hb_left"][l] = sel(fire & ~l_is_f, cfg.hb_ticks - 1,
                               nd["hb_left"][l])
        for p in range(N):
            pi = pair(l, p)
            li_l = nd["last_index"][l]
            i = pr["next_index"][pi]
            pli = i - 2
            # prevLogTerm of an invalid slot throws -> skip peer (§6).
            skip = (pli >= 0) & (pli >= li_l)
            plt = sel(pli >= 0, log_read(lt[l], pli), -1)
            has_entry = li_l >= i
            skip = skip | (has_entry & (i <= 0))  # quirk i underflow
            ent_t = log_read(lt[l], i - 1)
            ent_c = log_read(lc[l], i - 1)
            skip = skip | ~(eok[l][p] & eok[p][l])
            act5 = fire & ~skip
            req_term = nd["term"][l]
            req_commit = nd["commit"][l]
            # §6.2 handler on p.
            if p != l:
                adopt = act5 & (req_term > nd["term"][p])
                nd["term"][p] = sel(adopt, req_term, nd["term"][p])
                nd["voted_for"][p] = sel(adopt, -1, nd["voted_for"][p])
                nd["role"][p] = sel(act5, FOLLOWER, nd["role"][p])  # quirk d
                reset_timer(p, adopt)
                reset_timer(p, act5)
            p_li = nd["last_index"][p]
            cadv = act5 & (req_commit > nd["commit"][p])
            nd["commit"][p] = sel(cadv, torch.minimum(req_commit, p_li),
                                  nd["commit"][p])  # quirk e
            p_plt = log_read(lt[p], pli)
            succ = (pli == -1) | ((p_li > pli) & (pli >= 0) & (p_plt == plt))
            cmp = act5 & (pli >= 0) & (p_li > pli)  # both prevLog terms read
            mark(rd_t, l, pli, cmp)
            mark(rd_t, p, pli, cmp)
            ent = act5 & has_entry & succ
            mark(rd_t, l, i - 1, ent)
            mark(rd_c, l, i - 1, ent)
            log_add(p, pli + 1, ent_t, ent_c, ent)
            resp_term = nd["term"][p]
            # Leader processes the response (RaftServer.kt:146-168).
            if p != l:
                demote = act5 & (resp_term > nd["term"][l])
                nd["term"][l] = sel(demote, resp_term, nd["term"][l])
                nd["role"][l] = sel(demote, FOLLOWER, nd["role"][l])
                reset_timer(l, demote)
                proc = act5 & ~demote & succ
                nfail = act5 & ~demote & ~succ
            else:
                proc = act5 & succ
                nfail = act5 & ~succ
            with_e = proc & has_entry
            pr["next_index"][pi] = i + with_e.to(_I32) - nfail.to(_I32)
            mi = pr["match_index"][pi]
            pr["match_index"][pi] = sel(with_e, mi + 1,
                                        sel(proc & ~has_entry, pli + 1, mi))
            # Commit advancement (quirk a): #{q : match[q] > commit} >= maj.
            l_commit = nd["commit"][l]
            cnt = zero
            for q in range(N):
                cnt = cnt + (pr["match_index"][pair(l, q)] > l_commit).to(_I32)
            nd["commit"][l] = sel(with_e & (cnt >= maj), l_commit + 1,
                                  l_commit)

    # lastLogTerm cache, recomputed from the final log.
    for n in range(N):
        refresh_last_term(n)
    return finish()


def flatten_state(cfg: RaftConfig, state: RaftState) -> dict:
    """RaftState -> the rank-2 dict phase_body works on, as VIEWS of the
    state's tensors (phase_body's writes land in the state). Pair fields
    (N, N, G) -> (N*N, G), logs (N, C, G) -> (N*C, G); bool pair fields
    stay bool (the JAX package widens them to int16 — the values agree)."""
    N, C, G = cfg.n_nodes, cfg.phys_capacity, state.term.shape[-1]
    s = {}
    for k in STATE_FIELDS:
        v = getattr(state, k)
        if k in PAIR_FIELDS:
            v = v.view(N * N, G)
        elif k in LOG_FIELDS:
            v = v.view(N * C, G)
        s[k] = v
    return s


def unflatten_state(cfg: RaftConfig, s: dict) -> dict:
    """Inverse of flatten_state (a dict; add the tick to build RaftState)."""
    N, C = cfg.n_nodes, cfg.phys_capacity
    out = dict(s)
    for k in PAIR_FIELDS:
        out[k] = out[k].reshape(N, N, -1)
        if k in ("responded", "link_up"):
            out[k] = out[k] != 0
    for k in LOG_FIELDS:
        out[k] = out[k].reshape(N, C, -1)
    return out


def make_rng(cfg: RaftConfig, device="cuda"):
    """The per-simulation RNG operands: (base key words, timeout key words
    (N, G), backoff key words (N, G)) — the static key prefixes computed
    once, transposed to line up with the (N, G) counter grids."""
    check_supported(cfg)
    dev = require_device(device)
    base = rngmod.base_key(cfg.seed)
    G, N = cfg.n_groups, cfg.n_nodes
    tk = rngmod.grid_keys(base, rngmod.KIND_TIMEOUT, G, N, dev)
    bk = rngmod.grid_keys(base, rngmod.KIND_BACKOFF, G, N, dev)
    return (base, (tk[0].T.contiguous(), tk[1].T.contiguous()),
            (bk[0].T.contiguous(), bk[1].T.contiguous()))


def el_bounds(cfg: RaftConfig):
    """The election-timeout window every draw site uses (the boot draw, the
    phase-F restart redraw and the §7 materialization)."""
    return cfg.el_lo, cfg.el_hi


def make_aux(cfg: RaftConfig, base, tkeys, bkeys, state: RaftState,
             inject: Optional[torch.Tensor] = None,
             fault_cmd: Optional[torch.Tensor] = None):
    """Draw/assemble the phase_body aux inputs from the pre-tick state.
    Randomness is drawn in the canonical (G, ...) §4 shapes and transposed
    after, so no drawn bit depends on the groups-minor layout. `inject`
    ((G, N) int32, -1 = none) and `fault_cmd` ((G, N) int32: 0 none, 1
    crash, 2 restart) are the driver inputs in canonical orientation.
    Returns (aux dict, flags)."""
    G, N = cfg.n_groups, cfg.n_nodes
    dev = state.term.device
    t = int(state.tick)
    flags = make_flags(cfg, inject_present=inject is not None,
                       fault_present=fault_cmd is not None)
    check_flags(flags)

    def pairs(m):  # canonical (G, N, N) -> flat (N*N, G) int16
        return m.permute(1, 2, 0).reshape(N * N, G).to(torch.int16) \
            .contiguous()

    aux = {"edge_iid": pairs(rngmod.edge_ok_mask(base, t, (G, N, N),
                                                 cfg.p_drop, dev))}
    if flags.faults:
        crash = rngmod.event_mask(base, rngmod.KIND_CRASH, t, (G, N),
                                  cfg.p_crash, dev)
        restart = rngmod.event_mask(base, rngmod.KIND_RESTART, t, (G, N),
                                    cfg.p_restart, dev)
        if fault_cmd is not None:
            fault_cmd = fault_cmd.to(dev)
            crash = crash | (fault_cmd == 1)
            restart = restart | (fault_cmd == 2)
        aux["crash_m"] = crash.T.contiguous()
        aux["restart_m"] = restart.T.contiguous()
        aux["el_draw_f"] = rngmod.draw_uniform_keyed(
            tkeys, state.t_ctr, *el_bounds(cfg)).to(torch.int16)
    if flags.links:
        aux["link_fail"] = pairs(rngmod.event_mask(
            base, rngmod.KIND_LINK_FAIL, t, (G, N, N), cfg.p_link_fail, dev))
        aux["link_heal"] = pairs(rngmod.event_mask(
            base, rngmod.KIND_LINK_HEAL, t, (G, N, N), cfg.p_link_heal, dev))
    aux["bdraw"] = rngmod.draw_uniform_keyed(
        bkeys, state.b_ctr, cfg.bo_lo, cfg.bo_hi).to(torch.int16)
    if flags.periodic:
        due = t % cfg.cmd_period == 0 and t > 0
        aux["periodic"] = torch.full((1, G), t if due else -1, dtype=_I32,
                                     device=dev)
    if flags.inject:
        aux["inject"] = inject.to(device=dev, dtype=_I32).T.contiguous()
    return aux, flags


def materialize_el(cfg: RaftConfig, tkeys, s: dict,
                   el_dirty: torch.Tensor) -> None:
    """The SEMANTICS.md §7 deferred election draw, in place: el_left of a
    dirty node becomes the counted draw at t_ctr - 1 (the last counter the
    tick consumed)."""
    d = rngmod.draw_uniform_keyed(tkeys, s["t_ctr"].to(torch.int64) - 1,
                                  *el_bounds(cfg))
    s["el_left"].copy_(torch.where(el_dirty, d.to(s["el_left"].dtype),
                                   s["el_left"]))


def finish_tick(cfg: RaftConfig, tkeys, state: RaftState, s: dict,
                el_dirty: torch.Tensor) -> RaftState:
    """Materialize the deferred election draws and bump the tick counter."""
    materialize_el(cfg, tkeys, s, el_dirty)
    state.tick += 1
    return state


def make_stepper(cfg: RaftConfig, device, body):
    """tick(state, inject=None, fault_cmd=None) -> state around a lattice
    `body` (phase_body or the kernel wrapper), in place."""
    check_supported(cfg)
    check_flags(make_flags(cfg))
    dev = require_device(device)
    rng = make_rng(cfg, dev)

    def tick(state: RaftState, inject=None, fault_cmd=None) -> RaftState:
        if state.term.shape[-1] != cfg.n_groups:
            raise ValueError(f"state has {state.term.shape[-1]} groups but "
                             f"the tick was built for {cfg.n_groups}")
        base, tkeys, bkeys = rng
        aux, flags = make_aux(cfg, base, tkeys, bkeys, state, inject,
                              fault_cmd)
        s = flatten_state(cfg, state)
        el_dirty = body(cfg, s, aux, flags)
        return finish_tick(cfg, tkeys, state, s, el_dirty)

    return tick


def make_tick(cfg: RaftConfig, device="cuda"):
    """tick(state, inject=None, fault_cmd=None) -> state: one tick through
    the plain phase_body, updating `state` in place (and returning it)."""
    return make_stepper(cfg, device, phase_body)


TRACE_FIELDS = ("role", "term", "commit", "last_index", "voted_for",
                "rounds", "up")


def resolve_impl(impl: str, device: torch.device) -> str:
    """The tick backend make_run steps with: "kernel" or "plain"; "auto" is
    the kernel on cuda and plain on cpu."""
    if impl == "auto":
        return "kernel" if device.type == "cuda" else "plain"
    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    return impl


def make_run(cfg: RaftConfig, n_ticks: int, trace: bool = True,
             impl: str = "auto", telemetry: bool = False, device="cuda"):
    """Runner: state -> (state, ys[, telemetry]) stepping n_ticks, updating
    the state in place.

    ys is a dict of (T, N, G) tensors (TRACE_FIELDS, post-tick) when trace,
    else the per-tick (T, G) counts of role == LEADER (the JAX package's
    cheap mode). `impl`: "kernel" (ops/cuda_tick — the CUDA
    kernel for CUDA tensors, its plain version for CPU tensors), "plain"
    (phase_body), or "auto" = the kernel on cuda, plain on cpu.
    telemetry=True adds the flight recorder (utils/telemetry)."""
    if n_ticks < 1:
        raise ValueError(f"n_ticks must be >= 1, got {n_ticks}")
    dev = require_device(device)
    if resolve_impl(impl, dev) == "kernel":
        from raft_kotlin_tpu_torch.ops.cuda_tick import make_cuda_tick

        tick_fn = make_cuda_tick(cfg, dev)
    else:
        tick_fn = make_tick(cfg, dev)

    def run(state: RaftState):
        tel = telemetry_mod.telemetry_zeros(dev) if telemetry else None
        ys = []
        for _ in range(n_ticks):
            prev = telemetry_mod.state_view(state, clone=True) \
                if telemetry else None
            tick_fn(state)
            if telemetry:
                tel = telemetry_mod.telemetry_step_arrays(
                    prev, telemetry_mod.state_view(state), tel)
            if trace:
                ys.append({k: getattr(state, k).clone() for k in TRACE_FIELDS})
            else:
                ys.append((state.role == LEADER).sum(0, dtype=_I32))
        if trace:
            out = {k: torch.stack([y[k] for y in ys]) for k in TRACE_FIELDS}
        else:
            out = torch.stack(ys)
        return (state, out, tel) if telemetry else (state, out)

    return run
