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

Deep-log configs (`phys_capacity >= 256`: flag `dyn_log`) run one of the
JAX package's two deep engines inside the same lattice:

- the batched engine (`batched`, the default): every log write is deferred
  to the end of the tick and applied in one scatter, every phase-5 log
  read comes from one batched gather up front, overlaid with the writes
  made since. The gather and the scatter are the two kernels of that path
  (ops/deep_gather, ops/deep_scatter); the lattice around them stays plain
  PyTorch, as the JAX package keeps it in XLA. With `phase_body(fcache=)`
  the lattice reads phase 5's rows from the frontier-value cache instead
  of the gather (ops/deep_cache, whose make_deep_scan runs it); the
  scatter stays;
- the per-pair engine (`batched` off: make_tick / make_run(batched=False),
  and every τ=0 mailbox config): each read and write goes to the stored
  logs at once, one torch.gather / scatter_ of a (G,) row on a node's
  (C, G) view — the JAX package's take_along_axis / put_along_axis, in
  XLA there. It is the shallow lattice itself.

`make_deep_tick` steps either with the kernels.

The §10 mailbox (`flags.delay`) runs the JAX package's lattice of
capacity-1 in-flight slots: each (owner, peer) pair first delivers the
slot an earlier tick filled (the response leg is taken at the delivery
tick; a failed leg voids the whole exchange), then sends; the countdowns
advance once, after every phase. At delay_lo == 0 a pair's fresh send can
be delivered in the same iteration (the τ=0 regime). On deep logs the
batched engine runs it in the known-delivery regime (delay_lo >= 1), where
every delivery's reads are known at the tick's start: its batch widens to
6N+1 term rows and 3N cmd rows a node (see phase_body).

The port updates a state IN PLACE (the JAX package's states are immutable):
at the headline shape a second copy of the state is ~170 MB of traffic per
tick, at the deep config 28.7 GB. `make_run` clones what its trace and
recorder need.

§18 packed compute (`flags.packed_compute`) runs the vote-exchange set
as two words a node, responded_bits and vote_bits, with popcount quorums
(models/state.enter_packed_compute gives the lattice that form), around
any engine. `make_run(layout="packed")` carries the §14 packed layout
between ticks (models/state.pack_state).

§15 log compaction and the §16 ring window (`flags.compact`) route every
log access through one translate-or-latch map: a position's ring slot is
pos mod phys_capacity (C-style truncation, so a negative position stays
negative and matches no row) and a position is readable only inside the
node's live window [snap_index, snap_index + C), with position
snap_index - 1 reading snap_term. Appends test the live window for room,
overwrites below the base are absorbed, phase 5 sends InstallSnapshot
where a peer's frontier fell to or below the leader's base (synchronous,
or through the §10 slot with aq_hase == 2 under the mailbox, where the
per-pair engine runs), and phase C folds up to compact_chunk committed
entries a node into its snapshot at the tick's end. The batched engine's
takes address ring slots, while its tick-end ghost overlay compares
positions (two positions can share a slot).
"""

from __future__ import annotations

import dataclasses
import functools
import types
from typing import Optional

import torch

from raft_kotlin_tpu_torch.constants import (
    ACTIVE, BACKOFF, CANDIDATE, FOLLOWER, IDLE, LEADER)
from raft_kotlin_tpu_torch.models.state import (
    LOG_FIELDS, MAILBOX_FIELDS, PAIR_FIELDS, SNAPSHOT_FIELDS, RaftState,
    check_packed_ov, check_supported, enter_packed_compute,
    exit_packed_compute, fold_digest, pack_fields, pack_state, popcount32,
    require_device, unpack_fields, unpack_state)
from raft_kotlin_tpu_torch.ops import deep_gather, deep_scatter
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
    "delay",      # (N*N, G) i16 — §10 per-pair send delays (only if lo < hi)
)


# Node fields the lattice reads as int32 / as bool.
_INT_NODE = ("term", "voted_for", "role", "commit", "last_index", "phys_len",
             "last_term", "el_left", "round_state", "round_left", "round_age",
             "votes", "responses", "bo_left", "hb_left", "t_ctr", "b_ctr",
             "rounds", "cap_ov")
_BOOL_NODE = ("el_armed", "hb_armed", "up")


@dataclasses.dataclass(frozen=True)
class BodyFlags:
    """Static switches: which optional phases the tick includes. `delay`
    compiles in the §10 mailbox; `dyn_log` marks a deep log, `batched`
    selects the deep-log batched engine (without it the per-pair one);
    `packed_compute` the §18 vote-exchange words (the state dict then
    carries responded_bits / vote_bits in place of responded / votes /
    responses); `compact` the §15 compaction lattice (the ring translate,
    InstallSnapshot and the phase-C fold)."""
    faults: bool = False
    links: bool = False
    periodic: bool = False
    inject: bool = False
    delay: bool = False
    dyn_log: bool = False
    batched: bool = False
    compact: bool = False
    packed_compute: bool = False


def check_flags(flags: BodyFlags) -> None:
    """The flag combinations the lattice runs (the JAX package's asserts):
    under compaction the mailbox keeps the per-pair engine."""
    if flags.compact and flags.batched and flags.delay:
        raise ValueError(
            "mailbox compaction configs keep the per-pair engine: an "
            "InstallSnapshot delivery jumps next_index, breaking the "
            "known-delivery batched row-window invariant (SEMANTICS.md §15)")


def check_shallow(flags: BodyFlags) -> None:
    """The tick kernels and the fused runner take the shallow lattice only;
    a deep-log config runs a deep engine (make_deep_tick)."""
    check_flags(flags)
    if flags.dyn_log:
        raise NotImplementedError(
            "deep-log configs (phys_capacity >= 256) run the deep engines "
            "(with the deep gather / scatter kernels), not the tick kernels")


def make_flags(cfg: RaftConfig, inject_present: bool = False,
               fault_present: bool = False,
               batched: Optional[bool] = None) -> BodyFlags:
    """The BodyFlags a tick over `cfg` runs with (the JAX package's
    make_flags on the configs the port supports). A §12 scenario bank
    compiles the fault / link phases in when its spec carries those
    channels. A deep log takes the batched engine unless `batched` is
    False; under the mailbox only in the known-delivery regime (delay_lo
    >= 1) and without compaction — τ=0 pins the per-pair engine even when
    `batched` is True, as the JAX package's rule does."""
    dyn = cfg.uses_dyn_log
    spec = cfg.scenario
    return BodyFlags(
        faults=cfg.p_crash > 0 or cfg.p_restart > 0 or fault_present
        or (spec is not None and spec.has_faults),
        links=cfg.p_link_fail > 0 or cfg.p_link_heal > 0
        or (spec is not None and spec.has_links),
        periodic=cfg.cmd_period > 0,
        inject=inject_present,
        delay=cfg.uses_mailbox,
        dyn_log=dyn,
        batched=dyn and (not cfg.uses_mailbox or cfg.known_delivery)
        and not (cfg.uses_mailbox and cfg.uses_compaction)
        and batched is not False,
        compact=cfg.uses_compaction,
    )


def phase_body(cfg: RaftConfig, s: dict, aux: dict, flags: BodyFlags,
               cut: Optional[int] = None,
               touched: Optional[dict] = None, gather=None,
               scatter=None, track: Optional[dict] = None,
               fcache: Optional[dict] = None) -> torch.Tensor:
    """Advance the phase lattice F, 0-5 one tick, updating `s` in place.

    `s` maps STATE_FIELDS to rank-2 tensors (see flatten_state): (N, G) node
    grids, (N*N, G) pair grids (row (a-1)*N + b-1; bool or int 0/1), (N*C, G)
    logs (row (n-1)*C + slot). Values are read widened to int32 and written
    back in each tensor's own dtype (narrowing wraps, as `astype` does).
    Outside the batched engine the logs are read and written in place, one
    (G,) row of a node's (C, G) view at a time, so a read after a write in
    the same tick sees the stored (narrowed) value and no log-sized
    temporary is made. `aux` maps AUX_FIELDS to tensors (only the enabled
    ones are read).
    Returns el_dirty (N, G) bool: nodes whose election timer reset in phases
    2-5; the caller materializes their el_left as the draw at t_ctr - 1
    (SEMANTICS.md §7 — el_left's only reader is phase 1).

    `cut` stops the lattice after phase `cut` (0 = phases F and 0), for
    phase-by-phase comparison; None runs the whole tick.

    `touched`, when given, receives three (N*C, G) bool masks of log slots:
    "log_term_read" and "log_cmd_read", the slots whose stored value the
    tick needs (read before this tick writes them), and "log_written", the
    slots it writes (both logs) — the log bytes a tick must move, for the
    kernel's memory bound. Under the mailbox it also receives "mail":
    lanes counted per tick of vote / append deliveries that read a slot's
    payload ("vote_read", "append_read") and of sends that write one
    ("vote_sent", "append_sent").

    Under flags.batched (deep logs) log writes are deferred (a pending list
    per node, replayed by patch() onto every later read) and applied at the
    tick's end by `scatter`; the phase-5 reads come from one `gather` after
    phase 4. `gather` / `scatter` take the ops/deep_gather.gather /
    ops/deep_scatter.scatter arguments; None means their plain versions.
    `cut`, `touched` and `track` are shallow-only (both deep engines
    refuse them).

    `track`, when given, is the write tracking of the fused
    kernel's in-kernel monitor, as its log_put does it: (N*C, G) masks
    "written" (slots this tick wrote) and "changed" (slots whose stored
    value now differs from the tick's start), and int32 "start_term" /
    "start_cmd" holding each written slot's tick-start value, kept at its
    first write — so a slot written twice, or written back with its old
    value, ends as the full comparison of the two logs gives it. The caller
    zeroes the masks before the tick.

    Under flags.packed_compute (§18) `s` carries responded_bits and
    vote_bits ((N, G) int32 words, models/state.enter_packed_compute) in
    place of responded, votes and responses: an exchange ORs bit p-1 into
    the candidate's words, and phase 4 compares their popcounts.

    `fcache` (batched engine only; ops/deep_cache.py) is the frontier-value
    cache, the JAX package's `phase_body(fcache=)`: phase 5 reads the
    cached frontier values, topped up by one budgeted take per log array
    (deep_cache.TERM_BUDGET / CMD_BUDGET rows a lane), in place of the
    batched gather, which it never calls; every deferred write patches the
    entries it hits, the exchanges shift them, last_term is kept live. The
    dict is replaced entry by entry and gains "ov", (G,) bool: True where a
    value the tick needed was not in the cache (a budget overflow or a
    consumed-invalid entry) — that tick's bits are then not the plain
    engine's and the caller reruns without the cache.
    """
    check_flags(flags)
    N, C, maj = cfg.n_nodes, cfg.phys_capacity, cfg.majority
    G = s["term"].shape[-1]
    dev = s["term"].device
    ldt = s["log_term"].dtype
    batched = flags.batched
    pc = flags.packed_compute
    if flags.dyn_log and (cut is not None or touched is not None
                          or track is not None):
        raise ValueError("cut, touched and track apply to the shallow "
                         "lattice only")
    if batched and flags.delay and not cfg.known_delivery:
        raise ValueError("the batched engine under the mailbox needs the "
                         "known-delivery regime (delay_lo >= 1); τ=0 "
                         "configs keep the per-pair engine")
    use_fc = fcache is not None
    if use_fc and not batched:
        raise ValueError("fcache applies to the batched deep engine only "
                         "(flags.batched)")
    compact = flags.compact
    if compact and use_fc:
        raise ValueError("the frontier-cache engine does not support §15 "
                         "compaction")

    # The vote-exchange set: two words a node (§18), or the tallies and the
    # responded pair plane.
    int_node = tuple(k for k in _INT_NODE
                     if not (pc and k in ("votes", "responses"))) + (
        ("responded_bits", "vote_bits") if pc else ()) + (
        SNAPSHOT_FIELDS if compact else ())
    nd = {k: [s[k][i].to(_I32) for i in range(N)] for k in int_node}
    nd.update({k: [s[k][i] != 0 for i in range(N)] for k in _BOOL_NODE})
    pr = {k: [s[k][i].to(_I32) for i in range(N * N)]
          for k in ("next_index", "match_index")}
    pr.update({k: [s[k][i] != 0 for i in range(N * N)]
               for k in (("link_up",) if pc else ("responded", "link_up"))})
    # §10 mailbox slots, widened like the pair fields.
    mb = {k: [s[k][i].to(_I32) for i in range(N * N)]
          for k in MAILBOX_FIELDS} if flags.delay else {}
    if batched:
        # pending[n]: node n's deferred writes in the order they were made,
        # (row (G,) — C where masked —, term, cmd, write mask), values
        # already round-tripped through the log dtype, so a read patched
        # from them sees what the store will hold.
        lt = lc = None
        pending = [[] for _ in range(N)]
    else:
        # Each node's (C, G) slots: views of the stored logs.
        lt = [s["log_term"][n * C:(n + 1) * C] for n in range(N)]
        lc = [s["log_cmd"][n * C:(n + 1) * C] for n in range(N)]
    dirty = [torch.zeros(G, dtype=torch.bool, device=dev) for _ in range(N)]
    zero = torch.zeros(G, dtype=_I32, device=dev)
    rd_t = rd_c = wm = None
    if touched is not None:
        rd_t, rd_c, wm = (torch.zeros((N * C, G), dtype=torch.bool,
                                      device=dev) for _ in range(3))
        touched.update(log_term_read=rd_t, log_cmd_read=rd_c, log_written=wm)
        if flags.delay:
            touched["mail"] = dict.fromkeys(
                ("vote_read", "append_read", "vote_sent", "append_sent"), 0)

    def tally(key, mask):
        # `touched` bookkeeping of the mailbox slots a tick reads and writes.
        if touched is not None:
            touched["mail"][key] += int(mask.sum())

    def mark(plane, n, idx, need=None):
        # `touched` bookkeeping: plane[n*C + idx] |= need, for idx in range;
        # a read of a slot this tick already wrote needs no stored value.
        if plane is None:
            return
        if compact:  # a position: its ring slot, inside the live window
            ok = win_ok(n, idx)
            idx = ring(idx.clamp(min=0))
        else:
            ok = (idx >= 0) & (idx < C)
        if need is not None:
            ok = ok & need
        rows = (n * C + idx.clamp(0, C - 1)).long()[None]
        if plane is not wm:
            ok = ok & ~torch.gather(wm, 0, rows)[0]
        plane.scatter_(0, rows, (torch.gather(plane, 0, rows)[0] | ok)[None])

    def finish():
        for k in int_node + _BOOL_NODE:
            for i in range(N):
                s[k][i].copy_(nd[k][i])
        for grid in (pr, mb):
            for k in grid:
                for i in range(N * N):
                    s[k][i].copy_(grid[k][i])
        return torch.stack(dirty)

    def pair(a, b):  # 0-based owner a, peer b
        return a * N + b

    if use_fc:
        from raft_kotlin_tpu_torch.ops import deep_cache

        W_T = deep_cache.W_TOP
        # The cache as per-row lists (a (G,) update replaces one entry),
        # restacked into the caller's dict at the end.
        fc_fields = deep_cache.fields_for(flags.delay)
        fcl = {k: list(fcache[k].unbind(0)) for k in fc_fields}
        fc_ov = torch.zeros(G, dtype=torch.bool, device=dev)
        no = torch.zeros(G, dtype=torch.bool, device=dev)

        def fc_patch_write(n, wr, slot, tv, cv):
            # A deferred write of (tv, cv) (stored values) at node n's
            # position `slot` (mask wr) sets every entry whose (log, row)
            # it hits, value and validity.
            for q in range(n * N, (n + 1) * N):  # n's own pairs
                niq = pr["next_index"][q]
                hit2 = wr & (slot == niq - 2)
                hit1 = wr & (slot == niq - 1)
                for key, hit, val in (("f_pli", hit2, tv),
                                      ("f_ent_t", hit1, tv),
                                      ("f_ent_c", hit1, cv)):
                    okk = deep_cache.ok_name(key)
                    fcl[key][q] = sel(hit, val, fcl[key][q])
                    fcl[okk][q] = fcl[okk][q] | hit
            for l2 in range(N):  # pairs where n is the peer
                q = pair(l2, n)
                hit = wr & (slot == pr["next_index"][q] - 2)
                fcl["f_ppli"][q] = sel(hit, tv, fcl["f_ppli"][q])
                fcl["ok_ppli"][q] = fcl["ok_ppli"][q] | hit

        def fc_log_add(n, wr, app, slot, li, i, tv, cv):
            # log_add's cache upkeep (before last_index moves): patch the
            # entries the write hits, keep last_term live (§3: a GHOST
            # append — slot phys_len != last_index — leaves the new
            # last_term row at its stale stored value, the top window's
            # base row; an invalid base raises ov), and realign the top
            # window to the new last_index i + 1: an append shifts it down
            # one (its top row unknown), an overwrite invalidates it; this
            # write lands where it falls inside; rows >= C read 0.
            nonlocal fc_ov
            fc_patch_write(n, wr, slot, tv, cv)
            tw = n * W_T
            ghost = wr & app & (slot != li)
            fc_ov = fc_ov | (ghost & ~fcl["ok_topw"][tw])
            nd["last_term"][n] = sel(wr, sel(ghost, fcl["f_topw"][tw], tv),
                                     nd["last_term"][n])
            old_w = fcl["f_topw"][tw:tw + W_T]
            old_ok = fcl["ok_topw"][tw:tw + W_T]
            for j in range(W_T):
                sh_v = old_w[j + 1] if j + 1 < W_T else zero
                sh_ok = old_ok[j + 1] if j + 1 < W_T else no
                row_j = i + 1 + j
                hit = slot == row_j
                oob = row_j >= C
                v = sel(oob, 0, sel(hit, tv, sel(app, sh_v, zero)))
                ok = (app & sh_ok) | hit | oob
                fcl["f_topw"][tw + j] = sel(wr, v, old_w[j])
                fcl["ok_topw"][tw + j] = sel(wr, ok, old_ok[j])

        def fc_refill(entries, gate, budget, log, vi):
            # One budgeted take from a log array: a lane's asking entries
            # ranked in order (an exclusive count), the first `budget`
            # read at one row each — the rest land on a spare row —,
            # overlaid with this tick's pending writes (the take reads the
            # stored log; pending value vi: 1 term, 2 cmd). Returns the
            # lanes where a hard entry (all precede the soft ones) went
            # unserved.
            g32 = gate.to(_I32)
            rank = torch.cumsum(g32, 0) - g32
            got = gate & (rank < budget)
            slot = torch.where(got, rank, budget).long()
            want = torch.stack([n * C + row.clamp(0, C - 1)
                                for _, _, n, row, _, _ in entries]).long()
            rows = torch.zeros((budget + 1, G), dtype=torch.int64,
                               device=dev).scatter_(0, slot, want)[:budget]
            vals = torch.gather(log, 0, rows).to(_I32)
            for n in range(N):
                for w in pending[n]:
                    hit = w[3][None] & (rows == n * C + w[0][None])
                    vals = torch.where(hit, w[vi][None], vals)
            v = torch.gather(torch.cat([vals, vals.new_zeros((1, G))]), 0,
                             slot)
            keys = [(e[4], e[5]) for e in entries]
            cur = torch.stack([fcl[k][ix] for k, ix in keys])
            cur_ok = torch.stack([fcl[deep_cache.ok_name(k)][ix]
                                  for k, ix in keys])
            for (k, ix), nv, nok in zip(keys, torch.where(got, v, cur),
                                        cur_ok | got):
                fcl[k][ix] = nv
                fcl[deep_cache.ok_name(k)][ix] = nok
            hard = sum(e[1] for e in entries)
            return (gate[:hard] & ~got[:hard]).any(0)

        def fc_shift(pi, adv, rec, wrote, ent_w):
            # The exchange moved next_index by +1 (adv) or -1 (rec):
            # re-point the pair's entries, every old value read first. On
            # +1 the new entry row is unknown until a write lands there,
            # and the peer's prevLog row is what the exchange just wrote
            # (unknown after a §3 ghost write elsewhere); on -1 each
            # shift exposes an unknown row.
            o = {k: fcl[k][pi] for k in deep_cache.PAIR_VALS
                 + tuple(map(deep_cache.ok_name, deep_cache.PAIR_VALS))}
            for key, adv_v, adv_ok, rec_v, rec_ok in (
                    ("f_pli", o["f_ent_t"], o["ok_ent_t"], zero, no),
                    ("f_ent_t", zero, no, o["f_pli"], o["ok_pli"]),
                    ("f_ent_c", zero, no, zero, no),
                    ("f_ppli", sel(wrote, ent_w, zero), wrote, zero, no)):
                okk = deep_cache.ok_name(key)
                fcl[key][pi] = sel(adv, adv_v, sel(rec, rec_v, o[key]))
                fcl[okk][pi] = sel(adv, adv_ok, sel(rec, rec_ok, o[okk]))

    def responded(c, p):  # pair (c, p) exchanged this round
        if pc:
            return ((nd["responded_bits"][c] >> p) & 1) != 0
        return pr["responded"][pair(c, p)]

    # The round's exchange set, cleared where `mask` (a restart, a round
    # start): one select per word under §18.
    vote_set = (("responded_bits", "vote_bits") if pc
                else ("votes", "responses"))

    def clear_votes(n, mask):
        for k in vote_set:
            nd[k][n] = sel(mask, 0, nd[k][n])
        if not pc:
            for b in range(N):
                pr["responded"][pair(n, b)] = \
                    pr["responded"][pair(n, b)] & ~mask

    def sel(mask, v, x):
        return torch.where(mask, v, x)

    def reset_timer(n, mask):
        # §7 deferral: a reset consumes one counted draw; phase 1 is
        # el_left's only reader, so only t_ctr moves now.
        nd["t_ctr"][n] = nd["t_ctr"][n] + mask.to(_I32)
        nd["el_armed"][n] = nd["el_armed"][n] | mask
        dirty[n] = dirty[n] | mask

    def log_read(store, idx):
        # Physical slot idx of one node's (C, G) log, widened; 0 outside
        # [0, C).
        ok = (idx >= 0) & (idx < C)
        v = torch.gather(store, 0, idx.clamp(0, C - 1).long()[None])[0]
        return torch.where(ok, v.to(_I32), zero)

    def ring(pos):
        # §15 ring slot of a position: C-style truncation (torch.fmod), so a
        # negative position stays negative and matches no row.
        return torch.fmod(pos, C)

    def win_ok(n, idx):
        # The translate-or-latch window test: positions below node n's
        # snapshot base are folded, those at or above base + C would alias
        # a live slot.
        b = nd["snap_index"][n]
        return (idx >= b) & (idx < b + C)

    def node_read(n, idx, cmd=False, store=None):
        # Node n's log at position idx (a physical slot without compaction;
        # 0 outside [0, C), or outside the live window under §15). `store`:
        # the node's (C, G) rows where lt / lc are not set (batched).
        if store is None:
            store = (lc if cmd else lt)[n]
        if not compact:
            return log_read(store, idx)
        v = torch.gather(store, 0, ring(idx.clamp(min=0)).long()[None])[0]
        return torch.where(win_ok(n, idx), v.to(_I32), zero)

    def term_b(n, idx, store=None):
        # log_term at position idx with the §15 snapshot boundary: position
        # snap_index - 1 reads snap_term.
        v = node_read(n, idx, store=store)
        if compact:
            v = sel(idx == nd["snap_index"][n] - 1, nd["snap_term"][n], v)
        return v

    def rt(v):
        # A value as the log stores it (narrowing wraps), widened again.
        return v.to(ldt).to(_I32)

    def bounded(idx, v, n=None):
        # A batched read (rows clipped to [0, C)) with the out-of-[0, C)
        # => 0 convention of log_read; under §15 with the owning node given,
        # its live-window test instead.
        if compact and n is not None:
            return sel(win_ok(n, idx), v, zero)
        return sel((idx >= 0) & (idx < C), v, zero)

    def patch(cmd, n, row, v):
        # Overlay node n's pending writes, oldest first, onto a stored
        # value read at `row`: what a read after those writes sees.
        for prow_, pt, pc, pwr in pending[n]:
            v = sel(pwr & (prow_ == row), pc if cmd else pt, v)
        return v

    def log_write(store, slot, v, wr):
        sl = slot.clamp(0, C - 1).long()[None]
        cur = torch.gather(store, 0, sl)[0]
        store.scatter_(0, sl, torch.where(wr, v.to(ldt), cur)[None])

    def track_write(n, slot, term_v, cmd_v, wr):
        # The kernel's log_put tracking: a slot's tick-start value is kept
        # at its first write; each write sets the slot's changed bit to
        # whether the value it stores differs from that start value.
        rows = slice(n * C, (n + 1) * C)
        sl = slot.clamp(0, C - 1).long()[None]

        def at(t):
            return torch.gather(t, 0, sl)[0]

        def put(t, v):
            t.scatter_(0, sl, v[None])

        wr_n, ch_n = track["written"][rows], track["changed"][rows]
        st_t, st_c = track["start_term"][rows], track["start_cmd"][rows]
        first = wr & ~at(wr_n)
        t0 = sel(first, at(lt[n]).to(_I32), at(st_t))
        c0 = sel(first, at(lc[n]).to(_I32), at(st_c))
        put(st_t, t0)
        put(st_c, c0)
        diff = (rt(term_v) != t0) | (rt(cmd_v) != c0)
        put(ch_n, sel(wr, diff, at(ch_n)))
        put(wr_n, at(wr_n) | wr)

    def log_add(n, i, term_v, cmd_v, mask):
        # SEMANTICS.md §3 add(): append at the PHYSICAL end when
        # i == last_index and there is room (the ghost-append quirk writes
        # slot phys_len while last_index may point elsewhere), overwrite +
        # truncate when 0 <= i < last_index; a rejected append latches
        # cap_ov.
        li, pl = nd["last_index"][n], nd["phys_len"][n]
        if compact:
            # §15: the capacity clip tests the live window phys_len - base,
            # and a write below the base is absorbed (already folded: no
            # write, no last_index move, no capacity test).
            b = nd["snap_index"][n]
            has_room = (pl - b) < C
            inwin = i >= b
            app = (i == li) & inwin & has_room & mask
            ovw = (i < li) & inwin & mask
            cap_hit = mask & (i == li) & ~has_room & inwin
        else:
            has_room = pl < C
            app = (i == li) & has_room & mask
            ovw = (i < li) & (i >= 0) & mask
            cap_hit = mask & (i == li) & ~has_room
        nd["cap_ov"][n] = sel(cap_hit, nd["cap_ov"][n] | 1, nd["cap_ov"][n])
        wr = app | ovw
        slot = sel(app, pl, i)  # a position (== the slot without §15)
        row = ring(slot.clamp(min=0)) if compact else slot
        if batched:
            # Deferred: masked lanes carry row C, which the scatter drops
            # and no read row (< C) matches.
            pending[n].append((sel(wr, row.clamp(0, C - 1), C),
                               rt(term_v), rt(cmd_v), wr))
            if use_fc:
                fc_log_add(n, wr, app, slot, li, i, *pending[n][-1][1:3])
        else:
            mark(wm, n, slot, wr)
            if track is not None:
                track_write(n, row, term_v, cmd_v, wr)
            log_write(lt[n], row, term_v, wr)
            log_write(lc[n], row, cmd_v, wr)
        nd["last_index"][n] = sel(wr, i + 1, li)
        nd["phys_len"][n] = sel(app, pl + 1, pl)
        return wr, slot

    def refresh_last_term(n):
        # The lastLogTerm cache is log_term[last_index - 1] (0 for an empty
        # log: slot -1 reads as 0) — a LOG read, never an accumulated value,
        # because a ghost append leaves last_index pointing elsewhere.
        li = nd["last_index"][n]
        if batched:
            # The stored (pre-tick) row, overlaid with this tick's writes;
            # under §15 a fully folded window (li == base) reads snap_term.
            raw = node_read(n, li - 1, store=s["log_term"][n * C:(n + 1) * C])
            raw = patch(False, n, ring((li - 1).clamp(min=0)) if compact
                        else (li - 1).clamp(0, C - 1), raw)
            if compact:
                raw = sel(li == nd["snap_index"][n], nd["snap_term"][n], raw)
            nd["last_term"][n] = sel(li >= 1, raw, zero)
            return
        mark(rd_t, n, li - 1)
        if compact:
            nd["last_term"][n] = sel(li >= 1, term_b(n, li - 1), zero)
        else:
            nd["last_term"][n] = log_read(lt[n], li - 1)

    # -- phase F: fault events (SEMANTICS.md §9) ----------------------------
    if flags.faults:
        for n in range(N):
            up = nd["up"][n]
            crash_ev = up & (aux["crash_m"][n] != 0)
            rst = ~up & (aux["restart_m"][n] != 0)
            nd["up"][n] = (up & ~crash_ev) | rst
            for k, v in (("term", 0), ("voted_for", -1), ("role", FOLLOWER),
                         ("commit", 0), ("last_index", 0), ("phys_len", 0),
                         ("round_state", IDLE), ("round_left", 0),
                         ("round_age", 0), ("bo_left", 0), ("last_term", 0),
                         ("hb_left", 0)):
                nd[k][n] = sel(rst, v, nd[k][n])
            clear_votes(n, rst)
            for b in range(N):
                pi = pair(n, b)
                pr["next_index"][pi] = sel(rst, 0, pr["next_index"][pi])
                pr["match_index"][pi] = sel(rst, 0, pr["match_index"][pi])
            nd["hb_armed"][n] = nd["hb_armed"][n] & ~rst
            if compact:
                # §15: a restart wipes the snapshot too (the node rejoins
                # empty and catches up by InstallSnapshot); cap_ov stays.
                for k in SNAPSHOT_FIELDS:
                    nd[k][n] = sel(rst, 0, nd[k][n])
            if use_fc:
                # The node's own pair frontiers go to 0: their rows -2 / -1
                # read 0, so those entries become 0 and valid. Its stored
                # log is untouched (a logical wipe), so entries where it is
                # the peer stay; its top window's base row is unknown.
                for q in range(n * N, (n + 1) * N):
                    for k in deep_cache.PAIR_VALS:
                        okk = deep_cache.ok_name(k)
                        fcl[k][q] = sel(rst, 0, fcl[k][q])
                        fcl[okk][q] = fcl[okk][q] | rst
                for tw in range(n * W_T, (n + 1) * W_T):
                    fcl["ok_topw"][tw] = fcl["ok_topw"][tw] & ~rst
            if flags.delay:
                # §10: a restart clears the slots the node OWNS (its sent
                # requests died with the process); a crash clears nothing
                # (messages stay on the wire).
                for b in range(N):
                    for k in ("vq_due", "aq_due"):
                        mb[k][pair(n, b)] = sel(rst, -1, mb[k][pair(n, b)])
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

    if use_fc and (flags.periodic or flags.inject):
        # The early top-window refill: a phase-0 ghost append consumes the
        # window before phase 5's refill runs (e.g. the tick after a
        # truncation invalidated it). On a tick that injects a command, and
        # only where a ghost-state node (phys_len > last_index) misses a
        # window row, read the windows from the stored logs (no write is
        # pending yet); rows outside [0, C) store 0, all become valid.
        due = torch.zeros((), dtype=torch.bool, device=dev)
        if flags.periodic:
            due = due | (aux["periodic"][0] >= 0).any()
        if flags.inject:
            due = due | (aux["inject"] >= 0).any()
        rows_e, need_e, inr_e, ask = [], [], [], []
        for n in range(N):
            li_e = nd["last_index"][n]
            ghosty = nd["phys_len"][n] > li_e
            for j in range(W_T):
                r = li_e + j
                inr_e.append((r >= 0) & (r < C))
                need_e.append(~fcl["ok_topw"][n * W_T + j])
                rows_e.append(n * C + r.clamp(0, C - 1))
                ask.append(need_e[-1] & inr_e[-1] & ghosty)
        if bool(due & torch.stack(ask).any()):
            vals = torch.gather(s["log_term"], 0,
                                torch.stack(rows_e).long()).to(_I32)
            for k in range(N * W_T):
                v = sel(inr_e[k], vals[k], zero)
                fcl["f_topw"][k] = sel(need_e[k] | ~inr_e[k], v,
                                       fcl["f_topw"][k])
                fcl["ok_topw"][k] = torch.ones_like(fcl["ok_topw"][k])

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
    # lastLogTerm cache refresh for the nodes phase 0 may have appended to
    # (the frontier cache keeps last_term live in log_add instead).
    if flags.inject and not use_fc:
        for n in range(N):
            refresh_last_term(n)
    elif flags.periodic and not use_fc:
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
        clear_votes(n, init)
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

    def delay_for(a, b):
        # §10 per-pair send delay this tick (a constant when lo == hi).
        if cfg.delay_lo == cfg.delay_hi:
            return torch.full((G,), cfg.delay_lo, dtype=_I32, device=dev)
        return aux["delay"][pair(a, b)].to(_I32)

    def put(name, a, b, mask, v):
        mb[name][pair(a, b)] = sel(mask, v, mb[name][pair(a, b)])

    def vote_exchange(c, p, att, req_term, req_lli, req_llt, guard=None):
        # §6.1 handler on p + the candidate's tally, masked by `att`; the
        # request fields are c's live state (synchronous) or the slot's
        # snapshot (§10). `guard` also masks the candidate side: the §10
        # straggler rule; the handler on p is governed by `att` alone.
        p_term = nd["term"][p]
        rej_stale = (lli[p] >= 1) & (req_llt < llt[p])
        rej_short = (lli[p] >= 1) & (req_llt == llt[p]) & (req_lli < lli[p])
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
        tal = att if guard is None else att & guard
        if pc:
            # §18: bit p of c's words (each pair exchanges at most once a
            # round, so the OR is the wide count's add).
            nd["responded_bits"][c] = nd["responded_bits"][c] \
                | (tal.to(_I32) << p)
            nd["vote_bits"][c] = nd["vote_bits"][c] \
                | ((tal & granted).to(_I32) << p)
        else:
            pr["responded"][pair(c, p)] = pr["responded"][pair(c, p)] | tal
            nd["responses"][c] = nd["responses"][c] + tal.to(_I32)
            nd["votes"][c] = nd["votes"][c] + (tal & granted).to(_I32)
        nd["role"][c] = sel(tal & (resp_term > nd["term"][c]), FOLLOWER,
                            nd["role"][c])  # quirk f

    def vote_deliver(c, p, due):
        # §10 delivery: the response leg is taken now, and its failure
        # voids the whole exchange; the candidate counts the response only
        # while the round that sent it is still ACTIVE (the rounds stamp —
        # straggler cancellation, RaftServer.kt:214-215).
        pi = pair(c, p)
        att = due & eok[p][c]
        tally("vote_read", att)
        guard = (nd["round_state"][c] == ACTIVE) & (
            mb["vq_round"][pi] == nd["rounds"][c])
        mb["vq_due"][pi] = sel(due, -1, mb["vq_due"][pi])
        vote_exchange(c, p, att, mb["vq_term"][pi], mb["vq_lli"][pi],
                      mb["vq_llt"][pi], guard)

    # A pair's slot is written only by its own delivery and then its own
    # send, so every first delivery reads the pre-phase countdown.
    vdue0 = [d == 0 for d in mb["vq_due"]] if flags.delay else None
    for c in range(N):
        attempting = (nd["round_state"][c] == ACTIVE) & (
            torch.remainder(nd["round_age"][c], cfg.retry_ticks) == 0)
        for p in range(N):
            if flags.delay:
                vote_deliver(c, p, vdue0[pair(c, p)])  # earlier ticks' slot
                # The request leg at the send; responded may have just been
                # set by this pair's delivery.
                att = attempting & eok[c][p] & ~responded(c, p)
                tally("vote_sent", att)
                put("vq_term", c, p, att, nd["term"][c])
                put("vq_lli", c, p, att, lli[c])
                put("vq_llt", c, p, att, llt[c])
                put("vq_round", c, p, att, nd["rounds"][c])
                put("vq_due", c, p, att, delay_for(c, p))
                if cfg.delay_lo == 0:  # τ=0: the fresh slot, same iteration
                    vote_deliver(c, p, mb["vq_due"][pair(c, p)] == 0)
            else:
                att = attempting & ~responded(c, p) \
                    & eok[c][p] & eok[p][c]
                vote_exchange(c, p, att, nd["term"][c], lli[c], llt[c])
    if cut is not None and cut < 4:
        return finish()

    # -- phase 4: round conclusions -----------------------------------------
    for n in range(N):
        act = (nd["round_state"][n] == ACTIVE) & nd["up"][n]
        if pc:  # §18: the tallies are the words' popcounts
            resp_n = popcount32(nd["responded_bits"][n])
            vote_n = popcount32(nd["vote_bits"][n])
        else:
            resp_n, vote_n = nd["responses"][n], nd["votes"][n]
        concl = act & ((resp_n >= maj) | (nd["round_left"][n] <= 0))
        is_cand = nd["role"][n] == CANDIDATE
        win = concl & is_cand & (vote_n >= maj)
        lose = concl & is_cand & ~win
        dem = concl & ~is_cand
        nd["role"][n] = sel(win, LEADER, nd["role"][n])
        for b in range(N):  # quirk b
            pi = pair(n, b)
            pr["next_index"][pi] = sel(win, nd["commit"][n] + 1,
                                       pr["next_index"][pi])
            pr["match_index"][pi] = sel(win, 0, pr["match_index"][pi])
            if use_fc:  # the jump leaves every frontier value unknown
                for k in deep_cache.PAIR_VALS:
                    okk = deep_cache.ok_name(k)
                    fcl[okk][pi] = fcl[okk][pi] & ~win
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
    if use_fc:
        # The frontier-cache refill: the entries phase 5 will consume this
        # tick that are invalid and in range, in the JAX package's order —
        # per pair (f_pli, f_ent_t, f_ppli) then the top windows for the
        # term log, f_ent_c for the cmd log — each (gate, hard, node, row,
        # key, index). The consumption masks are the loop head's, from
        # state phase 5 reads before any exchange. Top-window rows are
        # asked for by ghost-state nodes only (soft: a miss is no ov).
        t_entries, c_entries = [], []
        for l in range(N):
            li_l = nd["last_index"][l]
            fire_f = nd["hb_armed"][l] & nd["up"][l] & ~(nd["hb_left"][l] > 0)
            for p in range(N):
                pi = pair(l, p)
                i = pr["next_index"][pi]
                he = li_l >= i
                cns = fire_f & ~(((i - 2 >= 0) & (i - 2 >= li_l))
                                 | (he & (i <= 0)))
                in2 = (i - 2 >= 0) & (i - 2 < C)
                in1 = (i - 1 >= 0) & (i - 1 < C)
                t_entries += [
                    (cns & ~fcl["ok_pli"][pi] & in2, True, l, i - 2,
                     "f_pli", pi),
                    (cns & he & ~fcl["ok_ent_t"][pi] & in1, True, l, i - 1,
                     "f_ent_t", pi),
                    (cns & ~fcl["ok_ppli"][pi] & in2, True, p, i - 2,
                     "f_ppli", pi)]
                c_entries.append((cns & he & ~fcl["ok_ent_c"][pi] & in1,
                                  True, l, i - 1, "f_ent_c", pi))
        for n in range(N):
            li_n = nd["last_index"][n]
            ghosty = nd["phys_len"][n] > li_n
            for j in range(W_T):
                r = li_n + j
                t_entries.append((~fcl["ok_topw"][n * W_T + j] & ghosty
                                  & (r >= 0) & (r < C), False, n, r,
                                  "f_topw", n * W_T + j))
        jobs = ((t_entries, deep_cache.TERM_BUDGET, s["log_term"], 1),
                (c_entries, deep_cache.CMD_BUDGET, s["log_cmd"], 2))
        gates = [torch.stack([e[0] for e in entries])
                 for entries, _, _, _ in jobs]
        # The JAX package's lax.cond: no lane asks, no take.
        if bool(torch.stack([g.any() for g in gates]).any()):
            for (entries, budget, log, vi), gate in zip(jobs, gates):
                fc_ov = fc_ov | fc_refill(entries, gate, budget, log, vi)
    elif batched:
        # Every phase-5 log read in one gather, rows known now (positions,
        # clipped to [0, C)). Synchronous: a pair's next_index moves only in
        # its own exchange. Node n's term rows:
        #   [0, N)        prevLog of n as leader, ni(n, q) - 2
        #   [N, 2N)       entry of n as leader, ni(n, q) - 1
        #   [2N, 3N)      prevLog check on n as peer, ni(l, n) - 2
        #   3N            last_index - 1, the tick-end last_term base
        #   [3N+1, 4N+1)  GHOST rows ni(l, n) - 1: a §3 append after a
        #                 truncation writes slot phys_len while last_index
        #                 moves to ni(l, n), so the tick-end last_term
        #                 reads this stale stored row;
        # cmd rows: the entry rows [N, 2N).
        # Under the mailbox (known delivery, delay_lo >= 1) a pair's
        # next_index at its send is ni + d, d in {-1, 0, +1} set by its own
        # delivery alone (capacity-1 slots, no same-tick redelivery), and
        # each delivery's prevLog row is the slot's own aq_pli, unwritten
        # until that pair's send. Node n's term rows:
        #   [0, 4N)       leader-send candidates ni(n, q) - 3 + k (block k)
        #   [4N, 5N)      delivery prevLog rows aq_pli(l, n)     (T_DEL)
        #   5N            last_index - 1                         (T_LLT)
        #   [5N+1, 6N+1)  ghost rows aq_pli(l, n) + 1: a delivery's add
        #                 at aq_pli + 1 moves last_index to aq_pli + 2
        #                                                        (T_GHOST)
        # cmd rows: the entry candidates, term rows [N, 4N).
        # §15 (synchronous only: mailbox compaction keeps the per-pair
        # engine): the rows are the positions' ring slots, and the parallel
        # positions bpos_t key the tick-end ghost overlay — two positions
        # can share a slot.
        ni = torch.stack(pr["next_index"]).view(N, N, G)
        li_b = torch.stack(nd["last_index"])[:, None]
        if flags.delay:
            T_DEL, T_LLT, T_GHOST, Rc = 4 * N, 5 * N, 5 * N + 1, 3 * N
            aqp = torch.stack(mb["aq_pli"]).view(N, N, G).transpose(0, 1)
            bpos_t = torch.cat([ni - 3, ni - 2, ni - 1, ni, aqp, li_b - 1,
                                aqp + 1], dim=1)
        else:
            T_LLT, T_GHOST, Rc = 3 * N, 3 * N + 1, N
            nit = ni.transpose(0, 1)
            bpos_t = torch.cat([ni - 2, ni - 1, nit - 2, li_b - 1, nit - 1],
                               dim=1)
        brows_t = (ring(bpos_t.clamp(min=0)) if compact
                   else bpos_t.clamp(0, C - 1))  # (N, Rt, G)
        Rt = brows_t.shape[1]
        brows_c = brows_t[:, N:N + Rc]
        vt, vc = (gather or deep_gather.gather_plain)(
            s["log_term"], s["log_cmd"], brows_t.reshape(N * Rt, G), N, C,
            Rc)
        bvals_t = vt.view(N, Rt, G).to(_I32)
        bvals_c = vc.view(N, Rc, G).to(_I32)

        def pick(rows, vals, l, p, j0, d):
            # Pair (l, p)'s candidate (row, value) in block j0 + 1 + d of
            # l's rows (d = ni at the send minus ni at the batch); where the
            # clip collapsed candidates they read the same row.
            return tuple(sel(d < 0, t[l, j0 * N + p],
                             sel(d > 0, t[l, (j0 + 2) * N + p],
                                 t[l, (j0 + 1) * N + p]))
                         for t in (rows, vals))

    def append_exchange(l, p, act5, req_term, req_commit, pli, plt,
                        has_entry, ent_t, ent_c, p_plt=None, sync=True):
        # §6.2 handler on p + the leader's response processing, masked by
        # `act5`; the request fields are l's live state (synchronous) or
        # the slot's snapshot (§10). The leader side always reads l's LIVE
        # state (RaftServer.kt:146-168: appends are never cancelled).
        # `p_plt`: p's log term at pli, pre-read by the batched engine.
        pi = pair(l, p)
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
        if p_plt is None:
            p_plt = node_read(p, pli)
        if compact:
            # §15: p's snapshot covers positions below its base — the
            # boundary row base-1 checks against snap_term, rows below it
            # are absorbed (folded, so committed and matching).
            b_p = nd["snap_index"][p]
            p_plt = sel((pli >= 0) & (pli == b_p - 1), nd["snap_term"][p],
                        p_plt)
            below = (pli >= 0) & (pli < b_p - 1)
            succ = (pli == -1) | below | (
                (p_li > pli) & (pli >= 0) & (p_plt == plt))
        else:
            succ = (pli == -1) | ((p_li > pli) & (pli >= 0) & (p_plt == plt))
        cmp = act5 & (pli >= 0) & (p_li > pli)  # p's prevLog term read
        ent = act5 & has_entry & succ
        if sync:  # the leader's reads belong to the exchange
            mark(rd_t, l, pli, cmp)
            mark(rd_t, p, pli, cmp)
            mark(rd_t, l, pli + 1, ent)
            mark(rd_c, l, pli + 1, ent)
        else:
            mark(rd_t, p, pli, cmp)
        wr_p, slot_p = log_add(p, pli + 1, ent_t, ent_c, ent)
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
        ni_old = pr["next_index"][pi]
        pr["next_index"][pi] = ni_old + with_e.to(_I32) - nfail.to(_I32)
        mi = pr["match_index"][pi]
        pr["match_index"][pi] = sel(with_e, mi + 1,
                                    sel(proc & ~has_entry, pli + 1, mi))
        # Commit advancement (quirk a): #{q : match[q] > commit} >= maj.
        l_commit = nd["commit"][l]
        cnt = zero
        for q in range(N):
            cnt = cnt + (pr["match_index"][pair(l, q)] > l_commit).to(_I32)
        nd["commit"][l] = sel(with_e & (cnt >= maj), l_commit + 1, l_commit)
        if use_fc:
            fc_shift(pi, with_e, nfail, wr_p & (slot_p == ni_old - 1),
                     rt(ent_t))

    def install_exchange(l, p, act, req_term, req_si, req_st, req_dg,
                         req_commit):
        # §15 InstallSnapshot handler on p + the leader's response, masked
        # by `act`; the request is l's live snapshot (synchronous) or the
        # slot's (§10, aq_hase == 2). The §6.2 shape: term adoption, the
        # quirk-d demote, install iff req_si > p's last_index (the window
        # emptied onto the snapshot; ring slot contents untouched, so stale
        # bits stay comparable across engines), the quirk-e commit advance;
        # the leader's side always succeeds, with the quirk-a tally.
        pi = pair(l, p)
        if p != l:
            adopt = act & (req_term > nd["term"][p])
            nd["term"][p] = sel(adopt, req_term, nd["term"][p])
            nd["voted_for"][p] = sel(adopt, -1, nd["voted_for"][p])
            nd["role"][p] = sel(act, FOLLOWER, nd["role"][p])  # quirk d
            reset_timer(p, adopt)
            reset_timer(p, act)
        do = act & (req_si > nd["last_index"][p])
        for k, v in (("snap_index", req_si), ("snap_term", req_st),
                     ("snap_digest", req_dg), ("last_index", req_si),
                     ("phys_len", req_si), ("commit", req_si),
                     ("last_term", req_st)):
            nd[k][p] = sel(do, v, nd[k][p])
        cadv = act & (req_commit > nd["commit"][p])
        nd["commit"][p] = sel(cadv, torch.minimum(req_commit,
                                                  nd["last_index"][p]),
                              nd["commit"][p])
        if p != l:
            resp_term = nd["term"][p]
            demote = act & (resp_term > nd["term"][l])
            nd["term"][l] = sel(demote, resp_term, nd["term"][l])
            nd["role"][l] = sel(demote, FOLLOWER, nd["role"][l])
            reset_timer(l, demote)
            proc = act & ~demote
        else:
            proc = act
        pr["next_index"][pi] = sel(proc, req_si + 1, pr["next_index"][pi])
        pr["match_index"][pi] = sel(proc, req_si, pr["match_index"][pi])
        l_commit = nd["commit"][l]
        cnt = zero
        for q in range(N):
            cnt = cnt + (pr["match_index"][pair(l, q)] > l_commit).to(_I32)
        nd["commit"][l] = sel(proc & (cnt >= maj), l_commit + 1, l_commit)

    def append_deliver(l, p, due):
        # §10 delivery: the response leg is taken now, and its failure voids
        # the whole exchange. No straggler guard for appends. Under §15 a
        # slot with aq_hase == 2 is an InstallSnapshot (snap_index /
        # snap_term / digest in the pli / plt / ent_t seats).
        pi = pair(l, p)
        act = due & eok[p][l]
        tally("append_read", act)
        mb["aq_due"][pi] = sel(due, -1, mb["aq_due"][pi])
        p_plt = None
        if batched:  # p's term at the slot's own prevLog row, batched
            p_plt = bounded(mb["aq_pli"][pi], patch(
                False, p, brows_t[p, T_DEL + l], bvals_t[p, T_DEL + l]))
        hase = mb["aq_hase"][pi]
        if compact:
            is_inst = hase == 2
            append_exchange(l, p, act & ~is_inst, mb["aq_term"][pi],
                            mb["aq_commit"][pi], mb["aq_pli"][pi],
                            mb["aq_plt"][pi], hase == 1, mb["aq_ent_t"][pi],
                            mb["aq_ent_c"][pi], p_plt, sync=False)
            install_exchange(l, p, act & is_inst, mb["aq_term"][pi],
                             mb["aq_pli"][pi], mb["aq_plt"][pi],
                             mb["aq_ent_t"][pi], mb["aq_commit"][pi])
            return
        append_exchange(l, p, act, mb["aq_term"][pi], mb["aq_commit"][pi],
                        mb["aq_pli"][pi], mb["aq_plt"][pi],
                        hase != 0, mb["aq_ent_t"][pi],
                        mb["aq_ent_c"][pi], p_plt, sync=False)

    adue0 = [d == 0 for d in mb["aq_due"]] if flags.delay else None
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
            if flags.delay:
                append_deliver(l, p, adue0[pi])  # earlier ticks' slot
            # The request, from l's live state at the send (a delivery just
            # above may have moved next_index).
            li_l = nd["last_index"][l]
            i = pr["next_index"][pi]
            pli = i - 2
            # prevLogTerm of an invalid slot throws -> skip peer (§6).
            skip = (pli >= 0) & (pli >= li_l)
            if compact:
                # §15 InstallSnapshot send condition: the peer's frontier
                # fell to or below l's snapshot base (base 0 keeps the
                # quirk-i path).
                b_l = nd["snap_index"][l]
                inst = fire & (i <= b_l) & (b_l >= 1)
            if use_fc:
                # Consumed from the cache; a needed invalid entry raises
                # ov. The guards read the live fire / skip masks, not the
                # refill's: an earlier leader's append can move this
                # leader's last_index mid-loop.
                in2 = (pli >= 0) & (pli < C)
                plt = sel(pli >= 0, bounded(pli, fcl["f_pli"][pi]), -1)
                ov_pli = fire & ~skip & in2 & ~fcl["ok_pli"][pi]
            elif batched:
                if flags.delay:
                    d = i - ni[l, p]
                    r_pli, v_pli = pick(brows_t, bvals_t, l, p, 0, d)
                else:
                    r_pli, v_pli = brows_t[l, p], bvals_t[l, p]
                raw_plt = bounded(pli, patch(False, l, r_pli, v_pli), l)
                if compact:  # prevLog at l's own base - 1 is snap_term
                    raw_plt = sel(pli == b_l - 1, nd["snap_term"][l],
                                  raw_plt)
                plt = sel(pli >= 0, raw_plt, -1)
            else:
                plt = sel(pli >= 0, term_b(l, pli), -1)
            has_entry = li_l >= i
            skip = skip | (has_entry & (i <= 0))  # quirk i underflow
            if use_fc:
                ent_t = bounded(i - 1, fcl["f_ent_t"][pi])
                ent_c = bounded(i - 1, fcl["f_ent_c"][pi])
                live = fire & ~skip
                fc_ov = fc_ov | ov_pli | (
                    live & has_entry & (i - 1 >= 0) & (i - 1 < C)
                    & ~(fcl["ok_ent_t"][pi] & fcl["ok_ent_c"][pi])) | (
                    live & in2 & ~fcl["ok_ppli"][pi])
            elif batched and flags.delay:
                # Term candidates one block above plt's; cmd candidates
                # the whole cmd batch.
                ent_t = bounded(i - 1, patch(False, l, *pick(
                    brows_t, bvals_t, l, p, 1, d)))
                ent_c = bounded(i - 1, patch(True, l, *pick(
                    brows_c, bvals_c, l, p, 0, d)))
            elif batched:
                ent_t = bounded(i - 1, patch(False, l, brows_t[l, N + p],
                                             bvals_t[l, N + p]), l)
                ent_c = bounded(i - 1, patch(True, l, brows_c[l, p],
                                             bvals_c[l, p]), l)
            else:
                ent_t = node_read(l, i - 1)
                ent_c = node_read(l, i - 1, cmd=True)
            if flags.delay:
                # The request leg at the send; the slot snapshots the
                # PHYSICAL row i - 1 whether or not an entry rides along.
                att = fire & eok[l][p] & ~skip
                if compact:
                    # §15: an install send rides the same slot (aq_hase ==
                    # 2, the snapshot in the pli / plt / ent_t seats), and
                    # takes its lanes out of the append send.
                    att_i = inst & eok[l][p]
                    att = att & ~inst
                    a_any = att | att_i
                else:
                    att_i, a_any = None, att
                tally("append_sent", att)
                mark(rd_t, l, pli, att & (pli >= 0))
                mark(rd_t, l, i - 1, att)
                mark(rd_c, l, i - 1, att)
                hase_v = has_entry.to(_I32)
                if att_i is not None:
                    pli, plt = sel(att_i, b_l, pli), sel(
                        att_i, nd["snap_term"][l], plt)
                    hase_v = sel(att_i, 2, hase_v)
                    ent_t = sel(att_i, nd["snap_digest"][l], ent_t)
                    ent_c = sel(att_i, 0, ent_c)
                put("aq_term", l, p, a_any, nd["term"][l])
                put("aq_commit", l, p, a_any, nd["commit"][l])
                put("aq_pli", l, p, a_any, pli)
                put("aq_plt", l, p, a_any, plt)
                put("aq_hase", l, p, a_any, hase_v)
                put("aq_ent_t", l, p, a_any, ent_t)
                put("aq_ent_c", l, p, a_any, ent_c)
                put("aq_due", l, p, a_any, delay_for(l, p))
                if cfg.delay_lo == 0:  # τ=0: the fresh slot, same iteration
                    append_deliver(l, p, mb["aq_due"][pi] == 0)
                continue
            both = eok[l][p] & eok[p][l]
            skip = skip | ~both
            act5 = fire & ~skip
            if compact:
                act5 = act5 & ~inst
            if use_fc:
                p_plt = bounded(pli, fcl["f_ppli"][pi])
            elif batched:
                p_plt = bounded(pli, patch(False, p, brows_t[p, 2 * N + l],
                                           bvals_t[p, 2 * N + l]), p)
            else:
                p_plt = None
            append_exchange(l, p, act5, nd["term"][l], nd["commit"][l], pli,
                            plt, has_entry, ent_t, ent_c, p_plt)
            if compact:
                install_exchange(l, p, inst & both, nd["term"][l], b_l,
                                 nd["snap_term"][l], nd["snap_digest"][l],
                                 nd["commit"][l])

    if flags.delay:
        # §10 end of tick: the in-flight countdowns advance (a send at t
        # with delay d is due, 0, at tick t + d's delivery scan).
        for k in ("vq_due", "aq_due"):
            mb[k] = [d - (d > 0).to(_I32) for d in mb[k]]

    def fold():
        # -- phase C: the §15 snapshot fold, on the final log. A live node
        # whose committed backlog commit - snap_index reached the watermark
        # folds up to compact_chunk oldest committed entries into its
        # snapshot (digest' = digest * DIGEST_MULT + cmd, wrapping i32;
        # snap_term = the last folded entry's term) and advances
        # snap_index, the ring base: the window slides with no data moved.
        W_cmp, CH_cmp = cfg.compact_watermark, cfg.compact_chunk
        for n in range(N):
            si = nd["snap_index"][n]
            avail = nd["commit"][n] - si
            due = nd["up"][n] & (avail >= W_cmp)
            cnt = sel(due, avail.clamp(max=CH_cmp), 0)
            rows = torch.stack([ring(si + j) for j in range(CH_cmp)]).long()
            tvs = torch.gather(s["log_term"][n * C:(n + 1) * C], 0, rows)
            cvs = torch.gather(s["log_cmd"][n * C:(n + 1) * C], 0, rows)
            dg, st = nd["snap_digest"][n], nd["snap_term"][n]
            for j in range(CH_cmp):
                active = due & (j < cnt)
                dg = sel(active, fold_digest(dg, cvs[j]), dg)
                st = sel(active, tvs[j].to(_I32), st)
            nd["snap_index"][n] = si + cnt
            nd["snap_term"][n], nd["snap_digest"][n] = st, dg

    if not batched:
        # lastLogTerm cache, recomputed from the final log.
        for n in range(N):
            refresh_last_term(n)
        if compact:
            fold()
        return finish()

    # The deferred writes, all nodes at once. Two leaders can append to the
    # same slot of one node in one tick, so each entry first takes the
    # value of the LAST write at its row (rows never alias across nodes);
    # duplicates then carry equal values and the scatter may store them in
    # any order. Nodes pad to K entries with row C (dropped).
    K = max(len(w) for w in pending)
    pad = (torch.full((G,), C, dtype=_I32, device=dev), zero, zero,
           torch.zeros(G, dtype=torch.bool, device=dev))
    rows_k, vt_k, vc_k, wr_k = (torch.stack([
        torch.stack([w[f] for w in pending[n]]
                    + [pad[f]] * (K - len(pending[n])))
        for n in range(N)]) for f in range(4))  # (N, K, G) each
    hit = wr_k[:, None] & (rows_k[:, None] == rows_k[:, :, None])
    kk = torch.arange(K, dtype=torch.int16, device=dev)
    last = torch.where(hit, kk[None, None, :, None], -1).amax(2)
    last = torch.where(last < 0, kk[None, :, None], last).long()
    (scatter or deep_scatter.scatter_plain)(
        s["log_term"], s["log_cmd"], rows_k.reshape(N * K, G),
        torch.gather(vt_k, 1, last).to(ldt).reshape(N * K, G),
        torch.gather(vc_k, 1, last).to(ldt).reshape(N * K, G), N, C, K)

    if use_fc:  # last_term was kept live; hand the cache back
        for k in fc_fields:
            fcache[k] = torch.stack(fcl[k])
        fcache["ov"] = fc_ov
        return finish()
    # lastLogTerm cache from the final log: the batched base row, a ghost
    # row where the final last_index - 1 is one, then this tick's writes.
    # §15: the overlay matches positions, and a fully folded window (li ==
    # base, e.g. right after an install) reads snap_term.
    for n in range(N):
        li_f = nd["last_index"][n]
        if compact:
            pos = li_f - 1
            row = ring(pos.clamp(min=0))
            raw = bvals_t[n, T_LLT]
            for j in range(T_GHOST, T_GHOST + N):
                raw = sel(bpos_t[n, j] == pos, bvals_t[n, j], raw)
            raw = sel(li_f == nd["snap_index"][n], nd["snap_term"][n],
                      patch(False, n, row, raw))
        else:
            row = (li_f - 1).clamp(0, C - 1)
            raw = bvals_t[n, T_LLT]
            for j in range(T_GHOST, T_GHOST + N):
                raw = sel(brows_t[n, j] == row, bvals_t[n, j], raw)
            raw = patch(False, n, row, raw)
        nd["last_term"][n] = sel(li_f >= 1, raw, zero)
    if compact:
        fold()
    return finish()


def flatten_state(cfg: RaftConfig, state: RaftState) -> dict:
    """RaftState -> the rank-2 dict phase_body works on, as VIEWS of the
    state's tensors (phase_body's writes land in the state). Pair fields
    (N, N, G) -> (N*N, G), logs (N, C, G) -> (N*C, G); bool pair fields
    stay bool (the JAX package widens them to int16 — the values agree)."""
    N, C, G = cfg.n_nodes, cfg.phys_capacity, state.term.shape[-1]
    s = {}
    for k in state.fields():
        v = getattr(state, k)
        if k in PAIR_FIELDS or k in MAILBOX_FIELDS:
            v = v.view(N * N, G)
        elif k in LOG_FIELDS:
            v = v.view(N * C, G)
        s[k] = v
    return s


def flatten_packed(cfg: RaftConfig, packed) -> dict:
    """PackedRaftState -> the flat dict the packed kernels take, as VIEWS of
    its tensors: pair fields (N, N, G) -> (N*N, G), logs (N, C, G) ->
    (N*C, G); the ctrl words (3, G), the peer masks (N, G) rows and the
    (G,) latch as they are."""
    N, C, G = cfg.n_nodes, cfg.phys_capacity, packed.term.shape[-1]
    s = {}
    for k in packed.fields():
        v = getattr(packed, k)
        if k in PAIR_FIELDS or k in MAILBOX_FIELDS:
            v = v.view(N * N, G)
        elif k in LOG_FIELDS:
            v = v.view(N * C, G)
        s[k] = v
    return s


def unflatten_packed(cfg: RaftConfig, s: dict) -> dict:
    """Inverse of flatten_packed (canonical shapes; views)."""
    N, C = cfg.n_nodes, cfg.phys_capacity
    out = dict(s)
    for k in out:
        if k in PAIR_FIELDS or k in MAILBOX_FIELDS:
            out[k] = out[k].view(N, N, -1)
        elif k in LOG_FIELDS:
            out[k] = out[k].view(N, C, -1)
    return out


def unpack_flat(cfg: RaftConfig, pf: dict) -> dict:
    """A flat packed dict -> the flat wide dict in the kernel form (int32,
    the logs in their storage dtype): what the packed kernels' plain
    versions run the lattice on. New tensors."""
    p = {k: v for k, v in unflatten_packed(cfg, pf).items() if k != "ov"}
    w = unpack_fields(cfg, p, kernel_form=True)
    N, C, G = cfg.n_nodes, cfg.phys_capacity, pf["term"].shape[-1]
    return {k: v.reshape(N * N, G) if v.dim() == 3 and k not in LOG_FIELDS
            else v.reshape(N * C, G) if k in LOG_FIELDS else v
            for k, v in w.items()}


def repack_flat(cfg: RaftConfig, s: dict, pf: dict) -> None:
    """Pack the flat wide dict `s` into the flat packed dict `pf` in place,
    ORing this pack's width-overflow latch into pf["ov"]."""
    N, C = cfg.n_nodes, cfg.phys_capacity
    canon = {k: v.reshape(N, N, -1) if k in PAIR_FIELDS or k in MAILBOX_FIELDS
             else v.reshape(N, C, -1) if k in LOG_FIELDS else v
             for k, v in s.items()}
    p, ov = pack_fields(cfg, canon)
    for k, v in p.items():
        pf[k].copy_(v.reshape(pf[k].shape))
    pf["ov"].copy_(pf["ov"] | ov.to(pf["ov"].dtype))


def unflatten_state(cfg: RaftConfig, s: dict) -> dict:
    """Inverse of flatten_state (a dict; add the tick to build RaftState)."""
    N, C = cfg.n_nodes, cfg.phys_capacity
    out = dict(s)
    for k in PAIR_FIELDS + tuple(k for k in MAILBOX_FIELDS if k in s):
        out[k] = out[k].reshape(N, N, -1)
        if k in ("responded", "link_up"):
            out[k] = out[k] != 0
    for k in LOG_FIELDS:
        out[k] = out[k].reshape(N, C, -1)
    return out


def make_rng(cfg: RaftConfig, device="cuda", uids=None):
    """The per-simulation RNG operands: (base key words, timeout key words
    (N, G), backoff key words (N, G)) — the static key prefixes computed
    once, transposed to line up with the (N, G) counter grids — and, when
    cfg.scenario is set, a fourth element: the §12 ScenarioBank
    (utils/rng.sample_scenario_bank, keyed by the spec's farm_seed and
    universe ids, not by cfg.seed), a dict of (G,) int32 rows on the
    device. `uids` overrides the bank's universe-id row."""
    check_supported(cfg)
    dev = require_device(device)
    base = rngmod.base_key(cfg.seed)
    G, N = cfg.n_groups, cfg.n_nodes
    tk = rngmod.grid_keys(base, rngmod.KIND_TIMEOUT, G, N, dev)
    bk = rngmod.grid_keys(base, rngmod.KIND_BACKOFF, G, N, dev)
    rng = (base, (tk[0].T.contiguous(), tk[1].T.contiguous()),
           (bk[0].T.contiguous(), bk[1].T.contiguous()))
    if cfg.scenario is not None:
        return rng + (rngmod.sample_scenario_bank(cfg, uids=uids,
                                                  device=dev),)
    if uids is not None:
        raise ValueError("universe ids need cfg.scenario")
    return rng


def split_rng(rng) -> tuple:
    """(base, tkeys, bkeys, bank) from a make_rng tuple; a config without a
    scenario carries an empty bank."""
    if len(rng) == 3:
        return (*rng, {})
    return tuple(rng)


def el_bounds(cfg: RaftConfig):
    """The election-timeout window every draw site uses (the boot draw, the
    phase-F restart redraw and the §7 materialization). §19 per-group
    timeout windows are refused (models/state.check_supported)."""
    return cfg.el_lo, cfg.el_hi


# Host-side draw calls since the last reset_call_counts(): the staged
# path's per-tick draws, which the in-kernel fused path does without.
CALLS = {"make_aux": 0, "materialize_el": 0}


def reset_call_counts() -> None:
    for k in CALLS:
        CALLS[k] = 0


def live_leaders(role: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Canonical (G, N) bool: the live leaders of (N, G) role / up rows —
    what a leader-isolation program (§12) reads at a tick's start."""
    return ((role == LEADER) & (up != 0)).T


def event_channels(cfg: RaftConfig, base, t: int, G: int, flags: BodyFlags,
                   device, scen: Optional[dict] = None,
                   lead: Optional[torch.Tensor] = None) -> dict:
    """The aux channels keyed by (kind, tick) alone — edge_iid, crash_m /
    restart_m (faults), link_fail / link_heal (links), periodic, delay (the
    §10 mailbox, when delay_lo < delay_hi) — drawn in the canonical
    (G, ...) §4 shapes and transposed to groups-minor. No counter-keyed
    draw: those depend on the live t_ctr / b_ctr.

    `scen`, the §12 bank, replaces the scalar thresholds and delay window
    channel by channel, folds its partition programs into edge_iid on the
    canonical orientation, and its warmup-down schedule into the crash /
    restart masks. A leader-isolation program needs `lead`, the (G, N)
    live leaders of the pre-tick state (live_leaders)."""
    N = cfg.n_nodes
    dev = torch.device(device)
    scen = scen or {}

    def pairs(m):  # canonical (G, N, N) -> flat (N*N, G) int16
        return m.permute(1, 2, 0).reshape(N * N, G).to(torch.int16) \
            .contiguous()

    edge = rngmod.edge_ok_mask(base, t, (G, N, N), cfg.p_drop, dev,
                               thresh=scen.get("drop_t"))
    if "part_kind" in scen:
        if lead is None and cfg.scenario.needs_state:
            raise RuntimeError(
                "leader-isolation partition programs need the pre-tick "
                "state (cfg.scenario.needs_state): this caller draws the "
                "tick's aux without it")
        edge = edge & ~rngmod.scenario_link_down(scen, t, lead, N)
    aux = {"edge_iid": pairs(edge)}
    if flags.faults:
        crash = rngmod.event_mask(base, rngmod.KIND_CRASH, t, (G, N),
                                  cfg.p_crash, dev,
                                  thresh=scen.get("crash_t"))
        restart = rngmod.event_mask(base, rngmod.KIND_RESTART, t, (G, N),
                                    cfg.p_restart, dev,
                                    thresh=scen.get("restart_t"))
        crash, restart = rngmod.apply_warmup_faults(
            cfg.scenario, cfg.cmd_node, t, crash, restart)
        aux["crash_m"], aux["restart_m"] = crash.T, restart.T
    if flags.links:
        aux["link_fail"] = pairs(rngmod.event_mask(
            base, rngmod.KIND_LINK_FAIL, t, (G, N, N), cfg.p_link_fail, dev,
            thresh=scen.get("link_fail_t")))
        aux["link_heal"] = pairs(rngmod.event_mask(
            base, rngmod.KIND_LINK_HEAL, t, (G, N, N), cfg.p_link_heal, dev,
            thresh=scen.get("link_heal_t")))
    if flags.periodic:
        due = t % cfg.cmd_period == 0 and t > 0
        aux["periodic"] = torch.full((1, G), t if due else -1, dtype=_I32,
                                     device=dev)
    if flags.delay and cfg.delay_lo < cfg.delay_hi:
        aux["delay"] = pairs(rngmod.delay_mask(
            base, t, (G, N, N), cfg.delay_lo, cfg.delay_hi, dev,
            lo_g=scen.get("delay_lo"), hi_g=scen.get("delay_hi")))
    return aux


def make_aux(cfg: RaftConfig, base, tkeys, bkeys, state: RaftState,
             inject: Optional[torch.Tensor] = None,
             fault_cmd: Optional[torch.Tensor] = None,
             scen: Optional[dict] = None, batched: Optional[bool] = None):
    """Draw/assemble the phase_body aux inputs from the pre-tick state:
    event_channels at the state's tick plus the counter-keyed draws.
    Randomness is drawn in the canonical (G, ...) §4 shapes and transposed
    after, so no drawn bit depends on the groups-minor layout. `inject`
    ((G, N) int32, -1 = none) and `fault_cmd` ((G, N) int32: 0 none, 1
    crash, 2 restart) are the driver inputs in canonical orientation.
    `scen` is the §12 bank (split_rng); its leader-isolation programs read
    the state's role / up. `batched` as make_flags takes it. Returns (aux
    dict, flags)."""
    CALLS["make_aux"] += 1
    G = cfg.n_groups
    dev = state.term.device
    flags = make_flags(cfg, inject_present=inject is not None,
                       fault_present=fault_cmd is not None, batched=batched)
    check_flags(flags)
    role = getattr(state, "role", None)
    lead = None if role is None else live_leaders(role, state.up)
    aux = event_channels(cfg, base, int(state.tick), G, flags, dev,
                         scen=scen, lead=lead)
    if flags.faults:
        crash, restart = aux["crash_m"], aux["restart_m"]
        if fault_cmd is not None:
            fault_cmd = fault_cmd.to(dev)
            crash = crash | (fault_cmd == 1).T
            restart = restart | (fault_cmd == 2).T
        aux["crash_m"] = crash.contiguous()
        aux["restart_m"] = restart.contiguous()
        aux["el_draw_f"] = rngmod.draw_uniform_keyed(
            tkeys, state.t_ctr, *el_bounds(cfg)).to(torch.int16)
    aux["bdraw"] = rngmod.draw_uniform_keyed(
        bkeys, state.b_ctr, cfg.bo_lo, cfg.bo_hi).to(torch.int16)
    if flags.inject:
        aux["inject"] = inject.to(device=dev, dtype=_I32).T.contiguous()
    return aux, flags


def materialize_el(cfg: RaftConfig, tkeys, s: dict,
                   el_dirty: torch.Tensor) -> None:
    """The SEMANTICS.md §7 deferred election draw, in place: el_left of a
    dirty node becomes the counted draw at t_ctr - 1 (the last counter the
    tick consumed)."""
    CALLS["materialize_el"] += 1
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


def make_stepper(cfg: RaftConfig, device, body,
                 batched: Optional[bool] = None):
    """tick(state, inject=None, fault_cmd=None) -> state around a lattice
    `body` (phase_body or the kernel wrapper), in place; `batched` selects
    the deep engine as make_flags takes it."""
    check_supported(cfg)
    check_flags(make_flags(cfg))
    dev = require_device(device)
    rng = make_rng(cfg, dev)

    def tick(state: RaftState, inject=None, fault_cmd=None) -> RaftState:
        if state.term.shape[-1] != cfg.n_groups:
            raise ValueError(f"state has {state.term.shape[-1]} groups but "
                             f"the tick was built for {cfg.n_groups}")
        base, tkeys, bkeys, scen = split_rng(rng)
        aux, flags = make_aux(cfg, base, tkeys, bkeys, state, inject,
                              fault_cmd, scen=scen, batched=batched)
        s = flatten_state(cfg, state)
        el_dirty = body(cfg, s, aux, flags)
        return finish_tick(cfg, tkeys, state, s, el_dirty)

    return tick


def packed_compute_body(cfg: RaftConfig, s: dict, aux: dict,
                        flags: BodyFlags, body=None) -> torch.Tensor:
    """`body` (phase_body when None) through the §18 form: the flat dict
    `s` enters (enter_packed_compute), the lattice runs with
    flags.packed_compute, and responded / votes / responses come back
    (popcounts of the words) in their own dtypes, in place."""
    wdt = {k: s[k].dtype for k in ("responded", "votes", "responses")}
    sp = enter_packed_compute(cfg, s)
    el_dirty = (body or phase_body)(
        cfg, sp, aux, dataclasses.replace(flags, packed_compute=True))
    out = exit_packed_compute(cfg, sp, wdt)
    for k in wdt:
        s[k].copy_(out[k])
    return el_dirty


COMPUTES = ("unpacked", "packed")
LAYOUTS = ("wide", "packed")


def check_compute(compute: str) -> None:
    if compute not in COMPUTES:
        raise ValueError(f"unknown compute {compute!r}")


def check_layout(layout: str, compute: str, paired: bool = True) -> None:
    """The (layout, compute) pair. The kernels pair them as the JAX
    package's make_pallas_scan does: packed compute reads the packed layout.
    `paired=False` (the plain lattice, which runs packed compute on either
    layout) checks the names only."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    check_compute(compute)
    if paired and compute == "packed" and layout != "packed":
        raise ValueError(
            "compute='packed' requires layout='packed': running the lattice "
            "on packed words while the carry rests wide would pay both "
            "layouts' repack work for neither's bytes")


def make_tick(cfg: RaftConfig, device="cuda", compute: str = "unpacked",
              batched: Optional[bool] = None):
    """tick(state, inject=None, fault_cmd=None) -> state: one tick through
    the plain phase_body, updating `state` in place (and returning it).
    `compute="packed"` runs the lattice in the §18 form (the JAX package's
    make_tick(compute="packed")): the same bits. `batched=False` runs a
    deep log's per-pair engine (make_flags)."""
    check_compute(compute)
    body = phase_body
    if compute == "packed":
        check_flags(dataclasses.replace(make_flags(cfg), packed_compute=True))
        body = packed_compute_body
    return make_stepper(cfg, device, body, batched=batched)


def deep_kernel_body(cfg: RaftConfig, s: dict, aux: dict,
                     flags: BodyFlags) -> torch.Tensor:
    """phase_body's deep engine with the deep gather and scatter kernels
    (their plain versions for a CPU state; the per-pair engine calls
    neither)."""
    return phase_body(cfg, s, aux, flags, gather=deep_gather.gather,
                      scatter=deep_scatter.scatter)


def make_deep_tick(cfg: RaftConfig, device="cuda",
                   batched: Optional[bool] = None,
                   compute: str = "unpacked"):
    """tick(state, inject=None, fault_cmd=None) -> state for a deep-log
    config: make_aux, the deep engine (the batched one through the deep
    gather and scatter kernels, or with `batched=False` — and at τ=0 — the
    per-pair one), the §7 deferred election draws — in place.
    `compute="packed"` runs it in the §18 form."""
    if not make_flags(cfg).dyn_log:
        raise ValueError("make_deep_tick needs a deep-log config "
                         "(phys_capacity >= 256)")
    check_compute(compute)
    body = deep_kernel_body
    if compute == "packed":
        body = functools.partial(packed_compute_body, body=body)
    return make_stepper(cfg, device, body, batched=batched)


TRACE_FIELDS = ("role", "term", "commit", "last_index", "voted_for",
                "rounds", "up")


def resolve_impl(impl: str, device: torch.device) -> str:
    """The tick backend make_run steps with: "kernel" or "plain"; "auto" is
    the kernel on cuda and plain on cpu. "kernel" means the tick kernel on
    a shallow config and the deep gather / scatter kernels on a deep one."""
    if impl == "auto":
        return "kernel" if device.type == "cuda" else "plain"
    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    return impl


def packed_shim(cfg: RaftConfig, pf: dict, tick: int):
    """What make_aux reads of a pre-tick state, from a flat packed dict:
    the tick, the counters and the role / up rows (for a leader-isolation
    bank)."""
    N = cfg.n_nodes
    ctrl = pf["ctrl_bits"]
    n = torch.arange(N, dtype=_I32, device=ctrl.device)[:, None]
    return types.SimpleNamespace(
        tick=tick, term=pf["term"], t_ctr=pf["t_ctr"], b_ctr=pf["b_ctr"],
        role=(ctrl[0][None] >> (2 * n)) & 3,
        up=(ctrl[2][None] >> (2 * N + n)) & 1)


def unpack_into(cfg: RaftConfig, state: RaftState, ps) -> None:
    """Write the packed state `ps` into the wide `state`, in place."""
    for k, v in unpack_state(cfg, ps).__dict__.items():
        if k != "tick" and v is not None:
            getattr(state, k).copy_(v)


def make_run(cfg: RaftConfig, n_ticks: int, trace: bool = True,
             impl: str = "auto", telemetry: bool = False,
             monitor: bool = False, device="cuda", layout: str = "wide",
             compute: str = "unpacked", batched: Optional[bool] = None,
             _width_latch: bool = False):
    """Runner: state -> (state, ys[, telemetry][, monitor]) stepping
    n_ticks, updating the state in place.

    ys is a dict of (T, N, G) tensors (TRACE_FIELDS, post-tick) when trace,
    else the per-tick (T, G) counts of role == LEADER (the JAX package's
    cheap mode). `impl`: "kernel" — on a shallow config the one-tick kernel
    (ops/cuda_tick), on a deep-log one the deep engine with the deep
    gather and scatter kernels (make_deep_tick); each runs its plain
    version for CPU tensors —, "plain" (phase_body and, on deep logs, the
    plain gather and scatter), or "auto" = the kernels on cuda, plain on
    cpu. `batched=False` runs a deep log's per-pair engine (the JAX
    package's make_run(batched=False)); a τ=0 mailbox config runs it
    whatever `batched` says. telemetry=True adds the flight recorder,
    monitor=True the safety monitor in its finalized form
    (utils/telemetry).

    `compute="packed"` runs the §18 lattice (make_tick(compute="packed")
    with impl "plain"; the kernels take it under the packed layout only, as
    the JAX package's make_pallas_scan pairs them: impl "kernel" with
    compute "packed" needs layout "packed", and on a deep config runs the
    deep engine in the §18 form).

    `layout="packed"` carries the §14 packed layout between ticks, as the
    JAX package's make_run(layout="packed") does: the state is packed at
    entry (models/state.pack_state), each tick reads it unpacked and
    writes it repacked, the width-overflow latch ORed across ticks, and
    the latch is read once at exit — a set latch raises RuntimeError
    ("width overflow"; the state then holds invalid bits). On a shallow
    config the kernels step the packed state in place with the one-tick
    kernel's packed instantiation (ops/cuda_tick.tick_kernel(layout=
    "packed")) and unpack it into the caller's state after each tick for
    the observers; otherwise (impl "plain", a deep config) each tick
    unpacks into the caller's state, ticks it and repacks. Either way
    run(state) takes and returns the wide state, updated in place.

    The one-tick kernel latches each log or §10 slot write that misses its
    packed range as it is made, so its latch may hold groups that the JAX
    package's rule (the values left at each tick's end) does not. The
    kernel route therefore keeps a clone of the entry state, and where its
    latch is set it restores that state and reruns wide, checking the
    packed range at entry and after each tick (`_width_latch`): it raises
    "width overflow" only where that check fails, and otherwise returns
    the wide rerun's results."""
    if n_ticks < 1:
        raise ValueError(f"n_ticks must be >= 1, got {n_ticks}")
    dev = require_device(device)
    flags = make_flags(cfg)
    plain = resolve_impl(impl, dev) == "plain"
    check_layout(layout, compute, paired=not plain)
    if compute == "packed":
        check_flags(dataclasses.replace(flags, packed_compute=True))
    packed = layout == "packed"
    packed_kernel = packed and not plain and not flags.dyn_log
    if packed_kernel:
        from raft_kotlin_tpu_torch.ops import cuda_tick

        check_supported(cfg)
        rng = make_rng(cfg, dev)

        def packed_tick(pf: dict, t: int) -> None:
            base, tkeys, bkeys, scen = split_rng(rng)
            aux, fl = make_aux(cfg, base, tkeys, bkeys,
                               packed_shim(cfg, pf, t), scen=scen)
            el_dirty = cuda_tick.tick_kernel(cfg, pf, aux, fl,
                                             layout="packed", compute=compute)
            materialize_el(cfg, tkeys, pf, el_dirty)
    elif plain:
        tick_fn = make_tick(cfg, dev, compute=compute, batched=batched)
    elif flags.dyn_log:
        tick_fn = make_deep_tick(cfg, dev, batched=batched, compute=compute)
    else:
        from raft_kotlin_tpu_torch.ops.cuda_tick import make_cuda_tick

        tick_fn = make_cuda_tick(cfg, dev)

    def run(state: RaftState):
        tel = telemetry_mod.telemetry_zeros(dev) if telemetry else None
        mon = telemetry_mod.monitor_init(cfg.n_groups, n_ticks, monitor,
                                         **telemetry_mod.ops_kw(cfg),
                                         device=dev)
        ps = pack_state(cfg, state) if packed else None
        entry = state.clone() if packed_kernel else None
        latch = pack_state(cfg, state).ov if _width_latch else None
        ys = []
        for _ in range(n_ticks):
            prev = telemetry_mod.state_view(state, clone=True) \
                if telemetry else None
            mprev = telemetry_mod.monitor_view(state, clone=True) \
                if monitor else None
            if packed_kernel:
                packed_tick(flatten_packed(cfg, ps), state.tick)
                ps.tick = state.tick = state.tick + 1
                unpack_into(cfg, state, ps)
            elif packed:
                # Unpack at read (into the caller's state), repack at
                # write, the latch chained.
                unpack_into(cfg, state, ps)
                tick_fn(state)
                ps = pack_state(cfg, state, ov=ps.ov)
            else:
                tick_fn(state)
            if latch is not None:
                latch = latch | pack_state(cfg, state).ov
            if telemetry:
                tel = telemetry_mod.telemetry_step_arrays(
                    prev, telemetry_mod.state_view(state), tel)
            if monitor:
                mon = telemetry_mod.monitor_step_arrays(
                    mprev, telemetry_mod.monitor_view(state), mon)
            if trace:
                ys.append({k: getattr(state, k).clone() for k in TRACE_FIELDS})
            else:
                ys.append((state.role == LEADER).sum(0, dtype=_I32))
        if trace:
            out = {k: torch.stack([y[k] for y in ys]) for k in TRACE_FIELDS}
        else:
            out = torch.stack(ys)
        if packed_kernel and bool(ps.ov.ne(0).any()):
            # The kernel's early latch: rerun wide under JAX's rule.
            for k in state.fields():
                getattr(state, k).copy_(getattr(entry, k))
            state.tick = entry.tick
            return make_run(cfg, n_ticks, trace=trace, impl=impl,
                            telemetry=telemetry, monitor=monitor,
                            device=dev, batched=batched,
                            _width_latch=True)(state)
        if packed or latch is not None:
            # The one host read of the latch.
            check_packed_ov(ps.ov if packed else latch)
        res = (state, out)
        if telemetry:
            res += (tel,)
        if monitor:
            res += (telemetry_mod.monitor_finalize(mon),)
        return res

    return run
