"""The flight recorder and the safety-invariant monitor: small dicts of
counters accumulated on the device from pre/post-tick states and read back
once per run.

Counters are derived from state TRANSITIONS only, so they are
engine-independent: the kernel path and the plain path record the same
numbers, and both equal the JAX package's recorder (SEMANTICS of each counter
as in `raft_kotlin_tpu/utils/telemetry.py`). The fields the port does not
carry yet (§15 snapshots, deep-engine overflow) keep their counters at 0, as
they do on the JAX package's configs without them. Of the §10 mailbox's
slots the observers read two things (`mailbox_snapshot`): the slots in
flight (mailbox_inflight_hw, the monitor ring's inflight_hw) and which
nodes own an append slot in flight (the monitor's stale-append hazard) —
counted from the vq_due / aq_due planes, or a fused launch's per-tick
snapshot of the two, which stands in for the planes.

The monitor (the second half of this module) checks the Figure-3 safety
properties on every transition, with the JAX package's quirk exemptions,
and keeps a first-violation latch, per-invariant counts, two per-group
taint masks and a downsampled history ring — the base channel of the JAX
package's monitor, bit-equal to it — and its per-group channel
(PER_GROUP_KEYS, the fuzzing farm's per-universe counters, read back with
universe_stats). Its §19 timing and scheduler and §21 series and event
channels are not ported and raise NotImplementedError.
Both observers are plain PyTorch between kernel launches, as they are
plain XLA in the JAX package: neither touches the tick.
"""

from __future__ import annotations

from typing import Dict, Optional

import math

import torch

from raft_kotlin_tpu_torch.constants import LEADER

_I32 = torch.int32

TELEMETRY_FIELDS = (
    "elections_started",
    "leader_changes",
    "votes_granted",
    "commit_advances",
    "append_accepts",
    "append_rejects",
    "mailbox_inflight_hw",
    "ov_fallbacks",
    "fault_events",
    "snapshots_taken",
    "installsnap_deliveries",
    "cap_exhausted_events",
)

# The state fields one step reads.
TELEMETRY_STATE_FIELDS = (
    "role", "up", "rounds", "votes", "commit", "match_index", "next_index",
    "last_index", "cap_ov",
)


# The slots the in-flight count reads.
TELEMETRY_MAILBOX_FIELDS = ("vq_due", "aq_due")


def mailbox_snapshot(src: dict) -> Optional[torch.Tensor]:
    """What the observers read of the §10 slots, per group, (2, G) int32:
    row 0 the slots in flight (due >= 0), row 1 the bitmask of the nodes
    that own an append slot in flight (bit n: node n + 1). `src`'s
    "inflight" entry (a fused launch's snapshot of these rows), else
    counted from its vq_due / aq_due pair grids (either layout); None for
    a config without the mailbox."""
    if src.get("inflight") is not None:
        return src["inflight"]
    vq = src.get("vq_due")
    if vq is None:
        return None
    G = vq.shape[-1]
    aq = src["aq_due"].reshape(-1, G) >= 0  # row owner * N + peer
    N = math.isqrt(aq.shape[0])
    bit = torch.ones(N, dtype=_I32, device=aq.device) << torch.arange(
        N, dtype=_I32, device=aq.device)
    owners = (aq.view(N, N, G).any(1).to(_I32) * bit[:, None]).sum(
        0, dtype=_I32)
    count = (vq.reshape(-1, G) >= 0).sum(0, dtype=_I32) + aq.sum(
        0, dtype=_I32)
    return torch.stack([count, owners])


def _with_inflight(view: dict, src: dict, n_nodes: int) -> dict:
    """`view` plus, on a mailbox config, "inflight" ((1, G) slots in
    flight) and "aq_inflight" ((N, G) bool: the node owns an append slot
    in flight), from mailbox_snapshot(src)."""
    snap = mailbox_snapshot(src)
    if snap is not None:
        n = torch.arange(n_nodes, dtype=_I32, device=snap.device)[:, None]
        view["inflight"] = snap[0:1]
        view["aq_inflight"] = ((snap[1:2] >> n) & 1) != 0
    return view


def telemetry_zeros(device="cuda") -> Dict[str, torch.Tensor]:
    """A fresh recorder: every counter a () int64 zero on `device`."""
    return {k: torch.zeros((), dtype=torch.int64, device=device)
            for k in TELEMETRY_FIELDS}


def _s(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64).sum()


def telemetry_step_arrays(prev: dict, cur: dict,
                          tel: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One recorder step from pre/post-tick views (TELEMETRY_STATE_FIELDS in
    RaftState shapes). Returns the advanced recorder; inputs untouched."""
    i32 = torch.int32
    prev_up = prev["up"] != 0
    cur_up = cur["up"] != 0
    new_leader = (cur["role"] == LEADER) & cur_up & ~((prev["role"] == LEADER)
                                                      & prev_up)
    restarted = cur_up & ~prev_up
    # Round starts and restarts zero the tally before this tick's grants.
    new_round = cur["rounds"] > prev["rounds"]
    base_votes = torch.where(new_round | restarted, 0, prev["votes"].to(i32))
    d_votes = cur["votes"].to(i32) - base_votes
    # Win jumps and restart wipes move the owner's pair rows for bookkeeping.
    owner_reset = (new_leader | restarted)[:, None, :]
    d_mi = cur["match_index"].to(i32) - prev["match_index"].to(i32)
    d_ni = cur["next_index"].to(i32) - prev["next_index"].to(i32)

    out = dict(tel)
    out["elections_started"] = tel["elections_started"] + _s(
        cur["rounds"] - prev["rounds"])
    out["leader_changes"] = tel["leader_changes"] + _s(new_leader)
    out["votes_granted"] = tel["votes_granted"] + _s(d_votes.clamp(min=0))
    out["commit_advances"] = tel["commit_advances"] + _s(
        (cur["commit"].to(i32) - prev["commit"].to(i32)).clamp(min=0))
    out["append_accepts"] = tel["append_accepts"] + _s(
        torch.where(owner_reset, 0, d_mi.clamp(min=0)))
    out["append_rejects"] = tel["append_rejects"] + _s(
        torch.where(owner_reset, 0, (-d_ni).clamp(min=0)))
    out["fault_events"] = tel["fault_events"] + _s(prev_up != cur_up)
    out["cap_exhausted_events"] = tel["cap_exhausted_events"] + _s(
        (cur["cap_ov"] != 0) & ~(prev["cap_ov"] != 0))
    if cur.get("inflight") is not None:
        out["mailbox_inflight_hw"] = torch.maximum(
            tel["mailbox_inflight_hw"], _s(cur["inflight"]))
    return out


def flat_view(flat: dict, n_nodes: int) -> dict:
    """The recorder's view of the flat rank-2 layout (ops/tick.flatten_state
    or a fused launch's snapshot dict): pair grids (N*N, G) reshape to the
    canonical (N, N, G); the mailbox's in-flight count rides as
    "inflight"."""
    N = n_nodes
    v = {k: flat[k].reshape(N, N, -1)
         if k in ("match_index", "next_index") else flat[k]
         for k in TELEMETRY_STATE_FIELDS}
    return _with_inflight(v, flat, N)


def state_view(state, clone: bool = False) -> dict:
    """The recorder's view of a RaftState. The port updates states in place,
    so a view of the PRE-tick state must be taken with clone=True."""
    v = {k: getattr(state, k).clone() if clone else getattr(state, k)
         for k in TELEMETRY_STATE_FIELDS}
    return _with_inflight(
        v, {k: getattr(state, k) for k in TELEMETRY_MAILBOX_FIELDS},
        state.term.shape[0])


def telemetry_step(prev_state, cur_state,
                   tel: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """telemetry_step_arrays over two RaftStates (one tick apart)."""
    return telemetry_step_arrays(state_view(prev_state),
                                 state_view(cur_state), tel)


def summarize_telemetry(tel: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """Host materialization of a recorder (the run's one read-back)."""
    return {k: int(tel[k]) for k in TELEMETRY_FIELDS if k in tel}


# ---------------------------------------------------------------------------
# The safety-invariant monitor (the JAX package's utils/telemetry.py
# monitor section; SEMANTICS.md §11 states each check). Ids are the latch's
# tie-break order; snapshot_consistency (6) needs §15 compaction, which the
# port does not carry, so it never fires here.

INVARIANT_IDS = (
    "election_safety",
    "leader_append_only",
    "log_matching",
    "leader_completeness",
    "commit_monotonic",
    "committed_prefix",
    "snapshot_consistency",
)
N_INVARIANTS = len(INVARIANT_IDS)
MONITOR_WINDOWS = 32
RING_SIGNALS = ("commit_min", "commit_max", "leaders", "inflight_hw",
                "violations")
_RING_BIG = 2 ** 31 - 1

# State fields one monitor step reads (node grids (N, G), logs (N, C, G)).
MONITOR_STATE_FIELDS = ("role", "up", "term", "commit", "last_index",
                        "phys_len", "hb_armed", "log_term", "log_cmd",
                        "cap_ov")


def monitor_ring_stride(n_ticks: int, windows: int = MONITOR_WINDOWS) -> int:
    """Ticks per history-ring window so `windows` windows tile a run of
    n_ticks (the last window may be partial)."""
    return max(1, -(-int(n_ticks) // int(windows)))


def ops_kw(cfg) -> dict:
    """The §21 monitor_init kwargs of a config (series / event rings)."""
    return {"series": int(getattr(cfg, "series_windows", 0) or 0),
            "series_stride": int(getattr(cfg, "series_stride", 0) or 0),
            "events": int(getattr(cfg, "event_capacity", 0) or 0)}


# Per-group (universe) stress counters, carried when per_group=True:
# elections started (rounds delta), §9 liveness transitions and per-group
# violation counts — the fuzzing farm ranks universes by them with no
# per-tick host traffic (api/fuzz). grp_elections reads `rounds` in the
# step views; a per-group step on a view without it raises.
PER_GROUP_KEYS = ("grp_elections", "grp_fault_events", "grp_violations")


def monitor_init(n_groups: int, n_ticks: int, enabled: bool = True,
                 per_group: bool = False, timing: bool = False,
                 sched: bool = False, quiesce_ticks: int = 0,
                 series: int = 0, series_stride: int = 0, events: int = 0,
                 device="cuda") -> Optional[Dict[str, torch.Tensor]]:
    """A fresh monitor carry whose ring stride tiles an n_ticks run, or None
    when `enabled` is False. `per_group=True` adds the PER_GROUP_KEYS
    counters. The §19 timing / scheduler and §21 series / event channels
    raise."""
    if not enabled:
        return None
    off = {"timing": timing, "sched": sched, "series": series,
           "events": events}
    on = [k for k, v in off.items() if v]
    if on:
        raise NotImplementedError(
            f"monitor channels {on} are not ported yet (the base and "
            "per-group channels are)")
    return monitor_zeros(n_groups, monitor_ring_stride(n_ticks),
                         per_group=per_group, device=device)


def monitor_zeros(n_groups: int, ring_stride: int = 1,
                  windows: int = MONITOR_WINDOWS, per_group: bool = False,
                  device="cuda") -> Dict[str, torch.Tensor]:
    """A fresh monitor carry; `ring_stride` is baked in so summarize_monitor
    decodes the ring without out-of-band metadata; `per_group` adds the
    (G,) PER_GROUP_KEYS counters."""
    def full(shape, v, dtype=_I32):
        return torch.full(shape, v, dtype=dtype, device=device)

    out = {
        "tick": full((), 0),
        "latch_tick": full((), -1), "latch_group": full((), -1),
        "latch_inv": full((), -1),
        "viol_total": full((), 0),
        "viol_by_inv": full((N_INVARIANTS,), 0),
        "taint_restart": full((n_groups,), False, torch.bool),
        "taint_unsafe": full((n_groups,), False, torch.bool),
        "ring_commit_min": full((windows,), _RING_BIG),
        "ring_commit_max": full((windows,), -1),
        "ring_leaders": full((windows,), 0),
        "ring_inflight_hw": full((windows,), 0),
        "ring_violations": full((windows,), 0),
        "ring_stride": full((), int(ring_stride)),
    }
    if per_group:
        for k in PER_GROUP_KEYS:
            out[k] = full((n_groups,), 0)
    return out


def invariant_matrix(prev: dict, cur: dict, taint_restart: torch.Tensor,
                     taint_unsafe: torch.Tensor):
    """The per-tick verdicts: (V, taint_restart', taint_unsafe') with V an
    (N_INVARIANTS, G) bool matrix of per-group violations of the transition
    prev -> cur, the quirk exemptions applied (taints update first, so a
    restart enabling a same-tick violation exempts it). `prev`/`cur` map
    MONITOR_STATE_FIELDS to canonical-shape tensors; bool fields may be
    int stand-ins."""
    lt_p, lc_p = prev["log_term"], prev["log_cmd"]
    lt_c, lc_c = cur["log_term"], cur["log_cmd"]
    N, C, G = lt_c.shape
    dev = lt_c.device
    slot = torch.arange(C, dtype=_I32, device=dev)[:, None]

    prev_up = prev["up"] != 0
    cur_up = cur["up"] != 0
    restarted = cur_up & ~prev_up
    lead_p = (prev["role"] == LEADER) & prev_up
    lead = (cur["role"] == LEADER) & cur_up
    term_p = prev["term"].to(_I32)
    term = cur["term"].to(_I32)
    li_p = prev["last_index"].to(_I32)
    li_c = cur["last_index"].to(_I32)
    cm_p = prev["commit"].to(_I32)
    cm_c = cur["commit"].to(_I32)
    none = torch.zeros(G, dtype=torch.bool, device=dev)

    # Taints: restart is sticky; the unsafe-commit taint follows §5.4.2 (a
    # commit topping out on an old-term entry sets it, one topping out on
    # a current-term entry clears it).
    taint_restart = taint_restart | restarted.any(0)
    adv = (cm_c > cm_p) & lead & ~restarted
    unsafe, justify = none, none
    for n in range(N):
        top = torch.where(slot == cm_c[n][None] - 1, lt_c[n].to(_I32),
                          0).sum(0, dtype=_I32)
        top_cur = top == term[n]
        unsafe = unsafe | (adv[n] & ~top_cur)
        justify = justify | (adv[n] & top_cur)
    taint_unsafe = (taint_unsafe | unsafe) & ~(justify & ~unsafe)

    # Stale-append hazard window: a live non-leader with an armed heartbeat,
    # or (§10) an append slot in flight from a node that was no live leader
    # (a deposed leader's appends deliver late).
    hazard = ((prev["hb_armed"] != 0) & prev_up
              & (prev["role"] != LEADER)).any(0)
    if prev.get("aq_inflight") is not None:
        hazard = hazard | (prev["aq_inflight"] & ~lead_p).any(0)

    # 0 — Election Safety.
    two_lead = none
    for a in range(N):
        for b in range(a + 1, N):
            two_lead = two_lead | (lead[a] & lead[b] & (term[a] == term[b]))
    v0 = two_lead & ~taint_restart

    # 1 — Leader Append-Only, content form.
    cont = lead & lead_p & (term == term_p)
    v1 = none
    for n in range(N):
        keep = slot < torch.minimum(li_p[n], li_c[n])[None]
        changed = (keep & ((lt_p[n] != lt_c[n]) | (lc_p[n] != lc_c[n]))).any(0)
        v1 = v1 | (cont[n] & changed)

    # 2/3 — Log Matching + Leader Completeness over pristine logs.
    pristine = cur["phys_len"].to(_I32) == li_c
    rc = torch.minimum(cm_c, li_c)
    v2, v3 = none, none
    for a in range(N):
        for b in range(a + 1, N):
            mism = (lt_c[a] != lt_c[b]) | (lc_c[a] != lc_c[b])
            valid = slot < torch.minimum(li_c[a], li_c[b])[None]
            bad_pref = torch.cumsum((mism & valid).to(_I32), 0) > 0
            v2 = v2 | (pristine[a] & pristine[b] & (
                valid & (lt_c[a] == lt_c[b]) & bad_pref).any(0))
            for l, n in ((a, b), (b, a)):
                lim = torch.minimum(rc[n], li_c[l])[None]
                diff = (mism & (slot < lim)).any(0)
                v3 = v3 | (lead[l] & pristine[l] & pristine[n]
                           & ~restarted[n] & ((rc[n] > li_c[l]) | diff))
    v2 = v2 & ~taint_restart
    v3 = v3 & ~taint_restart & ~taint_unsafe & ~hazard

    # 4 — group commit-frontier monotonicity (restart-masked prev side).
    fr_prev = torch.where(restarted, 0, cm_p).amax(0)
    v4 = cm_c.amax(0) < fr_prev

    # 5 — committed-prefix immutability per node, content form.
    v5 = none
    for n in range(N):
        keep = slot < torch.minimum(cm_p[n], li_p[n])[None]
        changed = (keep & ((lt_p[n] != lt_c[n]) | (lc_p[n] != lc_c[n]))).any(0)
        v5 = v5 | (~restarted[n] & changed)
    v5 = v5 & ~taint_restart & ~taint_unsafe & ~hazard

    V = torch.stack([v0, v1, v2, v3, v4, v5, none])
    return V, taint_restart, taint_unsafe


def monitor_step_arrays(prev: dict, cur: dict,
                        mon: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """One monitor step from pre/post-tick views: the checks, the latch,
    the counters, the taints and the history ring. Returns the advanced
    carry (a new dict; inputs untouched)."""
    V, tr, tu = invariant_matrix(prev, cur, mon["taint_restart"],
                                 mon["taint_unsafe"])
    out = dict(mon)
    out["taint_restart"], out["taint_unsafe"] = tr, tu
    tick = mon["tick"]
    per_inv = V.to(_I32).sum(1, dtype=_I32)
    vc = per_inv.sum(dtype=_I32)
    out["viol_by_inv"] = mon["viol_by_inv"] + per_inv
    out["viol_total"] = mon["viol_total"] + vc

    if "grp_violations" in mon:
        # The per-group counters: the same transition reductions, kept
        # (G,)-wide in the carry.
        out["grp_violations"] = mon["grp_violations"] + V.to(_I32).sum(
            0, dtype=_I32)
        out["grp_fault_events"] = mon["grp_fault_events"] + (
            (prev["up"] != 0) != (cur["up"] != 0)).to(_I32).sum(
            0, dtype=_I32)
        r_p, r_c = prev.get("rounds"), cur.get("rounds")
        if r_p is None or r_c is None:
            raise ValueError(
                "per-group monitor counters need `rounds` in the step views "
                "(snapshot it: fused_snapshot_fields(per_group=True))")
        out["grp_elections"] = mon["grp_elections"] + (
            r_c.to(_I32) - r_p.to(_I32)).sum(0, dtype=_I32)

    # First-violation latch: lexicographic (group, invariant) within the
    # tick via a masked min; earlier ticks latch first.
    G = V.shape[1]
    dev = V.device
    key = (torch.arange(G, dtype=_I32, device=dev)[None] * N_INVARIANTS
           + torch.arange(N_INVARIANTS, dtype=_I32, device=dev)[:, None])
    k = torch.where(V, key, _RING_BIG).amin()
    newly = (mon["latch_tick"] < 0) & (vc > 0)
    out["latch_tick"] = torch.where(newly, tick, mon["latch_tick"])
    out["latch_group"] = torch.where(newly, k // N_INVARIANTS,
                                     mon["latch_group"])
    out["latch_inv"] = torch.where(newly, k % N_INVARIANTS, mon["latch_inv"])

    # History ring: slot (tick // stride) % W, reset to the signal's
    # identity on a window's first tick.
    stride = mon["ring_stride"]
    W = mon["ring_violations"].shape[0]
    hot = torch.arange(W, dtype=_I32, device=dev) == (tick // stride) % W
    entering = (tick % stride) == 0
    fr = cur["commit"].to(_I32).amax(0)
    leaders = ((cur["role"] == LEADER) & (cur["up"] != 0)).sum(dtype=_I32)
    infl = cur["inflight"].sum(dtype=_I32) \
        if cur.get("inflight") is not None \
        else torch.zeros((), dtype=_I32, device=dev)

    def ring(name, val, combine, ident):
        r = mon[f"ring_{name}"]
        base = torch.where(entering, torch.full_like(r, ident), r)
        out[f"ring_{name}"] = torch.where(hot, combine(base, val), r)

    ring("commit_min", fr.amin(), torch.minimum, _RING_BIG)
    ring("commit_max", fr.amax(), torch.maximum, -1)
    ring("leaders", leaders, torch.maximum, 0)
    ring("inflight_hw", infl, torch.maximum, 0)
    ring("violations", vc, torch.add, 0)
    out["tick"] = tick + 1
    return out


def monitor_view(state, clone: bool = False) -> dict:
    """The monitor's view of a RaftState (clone=True for a PRE-tick view:
    the port updates states in place); `rounds` rides for the per-group
    counters."""
    v = {k: getattr(state, k).clone() if clone else getattr(state, k)
         for k in MONITOR_STATE_FIELDS + ("rounds",)}
    return _with_inflight(
        v, {k: getattr(state, k) for k in TELEMETRY_MAILBOX_FIELDS},
        state.term.shape[0])


def monitor_flat_view(flat: dict, n_nodes: int) -> dict:
    """The monitor's view of the flat rank-2 layout: logs (N*C, G) ->
    (N, C, G); the mailbox's in-flight count as "inflight"."""
    N = n_nodes
    v = {k: flat[k].reshape(N, -1, flat[k].shape[-1])
         if k in ("log_term", "log_cmd") else flat[k]
         for k in MONITOR_STATE_FIELDS}
    v["rounds"] = flat.get("rounds")  # the per-group counters only
    return _with_inflight(v, flat, N)


def monitor_finalize(mon: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """End-of-run form: the (G,) taint masks reduce to group counts.
    Idempotent."""
    if "taint_restart" not in mon:
        return dict(mon)
    out = {k: v for k, v in mon.items()
           if k not in ("taint_restart", "taint_unsafe")}
    out["taint_restart_groups"] = mon["taint_restart"].sum(dtype=_I32)
    out["taint_unsafe_groups"] = mon["taint_unsafe"].sum(dtype=_I32)
    return out


def universe_stats(mon: Dict[str, torch.Tensor]) -> dict:
    """Host numpy of the per-group channels of a RAW (un-finalized)
    per-group monitor carry: the PER_GROUP_KEYS counters and the two taint
    masks — the farm's ranking and coverage input (api/fuzz)."""
    keys = [k for k in PER_GROUP_KEYS + ("taint_restart", "taint_unsafe")
            if k in mon]
    return {k: mon[k].cpu().numpy() for k in keys}


def monitor_scalars(mon: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The monitor as flat () scalars under the inv_* reporting prefix."""
    fin = monitor_finalize(mon)
    return {
        "inv_violations": fin["viol_total"],
        "inv_latch_tick": fin["latch_tick"],
        "inv_latch_group": fin["latch_group"],
        "inv_latch_inv": fin["latch_inv"],
        "inv_taint_restart_groups": fin["taint_restart_groups"],
        "inv_taint_unsafe_groups": fin["taint_unsafe_groups"],
        "inv_ring_commit_lo": fin["ring_commit_min"].amin(),
        "inv_ring_commit_hi": fin["ring_commit_max"].amax(),
        "inv_ring_leaders_hw": fin["ring_leaders"].amax(),
        "inv_ring_inflight_hw": fin["ring_inflight_hw"].amax(),
    }


def status_from_scalars(stats: Optional[dict]) -> Optional[str]:
    """"clean", or "<invariant>@t<tick>/g<group>", from monitor_scalars
    output (host ints); None for a run without a monitor."""
    if not stats or "inv_latch_tick" not in stats:
        return None
    t = int(stats["inv_latch_tick"])
    if t < 0:
        return "clean"
    name = INVARIANT_IDS[int(stats["inv_latch_inv"])]
    return f"{name}@t{t}/g{int(stats['inv_latch_group'])}"


def summarize_monitor(mon: Dict[str, torch.Tensor]) -> dict:
    """Host materialization of a monitor carry (finalized or not): status,
    latch, per-invariant counts, taint coverage and the history ring in
    chronological windows (a run longer than the ring keeps the last W)."""
    host = {k: v.cpu() for k, v in monitor_finalize(mon).items()}
    ticks = int(host["tick"])
    stride = int(host["ring_stride"])
    W = len(host["ring_violations"])
    total_w = -(-ticks // stride) if ticks else 0
    if total_w <= W:
        order = list(range(total_w))
    else:
        first = total_w % W
        order = [(first + i) % W for i in range(W)]
    windows = [{sig: int(host[f"ring_{sig}"][w]) for sig in RING_SIGNALS}
               for w in order]
    lt = int(host["latch_tick"])
    latch = None if lt < 0 else {
        "tick": lt,
        "group": int(host["latch_group"]),
        "invariant_id": int(host["latch_inv"]),
        "invariant": INVARIANT_IDS[int(host["latch_inv"])],
    }
    status = "clean" if latch is None else (
        f"{latch['invariant']}@t{latch['tick']}/g{latch['group']}")
    return {
        "inv_status": status,
        "latch": latch,
        "ticks": ticks,
        "violations": int(host["viol_total"]),
        "viol_by_inv": {name: int(host["viol_by_inv"][i])
                        for i, name in enumerate(INVARIANT_IDS)},
        "taint_restart_groups": int(host["taint_restart_groups"]),
        "taint_unsafe_groups": int(host["taint_unsafe_groups"]),
        "ring_stride": stride,
        "ring": windows,
    }


# ---------------------------------------------------------------------------
# The fused kernel's in-kernel observers (csrc/fused_tick_kernel.cu, its
# observer build): each launch computes, for every tick and group, what
# telemetry_step_arrays and monitor_step_arrays compute of that tick's
# transition, updates the monitor's per-group carry (the taints and the
# PER_GROUP_KEYS counters) in place, and reduces the rest into one int64
# row per tick — sums, the latch key's minimum and the frontier's minimum
# and maximum, all integer, so the order of the reduction cannot change a
# bit. `fold_obs_rows` turns a launch's (T, R) rows into the recorder and
# the monitor carry exactly as T steps of the two step functions would.
# `obs_tick_rows` is the per-group computation's plain form (the wrapper's
# CPU path, ops/cuda_tick.fused_tick_plain(obs=...)).

# The recorder sums, in TELEMETRY_FIELDS order of the fields a step adds to.
OBS_SUM_FIELDS = ("elections_started", "leader_changes", "votes_granted",
                  "commit_advances", "append_accepts", "append_rejects",
                  "fault_events", "cap_exhausted_events")
OBS_INFLIGHT = len(OBS_SUM_FIELDS)          # sum of the slots in flight
OBS_VIOL = OBS_INFLIGHT + 1                 # N_INVARIANTS violation sums
OBS_LATCH = OBS_VIOL + N_INVARIANTS         # min of group * 7 + invariant
OBS_FR_MIN = OBS_LATCH + 1                  # min of the group frontiers
OBS_FR_MAX = OBS_FR_MIN + 1                 # max of the group frontiers
OBS_LEADERS = OBS_FR_MAX + 1                # live leaders
OBS_R = OBS_LEADERS + 1


def obs_rows_init(T: int, device) -> torch.Tensor:
    """A launch's (T, OBS_R) int64 rows at their identities, made on
    `device` (no host copy, which would wait for the card's queue)."""
    rows = torch.zeros((T, OBS_R), dtype=torch.int64, device=device)
    rows[:, OBS_LATCH:OBS_FR_MAX].fill_(_RING_BIG)
    rows[:, OBS_FR_MAX].fill_(-1)
    return rows


def _below(mask: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """(C, G) bool `mask` restricted to the slots below the (G,) bound."""
    slot = torch.arange(mask.shape[0], dtype=_I32, device=mask.device)
    return mask & (slot[:, None] < bound[None])


def obs_tick_rows(pre: dict, cur: dict, written: torch.Tensor,
                  changed: torch.Tensor, owners_prev, inflight,
                  carry: dict, monitor: bool,
                  reads: Optional[dict] = None) -> torch.Tensor:
    """One tick's observer row from the pre-tick view `pre` and the post-
    tick view `cur` (MONITOR_STATE_FIELDS + TELEMETRY_STATE_FIELDS, flat:
    node grids (N, G), pair grids (N*N, G), logs (N*C, G)), per group as
    the kernel computes it:

    - invariants 1 and 5 from the tick's own log writes: `written` (N*C, G)
      marks the slots the tick wrote and `changed` those whose value now
      differs from the tick's start (ops/tick.phase_body's `track`), in
      place of a copy of the pre-tick logs;
    - the §10 hazard from `owners_prev` ((G,) int32 bitmask of the nodes
      owning an append slot in flight at the tick's start, or None), the
      recorder's and the ring's slots in flight from `inflight` ((2, G),
      telemetry.mailbox_snapshot of the post-tick state, or None);
    - `carry` ("taint_restart", "taint_unsafe" and the PER_GROUP_KEYS, each
      (G,) or absent) updated in place.

    `monitor=False` computes the recorder's part alone. `reads`, when
    given, receives "log": the (N*C, G) mask of the post-tick log slots the
    kernel's monitor reads (each top-of-commit slot it checks, and each
    pristine node's slots below its group's longest common pair prefix
    where the restart taint does not void invariants 2 and 3), for the
    kernel's byte bound. Returns the (OBS_R,) int64 row."""
    i32 = _I32
    N = pre["up"].shape[0]
    G = pre["up"].shape[-1]
    dev = pre["up"].device
    row = obs_rows_init(1, dev)[0]
    pu, cu = pre["up"] != 0, cur["up"] != 0
    rs = cu & ~pu
    lp = (pre["role"] == LEADER) & pu
    lc = (cur["role"] == LEADER) & cu
    nl = lc & ~lp
    r_p, r_c = pre["rounds"].to(i32), cur["rounds"].to(i32)
    el = (r_c - r_p).sum(0, dtype=i32)
    base = torch.where((r_c > r_p) | rs, 0, pre["votes"].to(i32))
    reset = (nl | rs).repeat_interleave(N, 0)  # pair row a * N + b: owner a
    mi_p, mi_c = pre["match_index"].to(i32), cur["match_index"].to(i32)
    ni_p, ni_c = pre["next_index"].to(i32), cur["next_index"].to(i32)
    fe = (pu != cu).sum(0, dtype=i32)
    sums = [el, nl.sum(0, dtype=i32),
            (cur["votes"].to(i32) - base).clamp(min=0).sum(0, dtype=i32),
            (cur["commit"].to(i32) - pre["commit"].to(i32)).clamp(min=0)
            .sum(0, dtype=i32),
            torch.where(reset, 0, (mi_c - mi_p).clamp(min=0)).sum(0),
            torch.where(reset, 0, (ni_p - ni_c).clamp(min=0)).sum(0), fe,
            ((cur["cap_ov"] != 0) & (pre["cap_ov"] == 0)).sum(0, dtype=i32)]
    row[:OBS_INFLIGHT] = torch.stack([x.to(torch.int64).sum() for x in sums])
    if inflight is not None:
        row[OBS_INFLIGHT] = inflight[0].to(torch.int64).sum()
    if not monitor:
        return row

    C = cur["log_term"].shape[0] // N
    lt = cur["log_term"].reshape(N, C, G).to(i32)
    lcm = cur["log_cmd"].reshape(N, C, G).to(i32)
    written = written.reshape(N, C, G)
    changed = changed.reshape(N, C, G) & written
    term_p, term_c = pre["term"].to(i32), cur["term"].to(i32)
    li_p, li_c = pre["last_index"].to(i32), cur["last_index"].to(i32)
    cm_p, cm_c = pre["commit"].to(i32), cur["commit"].to(i32)
    none = torch.zeros(G, dtype=torch.bool, device=dev)
    tr = carry.get("taint_restart", none) | rs.any(0)
    adv = (cm_c > cm_p) & lc & ~rs
    top = torch.stack([
        torch.where((cm_c[n] >= 1) & (cm_c[n] <= C),
                    torch.gather(lt[n], 0, (cm_c[n] - 1).clamp(0, C - 1)
                                 .long()[None])[0], 0) for n in range(N)])
    unsafe = (adv & (top != term_c)).any(0)
    justify = (adv & (top == term_c)).any(0)
    tu = (carry.get("taint_unsafe", none) | unsafe) & ~(justify & ~unsafe)
    hazard = ((pre["hb_armed"] != 0) & pu & (pre["role"] != LEADER)).any(0)
    if owners_prev is not None:
        bit = (owners_prev[None] >> torch.arange(N, dtype=i32, device=dev)
               [:, None]) & 1
        hazard = hazard | ((bit != 0) & ~lp).any(0)
    v0 = none
    for a in range(N):
        for b in range(a + 1, N):
            v0 = v0 | (lc[a] & lc[b] & (term_c[a] == term_c[b]))
    v0 = v0 & ~tr
    cont = lc & lp & (term_c == term_p)
    v1 = torch.stack([cont[n] & _below(changed[n], torch.minimum(
        li_p[n], li_c[n])).any(0) for n in range(N)]).any(0)
    pristine = cur["phys_len"].to(i32) == li_c
    rc = torch.minimum(cm_c, li_c)
    slot = torch.arange(C, dtype=i32, device=dev)[:, None]
    v2, v3 = none, none
    for a in range(N):
        for b in range(a + 1, N):
            mism = (lt[a] != lt[b]) | (lcm[a] != lcm[b])
            valid = slot < torch.minimum(li_c[a], li_c[b])[None]
            seen = torch.cumsum((mism & valid).to(i32), 0) > 0
            v2 = v2 | (pristine[a] & pristine[b] & (
                valid & (lt[a] == lt[b]) & seen).any(0))
            for l, n in ((a, b), (b, a)):
                lim = torch.minimum(rc[n], li_c[l])[None]
                v3 = v3 | (lc[l] & pristine[l] & pristine[n] & ~rs[n] & (
                    (rc[n] > li_c[l]) | (mism & (slot < lim)).any(0)))
    v2 = v2 & ~tr
    v3 = v3 & ~tr & ~tu & ~hazard
    if reads is not None:
        common = torch.zeros(G, dtype=i32, device=dev)
        for a in range(N):
            for b in range(a + 1, N):
                common = torch.maximum(common, torch.where(
                    pristine[a] & pristine[b],
                    torch.minimum(li_c[a], li_c[b]), 0))
        common = torch.where(tr, 0, common)
        lim = torch.where(pristine, torch.minimum(li_c, common[None]), 0)
        mask = slot[None] < lim[:, None]
        mask = mask | ((slot[None] == (cm_c - 1)[:, None]) & adv[:, None])
        reads["log"] = mask.reshape(N * C, G)
    v4 = cm_c.amax(0) < torch.where(rs, 0, cm_p).amax(0)
    v5 = torch.stack([~rs[n] & _below(changed[n], torch.minimum(
        cm_p[n], li_p[n])).any(0) for n in range(N)]).any(0)
    v5 = v5 & ~tr & ~tu & ~hazard
    V = torch.stack([v0, v1, v2, v3, v4, v5, none])
    key = (torch.arange(G, dtype=torch.int64, device=dev)[None] * N_INVARIANTS
           + torch.arange(N_INVARIANTS, dtype=torch.int64,
                          device=dev)[:, None])
    fr = cm_c.amax(0).to(torch.int64)
    row[OBS_VIOL:OBS_LATCH] = V.sum(1)
    row[OBS_LATCH] = torch.where(V, key, _RING_BIG).amin()
    row[OBS_FR_MIN] = fr.amin()
    row[OBS_FR_MAX] = fr.amax()
    row[OBS_LEADERS] = lc.sum()
    if "taint_restart" in carry:
        carry["taint_restart"].copy_(tr)
        carry["taint_unsafe"].copy_(tu)
    if "grp_violations" in carry:
        carry["grp_violations"].add_(V.sum(0, dtype=i32))
        carry["grp_fault_events"].add_(fe)
        carry["grp_elections"].add_(el)
    return row


def fold_obs_rows(rows: torch.Tensor, tel: Optional[dict],
                  mon: Optional[dict]) -> tuple:
    """Advance the recorder `tel` and the monitor carry `mon` (either None)
    over a launch's (T, OBS_R) rows, as T steps of telemetry_step_arrays
    and monitor_step_arrays would (the per-group parts of `mon` are already
    advanced in place by the launch). A handful of small device operations
    a launch, none reading back to the host. Returns (tel, mon)."""
    T = rows.shape[0]
    if tel is not None:
        vals = torch.stack([tel[k] for k in OBS_SUM_FIELDS]) \
            + rows[:, :OBS_INFLIGHT].sum(0)
        tel = {**tel, **dict(zip(OBS_SUM_FIELDS, vals.unbind()))}
        tel["mailbox_inflight_hw"] = torch.maximum(
            tel["mailbox_inflight_hw"], rows[:, OBS_INFLIGHT].amax())
    if mon is None:
        return tel, mon
    dev = rows.device
    out = dict(mon)
    per_t = rows[:, OBS_VIOL:OBS_LATCH]
    vc = per_t.sum(1)                                   # (T,)
    out["viol_by_inv"] = mon["viol_by_inv"] + per_t.sum(0).to(_I32)
    out["viol_total"] = mon["viol_total"] + vc.sum().to(_I32)
    # The latch: the launch's first tick with a violation, its least key.
    tick0 = mon["tick"]
    hit = vc > 0
    first = torch.argmax(hit.to(_I32))
    key = rows[:, OBS_LATCH].gather(0, first.view(1))[0].to(_I32)
    newly = (mon["latch_tick"] < 0) & hit.any()
    out["latch_tick"] = torch.where(newly, tick0 + first.to(_I32),
                                    mon["latch_tick"])
    out["latch_group"] = torch.where(newly, key // N_INVARIANTS,
                                     mon["latch_group"])
    out["latch_inv"] = torch.where(newly, key % N_INVARIANTS,
                                   mon["latch_inv"])
    # The ring: a window's value after the launch is its signal combined
    # over the launch's ticks in it since the last tick that entered it
    # (from the identity), or since the launch's start (from its value).
    stride = mon["ring_stride"]
    W = mon["ring_violations"].shape[0]
    tt = torch.arange(T, dtype=_I32, device=dev)
    ticks = tick0 + tt
    slot = ((ticks // stride) % W).long()
    enter = torch.where(ticks % stride == 0, tt, -1)
    last = torch.full((W,), -1, dtype=_I32, device=dev).scatter_reduce(
        0, slot, enter, "amax")
    keep = tt >= last[slot]
    seen = torch.zeros(W, dtype=torch.bool, device=dev).scatter(
        0, slot, torch.ones(T, dtype=torch.bool, device=dev))
    sig = {"commit_min": (rows[:, OBS_FR_MIN], "amin", _RING_BIG),
           "commit_max": (rows[:, OBS_FR_MAX], "amax", -1),
           "leaders": (rows[:, OBS_LEADERS], "amax", 0),
           "inflight_hw": (rows[:, OBS_INFLIGHT], "amax", 0),
           "violations": (vc, "sum", 0)}
    for name, (val, how, ident) in sig.items():
        r = mon[f"ring_{name}"]
        v = torch.where(keep, val.to(_I32), ident)
        agg = torch.full((W,), ident, dtype=_I32, device=dev).scatter_reduce(
            0, slot, v, how)
        base = torch.where(last >= 0, ident, r)
        comb = {"amin": torch.minimum, "amax": torch.maximum,
                "sum": torch.add}[how](base, agg)
        out[f"ring_{name}"] = torch.where(seen, comb, r)
    out["tick"] = tick0 + T
    return tel, out
