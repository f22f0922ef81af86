"""The flight recorder: a small dict of scalar counters accumulated on the
device from pre/post-tick states and read back once per run.

Counters are derived from state TRANSITIONS only, so they are
engine-independent: the kernel path and the plain path record the same
numbers, and both equal the JAX package's recorder (SEMANTICS of each counter
as in `raft_kotlin_tpu/utils/telemetry.py`). The fields the port does not
carry yet (§10 mailbox, §15 snapshots, deep-engine overflow) keep their
counters at 0, as they do on the JAX package's configs without them.
"""

from __future__ import annotations

from typing import Dict

import torch

from raft_kotlin_tpu_torch.constants import LEADER

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
    return out


def state_view(state, clone: bool = False) -> dict:
    """The recorder's view of a RaftState. The port updates states in place,
    so a view of the PRE-tick state must be taken with clone=True."""
    return {k: getattr(state, k).clone() if clone else getattr(state, k)
            for k in TELEMETRY_STATE_FIELDS}


def telemetry_step(prev_state, cur_state,
                   tel: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """telemetry_step_arrays over two RaftStates (one tick apart)."""
    return telemetry_step_arrays(state_view(prev_state),
                                 state_view(cur_state), tel)


def summarize_telemetry(tel: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """Host materialization of a recorder (the run's one read-back)."""
    return {k: int(tel[k]) for k in TELEMETRY_FIELDS if k in tel}
