"""Batched Raft state as a dataclass of tensors — groups-minor, as in the JAX
package: per-node fields are (N, G), pair fields (N, N, G) ([owner-1, peer-1,
g]), logs (N, C, G), so one thread per group reads every row coalesced. Node
axis index i holds node id i + 1 (ids are 1-based, as in the reference).

Storage dtypes match the JAX package's (`field_dtype`): structurally bounded
fields are int16, bools are torch.bool (one byte), unbounded counters int32.
`tick` is a host int: every draw of a tick is keyed by it, and keeping it on
the host spares the tick loop a device read.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from raft_kotlin_tpu_torch.utils import rng as rngmod
from raft_kotlin_tpu_torch.utils.config import RaftConfig


@dataclasses.dataclass
class RaftState:
    term: torch.Tensor         # (N, G) i32
    voted_for: torch.Tensor    # (N, G) i16, -1 = none
    role: torch.Tensor         # (N, G) i16 ∈ {FOLLOWER, CANDIDATE, LEADER}
    commit: torch.Tensor       # (N, G) i16
    last_index: torch.Tensor   # (N, G) i16
    phys_len: torch.Tensor     # (N, G) i16
    log_term: torch.Tensor     # (N, C, G) i32 (or i16 via cfg.log_dtype)
    log_cmd: torch.Tensor      # (N, C, G) i32 (or i16)
    last_term: torch.Tensor    # (N, G) i32 — cache of log_term[last_index-1]
    el_armed: torch.Tensor     # (N, G) bool
    el_left: torch.Tensor      # (N, G) i16
    round_state: torch.Tensor  # (N, G) i16 ∈ {IDLE, BACKOFF, ACTIVE}
    round_left: torch.Tensor   # (N, G) i16
    round_age: torch.Tensor    # (N, G) i16
    votes: torch.Tensor        # (N, G) i16
    responses: torch.Tensor    # (N, G) i16
    responded: torch.Tensor    # (N, N, G) bool
    bo_left: torch.Tensor      # (N, G) i16
    next_index: torch.Tensor   # (N, N, G) i16
    match_index: torch.Tensor  # (N, N, G) i16
    hb_armed: torch.Tensor     # (N, G) bool
    hb_left: torch.Tensor      # (N, G) i16
    up: torch.Tensor           # (N, G) bool
    link_up: torch.Tensor      # (N, N, G) bool
    t_ctr: torch.Tensor        # (N, G) i32
    b_ctr: torch.Tensor        # (N, G) i32
    rounds: torch.Tensor       # (N, G) i32
    cap_ov: torch.Tensor       # (N, G) i16 capacity-exhaustion latch
    tick: int = 0

    def clone(self) -> "RaftState":
        return RaftState(**{k: getattr(self, k).clone() for k in STATE_FIELDS},
                         tick=self.tick)


STATE_FIELDS = tuple(f.name for f in dataclasses.fields(RaftState)
                     if f.name != "tick")
PAIR_FIELDS = ("responded", "next_index", "match_index", "link_up")
LOG_FIELDS = ("log_term", "log_cmd")
BOOL_FIELDS = ("el_armed", "hb_armed", "up", "responded", "link_up")

# Structurally bounded fields stored int16 (the JAX package's NARROW16 minus
# the mailbox slots, which the port does not carry yet).
NARROW16 = (
    "voted_for", "role", "commit", "last_index", "phys_len", "el_left",
    "round_state", "round_left", "round_age", "votes", "responses",
    "bo_left", "next_index", "match_index", "hb_left",
)


def field_dtype(name: str, cfg: RaftConfig) -> torch.dtype:
    """Canonical storage dtype of a RaftState field under `cfg`."""
    if name in LOG_FIELDS:
        return torch.int16 if cfg.log_dtype == "int16" else torch.int32
    if name in BOOL_FIELDS:
        return torch.bool
    if name == "cap_ov":
        return torch.int16
    return torch.int16 if name in NARROW16 else torch.int32


def field_shape(name: str, cfg: RaftConfig) -> tuple:
    N, C, G = cfg.n_nodes, cfg.phys_capacity, cfg.n_groups
    if name in PAIR_FIELDS:
        return (N, N, G)
    if name in LOG_FIELDS:
        return (N, C, G)
    return (N, G)


def assert_narrow_bounds(cfg: RaftConfig) -> None:
    """Value-range guards for the int16 storage: log positions need
    log_capacity < 2^15 - 1 (next_index reaches log_capacity + 1) and every
    config value that seeds an int16 countdown must itself fit int16."""
    assert cfg.log_capacity < 2 ** 15 - 1, (
        "int16 log positions (NARROW16) need log_capacity < 32767 "
        "(next_index reaches log_capacity + 1)")
    assert max(cfg.el_hi, cfg.bo_hi, cfg.delay_hi,
               cfg.round_ticks, cfg.hb_ticks) < 2 ** 15, (
        "int16 countdown fields (NARROW16) need el_hi/bo_hi/delay_hi/"
        "round_ticks/hb_ticks < 32768")


def check_supported(cfg: RaftConfig) -> None:
    """The port carries the core state only: the §10 mailbox slots, the §15
    snapshot fields and §12 scenario banks are not ported yet."""
    if cfg.uses_mailbox:
        raise NotImplementedError("the §10 mailbox (delay_hi > 0 or "
                                  "mailbox=True) is not ported yet")
    if cfg.uses_compaction:
        raise NotImplementedError("§15 compaction is not ported yet")
    if cfg.scenario is not None:
        raise NotImplementedError("§12 scenario banks are not ported yet")


def require_device(device) -> torch.device:
    """The device an entry point runs on; a CUDA device with no card is an
    error, never a silent move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False "
            "(pass device='cpu' to run the plain version on the CPU)")
    return dev


def init_state(cfg: RaftConfig, device="cuda") -> RaftState:
    """The boot state: every node a FOLLOWER with an armed election timer
    drawn at counter 0 (t_ctr then starts at 1)."""
    check_supported(cfg)
    assert_narrow_bounds(cfg)
    dev = require_device(device)
    G, N = cfg.n_groups, cfg.n_nodes

    def full(name, v):
        return torch.full(field_shape(name, cfg), v,
                          dtype=field_dtype(name, cfg), device=dev)

    st = {k: full(k, 0) for k in STATE_FIELDS}
    st["voted_for"].fill_(-1)
    for k in ("el_armed", "up", "link_up", "t_ctr"):
        st[k].fill_(1)
    # Boot draw in the canonical (G, N) shape (SEMANTICS.md §4), transposed.
    base = rngmod.base_key(cfg.seed)
    ctr0 = torch.zeros((G, N), dtype=torch.int64, device=dev)
    el = rngmod.draw_uniform_grid(base, rngmod.KIND_TIMEOUT, ctr0,
                                  cfg.el_lo, cfg.el_hi)
    st["el_left"].copy_(el.T)
    return RaftState(**st, tick=0)


def state_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda",
                     cfg: RaftConfig | None = None) -> RaftState:
    """A RaftState from numpy arrays keyed by field name (plus "tick"): the
    bridge that carries the JAX package's state into the port, dtypes kept.
    With `cfg`, every field's dtype and shape is checked against it."""
    dev = require_device(device)
    st = {}
    for k in STATE_FIELDS:
        t = torch.from_numpy(np.array(arrays[k], copy=True)).to(dev)
        if cfg is not None and (t.dtype != field_dtype(k, cfg)
                                or tuple(t.shape) != field_shape(k, cfg)):
            raise ValueError(f"{k}: got {t.dtype}{tuple(t.shape)}, want "
                             f"{field_dtype(k, cfg)}{field_shape(k, cfg)}")
        st[k] = t
    return RaftState(**st, tick=int(arrays.get("tick", 0)))


def state_to_numpy(state: RaftState) -> dict:
    """Inverse of state_from_numpy: field name -> numpy array (tick as a
    numpy int32 scalar, the JAX package's () int32)."""
    out = {k: getattr(state, k).detach().cpu().numpy() for k in STATE_FIELDS}
    out["tick"] = np.int32(state.tick)
    return out
