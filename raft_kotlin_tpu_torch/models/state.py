"""Batched Raft state as a dataclass of tensors — groups-minor, as in the JAX
package: per-node fields are (N, G), pair fields (N, N, G) ([owner-1, peer-1,
g]), logs (N, C, G), so one thread per group reads every row coalesced. Node
axis index i holds node id i + 1 (ids are 1-based, as in the reference).

Storage dtypes match the JAX package's (`field_dtype`): structurally bounded
fields are int16, bools are torch.bool (one byte), unbounded counters int32.
`tick` is a host int: every draw of a tick is keyed by it, and keeping it on
the host spares the tick loop a device read.

A config with the §10 mailbox (`cfg.uses_mailbox`) carries 13 more (N, N, G)
pair fields, the capacity-1 in-flight exchange slots (MAILBOX_FIELDS); on
any other config they are None, as in the JAX package. A §15 compaction
config (`cfg.uses_compaction`) carries the three (N, G) int32 snapshot
planes (SNAPSHOT_FIELDS), and its position-valued fields (POSITION_FIELDS)
widen to int32: positions are unbounded once the log window slides.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from raft_kotlin_tpu_torch.utils import rng as rngmod
from raft_kotlin_tpu_torch.utils.config import RaftConfig


@dataclasses.dataclass
class RaftState:
    term: torch.Tensor         # (N, G) i32
    voted_for: torch.Tensor    # (N, G) i16, -1 = none
    role: torch.Tensor         # (N, G) i16 ∈ {FOLLOWER, CANDIDATE, LEADER}
    commit: torch.Tensor       # (N, G) i16 (i32 under §15 compaction)
    last_index: torch.Tensor   # (N, G) i16 (i32 under §15 compaction)
    phys_len: torch.Tensor     # (N, G) i16 (i32 under §15 compaction)
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
    # §10 mailbox slots, [owner-1, peer-1, g] (None without the mailbox).
    # *_due is the delivery countdown (-1 = empty, 0 = deliverable this
    # tick); the rest is the request snapshot taken at the send.
    vq_due: Optional[torch.Tensor] = None    # vote slots (owner: candidate)
    vq_term: Optional[torch.Tensor] = None
    vq_lli: Optional[torch.Tensor] = None    # lastLogIndex
    vq_llt: Optional[torch.Tensor] = None    # lastLogTerm
    vq_round: Optional[torch.Tensor] = None  # rounds stamp (straggler guard)
    aq_due: Optional[torch.Tensor] = None    # append slots (owner: leader)
    aq_term: Optional[torch.Tensor] = None
    aq_pli: Optional[torch.Tensor] = None    # prevLogIndex
    aq_plt: Optional[torch.Tensor] = None    # prevLogTerm
    aq_hase: Optional[torch.Tensor] = None   # 1 iff an entry rides along
    aq_ent_t: Optional[torch.Tensor] = None  # the entry (term, cmd)
    aq_ent_c: Optional[torch.Tensor] = None
    aq_commit: Optional[torch.Tensor] = None  # leaderCommit
    # §15 snapshot planes (None without compaction). snap_index is also the
    # ring base of the log window: positions below it are folded into the
    # snapshot and their ring slots recycled.
    snap_index: Optional[torch.Tensor] = None   # (N, G) i32 folded prefix
    snap_term: Optional[torch.Tensor] = None    # (N, G) i32 term at base-1
    snap_digest: Optional[torch.Tensor] = None  # (N, G) i32 folded digest

    def fields(self) -> tuple:
        """The tensor fields this state carries: STATE_FIELDS, then
        MAILBOX_FIELDS when it has the slots, then SNAPSHOT_FIELDS when it
        has the snapshot planes."""
        return STATE_FIELDS + (
            MAILBOX_FIELDS if self.vq_due is not None else ()) + (
            SNAPSHOT_FIELDS if self.snap_index is not None else ())

    def clone(self) -> "RaftState":
        return RaftState(**{k: getattr(self, k).clone()
                            for k in self.fields()}, tick=self.tick)


MAILBOX_FIELDS = (
    "vq_due", "vq_term", "vq_lli", "vq_llt", "vq_round",
    "aq_due", "aq_term", "aq_pli", "aq_plt", "aq_hase",
    "aq_ent_t", "aq_ent_c", "aq_commit",
)
# §15 snapshot planes, present iff cfg.uses_compaction, canonical order.
SNAPSHOT_FIELDS = ("snap_index", "snap_term", "snap_digest")
STATE_FIELDS = tuple(f.name for f in dataclasses.fields(RaftState)
                     if f.name != "tick" and f.name not in MAILBOX_FIELDS
                     and f.name not in SNAPSHOT_FIELDS)
PAIR_FIELDS = ("responded", "next_index", "match_index", "link_up")
LOG_FIELDS = ("log_term", "log_cmd")
BOOL_FIELDS = ("el_armed", "hb_armed", "up", "responded", "link_up")

# Structurally bounded fields stored int16 (the JAX package's NARROW16).
NARROW16 = (
    "voted_for", "role", "commit", "last_index", "phys_len", "el_left",
    "round_state", "round_left", "round_age", "votes", "responses",
    "bo_left", "next_index", "match_index", "hb_left",
    # §10 mailbox: index-, countdown- and flag-valued slots. The term-valued
    # slots, the cmd payload and the rounds stamp stay int32 like their
    # sources.
    "vq_due", "vq_lli", "aq_due", "aq_pli", "aq_hase", "aq_commit",
)


# Position-valued fields: int16 without compaction; unbounded logical
# positions under §15 compaction (the window slides forever), where
# field_dtype widens them to int32.
POSITION_FIELDS = ("commit", "last_index", "phys_len", "next_index",
                   "match_index", "vq_lli", "aq_pli", "aq_commit")

# §15 command-digest fold: digest' = digest * DIGEST_MULT + cmd in wrapping
# int32 (two's complement).
DIGEST_MULT = 1000003


def fold_digest_py(digest: int, cmd: int) -> int:
    """The §15 digest fold on host ints, bit-identical to the kernels'
    wrapping-int32 arithmetic."""
    v = (digest * DIGEST_MULT + cmd) & 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def fold_digest(digest: torch.Tensor, cmd: torch.Tensor) -> torch.Tensor:
    """fold_digest_py on int32 tensors: the multiply-add in int64, wrapped
    back to int32 (torch's int32 multiply wraps too, but int64 keeps the
    wrap explicit)."""
    v = (digest.to(torch.int64) * DIGEST_MULT + cmd.to(torch.int64)) \
        & 0xFFFFFFFF
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def field_dtype(name: str, cfg: RaftConfig) -> torch.dtype:
    """Canonical storage dtype of a RaftState field under `cfg`."""
    if name in LOG_FIELDS:
        return torch.int16 if cfg.log_dtype == "int16" else torch.int32
    if name in BOOL_FIELDS:
        return torch.bool
    if name == "cap_ov":
        return torch.int16
    if cfg.uses_compaction and name in POSITION_FIELDS:
        return torch.int32
    return torch.int16 if name in NARROW16 else torch.int32


def field_shape(name: str, cfg: RaftConfig) -> tuple:
    N, C, G = cfg.n_nodes, cfg.phys_capacity, cfg.n_groups
    if name in PAIR_FIELDS or name in MAILBOX_FIELDS:
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
    """The port carries the core state, the §10 mailbox slots, the §15
    snapshot planes and, on shallow logs, §12 scenario banks (thresholds,
    delay windows, partition programs, the warmup-down schedule). Not
    ported yet: banks on deep logs, and the bank channels of the §19
    scheduler and §20 serving."""
    spec = cfg.scenario
    if spec is None:
        return
    missing = [name for name, on in (
        ("timeout_windows (§19 per-group election windows)",
         spec.timeout_windows),
        ("life_hi > 0 (§19 scheduler lifetimes)", spec.life_hi > 0),
        ("quiesce_ticks > 0 (§19 scheduler quiescence)",
         spec.quiesce_ticks > 0),
        ("client_*_max > 0 (§20 client streams)", spec.has_clients),
        ("a bank on a deep log (phys_capacity >= 256: the batched engine "
         "with bank rows)", cfg.uses_dyn_log)) if on]
    if missing:
        raise NotImplementedError(
            f"§12 scenario banks with {', '.join(missing)} are not ported "
            "yet")


def require_device(device) -> torch.device:
    """The device an entry point runs on; a CUDA device with no card is an
    error, never a silent move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False "
            "(pass device='cpu' to run the plain version on the CPU)")
    return dev


def init_state(cfg: RaftConfig, device="cuda",
               out: Optional[RaftState] = None) -> RaftState:
    """The boot state: every node a FOLLOWER with an armed election timer
    drawn at counter 0 (t_ctr then starts at 1). `out`, a state of `cfg`
    on `device`, is overwritten with it in place and returned: no second
    copy of the logs is made."""
    check_supported(cfg)
    assert_narrow_bounds(cfg)
    dev = require_device(device)
    G, N = cfg.n_groups, cfg.n_nodes

    def full(name, v):
        if out is not None:
            return getattr(out, name).fill_(v)
        return torch.full(field_shape(name, cfg), v,
                          dtype=field_dtype(name, cfg), device=dev)

    st = {k: full(k, 0) for k in STATE_FIELDS
          + (MAILBOX_FIELDS if cfg.uses_mailbox else ())
          + (SNAPSHOT_FIELDS if cfg.uses_compaction else ())}
    st["voted_for"].fill_(-1)
    if cfg.uses_mailbox:
        st["vq_due"].fill_(-1)  # every slot empty
        st["aq_due"].fill_(-1)
    for k in ("el_armed", "up", "link_up", "t_ctr"):
        st[k].fill_(1)
    # Boot draw in the canonical (G, N) shape (SEMANTICS.md §4), transposed.
    base = rngmod.base_key(cfg.seed)
    ctr0 = torch.zeros((G, N), dtype=torch.int64, device=dev)
    el = rngmod.draw_uniform_grid(base, rngmod.KIND_TIMEOUT, ctr0,
                                  cfg.el_lo, cfg.el_hi)
    st["el_left"].copy_(el.T)
    if out is not None:
        out.tick = 0
        return out
    return RaftState(**st, tick=0)


def state_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda",
                     cfg: RaftConfig | None = None) -> RaftState:
    """A RaftState from numpy arrays keyed by field name (plus "tick"): the
    bridge that carries the JAX package's state into the port, dtypes kept.
    The mailbox slots and the §15 snapshot planes come along when `arrays`
    has them (or `cfg` runs the mailbox / compaction). With `cfg`, every
    field's dtype and shape is checked against it."""
    dev = require_device(device)
    st = {}
    mailbox = cfg.uses_mailbox if cfg is not None else (
        arrays.get("vq_due") is not None)
    compact = cfg.uses_compaction if cfg is not None else (
        arrays.get("snap_index") is not None)
    for k in STATE_FIELDS + (MAILBOX_FIELDS if mailbox else ()) + (
            SNAPSHOT_FIELDS if compact else ()):
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
    out = {k: getattr(state, k).detach().cpu().numpy()
           for k in state.fields()}
    out["tick"] = np.int32(state.tick)
    return out


# ---------------------------------------------------------------------------
# Packed state layout (SEMANTICS.md §14): the bit- and byte-minimal storage
# form of a RaftState, the JAX package's `layout="packed"`. Handler
# arithmetic runs on wide values: a runner unpacks at read and repacks at
# write (the tick kernels' packed instantiations do both in registers), so
# every observer sees the wide run's bits.
#
# Encodings (groups-minor, as the wide layout):
#   - ctrl_bits (3, G): word 0 role, 2 bits a node; word 1 round_state, 2
#     bits a node; word 2 el_armed | hb_armed << N | up << 2N. The JAX
#     package stores u32; torch has no full uint32 arithmetic, so the port
#     stores the same 32 bits as int32.
#   - peer masks: responded / link_up / aq_hase (N, N, G) become (N, G)
#     N-bit row masks (bit b-1 of row a-1 = pair (a, b)), u8 when N <= 8
#     (else the u16 bits as int16).
#   - int8 or int16 narrowing where the config bounds the value
#     (packed_field_dtype is the gate); term-valued fields and counters
#     int16, log_term int8, log_cmd int16, under the WIDTH-OVERFLOW LATCH:
#     every narrowed value is compared with its packed range and a miss
#     sets the group's `ov` byte. A latched group's bits are invalid: the
#     runners check the latch on the host and raise ("width overflow");
#     layout="wide" has no latch and no bound.
#
# pack_fields / unpack_fields work on dicts of canonical-shape tensors
# ((N, G) / (N, N, G) / (N, C, G)); pack_state / unpack_state wrap them.
#
# A §15 compaction config (the JAX package's models/state.py:423-470) packs
# its positions and snap_index / snap_term int16 under the latch (positions
# are unbounded: a run that outgrows int16 latches and the runners rerun it
# wide), snap_digest int32 (a wrapping fold, never narrowed), aq_ent_t int32
# (an in-flight InstallSnapshot carries the digest in that seat) and aq_hase
# as an (N, N, G) int8 plane (its install marker 2 does not fit a bit).

# Wide fields fused into the (3, G) ctrl_bits word stack.
CTRL_FIELDS = ("role", "round_state", "el_armed", "hb_armed", "up")
# Wide (N, N, G) flag planes that become (N, G) N-bit masks.
PEER_BIT_FIELDS = {"responded": "responded_bits", "link_up": "link_bits",
                   "aq_hase": "aq_hase_bits"}


def peer_bit_fields(cfg: RaftConfig) -> dict:
    """The peer-bit planes under `cfg`: aq_hase is one bit a pair without
    §15 compaction only (an InstallSnapshot rides its slot as aq_hase ==
    2, so compaction keeps the plane, int8)."""
    if not cfg.uses_compaction:
        return dict(PEER_BIT_FIELDS)
    return {k: v for k, v in PEER_BIT_FIELDS.items() if k != "aq_hase"}


# Term-valued and monotone-counter fields: int16 under the overflow latch.
LATCH16 = (
    "term", "last_term", "t_ctr", "b_ctr", "rounds",
    "vq_term", "vq_llt", "vq_round", "aq_term", "aq_plt",
    "aq_ent_t", "aq_ent_c",
)

# PackedRaftState's tensor fields in the kernels' pointer order (the JAX
# package's field order), then its mailbox fields (MAILBOX_FIELDS with
# aq_hase as its mask).
PACKED_FIELDS = (
    "ctrl_bits", "term", "last_term", "voted_for", "commit", "last_index",
    "phys_len", "log_term", "log_cmd", "el_left", "round_left", "round_age",
    "votes", "responses", "responded_bits", "bo_left", "next_index",
    "match_index", "hb_left", "link_bits", "t_ctr", "b_ctr", "rounds",
    "cap_ov", "ov",
)
PACKED_MAILBOX_FIELDS = tuple(
    "aq_hase_bits" if k == "aq_hase" else k for k in MAILBOX_FIELDS)


def packed_mailbox_fields(cfg: RaftConfig) -> tuple:
    """The packed mailbox fields under `cfg`: PACKED_MAILBOX_FIELDS, or
    under §15 compaction MAILBOX_FIELDS (aq_hase an int8 plane)."""
    return MAILBOX_FIELDS if cfg.uses_compaction else PACKED_MAILBOX_FIELDS


@dataclasses.dataclass
class PackedRaftState:
    """RaftState in the packed layout: the fields of PACKED_FIELDS, the
    mailbox slots of packed_mailbox_fields(cfg) and the §15 snapshot
    planes when the config has them (else None), the host tick, and `ov`,
    the (G,) int8 per-group width-overflow latch (0: every narrowed value
    of the group fit)."""
    ctrl_bits: torch.Tensor       # (3, G) u32 bits as int32
    term: torch.Tensor            # (N, G) i16 (latched)
    last_term: torch.Tensor       # (N, G) i16 (latched)
    voted_for: torch.Tensor       # (N, G) i8
    commit: torch.Tensor          # (N, G) i8|i16
    last_index: torch.Tensor      # (N, G) i8|i16
    phys_len: torch.Tensor        # (N, G) i8|i16
    log_term: torch.Tensor        # (N, C, G) i8 (latched)
    log_cmd: torch.Tensor         # (N, C, G) i16 (latched)
    el_left: torch.Tensor         # (N, G) i8|i16
    round_left: torch.Tensor      # (N, G) i8|i16
    round_age: torch.Tensor       # (N, G) i8|i16
    votes: torch.Tensor           # (N, G) i8
    responses: torch.Tensor       # (N, G) i8
    responded_bits: torch.Tensor  # (N, G) u8 peer mask
    bo_left: torch.Tensor         # (N, G) i8|i16
    next_index: torch.Tensor      # (N, N, G) i8|i16
    match_index: torch.Tensor     # (N, N, G) i8|i16
    hb_left: torch.Tensor         # (N, G) i8|i16
    link_bits: torch.Tensor       # (N, G) u8 peer mask
    t_ctr: torch.Tensor           # (N, G) i16 (latched)
    b_ctr: torch.Tensor           # (N, G) i16 (latched)
    rounds: torch.Tensor          # (N, G) i16 (latched)
    cap_ov: torch.Tensor          # (N, G) i16
    ov: torch.Tensor              # (G,) i8 width-overflow latch
    tick: int = 0
    vq_due: Optional[torch.Tensor] = None        # (N, N, G) i8|i16
    vq_term: Optional[torch.Tensor] = None       # (N, N, G) i16 (latched)
    vq_lli: Optional[torch.Tensor] = None        # (N, N, G) i8|i16
    vq_llt: Optional[torch.Tensor] = None        # (N, N, G) i16 (latched)
    vq_round: Optional[torch.Tensor] = None      # (N, N, G) i16 (latched)
    aq_due: Optional[torch.Tensor] = None        # (N, N, G) i8|i16
    aq_term: Optional[torch.Tensor] = None       # (N, N, G) i16 (latched)
    aq_pli: Optional[torch.Tensor] = None        # (N, N, G) i8|i16
    aq_plt: Optional[torch.Tensor] = None        # (N, N, G) i16 (latched)
    aq_hase_bits: Optional[torch.Tensor] = None  # (N, G) u8 peer mask
    aq_ent_t: Optional[torch.Tensor] = None      # (N, N, G) i16 (latched);
    #                                              i32 under §15 compaction
    aq_ent_c: Optional[torch.Tensor] = None      # (N, N, G) i16 (latched)
    aq_commit: Optional[torch.Tensor] = None     # (N, N, G) i8|i16
    # §15 compaction: aq_hase as a plane (aq_hase_bits is then None) and the
    # snapshot planes.
    aq_hase: Optional[torch.Tensor] = None       # (N, N, G) i8
    snap_index: Optional[torch.Tensor] = None    # (N, G) i16 (latched)
    snap_term: Optional[torch.Tensor] = None     # (N, G) i16 (latched)
    snap_digest: Optional[torch.Tensor] = None   # (N, G) i32

    def fields(self) -> tuple:
        mail = () if self.vq_due is None else (
            MAILBOX_FIELDS if self.aq_hase is not None
            else PACKED_MAILBOX_FIELDS)
        return PACKED_FIELDS + mail + (
            SNAPSHOT_FIELDS if self.snap_index is not None else ())


def assert_packed_bounds(cfg: RaftConfig) -> None:
    """The ctrl word stack holds 3N flag bits in one 32-bit word (N <= 10),
    on top of the int16 storage guards."""
    assert_narrow_bounds(cfg)
    assert cfg.n_nodes <= 10, (
        "packed layout needs n_nodes <= 10 (3N flag bits per u32 ctrl "
        "word)")


# Narrow fields whose width the config picks, by the config value that
# bounds them (int8 when it leaves a unit of slack for the -1 / 0 sentinel).
NARROW_GATES = {
    "pos": ("commit", "last_index", "phys_len", "next_index", "match_index",
            "vq_lli", "aq_pli", "aq_commit"),
    "el": ("el_left",), "bo": ("bo_left",),
    "round": ("round_left", "round_age"), "hb": ("hb_left",),
    "due": ("vq_due", "aq_due"),
}


def narrow_gate_int8(gate: str, cfg: RaftConfig) -> bool:
    """Whether the fields of NARROW_GATES[gate] pack as int8 under `cfg`."""
    # Under §15 positions are unbounded: int16, latched.
    return {"pos": cfg.log_capacity + 1 <= 127  # next_index reaches C + 1
            and not cfg.uses_compaction,
            "el": cfg.el_hi <= 126, "bo": cfg.bo_hi <= 126,
            "round": cfg.round_ticks <= 126, "hb": cfg.hb_ticks <= 126,
            "due": cfg.delay_hi <= 126}[gate]


def packed_field_dtype(name: str, cfg: RaftConfig) -> torch.dtype:
    """The packed storage dtype of a PackedRaftState field under `cfg` (the
    JAX package's packed_field_dtype; u32 words as int32, u16 masks as
    int16)."""
    if name == "ctrl_bits":
        return torch.int32
    if name in PEER_BIT_FIELDS.values():
        return torch.uint8 if cfg.n_nodes <= 8 else torch.int16
    if name == "cap_ov":
        return torch.int16
    if name == "snap_digest" or (name == "aq_ent_t" and cfg.uses_compaction):
        return torch.int32  # the wrapping digest fold, never narrowed
    if name in ("snap_index", "snap_term"):
        return torch.int16  # latched, as the positions
    if name == "aq_hase":
        return torch.int8  # the plane under §15: values {0, 1, 2}
    if name in LATCH16 or name == "log_cmd":
        return torch.int16
    if name in ("log_term", "voted_for", "votes", "responses", "ov"):
        return torch.int8
    for gate, names in NARROW_GATES.items():
        if name in names:
            return torch.int8 if narrow_gate_int8(gate, cfg) else torch.int16
    raise KeyError(f"{name}: not a packed field")


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Population count of a non-negative int32 word (SWAR shift-add), the
    §18 quorum compare's tally. Valid below 2^31."""
    x = x.to(torch.int32)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def _u32(v: torch.Tensor) -> torch.Tensor:
    """An integer tensor's values as uint32 bit patterns, held in int64."""
    return v.to(torch.int64) & 0xFFFFFFFF


def _as_i32_bits(w: torch.Tensor) -> torch.Tensor:
    """A uint32 value held in int64 -> the same 32 bits as int32."""
    w = w & 0xFFFFFFFF
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def pack_fields(cfg: RaftConfig, s: dict) -> tuple:
    """Pack a dict of canonical-shape wide tensors ((N, G) / (N, N, G) /
    (N, C, G); any integer or bool dtype) into the packed field dict.
    Returns (packed dict, ov): `ov` is the (G,) bool per-group latch, True
    where some narrowed value fell outside its packed range (the pack then
    wrapped, as a narrowing cast does, and the group's bits are invalid) or
    a 2-bit ctrl lane held a value outside [0, 3]. Words are sums of
    shifted lanes, as the JAX package's are (an out-of-range lane carries
    into its neighbours)."""
    assert_packed_bounds(cfg)
    N = cfg.n_nodes
    G = s["term"].shape[-1]
    dev = s["term"].device
    ov = torch.zeros(G, dtype=torch.bool, device=dev)

    def lanes_any(bad):  # reduce a bad-value mask onto the groups axis
        return bad.reshape(-1, G).any(0)

    def narrow(name, v):
        nonlocal ov
        dt = packed_field_dtype(name, cfg)
        w = v.to(torch.int32)
        info = torch.iinfo(dt)
        ov = ov | lanes_any((w < info.min) | (w > info.max))
        return w.to(dt, copy=True)  # a new tensor, int32 fields too

    def sum_shifted(lanes, width, shift=0):  # (N, G) -> (G,) u32 in int64
        sh = torch.arange(N, dtype=torch.int64, device=dev)[:, None] * width
        return ((_u32(lanes) << (sh + shift)) & 0xFFFFFFFF).sum(0)

    def word2(v):  # 2-bit lanes (role / round_state)
        nonlocal ov
        w = v.to(torch.int32)
        ov = ov | lanes_any((w < 0) | (w > 3))
        return sum_shifted(w, 2)

    def bits1(v, shift):  # flag plane -> N bits over the node axis
        return sum_shifted((v != 0).to(torch.int32), 1, shift)

    flags = (bits1(s["el_armed"], 0) + bits1(s["hb_armed"], N)
             + bits1(s["up"], 2 * N))
    out = {"ctrl_bits": _as_i32_bits(torch.stack(
        [word2(s["role"]), word2(s["round_state"]), flags]))}
    pbf = peer_bit_fields(cfg)
    for name, packed_name in pbf.items():
        if s.get(name) is None:
            continue
        v = (s[name] != 0).to(torch.int64)
        sh = torch.arange(N, dtype=torch.int64, device=dev)[None, :, None]
        word = (v << sh).sum(1)
        out[packed_name] = word.to(packed_field_dtype(packed_name, cfg))
    for name, v in s.items():
        if name in CTRL_FIELDS or name in pbf or v is None:
            continue
        out[name] = narrow(name, v)
    return out, ov


def unpack_fields(cfg: RaftConfig, p: dict, kernel_form: bool = False
                  ) -> dict:
    """Inverse of pack_fields: packed field dict -> wide canonical-shape
    dict in the storage dtypes (field_dtype; flags as bools), or with
    `kernel_form` int32 everywhere but the logs, which keep their storage
    dtype (the flat carry the plain kernel versions run on)."""
    N = cfg.n_nodes
    dev = p["ctrl_bits"].device
    out = {}

    def wide(name, v):  # v: int32 values; a new tensor
        if kernel_form:
            return v.to(field_dtype(name, cfg) if name in LOG_FIELDS
                        else torch.int32, copy=True)
        dt = field_dtype(name, cfg)
        return v != 0 if dt == torch.bool else v.to(dt, copy=True)

    ctrl = p["ctrl_bits"].to(torch.int32)
    n = torch.arange(N, dtype=torch.int32, device=dev)[:, None]
    for name, word, shift, mask in (
            ("role", 0, 2 * n, 3), ("round_state", 1, 2 * n, 3),
            ("el_armed", 2, n, 1), ("hb_armed", 2, n + N, 1),
            ("up", 2, n + 2 * N, 1)):
        out[name] = wide(name, (ctrl[word][None, :] >> shift) & mask)
    sh = torch.arange(N, dtype=torch.int32, device=dev)[None, :, None]
    for name, packed_name in PEER_BIT_FIELDS.items():
        if p.get(packed_name) is None:
            continue
        word = p[packed_name].to(torch.int32) & ((1 << N) - 1)
        out[name] = wide(name, (word[:, None, :] >> sh) & 1)
    for name, v in p.items():
        if (name in ("ctrl_bits", "ov") or v is None
                or name in PEER_BIT_FIELDS.values()):
            continue
        out[name] = wide(name, v.to(torch.int32))
    return out


def pack_state(cfg: RaftConfig, state: RaftState, ov=None
               ) -> PackedRaftState:
    """RaftState -> PackedRaftState. `ov` chains an earlier latch (a runner
    ORs it across its packs); the result's (G,) int8 `ov` is 1 for every
    group where some pack so far wrapped a value."""
    s = {k: getattr(state, k) for k in state.fields()}
    p, ov_now = pack_fields(cfg, s)
    ov_now = ov_now.to(torch.int8)
    if ov is not None:
        ov_now = ov_now | ov.to(torch.int8)
    return PackedRaftState(**p, ov=ov_now, tick=state.tick)


def unpack_state(cfg: RaftConfig, packed: PackedRaftState) -> RaftState:
    """PackedRaftState -> RaftState in the storage dtypes. Valid only where
    packed.ov == 0 (check_packed_ov is the host-side guard)."""
    p = {k: getattr(packed, k) for k in packed.fields() if k != "ov"}
    return RaftState(**unpack_fields(cfg, p), tick=packed.tick)


def check_cap_ov(cap_ov) -> None:
    """Host-side loud-fail guard on the §15 capacity-exhaustion latch: a
    nonzero latch means some node's append was rejected by the §3 capacity
    clip — the run outlived its log window. Accepts the (N, G) field, any
    reduction of it, or a RaftState."""
    if isinstance(cap_ov, RaftState):
        cap_ov = cap_ov.cap_ov
    if bool(torch.as_tensor(cap_ov).ne(0).any()):
        raise RuntimeError(
            "log capacity exhausted: an append was rejected by the §3 "
            "capacity clip (models/state.py cap_ov latch) — the run "
            "outlived its log window; enable §15 compaction "
            "(compact_watermark > 0) or raise log_capacity")


def check_packed_ov(ov) -> None:
    """The host-side guard on the width-overflow latch: a nonzero latch (the
    (G,) field or any reduction of it) means some narrowed value exceeded
    its packed width and the packed bits are invalid — raise."""
    if bool(torch.as_tensor(ov).ne(0).any()):
        raise RuntimeError(
            "packed-layout width overflow: a term/counter/log value "
            "exceeded its packed storage width (models/state.py LATCH16 "
            "latch) — the packed bits are invalid; re-run with "
            'layout="wide"')


# ---------------------------------------------------------------------------
# Packed-domain compute (SEMANTICS.md §18): the vote-exchange set runs in the
# lattice as two (N, G) int32 words a node — responded_bits (bit p-1 of row
# c-1: pair (c, p) exchanged this round) and vote_bits (the granted subset)
# — and the phase-4 quorum compares are popcounts. Every word is below
# 2^(3N) <= 2^30, so int32 carries it exactly.

def pack_peer_word_i32(plane: torch.Tensor, N: int) -> torch.Tensor:
    """Flat (N*N, ...) 0/1 pair plane (row (a-1)*N + b-1 = pair (a, b)) ->
    (N, ...) int32 row masks, bit b-1 of row a-1 = pair (a, b)."""
    rows = []
    for a in range(N):
        w = (plane[a * N] != 0).to(torch.int32)
        for b in range(1, N):
            w = w | ((plane[a * N + b] != 0).to(torch.int32) << b)
        rows.append(w)
    return torch.stack(rows)


def unpack_peer_word_i32(bits: torch.Tensor, N: int) -> torch.Tensor:
    """Inverse of pack_peer_word_i32: (N, ...) row masks -> (N*N, ...) 0/1
    int32 pair plane."""
    b32 = bits.to(torch.int32)
    return torch.stack([(b32[a] >> b) & 1
                        for a in range(N) for b in range(N)])


def pack_ctrl_words_i32(role, round_state, el_armed, hb_armed, up):
    """The five (N, ...) head planes -> the (3, ...) int32 ctrl word stack
    (the ctrl_bits layout). Values must satisfy the §14 bounds."""
    N = role.shape[0]

    def word2(v):
        w = v[0].to(torch.int32) & 3
        for n in range(1, N):
            w = w | ((v[n].to(torch.int32) & 3) << (2 * n))
        return w

    def bits1(v, shift):
        w = (v[0] != 0).to(torch.int32) << shift
        for n in range(1, N):
            w = w | ((v[n] != 0).to(torch.int32) << (shift + n))
        return w

    flags = bits1(el_armed, 0) | bits1(hb_armed, N) | bits1(up, 2 * N)
    return torch.stack([word2(role), word2(round_state), flags])


def unpack_ctrl_words_i32(words: torch.Tensor, N: int) -> dict:
    """Inverse of pack_ctrl_words_i32: (3, ...) words -> five (N, ...)
    int32 planes (flags as 0/1)."""
    w = words.to(torch.int32)
    return {
        "role": torch.stack([(w[0] >> (2 * n)) & 3 for n in range(N)]),
        "round_state": torch.stack([(w[1] >> (2 * n)) & 3
                                    for n in range(N)]),
        "el_armed": torch.stack([(w[2] >> n) & 1 for n in range(N)]),
        "hb_armed": torch.stack([(w[2] >> (N + n)) & 1 for n in range(N)]),
        "up": torch.stack([(w[2] >> (2 * N + n)) & 1 for n in range(N)]),
    }


def synth_vote_bits(responded_bits: torch.Tensor, votes: torch.Tensor,
                    N: int) -> torch.Tensor:
    """A granted-vote word from (responded_bits, votes): the lowest `votes`
    set bits of responded_bits. The wide state keeps only the tally, and
    the lattice reads only popcount(vote_bits); a future grant can come
    only from a peer whose responded bit is still clear, so any
    |votes|-subset of the responded set is observationally equivalent, and
    the lowest bits make the choice deterministic (SEMANTICS.md §18)."""
    v = votes.to(torch.int32)
    rb = responded_bits.to(torch.int32)
    out = torch.zeros_like(rb)
    cnt = torch.zeros_like(rb)
    for j in range(N):
        take = ((rb >> j) & 1 != 0) & (cnt < v)
        t32 = take.to(torch.int32)
        out = out | (t32 << j)
        cnt = cnt + t32
    return out


def enter_packed_compute(cfg: RaftConfig, s: dict) -> dict:
    """A flat lattice dict (ops/tick.flatten_state shapes) -> the §18 form:
    the responded pair plane and the votes / responses tallies replaced by
    responded_bits / vote_bits ((N, G) int32 row masks). Every other field
    stays as it is. A new dict; the input's tensors are not written."""
    N = cfg.n_nodes
    out = dict(s)
    rb = pack_peer_word_i32(out.pop("responded"), N)
    votes = out.pop("votes")
    out.pop("responses")  # == popcount(responded_bits) at phase boundaries
    out["responded_bits"] = rb
    out["vote_bits"] = synth_vote_bits(rb, votes, N)
    return out


def exit_packed_compute(cfg: RaftConfig, s: dict,
                        dtypes: Optional[dict] = None) -> dict:
    """Inverse of enter_packed_compute: the responded plane and the votes /
    responses tallies (popcounts of the §18 words), in `dtypes[name]`
    (int32 where absent; bool restores a flag plane). A new dict."""
    N = cfg.n_nodes
    dtypes = dtypes or {}
    out = dict(s)
    rb = out.pop("responded_bits")
    vb = out.pop("vote_bits")
    for name, v in (("responded", unpack_peer_word_i32(rb, N)),
                    ("votes", popcount32(vb)),
                    ("responses", popcount32(rb))):
        dt = dtypes.get(name, torch.int32)
        out[name] = v != 0 if dt == torch.bool else v.to(dt)
    return out
