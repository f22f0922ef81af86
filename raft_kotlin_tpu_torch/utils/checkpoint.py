"""Whole-simulation checkpoint and bit-exact resume — the JAX package's
`utils/checkpoint.py` on the port's states, in its file format.

A checkpoint is one .npz file holding every RaftState field (the mailbox
slots and the §15 snapshot planes when the config has them), the tick as a
() int32, and three keys of its own: the RaftConfig as JSON (the config is
part of the semantics — its draws are keyed by it — so a load under another
config is refused), an `extra` JSON dict, and the format version. The
state is always stored wide: save() takes a PackedRaftState too (after
checking its width-overflow latch) and load(layout="packed") re-packs. The
counted threefry draws are keyed by on-state counters, so a resumed run
makes the draws the unbroken run would have made.

Version 9, the JAX package's: files of every version it reads (1-9) load
here, older ones migrated as it migrates them (groups-major arrays
transposed, the fault-model fields and the capacity latch defaulted, the
lastLogTerm cache derived from the log), and every field cast to its
canonical storage dtype (_canon_dtypes). A §16 ring-window config may load
a file saved under another ring_capacity (the only difference expect_cfg
may have): the live window [snap_index, phys_len) is rebased onto the new
ring (_resize_ring_window), which refuses a window that does not fit.

Not ported, and refused with NotImplementedError: the sharded form
(save_sharded / load_sharded, ROADMAP item 6), the §20 serving carry
(save(serving=...), load_serving, item 5). The arrays of a file's
serving carry are ignored by load().
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Optional, Tuple

import numpy as np

from raft_kotlin_tpu_torch.models.state import (
    MAILBOX_FIELDS, SNAPSHOT_FIELDS, STATE_FIELDS, PackedRaftState,
    RaftState, assert_narrow_bounds, check_packed_ov, field_dtype,
    pack_state, state_from_numpy, state_to_numpy, unpack_state)
from raft_kotlin_tpu_torch.utils.config import RaftConfig, config_from_dict

_HEADER_KEY = "__raft_config_json__"
_EXTRA_KEY = "__raft_extra_json__"
_VERSION_KEY = "__raft_ckpt_version__"
_VERSION = 9

# Every array name a RaftState file may hold, the tick included.
_ARRAY_FIELDS = STATE_FIELDS + MAILBOX_FIELDS + SNAPSHOT_FIELDS + ("tick",)


def _canon_dtypes(arrays: dict, cfg: RaftConfig) -> dict:
    """Cast loaded arrays to the canonical storage dtypes
    (models/state.field_dtype): every narrowed field's range is bounded by
    the config, so the cast is lossless for any valid checkpoint."""
    assert_narrow_bounds(cfg)  # an out-of-range cfg fails, never wraps
    out = {}
    for name, a in arrays.items():
        want = (a.dtype if name == "tick"
                else np.dtype(str(field_dtype(name, cfg)).split(".")[-1]))
        out[name] = a.astype(want) if a.dtype != want else a
    return out


def _derive_last_term(log_term: np.ndarray,
                      last_index: np.ndarray) -> np.ndarray:
    """last_term for files before v5: log_term at slot last_index - 1 (0
    for an empty log)."""
    li = last_index.astype(np.int64)
    idx = np.clip(li - 1, 0, log_term.shape[1] - 1)
    vals = np.take_along_axis(log_term, idx[:, None, :], axis=1)[:, 0, :]
    return np.where(li >= 1, vals, 0).astype(np.int32)


def _ring_only_mismatch(saved: RaftConfig, expect: RaftConfig) -> bool:
    """True where `expect` differs from the saved config in ring_capacity
    alone (§16): positions are unbounded and the ring is storage, so the
    run is the same."""
    return dataclasses.replace(saved,
                               ring_capacity=expect.ring_capacity) == expect


def _resize_ring_window(arrays: dict, saved: RaftConfig,
                        target: RaftConfig) -> dict:
    """§16 resize on load: the stored slot of position p is
    p % C_phys_saved, its target slot p % C_phys_target; only the live
    window [snap_index, phys_len) moves (every other row is folded or was
    never written). A live window wider than the target ring raises: its
    rows exist nowhere else."""
    C_old, C_new = saved.phys_capacity, target.phys_capacity
    if C_old == C_new:
        return arrays
    b = arrays["snap_index"].astype(np.int64)
    live = arrays["phys_len"].astype(np.int64) - b
    hw = int(live.max()) if live.size else 0
    if hw > C_new:
        raise ValueError(
            f"checkpoint live log window ({hw} rows) does not fit the "
            f"target ring_capacity ({C_new}): resume at a window >= {hw} "
            f"or let compaction drain the backlog before saving")
    out = dict(arrays)
    for name in ("log_term", "log_cmd"):
        a = arrays[name]                         # (N, C_old, G)
        new = np.zeros((a.shape[0], C_new, a.shape[2]), dtype=a.dtype)
        for k in range(hw):
            p = b + k                            # (N, G) positions
            vals = np.take_along_axis(a, (p % C_old)[:, None, :], axis=1)
            dst = (p % C_new)[:, None, :]
            keep = np.take_along_axis(new, dst, axis=1)
            np.put_along_axis(new, dst,
                              np.where((k < live)[:, None, :], vals, keep),
                              axis=1)
        out[name] = new
    return out


def _normalize_wide(state, cfg: RaftConfig) -> RaftState:
    """The wide state to store: a packed state's latch is checked first (a
    latched state holds wrapped values), then it is unpacked."""
    if isinstance(state, PackedRaftState):
        check_packed_ov(state.ov)
        return unpack_state(cfg, state)
    return state


def _apply_layout(state: RaftState, cfg: RaftConfig, layout: str):
    """The loaded wide state, re-packed for a run with layout="packed"."""
    if layout == "wide":
        return state
    if layout != "packed":
        raise ValueError(f"unknown layout {layout!r}")
    return pack_state(cfg, state)


def save(path: str, state, cfg: RaftConfig, extra: Optional[dict] = None,
         serving: Optional[dict] = None) -> None:
    """Write `state` (either layout; stored wide) and the config header to
    `path` (.npz) atomically: a temporary file in the same directory,
    renamed over `path`. `extra` is a JSON dict stored beside it
    (load_with_extra). The §20 serving carry is not ported."""
    if serving is not None:
        raise NotImplementedError(
            "the §20 serving carry is not ported (ROADMAP item 5)")
    state = _normalize_wide(state, cfg)
    arrays = state_to_numpy(state)
    arrays[_HEADER_KEY] = np.frombuffer(
        json.dumps(dataclasses.asdict(cfg)).encode(), dtype=np.uint8)
    arrays[_EXTRA_KEY] = np.frombuffer(
        json.dumps(extra or {}).encode(), dtype=np.uint8)
    arrays[_VERSION_KEY] = np.asarray(_VERSION, dtype=np.int32)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)  # atomic publish
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(path: str, expect_cfg: Optional[RaftConfig] = None,
         device="cuda", layout: str = "wide") -> Tuple[object, RaftConfig]:
    """Load a checkpoint onto `device`: (state, cfg). With `expect_cfg`,
    any difference from the saved config raises ValueError, except a
    different ring_capacity alone, which rebases the log window and returns
    the state AS `expect_cfg` (the returned cfg). `layout="packed"`
    returns the state re-packed."""
    state, cfg, _ = _load_impl(path, expect_cfg, device)
    return _apply_layout(state, cfg, layout), cfg


def load_with_extra(path: str, expect_cfg: Optional[RaftConfig] = None,
                    device="cuda", layout: str = "wide"
                    ) -> Tuple[object, RaftConfig, dict]:
    """As load(), and the extra dict given to save()."""
    state, cfg, extra = _load_impl(path, expect_cfg, device)
    return _apply_layout(state, cfg, layout), cfg, extra


def save_sharded(*args, **kwargs) -> None:
    raise NotImplementedError(
        "sharded checkpoints are not ported (ROADMAP item 6: the sharded "
        "runners)")


def load_sharded(*args, **kwargs):
    raise NotImplementedError(
        "sharded checkpoints are not ported (ROADMAP item 6: the sharded "
        "runners)")


def load_serving(*args, **kwargs):
    raise NotImplementedError(
        "the §20 serving carry is not ported (ROADMAP item 5)")


def _load_impl(path: str, expect_cfg: Optional[RaftConfig], device):
    with np.load(path) as z:
        version = int(z[_VERSION_KEY])
        if version not in range(1, _VERSION + 1):
            raise ValueError(f"checkpoint version {version} not supported "
                             f"(can load 1-{_VERSION})")
        cfg_dict = json.loads(bytes(z[_HEADER_KEY].tobytes()).decode())
        extra = (json.loads(bytes(z[_EXTRA_KEY].tobytes()).decode())
                 if _EXTRA_KEY in z else {})
        arrays = {k: z[k] for k in _ARRAY_FIELDS if k in z}
    if version < 3:
        # v1 / v2 stored groups-major arrays; transposing is a relabeling.
        arrays = {k: (a if a.ndim == 0 else a.T if a.ndim == 2
                      else a.transpose(1, 2, 0)) for k, a in arrays.items()}
    if version == 1:
        # v1 predates the fault-model fields: their boot values.
        N, G = arrays["term"].shape
        arrays.setdefault("up", np.ones((N, G), dtype=bool))
        arrays.setdefault("link_up", np.ones((N, N, G), dtype=bool))
    if version < 5 and "last_term" not in arrays:
        arrays["last_term"] = _derive_last_term(arrays["log_term"],
                                                arrays["last_index"])
    if version < 7 and "cap_ov" not in arrays:
        # Before the §15 capacity latch: clean.
        arrays["cap_ov"] = np.zeros(arrays["term"].shape, dtype=np.int16)
    cfg = config_from_dict(cfg_dict)
    arrays = _canon_dtypes(arrays, cfg)
    missing = [k for k in STATE_FIELDS
               + (MAILBOX_FIELDS if cfg.uses_mailbox else ())
               + (SNAPSHOT_FIELDS if cfg.uses_compaction else ())
               if k not in arrays]
    if missing:
        raise ValueError(f"checkpoint {path!r} is corrupt/truncated: "
                         f"missing arrays {missing}")
    if expect_cfg is not None and expect_cfg != cfg:
        if not _ring_only_mismatch(cfg, expect_cfg):
            raise ValueError(f"checkpoint config mismatch:\n saved   {cfg}\n"
                             f" expected {expect_cfg}")
        arrays = _resize_ring_window(arrays, cfg, expect_cfg)
        cfg = expect_cfg
    return state_from_numpy(arrays, device, cfg), cfg, extra
