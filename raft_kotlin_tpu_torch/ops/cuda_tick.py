"""The kernels' wrappers and their plain versions — the counterpart of the
JAX package's `ops/pallas_tick.py` (its runner, make_pallas_scan, is
`ops/cuda_scan.make_cuda_scan`).

- `tick_kernel(cfg, s, aux, flags)` computes what `ops/tick.phase_body`
  computes: one tick with staged aux (make_pallas_tick at T=1), through
  `csrc/tick_kernel.cu`.
- `k_tick_kernel(cfg, s, K, slabs, el_table, b_table)` computes what
  `k_tick_plain` computes: K ticks per launch with staged aux and no
  observers (the archival make_pallas_core_k, kernel #7), through its own
  entry in `csrc/fused_tick_kernel.cu`.
- `fused_tick_kernel(cfg, s, T, flags, aux_source, ops, snap_fields)`
  computes what `fused_tick_plain` computes: T ticks per launch with the
  state held in registers, el_left drawn in the kernel, and per-tick
  snapshots (_make_fused_core), through `csrc/fused_tick_kernel.cu`. Its
  randomness is either staged (T-stacked channels + counter-keyed draw
  tables, `fused_launch_aux`) or drawn in the kernel from a few key planes
  (`inkernel_aux_operands`; the plain version of those draws is `_kt_aux`).

Both kernels run the §10 mailbox (flags.delay, shallow logs): its 13 slot
planes are operands updated in place, and its per-pair send delays arrive
staged (the "delay" aux channel, T-stacked for a fused launch) or are drawn
in the kernel (kt_rng.cuh's delay_draw, whose plain version is
utils/rng.kt_delay_mask). A fused launch with an observer on snapshots, in
place of the two due planes, the two per-group rows the observers read of
them (INFLIGHT).

Both kernels also take the §14 packed layout (`layout="packed"`: the flat
views of a PackedRaftState, ops/tick.flatten_packed, in place), built as
their own libraries (`-DRAFT_PACKED=1`), and within it the §18 packed
compute (`compute="packed"`: the vote-exchange set as two words a node,
JAX's _enter/_exit_packed_lattice inside the kernels). Their plain
versions (`tick_plain_packed`, `fused_tick_plain(layout="packed")`) unpack
the packed state, run phase_body (through the §18 form under packed
compute) and repack it with the width-overflow latch. Snapshots keep the
wide int32 values (under packed compute the votes snapshot is
popcount(vote_bits), as in the JAX package's fused kernel).

For CUDA tensors a wrapper launches its hand-written kernel (built at first
use by `ops/build.py`) on the current stream, in place, and counts the
launch; for CPU tensors it calls the plain version. Nothing on a CUDA
tensor falls back to the plain version: a tensor the kernel does not take,
a failed build or a failed launch raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

import dataclasses

from raft_kotlin_tpu_torch.constants import LEADER
from raft_kotlin_tpu_torch.models.state import (
    LOG_FIELDS, MAILBOX_FIELDS, NARROW_GATES, PACKED_FIELDS,
    PACKED_MAILBOX_FIELDS, PAIR_FIELDS, PEER_BIT_FIELDS, STATE_FIELDS,
    enter_packed_compute, exit_packed_compute, field_dtype,
    narrow_gate_int8, packed_field_dtype, popcount32, unpack_peer_word_i32)
from raft_kotlin_tpu_torch.ops import tick as tick_mod
from raft_kotlin_tpu_torch.ops.build import check_operand as _check
from raft_kotlin_tpu_torch.ops.build import launch_library
from raft_kotlin_tpu_torch.utils import rng as rngmod
from raft_kotlin_tpu_torch.utils import telemetry as telemetry_mod
from raft_kotlin_tpu_torch.utils.config import RaftConfig

# Launches per kernel since the last reset_launch_counts(); a wrapper adds
# one exactly where it launches its kernel. "delay_draw" and "part_down"
# count the stand-alone launches of kt_rng.cuh's device functions (their
# timing kernels); "fused_tick_kernel[delay_draw]" counts the fused
# kernel's launches that draw the §10 delays in the kernel (delay_draw runs
# inside them), "scenario_rows" those that draw through a §12 bank's rows
# (its thresholds, delay windows, part_down and the warmup-down rule),
# "fused_tick_kernel[part_down]" those whose bank has a partition program
# (part_down runs inside them); "fused_tick_kernel[observers]" those of
# its observer build (the recorder and monitor computed in the kernel);
# "k_tick" counts kernel #7's.
LAUNCHES = {"tick_kernel": 0, "fused_tick_kernel": 0, "delay_draw": 0,
            "part_down": 0, "scenario_rows": 0, "k_tick": 0,
            "fused_tick_kernel[delay_draw]": 0,
            "fused_tick_kernel[part_down]": 0,
            "fused_tick_kernel[observers]": 0}
# The launches of each kernel's packed-layout instantiations (§14), by
# compute (§18: "packed" runs kernel #4, the packed lattice), counted
# beside the kernel's own count.
LAUNCHES.update({f"{k}[packed,{c}]": 0 for k in ("tick_kernel",
                                                 "fused_tick_kernel")
                 for c in ("unpacked", "packed")})

THREADS_PER_BLOCK = 128  # the kernel's __launch_bounds__

# Aux operands in the kernel's Params order, with their dtypes and rows.
_AUX = (("edge_iid", torch.int16, "pairs"), ("crash_m", torch.bool, "nodes"),
        ("restart_m", torch.bool, "nodes"), ("link_fail", torch.int16, "pairs"),
        ("link_heal", torch.int16, "pairs"),
        ("el_draw_f", torch.int16, "nodes"), ("bdraw", torch.int16, "nodes"),
        ("periodic", torch.int32, "one"), ("inject", torch.int32, "nodes"),
        ("delay", torch.int16, "pairs"))
_FLAG_BITS = {"faults": 1, "links": 2, "periodic": 4, "inject": 8,
              "delay": 16}
_NEEDS = {"faults": ("crash_m", "restart_m", "el_draw_f"),
          "links": ("link_fail", "link_heal"), "periodic": ("periodic",),
          "inject": ("inject",)}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    SNAPSHOT_BYTES["fused_tick_kernel"] = 0


def _rows(cfg: RaftConfig, k: str) -> int:
    N = cfg.n_nodes
    return N * N if k in PAIR_FIELDS or k in MAILBOX_FIELDS else \
        N * cfg.phys_capacity if k in LOG_FIELDS else N


def _delay_drawn(cfg: RaftConfig, flags) -> bool:
    """Whether a tick draws the §10 delays (lo == hi is a constant)."""
    return flags.delay and cfg.delay_lo < cfg.delay_hi


def _packed_shape(cfg: RaftConfig, k: str, G: int) -> tuple:
    N = cfg.n_nodes
    if k == "ctrl_bits":
        return (3, G)
    if k == "ov":
        return (G,)
    if k in PEER_BIT_FIELDS.values():
        return (N, G)
    return (_rows(cfg, k), G)


def _state_operands(cfg: RaftConfig, s: dict, flags,
                    layout: str = "wide") -> list:
    """The checked state tensors in STATE_FIELDS order, then the
    MAILBOX_FIELDS slots (None without the mailbox) — both kernels. Under
    the packed layout, PACKED_FIELDS then PACKED_MAILBOX_FIELDS."""
    dev = s["term"].device
    tick_mod.check_shallow(flags)
    G = s["term"].shape[-1]
    if G < 1:
        raise ValueError("the kernels need at least one group")
    if flags.delay != cfg.uses_mailbox:
        raise ValueError("flags.delay must match cfg.uses_mailbox: the "
                         "mailbox slots are the config's")
    if layout == "packed":
        fields, mail_fields = PACKED_FIELDS, PACKED_MAILBOX_FIELDS
        if cfg.n_nodes > 8:
            raise ValueError("the packed kernels take u8 peer masks "
                             "(n_nodes <= 8)")
    else:
        fields, mail_fields = STATE_FIELDS, MAILBOX_FIELDS
    for k in fields + (mail_fields if flags.delay else ()):
        if k not in s:
            raise ValueError(f"{k}: missing state operand")
        if layout == "packed":
            _check(k, s[k], packed_field_dtype(k, cfg),
                   _packed_shape(cfg, k, G), dev)
        else:
            _check(k, s[k], field_dtype(k, cfg), (_rows(cfg, k), G), dev)
    return [s[k] for k in fields] + [
        s[k] if flags.delay else None for k in mail_fields]


def narrow_code(cfg: RaftConfig) -> int:
    """The kernels' per-gate width code: bit i set where the fields of the
    i-th NARROW_GATES gate pack as int8 (else int16) — one uniform branch
    at each narrow load and store instead of an instantiation per
    combination."""
    return sum(1 << i for i, gate in enumerate(NARROW_GATES)
               if narrow_gate_int8(gate, cfg))


def layout_ints(cfg: RaftConfig, layout: str, compute: str) -> tuple:
    """The ints both kernels take after their own: the width code and the
    packed-compute switch (0 under the wide layout)."""
    packed = layout == "packed"
    return (narrow_code(cfg) if packed else 0,
            int(packed and compute == "packed"))


def _flag_bits(flags) -> int:
    bits = 0
    for name, bit in _FLAG_BITS.items():
        if getattr(flags, name):
            bits |= bit
    return bits


def kernel_operands(cfg: RaftConfig, s: dict, aux: dict,
                    flags: tick_mod.BodyFlags, layout: str = "wide") -> tuple:
    """Check every operand the kernel takes (device, dtype, shape,
    contiguity) and return (tensors in Params order with None for disabled
    aux channels, flag bits). Raises on anything the kernel does not take."""
    dev = s["term"].device
    N, G = cfg.n_nodes, s["term"].shape[-1]
    rows = {"nodes": N, "pairs": N * N, "one": 1}
    ops = _state_operands(cfg, s, flags, layout)
    bits = _flag_bits(flags)
    enabled = {"edge_iid", "bdraw"}.union(
        *(_NEEDS[f] for f in _NEEDS if getattr(flags, f)))
    if _delay_drawn(cfg, flags):
        enabled.add("delay")
    for name, dtype, kind in _AUX:
        if name in enabled:
            _check(name, aux[name], dtype, (rows[kind], G), dev)
            ops.append(aux[name])
        else:
            ops.append(None)
    return ops, bits


def tick_launch_args(cfg: RaftConfig, s: dict, aux: dict,
                     flags: tick_mod.BodyFlags, layout: str = "wide",
                     compute: str = "unpacked") -> tuple:
    """The one-tick kernel's launch arguments on the CUDA state `s`:
    (pointers in Params order, the int parameter block, el_dirty (N, G)
    bool, allocated for the kernel to fill)."""
    dev = s["term"].device
    ops, bits = kernel_operands(cfg, s, aux, flags, layout)
    N, C, G = cfg.n_nodes, cfg.phys_capacity, s["term"].shape[-1]
    el_dirty = torch.empty((N, G), dtype=torch.bool, device=dev)
    ptrs = [None if t is None else t.data_ptr() for t in ops]
    ptrs.append(el_dirty.data_ptr())
    # The library links its own CUDA runtime, so it is told the device too.
    ints = (G, C, cfg.majority, cfg.hb_ticks, cfg.round_ticks,
            cfg.retry_ticks, cfg.cmd_node, bits,
            int(cfg.log_dtype == "int16"), THREADS_PER_BLOCK,
            dev.index if dev.index is not None
            else torch.cuda.current_device(), cfg.delay_lo, cfg.delay_hi,
            *layout_ints(cfg, layout, compute))
    return ptrs, ints, el_dirty


def tick_plain_packed(cfg: RaftConfig, pf: dict, aux: dict,
                      flags: tick_mod.BodyFlags,
                      compute: str = "unpacked") -> torch.Tensor:
    """The plain version of the one-tick kernel's packed instantiations:
    the flat packed dict `pf` (ops/tick.flatten_packed) unpacked, one tick
    of phase_body (through the §18 form under compute="packed"), repacked
    in place with the width-overflow latch ORed into pf["ov"]; returns
    el_dirty (N, G) bool."""
    tick_mod.check_compute(compute)
    tick_mod.check_shallow(flags)
    s = tick_mod.unpack_flat(cfg, pf)
    body = (tick_mod.packed_compute_body if compute == "packed"
            else tick_mod.phase_body)
    el_dirty = body(cfg, s, aux, flags)
    tick_mod.repack_flat(cfg, s, pf)
    return el_dirty


def _count_launch(kernel: str, layout: str, compute: str) -> None:
    """One launch of `kernel`, and of its packed instantiation's count."""
    LAUNCHES[kernel] += 1
    if layout == "packed":
        LAUNCHES[f"{kernel}[packed,{compute}]"] += 1


def tick_kernel(cfg: RaftConfig, s: dict, aux: dict,
                flags: tick_mod.BodyFlags, layout: str = "wide",
                compute: str = "unpacked") -> torch.Tensor:
    """One tick of the phase lattice on the flat state dict `s` (views from
    ops/tick.flatten_state, or under layout="packed" from
    ops/tick.flatten_packed), in place; returns el_dirty (N, G) bool."""
    dev = s["term"].device
    tick_mod.check_shallow(flags)
    tick_mod.check_layout(layout, compute)
    if dev.type == "cpu":
        if layout == "packed":
            return tick_plain_packed(cfg, s, aux, flags, compute)
        return tick_mod.phase_body(cfg, s, aux, flags)
    if dev.type != "cuda":
        raise ValueError(f"tick_kernel runs on cuda (or cpu), not {dev}")
    ptrs, ints, el_dirty = tick_launch_args(cfg, s, aux, flags, layout,
                                            compute)

    from raft_kotlin_tpu_torch.ops.build import load_tick_library

    lib = load_tick_library(cfg.n_nodes, packed=layout == "packed")
    launch_library(lib.raft_tick_launch, ptrs, ints, dev, "tick kernel")
    _count_launch("tick_kernel", layout, compute)
    return el_dirty


# raft_tick_info's words: how a launch of the one-tick kernel runs.
TICK_INFO = ("tile", "threads", "smem_bytes", "blocks_per_sm", "registers",
             "local_bytes", "blocks", "bulk_segments", "staged_in",
             "staged_out")


def launch_info(fn, ptrs: list, ints: tuple, dev, what: str) -> dict:
    """Call a library's `*_info(pointers, ints, out)` for the launch those
    arguments describe (nothing is launched): {TICK_INFO key: int}, the
    form (1: the tile form), threads and dynamic shared memory a block,
    resident blocks an SM, registers and local bytes a thread, blocks,
    the staged tensors the full tiles bulk-copy, and a group's bytes staged
    into shared memory and written back from it (0 in the row form).
    Raises as a launch would."""
    out = (ctypes.c_longlong * len(TICK_INFO))()
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_ints = (ctypes.c_longlong * len(ints))(*ints)
    with torch.cuda.device(dev):
        err = fn(c_ptrs, c_ints, ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"{what} refused: cudaError_t {err}")
    return dict(zip(TICK_INFO, out))


def tick_kernel_info(cfg: RaftConfig, s: dict, aux: dict,
                     flags: tick_mod.BodyFlags, layout: str = "wide",
                     compute: str = "unpacked") -> dict:
    """launch_info of the one-tick kernel's launch on the CUDA state `s`
    with `aux` (nothing launched, nothing counted)."""
    from raft_kotlin_tpu_torch.ops.build import load_tick_library

    ptrs, ints, _ = tick_launch_args(cfg, s, aux, flags, layout, compute)
    lib = load_tick_library(cfg.n_nodes, packed=layout == "packed")
    return launch_info(lib.raft_tick_info, ptrs, ints, s["term"].device,
                       "tick kernel")


def make_cuda_tick(cfg: RaftConfig, device="cuda"):
    """tick(state, inject=None, fault_cmd=None) -> state: the contract of the
    JAX package's make_pallas_tick(cfg) at T=1 with staged aux — make_aux,
    then the tick kernel (the plain phase_body for a CPU state), then the
    §7 deferred election draws — updating `state` in place."""
    tick_mod.check_shallow(tick_mod.make_flags(cfg))
    return tick_mod.make_stepper(cfg, device, tick_kernel)


# ---------------------------------------------------------------------------
# In-kernel aux (SEMANTICS.md §17), the plain version: every per-tick
# channel re-derived from a few resident planes — the key table [base-key
# word 0; word 1; launch tick; global group index] and the timeout / backoff
# key-word planes — by the kt_* threefry twins. The twin of the staged
# make_aux over the same channel set, held bit-equal to it; the fused
# kernel evaluates the same draws per thread (csrc/kt_rng.cuh).

AUX_SOURCES = ("staged", "inkernel")


def inkernel_table_rows(cfg: RaftConfig) -> int:
    """Rows of the resident int32 key table: [k0; k1; tick0; gidx] plus one
    per §12 scenario-bank channel, in utils/rng.scen_layout order."""
    return 4 + len(rngmod.scen_layout(cfg))


def reject_timeout_windows(cfg: RaftConfig) -> None:
    """Per-group election-timeout windows (§19) are not wired into the
    kernels: every el-draw site bakes the config's scalar window."""
    if cfg.scenario is not None and cfg.scenario.timeout_windows:
        raise NotImplementedError(
            "scenario.timeout_windows (§19) is not wired into the kernels")


def inkernel_aux_statics(cfg: RaftConfig, base, tkeys, bkeys,
                         scen=None) -> dict:
    """The launch-invariant halves of the in-kernel operands, once per run:
    the key-table head (base-key words) and tail (global group index, then
    the §12 bank's rows in scen_layout order), and the (2N, G) timeout /
    backoff key-word planes (rows: word 0 of nodes 0..N-1, then word 1)."""
    reject_timeout_windows(cfg)
    scen = scen or {}
    keys = rngmod.scen_layout(cfg)
    missing = [k for k in keys if k not in scen]
    if missing:
        raise ValueError(f"the config's bank has rows {list(keys)}; "
                         f"{missing} were not given")
    dev = tkeys[0].device
    G = tkeys[0].shape[-1]
    b0, b1 = (rngmod._to_i32(int(w)) for w in base)
    head = torch.tensor([[b0], [b1]], dtype=torch.int32,
                        device=dev).expand(2, G)
    tail = torch.stack([torch.arange(G, dtype=torch.int32, device=dev)] + [
        scen[k].to(device=dev, dtype=torch.int32) for k in keys])
    t0, t1 = rngmod.kt_key_words(tkeys)
    u0, u1 = rngmod.kt_key_words(bkeys)
    return {"head": head, "tail": tail,
            "tkw": torch.cat([t0, t1]).contiguous(),
            "bkw": torch.cat([u0, u1]).contiguous()}


def inkernel_aux_operands(stat: dict, tick0: int) -> dict:
    """The in-kernel launch operands at launch tick `tick0`: the key table
    (its one per-launch row is a broadcast, not a draw) and the key-word
    planes."""
    G = stat["head"].shape[-1]
    row = torch.full((1, G), tick0, dtype=torch.int32,
                     device=stat["head"].device)
    return {"ktab": torch.cat([stat["head"], row, stat["tail"]]),
            "tkw": stat["tkw"], "bkw": stat["bkw"]}


def _kt_consts(cfg: RaftConfig, scen_keys: tuple, ktab, tkw, bkw) -> dict:
    """The launch constants unpacked from the resident operands: base-key
    word rows, the launch tick, the bank rows, per-lane flat lattice
    indices (pair element [p, g] at gidx*N*N + p, node element [n, g] at
    gidx*N + n — the row-major counters of the canonical shaped draws),
    each pair row's sender / receiver ids and the key words."""
    N = cfg.n_nodes
    dev = ktab.device
    gidx = ktab[3:4]
    p_col = torch.arange(N * N, dtype=torch.int32, device=dev)[:, None]
    return {
        "k0": ktab[0:1], "k1": ktab[1:2], "tick0": ktab[2:3],
        "scen": {nm: ktab[4 + i:5 + i] for i, nm in enumerate(scen_keys)},
        "idx_pair": gidx * (N * N) + p_col,
        "idx_node": gidx * N + torch.arange(
            N, dtype=torch.int32, device=dev)[:, None],
        "s_id": p_col // N + 1, "r_id": p_col % N + 1,
        "n_col": torch.arange(N, dtype=torch.int32, device=dev)[:, None],
        "tk0": tkw[:N], "tk1": tkw[N:], "bk0": bkw[:N], "bk1": bkw[N:],
    }


def _kt_thresh(cfg: RaftConfig, scen: dict, row: str, scalar: str):
    """A channel's 23-bit threshold: the scenario row when a bank carries
    it, else the config scalar through p_threshold, else None (the
    constant fast path) — make_aux's precedence."""
    if row in scen:
        return scen[row]
    p = getattr(cfg, scalar)
    return rngmod.p_threshold(p) if p > 0 else None


def _kt_edge(cfg: RaftConfig, kt: dict, tick, lead=None) -> torch.Tensor:
    """The tick's edge-survival lattice, (N*N, L) bool: the drop draw under
    the bank's threshold row or the config's (all up when neither draws),
    cut by a §12 bank's partition program — its leader program on `lead`,
    (N, L) bool, the live leaders at the tick's start (None: no leader
    program)."""
    N = cfg.n_nodes
    L = kt["k0"].shape[-1]
    scen = kt["scen"]
    et = _kt_thresh(cfg, scen, "drop_t", "p_drop")
    edge = (torch.ones((N * N, L), dtype=torch.bool, device=kt["k0"].device)
            if et is None else rngmod.kt_edge_ok_mask(
                kt["k0"], kt["k1"], tick, kt["idx_pair"], et))
    if "part_kind" in scen:
        lead_s = lead_r = None
        if lead is not None:
            lead_s = lead[(kt["s_id"][:, 0] - 1).long()]
            lead_r = lead[(kt["r_id"][:, 0] - 1).long()]
        down = rngmod.kt_part_down(
            scen["part_kind"], scen["part_cut"], scen["part_src"],
            scen["part_dst"], rngmod.scenario_active(scen, tick),
            kt["s_id"], kt["r_id"], lead_s, lead_r)
        edge = edge & ~down
    return edge


def _kt_aux(cfg: RaftConfig, flags: tick_mod.BodyFlags, kt: dict, s: dict,
            t: int) -> dict:
    """One tick's aux drawn from the resident planes at launch tick + t:
    the twin of ops/tick.make_aux over the channels `flags` select, with
    the counter-keyed draws at the live s["t_ctr"] / s["b_ctr"]. A §12
    bank's partition programs read the live role / up planes, which at a
    fused tick's start are the staged path's pre-tick state, and its
    warmup-down rule applies on the (N, L) orientation. Masks are bool,
    draws int32."""
    N = cfg.n_nodes
    dev = kt["k0"].device
    k0, k1, scen = kt["k0"], kt["k1"], kt["scen"]
    tick = kt["tick0"] + t
    lead = None
    if "part_kind" in scen and cfg.scenario.needs_state:
        lead = (s["role"] == LEADER) & (s["up"] != 0)  # (N, L)
    aux = {"edge_iid": _kt_edge(cfg, kt, tick, lead)}

    def event(kind, thresh, idx):
        if thresh is None:
            return torch.zeros(idx.shape, dtype=torch.bool, device=dev)
        return rngmod.kt_event_mask(k0, k1, kind, tick, idx, thresh)

    if flags.faults:
        crash = event(rngmod.KIND_CRASH,
                      _kt_thresh(cfg, scen, "crash_t", "p_crash"),
                      kt["idx_node"])
        restart = event(rngmod.KIND_RESTART,
                        _kt_thresh(cfg, scen, "restart_t", "p_restart"),
                        kt["idx_node"])
        W = 0 if cfg.scenario is None else cfg.scenario.warmup_down
        if W:
            # §15 warmup-down on the (N, L) orientation: apply_warmup_faults
            # on the transposed lattice.
            notcmd = kt["n_col"] != (cfg.cmd_node - 1)
            hold = (tick < W) & notcmd
            crash = crash | hold
            restart = (restart & ~hold) | ((tick == W) & notcmd)
        aux["crash_m"], aux["restart_m"] = crash, restart
        aux["el_draw_f"] = rngmod.kt_draw_uniform(
            kt["tk0"], kt["tk1"], s["t_ctr"], cfg.el_lo, cfg.el_hi)
    if flags.links:
        aux["link_fail"] = event(
            rngmod.KIND_LINK_FAIL,
            _kt_thresh(cfg, scen, "link_fail_t", "p_link_fail"),
            kt["idx_pair"])
        aux["link_heal"] = event(
            rngmod.KIND_LINK_HEAL,
            _kt_thresh(cfg, scen, "link_heal_t", "p_link_heal"),
            kt["idx_pair"])
    aux["bdraw"] = rngmod.kt_draw_uniform(
        kt["bk0"], kt["bk1"], s["b_ctr"], cfg.bo_lo, cfg.bo_hi)
    if flags.periodic:
        due = (torch.remainder(tick, cfg.cmd_period) == 0) & (tick > 0)
        aux["periodic"] = torch.where(due, tick, -1)
    if _delay_drawn(cfg, flags):
        aux["delay"] = rngmod.kt_delay_mask(
            k0, k1, tick, kt["idx_pair"], scen.get("delay_lo", cfg.delay_lo),
            scen.get("delay_hi", cfg.delay_hi))
    return aux


def _delay_window(cfg: RaftConfig, rows: dict) -> tuple:
    """The §10 delay window: a bank's per-lane rows, else the config's."""
    return (rows.get("delay_lo", cfg.delay_lo),
            rows.get("delay_hi", cfg.delay_hi))


def delay_draw_plain(cfg: RaftConfig, ktab: torch.Tensor) -> torch.Tensor:
    """The plain version of the stand-alone delay draw: the §10 delays of
    the key table's launch tick over the (N*N, G) pair lattice, int16 —
    `_kt_aux`'s kt_delay_mask, in a bank's per-lane windows where it has
    them."""
    N = cfg.n_nodes
    rows = {k: ktab[4 + i:5 + i]
            for i, k in enumerate(rngmod.scen_layout(cfg))}
    idx = ktab[3:4] * (N * N) + torch.arange(
        N * N, dtype=torch.int32, device=ktab.device)[:, None]
    return rngmod.kt_delay_mask(ktab[0:1], ktab[1:2], ktab[2:3], idx,
                                *_delay_window(cfg, rows)).to(torch.int16)


def _scen_rows(cfg: RaftConfig) -> dict:
    """Key-table row offsets (from row 4) of the bank channels the kernels
    read: each threshold, the delay window's first row and the partition
    program's first row (the window's and the program's rows are
    consecutive in scen_layout), -1 where the bank has none."""
    keys = rngmod.scen_layout(cfg)
    # In the kernel's order: FusedConsts drop_r .. lheal_r, delay_r, part_r.
    return {k: keys.index(k) if k in keys else -1
            for k in (*rngmod.THRESHOLD_CHANNELS, "delay_lo", "part_kind")}


def scen_rows_on(cfg: RaftConfig) -> bool:
    """Whether an in-kernel launch over `cfg` reads a §12 bank (a bank row
    or the warmup-down schedule): the fused kernel's kScen instantiation."""
    spec = cfg.scenario
    return spec is not None and (bool(rngmod.scen_layout(cfg))
                                 or spec.warmup_down > 0)


def delay_draw(cfg: RaftConfig, ktab: torch.Tensor) -> torch.Tensor:
    """kt_rng.cuh's delay_draw alone over one tick's pair lattice, (N*N, G)
    int16, from an in-kernel key table ((4 + bank rows, G) int32,
    inkernel_aux_operands) — the draw the fused kernel makes at each send;
    delay_draw_plain for a CPU table. Needs a drawn window (delay_lo <
    delay_hi)."""
    if not cfg.uses_mailbox or cfg.delay_lo >= cfg.delay_hi:
        raise ValueError("delay_draw needs a mailbox config with delay_lo < "
                         "delay_hi (a fixed delay is a constant, drawn "
                         "nowhere)")
    dev = ktab.device
    if dev.type == "cpu":
        return delay_draw_plain(cfg, ktab)
    if dev.type != "cuda":
        raise ValueError(f"delay_draw runs on cuda (or cpu), not {dev}")
    out = torch.empty((cfg.n_nodes ** 2, ktab.shape[-1]), dtype=torch.int16,
                      device=dev)
    ptrs, ints = delay_draw_args(cfg, ktab, out)

    from raft_kotlin_tpu_torch.ops.build import load_fused_library

    launch_library(load_fused_library(cfg.n_nodes).raft_delay_draw_launch,
                   ptrs, ints, dev, "delay draw")
    LAUNCHES["delay_draw"] += 1
    return out


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def delay_draw_args(cfg: RaftConfig, ktab: torch.Tensor,
                    out: torch.Tensor) -> tuple:
    """`raft_delay_draw_launch`'s (pointers, ints) for the key table `ktab`
    and the (N*N, G) int16 `out`; checks both."""
    N, G = cfg.n_nodes, ktab.shape[-1]
    dev = ktab.device
    _check("ktab", ktab, torch.int32, (inkernel_table_rows(cfg), G), dev)
    _check("out", out, torch.int16, (N * N, G), dev)
    return ([ktab.data_ptr(), out.data_ptr()],
            (G, cfg.delay_lo, cfg.delay_hi, THREADS_PER_BLOCK,
             _device_index(dev), _scen_rows(cfg)["delay_lo"]))


def part_down_plain(cfg: RaftConfig, ktab: torch.Tensor,
                    lead: torch.Tensor) -> torch.Tensor:
    """The plain version of the stand-alone edge lattice: the (N*N, G) bool
    edge channel of the key table's launch tick through the config's §12
    bank — _kt_aux's, with `lead` ((N, G) bool) the live leaders at the
    tick's start."""
    N = cfg.n_nodes
    keys = rngmod.scen_layout(cfg)
    dev = ktab.device
    p_col = torch.arange(N * N, dtype=torch.int32, device=dev)[:, None]
    kt = {"k0": ktab[0:1], "k1": ktab[1:2],
          "scen": {k: ktab[4 + i:5 + i] for i, k in enumerate(keys)},
          "idx_pair": ktab[3:4] * (N * N) + p_col,
          "s_id": p_col // N + 1, "r_id": p_col % N + 1}
    return _kt_edge(cfg, kt, ktab[2:3],
                    lead if cfg.scenario.needs_state else None)


def part_down(cfg: RaftConfig, ktab: torch.Tensor,
              lead: torch.Tensor) -> torch.Tensor:
    """kt_rng.cuh's part_down alone over one tick's (N*N, G) link lattice:
    the edge channel an in-kernel §12 launch draws at each pair (the drop
    draw under the bank's row, then the partition program), from an
    in-kernel key table ((4 + bank rows, G) int32, inkernel_aux_operands)
    and the (N, G) bool live leaders at the tick's start; part_down_plain
    for CPU tensors. Needs a bank with a partition program."""
    if "part_kind" not in rngmod.scen_layout(cfg):
        raise ValueError("part_down needs a §12 bank with a partition "
                         "program (scen_layout has no part_kind)")
    dev = ktab.device
    if dev.type == "cpu":
        return part_down_plain(cfg, ktab, lead)
    if dev.type != "cuda":
        raise ValueError(f"part_down runs on cuda (or cpu), not {dev}")
    out = torch.empty((cfg.n_nodes ** 2, ktab.shape[-1]), dtype=torch.bool,
                      device=dev)
    ptrs, ints = part_down_args(cfg, ktab, lead, out)

    from raft_kotlin_tpu_torch.ops.build import load_fused_library

    launch_library(load_fused_library(cfg.n_nodes).raft_part_down_launch,
                   ptrs, ints, dev, "part_down")
    LAUNCHES["part_down"] += 1
    return out


def part_down_args(cfg: RaftConfig, ktab: torch.Tensor, lead: torch.Tensor,
                   out: torch.Tensor) -> tuple:
    """`raft_part_down_launch`'s (pointers, ints) for the key table, the
    (N, G) bool leaders and the (N*N, G) bool `out`; checks them, and that
    every row offset of the kernel's 32-bit indexing fits (it refuses the
    launch otherwise)."""
    from raft_kotlin_tpu_torch.ops.build import check_offsets

    N, G = cfg.n_nodes, ktab.shape[-1]
    dev = ktab.device
    _check("ktab", ktab, torch.int32, (inkernel_table_rows(cfg), G), dev)
    _check("lead", lead, torch.bool, (N, G), dev)
    _check("out", out, torch.bool, (N * N, G), dev)
    check_offsets("part_down", max(ktab.shape[0], N * N), G)
    rows = _scen_rows(cfg)
    return ([ktab.data_ptr(), lead.data_ptr(), out.data_ptr()],
            (G, rngmod.p_threshold(cfg.p_drop) if cfg.p_drop > 0 else 0,
             rows["drop_t"], rows["part_kind"], THREADS_PER_BLOCK,
             _device_index(dev)))


def part_down_info(cfg: RaftConfig, ktab: torch.Tensor,
                   lead: torch.Tensor) -> dict:
    """How part_down's kernel launches on these operands (nothing is
    launched): launch_info's words (TICK_INFO) through
    `raft_part_down_info` — threads and blocks, resident blocks an SM,
    registers and local bytes a thread."""
    from raft_kotlin_tpu_torch.ops.build import load_fused_library

    out = torch.empty((cfg.n_nodes ** 2, ktab.shape[-1]), dtype=torch.bool,
                      device=ktab.device)
    ptrs, ints = part_down_args(cfg, ktab, lead, out)
    return launch_info(load_fused_library(cfg.n_nodes).raft_part_down_info,
                       ptrs, ints, ktab.device, "part_down")


# ---------------------------------------------------------------------------
# The staged fused pre-pass: a launch's T per-tick channel sets, T-stacked,
# and the counter-keyed draws as tables over the counter windows the launch
# can reach.

# The T-stacked channels in the kernel's operand order: per tick rows
# (a multiple of N) and the kernel's dtype.
FUSED_AUX = {"edge_iid": ("pairs", torch.int16),
             "crash_m": ("nodes", torch.bool),
             "restart_m": ("nodes", torch.bool),
             "link_fail": ("pairs", torch.int16),
             "link_heal": ("pairs", torch.int16),
             "periodic": ("one", torch.int32),
             "delay": ("pairs", torch.int16)}


def _aux_rows(cfg: RaftConfig, name: str) -> int:
    N = cfg.n_nodes
    return {"pairs": N * N, "nodes": N, "one": 1}[FUSED_AUX[name][0]]


def resets_per_tick_bound(N: int, delay_zero: bool = False) -> int:
    """Structural upper bound on election-timer resets per (node, tick) —
    the t_ctr advance a launch's draw table must cover: phase-F restart 1,
    phase-2 demotion 1, phase-3 adopts <= N, phase-4 demotion 1, phase-5
    adopt + quirk-d resets <= 2(N-1), phase-5 response demotes <= N-1:
    4N. Under the §10 mailbox at delay_lo == 0 (`delay_zero`) a pair can
    deliver twice a tick (its earlier slot, then its fresh send), doubling
    the phase-3 and phase-5 sites: 8N - 3."""
    return 8 * N - 3 if delay_zero else 4 * N


def config_resets_bound(cfg: RaftConfig) -> int:
    """resets_per_tick_bound for `cfg`'s regime."""
    return resets_per_tick_bound(cfg.n_nodes,
                                 cfg.uses_mailbox and cfg.delay_lo == 0)


def fused_aux_names(cfg: RaftConfig, flags: tick_mod.BodyFlags) -> tuple:
    """The T-stacked channels a staged fused launch takes under `flags`."""
    return tuple(
        k for k in FUSED_AUX
        if k == "edge_iid"
        or (k in ("crash_m", "restart_m") and flags.faults)
        or (k in ("link_fail", "link_heal") and flags.links)
        or (k == "periodic" and flags.periodic)
        or (k == "delay" and _delay_drawn(cfg, flags)))


def draw_tables(cfg: RaftConfig, tkeys, bkeys, t_ctr, b_ctr, K: int,
                resets_bound: Optional[int] = None) -> tuple:
    """The counter-keyed draw tables of a K-tick launch: el_table (N*W, G)
    with row n*W + j = node n's timeout draw at counter t_ctr0 + j (W =
    resets_bound * K), b_table (N*K, G) likewise over the backoff keys —
    the per-tick path's draws at the same counters, bit for bit. int16,
    the storage dtype of the fields they land in."""
    N = cfg.n_nodes
    if resets_bound is None:
        resets_bound = config_resets_bound(cfg)
    W = resets_bound * K

    def tab(keys, ctr0, Wn, lo, hi):
        j = torch.arange(Wn, dtype=torch.int64, device=ctr0.device)
        ctrs = ctr0.to(torch.int64)[:, None, :] + j[None, :, None]
        draws = rngmod.draw_uniform_keyed(
            (keys[0][:, None, :], keys[1][:, None, :]), ctrs, lo, hi)
        return draws.reshape(N * Wn, -1).to(torch.int16)  # row n*Wn + j

    return (tab(tkeys, t_ctr, W, cfg.el_lo, cfg.el_hi),
            tab(bkeys, b_ctr, K, cfg.bo_lo, cfg.bo_hi))


def fused_launch_aux(cfg: RaftConfig, base, tkeys, bkeys, tick0: int, t_ctr,
                     b_ctr, T: int, resets_bound: Optional[int] = None,
                     scen: Optional[dict] = None):
    """The staged pre-pass of one fused launch: the T per-tick channel sets
    (ops/tick.event_channels — every one keyed by (kind, tick) alone, and a
    §12 bank's rows) and the draw tables from the pre-launch counters.
    Returns (per-tick aux dicts, flags, (el_table, b_table)). A
    leader-isolation bank cannot be drawn ahead of its ticks (RuntimeError,
    from event_channels)."""
    flags = tick_mod.make_flags(cfg)
    G = t_ctr.shape[-1]
    per = [tick_mod.event_channels(cfg, base, tick0 + k, G, flags,
                                   t_ctr.device, scen=scen)
           for k in range(T)]
    tabs = draw_tables(cfg, tkeys, bkeys, t_ctr, b_ctr, T,
                       resets_bound=resets_bound)
    return per, flags, tabs


def fused_aux_slabs(per: list, aux_names: tuple) -> list:
    """T-stack the per-tick channels into the fused kernel's slab operands,
    in the kernel's dtypes."""
    return [torch.cat([p[nm].to(FUSED_AUX[nm][1]) for p in per])
            .contiguous() for nm in aux_names]


def staged_operands(cfg: RaftConfig, base, tkeys, bkeys, tick0: int, s: dict,
                    T: int, resets_bound: Optional[int] = None,
                    scen: Optional[dict] = None) -> dict:
    """The staged fused launch operands at launch tick `tick0` from the
    flat state `s`: {channel: (T*rows, G) slab, "el_table", "b_table"}."""
    per, flags, (el_tab, b_tab) = fused_launch_aux(
        cfg, base, tkeys, bkeys, tick0, s["t_ctr"], s["b_ctr"], T,
        resets_bound=resets_bound, scen=scen)
    names = fused_aux_names(cfg, flags)
    ops = dict(zip(names, fused_aux_slabs(per, names)))
    ops.update(el_table=el_tab, b_table=b_tab)
    return ops


# ---------------------------------------------------------------------------
# Fused observation: a fused launch snapshots, per tick, the fields the
# observers read, and they replay the T transitions between launches with
# the same step functions a one-tick runner calls.

FUSED_TRACE_FIELDS = ("role", "term", "commit", "last_index")
# The snapshot that stands in for the observers' two §10 due planes: per
# group after each tick, (2, G) int32 — the slots in flight and the bitmask
# of nodes owning an append slot in flight (utils/telemetry.mailbox_snapshot).
INFLIGHT = "inflight"


def fused_snapshot_fields(cfg: RaftConfig, telemetry: bool = False,
                          monitor: bool = False, trace: bool = False,
                          serving: bool = False,
                          per_group: bool = False) -> tuple:
    """The state fields a fused launch snapshots per tick so the requested
    observers can replay its T transitions, in STATE_FIELDS order (with
    `rounds` for the per-group monitor counters) — then, on a mailbox
    config with an observer on, INFLIGHT (the JAX package snapshots the
    vq_due / aq_due planes there; the observers read only the two rows
    INFLIGHT keeps of them)."""
    if serving:
        raise NotImplementedError("§20 serving is not ported yet")
    want = set()
    if trace:
        want.update(FUSED_TRACE_FIELDS)
    if telemetry:
        want.update(telemetry_mod.TELEMETRY_STATE_FIELDS)
    if monitor:
        want.update(telemetry_mod.MONITOR_STATE_FIELDS)
        if per_group:
            want.add("rounds")
    mail = (INFLIGHT,) if cfg.uses_mailbox and (telemetry or monitor) else ()
    return tuple(k for k in STATE_FIELDS if k in want) + mail


def snapshot_dtype(cfg: RaftConfig, k: str) -> torch.dtype:
    """Snapshots hold int32, except the logs, which keep their storage
    dtype."""
    return field_dtype(k, cfg) if k in LOG_FIELDS else torch.int32


def snapshot_rows(cfg: RaftConfig, k: str) -> int:
    """Rows of one tick's snapshot of `k` (INFLIGHT: two)."""
    return 2 if k == INFLIGHT else _rows(cfg, k)


def unpack_fused_outputs(snaps: dict, T: int) -> list:
    """A launch's (T, rows, G) snapshot buffers -> T per-tick dicts of
    (rows, G) views, tick-major."""
    return [{k: v[t] for k, v in snaps.items()} for t in range(T)]


def fused_observe(cfg: RaftConfig, prev_flat: dict, tick_flats: list, tel,
                  mon) -> tuple:
    """Advance the flight recorder and the monitor over the per-tick
    transitions of one fused launch, from its snapshot dicts. `prev_flat`
    is the pre-launch flat state (at least the snapshot fields). Returns
    (tel, mon)."""
    N = cfg.n_nodes
    for cur in tick_flats:
        if tel is not None:
            tel = telemetry_mod.telemetry_step_arrays(
                telemetry_mod.flat_view(prev_flat, N),
                telemetry_mod.flat_view(cur, N), tel)
        if mon is not None:
            mon = telemetry_mod.monitor_step_arrays(
                telemetry_mod.monitor_flat_view(prev_flat, N),
                telemetry_mod.monitor_flat_view(cur, N), mon)
        prev_flat = cur
    return tel, mon


# The observers a fused launch computes in the kernel (its observer build,
# csrc/fused_tick_kernel.cu RAFT_OBSERVE=1) in place of per-tick snapshots:
# per tick one (OBS_R,) int64 row of reductions, which
# utils/telemetry.fold_obs_rows folds into the recorder and the monitor
# carry, and the monitor's per-group carry updated in place.

# Per-group carry tensors a launch reads and writes in place, in the
# kernel's operand order.
OBS_CARRY = ("taint_restart", "taint_unsafe") + telemetry_mod.PER_GROUP_KEYS


@dataclasses.dataclass
class KernelObservers:
    """The observer operands of one fused launch. `monitor`: compute the
    monitor's step (else the recorder's alone); `carry`: the monitor
    carry's (G,) per-group tensors (OBS_CARRY keys present in it), updated
    in place; `rows`: set by the launch, its (T, OBS_R) int64 rows."""
    monitor: bool
    carry: dict
    rows: Optional[torch.Tensor] = None


def kernel_observers(mon: Optional[dict]) -> KernelObservers:
    """The observer operands of a launch advancing the monitor carry `mon`
    (None: the recorder alone)."""
    if mon is None:
        return KernelObservers(monitor=False, carry={})
    return KernelObservers(monitor=True, carry={
        k: mon[k] for k in OBS_CARRY if k in mon})


# Bytes of per-tick snapshot buffers the fused wrapper allocated for CUDA
# launches since the last reset_launch_counts(): a launch with in-kernel
# observers and no trace allocates none.
SNAPSHOT_BYTES = {"fused_tick_kernel": 0}


# ---------------------------------------------------------------------------
# The fused kernel: its plain version and its wrapper.

def _check_fused_flags(flags: tick_mod.BodyFlags, aux_source: str) -> None:
    tick_mod.check_shallow(flags)
    if aux_source not in AUX_SOURCES:
        raise ValueError(f"unknown aux_source {aux_source!r}")
    if flags.inject:
        raise ValueError(
            f"the fused kernel ({aux_source} aux) has no inject channel: "
            "per-tick injected commands are the one-tick kernel's surface")


def _snap_buffers(cfg: RaftConfig, s: dict, T: int, snap_fields) -> dict:
    G = s["term"].shape[-1]
    bad = [k for k in snap_fields if k not in STATE_FIELDS and not (
        k == INFLIGHT and cfg.uses_mailbox)]
    if bad:
        raise ValueError(f"cannot snapshot {bad}: not state fields")
    return {k: torch.empty((T, snapshot_rows(cfg, k), G),
                           dtype=snapshot_dtype(cfg, k),
                           device=s["term"].device) for k in snap_fields}


def fused_tick_plain(cfg: RaftConfig, s: dict, T: int,
                     flags: tick_mod.BodyFlags, aux_source: str, ops: dict,
                     snap_fields: tuple = (),
                     work: Optional[dict] = None, layout: str = "wide",
                     compute: str = "unpacked",
                     obs: Optional[KernelObservers] = None) -> tuple:
    """The fused kernel's plain version: T ticks of phase_body on the flat
    state `s`, in place. Each tick draws its aux — with `_kt_aux` from
    ops {"ktab", "tkw", "bkw"} (aux_source "inkernel"), or from the
    T-stacked slabs and the draw tables (ops from staged_operands) — runs
    the lattice, re-draws el_left of the reset nodes at t_ctr - 1, and
    writes the tick's snapshot rows. A table offset past its window is
    clamped and counted into the overflow; a negative one reads 0.
    Returns (overflow (N, G) int32, {field: (T, rows, G) snapshots}).

    `work`, when given, accumulates what the launch's data needs, for the
    kernel's bounds: "blocks", the threefry blocks the in-kernel draws
    evaluate (each channel drawn only where the tick uses it, as the kernel
    does), "staged_reads", {staged operand: entries the launch's ticks
    use}, the (N*C, G) bool masks "log_read" (slots whose stored value
    the launch reads before writing them — with `obs`, the in-kernel
    monitor's reads too) and "log_written", and under the mailbox "mail",
    phase_body's counts of slot payloads read and written.

    Under layout="packed" `s` is a flat packed dict (ops/tick.
    flatten_packed): it is unpacked once, the T ticks run on the wide
    values, and the end state is repacked in place with the width-overflow
    latch ORed into s["ov"] — the JAX package's packed scan, which packs
    at every launch's end. compute="packed" runs the lattice in the §18
    form for the whole launch (entered once, left once, as the kernel's
    registers hold it); the snapshots of votes / responses / responded are
    then the popcounts and bits of the words."""
    _check_fused_flags(flags, aux_source)
    tick_mod.check_layout(layout, compute)
    N = cfg.n_nodes
    G = s["term"].shape[-1]
    dev = s["term"].device
    pf = None
    if layout == "packed":
        pf, s = s, tick_mod.unpack_flat(cfg, s)
    pc = compute == "packed"
    if pc:
        wdt = {k: s[k].dtype for k in ("responded", "votes", "responses")}
        s = enter_packed_compute(cfg, s)
        flags = dataclasses.replace(flags, packed_compute=True)
    ov = torch.zeros((N, G), dtype=torch.int32, device=dev)
    snaps = _snap_buffers(cfg, s, T, snap_fields)
    inkernel = aux_source == "inkernel"
    if inkernel:
        kt = _kt_consts(cfg, rngmod.scen_layout(cfg), ops["ktab"],
                        ops["tkw"], ops["bkw"])
    else:
        el_tab = ops["el_table"].to(torch.int32)
        b_tab = ops["b_table"].to(torch.int32)
        W = el_tab.shape[0] // N
        rows = {nm: _aux_rows(cfg, nm) for nm in fused_aux_names(cfg, flags)}
    t0 = s["t_ctr"].to(torch.int32).clone()
    b0 = s["b_ctr"].to(torch.int32).clone()
    node_row = torch.arange(N, device=dev)[:, None]
    if obs is not None:
        obs.rows = telemetry_mod.obs_rows_init(T, dev)
        mail = telemetry_mod.mailbox_snapshot(s)
        owners = None if mail is None else mail[1]

    def sel(table, Wn, delta):
        # Node n's entry at offset delta of rows [n*Wn, (n+1)*Wn): clamped
        # and counted past the window, 0 below it.
        ov.add_((delta >= Wn).to(torch.int32))
        d = delta.clamp(max=Wn - 1)
        v = torch.gather(table, 0, node_row * Wn + d.clamp(min=0).long())
        return torch.where(d >= 0, v, 0)

    for t in range(T):
        pre = {k: s[k].clone() for k in ("up", "link_up", "b_ctr")} \
            if work is not None else None
        if inkernel:
            aux = _kt_aux(cfg, flags, kt, s, t)
        else:
            aux = {nm: ops[nm][t * r:(t + 1) * r] for nm, r in rows.items()}
            if flags.faults:
                aux["el_draw_f"] = sel(el_tab, W, s["t_ctr"] - t0)
            aux["bdraw"] = sel(b_tab, T, s["b_ctr"] - b0)
        touched = {} if work is not None else None
        track = reads = None
        if obs is not None:
            view0 = {k: _snap_value(cfg, s, k).clone() for k in OBS_VIEW}
            C = cfg.phys_capacity
            track = {k: torch.zeros((N * C, G), dtype=dt, device=dev)
                     for k, dt in (("written", torch.bool),
                                   ("changed", torch.bool),
                                   ("start_term", torch.int32),
                                   ("start_cmd", torch.int32))}
        el_dirty = tick_mod.phase_body(cfg, s, aux, flags, touched=touched,
                                       track=track)
        if inkernel:
            d = rngmod.kt_draw_uniform(kt["tk0"], kt["tk1"], s["t_ctr"] - 1,
                                       cfg.el_lo, cfg.el_hi)
        else:
            d = sel(el_tab, W, s["t_ctr"] - 1 - t0)
        s["el_left"].copy_(torch.where(el_dirty, d.to(s["el_left"].dtype),
                                       s["el_left"]))
        for k in snap_fields:
            snaps[k][t].copy_(telemetry_mod.mailbox_snapshot(s)
                              if k == INFLIGHT else _snap_value(cfg, s, k))
        if obs is not None:
            cur = {k: _snap_value(cfg, s, k) for k in OBS_VIEW + LOG_FIELDS
                   + ("phys_len",)}
            mail = telemetry_mod.mailbox_snapshot(s)
            reads = {} if work is not None and obs.monitor else None
            obs.rows[t] = telemetry_mod.obs_tick_rows(
                view0, cur, track["written"], track["changed"], owners, mail,
                obs.carry, obs.monitor, reads=reads)
            owners = None if mail is None else mail[1]
        if work is not None:
            _count_work(cfg, flags, work, pre, s, el_dirty, touched)
            if reads:  # the monitor's reads of slots no tick wrote before
                work["log_read"] |= reads["log"] & ~work["log_written"]
    if pc:
        s = exit_packed_compute(cfg, s, wdt)
    if pf is not None:
        tick_mod.repack_flat(cfg, s, pf)
    return ov, snaps


# The state fields of an observer row's pre- and post-tick views (the logs
# and phys_len are read post-tick only).
OBS_VIEW = ("role", "up", "term", "last_index", "commit", "hb_armed",
            "votes", "rounds", "cap_ov", "next_index", "match_index")


def _snap_value(cfg: RaftConfig, s: dict, k: str) -> torch.Tensor:
    """A snapshot row set of the lattice dict `s`; under §18 the vote set's
    wide values from its words."""
    if k in s:
        return s[k]
    if k == "responded":
        return unpack_peer_word_i32(s["responded_bits"], cfg.n_nodes)
    return popcount32(s["vote_bits" if k == "votes" else "responded_bits"])


def _count_work(cfg: RaftConfig, flags, work: dict, pre: dict, s: dict,
                el_dirty: torch.Tensor, touched: dict) -> None:
    """One tick's share of fused_tick_plain's `work` (see there)."""
    N, G = cfg.n_nodes, s["term"].shape[-1]
    draw = 5  # blocks per counted draw: fold the counter, two randint folds,
    # two bit lattices
    up0, up1 = pre["up"] != 0, s["up"] != 0
    link0 = pre["link_up"].reshape(N, N, -1) != 0
    link1 = s["link_up"].reshape(N, N, -1) != 0
    # The entries of each channel the tick uses: an edge where the link and
    # both ends are up, a crash draw for a live node, a restart draw for a
    # down one, a fail draw for a live link, a heal draw for a failed one;
    # one timeout-table entry per restart and per §7 draw, one backoff-table
    # entry per backoff.
    rows = rngmod.scen_layout(cfg)

    def on(row, p):  # the channel is drawn: a bank row or p > 0
        return row in rows or p > 0

    used = {"edge_iid": (on("drop_t", cfg.p_drop),
                         int((link1 & up1[:, None] & up1[None]).sum()))}
    if flags.faults:
        used["crash_m"] = (on("crash_t", cfg.p_crash), int(up0.sum()))
        used["restart_m"] = (on("restart_t", cfg.p_restart),
                             int((~up0).sum()))
    if flags.links:
        used["link_fail"] = (on("link_fail_t", cfg.p_link_fail),
                             int(link0.sum()))
        used["link_heal"] = (on("link_heal_t", cfg.p_link_heal),
                             int((~link0).sum()))
    counted = {"el_table": int((up1 & ~up0).sum()) + int(el_dirty.sum()),
               "b_table": int((s["b_ctr"] - pre["b_ctr"]).sum())}
    mail = touched.get("mail", {})
    sends = mail.get("vote_sent", 0) + mail.get("append_sent", 0)
    delays = sends if _delay_drawn(cfg, flags) else 0
    reads = work.setdefault("staged_reads", {})
    for k, n in [*((k, n) for k, (_, n) in used.items()), *counted.items(),
                 *([("periodic", G)] if flags.periodic else []),
                 *([("delay", delays)] if delays else [])]:
        reads[k] = reads.get(k, 0) + n
    # In-kernel: a channel with p <= 0 and no bank row is a constant, drawn
    # nowhere; each active channel's (kind, tick) key costs two folds per
    # group; a §10 delay costs two blocks a send and its tick key four per
    # group.
    live = [n for drawn, n in used.values() if drawn]
    blocks = sum(live) + draw * sum(counted.values()) + 2 * len(live) * G \
        + (2 * delays + 4 * G if _delay_drawn(cfg, flags) else 0)
    work["blocks"] = work.get("blocks", 0) + blocks
    for k, n in mail.items():
        work.setdefault("mail", {})
        work["mail"][k] = work["mail"].get(k, 0) + n
    wr = work.setdefault("log_written", torch.zeros_like(touched["log_written"]))
    rd = work.setdefault("log_read", torch.zeros_like(touched["log_written"]))
    rd |= (touched["log_term_read"] | touched["log_cmd_read"]) & ~wr
    wr |= touched["log_written"]


_FUSED_OPS = ("edge_iid", "crash_m", "restart_m", "link_fail", "link_heal",
              "periodic", "el_table", "b_table", "delay", "ktab", "tkw",
              "bkw")


def fused_operands(cfg: RaftConfig, s: dict, T: int,
                   flags: tick_mod.BodyFlags, aux_source: str, ops: dict,
                   snap_fields: tuple, layout: str = "wide",
                   compute: str = "unpacked",
                   obs: Optional[KernelObservers] = None) -> tuple:
    """Check every operand the fused kernel takes and allocate its outputs
    (with `obs`, the observer build's: obs.rows at their identities and
    the two shadow logs of its write tracking). Returns
    (tensors in Params order with None where unused, the int parameter
    block, overflow, snapshot buffers). Raises on anything the kernel does
    not take."""
    _check_fused_flags(flags, aux_source)
    tick_mod.check_layout(layout, compute)
    if T < 1:
        raise ValueError(f"T must be >= 1, got {T}")
    N, C = cfg.n_nodes, cfg.phys_capacity
    dev = s["term"].device
    G = s["term"].shape[-1]
    state = _state_operands(cfg, s, flags, layout)
    snaps = _snap_buffers(cfg, s, T, snap_fields)
    overflow = torch.empty((N, G), dtype=torch.int32, device=dev)
    want = {}
    W = 0
    if aux_source == "inkernel":
        want = {"ktab": (torch.int32, inkernel_table_rows(cfg)),
                "tkw": (torch.int32, 2 * N), "bkw": (torch.int32, 2 * N)}
    else:
        for nm in fused_aux_names(cfg, flags):
            want[nm] = (FUSED_AUX[nm][1], T * _aux_rows(cfg, nm))
        el = ops.get("el_table")
        if el is None or el.shape[0] % N or el.shape[0] < N:
            raise ValueError("el_table: the staged fused kernel takes an "
                             "(N*W, G) int16 table")
        W = el.shape[0] // N
        want["el_table"] = (torch.int16, N * W)
        want["b_table"] = (torch.int16, N * T)
    extra = set(ops) - set(want)
    if extra:
        raise ValueError(f"operands {sorted(extra)}: the {aux_source} fused "
                         "kernel does not take them")
    for nm, (dtype, r) in want.items():
        if nm not in ops:
            raise ValueError(f"{nm}: missing operand")
        _check(nm, ops[nm], dtype, (r, G), dev)
    tensors = state + [snaps.get(k) for k in STATE_FIELDS] \
        + [ops.get(nm) for nm in _FUSED_OPS] + [overflow,
                                                 snaps.get(INFLIGHT)]
    tensors += _obs_operands(cfg, s, T, obs, dev)

    def thresh(p, on=True):
        return rngmod.p_threshold(p) if on and p > 0 else 0

    ints = (G, C, cfg.majority, cfg.hb_ticks, cfg.round_ticks,
            cfg.retry_ticks, cfg.cmd_node, _flag_bits(flags),
            int(cfg.log_dtype == "int16"), THREADS_PER_BLOCK,
            dev.index if dev.index is not None
            else torch.cuda.current_device(),
            T, W, int(aux_source == "inkernel"), max(cfg.cmd_period, 1),
            cfg.el_lo, cfg.el_hi, cfg.bo_lo, cfg.bo_hi, thresh(cfg.p_drop),
            thresh(cfg.p_crash, flags.faults),
            thresh(cfg.p_restart, flags.faults),
            thresh(cfg.p_link_fail, flags.links),
            thresh(cfg.p_link_heal, flags.links), cfg.delay_lo, cfg.delay_hi,
            *_scen_rows(cfg).values(),
            cfg.scenario.warmup_down if cfg.scenario is not None else 0,
            *layout_ints(cfg, layout, compute))
    return tensors, ints, overflow, snaps


def _obs_operands(cfg: RaftConfig, s: dict, T: int,
                  obs: Optional[KernelObservers], dev) -> list:
    """The observer pointers in Params order: rows, the OBS_CARRY tensors
    (None without the monitor), the shadow logs. The observer build's write
    tracking (csrc/tick_body.cuh LogTrack) stores each written slot's
    tick-start value in the shadow logs whether or not the monitor reads
    them, so they are allocated for every observed launch."""
    if obs is None:
        return [None] * (3 + len(OBS_CARRY))
    G = s["term"].shape[-1]
    extra = set(obs.carry) - set(OBS_CARRY)
    if extra:
        raise ValueError(f"observer carry {sorted(extra)}: not per-group "
                         "monitor tensors")
    if obs.monitor != ("taint_restart" in obs.carry):
        raise ValueError("the monitor's launch takes its two taints")
    for k, v in obs.carry.items():
        _check(k, v, torch.bool if k.startswith("taint") else torch.int32,
               (G,), dev)
    obs.rows = telemetry_mod.obs_rows_init(T, dev)
    shadow = [torch.empty_like(s[k]) for k in LOG_FIELDS]
    return [obs.rows] + [obs.carry.get(k) for k in OBS_CARRY] + shadow


def fused_tick_kernel(cfg: RaftConfig, s: dict, T: int,
                      flags: tick_mod.BodyFlags, aux_source: str, ops: dict,
                      snap_fields: tuple = (), layout: str = "wide",
                      compute: str = "unpacked",
                      obs: Optional[KernelObservers] = None) -> tuple:
    """T ticks on the flat state dict `s` (under layout="packed", the flat
    packed dict), in place, through the fused kernel (CUDA tensors) or
    fused_tick_plain (CPU tensors). Returns (overflow (N, G) int32,
    {field: (T, rows, G) snapshots}).

    `obs` (KernelObservers) launches the observer build, which computes
    the recorder's and the monitor's steps in the kernel: obs.rows is set
    to the launch's (T, OBS_R) rows (fold them with
    utils/telemetry.fold_obs_rows) and obs.carry is updated in place. The
    snapshots then need not hold the observers' fields: a launch with
    observers and no `snap_fields` stores no per-tick snapshot. Every
    snapshot buffer allocated for a CUDA launch is counted in
    SNAPSHOT_BYTES."""
    dev = s["term"].device
    if dev.type == "cpu":
        return fused_tick_plain(cfg, s, T, flags, aux_source, ops,
                                snap_fields, layout=layout, compute=compute,
                                obs=obs)
    if dev.type != "cuda":
        raise ValueError(f"fused_tick_kernel runs on cuda (or cpu), not {dev}")
    tensors, ints, overflow, snaps = fused_operands(
        cfg, s, T, flags, aux_source, ops, snap_fields, layout, compute,
        obs=obs)
    SNAPSHOT_BYTES["fused_tick_kernel"] += sum(v.nbytes
                                               for v in snaps.values())

    from raft_kotlin_tpu_torch.ops.build import load_fused_library

    lib = load_fused_library(cfg.n_nodes, packed=layout == "packed",
                             observe=obs is not None)
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    launch_library(lib.raft_fused_launch, ptrs, ints, dev,
                   "fused tick kernel")
    _count_launch("fused_tick_kernel", layout, compute)
    if obs is not None:
        LAUNCHES["fused_tick_kernel[observers]"] += 1
    if aux_source == "inkernel" and _delay_drawn(cfg, flags):
        LAUNCHES["fused_tick_kernel[delay_draw]"] += 1
    if aux_source == "inkernel" and scen_rows_on(cfg):
        LAUNCHES["scenario_rows"] += 1
        if _scen_rows(cfg)["part_kind"] >= 0:
            LAUNCHES["fused_tick_kernel[part_down]"] += 1
    return overflow, snaps


# ---------------------------------------------------------------------------
# Kernel #7: K ticks a launch with staged aux, no observers — the JAX
# package's archival make_pallas_core_k.

def _k_tick_ops(slabs: dict, el_table: torch.Tensor,
                b_table: torch.Tensor) -> dict:
    return {**slabs, "el_table": el_table, "b_table": b_table}


def k_tick_plain(cfg: RaftConfig, s: dict, K: int, slabs: dict,
                 el_table: torch.Tensor, b_table: torch.Tensor,
                 work: Optional[dict] = None) -> torch.Tensor:
    """Kernel #7's plain version: K ticks of phase_body on the flat state
    `s`, in place, each tick's channels from the K-stacked `slabs`
    ({channel: (K*rows, G)}, fused_aux_names order) and its counted draws
    from the tables (draw_tables) — the restart draw under the fault
    channels, the backoff draw, el_left's draw at t_ctr - 1 — each select
    counted past its window. fused_tick_plain's staged form with no
    snapshot. Returns the (N, G) int32 overflow counts; `work` as
    fused_tick_plain's."""
    flags = tick_mod.make_flags(cfg)
    ov, _ = fused_tick_plain(cfg, s, K, flags, "staged",
                             _k_tick_ops(slabs, el_table, b_table), (),
                             work=work)
    return ov


def k_tick_kernel_info(cfg: RaftConfig, s: dict, K: int, slabs: dict,
                       el_table: torch.Tensor,
                       b_table: torch.Tensor) -> dict:
    """launch_info of kernel #7's launch on the CUDA state `s` (nothing
    launched, nothing counted)."""
    flags = tick_mod.make_flags(cfg)
    tensors, ints, _, _ = fused_operands(
        cfg, s, K, flags, "staged", _k_tick_ops(slabs, el_table, b_table),
        ())

    from raft_kotlin_tpu_torch.ops.build import load_fused_library

    lib = load_fused_library(cfg.n_nodes)
    return launch_info(lib.raft_k_tick_info,
                       [None if t is None else t.data_ptr() for t in tensors],
                       ints, s["term"].device, "K-tick kernel")


def k_tick_kernel(cfg: RaftConfig, s: dict, K: int, slabs: dict,
                  el_table: torch.Tensor,
                  b_table: torch.Tensor) -> torch.Tensor:
    """K ticks on the wide flat state `s`, in place, through kernel #7
    (`raft_k_tick_launch` in csrc/fused_tick_kernel.cu) for CUDA tensors,
    k_tick_plain for CPU tensors. Returns the (N, G) int32 overflow
    counts."""
    dev = s["term"].device
    if dev.type == "cpu":
        return k_tick_plain(cfg, s, K, slabs, el_table, b_table)
    if dev.type != "cuda":
        raise ValueError(f"k_tick_kernel runs on cuda (or cpu), not {dev}")
    flags = tick_mod.make_flags(cfg)
    tensors, ints, overflow, _ = fused_operands(
        cfg, s, K, flags, "staged", _k_tick_ops(slabs, el_table, b_table),
        ())

    from raft_kotlin_tpu_torch.ops.build import load_fused_library

    lib = load_fused_library(cfg.n_nodes)
    launch_library(lib.raft_k_tick_launch,
                   [None if t is None else t.data_ptr() for t in tensors],
                   ints, dev, "K-tick kernel")
    LAUNCHES["k_tick"] += 1
    return overflow
