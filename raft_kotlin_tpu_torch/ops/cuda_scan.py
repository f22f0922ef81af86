"""The multi-tick runner over a flat carry — the counterpart of the JAX
package's `ops/pallas_tick.make_pallas_scan`, on the port's kernels.

`make_cuda_scan(cfg, n_ticks, ...)` returns run(state), which advances the
state n_ticks in place: full T-blocks through the fused kernel
(ops/cuda_tick.fused_tick_kernel), the n_ticks % T remainder one tick at a
time, with the flight recorder, the safety monitor and the differential
trace replayed from the fused launches' snapshots. The flat views of the
state are built once per call and the kernels update them in place, so
nothing is rebuilt between launches — the §10 mailbox slots too, on a
mailbox config.
"""

from __future__ import annotations

import types
from typing import Optional

import torch

from raft_kotlin_tpu_torch.models.state import check_supported, require_device
from raft_kotlin_tpu_torch.ops import cuda_tick
from raft_kotlin_tpu_torch.ops import tick as tick_mod
from raft_kotlin_tpu_torch.utils import telemetry as telemetry_mod
from raft_kotlin_tpu_torch.utils.config import RaftConfig

# The fused depth on a card until a plan layer for the card is ported: the
# JAX package's headline plan row's T.
CUDA_FUSED_TICKS = 4


def resolve_fused_geometry(cfg: RaftConfig, device,
                           fused_ticks: Optional[int] = None) -> int:
    """The fused depth T a make_cuda_scan call runs with: the caller's pin,
    else 1 on the CPU (where nothing is launched, so there is no launch cost
    to amortize — the JAX package's CPU rule) and CUDA_FUSED_TICKS on a
    card."""
    if fused_ticks is not None:
        if fused_ticks < 1:
            raise ValueError(f"fused_ticks must be >= 1, got {fused_ticks}")
        return int(fused_ticks)
    return 1 if torch.device(device).type == "cpu" else CUDA_FUSED_TICKS


def make_cuda_scan(cfg: RaftConfig, n_ticks: int,
                   k_per_launch: int = 1,
                   _resets_bound: Optional[int] = None,
                   telemetry: bool = False,
                   monitor: bool = False,
                   fused_ticks: Optional[int] = None,
                   trace: bool = False,
                   layout: str = "wide",
                   aux_source: str = "staged",
                   compute: str = "unpacked",
                   serving: bool = False,
                   device="cuda"):
    """Multi-tick runner with a flat carry: run(state) advances `state`
    n_ticks in place and returns (state[, trace][, telemetry][, monitor]),
    or the state alone when no observer is on.

    Full T-blocks launch the fused kernel (T = resolve_fused_geometry:
    `fused_ticks`, else 1 on the CPU and 4 on a card); the n_ticks % T
    remainder runs one tick per launch — through the fused kernel at T=1
    under aux_source="inkernel", so that no draw runs on the host anywhere,
    and through the one-tick kernel with make_aux and materialize_el under
    "staged" (the JAX package's T=1 program). Same bits either way.

    `aux_source`: "staged" (the JAX default: the draws run as plain torch
    ops before each launch) or "inkernel" (the kernel draws them). The
    staged fused launches take their counter-keyed draws from tables over
    the counter window a launch can reach (resets_per_tick_bound per tick,
    8N - 3 under the mailbox at delay_lo == 0; `_resets_bound` overrides
    it, for tests); an offset past a window is
    counted on the device, every fused launch's count is summed there, and
    the sum is read once per call: a nonzero sum raises RuntimeError, and
    the state, already advanced in place, is invalid. (The in-kernel draws
    have no window: their count is 0 by construction.)

    `telemetry` (the flight recorder), `monitor` (the safety monitor,
    returned in its finalized form) and `trace` (per-tick role / term /
    commit / last_index, (n_ticks, N, G) int32) work under fusion: each
    fused launch snapshots the fields they read and they replay its T
    transitions (ops/cuda_tick.fused_observe).

    Left out of the JAX signature: `tile_g`, `ilp_subtiles` and `interpret`
    (nothing to tile or interpret in a one-thread-per-group CUDA kernel)
    and `jitted` (torch runs eagerly; the overflow is checked per call).
    Not ported yet, and refused: layout="packed" and compute="packed" (the
    §14 packed layout, §18 packed compute), k_per_launch > 1 (the archival
    K-tick kernel) and serving (§20).

    The entry point runs on the card unless `device` names the CPU, where
    every launch runs its kernel's plain version."""
    if n_ticks < 1:
        raise ValueError(f"n_ticks must be >= 1, got {n_ticks}")
    if layout not in ("wide", "packed"):
        raise ValueError(f"unknown layout {layout!r}")
    if compute not in ("unpacked", "packed"):
        raise ValueError(f"unknown compute {compute!r}")
    if aux_source not in cuda_tick.AUX_SOURCES:
        raise ValueError(f"unknown aux_source {aux_source!r}")
    if layout == "packed" or compute == "packed":
        raise NotImplementedError(
            "layout/compute='packed' (§14 packed layout, §18 packed "
            "compute) is not ported yet")
    if k_per_launch != 1:
        raise NotImplementedError(
            "k_per_launch > 1 (the archival K-tick kernel) is not ported")
    if serving:
        raise NotImplementedError("§20 serving is not ported yet")
    check_supported(cfg)
    cuda_tick.reject_timeout_windows(cfg)
    dev = require_device(device)
    flags = tick_mod.make_flags(cfg)
    tick_mod.check_shallow(flags)
    T = resolve_fused_geometry(cfg, dev, fused_ticks)
    n_launch, rem = divmod(n_ticks, T) if T > 1 else (0, n_ticks)
    inkernel = aux_source == "inkernel"
    snap_fields = cuda_tick.fused_snapshot_fields(
        cfg, telemetry=telemetry, monitor=monitor, trace=trace)
    observed = cuda_tick.fused_snapshot_fields(
        cfg, telemetry=telemetry, monitor=monitor)
    G = cfg.n_groups
    rng = tick_mod.make_rng(cfg, dev)

    def run(state):
        if state.term.shape[-1] != G:
            raise ValueError(f"state has {state.term.shape[-1]} groups but "
                             f"the runner was built for {G}")
        base, tkeys, bkeys = rng
        s = tick_mod.flatten_state(cfg, state)
        stat = (cuda_tick.inkernel_aux_statics(cfg, base, tkeys, bkeys)
                if inkernel else None)
        tel = telemetry_mod.telemetry_zeros(dev) if telemetry else None
        mon = telemetry_mod.monitor_init(G, n_ticks, monitor,
                                         **telemetry_mod.ops_kw(cfg),
                                         device=dev)
        # The pre-launch view the observers read; after a fused launch, its
        # last snapshot (the port updates the state in place).
        prev = {k: telemetry_mod.mailbox_snapshot(s)
                if k == cuda_tick.INFLIGHT else s[k].clone()
                for k in observed}
        ov_total = torch.zeros((), dtype=torch.int64, device=dev)
        traces = []
        t = state.tick

        def fused(Tl: int):
            nonlocal prev, tel, mon, ov_total
            if inkernel:
                ops = cuda_tick.inkernel_aux_operands(stat, t)
            else:
                ops = cuda_tick.staged_operands(cfg, base, tkeys, bkeys, t, s,
                                                Tl, _resets_bound)
            ov, snaps = cuda_tick.fused_tick_kernel(
                cfg, s, Tl, flags, aux_source, ops, snap_fields)
            ov_total = ov_total + ov.sum()
            ticks = cuda_tick.unpack_fused_outputs(snaps, Tl)
            if observed:
                tel, mon = cuda_tick.fused_observe(cfg, prev, ticks, tel, mon)
                prev = ticks[-1]
            if trace:
                traces.append({f: snaps[f] for f in
                               cuda_tick.FUSED_TRACE_FIELDS})

        def one_tick():
            # The staged T=1 program: make_aux, the one-tick kernel, the §7
            # draws on the host.
            nonlocal prev, tel, mon
            shim = types.SimpleNamespace(tick=t, term=s["term"],
                                         t_ctr=s["t_ctr"], b_ctr=s["b_ctr"])
            aux, fl = tick_mod.make_aux(cfg, base, tkeys, bkeys, shim)
            el_dirty = cuda_tick.tick_kernel(cfg, s, aux, fl)
            tick_mod.materialize_el(cfg, tkeys, s, el_dirty)
            if observed:
                cur = {k: telemetry_mod.mailbox_snapshot(s)
                       if k == cuda_tick.INFLIGHT else s[k] for k in observed}
                tel, mon = cuda_tick.fused_observe(cfg, prev, [cur], tel, mon)
                prev = {k: v.clone() for k, v in cur.items()}
            if trace:
                traces.append({f: s[f].to(torch.int32, copy=True)[None]
                               for f in cuda_tick.FUSED_TRACE_FIELDS})

        for _ in range(n_launch):
            fused(T)
            t += T
        for _ in range(rem):
            if inkernel:
                fused(1)
            else:
                one_tick()
            t += 1
        state.tick = t
        # The one host read of the call.
        if (n_launch or inkernel) and int(ov_total):
            raise RuntimeError(
                f"fused-tick kernel draw-table overflow: a node consumed more "
                f"election-timer resets within one {T}-tick launch than the "
                f"draw tables cover (resets_per_tick_bound) — the launch's "
                f"draws were clamped, so the state is INVALID")
        out = (state,)
        if trace:
            out += ({f: torch.cat([tr[f] for tr in traces])
                     for f in cuda_tick.FUSED_TRACE_FIELDS},)
        if telemetry:
            out += (tel,)
        if monitor:
            out += (telemetry_mod.monitor_finalize(mon),)
        return out if len(out) > 1 else state

    return run
