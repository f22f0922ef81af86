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
from typing import Callable, Optional

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

    A §12 scenario bank (cfg.scenario) rides the rng operand: the staged
    draws take its rows on the host, the in-kernel ones as key-table rows.
    Its leader-isolation programs (cfg.scenario.needs_state) read each
    tick's pre-tick roles, which a staged fused launch, drawn before its T
    ticks run, cannot see: with staged aux a pinned fused_ticks > 1 raises
    ValueError and a routed T falls back to 1 (the JAX package's rule);
    the in-kernel draws read the live roles and fuse them at any T.

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
    if layout not in ("wide", "packed"):
        raise ValueError(f"unknown layout {layout!r}")
    if compute not in ("unpacked", "packed"):
        raise ValueError(f"unknown compute {compute!r}")
    if layout == "packed" or compute == "packed":
        raise NotImplementedError(
            "layout/compute='packed' (§14 packed layout, §18 packed "
            "compute) is not ported yet")
    if k_per_launch != 1:
        raise NotImplementedError(
            "k_per_launch > 1 (the archival K-tick kernel) is not ported")
    if serving:
        raise NotImplementedError("§20 serving is not ported yet")
    core = scan_core(cfg, n_ticks, telemetry=telemetry, monitor=monitor,
                     trace=trace, fused_ticks=fused_ticks,
                     aux_source=aux_source, _resets_bound=_resets_bound,
                     device=device)

    def run(state):
        state, traces, tel, mon = core(state)
        out = (state,)
        if trace:
            out += (traces,)
        if telemetry:
            out += (tel,)
        if monitor:
            out += (telemetry_mod.monitor_finalize(mon),)
        return out if len(out) > 1 else state

    return run


def scan_core(cfg: RaftConfig, n_ticks: int, telemetry: bool = False,
              monitor: bool = False, trace: bool = False,
              fused_ticks: Optional[int] = None, aux_source: str = "staged",
              _resets_bound: Optional[int] = None, per_group: bool = False,
              mutator: Optional[Callable] = None, device="cuda"):
    """make_cuda_scan's launch and observer loop: run(state) -> (state,
    trace dict or None, recorder or None, RAW monitor carry or None), the
    state advanced n_ticks in place. `per_group` carries the monitor's
    per-group counters.

    `mutator(state, t)`, with aux_source="inkernel", is a seeded mutation:
    it updates the RaftState in place after tick t's transition and before
    the observers read it. That needs the post-tick state of every tick
    between launches, so the run launches the fused kernel one tick at a
    time (still drawing in the kernel) — the mutation's semantics, not a
    fallback."""
    if n_ticks < 1:
        raise ValueError(f"n_ticks must be >= 1, got {n_ticks}")
    if aux_source not in cuda_tick.AUX_SOURCES:
        raise ValueError(f"unknown aux_source {aux_source!r}")
    inkernel = aux_source == "inkernel"
    if mutator is not None:
        if not inkernel:
            raise ValueError("a mutator runs with aux_source='inkernel'")
        if fused_ticks not in (None, 1):
            raise ValueError("a mutator applies between ticks: fused_ticks "
                             "must be 1")
        fused_ticks = 1
    check_supported(cfg)
    cuda_tick.reject_timeout_windows(cfg)
    dev = require_device(device)
    flags = tick_mod.make_flags(cfg)
    tick_mod.check_shallow(flags)
    if cfg.scenario is not None and cfg.scenario.needs_state \
            and not inkernel:
        if fused_ticks is not None and fused_ticks > 1:
            raise ValueError(
                "fused_ticks > 1 cannot run a leader-isolation scenario "
                "bank (cfg.scenario.needs_state) with staged aux: per-tick "
                "aux depends on pre-tick state the fused launch cannot "
                "see; use aux_source='inkernel'")
        fused_ticks = 1
    T = resolve_fused_geometry(cfg, dev, fused_ticks)
    n_launch, rem = divmod(n_ticks, T) if T > 1 else (0, n_ticks)
    snap_fields = () if mutator is not None else \
        cuda_tick.fused_snapshot_fields(cfg, telemetry=telemetry,
                                        monitor=monitor, trace=trace,
                                        per_group=per_group)
    observed = cuda_tick.fused_snapshot_fields(
        cfg, telemetry=telemetry, monitor=monitor, per_group=per_group)
    # What a tick run outside the snapshots (the staged T=1 program, a
    # mutated tick) hands the observers and the trace.
    watched = tuple(dict.fromkeys(observed + (
        cuda_tick.FUSED_TRACE_FIELDS if trace else ())))
    G = cfg.n_groups
    rng = tick_mod.make_rng(cfg, dev)

    def run(state):
        if state.term.shape[-1] != G:
            raise ValueError(f"state has {state.term.shape[-1]} groups but "
                             f"the runner was built for {G}")
        base, tkeys, bkeys, scen = tick_mod.split_rng(rng)
        s = tick_mod.flatten_state(cfg, state)
        stat = (cuda_tick.inkernel_aux_statics(cfg, base, tkeys, bkeys, scen)
                if inkernel else None)
        tel = telemetry_mod.telemetry_zeros(dev) if telemetry else None
        mon = telemetry_mod.monitor_init(G, n_ticks, monitor,
                                         per_group=per_group,
                                         **telemetry_mod.ops_kw(cfg),
                                         device=dev)

        def view():  # a copy of the watched fields of the live state
            return {k: telemetry_mod.mailbox_snapshot(s)
                    if k == cuda_tick.INFLIGHT else s[k].clone()
                    for k in watched}

        # The pre-launch view the observers read; after a fused launch, its
        # last snapshot (the port updates the state in place).
        prev = view()
        ov_total = torch.zeros((), dtype=torch.int64, device=dev)
        traces = []
        t = state.tick

        def observe(ticks):
            nonlocal prev, tel, mon
            if observed:
                tel, mon = cuda_tick.fused_observe(cfg, prev, ticks, tel, mon)
                prev = ticks[-1]
            if trace:
                traces.append({f: torch.stack([tk[f] for tk in ticks]).to(
                    torch.int32) for f in cuda_tick.FUSED_TRACE_FIELDS})

        def fused(Tl: int):
            nonlocal ov_total
            if inkernel:
                ops = cuda_tick.inkernel_aux_operands(stat, t)
            else:
                ops = cuda_tick.staged_operands(cfg, base, tkeys, bkeys, t, s,
                                                Tl, _resets_bound, scen=scen)
            ov, snaps = cuda_tick.fused_tick_kernel(
                cfg, s, Tl, flags, aux_source, ops, snap_fields)
            ov_total = ov_total + ov.sum()
            if mutator is None:
                observe(cuda_tick.unpack_fused_outputs(snaps, Tl))
            else:
                mutator(state, t)
                observe([view()])

        def one_tick():
            # The staged T=1 program: make_aux (on the pre-tick role / up
            # too, for a leader-isolation bank), the one-tick kernel, the §7
            # draws on the host.
            shim = types.SimpleNamespace(
                tick=t, term=s["term"], role=s["role"], up=s["up"],
                t_ctr=s["t_ctr"], b_ctr=s["b_ctr"])
            aux, fl = tick_mod.make_aux(cfg, base, tkeys, bkeys, shim,
                                        scen=scen)
            el_dirty = cuda_tick.tick_kernel(cfg, s, aux, fl)
            tick_mod.materialize_el(cfg, tkeys, s, el_dirty)
            observe([view()] if watched else [])

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
        tr = ({f: torch.cat([x[f] for x in traces])
               for f in cuda_tick.FUSED_TRACE_FIELDS} if trace else None)
        return state, tr, tel, mon

    return run
