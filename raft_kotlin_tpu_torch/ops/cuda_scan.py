"""The multi-tick runner over a flat carry — the counterpart of the JAX
package's `ops/pallas_tick.make_pallas_scan`, on the port's kernels.

`make_cuda_scan(cfg, n_ticks, ...)` returns run(state), which advances the
state n_ticks in place: full T-blocks through the fused kernel
(ops/cuda_tick.fused_tick_kernel) — or, with k_per_launch = K > 1, full
K-blocks through kernel #7 (ops/cuda_tick.k_tick_kernel) — the remainder
one tick at a time. The flight recorder and the safety monitor are
computed inside each fused launch (the kernel's observer build) and folded
into their carry after it (utils/telemetry.fold_obs_rows); they are
replayed on the host (ops/cuda_tick.fused_observe) only over a tick that
runs outside the fused kernel (the staged remainder) or that a mutator
rewrote. The differential trace comes from the fused launches' snapshots
of its four small fields. The flat views of the
state are built once per call and the kernels update them in place, so
nothing is rebuilt between launches — the §10 mailbox slots too, on a
mailbox config. Under layout="packed" the state is packed once at entry
and the kernels' packed instantiations update the packed tensors in place
(no pack or unpack between launches); it is unpacked into the caller's
state once at exit.
"""

from __future__ import annotations

import types
from typing import Callable, Optional

import torch

from raft_kotlin_tpu_torch.models.state import (
    check_packed_ov, check_supported, pack_state, require_device,
    unpack_state)
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
    fused launch computes the recorder's and the monitor's T steps in the
    kernel and they are folded into the carry after it; the trace is the
    one per-tick snapshot a launch stores.

    `layout="packed"` (SEMANTICS.md §14) packs the state once at entry
    (models/state.pack_state) and runs the kernels' packed-layout
    instantiations on the packed tensors in place — the one-tick kernel's
    for the staged remainder, with make_aux reading the packed counters —
    and unpacks into the caller's state once at exit; the observers' first
    view is one unpack at entry, then each launch's last snapshot. The
    kernels latch every narrowed value that misses its packed range: the
    state at each launch's end, and each log or §10 slot write as it is
    made — so their latch holds the JAX package's, whose scan checks only
    the values left at each launch's end (`_carry_in`), and may hold more
    (a miss overwritten in range within a launch: csrc/tick_body.cuh).
    The latch is read with the draw overflow in the call's one host read,
    before anything reaches the caller's state. Where it is set, the call
    reruns in the wide layout from the caller's untouched entry state,
    with the same launches, aux source, observers and trace, and applies
    the packed range check (models/state.pack_state) at entry and at each
    launch's end — JAX's rule: it raises RuntimeError ("width overflow")
    only where that check fails, and otherwise returns the wide rerun's
    state, trace, recorder and monitor. `compute="packed"`
    (§18) runs the kernels' packed lattice (kernel #4) and needs the
    packed layout (ValueError otherwise, as in the JAX package). The
    packed layout with a §12 scenario bank is not ported
    (NotImplementedError): the JAX package's farm routes no layout.

    `k_per_launch` = K > 1 runs the full K-blocks through kernel #7, the
    JAX package's archival K-tick kernel (ops/cuda_tick.k_tick_kernel:
    staged aux, K-stacked channels and draw tables, no observer), and the
    n_ticks % K remainder through the staged one-tick program; the draw
    tables' overflow is summed on the device and read once per call, as
    above. It takes the JAX package's guards, each a ValueError: no
    in-kernel aux, no packed layout or compute, no observer (telemetry,
    monitor, trace, serving), no fused_ticks other than None or 1, and no
    leader-isolation bank (its staged aux would need each tick's pre-tick
    roles); a bank without leader programs rides the staged channels.

    Left out of the JAX signature: `tile_g`, `ilp_subtiles` and `interpret`
    (nothing to tile or interpret in a one-thread-per-group CUDA kernel)
    and `jitted` (torch runs eagerly; the overflow is checked per call).
    Not ported yet, and refused: serving (§20).

    The entry point runs on the card unless `device` names the CPU, where
    every launch runs its kernel's plain version."""
    K = max(1, k_per_launch)
    if K > 1:
        check_k_per_launch(cfg, telemetry=telemetry, monitor=monitor,
                           trace=trace, serving=serving,
                           fused_ticks=fused_ticks, layout=layout,
                           aux_source=aux_source, compute=compute)
    if serving:
        raise NotImplementedError("§20 serving is not ported yet")
    core = scan_core(cfg, n_ticks, telemetry=telemetry, monitor=monitor,
                     trace=trace, fused_ticks=fused_ticks,
                     aux_source=aux_source, _resets_bound=_resets_bound,
                     layout=layout, compute=compute, k_per_launch=K,
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


def check_k_per_launch(cfg: RaftConfig, telemetry: bool = False,
                       monitor: bool = False, trace: bool = False,
                       serving: bool = False,
                       fused_ticks: Optional[int] = None,
                       layout: str = "wide", aux_source: str = "staged",
                       compute: str = "unpacked") -> None:
    """The JAX package's guards on k_per_launch > 1 (make_pallas_scan), in
    its order and with its exception type: kernel #7 is a wide, unpacked,
    staged-aux surface with no per-tick state for an observer. The checks
    every runner shares (layout, aux_source, timeout windows) are
    scan_core's."""
    if compute == "packed":
        raise ValueError("compute='packed' needs k_per_launch == 1 (the "
                         "archival K-tick kernel is an unpacked-compute "
                         "surface)")
    if aux_source == "inkernel":
        raise ValueError("aux_source='inkernel' needs k_per_launch == 1 "
                         "(the archival K-tick kernel is a staged-aux "
                         "surface)")
    if layout == "packed":
        raise ValueError("layout='packed' needs k_per_launch == 1 (the "
                         "archival K-tick kernel exposes no per-tick state "
                         "to repack between launches)")
    if telemetry or monitor or trace or serving:
        raise ValueError("telemetry/monitor/trace/serving need "
                         "k_per_launch == 1: the K-tick kernel exposes no "
                         "per-tick state between launches")
    if fused_ticks not in (None, 1):
        raise ValueError("k_per_launch (the archival K-tick kernel) and "
                         "fused_ticks (the fused-T engine) are mutually "
                         "exclusive")
    if cfg.scenario is not None and cfg.scenario.needs_state:
        raise ValueError("k_per_launch > 1 cannot run a leader-isolation "
                         "scenario bank (cfg.scenario.needs_state): per-tick "
                         "aux depends on pre-tick state the K-tick launch "
                         "cannot see")


def scan_core(cfg: RaftConfig, n_ticks: int, telemetry: bool = False,
              monitor: bool = False, trace: bool = False,
              fused_ticks: Optional[int] = None, aux_source: str = "staged",
              _resets_bound: Optional[int] = None, per_group: bool = False,
              mutator: Optional[Callable] = None, layout: str = "wide",
              compute: str = "unpacked", k_per_launch: int = 1,
              device="cuda", _width_latch: bool = False):
    """make_cuda_scan's launch and observer loop: run(state) -> (state,
    trace dict or None, recorder or None, RAW monitor carry or None), the
    state advanced n_ticks in place. `per_group` carries the monitor's
    per-group counters.

    `mutator(state, t)`, with aux_source="inkernel", is a seeded mutation:
    it updates the RaftState in place after tick t's transition and before
    the observers read it. That needs the post-tick state of every tick
    between launches, so the run launches the fused kernel one tick at a
    time (still drawing in the kernel) — the mutation's semantics, not a
    fallback.

    `layout` / `compute`: make_cuda_scan's (a mutator needs the wide
    layout: it rewrites the RaftState between ticks). `k_per_launch` > 1:
    make_cuda_scan's, its guards checked there (check_k_per_launch).
    `_width_latch` (the wide rerun of a packed call whose kernel latch is
    set): the packed range check at entry and at each launch's end, read
    with the draw overflow, a failure raising "width overflow"."""
    if n_ticks < 1:
        raise ValueError(f"n_ticks must be >= 1, got {n_ticks}")
    tick_mod.check_layout(layout, compute)
    packed = layout == "packed"
    if packed and mutator is not None:
        raise ValueError("a mutator rewrites the wide state: layout must be "
                         "'wide'")
    if packed and cfg.scenario is not None:
        raise NotImplementedError(
            "a §12 scenario bank with layout='packed' is not ported (the "
            "JAX package's farm routes no layout)")
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
    k_tick = k_per_launch > 1
    T = k_per_launch if k_tick else resolve_fused_geometry(cfg, dev,
                                                          fused_ticks)
    n_launch, rem = divmod(n_ticks, T) if T > 1 else (0, n_ticks)
    # A fused launch snapshots the trace's fields alone: the observers run
    # in the kernel (a mutated launch snapshots nothing; its observers
    # replay the mutated state).
    snap_fields = () if mutator is not None else \
        cuda_tick.fused_snapshot_fields(cfg, trace=trace)
    observed = cuda_tick.fused_snapshot_fields(
        cfg, telemetry=telemetry, monitor=monitor, per_group=per_group)
    # What a tick run outside the fused kernel's observers (the staged T=1
    # program, a mutated tick) hands the replay and the trace.
    watched = tuple(dict.fromkeys(observed + (
        cuda_tick.FUSED_TRACE_FIELDS if trace else ())))
    G = cfg.n_groups
    rng = tick_mod.make_rng(cfg, dev)

    def run(state):
        if state.term.shape[-1] != G:
            raise ValueError(f"state has {state.term.shape[-1]} groups but "
                             f"the runner was built for {G}")
        base, tkeys, bkeys, scen = tick_mod.split_rng(rng)
        wide = tick_mod.flatten_state(cfg, state)
        # The wide rerun's packed range check, taken at entry and at each
        # launch's end (pack_state.ov: JAX's _carry_in rule).
        latch = pack_state(cfg, state).ov if _width_latch else None
        # The state the launches update in place: the caller's (wide), or
        # its pack, unpacked into the caller's at exit.
        ps = pack_state(cfg, state) if packed else None
        s = tick_mod.flatten_packed(cfg, ps) if packed else wide
        stat = (cuda_tick.inkernel_aux_statics(cfg, base, tkeys, bkeys, scen)
                if inkernel else None)
        tel = telemetry_mod.telemetry_zeros(dev) if telemetry else None
        mon = telemetry_mod.monitor_init(G, n_ticks, monitor,
                                         per_group=per_group,
                                         **telemetry_mod.ops_kw(cfg),
                                         device=dev)

        def view():  # a copy of the watched fields of the live state
            src = (tick_mod.flatten_state(cfg, unpack_state(cfg, ps))
                   if packed else s)
            return {k: telemetry_mod.mailbox_snapshot(src)
                    if k == cuda_tick.INFLIGHT else src[k].clone()
                    for k in watched}

        # The pre-tick view a host replay reads: taken before a replayed
        # tick where the last launch observed in the kernel, else the last
        # replayed tick's view (the port updates the state in place).
        prev = None
        ov_total = torch.zeros((), dtype=torch.int64, device=dev)
        traces = []
        t = state.tick

        def before_replay():
            nonlocal prev
            if observed and prev is None:
                prev = view()

        def record(ticks):
            if trace:
                traces.append({f: torch.stack([tk[f] for tk in ticks]).to(
                    torch.int32) for f in cuda_tick.FUSED_TRACE_FIELDS})

        def observe(ticks):
            nonlocal prev, tel, mon
            if observed:
                tel, mon = cuda_tick.fused_observe(cfg, prev, ticks, tel, mon)
                prev = ticks[-1]
            record(ticks)

        def k_launch():
            # Kernel #7: the K channel sets and the draw tables staged from
            # the pre-launch counters.
            nonlocal ov_total
            ops = cuda_tick.staged_operands(cfg, base, tkeys, bkeys, t, s, T,
                                            _resets_bound, scen=scen)
            el_tab, b_tab = ops.pop("el_table"), ops.pop("b_table")
            ov = cuda_tick.k_tick_kernel(cfg, s, T, ops, el_tab, b_tab)
            ov_total = ov_total + ov.sum()

        def fused(Tl: int):
            nonlocal ov_total, tel, mon, prev
            if mutator is not None:
                before_replay()
            if inkernel:
                ops = cuda_tick.inkernel_aux_operands(stat, t)
            else:
                ops = cuda_tick.staged_operands(cfg, base, tkeys, bkeys, t, s,
                                                Tl, _resets_bound, scen=scen)
            kobs = (cuda_tick.kernel_observers(mon)
                    if observed and mutator is None else None)
            ov, snaps = cuda_tick.fused_tick_kernel(
                cfg, s, Tl, flags, aux_source, ops, snap_fields,
                layout=layout, compute=compute, obs=kobs)
            ov_total = ov_total + ov.sum()
            if mutator is not None:
                mutator(state, t)
                observe([view()])
                return
            if kobs is not None:
                tel, mon = telemetry_mod.fold_obs_rows(kobs.rows, tel, mon)
                prev = None
            record(cuda_tick.unpack_fused_outputs(snaps, Tl))

        def one_tick():
            # The staged T=1 program: make_aux (on the pre-tick role / up
            # too, for a leader-isolation bank), the one-tick kernel, the §7
            # draws on the host.
            before_replay()
            shim = tick_mod.packed_shim(cfg, s, t) if packed else \
                types.SimpleNamespace(
                    tick=t, term=s["term"], role=s["role"], up=s["up"],
                    t_ctr=s["t_ctr"], b_ctr=s["b_ctr"])
            aux, fl = tick_mod.make_aux(cfg, base, tkeys, bkeys, shim,
                                        scen=scen)
            el_dirty = cuda_tick.tick_kernel(cfg, s, aux, fl, layout=layout,
                                             compute=compute)
            tick_mod.materialize_el(cfg, tkeys, s, el_dirty)
            observe([view()] if watched else [])

        def launched():
            nonlocal latch
            if latch is not None:
                latch = latch | pack_state(cfg, state).ov

        for _ in range(n_launch):
            k_launch() if k_tick else fused(T)
            t += T
            launched()
        for _ in range(rem):
            if inkernel:
                fused(1)
            else:
                one_tick()
            t += 1
            launched()
        # The one host read of the call: the draw overflow and the width
        # latch together, before the caller's state is written.
        draw_ov = width_ov = 0
        if packed or latch is not None:
            draw_ov, width_ov = torch.stack([
                ov_total, (ps.ov if packed else latch).ne(0).sum().to(
                    ov_total.dtype)]).tolist()
        elif n_launch or inkernel:
            draw_ov = int(ov_total)
        if packed and width_ov:
            # The kernels' early latch: rerun wide under JAX's rule.
            return scan_core(
                cfg, n_ticks, telemetry=telemetry, monitor=monitor,
                trace=trace, fused_ticks=fused_ticks, aux_source=aux_source,
                _resets_bound=_resets_bound, per_group=per_group,
                k_per_launch=k_per_launch, device=dev,
                _width_latch=True)(state)
        check_packed_ov(width_ov)
        state.tick = t
        if packed:
            for k, v in tick_mod.flatten_state(
                    cfg, unpack_state(cfg, ps)).items():
                wide[k].copy_(v)
        if draw_ov:
            raise RuntimeError(
                f"{'K' if k_tick else 'fused'}-tick kernel draw-table "
                f"overflow: a node consumed more "
                f"election-timer resets within one {T}-tick launch than the "
                f"draw tables cover (resets_per_tick_bound) — the launch's "
                f"draws were clamped, so the state is INVALID")
        tr = ({f: torch.cat([x[f] for x in traces])
               for f in cuda_tick.FUSED_TRACE_FIELDS} if trace else None)
        return state, tr, tel, mon

    return run
