"""The frontier-value cache and its deep-log runner — the counterpart of the
JAX package's `ops/deep_cache.py` (`make_deep_scan` at :185, its single-
device runner).

The batched deep engine reads ~4N+1 log rows a node a tick through the deep
gather. The protocol only ever reads rows at a pair's frontier
`next_index(l, p)`, which moves by at most one an exchange (with two jumps:
the quirk-b jump to commit + 1 on an election win, and the restart wipe).
The cache keeps the VALUES at the frontier as state beside the Raft state,
maintained by (G,)-wide updates inside the lattice (ops/tick.phase_body's
`fcache` hooks):

- per pair (l, p), four values, each with a validity bit: f_pli =
  l.log_term[ni - 2] (the next request's prevLogTerm), f_ent_t / f_ent_c =
  l's entry at ni - 1, f_ppli = p.log_term[ni - 2] (the peer's prevLog
  check);
- per node, f_topw = log_term[last_index + j], j < W_TOP: the rows a §3
  ghost append exposes to the lastLogTerm cache. A window, because a
  catching-up node consumes a row an append while a tick's refill tops it
  up once.

A value the tick needs and the cache does not hold comes from one budgeted
take per log array a tick (TERM_BUDGET / CMD_BUDGET rows a lane). Hard
demand past the budget, or a consumed invalid entry, raises the tick's
per-lane OV flag, and `make_deep_scan` then reruns the whole call from its
entry state on the batched engine: the bits never depend on the budget or
on the cache's validity reasoning, only the time does.

On the card the cached tick never launches the deep gather (#6); its
deferred writes still go through the deep scatter (#5), once a tick. The
cache's own takes (`refill_all`, the per-tick refill) are plain
`torch.gather`, as they are `jnp.take_along_axis` in the JAX package.

Not ported: the known-delivery mailbox's second-entry window (PAIR_VALS_MB
is kept as the name it will carry; `mailbox=True` raises), serving, and
`make_sharded_deep_scan`.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from raft_kotlin_tpu_torch.models.state import (
    RaftState, check_packed_ov, check_supported, pack_state, require_device)
from raft_kotlin_tpu_torch.ops import deep_scatter
from raft_kotlin_tpu_torch.ops import tick as tick_mod
from raft_kotlin_tpu_torch.utils import telemetry as telemetry_mod
from raft_kotlin_tpu_torch.utils.config import RaftConfig

_I32 = torch.int32

# Pair-shaped value fields and the node-shaped top window, in order.
PAIR_VALS = ("f_pli", "f_ent_t", "f_ent_c", "f_ppli")
# The known-delivery mailbox's second-entry window (row ni of the owner's
# log), which the deep mailbox engine will carry (ROADMAP queue 1 item 3).
PAIR_VALS_MB = ("f_ent2_t", "f_ent2_c")
NODE_VALS = ("f_topw",)
ALL_VALS = PAIR_VALS + NODE_VALS

# Rows of the window above last_index (f_topw[n * W_TOP + j] =
# log_term[last_index + j] of node n + 1).
W_TOP = 4

# Refill rows a lane a tick (term take, cmd take): a whole-group election
# win (3 hard entries x N pairs) plus the top-window top-ups fit; more is
# an OV rerun, not an error. Module attributes, so a test can lower them.
TERM_BUDGET = 40
CMD_BUDGET = 12


def ok_name(k: str) -> str:
    return "ok_" + k[2:]


FIELDS = ALL_VALS + tuple(ok_name(k) for k in ALL_VALS)


def pair_vals_for(mailbox: bool) -> tuple:
    """The pair-shaped value fields of a config class. The mailbox's
    second-entry window is not ported."""
    if mailbox:
        raise NotImplementedError(
            "the frontier cache of the deep mailbox engine (PAIR_VALS_MB, "
            "the known-delivery second-entry window) is not ported: ROADMAP "
            "queue 1 item 3")
    return PAIR_VALS


def fields_for(mailbox: bool) -> tuple:
    """The cache dict's fields (values, then validity) of a config class."""
    vals = pair_vals_for(mailbox) + NODE_VALS
    return vals + tuple(ok_name(k) for k in vals)


def init_fields(N: int, G: int, mailbox: bool = False,
                device="cuda") -> dict:
    """An all-invalid cache (a cold start; the runner fills it with
    refill_all)."""
    dev = torch.device(device)
    fc = {}
    for k in pair_vals_for(mailbox):
        fc[k] = torch.zeros((N * N, G), dtype=_I32, device=dev)
        fc[ok_name(k)] = torch.zeros((N * N, G), dtype=torch.bool,
                                     device=dev)
    fc["f_topw"] = torch.zeros((N * W_TOP, G), dtype=_I32, device=dev)
    fc["ok_topw"] = torch.zeros((N * W_TOP, G), dtype=torch.bool, device=dev)
    return fc


def refill_all(cfg: RaftConfig, state) -> dict:
    """Every cache entry from `state`, valid: one flat torch.gather per log
    array over the (N*C, G) views. A row outside [0, C) reads 0."""
    N, C = cfg.n_nodes, cfg.phys_capacity
    pair_vals_for(cfg.uses_mailbox)
    G = state.term.shape[-1]
    dev = state.term.device
    ni = state.next_index.reshape(N * N, G).to(_I32)
    li = state.last_index.to(_I32)
    nodes = torch.arange(N, dtype=_I32, device=dev)
    owner = nodes.repeat_interleave(N)[:, None]  # pair row a * N + b
    peer = nodes.repeat(N)[:, None]
    top = li.repeat_interleave(W_TOP, 0) + torch.arange(
        W_TOP, dtype=_I32, device=dev).repeat(N)[:, None]
    # (field, node of each row, logical rows), in take order.
    segs_t = (("f_pli", owner, ni - 2), ("f_ent_t", owner, ni - 1),
              ("f_ppli", peer, ni - 2),
              ("f_topw", nodes.repeat_interleave(W_TOP)[:, None], top))
    segs_c = (("f_ent_c", owner, ni - 1),)
    fc = {}
    for log, segs in ((state.log_term, segs_t), (state.log_cmd, segs_c)):
        rows = torch.cat([node * C + r.clamp(0, C - 1)
                          for _, node, r in segs])
        vals = torch.gather(log.reshape(N * C, G), 0, rows.long()).to(_I32)
        for (key, _, r), v in zip(segs, vals.split([r.shape[0]
                                                    for _, _, r in segs])):
            fc[key] = torch.where((r >= 0) & (r < C), v, 0)
            fc[ok_name(key)] = torch.ones(r.shape, dtype=torch.bool,
                                          device=dev)
    return fc


def make_deep_scan(cfg: RaftConfig, n_ticks: int, return_state: bool = False,
                   telemetry: bool = False, monitor: bool = False,
                   trace: bool = False, layout: str = "wide",
                   serving: bool = False, device="cuda"):
    """The frontier-cached deep runner (JAX `make_deep_scan`): n_ticks of
    the cached tick — make_aux, phase_body(fcache=) with the deep scatter,
    the §7 deferred draws — updating the state in place, the cache filled
    once at entry (refill_all). Each tick's OV flag is reduced on the
    device and read on the host once, after the call; on OV the call is
    rerun from its entry state on the batched engine (the deep gather and
    scatter, make_run's tick) with the same rng, and the rerun's bits,
    trace and monitor verdict are the ones returned. Every mode runs
    `run(state, rng=None, ..., rebuild=None)` (rng: tick.make_rng's, made
    from cfg when None):

    - default: run(state, rng, summarize=None) returns the reduction dict
      (_reduction): "rounds" (sum of rounds), "livepin" (the running sum of
      log_cmd[:, 0, :], int32), "ov" (0/1), the recorder as tel_* under
      telemetry=True, the monitor's inv_* scalars under monitor=True, and
      what summarize(end) adds;
    - return_state=True: (end, ov[, recorder][, finalized monitor]) — end
      is `state`, updated in place. (The JAX package's form drops the
      recorder; the port returns it where telemetry=True.);
    - trace=True: (ys, ov), ys the TRACE_FIELDS after each tick stacked
      (T, N, G).

    On OV the recorder's ov_fallbacks is the cached attempt's count of
    overflowing ticks (the rerun's recorder sees none), as in JAX.

    The rerun needs the entry state, which the port updates in place. By
    default the runner keeps a clone of it on the device: another copy of
    the state's bytes (28.7 GB at BASELINE config 5). A caller that can
    rebuild the entry passes `rebuild(state)`, which writes the entry
    state into `state` in place (for a boot entry: models/state.init_state
    (cfg, device, out=state)); then nothing is kept.

    layout="packed" carries the §14 packed layout between ticks (unpacked
    at each tick's read, repacked at its write, the width latch chained)
    and checks the latch once per call (RuntimeError "width overflow");
    the cache stays wide, and run takes and returns the wide state.

    Refused: §15 compaction (ValueError, JAX's), a config the batched
    engine does not run (ValueError), serving (NotImplementedError).
    Device: the card unless device="cpu"; on the CPU the scatter (and the
    rerun's gather) are their plain versions."""
    if cfg.uses_compaction:
        raise ValueError(
            "the frontier-cache engine does not support §15 compaction "
            "(the cache predates the ring map) — plan_for routes "
            "compaction configs to the batched/flat engines")
    if layout not in tick_mod.LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    if serving:
        raise NotImplementedError(
            "serving=True (§20) is not ported: ROADMAP queue 1 item 5")
    if n_ticks < 1:
        raise ValueError(f"n_ticks must be >= 1, got {n_ticks}")
    check_supported(cfg)
    flags = tick_mod.make_flags(cfg)
    tick_mod.check_flags(flags)
    if not flags.batched:
        raise ValueError("make_deep_scan needs a batched-engine config "
                         "(a deep log: phys_capacity >= 256)")
    dev = require_device(device)
    packed = layout == "packed"

    def scan(state: RaftState, rng, with_fc: bool):
        """n_ticks on `state` in place: the cached tick, or the batched
        engine. Returns (livepin, any OV, recorder, monitor, trace rows,
        packed latch)."""
        base, tkeys, bkeys, scen = tick_mod.split_rng(rng)
        fc = refill_all(cfg, state) if with_fc else None
        tel = telemetry_mod.telemetry_zeros(dev) if telemetry else None
        mon = telemetry_mod.monitor_init(cfg.n_groups, n_ticks, monitor,
                                         **telemetry_mod.ops_kw(cfg),
                                         device=dev)
        acc = torch.zeros((), dtype=_I32, device=dev)
        ova = torch.zeros((), dtype=torch.bool, device=dev)
        ps = pack_state(cfg, state) if packed else None
        ys = []
        for _ in range(n_ticks):
            if packed:
                tick_mod.unpack_into(cfg, state, ps)
            prev = telemetry_mod.state_view(state, clone=True) \
                if telemetry else None
            mprev = telemetry_mod.monitor_view(state, clone=True) \
                if monitor else None
            aux, fl = tick_mod.make_aux(cfg, base, tkeys, bkeys, state,
                                        scen=scen)
            s = tick_mod.flatten_state(cfg, state)
            ov_t = None
            if with_fc:
                el_dirty = tick_mod.phase_body(
                    cfg, s, aux, fl, scatter=deep_scatter.scatter, fcache=fc)
                ov_t = fc.pop("ov").any()
                ova = ova | ov_t
            else:
                el_dirty = tick_mod.deep_kernel_body(cfg, s, aux, fl)
            tick_mod.finish_tick(cfg, tkeys, state, s, el_dirty)
            if telemetry:
                tel = telemetry_mod.telemetry_step_arrays(
                    prev, telemetry_mod.state_view(state), tel, ov=ov_t)
            if monitor:
                mon = telemetry_mod.monitor_step_arrays(
                    mprev, telemetry_mod.monitor_view(state), mon)
            acc = acc + state.log_cmd[:, 0, :].sum(dtype=_I32)
            if trace:
                ys.append({k: getattr(state, k).clone()
                           for k in tick_mod.TRACE_FIELDS})
            if packed:
                ps = pack_state(cfg, state, ov=ps.ov)
        return acc, ova, tel, mon, ys, (ps.ov if packed else None)

    def attempt(state: RaftState, rng, rebuild: Optional[Callable]):
        """The cached call and, on OV, the rerun: (published scan, ov,
        the cached attempt's ov_fallbacks or None)."""
        if state.term.device.type != dev.type:
            raise ValueError(f"the state is on {state.term.device}, the "
                             f"runner on {dev}")
        if state.term.shape[-1] != cfg.n_groups:
            raise ValueError(f"state has {state.term.shape[-1]} groups but "
                             f"the runner was built for {cfg.n_groups}")
        if rng is None:
            rng = tick_mod.make_rng(cfg, dev)
        tick0 = state.tick
        entry = state.clone() if rebuild is None else None
        out = scan(state, rng, True)
        ov = bool(out[1])
        fc_ov_ticks = None
        if ov:
            fc_ov_ticks = out[2]["ov_fallbacks"] if telemetry else None
            if rebuild is None:
                for k in state.fields():
                    getattr(state, k).copy_(getattr(entry, k))
                state.tick = entry.tick
            else:
                rebuild(state)
            del entry
            if state.tick != tick0:
                raise ValueError(f"rebuild left the state at tick "
                                 f"{state.tick}, not the entry's {tick0}")
            out = scan(state, rng, False)
            if telemetry:
                out[2]["ov_fallbacks"] = fc_ov_ticks
        if packed:
            check_packed_ov(out[5])
        return out, ov

    if trace:
        def run_trace(state: RaftState, rng=None, rebuild=None):
            (_, _, _, _, ys, _), ov = attempt(state, rng, rebuild)
            return ({k: torch.stack([y[k] for y in ys])
                     for k in tick_mod.TRACE_FIELDS}, ov)

        return run_trace

    if return_state:
        def run_state(state: RaftState, rng=None, rebuild=None):
            (_, _, tel, mon, _, _), ov = attempt(state, rng, rebuild)
            out = (state, ov)
            if telemetry:
                out += (tel,)
            if monitor:
                out += (telemetry_mod.monitor_finalize(mon),)
            return out

        return run_state

    def run(state: RaftState, rng=None, summarize=None, rebuild=None):
        (acc, _, tel, mon, _, latch), ov = attempt(state, rng, rebuild)
        vals = _reduction(state, acc,
                          torch.tensor(int(ov), dtype=_I32, device=dev),
                          summarize, tel=tel, mon=mon)
        if packed:
            vals["packed_ov"] = latch.ne(0).any().to(_I32)
        return vals

    run.self_timed = True
    return run


def _reduction(end: RaftState, acc, ov, summarize, tel=None, mon=None
               ) -> dict:
    """The JAX package's reduction contract: rounds / livepin / ov, the
    recorder's tel_* counters, the monitor's inv_* scalars, then what
    summarize(end) adds."""
    out = {"rounds": end.rounds.sum(dtype=_I32), "livepin": acc, "ov": ov}
    if tel is not None:
        out.update({f"tel_{k}": v for k, v in tel.items()})
    if mon is not None:
        out.update(telemetry_mod.monitor_scalars(mon))
    if summarize is not None:
        out.update(summarize(end))
    return out
