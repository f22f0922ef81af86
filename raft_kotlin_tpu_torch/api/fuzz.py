"""The deterministic simulation-fuzzing farm, batch mode — the port of the
JAX package's `api/fuzz.py` (its batch farm, shrink, artifact, replay and
corpus).

Every group of a farm batch is a distinct, reproducible universe: its fault
thresholds, delay window and scripted partition program come from the §12
scenario bank (`utils/rng.sample_scenario_bank`, keyed by (farm_seed,
universe_id)), which `ops/tick.make_rng` samples from `RaftConfig.scenario`.
On the card a batch is one monitored, recorded run of the fused tick kernel
with its draws made in the kernel, the bank's rows among them, T ticks a
launch (`ops/cuda_scan.scan_core`); the safety monitor keeps per-universe
counters in its carry, read back once.

The farm loop (`fuzz_farm`):
1. run monitored, recorded batches over the sampled universes;
2. on a latch, shrink the violation (`shrink_violation`): halve the tick
   horizon while the latch persists, then zero the scenario's fault
   channels one at a time, keeping only those the violation needs;
3. write the minimal replayable artifact to a JSONL corpus whose bytes are
   a pure function of the farm's inputs (`corpus_hash`) — the same bytes
   the JAX package's farm writes for the same inputs;
4. confirm it by replay (`replay_artifact`): the shrunk config rerun from
   scratch must latch at the exact coordinate.

The farm's own acceptance machinery is exercised by seeded mutation
(`committed_rewrite_mutator`, `twin_leader_mutator`): a broken transition
injected at an exact (tick, group), which must latch, shrink to no fault
channel and replay there.

The §15 standing soak (`soak_run`) runs a compaction config for any number
of ticks in checkpoint-rotated segments (utils/checkpoint), carrying the
monitor's taints across them; `laggard_config` and
`partition_snapshot_config` are its universe families, where followers
come back below the leaders' snapshot bases and catch up by
InstallSnapshot.

Not ported: the §19 continuous scheduler (`make_continuous_runner`,
`continuous_farm`), the multi-device `mesh` argument (ROADMAP item 6), and
the triage replay of pure violations (`api/triage`; `fuzz_farm` raises
NotImplementedError unless `triage_confirm=False`).

Entry points run on the card unless `device="cpu"`, where every launch
runs its kernel's plain version.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from typing import Callable, Optional

import numpy as np

from raft_kotlin_tpu_torch.constants import LEADER
from raft_kotlin_tpu_torch.models.state import (
    RaftState, init_state, require_device)
from raft_kotlin_tpu_torch.ops.cuda_scan import scan_core
from raft_kotlin_tpu_torch.utils import rng as rngmod
from raft_kotlin_tpu_torch.utils import telemetry as telemetry_mod
from raft_kotlin_tpu_torch.utils.config import (
    RaftConfig, ScenarioSpec, config_from_dict)

CORPUS_SCHEMA = "raft-fuzz-v1"


def make_batch_runner(cfg: RaftConfig, n_ticks: int,
                      mutator: Optional[Callable] = None, device="cuda"):
    """run(state0=None) -> (end_state, recorder, RAW per-group monitor
    carry) for one monitored, recorded batch — the farm's engine. The
    monitor comes back un-finalized, so its (G,) taint masks and
    PER_GROUP_KEYS counters are readable (telemetry.universe_stats).

    On the card it drives the fused tick kernel with in-kernel draws,
    CUDA_FUSED_TICKS ticks a launch (one on the CPU). `mutator(state, t)`
    is the seeded-mutation hook: it updates the post-tick state of tick t
    in place, before the monitor step, as the JAX package's scan applies
    it; the run then launches the fused kernel one tick at a time, still
    drawing in the kernel, so that the mutation lands between ticks — the
    mutation's semantics, not a fallback. `taints`, a (restart, unsafe)
    pair of (G,) bool masks, seeds the monitor's sticky taints (soak_run
    carries them across segments)."""
    dev = require_device(device)
    core = scan_core(cfg, n_ticks, telemetry=True, monitor=True,
                     per_group=True, aux_source="inkernel", mutator=mutator,
                     device=dev)

    def call(state0: Optional[RaftState] = None, taints=None):
        st = state0 if state0 is not None else init_state(cfg, dev)
        end, _, tel, mon = core(st, taints)
        return end, tel, mon

    return call


def run_fuzz_batch(cfg: RaftConfig, n_ticks: int,
                   mutator: Optional[Callable] = None,
                   device="cuda") -> dict:
    """One monitored farm batch -> a host-side result dict:
    - "summary": telemetry.summarize_monitor (inv_status, latch, ring...),
    - "latch": the first-violation coordinate or None,
    - "telemetry": flight-recorder counters,
    - "universe": per-group numpy arrays (grp_elections / grp_fault_events /
      grp_violations and the taint masks),
    - "coverage": universes with any fault event / election / taint /
      violation — the evidence that the bank bit."""
    end, tel, mon = make_batch_runner(cfg, n_ticks, mutator=mutator,
                                      device=device)()
    summary = telemetry_mod.summarize_monitor(mon)
    uni = telemetry_mod.universe_stats(mon)
    cov = {
        "fault_universes": int(np.sum(uni["grp_fault_events"] > 0)),
        "election_universes": int(np.sum(uni["grp_elections"] > 0)),
        "taint_restart_universes": int(np.sum(uni["taint_restart"])),
        "taint_unsafe_universes": int(np.sum(uni["taint_unsafe"])),
        "violation_universes": int(np.sum(uni["grp_violations"] > 0)),
    }
    return {
        "summary": summary,
        "latch": summary["latch"],
        "telemetry": telemetry_mod.summarize_telemetry(tel),
        "universe": uni,
        "coverage": cov,
    }


# -- auto-shrinking ----------------------------------------------------------

def scenario_channels(cfg: RaftConfig) -> list:
    """The fault channels a shrink pass can zero, in deterministic order:
    [(name, zeroed config)] — spec channels first, then any scalar
    baselines the config carries."""
    out = []
    spec = cfg.scenario

    def with_spec(**kw):
        return dataclasses.replace(
            cfg, scenario=dataclasses.replace(spec, **kw))

    if spec is not None and not spec.degenerate:
        for ch in ("drop", "crash", "restart", "link_fail", "link_heal"):
            if getattr(spec, f"{ch}_max") > 0:
                out.append((f"scenario.{ch}", with_spec(**{f"{ch}_max": 0.0})))
        if spec.partitions:
            out.append(("scenario.partitions", with_spec(partitions=())))
        if spec.delay_windows:
            out.append(("scenario.delay_windows",
                        with_spec(delay_windows=False)))
    for ch in ("p_drop", "p_crash", "p_restart", "p_link_fail",
               "p_link_heal"):
        if getattr(cfg, ch) > 0:
            out.append((ch, dataclasses.replace(cfg, **{ch: 0.0})))
    return out


def shrink_violation(cfg: RaftConfig, n_ticks: int, latch: dict,
                     mutator_factory: Optional[Callable] = None,
                     device="cuda") -> dict:
    """Shrink a latched violation to its minimal reproducer: (1) halve the
    tick horizon while the latch persists (down to latch tick + 1), then
    (2) zero fault channels one at a time, keeping a channel zeroed
    whenever the latch persists without it (the latch may move: the shrunk
    coordinate is the shrunk config's own first violation).

    `mutator_factory(cfg) -> mutator` rebuilds the seeded mutation for each
    candidate config (None for pure violations). Returns {"config",
    "horizon", "latch", "steps"}; `steps` is the audit trail [(kind,
    detail, kept)]."""
    steps = []

    def latch_of(c, h):
        mut = mutator_factory(c) if mutator_factory is not None else None
        return run_fuzz_batch(c, h, mutator=mut, device=device)["latch"]

    horizon = n_ticks
    # Phase 1: horizon halving (floor: the latch tick + 1).
    while horizon > latch["tick"] + 1:
        cand = max(latch["tick"] + 1, horizon // 2)
        if cand == horizon:
            break
        got = latch_of(cfg, cand)
        if got is not None:
            horizon, latch = cand, got
            steps.append(["horizon", cand, True])
        else:
            steps.append(["horizon", cand, False])
            break
    # Phase 2: channel zeroing, one at a time, re-enumerated after each
    # kept shrink.
    changed = True
    while changed:
        changed = False
        for name, cand_cfg in scenario_channels(cfg):
            got = latch_of(cand_cfg, horizon)
            if got is not None:
                cfg, latch = cand_cfg, got
                steps.append(["channel", name, True])
                changed = True
                break
            steps.append(["channel", name, False])
        # A kept shrink may have moved the latch earlier: re-tighten.
        while horizon > latch["tick"] + 1:
            cand = max(latch["tick"] + 1, horizon // 2)
            if cand == horizon:
                break
            got = latch_of(cfg, cand)
            if got is None:
                break
            horizon, latch = cand, got
    return {"config": cfg, "horizon": horizon, "latch": latch,
            "steps": steps}


# -- corpus ------------------------------------------------------------------

def universe_params(cfg: RaftConfig, group: int) -> dict:
    """The host-readable bank row of one universe (the artifact's
    `universe` field): {channel: int} for every sampled channel. Sampled
    for that universe alone — a bank row depends on its universe id, never
    on the batch."""
    spec = cfg.scenario
    if spec is None:
        return {}
    one = dataclasses.replace(cfg, n_groups=1, scenario=dataclasses.replace(
        spec, universe_base=spec.universe_base + group))
    bank = rngmod.sample_scenario_bank(one, device="cpu")
    return {k: int(v[0]) for k, v in bank.items()}


def violation_artifact(shrunk: dict, orig_cfg: RaftConfig,
                       mutated: bool = False) -> dict:
    """The minimal replayable corpus record of one shrunk violation."""
    cfg, latch = shrunk["config"], shrunk["latch"]
    spec = cfg.scenario
    g = latch["group"]
    return {
        "schema": CORPUS_SCHEMA,
        "farm_seed": spec.farm_seed if spec is not None else None,
        "universe_id": (spec.universe_base + g) if spec is not None else g,
        # The universe as sampled (the original batch config's bank row):
        # the shrunk config may have zeroed channels away.
        "universe": universe_params(orig_cfg, g),
        "config": dataclasses.asdict(cfg),
        "horizon": shrunk["horizon"],
        "tick": latch["tick"],
        "group": g,
        "invariant": latch["invariant"],
        "invariant_id": latch["invariant_id"],
        "status": f"{latch['invariant']}@t{latch['tick']}/g{g}",
        "shrink": shrunk["steps"],
        "mutated": bool(mutated),
        "orig_config": dataclasses.asdict(orig_cfg),
    }


def replay_artifact(artifact: dict,
                    mutator_factory: Optional[Callable] = None,
                    device="cuda") -> bool:
    """Re-confirm a corpus record from scratch: rebuild the config, run
    `horizon` monitored ticks, and require the latch at exactly the
    recorded (tick, group, invariant)."""
    cfg = config_from_dict(artifact["config"])
    mut = mutator_factory(cfg) if mutator_factory is not None else None
    latch = run_fuzz_batch(cfg, artifact["horizon"], mutator=mut,
                           device=device)["latch"]
    return (latch is not None
            and latch["tick"] == artifact["tick"]
            and latch["group"] == artifact["group"]
            and latch["invariant_id"] == artifact["invariant_id"])


def corpus_lines(records) -> list:
    """The corpus's canonical JSONL lines (sort_keys, no whitespace
    variance): byte-determinism is what corpus_hash pins."""
    return [json.dumps(r, sort_keys=True, separators=(",", ":"))
            for r in records]


def corpus_hash(records, farm_seed, universes: int, n_ticks: int) -> str:
    """A short content hash over the canonical corpus and the farm's shape:
    equal inputs give equal corpus bytes and an equal hash."""
    payload = json.dumps(
        {"schema": CORPUS_SCHEMA, "farm_seed": farm_seed,
         "universes": universes, "ticks": n_ticks,
         "records": corpus_lines(records)},
        sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


# -- the farm ----------------------------------------------------------------

def fuzz_farm(cfg: RaftConfig, n_ticks: int, universes: Optional[int] = None,
              batch_groups: Optional[int] = None,
              out_path: Optional[str] = None,
              mutator_factory: Optional[Callable] = None,
              triage_confirm: bool = True, verbose: bool = False,
              device="cuda") -> dict:
    """Run the farm over `universes` universes (default: one batch of
    cfg.n_groups) in batches of `batch_groups`, shrinking each latched
    violation to a minimal artifact, replay-confirming it, and writing the
    JSONL corpus to `out_path`. Returns {"schema", "farm_seed",
    "universes", "ticks_per_universe", "universe_ticks", "inv_status",
    "violations", "coverage", "telemetry", "corpus_hash", "records"}.

    Each batch latches at most its lexicographically first violation (the
    monitor's latch is one coordinate), so the farm harvests one artifact
    per violating batch.

    The JAX package's farm also confirms a pure violation through its
    triage replay (api/triage), which the port does not carry: pass
    triage_confirm=False (the corpus bytes are those of the JAX package's
    fuzz_farm(..., triage_confirm=False))."""
    if triage_confirm:
        raise NotImplementedError(
            "api/triage is not ported: run the farm with "
            "triage_confirm=False")
    spec = cfg.scenario
    if spec is None:
        raise ValueError("fuzz_farm needs cfg.scenario (the bank spec)")
    universes = universes if universes is not None else cfg.n_groups
    batch_groups = batch_groups if batch_groups is not None else cfg.n_groups
    records = []
    status = "clean"
    tel_total: dict = {}
    cov_total = {"fault_universes": 0, "election_universes": 0,
                 "taint_restart_universes": 0, "taint_unsafe_universes": 0,
                 "violation_universes": 0}
    done = 0
    while done < universes:
        gb = min(batch_groups, universes - done)
        cfg_b = dataclasses.replace(
            cfg, n_groups=gb,
            scenario=dataclasses.replace(
                spec, universe_base=spec.universe_base + done))
        mut = mutator_factory(cfg_b) if mutator_factory is not None else None
        res = run_fuzz_batch(cfg_b, n_ticks, mutator=mut, device=device)
        for k, v in res["telemetry"].items():
            tel_total[k] = tel_total.get(k, 0) + v
        for k in cov_total:
            cov_total[k] += res["coverage"][k]
        if res["latch"] is not None:
            if verbose:
                print(f"LATCH: {res['summary']['inv_status']} in batch at "
                      f"universe_base={spec.universe_base + done}")
            shrunk = shrink_violation(cfg_b, n_ticks, res["latch"],
                                      mutator_factory=mutator_factory,
                                      device=device)
            art = violation_artifact(shrunk, cfg_b,
                                     mutated=mutator_factory is not None)
            art["replay_confirmed"] = replay_artifact(
                art, mutator_factory=mutator_factory, device=device)
            records.append(art)
            if status == "clean":
                status = art["status"]
        done += gb
    result = {
        "schema": CORPUS_SCHEMA,
        "farm_seed": spec.farm_seed,
        "universes": universes,
        "ticks_per_universe": n_ticks,
        "universe_ticks": universes * n_ticks,
        "inv_status": status,
        "violations": len(records),
        "coverage": cov_total,
        "telemetry": tel_total,
        "corpus_hash": corpus_hash(records, spec.farm_seed, universes,
                                   n_ticks),
        "records": records,
    }
    if out_path is not None:
        with open(out_path, "w") as f:
            for line in corpus_lines(records):
                f.write(line + "\n")
    return result


def smoke_spec(farm_seed: int = 12) -> ScenarioSpec:
    """The smoke-universe spec: mixed fault thresholds and all three
    partition program kinds — the family bench.py's fuzz leg gates on."""
    return ScenarioSpec(
        farm_seed=farm_seed, drop_max=0.25, crash_max=0.02, restart_max=0.2,
        partitions=("split", "asym", "leader"),
        part_period_lo=5, part_period_hi=40)


def smoke_config(groups: int, farm_seed: int = 12,
                 seed: int = 9) -> RaftConfig:
    """The smoke-batch config over smoke_spec: 3-node universes, 32-entry
    logs, a command every 5 ticks, pacing compressed 10x."""
    return RaftConfig(n_groups=groups, n_nodes=3, log_capacity=32,
                      cmd_period=5, seed=seed,
                      scenario=smoke_spec(farm_seed)).stressed(10)


def laggard_spec(farm_seed: int = 21) -> ScenarioSpec:
    """§15 laggard-catch-up universes: crash / restart-heavy fault
    thresholds, so leaders routinely snapshot past a crashed follower's
    frontier and its rejoin travels by InstallSnapshot. Run with a
    compaction config (laggard_config)."""
    return ScenarioSpec(
        farm_seed=farm_seed, drop_max=0.1, crash_max=0.05, restart_max=0.3)


def laggard_config(groups: int, farm_seed: int = 21,
                   seed: int = 9) -> RaftConfig:
    """The §15 laggard-catch-up batch: 32-entry logs with an aggressive
    watermark (W=4, CH=4), so committed progress folds quickly and crashed
    followers come back below the leaders' snapshot bases."""
    return RaftConfig(n_groups=groups, n_nodes=3, log_capacity=32,
                      cmd_period=5, seed=seed,
                      compact_watermark=4, compact_chunk=4,
                      scenario=laggard_spec(farm_seed)).stressed(10)


def partition_snapshot_spec(farm_seed: int = 22) -> ScenarioSpec:
    """§15 snapshot-during-partition universes: split / asym / leader
    partition programs over a compacting cluster — the isolated side's
    frontier freezes while the majority folds, so heals take the install
    path under every partition geometry."""
    return ScenarioSpec(
        farm_seed=farm_seed, drop_max=0.15, crash_max=0.01,
        restart_max=0.15, partitions=("split", "asym", "leader"),
        part_period_lo=5, part_period_hi=40)


def partition_snapshot_config(groups: int, farm_seed: int = 22,
                              seed: int = 9) -> RaftConfig:
    """The §15 snapshot-during-partition batch (partition_snapshot_spec)."""
    return RaftConfig(n_groups=groups, n_nodes=3, log_capacity=32,
                      cmd_period=5, seed=seed,
                      compact_watermark=4, compact_chunk=4,
                      scenario=partition_snapshot_spec(farm_seed)
                      ).stressed(10)


def soak_run(cfg: RaftConfig, n_ticks: int, segment: Optional[int] = None,
             ckpt_dir: Optional[str] = None, verbose: bool = False,
             mesh=None, device="cuda") -> dict:
    """§15 standing soak: `n_ticks` monitored ticks in checkpoint-rotated
    segments of `segment` ticks (default 2 x log_capacity). Each segment
    runs a monitored batch (make_batch_runner) from the carried state and
    taints, saves a checkpoint, loads it back and continues from the
    loaded state, so the end state has been through the rotation path.

    Returns {"ticks", "segments", "inv_status" (the first non-clean
    segment verdict, else "clean"), "statuses", "snap_index_min/max",
    "window_hw" (max(phys_len - snap_index) of the end state: healthy
    while it stays within the window), "cap_exhausted_groups",
    "log_bytes", "telemetry" (the segments' counters summed)} — the JAX
    package's soak_run summary. The multi-device `mesh` is not ported."""
    from raft_kotlin_tpu_torch.utils import checkpoint as ckpt_mod

    if mesh is not None:
        raise NotImplementedError(
            "soak_run over a mesh is not ported (ROADMAP item 6)")
    if not cfg.uses_compaction:
        raise ValueError("soak_run needs a §15 compaction config "
                         "(compact_watermark > 0): without truncation the "
                         "run dies at log_capacity")
    dev = require_device(device)
    segment = segment or max(1, min(n_ticks, 2 * cfg.log_capacity))
    tmp = None
    if ckpt_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="raft_soak_")
        ckpt_dir = tmp.name
    path = os.path.join(ckpt_dir, "soak.npz")
    state = init_state(cfg, dev)
    runners: dict = {}
    taints = None
    statuses, tel_total = [], {}
    done = seg_i = 0
    status = "clean"
    try:
        while done < n_ticks:
            t_seg = min(segment, n_ticks - done)
            if t_seg not in runners:
                runners[t_seg] = make_batch_runner(cfg, t_seg, device=dev)
            state, tel, mon = runners[t_seg](state, taints=taints)
            taints = (mon["taint_restart"], mon["taint_unsafe"])
            summ = telemetry_mod.summarize_monitor(mon)
            statuses.append(summ["inv_status"])
            if summ["inv_status"] != "clean" and status == "clean":
                status = summ["inv_status"]
            for k, v in telemetry_mod.summarize_telemetry(tel).items():
                tel_total[k] = tel_total.get(k, 0) + v
            # Checkpoint rotation: publish, reload, go on from the load.
            ckpt_mod.save(path, state, cfg,
                          extra={"soak_segment": seg_i, "ticks": done + t_seg})
            state, _ = ckpt_mod.load(path, expect_cfg=cfg, device=dev)
            done += t_seg
            seg_i += 1
            if verbose:
                si = state.snap_index
                print(f"soak segment {seg_i}: ticks {done}/{n_ticks} "
                      f"inv={summ['inv_status']} snap_index "
                      f"[{int(si.min())}, {int(si.max())}]")
    finally:
        if tmp is not None:
            tmp.cleanup()
    si = state.snap_index.cpu().numpy().astype(np.int64)
    window = state.phys_len.cpu().numpy().astype(np.int64) - si
    return {
        "ticks": done,
        "segments": seg_i,
        "inv_status": status,
        "statuses": statuses,
        "snap_index_min": int(si.min()),
        "snap_index_max": int(si.max()),
        "window_hw": int(window.max()),
        "cap_exhausted_groups": int(
            (state.cap_ov != 0).any(0).sum()),
        "log_bytes": int(state.log_term.nbytes * 2),
        "telemetry": tel_total,
    }


# -- seeded mutations (the farm's own acceptance harness) --------------------

def committed_rewrite_mutator(cfg: RaftConfig, tick: int, group: int,
                              delta: int = 7777):
    """A deliberately broken transition: at tick `tick`, rewrite the stored
    content of node 1's log slot 0 in `group` (in place, wrapping in the
    log's dtype) — where slot 0 is committed and the logs are pristine, a
    committed rewrite, latched at exactly (tick, group)."""
    def mutate(state: RaftState, t: int) -> RaftState:
        if t == tick:
            state.log_cmd[0, 0, group] += delta
        return state

    return mutate


def twin_leader_mutator(cfg: RaftConfig, tick: int, group: int):
    """A deliberately broken transition: at tick `tick`, force nodes 1 and
    2 of `group` into LEADER at node 1's term (in place) — two live
    same-term leaders, an election-safety violation."""
    def mutate(state: RaftState, t: int) -> RaftState:
        if t == tick:
            state.role[:2, group] = LEADER
            state.term[:2, group] = state.term[0, group].clone()
            state.up[:2, group] = True
        return state

    return mutate
