"""The port's fuzzing farm (raft_kotlin_tpu_torch/api/fuzz.py) and the
monitor's per-group channel against the JAX package, on the CPU.
Tolerance: zero — counters, latches and corpus bytes are compared exactly.

- the per-group monitor carry (PER_GROUP_KEYS, taint masks) step by step,
  and telemetry.universe_stats;
- run_fuzz_batch on api/fuzz.smoke_config(32): latch, coverage, recorder
  and per-universe arrays;
- a seeded mutation through fuzz_farm (tests/test_fuzz.py's committed
  rewrite): byte-equal corpus lines, file and hash against JAX's
  fuzz_farm(..., triage_confirm=False), the replay confirmed and a
  perturbed artifact refused; the twin-leader mutation's latch;
- corpus determinism, the CLI, and what stays refused.
"""

import dataclasses
import json
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_kotlin_tpu.api import fuzz as jfuzz
from raft_kotlin_tpu.models.state import RaftState as JState
from raft_kotlin_tpu.utils import telemetry as jtel
from raft_kotlin_tpu.utils.config import RaftConfig as JConfig
from raft_kotlin_tpu.utils.config import ScenarioSpec as JSpec
from raft_kotlin_tpu_torch.api import fuzz
from raft_kotlin_tpu_torch.models.state import (
    STATE_FIELDS, check_supported, init_state, state_to_numpy)
from raft_kotlin_tpu_torch.ops import tick as ttick
from raft_kotlin_tpu_torch.ops.cuda_scan import make_cuda_scan
from raft_kotlin_tpu_torch.utils import telemetry as ttel
from raft_kotlin_tpu_torch.utils.config import (
    RaftConfig, ScenarioSpec, config_from_dict)


def to_jax(st) -> JState:
    arrs = state_to_numpy(st)
    return JState(**{k: jnp.asarray(arrs[k]) for k in STATE_FIELDS},
                  tick=jnp.asarray(arrs["tick"], jnp.int32))


def test_per_group_monitor_and_universe_stats_equal_jax():
    cfg = fuzz.smoke_config(37)
    tick = ttick.make_tick(cfg, "cpu")
    st = init_state(cfg, "cpu")
    jm = jtel.monitor_init(37, 28, per_group=True)
    tm = ttel.monitor_init(37, 28, per_group=True, device="cpu")
    for _ in range(28):
        prev = st.clone()
        tick(st)
        jm = jtel.monitor_step(to_jax(prev), to_jax(st), jm)
        tm = ttel.monitor_step_arrays(ttel.monitor_view(prev),
                                      ttel.monitor_view(st), tm)
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]),
                                          err_msg=k)
    ju, tu = jtel.universe_stats(jm), ttel.universe_stats(tm)
    assert set(tu) == set(ju)
    for k in ju:
        np.testing.assert_array_equal(tu[k], ju[k], err_msg=k)
    assert tu["grp_elections"].sum() > 0 and tu["grp_fault_events"].sum() > 0
    # A per-group step needs `rounds` in its views.
    view = ttel.monitor_view(st)
    del view["rounds"]
    with pytest.raises(ValueError, match="rounds"):
        ttel.monitor_step_arrays(view, view, tm)


def test_run_fuzz_batch_equals_jax():
    want = jfuzz.run_fuzz_batch(jfuzz.smoke_config(32), 80)
    got = fuzz.run_fuzz_batch(fuzz.smoke_config(32), 80, device="cpu")
    assert got["latch"] == want["latch"]
    assert got["coverage"] == want["coverage"]
    assert got["telemetry"] == want["telemetry"]
    assert got["summary"] == want["summary"]
    for k in want["universe"]:
        np.testing.assert_array_equal(got["universe"][k],
                                      np.asarray(want["universe"][k]),
                                      err_msg=k)
    cov = got["coverage"]
    assert cov["fault_universes"] > 0 and cov["taint_restart_universes"] > 0
    assert len(np.unique(got["universe"]["grp_elections"])) > 1


# tests/test_fuzz.py's seeded mutation.
MUT = dict(n_groups=8, n_nodes=3, log_capacity=32, cmd_period=2, seed=2)
T_M, G_M = 70, 3


def test_mutated_farm_corpus_bytes_equal_jax(tmp_path):
    clean = RaftConfig(**MUT, scenario=ScenarioSpec(farm_seed=1,
                                                    drop_max=0.05)
                       ).stressed(10)
    jclean = JConfig(**MUT, scenario=JSpec(farm_seed=1, drop_max=0.05)
                     ).stressed(10)

    def mf(c):
        return fuzz.committed_rewrite_mutator(c, T_M, G_M)

    res = fuzz.fuzz_farm(clean, 90, mutator_factory=mf, triage_confirm=False,
                         out_path=str(tmp_path / "port.jsonl"), device="cpu")
    want = jfuzz.fuzz_farm(
        jclean, 90,
        mutator_factory=lambda c: jfuzz.committed_rewrite_mutator(c, T_M, G_M),
        triage_confirm=False, out_path=str(tmp_path / "jax.jsonl"))
    assert fuzz.corpus_lines(res["records"]) == \
        jfuzz.corpus_lines(want["records"])
    assert res["corpus_hash"] == want["corpus_hash"]
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "jax.jsonl").read_bytes()
    assert {k: v for k, v in res.items() if k != "records"} == \
        {k: v for k, v in want.items() if k != "records"}
    art = res["records"][0]
    assert (art["tick"], art["group"], art["horizon"]) == (T_M, G_M, T_M + 1)
    assert fuzz.scenario_channels(config_from_dict(art["config"])) == []
    assert art["replay_confirmed"] and art["universe"]
    assert fuzz.replay_artifact(art, mutator_factory=mf, device="cpu")
    assert not fuzz.replay_artifact(dict(art, tick=art["tick"] + 1),
                                    mutator_factory=mf, device="cpu")


def test_twin_leader_mutation_latches_at_the_jax_coordinate():
    kw = dict(n_groups=4, n_nodes=3, log_capacity=32, cmd_period=4, seed=4)
    want = jfuzz.run_fuzz_batch(
        JConfig(**kw, scenario=JSpec(farm_seed=2)).stressed(10), 50,
        mutator=jfuzz.twin_leader_mutator(None, 40, 1))["latch"]
    cfg = RaftConfig(**kw, scenario=ScenarioSpec(farm_seed=2)).stressed(10)
    got = fuzz.run_fuzz_batch(cfg, 50, mutator=fuzz.twin_leader_mutator(
        cfg, 40, 1), device="cpu")["latch"]
    assert got == want
    assert (got["tick"], got["group"], got["invariant"]) == (
        40, 1, "election_safety")


def test_farm_corpus_is_deterministic(tmp_path):
    cfg = fuzz.smoke_config(24)
    for name, kw in (("one", {}), ("two", dict(batch_groups=12))):
        a = fuzz.fuzz_farm(cfg, 50, out_path=str(tmp_path / f"{name}a"),
                           triage_confirm=False, device="cpu", **kw)
        b = fuzz.fuzz_farm(cfg, 50, out_path=str(tmp_path / f"{name}b"),
                           triage_confirm=False, device="cpu", **kw)
        assert a == b
        assert (tmp_path / f"{name}a").read_bytes() == \
            (tmp_path / f"{name}b").read_bytes()
    other = fuzz.fuzz_farm(fuzz.smoke_config(24, farm_seed=13), 50,
                           triage_confirm=False, device="cpu")
    assert other["corpus_hash"] != a["corpus_hash"]


def test_cli_fuzz_on_cpu_equals_the_farm():
    out = subprocess.run(
        [sys.executable, "-m", "raft_kotlin_tpu_torch", "fuzz", "--device",
         "cpu", "--universes", "16", "--ticks", "30", "--json"],
        capture_output=True, text=True, timeout=300)
    assert out.returncode in (0, 1), out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    want = fuzz.fuzz_farm(fuzz.smoke_config(16), 30, triage_confirm=False,
                          device="cpu")
    assert res["corpus_hash"] == want["corpus_hash"]
    assert res["inv_status"] == want["inv_status"]
    assert out.returncode == (0 if want["inv_status"] == "clean" else 1)
    bad = subprocess.run(
        [sys.executable, "-m", "raft_kotlin_tpu_torch", "fuzz", "--device",
         "cpu", "--delay", "3", "1"], capture_output=True, text=True,
        timeout=120)
    assert bad.returncode == 2


@pytest.mark.parametrize("spec", [
    dict(timeout_windows=True),                 # §19 per-group el windows
    dict(life_lo=5, life_hi=40),                # §19 scheduler lifetimes
    dict(quiesce_ticks=8),                      # §19 quiescence
    dict(client_rate_max=2),                    # §20 client streams
])
def test_unported_bank_channels_raise(spec):
    serve = {"serve_slots": 8} if "client_rate_max" in spec else {}
    cfg = RaftConfig(n_groups=4, **serve,
                     scenario=ScenarioSpec(drop_max=0.1, **spec))
    for entry in (lambda: check_supported(cfg),
                  lambda: init_state(cfg, "cpu"),
                  lambda: make_cuda_scan(cfg, 4, device="cpu"),
                  lambda: fuzz.make_batch_runner(cfg, 4, device="cpu")):
        with pytest.raises(NotImplementedError):
            entry()


def test_unported_farm_paths_raise():
    deep = RaftConfig(n_groups=4, log_capacity=512,
                      scenario=ScenarioSpec(drop_max=0.1))
    for entry in (lambda: init_state(deep, "cpu"),
                  lambda: make_cuda_scan(deep, 4, device="cpu"),
                  lambda: ttick.make_run(deep, 4, device="cpu")):
        with pytest.raises(NotImplementedError, match="deep log"):
            entry()
    cfg = fuzz.smoke_config(4)
    with pytest.raises(NotImplementedError, match="triage"):
        fuzz.fuzz_farm(cfg, 4, device="cpu")
    # Leader programs with staged aux cannot fuse (the JAX package's rule).
    with pytest.raises(ValueError, match="leader-isolation"):
        make_cuda_scan(cfg, 8, fused_ticks=2, aux_source="staged",
                       device="cpu")
    no_leader = dataclasses.replace(cfg, scenario=dataclasses.replace(
        cfg.scenario, partitions=("split", "asym")))
    make_cuda_scan(no_leader, 8, fused_ticks=2, aux_source="staged",
                   device="cpu")  # split / asym programs fuse staged


# The farm's two regimes latch at 102,400 universes (chip_smoke.py step
# 11): the smoke family at tick 44 in universe 11,387, its mailbox regime
# (scripts/fuzz_farm.py --delay 1 4) at tick 28 in universe 40,756. The
# batch over the universes up to the latched one latches there, in the JAX
# package as in the port.
FARM_LATCHES = {
    "smoke": ("committed_prefix@t44/g11387", 11_388, 45),
    "mailbox": ("leader_completeness@t28/g40756", 40_757, 29),
}


@pytest.mark.slow
@pytest.mark.parametrize("regime", sorted(FARM_LATCHES))
def test_farm_latch_matches_jax(regime):
    status, groups, ticks = FARM_LATCHES[regime]
    cfgs = []
    for mod in (fuzz, jfuzz):
        cfg = mod.smoke_config(groups)
        if regime == "mailbox":
            cfg = dataclasses.replace(
                cfg, delay_lo=1, delay_hi=4, scenario=dataclasses.replace(
                    cfg.scenario, delay_windows=True))
        cfgs.append(cfg)
    got = fuzz.run_fuzz_batch(cfgs[0], ticks, device="cpu")
    want = jfuzz.run_fuzz_batch(cfgs[1], ticks)
    assert got["summary"]["inv_status"] == want["summary"]["inv_status"] \
        == status
    assert got["summary"] == want["summary"]
    assert got["telemetry"] == want["telemetry"]
