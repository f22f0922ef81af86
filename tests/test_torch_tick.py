"""The port's tick (raft_kotlin_tpu_torch/ops/tick.py) against the JAX
package's, on the CPU. Tolerance: zero — the state is all integers, so every
field, trace and recorder counter must be bit-equal, in the same dtypes.

- make_run: traces, end state and flight-recorder counters over 120 ticks on
  tests/test_differential.py's election / replication / fault configs and
  the headline fault-soup config at 64 groups. The three differential
  configs run .stressed(10) so their elections, commits and drops happen
  inside the 120-tick budget; the CLI's CPU run of the fault config is held
  against the same JAX run;
- make_aux: every staged draw on mid-run states (with and without the driver
  inject / fault_cmd inputs);
- phase_body(cut=k): the lattice stopped after each phase, on the same
  mid-run state and aux (carried across with state_from_numpy).
"""

import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_kotlin_tpu.models.state import RaftState as JState
from raft_kotlin_tpu.models.state import init_state as j_init_state
from raft_kotlin_tpu.ops import tick as jtick
from raft_kotlin_tpu.utils import telemetry as jtel
from raft_kotlin_tpu.utils.config import RaftConfig as JConfig
from raft_kotlin_tpu_torch.constants import LEADER
from raft_kotlin_tpu_torch.models.state import (
    STATE_FIELDS, init_state, state_from_numpy, state_to_numpy)
from raft_kotlin_tpu_torch.ops import cuda_tick
from raft_kotlin_tpu_torch.ops import tick as ttick
from raft_kotlin_tpu_torch.utils import telemetry as ttel
from raft_kotlin_tpu_torch.utils.config import RaftConfig

TICKS = 120
HEADLINE = dict(n_groups=64, n_nodes=5, log_capacity=32, cmd_period=10,
                p_drop=0.25, p_crash=0.01, p_restart=0.08, p_link_fail=0.02,
                p_link_heal=0.08, seed=0)
RUN_CONFIGS = {
    "election": dict(n_groups=4, n_nodes=3, seed=17),
    "replication": dict(n_groups=4, n_nodes=5, seed=23, cmd_period=25,
                        cmd_node=2),
    "faults": dict(n_groups=6, n_nodes=3, seed=31, p_drop=0.2),
    "headline": HEADLINE,
}


# Recorder counters each run must move: what the config exists to exercise.
EXERCISES = {
    "election": ("leader_changes", "votes_granted"),
    "replication": ("leader_changes", "commit_advances", "append_accepts"),
    "faults": ("leader_changes", "elections_started"),
    "headline": ("commit_advances", "fault_events", "append_rejects"),
}


def both(name):
    kw = RUN_CONFIGS[name]
    return JConfig(**kw).stressed(10), RaftConfig(**kw).stressed(10)


def jax_to_numpy(js) -> dict:
    out = {k: np.asarray(getattr(js, k)) for k in STATE_FIELDS}
    out["tick"] = int(js.tick)
    return out


def numpy_to_jax(arrs: dict) -> JState:
    return JState(**{k: jnp.asarray(arrs[k]) for k in STATE_FIELDS},
                  tick=jnp.asarray(arrs["tick"], jnp.int32))


@functools.lru_cache(maxsize=None)
def jax_run(name):
    """One JAX make_run per config, shared by every test of this file."""
    jc, _ = both(name)
    end, ys, tel = jtick.make_run(jc, TICKS, trace=True, telemetry=True)(
        j_init_state(jc))
    return (jax_to_numpy(jax.device_get(end)),
            {k: np.asarray(v) for k, v in ys.items()},
            jtel.summarize_telemetry(tel))


def assert_same(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not np.array_equal(got.astype(np.int64), want.astype(np.int64)):
        bad = np.argwhere(got != want)[0]
        raise AssertionError(f"{what} differs first at {tuple(bad)}: port "
                             f"{got[tuple(bad)]} jax {want[tuple(bad)]}")


def assert_make_run_equals_jax(name):
    jend, jys, jtelem = jax_run(name)
    _, cfg = both(name)
    end, ys, tel = ttick.make_run(cfg, TICKS, trace=True, telemetry=True,
                                  device="cpu")(init_state(cfg, "cpu"))
    tend = state_to_numpy(end)
    for k in STATE_FIELDS:
        assert tend[k].dtype == jend[k].dtype, k
        assert_same(tend[k], jend[k], k)
    assert int(tend["tick"]) == jend["tick"] == TICKS
    assert set(ys) == set(jys)
    for k in jys:
        assert ys[k].numpy().dtype == jys[k].dtype, k
        assert_same(ys[k], jys[k], f"trace {k}")
    assert ttel.summarize_telemetry(tel) == jtelem
    for counter in EXERCISES[name]:  # the run does what it exists for
        assert jtelem[counter] > 0, counter
    flat = ttick.flatten_state(cfg, end)
    back = ttick.unflatten_state(cfg, flat)
    for k in STATE_FIELDS:
        assert torch.equal(back[k], getattr(end, k)), k


@pytest.mark.parametrize("name", sorted(RUN_CONFIGS))
def test_make_run_equals_jax(name):
    assert_make_run_equals_jax(name)


def test_make_run_without_trace_counts_leaders():
    jend, jys, _ = jax_run("faults")
    _, cfg = both("faults")
    end, ys = ttick.make_run(cfg, TICKS, trace=False, device="cpu")(
        init_state(cfg, "cpu"))
    assert_same(ys, (jys["role"] == LEADER).sum(1), "leader counts")
    assert_same(end.role, jend["role"], "role")


def test_cli_on_cpu_matches_the_jax_run():
    """`python -m raft_kotlin_tpu_torch run --device cpu` on the fault config
    prints one JSON line whose counts equal the JAX run's end state."""
    repo = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
    args = ["--groups", "6", "--nodes", "3", "--seed", "31", "--p-drop",
            "0.2", "--stress", "10", "--ticks", str(TICKS)]
    r = subprocess.run([sys.executable, "-m", "raft_kotlin_tpu_torch", "run",
                        "--device", "cpu", *args], cwd=repo, env=env,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    jend = jax_run("faults")[0]
    assert out["groups_with_leader"] == int(
        (jend["role"] == LEADER).any(0).sum()) > 0
    assert out["elections_started"] == int(jend["rounds"].astype(np.int64)
                                           .sum())
    assert out["max_commit"] == int(jend["commit"].max())
    assert (out["device"], out["impl"], out["kernel_launches"]) == (
        "cpu", "plain", 0)
    assert (out["ticks"], out["groups"]) == (TICKS, 6)


def mid_run(name):
    """A mid-run state (tick 120 of the config's run) on both sides."""
    arrs = jax_run(name)[0]
    return arrs, numpy_to_jax(arrs)


def driver_inputs(cfg, seed):
    r = np.random.default_rng(seed)
    inject = np.where(r.random((cfg.n_groups, cfg.n_nodes)) < 0.3,
                      r.integers(500, 900, (cfg.n_groups, cfg.n_nodes)),
                      -1).astype(np.int32)
    fault = r.choice([0, 0, 0, 1, 2], size=(cfg.n_groups, cfg.n_nodes))
    return inject, fault.astype(np.int32)


def aux_pair(name, drivers: bool):
    jc, tc = both(name)
    arrs, js = mid_run(name)
    inject = fault = None
    if drivers:
        inject, fault = driver_inputs(tc, 5)
    jaux, jflags = jtick.make_aux(
        jc, *jtick.make_rng(jc), js,
        None if inject is None else jnp.asarray(inject),
        None if fault is None else jnp.asarray(fault))
    ts = state_from_numpy(arrs, "cpu", cfg=tc)
    taux, tflags = ttick.make_aux(
        tc, *ttick.make_rng(tc, "cpu"), ts,
        None if inject is None else torch.from_numpy(inject),
        None if fault is None else torch.from_numpy(fault))
    return (jaux, jflags), (taux, tflags)


@pytest.mark.parametrize("name,drivers", [("headline", False),
                                          ("replication", False),
                                          ("headline", True)])
def test_make_aux_equals_jax(name, drivers):
    (jaux, jflags), (taux, tflags) = aux_pair(name, drivers)
    assert set(taux) == set(jaux)
    for k in jaux:
        assert taux[k].numpy().dtype == np.asarray(jaux[k]).dtype, k
        assert_same(taux[k], jaux[k], f"aux {k}")
    for f in ("faults", "links", "periodic", "inject", "delay", "dyn_log",
              "batched", "compact", "packed_compute"):
        assert getattr(tflags, f) == getattr(jflags, f), f


@pytest.mark.parametrize("cut", [0, 1, 2, 3, 4, 5, "inject"])
def test_phase_body_cut_equals_jax(cut):
    """Same mid-run state + aux into both lattices, stopped after phase
    `cut` (0 = phases F and 0; 5 = the whole tick; "inject" = the whole tick
    with the driver inject/fault inputs). JAX's truncated lattice leaves its
    per-node log slices unjoined, so the log arrays compare on whole ticks."""
    drivers = cut == "inject"
    k_cut = None if drivers else cut
    jc, tc = both("headline")
    arrs, js = mid_run("headline")
    (jaux, jflags), (taux, tflags) = aux_pair("headline", drivers)
    js_flat = jtick.flatten_state(jc, js)
    ts_flat = {k: torch.from_numpy(np.array(v)) for k, v in js_flat.items()}
    jd = jtick.phase_body(jc, js_flat, dict(jaux), jflags, cut=k_cut)
    td = ttick.phase_body(tc, ts_flat, taux, tflags, cut=k_cut)
    assert_same(td, jd, "el_dirty")
    whole = k_cut is None or k_cut >= 5
    for k in STATE_FIELDS:
        if k in ("log_term", "log_cmd") and not whole:
            continue
        assert ts_flat[k].numpy().dtype == np.asarray(js_flat[k]).dtype, k
        assert_same(ts_flat[k], js_flat[k], f"{k} after phase {cut}")


@pytest.mark.parametrize("drivers", [False, True])
def test_phase_body_touched_counts_the_log_traffic(drivers):
    """`touched` leaves the tick's bits alone, and its masks cover the log
    traffic the tick needs: every changed slot is marked written, every final
    last_term comes from a marked slot, an entry's cmd is read only with its
    term — and a tick touches a small part of the logs."""
    _, tc = both("headline")
    arrs, _ = mid_run("headline")
    _, (taux, tflags) = aux_pair("headline", drivers)
    N, C, G = tc.n_nodes, tc.phys_capacity, tc.n_groups
    pre = ttick.flatten_state(tc, state_from_numpy(arrs, "cpu", cfg=tc))
    s0 = {k: v.clone() for k, v in pre.items()}
    s1 = {k: v.clone() for k, v in pre.items()}
    touched = {}
    d0 = ttick.phase_body(tc, s0, taux, tflags)
    d1 = ttick.phase_body(tc, s1, taux, tflags, touched=touched)
    assert torch.equal(d0, d1)
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    rd_t, rd_c, wr = (touched[k] for k in ("log_term_read", "log_cmd_read",
                                           "log_written"))
    assert rd_t.shape == rd_c.shape == wr.shape == (N * C, G)
    changed = (s1["log_term"] != pre["log_term"]) \
        | (s1["log_cmd"] != pre["log_cmd"])
    assert not (changed & ~wr).any()
    assert not (rd_c & ~rd_t).any()
    li = s1["last_index"].long()
    rows = torch.arange(N)[:, None] * C + (li - 1).clamp(0, C - 1)
    need = (li >= 1) & (li <= C)
    got = torch.gather(rd_t | wr, 0, rows)
    assert not (need & ~got).any()
    assert wr.any() and rd_c.any() and rd_t.any()
    assert int(rd_t.sum() + wr.sum()) < 0.1 * N * C * G


def test_resolve_impl():
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    assert ttick.resolve_impl("auto", cpu) == "plain"
    assert ttick.resolve_impl("auto", card) == "kernel"
    assert ttick.resolve_impl("kernel", cpu) == "kernel"
    assert ttick.resolve_impl("plain", card) == "plain"
    with pytest.raises(ValueError):
        ttick.resolve_impl("xla", cpu)


def test_unported_flags_raise():
    _, cfg = both("election")
    s = ttick.flatten_state(cfg, init_state(cfg, "cpu"))
    with pytest.raises(NotImplementedError):
        ttick.phase_body(cfg, s, {}, ttick.BodyFlags(compact=True))
    # The deep engines (batched and per-pair), §18 packed compute and the
    # §10 mailbox on deep logs are ported (tests/test_torch_deep*.py,
    # tests/test_torch_deep_mailbox.py against JAX): their flags pass, and
    # on a deep config the per-pair engine and packed compute equal the
    # batched engine's bits. The shallow tick kernel refuses a deep config.
    for f in (dict(dyn_log=True), dict(batched=True),
              dict(packed_compute=True, dyn_log=True, batched=True),
              dict(delay=True, dyn_log=True, batched=True),
              dict(delay=True, dyn_log=True)):
        ttick.check_flags(ttick.BodyFlags(**f))
    deep = RaftConfig(n_groups=2, log_capacity=512)
    ends = []
    for kw in (dict(), dict(batched=False), dict(compute="packed")):
        st = init_state(deep, "cpu")
        step = ttick.make_tick(deep, "cpu", **kw)
        for _ in range(3):
            step(st)
        ends.append(st)
    for k in STATE_FIELDS:
        assert torch.equal(getattr(ends[0], k), getattr(ends[1], k)), k
        assert torch.equal(getattr(ends[0], k), getattr(ends[2], k)), k
    with pytest.raises(NotImplementedError):
        cuda_tick.make_cuda_tick(deep, "cpu")
    with pytest.raises(NotImplementedError):
        ttick.check_flags(dataclasses.replace(ttick.make_flags(deep),
                                              compact=True))
