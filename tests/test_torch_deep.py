"""The deep-log batched engine (raft_kotlin_tpu_torch/ops/tick.py under
flags.batched) against the JAX package's, on the CPU. Tolerance: zero — the
state is all integers, so every trace field, end-state field and recorder
counter must be bit-equal, in the same dtypes.

The JAX reference is `make_tick(cfg)` — its batched engine with the Pallas
gather and scatter in interpret mode, as tests/test_deep_gather.py runs them
— stepped op by op with its recorder: XLA:CPU takes ~40 s to compile one
deep tick at N=3 and minutes at N >= 5, so no test here jits it. At N=7
int16 the reference is JAX's per-pair engine (`batched=False`), which
tests/test_deep_gather.py holds equal to its batched one.

- tier 1, against JAX: the ghost-append soup (N=3, C=256, seed 41) with
  int16 logs at 64 groups from boot over 22 ticks (leaders and the §3
  ghost state, phys_len > last_index, from tick 21), and over ticks
  121-132 from a state of the port's direct-read lattice, every field
  each tick — ticks 123 and 129 need a ghost row (129: JAX's round-4
  batched/per-pair divergence); a five-node soup over ticks 31-35 the
  same way. Against the port's direct-read lattice: the whole 150-tick
  soup (8 groups, int32) and config 5 itself (C = 10,000) over 30 ticks at
  16 groups. The flags and the routing;
- slow (`-m slow`): the soup from boot through 150 ticks, the five-node
  soup from boot over 60 ticks, and seven nodes with int16 logs (the
  config-5 shape at C=256) against JAX's per-pair engine.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_kotlin_tpu.models.state import RaftState as JState
from raft_kotlin_tpu.models.state import init_state as j_init_state
from raft_kotlin_tpu.ops import tick as jtick
from raft_kotlin_tpu.utils import telemetry as jtel
from raft_kotlin_tpu.utils.config import RaftConfig as JConfig
from raft_kotlin_tpu_torch.models.state import (
    STATE_FIELDS, init_state, state_from_numpy, state_to_numpy)
from raft_kotlin_tpu_torch.ops import cuda_tick, deep_gather, deep_scatter
from raft_kotlin_tpu_torch.ops import tick as ttick
from raft_kotlin_tpu_torch.utils import telemetry as ttel
from raft_kotlin_tpu_torch.utils.config import RaftConfig, deep_config

SOUP = dict(n_nodes=3, log_capacity=256, cmd_period=3, p_drop=0.2,
            p_crash=0.02, p_restart=0.15, seed=41)
# name -> (config kwargs, stress, ticks, JAX engine: None = batched,
# False = per-pair)
DEEP = {
    "ghost_soup": (dict(n_groups=8, **SOUP), 10, 150, None),
    "ghost_soup_int16": (dict(n_groups=64, log_dtype="int16", **SOUP), 10,
                         22, None),
    "five_nodes": (dict(n_groups=16, n_nodes=5, log_capacity=300,
                        cmd_period=2, p_drop=0.2, p_crash=0.01,
                        p_restart=0.1, p_link_fail=0.03, p_link_heal=0.1,
                        seed=61), 10, 60, None),
    "seven_nodes_int16": (dict(n_groups=16, n_nodes=7, log_capacity=256,
                               log_dtype="int16", cmd_period=2, p_drop=0.05,
                               seed=3), 10, 60, False),
    # BASELINE config 5 itself (utils/config.deep_config) at 16 groups: the
    # int16 positions with node offsets (n - 1) * C past int16.
    "config5": (dict(n_groups=16, n_nodes=7, log_capacity=10_000,
                     log_dtype="int16", cmd_period=2, p_drop=0.05, seed=3),
                10, 30, False),
}


# Mid-run windows held against JAX in tier 1: name -> (ticks the port's
# direct-read lattice steps from boot to the shared start state, ticks both
# engines step from there). The ghost-append soup's window holds ticks 123
# and 129, where its tick-end last_term needs a ghost row (tick 129: JAX's
# batched engine's one-time divergence); the five-node window starts once
# leaders replicate.
MID_RUN = {"ghost_soup_int16": (120, 12), "five_nodes": (30, 5)}


def both(name):
    kw, stress, _, _ = DEEP[name]
    return JConfig(**kw).stressed(stress), RaftConfig(**kw).stressed(stress)


def jax_steps(name, state, ticks):
    """The JAX reference from `state`: (end state as numpy, every state
    field after each tick stacked (T, ...), recorder counters)."""
    jc, _ = both(name)
    tick = jtick.make_tick(jc, batched=DEEP[name][3])
    tel, ys = jtel.telemetry_zeros(), []
    for _ in range(ticks):
        nxt = tick(state)
        tel = jtel.telemetry_step(state, nxt, tel)
        ys.append({k: np.asarray(getattr(nxt, k)) for k in STATE_FIELDS})
        state = nxt
    end = {k: np.asarray(getattr(state, k)) for k in STATE_FIELDS}
    end["tick"] = int(state.tick)
    return (end, {k: np.stack([y[k] for y in ys]) for k in ys[0]},
            jtel.summarize_telemetry(tel))


@pytest.fixture
def rows_in_range(monkeypatch):
    """Every batched read the engine issues asks for rows in [0, C) (the
    gather's contract); counts the gathers."""
    calls = []
    plain = deep_gather.gather_plain

    def spy(lt, lc, rows, N, C, Rc=None):
        assert int(rows.min()) >= 0 and int(rows.max()) < C
        calls.append(rows.shape)
        return plain(lt, lc, rows, N, C, Rc)

    monkeypatch.setattr(deep_gather, "gather_plain", spy)
    return calls


def assert_run_equals(name, arrs, ticks, want, impl="auto"):
    """The port's make_run from the numpy state `arrs` equals `want` (a
    jax_steps result): traces, end state (dtypes too), recorder."""
    _, tc = both(name)
    jend, jys, jtel_ = want
    end, ys, tel = ttick.make_run(tc, ticks, trace=True, telemetry=True,
                                  impl=impl, device="cpu")(
        state_from_numpy(arrs, "cpu", cfg=tc))
    for k in ttick.TRACE_FIELDS:
        np.testing.assert_array_equal(ys[k].numpy(), jys[k],
                                      err_msg=f"trace {k}")
    for k in STATE_FIELDS:
        got = getattr(end, k).numpy()
        assert got.dtype == jend[k].dtype, k
        np.testing.assert_array_equal(got, jend[k], err_msg=k)
    assert end.tick == jend["tick"]
    assert ttel.summarize_telemetry(tel) == jtel_
    return end, tel


def run_from_boot(name, impl="auto"):
    """The port's make_run from boot equals the JAX reference's."""
    jc, tc = both(name)
    ticks = DEEP[name][2]
    want = jax_steps(name, j_init_state(jc), ticks)
    return assert_run_equals(name, state_to_numpy(init_state(tc, "cpu")),
                             ticks, want, impl)


def test_ghost_soup_int16_equals_jax(rows_in_range):
    """The ghost-append soup with int16 logs (config 5's storage dtype)
    from boot over 22 ticks at 64 groups (leaders from tick 21, nodes in
    the §3 ghost state from then on), through the deep wrappers (make_run
    impl="kernel"; their plain versions on the CPU): one gather of
    Rt = 4N + 1 term rows per node a tick, rows always in [0, C)."""
    end, tel = run_from_boot("ghost_soup_int16", impl="kernel")
    assert rows_in_range == [(3 * (4 * 3 + 1), 64)] * 22
    assert int(end.commit.max()) > 0 and int(tel["append_accepts"]) > 0
    assert int((end.phys_len > end.last_index).sum()) > 0


@pytest.mark.parametrize("name", sorted(MID_RUN))
def test_deep_run_equals_jax_mid_run(name, rows_in_range):
    """From a mid-run state of the port's direct-read lattice (no batched
    read, no ghost rows), the port's make_run and JAX's batched engine
    (Pallas gather and scatter in interpret mode) step the same window
    bit-equal — traces, end state and recorder, and every state field
    after each tick (last_term is rebuilt each tick, so a wrong ghost read
    shows only there): the ghost-append soup's ticks 121-132 (§3 ghost
    state in force) and the five-node soup's ticks 31-35."""
    _, tc = both(name)
    start, ticks = MID_RUN[name]
    mid, direct = init_state(tc, "cpu"), direct_read_tick(tc)
    for _ in range(start):
        direct(mid)
    if name == "ghost_soup_int16":
        assert int((mid.phys_len > mid.last_index).sum()) > 0
    arrs = state_to_numpy(mid)
    jstate = JState(**{k: jnp.asarray(arrs[k]) for k in STATE_FIELDS},
                    tick=jnp.asarray(arrs["tick"], jnp.int32))
    want = jax_steps(name, jstate, ticks)
    end, tel = assert_run_equals(name, arrs, ticks, want)
    step = ttick.make_tick(tc, "cpu")
    for t in range(ticks):
        step(mid)
        for k in STATE_FIELDS:
            np.testing.assert_array_equal(getattr(mid, k).numpy(),
                                          want[1][k][t],
                                          err_msg=f"{k} at tick {mid.tick}")
    assert len(rows_in_range) == 2 * ticks  # make_run's and make_tick's
    assert int(tel["append_accepts"]) > 0 and int(end.commit.max()) > 0


def direct_read_tick(cfg):
    """A tick of the port's shallow lattice (direct log reads and writes, no
    deferral) on a deep config: the port's twin of JAX's per-pair engine."""
    def body(cfg, s, aux, flags):
        return ttick.phase_body(cfg, s, aux, dataclasses.replace(
            flags, dyn_log=False, batched=False))

    return ttick.make_stepper(cfg, "cpu", body)


@pytest.mark.parametrize("name", ["ghost_soup", "config5"])
def test_batched_engine_equals_direct_reads(name):
    """The whole 150-tick ghost-append soup, and config 5's shape: the
    batched engine (deferred writes, one gather, ghost rows) and the
    direct-read lattice stay bit-equal every tick — the divergence JAX's
    batched engine once had at tick 129 (a §3 ghost append's stale
    last_term row)."""
    _, tc = both(name)
    a, b = init_state(tc, "cpu"), init_state(tc, "cpu")
    batched, direct = ttick.make_tick(tc, "cpu"), direct_read_tick(tc)
    ghosts = 0
    for _ in range(DEEP[name][2]):
        batched(a)
        direct(b)
        for k in STATE_FIELDS:
            assert torch.equal(getattr(a, k), getattr(b, k)), \
                f"{k} at tick {a.tick}"
        ghosts += int((a.phys_len > a.last_index).sum())
    assert ghosts > 0  # the soup does reach the §3 ghost state
    assert int(a.commit.max()) > 0


@pytest.mark.slow
@pytest.mark.parametrize("name", ["ghost_soup", "five_nodes",
                                  "seven_nodes_int16"])
def test_deep_make_run_equals_jax(name, rows_in_range):
    """From boot: the ghost-append soup through its 150 ticks, a five-node
    fault soup, and seven nodes with int16 logs (config 5's shape at
    C = 256) against JAX's per-pair engine."""
    end, tel = run_from_boot(name)
    assert len(rows_in_range) == DEEP[name][2]
    assert int(end.commit.max()) > 0 and int(tel["leader_changes"]) > 0


def test_flags_and_routing_match_jax():
    """make_flags equals JAX's on the deep configs and on config 5 at
    102,400 groups; the deep path never takes the shallow tick kernels."""
    config5 = JConfig(n_groups=102_400, n_nodes=7, log_capacity=10_000,
                      log_dtype="int16", cmd_period=2, p_drop=0.05,
                      seed=3).stressed(10)
    for jc, tc in [both(n) for n in DEEP] + [(config5, deep_config())]:
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        jf, tf = jtick.make_flags(jc), ttick.make_flags(tc)
        for f in ("faults", "links", "periodic", "inject", "delay", "dyn_log",
                  "batched", "compact", "packed_compute"):
            assert getattr(tf, f) == getattr(jf, f), f
        assert tf.dyn_log and tf.batched
        with pytest.raises(NotImplementedError):
            cuda_tick.make_cuda_tick(tc, "cpu")
    tc = both("ghost_soup")[1]
    # The per-pair engine (dyn_log without batched) and §15 compaction are
    # ported; the batched engine under the mailbox with compaction is not a
    # combination the JAX package runs either.
    ttick.check_flags(ttick.BodyFlags(dyn_log=True))
    ttick.check_flags(ttick.BodyFlags(dyn_log=True, compact=True))
    with pytest.raises(ValueError):
        ttick.check_flags(ttick.BodyFlags(dyn_log=True, batched=True,
                                          delay=True, compact=True))
    with pytest.raises(ValueError):
        ttick.make_deep_tick(RaftConfig(n_groups=2), "cpu")
    s = ttick.flatten_state(tc, init_state(tc, "cpu"))
    with pytest.raises(ValueError):
        ttick.phase_body(tc, s, {}, ttick.make_flags(tc), cut=3)


def test_make_deep_tick_on_cpu_runs_the_plain_versions():
    """make_run(impl="kernel") on CPU tensors is the deep wrappers' CPU
    branch: equal to impl="plain", with no kernel launch counted."""
    name = "ghost_soup_int16"
    _, tc = both(name)
    deep_gather.reset_counts()
    deep_scatter.reset_counts()
    runs = [ttick.make_run(tc, 12, trace=True, impl=impl, device="cpu")(
        init_state(tc, "cpu")) for impl in ("kernel", "plain")]
    for k in STATE_FIELDS:
        assert torch.equal(getattr(runs[0][0], k), getattr(runs[1][0], k)), k
    assert deep_gather.LAUNCHES == {"deep_gather": 0}
    assert deep_scatter.LAUNCHES == {"deep_scatter": 0}
    assert deep_gather.PLAIN_ON_CUDA == {"deep_gather": 0}
