"""The deep mailbox (raft_kotlin_tpu_torch/ops/tick.py on a deep log under
the §10 mailbox) and §18 packed compute on deep logs against the JAX
package's, on the CPU. Tolerance: zero — the state is all integers, so
every field (the 13 slot planes included), recorder counter and monitor
entry must be bit-equal, in the same dtypes.

The JAX reference steps its `make_tick` op by op, without jax.jit (its
XLA:CPU compile of a deep tick takes minutes), its batched engine's Pallas
gather and scatter in interpret mode — as tests/test_torch_deep.py runs it.
Each comparison starts from a state the port's own engine reached (about
tick 60, where leaders replicate), so JAX steps only the compared window:

- make_flags equals JAX's on the delay windows [1,1], [1,3], [2,5], the
  τ=0 mailbox (0, 0) and [0,3], each with `batched` None / False / True;
- the batched engine's known-delivery batch (tests/test_mailbox_deep.py's
  MB13: N=3, C=256, 4 groups, seed 13, delays [1,3]; int32 and int16
  logs) against JAX's `make_tick(cfg)`, every field after every tick;
- the per-pair engine at [1,3] and at τ=0 ([0,3], seed 17: it commits)
  against JAX's `make_tick(cfg, batched=False)` the same way;
- packed compute on deep logs against JAX's `make_tick(compute="packed",
  batched=False)` at tests/test_packed_compute.py's
  `test_int16_deep_packed_compute_equals_unpacked` config, and the port's
  batched engine packed ≡ unpacked;
- the recorder and the monitor through the port's make_run on both
  engines against JAX's telemetry_step / monitor_step over the batched
  window, and a forged latch through both monitors, as
  tests/test_torch_deep_cache.py::test_deep_monitor_equals_jax does.

Port-only checks of these engines (longer runs, config 5's shape, the
refusals) are in tests/test_torch_deep_mailbox_engines.py.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_kotlin_tpu.models.state import RaftState as JState
from raft_kotlin_tpu.ops import tick as jtick
from raft_kotlin_tpu.utils import telemetry as jtel
from raft_kotlin_tpu.utils.config import RaftConfig as JConfig
from raft_kotlin_tpu_torch.models.state import (
    MAILBOX_FIELDS, STATE_FIELDS, init_state, state_from_numpy,
    state_to_numpy)
from raft_kotlin_tpu_torch.ops import tick as ttick
from raft_kotlin_tpu_torch.utils import telemetry as ttel
from raft_kotlin_tpu_torch.utils.config import RaftConfig

MB13 = dict(n_groups=4, n_nodes=3, log_capacity=256, cmd_period=3,
            p_drop=0.15, p_crash=0.02, p_restart=0.1, seed=13)
# name -> (config kwargs, delay window, JAX engine's `batched`); every
# config .stressed(10).
CASES = {
    "batched_d13": (MB13, (1, 3), None),
    "batched_d13_int16": (dict(MB13, log_dtype="int16"), (1, 3), None),
    "per_pair_d13": (MB13, (1, 3), False),
    "per_pair_tau0": (dict(MB13, seed=17), (0, 3), False),
    # test_int16_deep_packed_compute_equals_unpacked's config (no mailbox).
    "packed": (dict(n_groups=8, n_nodes=3, log_capacity=512,
                    log_dtype="int16", cmd_period=2, p_drop=0.1, seed=5),
               None, False),
}
START, TICKS = 60, 12


def both(name):
    kw, window, _ = CASES[name]
    jc, tc = JConfig(**kw).stressed(10), RaftConfig(**kw).stressed(10)
    if window is not None:
        lo, hi = window
        jc = dataclasses.replace(jc, delay_lo=lo, delay_hi=hi)
        tc = dataclasses.replace(tc, delay_lo=lo, delay_hi=hi)
    return jc, tc


def fields(cfg):
    return STATE_FIELDS + (MAILBOX_FIELDS if cfg.uses_mailbox else ())


@functools.lru_cache(maxsize=None)
def start_state(name):
    """The numpy state the port's engine (JAX's engine choice) reaches at
    tick START from boot."""
    _, tc = both(name)
    st = init_state(tc, "cpu")
    step = ttick.make_tick(tc, "cpu", batched=CASES[name][2])
    for _ in range(START):
        step(st)
    return state_to_numpy(st)


@functools.lru_cache(maxsize=None)
def jax_window(name, compute="unpacked"):
    """JAX's make_tick from start_state over TICKS ticks: (every field
    after each tick, recorder summary, finalized monitor as numpy)."""
    jc, tc = both(name)
    arrs = start_state(name)
    st = JState(**{k: jnp.asarray(arrs[k]) for k in fields(tc)},
                tick=jnp.asarray(arrs["tick"], jnp.int32))
    tick = jtick.make_tick(jc, batched=CASES[name][2], compute=compute)
    tel, mon = jtel.telemetry_zeros(), jtel.monitor_init(jc.n_groups, TICKS)
    ys = []
    for _ in range(TICKS):
        nxt = tick(st)
        tel = jtel.telemetry_step(st, nxt, tel)
        mon = jtel.monitor_step(st, nxt, mon)
        ys.append({k: np.asarray(getattr(nxt, k)) for k in fields(tc)})
        st = nxt
    return (ys, jtel.summarize_telemetry(tel),
            {k: np.asarray(v) for k, v in jtel.monitor_finalize(mon).items()})


def assert_steps_equal(name, **kw):
    """The port's make_tick(**kw) from start_state equals JAX's window in
    every field (dtypes too) after every tick; returns the end state."""
    _, tc = both(name)
    st = state_from_numpy(start_state(name), "cpu", cfg=tc)
    step = ttick.make_tick(tc, "cpu", **kw)
    want = jax_window(name, kw.get("compute", "unpacked"))[0]
    for t in range(TICKS):
        step(st)
        got = state_to_numpy(st)
        for k in fields(tc):
            assert got[k].dtype == want[t][k].dtype, k
            np.testing.assert_array_equal(got[k], want[t][k],
                                          err_msg=f"{k} at tick {st.tick}")
    return st


WINDOWS = [((1, 1), False), ((1, 3), False), ((2, 5), False),
           ((0, 0), True), ((0, 3), False)]


@pytest.mark.parametrize("window,mailbox", WINDOWS)
def test_make_flags_equal_jax(window, mailbox):
    """make_flags equals JAX's on each window with `batched` None, False
    and True: the batched engine only under known delivery (delay_lo >=
    1); τ=0 pins the per-pair engine even when batched=True is asked."""
    lo, hi = window
    jc, tc = (dataclasses.replace(c(**MB13).stressed(10), delay_lo=lo,
                                  delay_hi=hi, mailbox=mailbox)
              for c in (JConfig, RaftConfig))
    assert tc.uses_mailbox and tc.uses_dyn_log
    for batched in (None, False, True):
        jf = jtick.make_flags(jc, batched=batched)
        tf = ttick.make_flags(tc, batched=batched)
        for f in dataclasses.fields(tf):
            assert getattr(tf, f.name) == getattr(jf, f.name), (f.name,
                                                                batched)
        assert tf.batched == (lo >= 1 and batched is not False)


@pytest.mark.parametrize("name", ["batched_d13", "batched_d13_int16"])
def test_batched_mailbox_engine_equals_jax(name):
    """The known-delivery batch (6N+1 term rows, 3N cmd rows a node, the
    send's candidate picked by its delivery's ±1) against JAX's batched
    engine: every field every tick, leaders replicating in the window."""
    _, tc = both(name)
    assert ttick.make_flags(tc).batched
    st = assert_steps_equal(name)
    assert int(st.commit.max()) > 0
    assert int((st.aq_due >= 0).sum()) > 0  # appends in flight


@pytest.mark.parametrize("name", ["per_pair_d13", "per_pair_tau0"])
def test_per_pair_engine_equals_jax(name):
    """The per-pair engine (reads and writes in place) at known delivery,
    asked for with batched=False, and at τ=0, where it is the only deep
    engine, against JAX's make_tick(cfg, batched=False)."""
    _, tc = both(name)
    assert ttick.make_flags(tc, batched=False).batched is False
    st = assert_steps_equal(name, batched=False)
    assert int(st.commit.max()) > 0


def test_deep_packed_compute_equals_jax():
    """§18 packed compute on deep int16 logs: the per-pair engine against
    JAX's make_tick(compute="packed", batched=False); the port's batched
    engine packed ≡ unpacked over the same window."""
    name = "packed"
    _, tc = both(name)
    st = assert_steps_equal(name, batched=False, compute="packed")
    assert int(st.commit.max()) > 0
    runs = []
    for compute in ("packed", "unpacked"):
        s = state_from_numpy(start_state(name), "cpu", cfg=tc)
        runs.append(ttick.make_run(tc, TICKS, trace=True, compute=compute,
                                   impl="plain", device="cpu")(s))
    for k in STATE_FIELDS:
        assert torch.equal(getattr(runs[0][0], k), getattr(runs[1][0], k)), k
        assert torch.equal(getattr(runs[0][0], k), getattr(st, k)), k
    for k in runs[0][1]:
        assert torch.equal(runs[0][1][k], runs[1][1][k]), k


def to_jax(v: dict) -> dict:
    return {k: jnp.asarray(a) for k, a in v.items()}


def to_torch(v: dict) -> dict:
    return {k: torch.from_numpy(np.array(a)) for k, a in v.items()}


@pytest.mark.parametrize("batched", [None, False])
def test_deep_mailbox_observers_equal_jax(batched):
    """The recorder (mailbox_inflight_hw included) and the monitor through
    the port's make_run(telemetry=True, monitor=True) on each engine over
    the batched window equal JAX's telemetry_step / monitor_step; one
    tick's post view forged to latch (the first committing group's commit
    dropped to 0) gives both monitors the same latch."""
    name = "batched_d13"
    _, tc = both(name)
    _, jsum, jmon = jax_window(name)
    st = state_from_numpy(start_state(name), "cpu", cfg=tc)
    _, _, tel, mon = ttick.make_run(tc, TICKS, trace=False, telemetry=True,
                                    monitor=True, batched=batched,
                                    device="cpu")(st)
    assert ttel.summarize_telemetry(tel) == jsum
    assert jsum["mailbox_inflight_hw"] > 0
    assert set(mon) == set(jmon)
    for k in jmon:
        np.testing.assert_array_equal(mon[k].numpy(), jmon[k], err_msg=k)
    # A forged latch through both monitors' step on the port's views.
    st = state_from_numpy(start_state(name), "cpu", cfg=tc)
    step = ttick.make_tick(tc, "cpu", batched=batched)
    jm = jtel.monitor_init(tc.n_groups, TICKS)
    tm = ttel.monitor_init(tc.n_groups, TICKS, device="cpu")

    def views():
        # The port's monitor view (the slots' in-flight summary derived)
        # and JAX's (the due planes themselves).
        v = {k: t.numpy() for k, t in ttel.monitor_view(st,
                                                         clone=True).items()}
        return v, {**v, **{k: getattr(st, k).numpy().copy()
                           for k in ("vq_due", "aq_due")}}

    prev = views()
    for t in range(TICKS):
        step(st)
        cur = views()
        if t == TICKS - 4:
            g = int(np.flatnonzero(cur[0]["commit"].max(0) > 0)[0])
            for v in cur:
                v["commit"][:, g] = 0
        jm = jtel.monitor_step_arrays(to_jax(prev[1]), to_jax(cur[1]), jm)
        tm = ttel.monitor_step_arrays(to_torch(prev[0]), to_torch(cur[0]),
                                      tm)
        prev = cur
    want = jtel.summarize_monitor(jm)
    assert ttel.summarize_monitor(tm) == want
    # (The monitor counts ticks from its init.)
    assert want["inv_status"] == f"commit_monotonic@t{TICKS - 4}/g{g}"
