"""The frontier-cache deep runner (raft_kotlin_tpu_torch/ops/deep_cache.py)
against the JAX package's and against the port's batched engine, on the
CPU. Tolerance: zero — the state is all integers, so every field must be
bit-equal in the same dtype, and every recorder and monitor counter equal.

- tier 1: make_deep_scan(return_state=True) ≡ JAX's on JAX's steady-state
  config (tests/test_deep_cache.py:34-47), the cache holding in both (ov
  False); make_deep_scan ≡ the port's batched make_run — trace rows, end
  state, recorder, rounds and livepin — on the ghost-append soup (150
  ticks), a five-node soup and config 5 at 16 groups, the cache holding
  (ov False) on each; the forced OV rerun (one-row budgets) ≡ make_run in
  every mode, with the cached attempt's ov_fallbacks; refill_all ≡ JAX's
  on a mid-run ghost state and on out-of-range rows, and the early
  top-window refill's out-of-range rows; the cache itself ≡ JAX's
  phase_body(fcache=) (stepped op by op) over a window of the soup;
  layout="packed" ≡ wide; the guards. The monitor on deep logs (C = 256,
  N = 3 and 5): the port's monitor and JAX's monitor_step, stepped op by
  op, over the same per-tick states, and the runner's monitor, equal;
  telemetry_step_arrays(ov=) ≡ JAX's on a planted OV tick;
- slow (`-m slow`): JAX's make_deep_scan(monitor=True) on
  tests/test_invariants.py:163's config, and its runner on the
  conflict-churn and fault-soup configs (tests/test_deep_cache.py:51-76),
  against the port's.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_kotlin_tpu.models.state import RaftState as JState
from raft_kotlin_tpu.models.state import init_state as j_init_state
from raft_kotlin_tpu.ops import deep_cache as jcache
from raft_kotlin_tpu.ops import tick as jtick
from raft_kotlin_tpu.utils import telemetry as jtel
from raft_kotlin_tpu.utils.config import RaftConfig as JConfig
from raft_kotlin_tpu_torch.models.state import (
    STATE_FIELDS, init_state, state_from_numpy, state_to_numpy)
from raft_kotlin_tpu_torch.ops import deep_cache, deep_gather, deep_scatter
from raft_kotlin_tpu_torch.ops import tick as ttick
from raft_kotlin_tpu_torch.utils import telemetry as ttel
from raft_kotlin_tpu_torch.utils.config import RaftConfig

SOUP = dict(n_nodes=3, log_capacity=256, cmd_period=3, p_drop=0.2,
            p_crash=0.02, p_restart=0.15, seed=41)
# name -> (config kwargs (stressed 10x), ticks)
CONFIGS = {
    "steady": (dict(n_groups=8, n_nodes=3, log_capacity=256, cmd_period=30,
                    seed=7), 70),
    "ghost_soup": (dict(n_groups=8, **SOUP), 150),
    "five_nodes": (dict(n_groups=16, n_nodes=5, log_capacity=300,
                        cmd_period=2, p_drop=0.2, p_crash=0.01,
                        p_restart=0.1, p_link_fail=0.03, p_link_heal=0.1,
                        seed=61), 60),
    "config5": (dict(n_groups=16, n_nodes=7, log_capacity=10_000,
                     log_dtype="int16", cmd_period=2, p_drop=0.05, seed=3),
                30),
    "forced_ov": (dict(n_groups=8, n_nodes=3, log_capacity=256, cmd_period=3,
                       p_drop=0.2, seed=43), 50),
    # tests/test_layout.py:235 (int16 logs).
    "int16": (dict(n_groups=8, n_nodes=3, log_capacity=512,
                   log_dtype="int16", cmd_period=2, p_drop=0.1, seed=5), 20),
    # The monitor on deep logs: C = 256 at N = 3 and N = 5.
    "monitor3": (dict(n_groups=8, **SOUP), 60),
    "monitor5": (dict(n_groups=8, n_nodes=5, log_capacity=256, cmd_period=2,
                      p_drop=0.2, p_crash=0.01, p_restart=0.1,
                      p_link_fail=0.03, p_link_heal=0.1, seed=61), 40),
    # Slow tier: tests/test_invariants.py:163, tests/test_deep_cache.py:51-76.
    "invariants": (dict(n_groups=8, n_nodes=3, log_capacity=256,
                        cmd_period=3, p_drop=0.1, seed=7), 60),
    "conflict_churn": (dict(n_groups=8, n_nodes=3, log_capacity=256,
                            cmd_period=3, p_drop=0.2, seed=41), 60),
    "fault_soup": (dict(n_groups=8, **SOUP), 150),
}


def both(name):
    kw = CONFIGS[name][0]
    return JConfig(**kw).stressed(10), RaftConfig(**kw).stressed(10)


def jax_state(arrs: dict) -> JState:
    return JState(**{k: jnp.asarray(arrs[k]) for k in STATE_FIELDS},
                  tick=jnp.asarray(arrs["tick"], jnp.int32))


def assert_state_equals(got, want: dict, what=""):
    """A port RaftState equals the numpy fields `want`, dtypes too."""
    for k in STATE_FIELDS:
        g = getattr(got, k).numpy()
        assert g.dtype == want[k].dtype, f"{what}{k}"
        np.testing.assert_array_equal(g, want[k], err_msg=f"{what}{k}")


def scan(name, **kw):
    """The port's make_deep_scan over the config's ticks, on the CPU."""
    _, tc = both(name)
    return deep_cache.make_deep_scan(tc, CONFIGS[name][1], device="cpu", **kw)


def test_deep_scan_equals_jax_steady_state():
    """JAX's make_deep_scan(return_state=True) and the port's from boot on
    JAX's conflict-free steady state: the cache holds in both (ov False)
    and the end states are bit-equal."""
    jc, tc = both("steady")
    T = CONFIGS["steady"][1]
    jend, jov = jcache.make_deep_scan(jc, T, return_state=True)(
        j_init_state(jc), jtick.make_rng(jc))
    end, ov = scan("steady", return_state=True)(init_state(tc, "cpu"))
    assert jov is False and ov is False
    want = {k: np.asarray(getattr(jend, k)) for k in STATE_FIELDS}
    assert_state_equals(end, want)
    assert end.tick == int(jend.tick) == T
    assert int(end.commit.max()) > 0


def make_run_of(name, monitor=False):
    """The port's batched make_run from boot: (end, ys, recorder[, mon])."""
    _, tc = both(name)
    return ttick.make_run(tc, CONFIGS[name][1], trace=True, telemetry=True,
                          monitor=monitor, device="cpu")(
        init_state(tc, "cpu"))


def batched_run(name):
    """make_run(trace=True, telemetry=True)'s loop — make_tick, the port's
    batched engine, a tick at a time — from boot, also summing what the
    reduction dict's livepin sums: (end, trace rows, recorder, (rounds,
    livepin))."""
    _, tc = both(name)
    st, step = init_state(tc, "cpu"), ttick.make_tick(tc, "cpu")
    tel, ys, acc = ttel.telemetry_zeros("cpu"), [], 0
    for _ in range(CONFIGS[name][1]):
        prev = ttel.state_view(st, clone=True)
        step(st)
        tel = ttel.telemetry_step_arrays(prev, ttel.state_view(st), tel)
        ys.append({k: getattr(st, k).clone() for k in ttick.TRACE_FIELDS})
        acc = (acc + int(st.log_cmd[:, 0, :].sum(dtype=torch.int64))
               + 2 ** 31) % 2 ** 32 - 2 ** 31  # int32 wrap-around
    ys = {k: torch.stack([y[k] for y in ys]) for k in ttick.TRACE_FIELDS}
    return st, ys, tel, (int(st.rounds.sum()), acc)


@pytest.mark.parametrize("name", ["ghost_soup", "five_nodes", "config5"])
def test_deep_scan_equals_batched_make_run(name):
    """The cached runner ≡ the port's batched engine as make_run steps it
    (which tests/test_torch_deep.py holds to JAX): the trace rows and the
    end state (trace mode, the state updated in place), the recorder,
    rounds and livepin (the reduction dict); the cache held on each (ov
    False: these are the cached tick's own bits, not a rerun's)."""
    _, tc = both(name)
    end, ys, tel, sums = batched_run(name)
    got = init_state(tc, "cpu")
    gys, ov = scan(name, trace=True)(got)
    assert ov is False
    for k in ttick.TRACE_FIELDS:
        assert torch.equal(gys[k], ys[k]), f"trace {k}"
    assert_state_equals(got, state_to_numpy(end))
    vals = scan(name, telemetry=True)(init_state(tc, "cpu"))
    assert int(vals["ov"]) == 0
    assert {k[4:]: int(v) for k, v in vals.items()
            if k.startswith("tel_")} == ttel.summarize_telemetry(tel)
    assert (int(vals["rounds"]), int(vals["livepin"])) == sums
    assert int(tel["append_accepts"]) > 0


def test_forced_ov_rerun_equals_make_run(monkeypatch):
    """One-row budgets overflow the cache: every mode reruns on the
    batched engine and publishes its bits — end state, trace, recorder and
    monitor equal make_run's —, with ov True, the cached attempt's
    ov_fallbacks (>= 1) in place of the rerun's 0, and the entry state
    kept by the runner or rebuilt by the caller."""
    monkeypatch.setattr(deep_cache, "TERM_BUDGET", 1)
    monkeypatch.setattr(deep_cache, "CMD_BUDGET", 1)
    _, tc = both("forced_ov")
    end, ys, tel, mon = make_run_of("forced_ov", monitor=True)
    want_tel = ttel.summarize_telemetry(tel)
    st = init_state(tc, "cpu")
    got, ov, gtel, gmon = scan("forced_ov", return_state=True,
                               telemetry=True, monitor=True)(st)
    assert got is st and ov is True
    assert_state_equals(got, state_to_numpy(end))
    fallbacks = int(gtel["ov_fallbacks"])
    assert fallbacks >= 1
    assert ttel.summarize_telemetry(gtel) == {**want_tel,
                                             "ov_fallbacks": fallbacks}
    assert ttel.summarize_monitor(gmon) == ttel.summarize_monitor(mon)
    rebuilt = []

    def rebuild(s):
        rebuilt.append(s.tick)
        init_state(tc, "cpu", out=s)

    gys, ov = scan("forced_ov", trace=True)(init_state(tc, "cpu"),
                                            rebuild=rebuild)
    assert ov is True and rebuilt == [CONFIGS["forced_ov"][1]]
    for k in ttick.TRACE_FIELDS:
        assert torch.equal(gys[k], ys[k]), f"trace {k}"
    vals = scan("forced_ov", telemetry=True, monitor=True)(
        init_state(tc, "cpu"))
    assert int(vals["ov"]) == 1
    assert int(vals["tel_ov_fallbacks"]) == fallbacks
    assert {k: int(v) for k, v in vals.items() if k.startswith("inv_")} == {
        k: int(v) for k, v in ttel.monitor_scalars(mon).items()}
    with pytest.raises(ValueError, match="tick"):
        scan("forced_ov", return_state=True)(init_state(tc, "cpu"),
                                             rebuild=lambda s: None)


@functools.lru_cache(maxsize=None)
def soup_mid_run():
    """The ghost soup's port state after 123 ticks (nodes in the §3 ghost
    state), as numpy."""
    _, tc = both("ghost_soup")
    st, step = init_state(tc, "cpu"), ttick.make_tick(tc, "cpu")
    for _ in range(123):
        step(st)
    assert int((st.phys_len > st.last_index).sum()) > 0
    return state_to_numpy(st)


def mid_state():
    """A fresh port state of soup_mid_run()."""
    return state_from_numpy(soup_mid_run(), "cpu")


def assert_cache_equal(got: dict, want: dict, what=""):
    assert set(got) == set(want) == set(deep_cache.FIELDS)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.dtype == w.dtype, f"{what}{k}"
        np.testing.assert_array_equal(g, w, err_msg=f"{what}{k}")


def test_refill_all_and_cached_ticks_equal_jax():
    """refill_all ≡ JAX's on a mid-run ghost state; then 3 ticks of the
    cached lattice from there — JAX's phase_body(fcache=) stepped op by op
    beside the port's — leave equal caches, OV flags and states."""
    jc, tc = both("ghost_soup")
    jst = jax_state(soup_mid_run())
    st = mid_state()
    fc = deep_cache.refill_all(tc, st)
    jfc = jcache.refill_all(jc, jst)
    assert_cache_equal(fc, jfc)
    rng, jrng = ttick.make_rng(tc, "cpu"), jtick.make_rng(jc)
    held = 0
    for t in range(3):
        base, tk, bk = rng
        aux, fl = ttick.make_aux(tc, base, tk, bk, st)
        s = ttick.flatten_state(tc, st)
        d = ttick.phase_body(tc, s, aux, fl, fcache=fc)
        ttick.finish_tick(tc, tk, st, s, d)
        jbase, jtk, jbk, jscen = jtick.split_rng(jrng)
        jaux, jfl = jtick.make_aux(jc, jbase, jtk, jbk, jst, None, None,
                                   scen=jscen)
        js = jtick.flatten_state(jc, jst)
        jfc = dict(jfc)
        jd = jtick.phase_body(jc, js, jaux, jfl, fcache=jfc)
        jst = jtick.finish_tick(jc, jtk, jtick.unflatten_state(jc, js), jd,
                                jst.tick)
        np.testing.assert_array_equal(fc.pop("ov").numpy(),
                                      np.asarray(jfc.pop("ov")))
        assert_cache_equal(fc, jfc, f"tick {st.tick}: ")
        assert_state_equals(st, {k: np.asarray(getattr(jst, k))
                                 for k in STATE_FIELDS}, f"tick {st.tick}: ")
        held += int(np.asarray(fc["ok_pli"]).sum())
    assert held > 0


def test_refill_all_out_of_range_rows_read_zero():
    """tests/test_deep_cache.py:143 on the port, and ≡ JAX's: top-window
    rows past C and pair frontiers at rows -2 / -1 refill 0 and valid,
    though the clipped stored rows hold 9 / 8."""
    jc = JConfig(n_groups=4, n_nodes=3, log_capacity=256, seed=0)
    tc = RaftConfig(n_groups=4, n_nodes=3, log_capacity=256, seed=0)
    N, C, G, W = 3, 256, 4, deep_cache.W_TOP
    st = init_state(tc, "cpu")
    st.log_term.fill_(9)
    st.log_cmd.fill_(8)
    st.last_index.fill_(C - 1)
    fc = deep_cache.refill_all(tc, st)
    assert_cache_equal(fc, jcache.refill_all(
        jc, jax_state(state_to_numpy(st))))
    for n in range(N):
        assert bool((fc["f_topw"][n * W] == 9).all())
        for j in range(1, W):
            assert bool((fc["f_topw"][n * W + j] == 0).all()), (n, j)
    assert bool(fc["ok_topw"].all())
    for k in deep_cache.PAIR_VALS:
        assert bool((fc[k] == 0).all()) and bool(fc["ok_" + k[2:]].all())
    assert fc["f_pli"].shape == (N * N, G)


def test_early_refill_zeroes_out_of_range_window_rows():
    """tests/test_deep_cache.py:172 on the port: a ghost-state node whose
    top window straddles C, stale 77 / 88 cached in its rows past C, on a
    command tick — those rows come out 0 and valid, the in-range rows read
    from the log, valid."""
    tc = RaftConfig(n_groups=4, n_nodes=3, log_capacity=256, cmd_period=2,
                    seed=5).stressed(10)
    N, C, G, W = 3, 256, 4, deep_cache.W_TOP
    st = init_state(tc, "cpu")
    st.last_index[1] = C - 2  # node 2's window: rows C-2, C-1, C, C+1
    st.phys_len[1] = C - 1    # the ghost state
    st.tick = tc.cmd_period
    base, tk, bk = ttick.make_rng(tc, "cpu")
    aux, flags = ttick.make_aux(tc, base, tk, bk, st)
    assert flags.batched and flags.periodic
    assert bool((aux["periodic"][0] >= 0).any())
    fc = deep_cache.init_fields(N, G, device="cpu")
    fc["f_topw"][W + 2] = 77
    fc["f_topw"][W + 3] = 88
    ttick.phase_body(tc, ttick.flatten_state(tc, st), aux, flags, fcache=fc)
    for j in range(W):
        assert bool(fc["ok_topw"][W + j].all()), j
        assert bool((fc["f_topw"][W + j] == 0).all()), j


def test_packed_layout_equals_wide():
    """layout="packed" ≡ wide on tests/test_layout.py:235's int16 config
    (end state, ov, trace), and the reduction dict's latch is 0."""
    _, tc = both("int16")
    a, b = init_state(tc, "cpu"), init_state(tc, "cpu")
    _, ov0 = scan("int16", return_state=True)(a)
    _, ov1 = scan("int16", return_state=True, layout="packed")(b)
    assert ov0 == ov1
    assert_state_equals(b, state_to_numpy(a))
    ys0, _ = scan("int16", trace=True)(init_state(tc, "cpu"))
    ys1, _ = scan("int16", trace=True, layout="packed")(init_state(tc, "cpu"))
    assert all(torch.equal(ys0[k], ys1[k]) for k in ys0)
    vals = scan("int16", layout="packed")(init_state(tc, "cpu"))
    assert int(vals["packed_ov"]) == 0


def test_guards_and_launches():
    """The refusals (compaction with JAX's message, a shallow config,
    serving, the deep mailbox's cache, an unknown layout), the default
    device, and the CPU run: no kernel launch, no plain call counted on a
    card."""
    _, tc = both("steady")
    with pytest.raises(ValueError, match="§15 compaction"):
        deep_cache.make_deep_scan(dataclasses.replace(
            tc, compact_watermark=8, compact_chunk=4), 4, device="cpu")
    with pytest.raises(ValueError, match="batched"):
        deep_cache.make_deep_scan(RaftConfig(n_groups=4), 4, device="cpu")
    with pytest.raises(NotImplementedError, match="item 5"):
        deep_cache.make_deep_scan(tc, 4, serving=True, device="cpu")
    with pytest.raises(ValueError, match="layout"):
        deep_cache.make_deep_scan(tc, 4, layout="tall", device="cpu")
    with pytest.raises(NotImplementedError, match="item 3"):
        deep_cache.init_fields(3, 4, mailbox=True, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            deep_cache.make_deep_scan(tc, 4)
    deep_gather.reset_counts()
    deep_scatter.reset_counts()
    scan("steady", return_state=True)(init_state(tc, "cpu"))
    assert deep_gather.LAUNCHES == {"deep_gather": 0}
    assert deep_scatter.LAUNCHES == {"deep_scatter": 0}
    assert deep_scatter.PLAIN_ON_CUDA == {"deep_scatter": 0}


# -- the monitor on deep logs -------------------------------------------------

def to_jax(v: dict) -> dict:
    return {k: jnp.asarray(a) for k, a in v.items()}


def to_torch(v: dict) -> dict:
    return {k: torch.from_numpy(np.array(a)) for k, a in v.items()}


@pytest.mark.parametrize("name", ["monitor3", "monitor5"])
def test_deep_monitor_equals_jax(name):
    """The port's batched deep run, C = 256: its per-tick monitor views go
    through the port's monitor_step_arrays and JAX's, stepped op by op (not
    jitted), with one tick's post view forged to latch (the group frontier
    of the first group with a commit dropped to 0 at tick T - 8: the run
    itself stays clean); the carries and summaries are equal, latch
    included. The cached runner's monitor equals the port's over the
    unforged views."""
    _, tc = both(name)
    T = CONFIGS[name][1]
    st, step = init_state(tc, "cpu"), ttick.make_tick(tc, "cpu")
    jm = jtel.monitor_init(tc.n_groups, T)
    tm, clean = (ttel.monitor_init(tc.n_groups, T, device="cpu")
                 for _ in range(2))
    prev = {k: v.numpy() for k, v in ttel.monitor_view(st, clone=True).items()}
    for t in range(T):
        step(st)
        cur = {k: v.numpy()
               for k, v in ttel.monitor_view(st, clone=True).items()}
        seen = cur
        if t == T - 8:
            g = int(np.flatnonzero(cur["commit"].max(0) > 0)[0])
            seen = {**cur, "commit": cur["commit"].copy()}
            seen["commit"][:, g] = 0
        jm = jtel.monitor_step_arrays(to_jax(prev), to_jax(seen), jm)
        tm = ttel.monitor_step_arrays(to_torch(prev), to_torch(seen), tm)
        clean = ttel.monitor_step_arrays(to_torch(prev), to_torch(cur),
                                         clean)
        prev = cur
    want = jtel.summarize_monitor(jm)
    assert ttel.summarize_monitor(tm) == want
    assert want["inv_status"] == f"commit_monotonic@t{T - 8}/g{g}"
    for k, v in jtel.monitor_finalize(jm).items():
        np.testing.assert_array_equal(
            ttel.monitor_finalize(tm)[k].numpy(), np.asarray(v), err_msg=k)
    _, ov, mon = scan(name, return_state=True, monitor=True)(
        init_state(tc, "cpu"))
    assert ov is False
    got = ttel.summarize_monitor(mon)
    assert got == ttel.summarize_monitor(clean)
    assert got["inv_status"] == "clean" and got["taint_restart_groups"] > 0


def test_recorder_counts_ov_like_jax():
    """telemetry_step_arrays(prev, cur, tel, ov=) ≡ JAX's over a tick of the
    ghost soup, with the OV flag planted (True, then False, then absent)."""
    _, tc = both("ghost_soup")
    st = mid_state()
    prev = ttel.state_view(st, clone=True)
    ttick.make_tick(tc, "cpu")(st)
    cur = ttel.state_view(st)
    tel, jt = ttel.telemetry_zeros("cpu"), jtel.telemetry_zeros()
    np_ = {k: v.numpy() for k, v in prev.items()}
    nc = {k: v.numpy() for k, v in cur.items()}
    for ov in (True, False, None):
        tel = ttel.telemetry_step_arrays(
            prev, cur, tel, ov=None if ov is None else torch.tensor(ov))
        jt = jtel.telemetry_step_arrays(
            to_jax(np_), to_jax(nc), jt,
            ov=None if ov is None else jnp.asarray(ov))
    assert ttel.summarize_telemetry(tel) == jtel.summarize_telemetry(jt)
    assert int(tel["ov_fallbacks"]) == 1


# -- slow: JAX's runner on longer configs -------------------------------------

def jax_scan_state(name, **kw):
    jc, _ = both(name)
    return jcache.make_deep_scan(jc, CONFIGS[name][1], return_state=True,
                                 **kw)(j_init_state(jc), jtick.make_rng(jc))


@pytest.mark.slow
def test_deep_monitor_equals_jax_runner():
    """JAX's make_deep_scan(monitor=True) on tests/test_invariants.py:163's
    config ≡ the port's: end state, ov, summarized monitor."""
    _, tc = both("invariants")
    jend, jov, jmon = jax_scan_state("invariants", monitor=True)
    end, ov, mon = scan("invariants", return_state=True, monitor=True)(
        init_state(tc, "cpu"))
    assert ov == jov
    assert_state_equals(end, {k: np.asarray(getattr(jend, k))
                              for k in STATE_FIELDS})
    assert ttel.summarize_monitor(mon) == jtel.summarize_monitor(jmon)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["conflict_churn", "fault_soup"])
def test_deep_scan_equals_jax_runner(name):
    """JAX's runner on the conflict-churn and fault-soup configs ≡ the
    port's: end state and ov."""
    _, tc = both(name)
    jend, jov = jax_scan_state(name)
    end, ov = scan(name, return_state=True)(init_state(tc, "cpu"))
    assert ov == jov
    assert_state_equals(end, {k: np.asarray(getattr(jend, k))
                              for k in STATE_FIELDS})
