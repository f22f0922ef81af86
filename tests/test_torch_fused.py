"""The port's flat-carry runner (raft_kotlin_tpu_torch/ops/cuda_scan.py
make_cuda_scan) on the CPU, where every launch runs its kernel's plain
version, against the JAX package at tolerance zero (integers):

- aux_source {staged, inkernel} x fused_ticks {1, 3} over 7 ticks from a
  mid-run state of the headline soup (3 + 3 + a 1-tick remainder at T=3),
  with the recorder, the monitor and the trace on, against the JAX
  package's XLA make_run — the reference its own tests hold
  make_pallas_scan to;
- the in-kernel fused path at 8 groups against the JAX package's
  make_pallas_scan(fused_ticks=2, aux_source="inkernel") in Pallas
  interpret mode;
- the staged draw tables' overflow raising, the refusals (packed compute
  without the packed layout, the K-tick kernel with either, serving, inject
  into the fused kernel), the fused depth's resolution and the snapshot
  field sets.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_kotlin_tpu.models.state import RaftState as JState
from raft_kotlin_tpu.models.state import init_state as jinit_state
from raft_kotlin_tpu.ops import pallas_tick as jpt
from raft_kotlin_tpu.ops import tick as jtick
from raft_kotlin_tpu.utils import telemetry as jtel_mod
from raft_kotlin_tpu.utils.config import RaftConfig as JConfig
from raft_kotlin_tpu_torch.models.state import (
    STATE_FIELDS, init_state, state_from_numpy, state_to_numpy)
from raft_kotlin_tpu_torch.ops import cuda_tick
from raft_kotlin_tpu_torch.ops import tick as ttick
from raft_kotlin_tpu_torch.ops.cuda_scan import (
    make_cuda_scan, resolve_fused_geometry)
from raft_kotlin_tpu_torch.utils.config import RaftConfig
from raft_kotlin_tpu_torch.utils.telemetry import summarize_monitor

HEADLINE = dict(n_nodes=5, log_capacity=32, cmd_period=10, p_drop=0.25,
                p_crash=0.01, p_restart=0.08, p_link_fail=0.02,
                p_link_heal=0.08, seed=0)
TICKS, WARM = 7, 40


def configs(groups):
    return (JConfig(n_groups=groups, **HEADLINE).stressed(10),
            RaftConfig(n_groups=groups, **HEADLINE).stressed(10))


@functools.lru_cache(maxsize=None)
def warm_arrays(groups):
    """The headline soup at `groups` groups after WARM plain ticks, as
    numpy arrays (elections, commits and restarts are live by then)."""
    _, cfg = configs(groups)
    st = init_state(cfg, "cpu")
    ttick.make_run(cfg, WARM, trace=False, impl="plain", device="cpu")(st)
    return state_to_numpy(st)


def port_state(groups):
    return state_from_numpy(warm_arrays(groups), "cpu")


def jax_state(groups):
    a = warm_arrays(groups)
    return JState(**{k: jnp.asarray(a[k]) for k in STATE_FIELDS},
                  tick=jnp.asarray(a["tick"], jnp.int32))


def assert_end_equal(end, jend):
    jn = jax.device_get(jend)
    for k in STATE_FIELDS:
        want = np.asarray(getattr(jn, k))
        got = getattr(end, k).numpy()
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert end.tick == int(jn.tick)


def assert_observers_equal(trace, tel, mon, jtrace, jtel, jmon):
    for f in cuda_tick.FUSED_TRACE_FIELDS:
        np.testing.assert_array_equal(
            trace[f].numpy(), np.asarray(jtrace[f]).astype(np.int32),
            err_msg=f)
        assert trace[f].dtype == torch.int32
    assert {k: int(v) for k, v in tel.items()} == \
        {k: int(v) for k, v in jtel.items()}
    jm = jax.device_get(jmon)
    assert set(mon) == set(jm)
    for k in jm:
        w = np.asarray(jm[k])
        assert mon[k].numpy().dtype == w.dtype, k
        np.testing.assert_array_equal(mon[k].numpy(), w, err_msg=k)


@functools.lru_cache(maxsize=None)
def jax_reference(groups):
    jcfg, _ = configs(groups)
    run = jtick.make_run(jcfg, TICKS, trace=True, impl="xla",
                         telemetry=True, monitor=True)
    return jax.device_get(run(jax_state(groups)))


@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("aux_source", ["staged", "inkernel"])
def test_cuda_scan_on_cpu_equals_jax_xla(aux_source, T):
    groups = 64
    _, cfg = configs(groups)
    jend, jtrace, jtel, jmon = jax_reference(groups)
    run = make_cuda_scan(cfg, TICKS, telemetry=True, monitor=True,
                         trace=True, fused_ticks=T, aux_source=aux_source,
                         device="cpu")
    end, trace, tel, mon = run(port_state(groups))
    assert_end_equal(end, jend)
    assert_observers_equal(trace, tel, mon, jtrace, jtel, jmon)
    # The window is not quiet: faults, elections and commits happen in it.
    for k in ("fault_events", "elections_started", "commit_advances"):
        assert int(tel[k]) > 0, k


# The headline soup is not clean: the first 44,836 groups from tick 0
# latch this invariant at tick 24 (group 44,835 is the first to break it).
HEADLINE_LATCH = ("leader_completeness@t24/g44835", 44_836, 25)


@pytest.mark.slow
def test_headline_soup_latch_matches_jax():
    """The JAX package's own monitor latches the headline soup: its XLA
    make_run and the port's headline runner (plain versions on the CPU)
    from tick 0 over the groups and ticks up to the first violation agree
    in end state, trace, recorder and monitor, and both latch it. ~3 min on
    a CPU, hence slow; chip_smoke.py's latch check runs the port's half."""
    status, groups, ticks = HEADLINE_LATCH
    jcfg, cfg = configs(groups)
    jrun = jtick.make_run(jcfg, ticks, trace=True, impl="xla",
                          telemetry=True, monitor=True)
    jend, jtrace, jtel, jmon = jax.device_get(jrun(jinit_state(jcfg)))
    run = make_cuda_scan(cfg, ticks, telemetry=True, monitor=True,
                         trace=True, fused_ticks=4, aux_source="inkernel",
                         device="cpu")
    end, trace, tel, mon = run(init_state(cfg, "cpu"))
    assert_end_equal(end, jend)
    assert_observers_equal(trace, tel, mon, jtrace, jtel, jmon)
    assert jtel_mod.summarize_monitor(jmon)["inv_status"] == status
    assert summarize_monitor(mon)["inv_status"] == status


def test_cuda_scan_on_cpu_equals_pallas_fused_inkernel():
    """The JAX package's headline runner shape at 8 groups, in Pallas
    interpret mode: two fused T=2 launches with in-kernel draws, the
    recorder, the monitor and the trace. Three-node groups: interpreting
    the five-node fused kernel costs ~100 s of compile on a CPU, the
    three-node one half that."""
    kw = dict(n_groups=8, n_nodes=3, log_capacity=8, cmd_period=3,
              p_drop=0.2, p_crash=0.02, p_restart=0.1, p_link_fail=0.02,
              p_link_heal=0.08, seed=5)
    jcfg, cfg = JConfig(**kw).stressed(10), RaftConfig(**kw).stressed(10)
    st = init_state(cfg, "cpu")
    ttick.make_run(cfg, 30, trace=False, impl="plain", device="cpu")(st)
    arrs = state_to_numpy(st)
    js = JState(**{k: jnp.asarray(arrs[k]) for k in STATE_FIELDS},
                tick=jnp.asarray(arrs["tick"], jnp.int32))
    ticks = 4
    jrun = jpt.make_pallas_scan(jcfg, ticks, interpret=True, fused_ticks=2,
                                aux_source="inkernel", telemetry=True,
                                monitor=True, trace=True)
    jend, jtrace, jtel, jmon = jax.device_get(jrun(js, jtick.make_rng(jcfg)))
    run = make_cuda_scan(cfg, ticks, fused_ticks=2, aux_source="inkernel",
                         telemetry=True, monitor=True, trace=True,
                         device="cpu")
    end, trace, tel, mon = run(st)
    assert_end_equal(end, jend)
    assert_observers_equal(trace, tel, mon, jtrace, jtel, jmon)


def test_staged_draw_table_overflow_raises():
    # Churn pacing (the JAX package's overflow test config) overflows a
    # one-reset-per-tick table within a few launches.
    churn = RaftConfig(n_groups=16, n_nodes=3, log_capacity=8, seed=1,
                       el_lo=2, el_hi=3, hb_ticks=2, round_ticks=3,
                       retry_ticks=2, bo_lo=2, bo_hi=3)
    run = make_cuda_scan(churn, 12, fused_ticks=2, _resets_bound=1,
                         device="cpu")
    with pytest.raises(RuntimeError, match="overflow"):
        run(init_state(churn, "cpu"))
    _, cfg = configs(16)
    # The real bound never overflows, and the in-kernel path has no window.
    for aux_source in ("staged", "inkernel"):
        a = port_state(16)
        make_cuda_scan(cfg, 12, fused_ticks=4, aux_source=aux_source,
                       device="cpu")(a)
        assert a.tick == WARM + 12


def test_without_observers_the_runner_returns_the_state():
    _, cfg = configs(16)
    st = port_state(16)
    assert make_cuda_scan(cfg, 3, fused_ticks=2, aux_source="inkernel",
                          device="cpu")(st) is st
    assert st.tick == WARM + 3


def test_refusals():
    _, cfg = configs(8)
    with pytest.raises(NotImplementedError):
        make_cuda_scan(cfg, 4, device="cpu", serving=True)
    # The K-tick kernel is ported (tests/test_torch_k_tick.py): K=2 runs.
    st = port_state(8)
    make_cuda_scan(cfg, 4, k_per_launch=2, device="cpu")(st)
    assert st.tick == WARM + 4
    # The packed layout and compute are ported (tests/test_torch_packed.py);
    # packed compute still needs the packed layout, and neither takes the
    # archival K-tick kernel (the JAX package's guards).
    for kw in (dict(aux_source="host"), dict(layout="narrow"),
               dict(fused_ticks=0), dict(compute="packed"),
               dict(compute="narrow"),
               dict(layout="packed", compute="packed", k_per_launch=2)):
        with pytest.raises(ValueError):
            make_cuda_scan(cfg, 4, device="cpu", **kw)
    # The fused kernel has no inject channel (the JAX package refuses
    # inject under in-kernel aux); neither form takes one here.
    st = port_state(8)
    s = ttick.flatten_state(cfg, st)
    flags = ttick.make_flags(cfg, inject_present=True)
    base, tk, bk = ttick.make_rng(cfg, "cpu")
    stat = cuda_tick.inkernel_aux_statics(cfg, base, tk, bk)
    for aux_source, ops in (
            ("inkernel", cuda_tick.inkernel_aux_operands(stat, st.tick)),
            ("staged", cuda_tick.staged_operands(cfg, base, tk, bk, st.tick,
                                                 s, 2))):
        with pytest.raises(ValueError, match="inject"):
            cuda_tick.fused_tick_kernel(cfg, s, 2, flags, aux_source, ops)
    # Without a card, a CUDA request fails instead of falling back.
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_cuda_scan(cfg, 4)


def test_fused_geometry_and_snapshot_fields():
    _, cfg = configs(8)
    assert resolve_fused_geometry(cfg, "cpu") == 1
    assert resolve_fused_geometry(cfg, "cuda") == 4
    assert resolve_fused_geometry(cfg, "cpu", 3) == 3
    jcfg, _ = configs(8)
    for kw in (dict(), dict(trace=True), dict(telemetry=True),
               dict(monitor=True), dict(telemetry=True, monitor=True),
               dict(telemetry=True, monitor=True, trace=True)):
        assert cuda_tick.fused_snapshot_fields(cfg, **kw) == \
            jpt.fused_snapshot_fields(jcfg, **kw), kw
    assert cuda_tick.FUSED_TRACE_FIELDS == jpt.FUSED_TRACE_FIELDS
    assert cuda_tick.resets_per_tick_bound(5) == \
        jpt.resets_per_tick_bound(5) == 20
