"""§15 log compaction and the §16 ring window in the PyTorch port, against
the JAX package on the CPU at tolerance zero (integers):

- the digest fold, the storage dtypes and the config validation;
- the port's make_run ≡ the JAX package's make_run (trace, recorder,
  monitor, end state with the snapshot planes) on the synchronous soup
  `SYNC` (folds, no install) and on `laggard_config(16)` over 120 ticks
  (InstallSnapshot catch-ups of crashed followers);
- the tick kernels' plain versions (make_cuda_scan on the CPU: the fused
  kernel's in-kernel and staged forms with its in-kernel observers' plain
  form, the one-tick kernel's staged remainder, kernel #7 at K = 4) ≡
  JAX's make_run on both;
- the §14 packed layout of a compaction config: pack_state ≡ the JAX
  package's pack_state field by field on a folded state, and
  make_run(layout="packed") (both) and make_cuda_scan(layout="packed")
  (sync: a bank takes no packed layout) ≡ JAX's make_run at both computes;
  a position doctored past int16 latches;
- int16 logs in the §15 forms: make_cuda_scan ≡ JAX's make_run;
- the ring window ≡ the full window on bench.py's compaction leg, while
  positions outgrow the ring;
- the capacity latch, invariant 6 against the JAX package's unit matrix,
  and the refusals that stay.

One JAX run per config, in module-scoped fixtures (XLA:CPU compiles a
config's scan once: ~25 s for SYNC, ~40 s for the laggard batch).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_kotlin_tpu.api.fuzz import laggard_config as j_laggard_config
from raft_kotlin_tpu.models.state import field_dtype as j_field_dtype
from raft_kotlin_tpu.models.state import fold_digest_py as j_fold_digest_py
from raft_kotlin_tpu.models.state import init_state as j_init_state
from raft_kotlin_tpu.models.state import pack_state as j_pack_state
from raft_kotlin_tpu.ops import tick as jtick
from raft_kotlin_tpu.utils import telemetry as jtel
from raft_kotlin_tpu.utils.config import RaftConfig as JConfig
from raft_kotlin_tpu_torch.api import fuzz
from raft_kotlin_tpu_torch.models.state import (
    MAILBOX_FIELDS, SNAPSHOT_FIELDS, STATE_FIELDS, check_cap_ov, field_dtype,
    fold_digest, fold_digest_py, init_state, pack_state, state_from_numpy,
    state_to_numpy)
from raft_kotlin_tpu_torch.ops import cuda_tick, deep_cache
from raft_kotlin_tpu_torch.ops import tick as ttick
from raft_kotlin_tpu_torch.ops.cuda_scan import make_cuda_scan
from raft_kotlin_tpu_torch.utils import telemetry as ttel
from raft_kotlin_tpu_torch.utils.config import (
    RaftConfig, ScenarioSpec, config_from_dict)

SYNC = dict(n_groups=8, n_nodes=3, log_capacity=64, cmd_period=3,
            p_drop=0.15, seed=11, compact_watermark=3, compact_chunk=1)
SYNC_TICKS, LAG_TICKS = 60, 120


def both(name):
    if name == "sync":
        return JConfig(**SYNC).stressed(10), RaftConfig(**SYNC).stressed(10)
    jc = j_laggard_config(16)
    return jc, fuzz.laggard_config(16)


@pytest.fixture(scope="module", params=["sync", "laggard"])
def case(request):
    """(name, port cfg, JAX end state, trace, recorder, monitor) of one
    JAX make_run from boot."""
    jc, tc = both(request.param)
    T = SYNC_TICKS if request.param == "sync" else LAG_TICKS
    end, tr, tel, mon = jtick.make_run(jc, T, trace=True, telemetry=True,
                                       monitor=True)(j_init_state(jc))
    return (request.param, tc, T, jax.device_get(end),
            {k: np.asarray(v) for k, v in tr.items()},
            jtel.summarize_telemetry(tel), jtel.summarize_monitor(mon))


def assert_matches_jax(case, end, tr, tel, mon):
    _, tc, _, jend, jtr, jtel_s, jmon_s = case
    got = state_to_numpy(end)
    for k in STATE_FIELDS + SNAPSHOT_FIELDS:
        want = np.asarray(getattr(jend, k))
        assert got[k].dtype == want.dtype, k
        np.testing.assert_array_equal(got[k], want, err_msg=k)
    assert end.tick == int(jend.tick)
    for k in tr:  # make_run's trace fields, or the fused launches' four
        np.testing.assert_array_equal(tr[k].numpy(), jtr[k], err_msg=k)
    assert ttel.summarize_telemetry(tel) == {
        k: v for k, v in jtel_s.items() if k in ttel.TELEMETRY_FIELDS}
    assert ttel.summarize_monitor(mon) == jmon_s


def test_fold_digest_matches_wrapping_int32():
    """The one digest definition: the port's host and tensor folds ≡ the
    JAX package's fold_digest_py ≡ numpy's wrapping int32 multiply-add,
    through overflow."""
    rng = np.random.RandomState(0)
    d, dp = np.int32(0), 0
    cmds = rng.randint(-(1 << 14), 1 << 14, size=200)
    dt = torch.zeros(1, dtype=torch.int32)
    with np.errstate(over="ignore"):
        for cmd in cmds:
            d = np.int32(d * np.int32(1000003) + np.int32(cmd))
            dp = fold_digest_py(dp, int(cmd))
            dt = fold_digest(dt, torch.tensor([int(cmd)], dtype=torch.int32))
            assert int(d) == dp == int(dt[0])
    dj = 0
    for cmd in cmds:
        dj = j_fold_digest_py(dj, int(cmd))
    assert dj == dp


def test_field_dtypes_and_config_validation():
    """Positions widen to int32 under compaction, the snapshot planes are
    int32, and the two packages refuse the same invalid configs."""
    jc, tc = both("sync")
    off_j = dataclasses.replace(jc, compact_watermark=0)
    off_t = dataclasses.replace(tc, compact_watermark=0)
    for k in STATE_FIELDS + MAILBOX_FIELDS + SNAPSHOT_FIELDS:
        for j, t in ((jc, tc), (off_j, off_t)):
            want = np.dtype(j_field_dtype(k, j))
            got = np.dtype(str(field_dtype(k, t)).split(".")[-1])
            assert got == want, k
    st = init_state(tc, "cpu")
    assert [st.snap_index.dtype, st.commit.dtype, st.next_index.dtype] \
        == [torch.int32] * 3
    assert init_state(off_t, "cpu").snap_index is None
    for kw in (dict(compact_watermark=-1),
               dict(compact_watermark=4, compact_chunk=0),
               dict(compact_watermark=80),
               dict(ring_capacity=32),
               dict(compact_watermark=8, compact_chunk=8, ring_capacity=12),
               dict(compact_watermark=8, compact_chunk=8, ring_capacity=80)):
        with pytest.raises(ValueError):
            JConfig(n_groups=4, log_capacity=64, **kw)
        with pytest.raises(ValueError):
            RaftConfig(n_groups=4, log_capacity=64, **kw)
    ring = RaftConfig(n_groups=4, log_capacity=64, compact_watermark=8,
                      compact_chunk=8, ring_capacity=20)
    assert ring.phys_capacity == 20
    assert init_state(ring, "cpu").log_term.shape == (3, 20, 4)


def test_make_run_equals_jax(case):
    """The plain lattice from boot: every field (snapshot planes included),
    the trace, the recorder and the monitor."""
    name, tc, T = case[:3]
    end, tr, tel, mon = ttick.make_run(tc, T, trace=True, telemetry=True,
                                       monitor=True, device="cpu")(
        init_state(tc, "cpu"))
    assert_matches_jax(case, end, tr, tel, mon)
    s = ttel.summarize_telemetry(tel)
    assert s["snapshots_taken"] > 0
    if name == "laggard":
        assert s["installsnap_deliveries"] > 0
        assert int(end.snap_index.max()) > 0


@pytest.mark.parametrize("aux_source,T", [("inkernel", 4), ("staged", 3)])
def test_kernel_plain_versions_equal_jax(case, aux_source, T):
    """make_cuda_scan on the CPU runs the §15 forms' plain versions: the
    fused kernel (T ticks a launch, its in-kernel observers' plain form,
    the trace from its snapshots) and, for the staged remainder, the
    one-tick kernel. A §12 bank's staged fused launches need T = 1 only
    for leader programs, which the laggard family has none of."""
    name, tc, ticks = case[:3]
    end, tr, tel, mon = make_cuda_scan(
        tc, ticks, telemetry=True, monitor=True, trace=True, fused_ticks=T,
        aux_source=aux_source, device="cpu")(init_state(tc, "cpu"))
    assert set(tr) == set(cuda_tick.FUSED_TRACE_FIELDS)
    assert_matches_jax(case, end, tr, tel, mon)


def test_k_tick_plain_equals_jax(case):
    """Kernel #7's §15 form through make_cuda_scan(k_per_launch=4) on the
    CPU (its plain version, K ticks a launch from staged slabs and draw
    tables): the end state ≡ JAX's (a bank without leader programs rides
    the staged slabs)."""
    _, tc, ticks = case[:3]
    end = make_cuda_scan(tc, ticks, k_per_launch=4, device="cpu")(
        init_state(tc, "cpu"))
    got, jend = state_to_numpy(end), case[3]
    for k in STATE_FIELDS + SNAPSHOT_FIELDS:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jend, k)),
                                      err_msg=k)


def test_pack_state_equals_jax(case):
    """The §15 packed fields (latched int16 positions and snapshot terms,
    the int32 digest) on a folded state: the port's pack_state ≡ the JAX
    package's, field by field and dtype by dtype (the u32 ctrl words held
    as int32 bits)."""
    name, tc, _, jend = case[:4]
    jc = both(name)[0]
    jp = jax.device_get(j_pack_state(jc, jend))
    tp = pack_state(tc, state_from_numpy(state_to_numpy_j(jend), "cpu", tc))
    assert int(np.asarray(jend.snap_index).max()) > 0
    for k in tp.fields():
        want, got = np.asarray(getattr(jp, k)), getattr(tp, k).numpy()
        if k == "ctrl_bits":
            want = want.view(np.int32)
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert tp.snap_digest.dtype == torch.int32 \
        and tp.last_index.dtype == torch.int16


def state_to_numpy_j(jend) -> dict:
    """A JAX state's fields as numpy arrays."""
    return {f.name: np.asarray(getattr(jend, f.name))
            for f in dataclasses.fields(jend)
            if getattr(jend, f.name) is not None}


@pytest.mark.parametrize("compute", ["unpacked", "packed"])
def test_packed_layout_equals_jax(case, compute):
    """The packed layout over a compaction config: make_run(layout=
    "packed") and, without a bank, make_cuda_scan(layout="packed") — the
    packed kernels' plain versions, in-kernel draws, observers in the
    launch — return JAX's wide run: trace, recorder, monitor, end state."""
    name, tc, T = case[:3]
    out = ttick.make_run(tc, T, trace=True, telemetry=True, monitor=True,
                         layout="packed", compute=compute, device="cpu")(
        init_state(tc, "cpu"))
    assert_matches_jax(case, *out)
    if tc.scenario is None:
        out = make_cuda_scan(tc, T, telemetry=True, monitor=True, trace=True,
                             fused_ticks=4, aux_source="inkernel",
                             layout="packed", compute=compute,
                             device="cpu")(init_state(tc, "cpu"))
        assert_matches_jax(case, *out)


def test_packed_position_past_int16_latches():
    """A position doctored past 32,767: the packed runs latch it, rerun
    wide and raise "width overflow" (JAX's rule: the value is in the state
    at every launch's end); the wide run carries it."""
    _, tc = both("sync")
    st = init_state(tc, "cpu")
    make_cuda_scan(tc, 20, device="cpu")(st)
    st.match_index[0, 1, 2] = 40_000
    for run in (make_cuda_scan(tc, 8, fused_ticks=4, aux_source="inkernel",
                               layout="packed", device="cpu"),
                lambda x: ttick.make_run(tc, 8, trace=False, layout="packed",
                                         device="cpu")(x)):
        with pytest.raises(RuntimeError, match="width overflow"):
            run(st.clone())
    wide = make_cuda_scan(tc, 8, fused_ticks=4, aux_source="inkernel",
                          device="cpu")(st.clone())
    assert int(wide.match_index.max()) >= 40_000


def test_int16_logs_equal_jax():
    """The §15 forms with int16 logs (the sync family): make_cuda_scan's
    fused in-kernel route ≡ one JAX make_run in the trace and every field
    of the end state, folds taken (the digest over sign-extended int16
    commands)."""
    kw = dict(SYNC, log_dtype="int16")
    jc, tc = JConfig(**kw).stressed(10), RaftConfig(**kw).stressed(10)
    T = 40
    jend, jtr = jtick.make_run(jc, T, trace=True)(j_init_state(jc))
    end, tr = make_cuda_scan(tc, T, trace=True, fused_ticks=4,
                             aux_source="inkernel", device="cpu")(
        init_state(tc, "cpu"))
    assert end.log_cmd.dtype == torch.int16
    got = state_to_numpy(end)
    for k in STATE_FIELDS + SNAPSHOT_FIELDS:
        want = np.asarray(getattr(jend, k))
        assert got[k].dtype == want.dtype, k
        np.testing.assert_array_equal(got[k], want, err_msg=k)
    for k in tr:
        np.testing.assert_array_equal(tr[k].numpy(), np.asarray(jtr[k]),
                                      err_msg=k)
    assert int(end.snap_index.max()) > 0


def bench_config(groups, ring=None):
    """bench.py's compaction leg (its §15 bounded-window proof): 64-entry
    logs, a command every 2 ticks, W = CH = 8, 40 warmup-down ticks."""
    cfg = RaftConfig(n_groups=groups, n_nodes=3, log_capacity=64,
                     cmd_period=2, p_drop=0.05, seed=0, compact_watermark=8,
                     compact_chunk=8,
                     scenario=ScenarioSpec(warmup_down=40)).stressed(10)
    return cfg if ring is None else dataclasses.replace(cfg,
                                                        ring_capacity=ring)


def test_ring_window_equals_full_window():
    """The §16 ring is storage: over 4 x C ticks the ring of 56 rows ≡ the
    full 64-row window in every per-node seat bench.py compares, the
    monitor clean, no capacity latch, the live window within 56 rows while
    positions pass 64."""
    runs = []
    for ring in (None, 56):
        cfg = bench_config(24, ring)
        runs.append(ttick.make_run(cfg, 256, trace=False, telemetry=True,
                                   monitor=True, device="cpu")(
            init_state(cfg, "cpu")))
    (full, _, tel, mon), (rend, _, _, rmon) = runs
    for f in ("term", "voted_for", "role", "commit", "last_index",
              "last_term", "rounds", "snap_index", "snap_term",
              "snap_digest", "phys_len", "cap_ov"):
        assert torch.equal(getattr(full, f), getattr(rend, f)), f
    assert rend.log_term.shape[1] == 56
    assert ttel.summarize_monitor(mon)["inv_status"] == "clean"
    assert ttel.summarize_monitor(rmon)["inv_status"] == "clean"
    assert int((rend.phys_len - rend.snap_index).max()) <= 56
    assert int(rend.last_index.max()) > 64
    assert int((rend.cap_ov != 0).sum()) == 0
    assert ttel.summarize_telemetry(tel)["snapshots_taken"] > 0


def test_capacity_latch():
    """A ring smaller than the live window latches cap_ov (loud, never a
    silent wrap) and check_cap_ov raises; without compaction a run that
    outlives its log latches too; the remedy run is clean."""
    small = bench_config(8, 20)
    end, _ = ttick.make_run(small, 120, trace=False, device="cpu")(
        init_state(small, "cpu"))
    assert bool((end.cap_ov != 0).any())
    with pytest.raises(RuntimeError, match="capacity exhausted"):
        check_cap_ov(end)
    off = dataclasses.replace(bench_config(8), compact_watermark=0,
                              log_capacity=16)
    end, _ = ttick.make_run(off, 120, trace=False, device="cpu")(
        init_state(off, "cpu"))
    assert bool((end.cap_ov != 0).any())
    ok = bench_config(8, 56)
    end, _ = ttick.make_run(ok, 120, trace=False, device="cpu")(
        init_state(ok, "cpu"))
    check_cap_ov(end)
    check_cap_ov(end.cap_ov.amax())


def _port_views(cfg, st):
    return ttel.monitor_view(st)


def _jax_views(cfg, st):
    a = state_to_numpy(st)
    return {k: jnp.asarray(a[k]) for k in
            jtel.MONITOR_STATE_FIELDS + jtel.MONITOR_COMPACT_FIELDS}


def test_snapshot_consistency_unit_matrix():
    """Invariant 6 on forged states, every verdict row ≡ the JAX package's
    invariant_matrix: equal zero bases clean, equal nonzero bases with a
    differing digest or term fire in exactly that group, unequal bases
    never compare, and the capacity and restart-taint gates hold."""
    cfg = RaftConfig(n_groups=3, n_nodes=3, log_capacity=4,
                     compact_watermark=2)
    idx = ttel.INVARIANT_IDS.index("snapshot_consistency")
    assert jtel.INVARIANT_IDS == ttel.INVARIANT_IDS
    z = torch.zeros(3, dtype=torch.bool)

    def forge(**planes):
        st = init_state(cfg, "cpu")
        for k, v in planes.items():
            getattr(st, k).copy_(torch.from_numpy(v))
        return st

    def run(st, taint=z):
        V, _, _ = ttel.invariant_matrix(_port_views(cfg, st),
                                        _port_views(cfg, st), taint, z)
        jv = _jax_views(cfg, st)
        JV, _, _ = jtel.invariant_matrix(jv, jv, jnp.asarray(taint.numpy()),
                                         jnp.asarray(z.numpy()))
        np.testing.assert_array_equal(V.numpy(), np.asarray(JV))
        return V[idx].tolist()

    si = np.zeros((3, 3), np.int32)
    si[:, 1] = 2
    dg = np.zeros((3, 3), np.int32)
    dg[0, 1] = 7
    stm = np.zeros((3, 3), np.int32)
    stm[2, 1] = 1
    si2 = si.copy()
    si2[0, 1] = 3
    cap = np.zeros((3, 3), np.int16)
    cap[1, 1] = 1
    assert run(forge()) == [False] * 3
    assert run(forge(snap_index=si, snap_digest=dg)) == [False, True, False]
    assert run(forge(snap_index=si, snap_term=stm)) == [False, True, False]
    assert run(forge(snap_index=si)) == [False] * 3
    assert run(forge(snap_index=si2, snap_digest=dg)) == [False] * 3
    assert run(forge(snap_index=si, snap_digest=dg, cap_ov=cap)) \
        == [False] * 3
    assert run(forge(snap_index=si, snap_digest=dg),
               torch.tensor([False, True, False])) == [False] * 3


def test_refusals_that_stay():
    """The refusals a compaction config still meets, each before any work
    and each the JAX package's own: kernel #7 with the packed layout,
    in-kernel draws or an observer (ValueError), a §12 bank with the packed
    layout (NotImplementedError), the frontier cache's ValueError."""
    _, tc = both("sync")
    lag = fuzz.laggard_config(16)
    for kw in (dict(layout="packed"), dict(aux_source="inkernel"),
               dict(telemetry=True), dict(monitor=True)):
        with pytest.raises(ValueError, match="k_per_launch"):
            make_cuda_scan(tc, 4, k_per_launch=2, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="scenario bank"):
        make_cuda_scan(lag, 4, layout="packed", device="cpu")
    deep = RaftConfig(n_groups=8, n_nodes=3, log_capacity=512,
                      log_dtype="int16", compact_watermark=4)
    with pytest.raises(ValueError, match="frontier-cache"):
        deep_cache.make_deep_scan(deep, 10, device="cpu")
    assert config_from_dict(dataclasses.asdict(tc)) == tc
