"""The port's §10 mailbox (SEMANTICS.md §10) against the JAX package's, on
the CPU. Tolerance: zero — the state is all integers, so every trace
field, end-state field (the 13 slot planes included), recorder counter and
monitor entry must be bit-equal, in the same dtypes.

The JAX reference steps its `make_tick` op by op — the ops of its XLA
`make_run` scan body, without the ~60 s XLA:CPU compile of the five-node
mailbox scan — with its recorder and monitor after each tick, once per
config (module scope).

- tier 1: bench.py's stage-4b config (`mailbox_config`) at 128 five-node
  groups over 30 ticks: the port's make_run (traces, end state with every
  slot, recorder with mailbox_inflight_hw) and its flat-carry runner (the
  monitor) against JAX; three-node soups at delays [1, 1], [2, 5] and the
  τ=0 window [0, 2] the same way; the monitor's stale-append hazard on
  forged views; make_cuda_scan (both aux forms,
  T in {1, 4}) against make_run; τ=0 at 0/0 against the port's own
  synchronous path; the straggler rule and a restart clearing the slots a
  node owns (twins of tests/test_delay.py's oracle tests); the delay draw
  and its in-kernel twin against JAX's, lo == hi included; the refusals
  of what is still unported;
- slow (`-m slow`): make_cuda_scan against the JAX package's Pallas fused
  kernel in interpret mode (its compile alone is minutes), a 200-tick run
  against JAX's jitted make_run, and the stage-4b soup's monitor latch
  (35,422 groups, 38 ticks) against JAX's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_kotlin_tpu.models.oracle import OracleGroup
from raft_kotlin_tpu.models.state import RaftState as JState
from raft_kotlin_tpu.models.state import init_state as jinit_state
from raft_kotlin_tpu.ops import tick as jtick
from raft_kotlin_tpu.utils import rng as jrng
from raft_kotlin_tpu.utils import telemetry as jtel
from raft_kotlin_tpu.utils.config import RaftConfig as JConfig
from raft_kotlin_tpu_torch.constants import BACKOFF, CANDIDATE
from raft_kotlin_tpu_torch.models.state import (
    MAILBOX_FIELDS, STATE_FIELDS, init_state, state_from_numpy,
    state_to_numpy)
from raft_kotlin_tpu_torch.ops import cuda_tick
from raft_kotlin_tpu_torch.ops import tick as ttick
from raft_kotlin_tpu_torch.ops.cuda_scan import make_cuda_scan
from raft_kotlin_tpu_torch.utils import rng as trng
from raft_kotlin_tpu_torch.utils import telemetry as ttel
from raft_kotlin_tpu_torch.utils.config import (
    RaftConfig, ScenarioSpec, mailbox_config)

TICKS = 30
SOUP3 = dict(n_groups=16, n_nodes=3, log_capacity=16, cmd_period=3,
             p_drop=0.2, p_crash=0.02, p_restart=0.15, p_link_fail=0.02,
             p_link_heal=0.1, seed=11)
# name -> config kwargs (all .stressed(10)).
CONFIGS = {
    # bench.py stage 4b (bench.py:1418-1424) at 128 groups.
    "stage4b": dict(n_groups=128, n_nodes=5, log_capacity=32, cmd_period=10,
                    p_drop=0.25, p_crash=0.01, p_restart=0.08,
                    p_link_fail=0.02, p_link_heal=0.08, seed=5, delay_lo=1,
                    delay_hi=3),
    "n3_d11": dict(SOUP3, delay_lo=1, delay_hi=1),
    "n3_d25": dict(SOUP3, delay_lo=2, delay_hi=5),
    "n3_tau0": dict(SOUP3, delay_lo=0, delay_hi=2),
}
FIELDS = STATE_FIELDS + MAILBOX_FIELDS


def both(name):
    kw = CONFIGS[name]
    return JConfig(**kw).stressed(10), RaftConfig(**kw).stressed(10)


def test_stage4b_is_mailbox_config():
    _, cfg = both("stage4b")
    assert cfg == mailbox_config(128)
    full = mailbox_config()
    assert (full.n_groups, full.delay_lo, full.delay_hi, full.seed) == \
        (102_400, 1, 3, 5)
    slot_bytes = sum(getattr(init_state(mailbox_config(1), "cpu"), k).nbytes
                     for k in MAILBOX_FIELDS)
    assert slot_bytes * 102_400 == 102_400_000  # 13 planes, ~102 MB


@functools.lru_cache(maxsize=None)
def jax_run(name, ticks=TICKS):
    """The JAX reference from boot: (end state as numpy, per-tick trace
    stacks, recorder summary, finalized monitor as numpy)."""
    jc, _ = both(name)
    tick = jtick.make_tick(jc)
    mstep = jax.jit(jtel.monitor_step)
    st = jinit_state(jc)
    tel = jtel.telemetry_zeros()
    mon = jtel.monitor_init(jc.n_groups, ticks)
    ys = []
    for _ in range(ticks):
        nxt = tick(st)
        tel = jtel.telemetry_step(st, nxt, tel)
        mon = mstep(st, nxt, mon)
        ys.append({k: np.asarray(getattr(nxt, k)) for k in ttick.TRACE_FIELDS})
        st = nxt
    end = {k: np.asarray(getattr(st, k)) for k in FIELDS}
    end["tick"] = int(st.tick)
    return (end, {k: np.stack([y[k] for y in ys]) for k in ys[0]},
            jtel.summarize_telemetry(tel),
            {k: np.asarray(v) for k, v in
             jax.device_get(jtel.monitor_finalize(mon)).items()})


def assert_state_equal(got: dict, want: dict, what=""):
    for k in FIELDS:
        assert got[k].dtype == want[k].dtype, (what, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")
    assert int(got["tick"]) == int(want["tick"])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_make_run_equals_jax(name):
    jend, jys, jtelem, jmon = jax_run(name)
    _, cfg = both(name)
    end, ys, tel = ttick.make_run(cfg, TICKS, trace=True, telemetry=True,
                                  device="cpu")(init_state(cfg, "cpu"))
    assert_state_equal(state_to_numpy(end), jend, name)
    for k in jys:
        assert ys[k].numpy().dtype == jys[k].dtype, k
        np.testing.assert_array_equal(ys[k].numpy(), jys[k], err_msg=k)
    assert ttel.summarize_telemetry(tel) == jtelem
    # The run does what it exists for: slots in flight, elections, and
    # (delays of a tick or more) exchanges still in flight at the end.
    assert jtelem["mailbox_inflight_hw"] > 0
    assert jtelem["elections_started"] > 0 and jtelem["leader_changes"] > 0
    # The monitor, through the flat-carry runner (make_run has none).
    _, mon = make_cuda_scan(cfg, TICKS, monitor=True, aux_source="inkernel",
                            device="cpu")(init_state(cfg, "cpu"))
    assert set(mon) == set(jmon)
    for k in jmon:
        assert mon[k].numpy().dtype == jmon[k].dtype, k
        np.testing.assert_array_equal(mon[k].numpy(), jmon[k], err_msg=k)
    assert max(jmon["ring_inflight_hw"]) > 0


@functools.lru_cache(maxsize=None)
def port_run(name):
    _, cfg = both(name)
    end, _, tel = ttick.make_run(cfg, TICKS, trace=False, telemetry=True,
                                 device="cpu")(init_state(cfg, "cpu"))
    return state_to_numpy(end), ttel.summarize_telemetry(tel)


@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("aux_source", ["staged", "inkernel"])
def test_cuda_scan_on_cpu_equals_make_run(aux_source, T):
    """bench.py's stage-4b runner shape on the CPU (every launch its
    kernel's plain version): 30 ticks, so T=4 runs 7 fused launches and a
    2-tick remainder; the staged draw tables at the mailbox's reset bound."""
    want, wtel = port_run("stage4b")
    _, cfg = both("stage4b")
    end, tel = make_cuda_scan(cfg, TICKS, telemetry=True, fused_ticks=T,
                              aux_source=aux_source,
                              device="cpu")(init_state(cfg, "cpu"))
    assert_state_equal(state_to_numpy(end), want)
    assert ttel.summarize_telemetry(tel) == wtel


def test_tau0_mailbox_equals_the_synchronous_path():
    """τ=0 (mailbox=True at 0/0): every send is delivered in the same pair
    iteration, so the run equals the synchronous lattice's, traces and
    every core field (the pattern of tests/test_delay.py:71), and no slot
    is left in flight."""
    kw = dict(SOUP3, n_groups=24)
    sync = RaftConfig(**kw).stressed(10)
    mail = dataclasses.replace(sync, mailbox=True)
    s_end, s_ys = ttick.make_run(sync, 60, device="cpu")(
        init_state(sync, "cpu"))
    m_end, m_ys, m_tel = ttick.make_run(mail, 60, telemetry=True,
                                        device="cpu")(init_state(mail, "cpu"))
    for k in s_ys:
        assert torch.equal(s_ys[k], m_ys[k]), k
    for k in STATE_FIELDS:
        assert torch.equal(getattr(s_end, k), getattr(m_end, k)), k
    assert int(m_tel["mailbox_inflight_hw"]) == 0
    assert bool((m_end.vq_due == -1).all()) and bool((m_end.aq_due == -1).all())
    assert int(s_end.commit.max()) > 0  # replication really ran


def test_straggler_vote_mutates_peer_but_not_candidate():
    """Twin of tests/test_delay.py's straggler test: the candidate's round
    window (round_ticks=2) closes before its delay-4 requests deliver, so
    the round concludes while they are in flight. At delivery the peers
    still grant and adopt the term; the candidate's tally stays untouched
    (the rounds stamp no longer matches — cancelChildren). The port's run
    equals the scalar oracle's node state there."""
    delay = 4
    for seed in range(60):
        kw = dict(n_groups=1, n_nodes=3, log_capacity=8, seed=seed, el_lo=5,
                  el_hi=30, hb_ticks=4, round_ticks=2, retry_ticks=10,
                  bo_lo=40, bo_hi=40, delay_lo=delay, delay_hi=delay)
        g = OracleGroup(JConfig(**kw), group=0)
        lefts = sorted((n.el_left, n.id) for n in g.nodes)
        if lefts[1][0] - lefts[0][0] > delay + 3:
            break
    else:
        pytest.fail("no seed with a big enough timer gap")
    cid = lefts[0][1]
    ticks = g.nodes[cid - 1].el_left + 1 + delay + 1
    for _ in range(ticks):
        g.tick()
    cfg = RaftConfig(**kw)
    st = init_state(cfg, "cpu")
    ttick.make_run(cfg, ticks, trace=False, device="cpu")(st)
    c = cid - 1
    assert int(st.round_state[c, 0]) == BACKOFF
    assert int(st.role[c, 0]) == CANDIDATE
    peers = [n for n in range(3) if n != c]
    assert all(int(st.term[p, 0]) == 1 and int(st.voted_for[p, 0]) == cid
               for p in peers)
    assert int(st.responses[c, 0]) == 0 and int(st.votes[c, 0]) == 0
    for n in g.nodes:
        for k in ("term", "voted_for", "role", "round_state", "responses",
                  "votes"):
            assert int(getattr(st, k)[n.id - 1, 0]) == getattr(n, k), \
                (n.id, k)


def test_restart_clears_owned_slots():
    """Twin of tests/test_delay.py's restart test, on 16 groups through the
    tick's fault_cmd input: a node that owns an in-flight vote slot is
    crashed, then restarted; the restart clears every slot it owns (its
    sent requests died with the process) and the crash clears none. The
    port equals JAX's make_tick over the same driven ticks."""
    kw = dict(n_groups=16, n_nodes=3, log_capacity=8, seed=4, el_lo=3,
              el_hi=4, hb_ticks=3, round_ticks=6, retry_ticks=3, bo_lo=3,
              bo_hi=4, delay_lo=3, delay_hi=3)
    jc, cfg = JConfig(**kw), RaftConfig(**kw)
    st, js = init_state(cfg, "cpu"), jinit_state(jc)
    ptick, jtick_fn = ttick.make_tick(cfg, "cpu"), jtick.make_tick(jc)
    owner = None
    for _ in range(30):
        ptick(st)
        js = jtick_fn(js)
        busy = (st.vq_due[:, :, 0] >= 0).any(1)
        if bool(busy.any()):
            owner = int(busy.nonzero()[0, 0])
            break
    assert owner is not None, "no in-flight slot materialized"
    for cmd in (1, 2):  # crash, then restart, of the owner in group 0
        fc = np.zeros((16, 3), np.int32)
        fc[0, owner] = cmd
        before = st.vq_due[owner, :, 0].clone()
        ptick(st, fault_cmd=torch.from_numpy(fc))
        js = jtick_fn(js, fault_cmd=jnp.asarray(fc))
        if cmd == 1:
            assert not bool(st.up[owner, 0])
            # A crash leaves the owner's slots on the wire (they count down).
            assert bool(((st.vq_due[owner, :, 0] >= 0)
                         | (before <= 0)).all())
    assert bool(st.up[owner, 0])
    assert bool((st.vq_due[owner, :, 0] == -1).all())
    assert bool((st.aq_due[owner, :, 0] == -1).all())
    got = state_to_numpy(st)
    jn = jax.device_get(js)
    assert_state_equal(got, {**{k: np.asarray(getattr(jn, k))
                                for k in FIELDS}, "tick": int(jn.tick)})


@pytest.mark.parametrize("lo,hi", [(1, 3), (2, 5), (0, 3), (1, 1), (0, 0)])
@pytest.mark.parametrize("seed", [5, -7])
def test_delay_mask_equals_jax(seed, lo, hi):
    """The staged §10 draw and its in-kernel twin, bit for bit, at the
    pair lattice index; lo == hi is a constant, drawn nowhere."""
    shape = (37, 5, 5)
    for tick in (0, 1, 1234):
        want = np.asarray(jrng.delay_mask(jrng.base_key(seed), tick, shape,
                                          lo, hi))
        got = trng.delay_mask(trng.base_key(seed), tick, shape, lo, hi,
                              "cpu")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        if lo < hi:
            k0, k1 = trng.kt_key_words(trng.base_key(seed))
            idx = torch.arange(37 * 25, dtype=torch.int32).reshape(shape)
            np.testing.assert_array_equal(
                trng.kt_delay_mask(k0, k1, tick, idx, lo, hi).numpy(), want)
            jk0, jk1 = jrng.kt_key_words(jrng.base_key(seed))
            np.testing.assert_array_equal(np.asarray(jrng.kt_delay_mask(
                jk0, jk1, jnp.int32(tick), jnp.asarray(idx.numpy()), lo,
                hi)), want)


def test_delay_channels_equal_jax():
    """make_aux's delay plane, the in-kernel aux's and the stand-alone
    delay draw (plain on the CPU) are the JAX package's staged draw, in
    its flat (N*N, G) int16 layout; a fixed delay stages nothing."""
    jc, cfg = both("stage4b")
    st = init_state(cfg, "cpu")
    ttick.make_run(cfg, 12, trace=False, device="cpu")(st)
    base, tk, bk = ttick.make_rng(cfg, "cpu")
    aux, flags = ttick.make_aux(cfg, base, tk, bk, st)
    arrs = state_to_numpy(st)
    js = JState(**{k: jnp.asarray(arrs[k]) for k in FIELDS},
                tick=jnp.asarray(arrs["tick"], jnp.int32))
    jb, jt, jbk, _ = jtick.split_rng(jtick.make_rng(jc))
    jaux, _ = jtick.make_aux(jc, jb, jt, jbk, js, None, None)
    want = np.asarray(jaux["delay"])
    assert aux["delay"].dtype == torch.int16
    np.testing.assert_array_equal(aux["delay"].numpy(), want)
    stat = cuda_tick.inkernel_aux_statics(cfg, base, tk, bk)
    ops = cuda_tick.inkernel_aux_operands(stat, st.tick)
    kt = cuda_tick._kt_consts(cfg, (), ops["ktab"], ops["tkw"], ops["bkw"])
    np.testing.assert_array_equal(
        cuda_tick._kt_aux(cfg, flags, kt, ttick.flatten_state(cfg, st),
                          0)["delay"].numpy(), want)
    np.testing.assert_array_equal(
        cuda_tick.delay_draw(cfg, ops["ktab"]).numpy(), want)
    fixed = dataclasses.replace(cfg, delay_lo=2, delay_hi=2)
    aux2, _ = ttick.make_aux(fixed, base, tk, bk, init_state(fixed, "cpu"))
    assert "delay" not in aux2
    assert "delay" not in cuda_tick.fused_aux_names(fixed,
                                                    ttick.make_flags(fixed))
    assert "delay" in cuda_tick.fused_aux_names(cfg, flags)
    with pytest.raises(ValueError):
        cuda_tick.delay_draw(fixed, ops["ktab"])


def test_flags_bounds_and_snapshots():
    jc, cfg = both("stage4b")
    assert ttick.make_flags(cfg).delay and not ttick.make_flags(cfg).dyn_log
    tau0 = dataclasses.replace(cfg, delay_lo=0)
    assert cuda_tick.config_resets_bound(cfg) == 4 * 5
    assert cuda_tick.config_resets_bound(tau0) == 8 * 5 - 3
    snaps = cuda_tick.fused_snapshot_fields(cfg, telemetry=True, monitor=True)
    # The JAX package snapshots the two due planes; the port their count.
    from raft_kotlin_tpu.ops import pallas_tick as jpt
    jsnaps = jpt.fused_snapshot_fields(jc, telemetry=True, monitor=True)
    assert snaps == tuple(k for k in jsnaps if k not in ("vq_due", "aq_due")) \
        + (cuda_tick.INFLIGHT,)
    # The trace alone reads no slot.
    assert set(cuda_tick.fused_snapshot_fields(cfg, trace=True)) == \
        set(cuda_tick.FUSED_TRACE_FIELDS)
    # Held bit-equal over a run: the recorder and monitor read the count.
    st = init_state(cfg, "cpu")
    ttick.make_run(cfg, 25, trace=False, device="cpu")(st)
    flat = ttick.flatten_state(cfg, st)
    snap = ttel.mailbox_snapshot(flat)
    assert snap.shape == (2, cfg.n_groups) and int(snap[0].sum()) == int(
        (st.vq_due >= 0).sum() + (st.aq_due >= 0).sum()) > 0
    owners = (st.aq_due >= 0).any(1)  # (N, G)
    for n in range(cfg.n_nodes):
        assert torch.equal((snap[1] >> n) & 1 != 0, owners[n])
    assert bool(owners.any())


def test_monitor_stale_append_hazard_equals_jax():
    """The monitor's §10 hazard gate on forged views: an append slot in
    flight from a node that was no live leader masks the durability checks
    (a deposed leader's appends deliver late); one from a live leader, or a
    vote slot, does not. Every group breaks leader completeness; the
    port's verdicts, taints and monitor step equal JAX's."""
    N, C, G = 3, 4, 3
    lt = np.zeros((N, C, G), np.int32)
    lt[:, :2] = 1
    lc = np.zeros((N, C, G), np.int32)
    lc[:, 0], lc[:, 1] = 10, 11
    prev = {"role": np.zeros((N, G), np.int16), "up": np.ones((N, G), bool),
            "term": np.ones((N, G), np.int32),
            "commit": np.ones((N, G), np.int16),
            "last_index": np.full((N, G), 2, np.int16),
            "phys_len": np.full((N, G), 2, np.int16),
            "hb_armed": np.zeros((N, G), bool), "log_term": lt,
            "log_cmd": lc, "cap_ov": np.zeros((N, G), np.int16),
            "vq_due": np.full((N, N, G), -1, np.int16),
            "aq_due": np.full((N, N, G), -1, np.int16)}
    cur = {k: v.copy() for k, v in prev.items()}
    cur["role"][0] = 2  # LEADER, missing node 2's committed entry 2
    cur["log_term"][0, 1] = 5
    cur["commit"][1] = 2
    prev["aq_due"][1, 2, 0] = 1          # g0: a non-leader's append slot
    prev["aq_due"][0, 1, 1] = 0          # g1: a live leader's
    prev["role"][0, 1] = 2
    prev["vq_due"][1, 2, 2] = 1          # g2: a vote slot only
    cur["aq_due"][0, 1, 1] = 2

    def port(v):
        flat = {k: torch.from_numpy(a.reshape(-1, G) if a.ndim == 3 else a)
                for k, a in v.items()}
        return ttel.monitor_flat_view(flat, N)

    def jx(v):
        return {k: jnp.asarray(a) for k, a in v.items()}

    none = np.zeros(G, bool)
    want = jtel.invariant_matrix(jx(prev), jx(cur), jnp.asarray(none),
                                 jnp.asarray(none))
    got = ttel.invariant_matrix(port(prev), port(cur),
                                torch.from_numpy(none), torch.from_numpy(none))
    for g_, w in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w))
    lc_id = ttel.INVARIANT_IDS.index("leader_completeness")
    assert got[0][lc_id].tolist() == [False, True, True]
    jm = jtel.monitor_step_arrays(jx(prev), jx(cur), jtel.monitor_zeros(G))
    tm = ttel.monitor_step_arrays(port(prev), port(cur),
                                  ttel.monitor_zeros(G, device="cpu"))
    for k in jm:
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]),
                                      err_msg=k)
    assert int(tm["ring_inflight_hw"].max()) == 1


def test_unported_mailbox_combinations_raise():
    """The mailbox with §12 per-group delay windows on a deep log stays
    refused by every entry point (the windows on shallow logs are ported:
    tests/test_torch_scenario.py). The mailbox with §15 compaction runs on
    the plain lattice and on the tick kernels' plain versions, which agree
    (tests/test_torch_compaction_mailbox.py holds both to JAX). The
    mailbox on deep logs runs (tests/test_torch_deep_mailbox.py holds it
    to JAX): its batched engine equals its per-pair one, and the shallow
    tick kernels still refuse it."""
    deep = RaftConfig(n_groups=4, log_capacity=512, delay_lo=1, delay_hi=3)
    compact = RaftConfig(n_groups=4, compact_watermark=4, compact_chunk=2,
                         delay_lo=1, delay_hi=3)
    windows = RaftConfig(n_groups=4, log_capacity=512, delay_lo=1,
                         delay_hi=3, scenario=ScenarioSpec(delay_windows=True))
    for entry in (lambda: make_cuda_scan(windows, 2, device="cpu"),
                  lambda: cuda_tick.make_cuda_tick(windows, "cpu"),
                  lambda: init_state(windows, "cpu"),
                  lambda: ttick.make_run(windows, 2, device="cpu")):
        with pytest.raises(NotImplementedError):
            entry()
    end, _ = ttick.make_run(compact, 2, device="cpu")(
        init_state(compact, "cpu"))
    assert end.snap_index is not None and end.vq_due is not None
    scan = make_cuda_scan(compact, 2, device="cpu")(init_state(compact, "cpu"))
    one = cuda_tick.make_cuda_tick(compact, "cpu")
    st = init_state(compact, "cpu")
    for _ in range(2):
        one(st)
    for k in FIELDS:
        assert torch.equal(getattr(scan, k), getattr(end, k)), k
        assert torch.equal(getattr(st, k), getattr(end, k)), k
    ttick.check_flags(ttick.make_flags(deep))
    runs = [ttick.make_run(deep, 2, trace=True, batched=batched,
                           device="cpu")(init_state(deep, "cpu"))
            for batched in (None, False)]
    for k in FIELDS:
        assert torch.equal(getattr(runs[0][0], k), getattr(runs[1][0], k)), k
    for entry in (lambda: make_cuda_scan(deep, 2, device="cpu"),
                  lambda: cuda_tick.make_cuda_tick(deep, "cpu")):
        with pytest.raises(NotImplementedError):
            entry()


# The stage-4b soup is not clean: at 102,400 groups the monitor latches
# this invariant at tick 37, first in group 35,421 (chip_smoke.py step
# 10b). In this window a deposed leader's appends also deliver late: before
# the monitor took in-flight append slots into its hazard window, the port
# latched a tick earlier there and the JAX package did not.
MAILBOX_LATCH = ("leader_completeness@t37/g35421", 35_422, 38)


@pytest.mark.slow
def test_mailbox_soup_latch_matches_jax():
    """The JAX package's own monitor latches the stage-4b soup: its XLA
    make_run and the port's stage-4b runner (plain versions on the CPU),
    from tick 0 over the groups and ticks up to the first violation, agree
    in end state (every slot), recorder and monitor, and both latch it.
    Minutes on a CPU, hence slow."""
    status, groups, ticks = MAILBOX_LATCH
    jc = JConfig(**dict(CONFIGS["stage4b"], n_groups=groups)).stressed(10)
    cfg = mailbox_config(groups)
    jend, _, jtel_, jmon = jax.device_get(jtick.make_run(
        jc, ticks, trace=False, telemetry=True, monitor=True)(
            jinit_state(jc)))
    end, tel, mon = make_cuda_scan(cfg, ticks, telemetry=True, monitor=True,
                                   fused_ticks=4, aux_source="inkernel",
                                   device="cpu")(init_state(cfg, "cpu"))
    assert_state_equal(state_to_numpy(end), {
        **{k: np.asarray(getattr(jend, k)) for k in FIELDS},
        "tick": int(jend.tick)})
    assert ttel.summarize_telemetry(tel) == jtel.summarize_telemetry(jtel_)
    jfin = jtel.monitor_finalize(jmon)
    for k in jfin:
        np.testing.assert_array_equal(mon[k].numpy(), np.asarray(jfin[k]),
                                      err_msg=k)
    assert jtel.summarize_monitor(jmon)["inv_status"] == status
    assert ttel.summarize_monitor(mon)["inv_status"] == status


@pytest.mark.slow
def test_cuda_scan_on_cpu_equals_pallas_fused_mailbox():
    """The stage-4b runner shape at 8 three-node groups against the JAX
    package's make_pallas_scan in Pallas interpret mode, both aux forms
    (T=2, two launches), from a state with slots in flight: end state with
    every slot, recorder and monitor. Slow: interpreting the fused mailbox
    kernel is minutes of compile on a CPU."""
    kw = dict(SOUP3, n_groups=8, delay_lo=1, delay_hi=3)
    jcfg, cfg = JConfig(**kw).stressed(10), RaftConfig(**kw).stressed(10)
    st0 = init_state(cfg, "cpu")
    ttick.make_run(cfg, 30, trace=False, device="cpu")(st0)
    arrs = state_to_numpy(st0)
    assert int((st0.vq_due >= 0).sum() + (st0.aq_due >= 0).sum()) > 0
    for aux_source in ("staged", "inkernel"):
        js = JState(**{k: jnp.asarray(arrs[k]) for k in FIELDS},
                    tick=jnp.asarray(arrs["tick"], jnp.int32))
        jrun = jtick_pallas_scan(jcfg, aux_source)
        jend, jtel_, jmon = jax.device_get(jrun(js, jtick.make_rng(jcfg)))
        run = make_cuda_scan(cfg, 4, fused_ticks=2, aux_source=aux_source,
                             telemetry=True, monitor=True, device="cpu")
        end, tel, mon = run(state_from_numpy(arrs, "cpu"))
        assert_state_equal(state_to_numpy(end), {
            **{k: np.asarray(getattr(jend, k)) for k in FIELDS},
            "tick": int(jend.tick)}, aux_source)
        assert {k: int(v) for k, v in tel.items()} == \
            {k: int(v) for k, v in jtel_.items()}
        for k, v in jmon.items():
            np.testing.assert_array_equal(mon[k].numpy(), np.asarray(v),
                                          err_msg=k)


def jtick_pallas_scan(jcfg, aux_source):
    from raft_kotlin_tpu.ops import pallas_tick as jpt
    return jpt.make_pallas_scan(jcfg, 4, interpret=True, fused_ticks=2,
                                aux_source=aux_source, telemetry=True,
                                monitor=True)


@pytest.mark.slow
def test_long_run_equals_jax_make_run():
    """200 ticks of the three-node [2, 5] soup against the JAX package's
    jitted make_run (trace, end state with every slot, recorder, monitor):
    commits, restarts and straggler rounds pile up. Slow: the XLA:CPU
    compile of the mailbox scan is about a minute."""
    jc, cfg = both("n3_d25")
    jend, jys, jtel_, jmon = jax.device_get(jtick.make_run(
        jc, 200, trace=True, telemetry=True, monitor=True)(jinit_state(jc)))
    end, ys, tel = ttick.make_run(cfg, 200, trace=True, telemetry=True,
                                  device="cpu")(init_state(cfg, "cpu"))
    assert_state_equal(state_to_numpy(end), {
        **{k: np.asarray(getattr(jend, k)) for k in FIELDS},
        "tick": int(jend.tick)})
    for k in jys:
        np.testing.assert_array_equal(ys[k].numpy(), np.asarray(jys[k]),
                                      err_msg=k)
    assert ttel.summarize_telemetry(tel) == jtel.summarize_telemetry(jtel_)
    _, mon = make_cuda_scan(cfg, 200, monitor=True, fused_ticks=4,
                            aux_source="inkernel",
                            device="cpu")(init_state(cfg, "cpu"))
    for k, v in jtel.monitor_finalize(jmon).items():
        np.testing.assert_array_equal(mon[k].numpy(), np.asarray(v),
                                      err_msg=k)
    assert int(end.commit.max()) > 0
