"""The fused kernel's in-kernel observers, in their plain form, on the CPU:
the per-tick per-group rows (utils/telemetry.obs_tick_rows, computed
inside ops/cuda_tick.fused_tick_plain(obs=...), the wrapper's CPU path) and
the fold of a launch's rows into the carry (telemetry.fold_obs_rows),
held at tolerance zero (integers) against the host replay they replace
(ops/cuda_tick.fused_observe over per-tick snapshots) and, on one forged
transition, against the JAX package's monitor_step_arrays:

- T=4 launches at the headline, mailbox and farm shapes from states forged
  into chaos (extra leaders, rewritten and committed entries moved), so
  that every invariant and both taints are exercised;
- a launch whose latch falls in its second tick, with a ring window that
  starts inside the launch;
- the §10 stale-append hazard across a launch boundary;
- the write tracking of invariants 1 and 5 on a planted tick in which one
  slot is written twice (ending at its start value) and another written
  back with its old value;
- make_cuda_scan's routes: a run whose fused launches observe in the
  kernel and whose staged remainder replays equals the all-replay run, and
  its launches store no per-tick snapshot.

The kernel itself is held to this plain form on the card
(tests/test_torch_cuda_observers.py, chip_smoke.py).
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_kotlin_tpu.utils import telemetry as jtel
from raft_kotlin_tpu_torch.api import fuzz
from raft_kotlin_tpu_torch.constants import LEADER
from raft_kotlin_tpu_torch.models.state import init_state
from raft_kotlin_tpu_torch.ops import cuda_scan, cuda_tick
from raft_kotlin_tpu_torch.ops import tick as ttick
from raft_kotlin_tpu_torch.utils import telemetry as ttel
from raft_kotlin_tpu_torch.utils.config import (
    RaftConfig, headline_config, mailbox_config)

G = 32


def forge_chaos(cfg, st, seed):
    """Chaos in a third of the groups, drawn from `seed` with numpy: nodes
    made leaders with a due heartbeat (some with a moved term), log entries
    rewritten, commits moved, nodes taken down or up, next_index moved."""
    r = np.random.default_rng(seed)
    N = cfg.n_nodes
    for g in r.choice(cfg.n_groups, cfg.n_groups // 3, replace=False):
        for n in r.choice(N, r.integers(1, N), replace=False):
            k = r.integers(0, 6)
            li = int(st.last_index[n, g])
            if k <= 1:
                if k == 1:
                    st.term[n, g] = int(st.term[:, g].max()) \
                        + int(r.integers(-1, 2))
                st.role[n, g] = LEADER
                st.hb_armed[n, g] = True
                st.hb_left[n, g] = 0
            elif k == 2 and li > 0:
                x = int(r.integers(0, li))
                st.log_cmd[n, x, g] = int(r.integers(0, 50))
                if r.random() < 0.5:
                    st.log_term[n, x, g] = int(st.log_term[n, x, g]) + 1
            elif k == 3:
                st.commit[n, g] = int(r.integers(0, li + 2))
            elif k == 4:
                st.up[n, g] = not bool(st.up[n, g])
            elif k == 5:
                st.next_index[n, :, g] = torch.from_numpy(
                    r.integers(0, li + 2, N).astype(np.int16))


# (config, per-group monitor, forge seed): each seed's launches latch
# invariants 0 and 3 (the farm's: 3) and set both taints.
CONFIGS = {"headline": (lambda: headline_config(G), False, 4),
           "mailbox": (lambda: mailbox_config(G), False, 4),
           "farm": (lambda: fuzz.smoke_config(G), True, 5)}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_observer_rows_equal_the_replay(name):
    """Three T=4 launches from a forged state: the plain form's rows,
    folded, equal fused_observe over the launches' snapshots in recorder
    and monitor carry (latch, counts, ring, taints, per-group counters),
    and the two runs' states are equal."""
    make, per_group, seed = CONFIGS[name]
    cfg = make()
    st = init_state(cfg, "cpu")
    cuda_scan.make_cuda_scan(cfg, 12, fused_ticks=1, aux_source="inkernel",
                             device="cpu")(st)
    forge_chaos(cfg, st, seed)
    flags = ttick.make_flags(cfg)
    rng = ttick.make_rng(cfg, "cpu")
    stat = cuda_tick.inkernel_aux_statics(cfg, *ttick.split_rng(rng))
    snap = cuda_tick.fused_snapshot_fields(cfg, telemetry=True, monitor=True,
                                           per_group=per_group)
    a, b = st.clone(), st.clone()
    sa, sb = ttick.flatten_state(cfg, a), ttick.flatten_state(cfg, b)
    tel_a, tel_b = ttel.telemetry_zeros("cpu"), ttel.telemetry_zeros("cpu")
    mon_a = ttel.monitor_zeros(G, 3, per_group=per_group, device="cpu")
    mon_b = ttel.monitor_zeros(G, 3, per_group=per_group, device="cpu")
    prev = {k: ttel.mailbox_snapshot(sb) if k == cuda_tick.INFLIGHT
            else sb[k].clone() for k in snap}
    for i in range(3):
        ops = cuda_tick.inkernel_aux_operands(stat, st.tick + 4 * i)
        obs = cuda_tick.kernel_observers(mon_a)
        cuda_tick.fused_tick_plain(cfg, sa, 4, flags, "inkernel", ops,
                                   obs=obs)
        tel_a, mon_a = ttel.fold_obs_rows(obs.rows, tel_a, mon_a)
        _, snaps = cuda_tick.fused_tick_plain(cfg, sb, 4, flags, "inkernel",
                                              ops, snap)
        ticks = cuda_tick.unpack_fused_outputs(snaps, 4)
        tel_b, mon_b = cuda_tick.fused_observe(cfg, prev, ticks, tel_b,
                                               mon_b)
        prev = ticks[-1]
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    for got, want in ((tel_a, tel_b), (mon_a, mon_b)):
        assert set(got) == set(want)
        bad = [k for k in want if not torch.equal(got[k], want[k])]
        assert not bad, bad
    assert int(mon_a["viol_by_inv"][3]) > 0 and int(mon_a["latch_tick"]) >= 0
    assert int(mon_a["taint_restart"].sum()) > 0


# -- forged views: the fold and the rows against monitor_step_arrays --------

NF, CF = 3, 4


def base_view(groups):
    """Live followers of term 1 sharing a two-entry log, entry 1 committed;
    the recorder's fields at rest."""
    lt = np.zeros((NF * CF, groups), np.int32)
    lc = np.zeros((NF * CF, groups), np.int32)
    for n in range(NF):
        lt[n * CF:n * CF + 2] = 1
        lc[n * CF], lc[n * CF + 1] = 10, 11
    z = np.zeros((NF, groups), np.int16)
    return {"role": z.copy(), "up": np.ones((NF, groups), bool),
            "term": np.ones((NF, groups), np.int32), "commit": z + 1,
            "last_index": z + 2, "phys_len": z + 2,
            "hb_armed": np.zeros((NF, groups), bool), "log_term": lt,
            "log_cmd": lc, "cap_ov": z.copy(), "votes": z.copy(),
            "rounds": np.zeros((NF, groups), np.int32),
            "next_index": np.full((NF * NF, groups), 3, np.int16),
            "match_index": np.zeros((NF * NF, groups), np.int16)}


def forge(v, g, what):
    """Break (or gate) group g of view `v` in place, as the JAX package's
    monitor tests forge each invariant."""
    if what == "two_leaders":
        v["role"][0, g] = v["role"][1, g] = LEADER
    elif what == "rewrite_committed":
        v["log_cmd"][2 * CF, g] = 55
    elif what == "log_mismatch":
        v["log_cmd"][1 * CF + 1, g] = 77
    elif what == "frontier_back":
        v["commit"][:, g] = 0


def torch_view(v):
    out = {k: torch.from_numpy(np.array(a)) for k, a in v.items()}
    return out


def monitor_view(v):
    """The replay's view: logs (N, C, G), pair grids as flat (N*N, G)."""
    out = torch_view(v)
    for k in ("log_term", "log_cmd"):
        out[k] = out[k].reshape(NF, CF, -1)
    return out


def diff_masks(prev, cur):
    """The write tracking a tick that wrote exactly the slots that differ
    would leave."""
    ch = torch.from_numpy((prev["log_term"] != cur["log_term"])
                          | (prev["log_cmd"] != cur["log_cmd"]))
    return ch, ch


def rows_and_steps(seq, mon0, owners=None):
    """The launch's rows over the view sequence `seq` (its ticks' pre- and
    post-views), folded into `mon0`, and monitor_step_arrays over the same
    transitions."""
    groups = seq[0]["up"].shape[-1]
    mon_k = {k: v.clone() for k, v in mon0.items()}
    rows = []
    for pre, cur in zip(seq, seq[1:]):
        w, c = diff_masks(pre, cur)
        rows.append(ttel.obs_tick_rows(
            torch_view(pre), torch_view(cur), w, c, owners, None,
            {k: mon_k[k] for k in ("taint_restart", "taint_unsafe")}, True))
    _, folded = ttel.fold_obs_rows(torch.stack(rows), None, mon_k)
    mon_r = mon0
    for pre, cur in zip(seq, seq[1:]):
        mon_r = ttel.monitor_step_arrays(monitor_view(pre), monitor_view(cur),
                                         mon_r)
    assert groups == mon0["taint_restart"].shape[0]
    return folded, mon_r


def assert_same(got, want):
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    assert not bad, bad


def test_fold_latch_in_second_tick_and_ring_window_inside_launch():
    """A T=4 launch from monitor tick 2 with ring stride 3: tick 2 clean,
    the violations from tick 3 (the launch's second tick, which enters a
    ring window) on — the latch, the counts and every ring slot as four
    monitor_step_arrays calls leave them."""
    groups = 5
    clean = base_view(groups)
    bad = copy.deepcopy(clean)
    forge(bad, 3, "two_leaders")
    forge(bad, 1, "log_mismatch")
    worse = copy.deepcopy(bad)
    forge(worse, 4, "frontier_back")
    seq = [clean, clean, bad, worse, worse]
    mon0 = ttel.monitor_zeros(groups, 3, windows=4, device="cpu")
    # Two clean ticks first, so the launch starts at monitor tick 2.
    _, mon0 = rows_and_steps([clean, clean, clean], mon0)
    folded, stepped = rows_and_steps(seq, mon0)
    assert_same(folded, stepped)
    assert int(folded["latch_tick"]) == 3
    assert (int(folded["latch_group"]), int(folded["latch_inv"])) == (1, 2)
    assert int(folded["ring_violations"][1]) > 0


def test_hazard_across_a_launch_boundary():
    """A committed rewrite under a deposed leader's append in flight: the
    append owners the kernel takes at a launch's start (from the due
    planes) gate invariant 5 as the replay's pre-tick in-flight row does —
    and a mailbox launch's owners at load equal the last tick's row of the
    launch before."""
    groups = 2
    prev = base_view(groups)
    cur = copy.deepcopy(prev)
    forge(cur, 0, "rewrite_committed")
    forge(cur, 1, "rewrite_committed")
    owners = torch.tensor([1 << 1, 0], dtype=torch.int32)  # node 1, group 0
    pv, cv = monitor_view(prev), monitor_view(cur)
    pv["aq_inflight"] = ((owners[None] >> torch.arange(NF)[:, None]) & 1) != 0
    want = ttel.monitor_step_arrays(pv, cv, ttel.monitor_zeros(
        groups, device="cpu"))
    mon = ttel.monitor_zeros(groups, device="cpu")
    w, c = diff_masks(prev, cur)
    row = ttel.obs_tick_rows(torch_view(prev), torch_view(cur), w, c, owners,
                             None, {k: mon[k] for k in ("taint_restart",
                                                        "taint_unsafe")},
                             True)
    _, got = ttel.fold_obs_rows(row[None], None, mon)
    assert_same(got, want)
    # Group 0's rewrite is under the hazard, group 1's is not.
    assert int(got["viol_by_inv"][5]) == 1
    free = ttel.obs_tick_rows(torch_view(prev), torch_view(cur), w, c, None,
                              None, {}, True)
    assert int(free[ttel.OBS_VIOL + 5]) == 2

    cfg = mailbox_config(16)
    st = init_state(cfg, "cpu")
    cuda_scan.make_cuda_scan(cfg, WARM_MAIL, fused_ticks=1,
                             aux_source="inkernel", device="cpu")(st)
    s = ttick.flatten_state(cfg, st)
    rng = ttick.make_rng(cfg, "cpu")
    stat = cuda_tick.inkernel_aux_statics(cfg, *ttick.split_rng(rng))
    _, snaps = cuda_tick.fused_tick_plain(
        cfg, s, 3, ttick.make_flags(cfg), "inkernel",
        cuda_tick.inkernel_aux_operands(stat, st.tick), (cuda_tick.INFLIGHT,))
    at_load = ttel.mailbox_snapshot(s)[1]
    assert torch.equal(at_load, snaps[cuda_tick.INFLIGHT][-1][1])
    assert int(at_load.ne(0).sum()) > 0


# Ticks of the mailbox soup at 16 groups before appends are in flight.
WARM_MAIL = 40


def planted_state():
    """Three three-node groups on a drop-free config, every node holding
    [(1, 10), (1, 11)] committed, and leaders whose heartbeats are due this
    tick, each with its own entry at index 2:

    - group 0: leader 0 (term 2, entry (2, 20) at index 2) and leader 1
      (term 3, entry (1, 11)) both overwrite the follower's slot 1 in one
      tick, the second back to its start value (the link between the two
      leaders is down, so each sends its own entry and keeps its log);
    - group 1: leader 0 (term 2) writes (1, 11) over slot 1: its old value;
    - group 2: leader 0 alone writes (2, 20) over slot 1: a change."""
    cfg = RaftConfig(n_groups=3, n_nodes=3, log_capacity=4, seed=1)
    st = init_state(cfg, "cpu")
    st.term[:] = 1
    st.last_index[:] = 2
    st.phys_len[:] = 2
    st.commit[:] = 2
    st.log_term[:, :2] = 1
    st.log_cmd[:, 0] = 10
    st.log_cmd[:, 1] = 11
    st.el_left[:] = 50
    lead = {0: ((0, 2, 20), (1, 1, 11)), 1: ((0, 1, 11),), 2: ((0, 2, 20),)}
    for g, leaders in lead.items():
        for n, et, ec in leaders:
            st.role[n, g] = LEADER
            st.term[n, g] = 2 if n == 0 else 3
            st.log_term[n, 1, g] = et
            st.log_cmd[n, 1, g] = ec
            st.hb_armed[n, g] = True
            st.hb_left[n, g] = 0
            st.next_index[n, :, g] = 2
    st.link_up[0, 1, 0] = st.link_up[1, 0, 0] = False
    return cfg, st


def test_write_tracking_of_a_planted_rewrite():
    """One tick of the planted state: the tracking's changed mask equals
    the full comparison of the tick's two logs (slot 1 of the follower
    written twice in group 0, written back in group 1, changed in group 2),
    and the rows' invariants 1 and 5, folded, equal monitor_step_arrays
    over the pre- and post-tick logs."""
    cfg, st = planted_state()
    N, C = 3, 4
    s = ttick.flatten_state(cfg, st)
    pre = {k: v.clone() for k, v in s.items()}
    base, tk, bk, scen = ttick.split_rng(ttick.make_rng(cfg, "cpu"))
    aux, flags = ttick.make_aux(cfg, base, tk, bk, st, scen=scen)
    track = {k: torch.zeros((N * C, 3), dtype=dt) for k, dt in (
        ("written", torch.bool), ("changed", torch.bool),
        ("start_term", torch.int32), ("start_cmd", torch.int32))}
    ttick.phase_body(cfg, s, aux, flags, track=track)
    full = (pre["log_term"] != s["log_term"]) | (pre["log_cmd"] != s["log_cmd"])
    row = 2 * C + 1  # the follower's slot 1
    assert track["written"][row].tolist() == [True, True, True]
    assert track["changed"][row].tolist() == [False, False, True]
    assert torch.equal(track["changed"], full)
    view = cuda_tick.OBS_VIEW + ("log_term", "log_cmd", "phys_len")
    mon = ttel.monitor_zeros(3, device="cpu")
    carry = {k: mon[k] for k in ("taint_restart", "taint_unsafe")}
    r = ttel.obs_tick_rows({k: pre[k] for k in view}, {k: s[k] for k in view},
                           track["written"], track["changed"], None, None,
                           carry, True)
    _, got = ttel.fold_obs_rows(r[None], None, mon)
    want = ttel.monitor_step_arrays(
        ttel.monitor_flat_view(pre, N), ttel.monitor_flat_view(s, N),
        ttel.monitor_zeros(3, device="cpu"))
    assert_same(got, want)
    # Invariant 5 in group 2 alone (group 0's two leaders break
    # invariant 3: the term-2 leader lacks the committed entry).
    assert got["viol_by_inv"].tolist() == [0, 0, 0, 1, 0, 1, 0]


def test_observer_rows_match_the_jax_monitor():
    """One forged transition (two leaders, a log mismatch, a committed
    rewrite, the frontier going back) through the rows and the fold equals
    the JAX package's monitor_step_arrays, through numpy."""
    groups = 5
    prev = base_view(groups)
    cur = copy.deepcopy(prev)
    for g, what in enumerate(("two_leaders", "log_mismatch",
                              "rewrite_committed", "frontier_back")):
        forge(cur, g, what)
    mon = ttel.monitor_zeros(groups, 2, device="cpu")
    w, c = diff_masks(prev, cur)
    row = ttel.obs_tick_rows(torch_view(prev), torch_view(cur), w, c, None,
                             None, {k: mon[k] for k in ("taint_restart",
                                                        "taint_unsafe")},
                             True)
    _, got = ttel.fold_obs_rows(row[None], None, mon)

    def jview(v):
        out = {k: jnp.asarray(a) for k, a in v.items()}
        for k in ("log_term", "log_cmd"):
            out[k] = out[k].reshape(NF, CF, -1)
        return out
    want = jtel.monitor_step_arrays(jview(prev), jview(cur),
                                    jtel.monitor_zeros(groups, 2))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert int(got["viol_total"]) >= 4


def test_scan_routes_and_no_snapshots(monkeypatch):
    """make_cuda_scan over 10 ticks from a forged state, staged aux at T=4
    (two fused launches observed in the kernel's plain form, then two
    one-tick launches replayed on the same carry) and at T=1 (all
    replayed): equal end state, recorder and monitor; the fused launches
    ask for no snapshot."""
    cfg = headline_config(G)
    st = init_state(cfg, "cpu")
    cuda_scan.make_cuda_scan(cfg, 12, fused_ticks=1, aux_source="inkernel",
                             device="cpu")(st)
    forge_chaos(cfg, st, 4)
    seen = []
    real = cuda_tick.fused_tick_kernel

    def spy(*a, **kw):
        seen.append((a[6] if len(a) > 6 else kw.get("snap_fields", ()),
                     kw.get("obs")))
        return real(*a, **kw)
    monkeypatch.setattr(cuda_tick, "fused_tick_kernel", spy)
    outs = {}
    for T in (4, 1):
        run = cuda_scan.make_cuda_scan(cfg, 10, fused_ticks=T,
                                       aux_source="staged", telemetry=True,
                                       monitor=True, device="cpu")
        outs[T] = run(st.clone())
    assert len(seen) == 2 and all(sf == () and ob is not None
                                  for sf, ob in seen)
    (e4, t4, m4), (e1, t1, m1) = outs[4], outs[1]
    assert all(torch.equal(getattr(e4, k), getattr(e1, k)) for k in e4.fields())
    assert_same(t4, t1)
    assert_same(m4, m1)
    assert int(m4["viol_total"]) > 0
