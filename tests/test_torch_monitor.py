"""The port's safety-invariant monitor (raft_kotlin_tpu_torch/utils/
telemetry.py, base channel) against the JAX package's, on the CPU, at
tolerance zero:

- invariant_matrix and monitor_step_arrays on forged pre/post views that
  break each of invariants 0-5, and that exercise the restart-taint,
  unsafe-commit-taint and stale-append-hazard gates (a clean run alone
  would leave the equality vacuous);
- monitor_step_arrays over 40 transitions of a real run of the headline
  soup, and summarize_monitor on the result (the history ring wraps);
- the refusal of the channels the port does not carry.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_kotlin_tpu.utils import telemetry as jtel
from raft_kotlin_tpu_torch.constants import LEADER
from raft_kotlin_tpu_torch.models.state import init_state
from raft_kotlin_tpu_torch.ops import tick as ttick
from raft_kotlin_tpu_torch.utils import telemetry as ttel
from raft_kotlin_tpu_torch.utils.config import RaftConfig

N, C = 3, 4
# Group -> what its forged transition breaks (or exempts).
FORGED = ("election_safety", "leader_append_only", "log_matching",
          "leader_completeness", "commit_monotonic", "committed_prefix",
          "restart_gate", "hazard_gate", "unsafe_taint")
G = len(FORGED)


def base_view() -> dict:
    """Every node a live follower of term 1 with the same two-entry log,
    entry 1 committed."""
    lt = np.zeros((N, C, G), np.int32)
    lc = np.zeros((N, C, G), np.int32)
    lt[:, :2] = 1
    lc[:, 0], lc[:, 1] = 10, 11
    return {
        "role": np.zeros((N, G), np.int16), "up": np.ones((N, G), bool),
        "term": np.ones((N, G), np.int32),
        "commit": np.ones((N, G), np.int16),
        "last_index": np.full((N, G), 2, np.int16),
        "phys_len": np.full((N, G), 2, np.int16),
        "hb_armed": np.zeros((N, G), bool), "log_term": lt, "log_cmd": lc,
        "cap_ov": np.zeros((N, G), np.int16),
    }


def forged_views():
    prev = base_view()
    cur = copy.deepcopy(prev)
    g = {name: i for i, name in enumerate(FORGED)}
    # 0: two live leaders of one term.
    for v in (cur,):
        v["role"][0, g["election_safety"]] = LEADER
        v["role"][1, g["election_safety"]] = LEADER
    # 1: a continuing same-term leader rewrites a readable slot.
    for v in (prev, cur):
        v["role"][0, g["leader_append_only"]] = LEADER
    cur["log_cmd"][0, 1, g["leader_append_only"]] = 99
    # 2: same (index, term) on two pristine logs, different prefixes.
    cur["log_cmd"][1, 1, g["log_matching"]] = 77
    # 3: a leader missing a follower's committed entry.
    cur["role"][0, g["leader_completeness"]] = LEADER
    cur["log_term"][0, 1, g["leader_completeness"]] = 5
    cur["commit"][1, g["leader_completeness"]] = 2
    # 4: the group commit frontier goes back.
    prev["commit"][1, g["commit_monotonic"]] = 3
    # 5: a committed entry's content changes.
    cur["log_cmd"][2, 0, g["committed_prefix"]] = 55
    # Gates: the two-leader split with a node restarting this tick ...
    cur["role"][0, g["restart_gate"]] = LEADER
    cur["role"][1, g["restart_gate"]] = LEADER
    prev["up"][2, g["restart_gate"]] = False
    # ... a committed rewrite while a non-leader heartbeat is armed ...
    cur["log_cmd"][2, 0, g["hazard_gate"]] = 55
    prev["hb_armed"][1, g["hazard_gate"]] = True
    # ... and a leader committing over an old-term entry (Figure 8).
    for v in (prev, cur):
        v["role"][0, g["unsafe_taint"]] = LEADER
        v["term"][0, g["unsafe_taint"]] = 5
        v["log_term"][0, :2, g["unsafe_taint"]] = 3
    cur["commit"][0, g["unsafe_taint"]] = 2
    return prev, cur


def to_jax(v: dict) -> dict:
    return {k: jnp.asarray(a) for k, a in v.items()}


def to_torch(v: dict) -> dict:
    return {k: torch.from_numpy(np.array(a)) for k, a in v.items()}


def assert_carry_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("taints", ["clear", "set"])
def test_invariant_matrix_on_forged_violations(taints):
    prev, cur = forged_views()
    tr = np.zeros(G, bool)
    tu = np.zeros(G, bool)
    if taints == "set":
        tr[::3] = True
        tu[1::3] = True
    want = jtel.invariant_matrix(to_jax(prev), to_jax(cur), jnp.asarray(tr),
                                 jnp.asarray(tu))
    got = ttel.invariant_matrix(to_torch(prev), to_torch(cur),
                                torch.from_numpy(tr), torch.from_numpy(tu))
    for g_, w in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w))
    V, tr2, tu2 = (x.numpy() for x in got)
    if taints == "clear":
        # Each of invariants 0-5 fires where it was forged ...
        for i, name in enumerate(ttel.INVARIANT_IDS[:6]):
            assert V[i, FORGED.index(name)], name
        # ... and the gates hold.
        assert tr2[FORGED.index("restart_gate")]
        assert not V[0, FORGED.index("restart_gate")]
        assert not V[5, FORGED.index("hazard_gate")]
        assert tu2[FORGED.index("unsafe_taint")]
    assert ttel.INVARIANT_IDS == jtel.INVARIANT_IDS


def test_monitor_step_on_forged_violations():
    prev, cur = forged_views()
    want = jtel.monitor_step_arrays(to_jax(prev), to_jax(cur),
                                    jtel.monitor_zeros(G, 3))
    got = ttel.monitor_step_arrays(to_torch(prev), to_torch(cur),
                                   ttel.monitor_zeros(G, 3, device="cpu"))
    assert_carry_equal(got, want)
    assert int(got["latch_tick"]) == 0 and int(got["viol_total"]) > 6
    # A second step from the violating state latches nothing new.
    want2 = jtel.monitor_step_arrays(to_jax(cur), to_jax(cur), want)
    got2 = ttel.monitor_step_arrays(to_torch(cur), to_torch(cur), got)
    assert_carry_equal(got2, want2)
    assert_carry_equal(ttel.monitor_finalize(got2),
                       jtel.monitor_finalize(want2))


def run_views(ticks=40, start=12):
    """Monitor views of `ticks` + 1 consecutive states of the headline soup
    at 24 groups, from tick `start`."""
    cfg = RaftConfig(n_groups=24, n_nodes=5, log_capacity=16, cmd_period=4,
                     p_drop=0.2, p_crash=0.02, p_restart=0.1,
                     p_link_fail=0.02, p_link_heal=0.08, seed=3).stressed(10)
    st = init_state(cfg, "cpu")
    step = ttick.make_tick(cfg, "cpu")
    views = []
    for t in range(start + ticks + 1):
        if t >= start:
            views.append({k: v.numpy() for k, v in
                          ttel.monitor_view(st, clone=True).items()})
        step(st)
    return views


def test_monitor_over_a_run_and_summary():
    views = run_views()
    jstep = jax.jit(jtel.monitor_step_arrays)
    jm = jtel.monitor_zeros(24, 1)
    tm = ttel.monitor_zeros(24, 1, device="cpu")
    for a, b in zip(views, views[1:]):
        jm = jstep(to_jax(a), to_jax(b), jm)
        tm = ttel.monitor_step_arrays(to_torch(a), to_torch(b), tm)
    assert_carry_equal(tm, jax.device_get(jm))
    want = jtel.summarize_monitor(jm)
    got = ttel.summarize_monitor(tm)
    assert got == want
    # The run exercised the monitor: restarts tainted groups, leaders rose,
    # and 40 one-tick windows wrapped the 32-window ring.
    assert got["taint_restart_groups"] > 0 and len(got["ring"]) == 32
    assert max(w["leaders"] for w in got["ring"]) > 0
    stats = {k: int(v) for k, v in ttel.monitor_scalars(tm).items()}
    jstats = {k: int(v) for k, v in jtel.monitor_scalars(jm).items()}
    assert stats == jstats
    assert ttel.status_from_scalars(stats) == \
        jtel.status_from_scalars(jstats) == got["inv_status"]


def test_monitor_init_refuses_unported_channels():
    assert ttel.monitor_init(4, 10, enabled=False) is None
    m = ttel.monitor_init(4, 100, device="cpu")
    assert int(m["ring_stride"]) == ttel.monitor_ring_stride(100) == \
        jtel.monitor_ring_stride(100)
    for kw in (dict(timing=True), dict(sched=True), dict(series=4),
               dict(events=8)):
        with pytest.raises(NotImplementedError):
            ttel.monitor_init(4, 10, device="cpu", **kw)
    # The per-group channel is ported: the JAX package's keys and shapes.
    got = ttel.monitor_init(4, 10, per_group=True, device="cpu")
    want = jtel.monitor_init(4, 10, per_group=True)
    assert set(got) == set(want)
    for k in ttel.PER_GROUP_KEYS:
        assert tuple(got[k].shape) == tuple(want[k].shape) == (4,)
