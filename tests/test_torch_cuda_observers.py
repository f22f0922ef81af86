"""The fused kernel's observer build (raft_kotlin_tpu_torch/ops/csrc/
fused_tick_kernel.cu, RAFT_OBSERVE=1: the flight recorder and the safety
monitor computed inside the launch) against its plain versions on the card,
at tolerance zero (integers):

- from states forged into chaos (extra leaders, rewritten entries, moved
  commits) at a ragged group count, so the last block has idle threads:
  each launch's rows and per-group carry equal the plain form's
  (ops/cuda_tick.fused_tick_plain(obs=...)), and the folded recorder and
  monitor equal the host replay of the plain route (fused_tick_plain's
  snapshots + fused_observe) — headline (staged and in-kernel aux),
  mailbox, farm (per-group counters) and the packed layout;
- the planted tick of tests/test_torch_kernel_observers.py (one slot
  written twice, back to its start value; one written back with its old
  value) through the kernel's write tracking;
- make_cuda_scan with observers and no trace: every fused launch observes
  in the kernel and no snapshot byte is allocated.

The kernel has no CPU mode, so every test here needs the card and skips
without one. The card's machine has no JAX; run them there with
`python -m pytest --noconftest -m cuda tests/test_torch_cuda_observers.py`.
"""

import numpy as np
import pytest
import torch

from raft_kotlin_tpu_torch.api import fuzz
from raft_kotlin_tpu_torch.constants import LEADER
from raft_kotlin_tpu_torch.models.state import (
    init_state, pack_state, unpack_state)
from raft_kotlin_tpu_torch.ops import cuda_scan, cuda_tick
from raft_kotlin_tpu_torch.ops import tick as ttick
from raft_kotlin_tpu_torch.utils import telemetry as ttel
from raft_kotlin_tpu_torch.utils.config import (
    RaftConfig, headline_config, mailbox_config)

G = 4099


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")


def forge_chaos(cfg, st, seed):
    """tests/test_torch_kernel_observers.py's forge, on a state anywhere."""
    r = np.random.default_rng(seed)
    N = cfg.n_nodes
    host = {k: getattr(st, k).cpu() for k in (
        "term", "role", "hb_armed", "hb_left", "last_index", "log_cmd",
        "log_term", "commit", "up", "next_index")}
    for g in r.choice(cfg.n_groups, cfg.n_groups // 3, replace=False):
        for n in r.choice(N, r.integers(1, N), replace=False):
            k = r.integers(0, 6)
            li = int(host["last_index"][n, g])
            if k <= 1:
                if k == 1:
                    host["term"][n, g] = int(host["term"][:, g].max()) \
                        + int(r.integers(-1, 2))
                host["role"][n, g] = LEADER
                host["hb_armed"][n, g] = True
                host["hb_left"][n, g] = 0
            elif k == 2 and li > 0:
                x = int(r.integers(0, li))
                host["log_cmd"][n, x, g] = int(r.integers(0, 50))
                if r.random() < 0.5:
                    host["log_term"][n, x, g] += 1
            elif k == 3:
                host["commit"][n, g] = int(r.integers(0, li + 2))
            elif k == 4:
                host["up"][n, g] = not bool(host["up"][n, g])
            elif k == 5:
                host["next_index"][n, :, g] = torch.from_numpy(
                    r.integers(0, li + 2, N).astype(np.int16))
    for k, v in host.items():
        getattr(st, k).copy_(v)


# name -> (config, aux source, layout, compute, per-group monitor)
CASES = {
    "headline_inkernel": (lambda: headline_config(G), "inkernel", "wide",
                          "unpacked", False),
    "headline_staged": (lambda: headline_config(G), "staged", "wide",
                        "unpacked", False),
    "mailbox_inkernel": (lambda: mailbox_config(G), "inkernel", "wide",
                         "unpacked", False),
    "farm_inkernel": (lambda: fuzz.smoke_config(G), "inkernel", "wide",
                      "unpacked", True),
    "headline_packed": (lambda: headline_config(G), "inkernel", "packed",
                        "packed", False),
    "mailbox_packed": (lambda: mailbox_config(G), "inkernel", "packed",
                       "unpacked", False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_observer_kernel_equals_plain(name):
    need_card()
    make, aux_source, layout, compute, per_group = CASES[name]
    cfg = make()
    dev = torch.device("cuda")
    st = init_state(cfg, dev)
    cuda_scan.make_cuda_scan(cfg, 30, fused_ticks=1, aux_source="inkernel",
                             device=dev)(st)
    forge_chaos(cfg, st, 4)
    flags = ttick.make_flags(cfg)
    rng = ttick.make_rng(cfg, dev)
    base, tk, bk, scen = ttick.split_rng(rng)
    stat = cuda_tick.inkernel_aux_statics(cfg, base, tk, bk, scen)
    snap = cuda_tick.fused_snapshot_fields(cfg, telemetry=True, monitor=True,
                                           per_group=per_group)
    packed = layout == "packed"
    fresh = (lambda: pack_state(cfg, st)) if packed else st.clone
    flat = ttick.flatten_packed if packed else ttick.flatten_state
    a, b, c = fresh(), fresh(), fresh()
    sa, sb, sc = flat(cfg, a), flat(cfg, b), flat(cfg, c)

    def wide(x):
        return ttick.flatten_state(cfg, unpack_state(cfg, x)) if packed \
            else flat(cfg, x)
    src = wide(c)
    prev = {k: ttel.mailbox_snapshot(src) if k == cuda_tick.INFLIGHT
            else src[k].clone() for k in snap}
    mons = [ttel.monitor_zeros(G, 3, per_group=per_group, device=dev)
            for _ in range(3)]
    tels = [ttel.telemetry_zeros(dev) for _ in range(3)]
    n0 = cuda_tick.LAUNCHES["fused_tick_kernel[observers]"]
    T, tick = 4, st.tick
    for i in range(4):
        ops = cuda_tick.inkernel_aux_operands(stat, tick) \
            if aux_source == "inkernel" else cuda_tick.staged_operands(
                cfg, base, tk, bk, tick, wide(b), T, scen=scen)
        oa = cuda_tick.kernel_observers(mons[0])
        ob = cuda_tick.kernel_observers(mons[1])
        ova, _ = cuda_tick.fused_tick_kernel(cfg, sa, T, flags, aux_source,
                                             ops, layout=layout,
                                             compute=compute, obs=oa)
        ovb, _ = cuda_tick.fused_tick_plain(cfg, sb, T, flags, aux_source,
                                            ops, layout=layout,
                                            compute=compute, obs=ob)
        _, snaps = cuda_tick.fused_tick_plain(cfg, sc, T, flags, aux_source,
                                              ops, snap, layout=layout,
                                              compute=compute)
        assert torch.equal(ova, ovb), f"overflow, launch {i}"
        for k in sa:
            assert torch.equal(sa[k], sb[k]), f"{k}, launch {i}"
            assert torch.equal(sa[k], sc[k]), f"{k}, launch {i}"
        assert torch.equal(oa.rows, ob.rows), f"rows, launch {i}"
        for k in oa.carry:
            assert torch.equal(oa.carry[k], ob.carry[k]), f"{k}, launch {i}"
        tels[0], mons[0] = ttel.fold_obs_rows(oa.rows, tels[0], mons[0])
        tels[1], mons[1] = ttel.fold_obs_rows(ob.rows, tels[1], mons[1])
        ticks = cuda_tick.unpack_fused_outputs(snaps, T)
        tels[2], mons[2] = cuda_tick.fused_observe(cfg, prev, ticks, tels[2],
                                                   mons[2])
        prev = ticks[-1]
        tick += T
    for got, want in ((tels[0], tels[2]), (mons[0], mons[2])):
        bad = [k for k in want if not torch.equal(got[k], want[k])]
        assert not bad, bad
    assert cuda_tick.LAUNCHES["fused_tick_kernel[observers]"] == n0 + 4
    assert int(mons[0]["viol_total"]) > 0


def planted_state():
    """tests/test_torch_kernel_observers.py's planted tick, on the CPU."""
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


@pytest.mark.cuda
def test_planted_rewrite_through_the_kernel():
    """A staged T=1 launch of the planted tick: the kernel's write tracking
    gives the plain form's rows (invariant 5 in group 2 alone) and taints."""
    need_card()
    cfg, st = planted_state()
    dev = torch.device("cuda")
    sa = {k: v.to(dev) for k, v in ttick.flatten_state(cfg, st).items()}
    sb = {k: v.clone() for k, v in ttick.flatten_state(cfg, st).items()}
    flags = ttick.make_flags(cfg)
    rows = []
    for s, d in ((sa, dev), (sb, torch.device("cpu"))):
        base, tk, bk, scen = ttick.split_rng(ttick.make_rng(cfg, d))
        ops = cuda_tick.staged_operands(cfg, base, tk, bk, 0, s, 1, scen=scen)
        obs = cuda_tick.kernel_observers(ttel.monitor_zeros(3, device=d))
        cuda_tick.fused_tick_kernel(cfg, s, 1, flags, "staged", ops, obs=obs)
        rows.append(obs.rows.cpu())
    assert torch.equal(rows[0], rows[1])
    assert rows[0][0, ttel.OBS_VIOL:ttel.OBS_LATCH].tolist() == \
        [0, 0, 0, 1, 0, 1, 0]
    for k in sa:
        assert torch.equal(sa[k].cpu(), sb[k]), k


@pytest.mark.cuda
def test_scan_observes_in_the_kernel_without_snapshots():
    need_card()
    cfg = mailbox_config(G)
    dev = torch.device("cuda")
    run = cuda_scan.make_cuda_scan(cfg, 42, fused_ticks=4,
                                   aux_source="inkernel", telemetry=True,
                                   monitor=True, device=dev)
    cuda_tick.reset_launch_counts()
    _, tel, mon = run(init_state(cfg, dev))
    assert cuda_tick.LAUNCHES["fused_tick_kernel"] == 12
    assert cuda_tick.LAUNCHES["fused_tick_kernel[observers]"] == 12
    assert cuda_tick.SNAPSHOT_BYTES["fused_tick_kernel"] == 0
    ref = cuda_scan.make_cuda_scan(cfg, 42, fused_ticks=1,
                                   aux_source="staged", telemetry=True,
                                   monitor=True, device=dev)
    _, tel1, mon1 = ref(init_state(cfg, dev))
    for got, want in ((tel, tel1), (mon, mon1)):
        bad = [k for k in want if not torch.equal(got[k], want[k])]
        assert not bad, bad


@pytest.mark.cuda
def test_observed_launch_and_fold_never_wait_for_the_card():
    """An observed launch and the fold of its rows queue work only: no
    operation on the way reads the card back (torch's sync debug mode
    raises on one)."""
    need_card()
    cfg = headline_config(G)
    dev = torch.device("cuda")
    st = init_state(cfg, dev)
    s = ttick.flatten_state(cfg, st)
    stat = cuda_tick.inkernel_aux_statics(
        cfg, *ttick.split_rng(ttick.make_rng(cfg, dev)))
    flags = ttick.make_flags(cfg)
    tel = ttel.telemetry_zeros(dev)
    mon = ttel.monitor_init(G, 8, device=dev)
    for t in (0, 4):  # the first launch loads the module, untimed
        ops = cuda_tick.inkernel_aux_operands(stat, t)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            obs = cuda_tick.kernel_observers(mon)
            cuda_tick.fused_tick_kernel(cfg, s, 4, flags, "inkernel", ops,
                                        obs=obs)
            tel, mon = ttel.fold_obs_rows(obs.rows, tel, mon)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert int(mon["tick"]) == 8
