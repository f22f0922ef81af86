"""The §15 forms of the one-tick kernel (#1) and the fused kernel (#2) on
the card (csrc/tick_body.cuh's Snap: the ring translate and window test in
every log access, InstallSnapshot in phase 5, the phase-C fold; int32
positions and the three snapshot planes as operands) against their plain
versions (ops/tick.phase_body under BodyFlags.compact,
ops/cuda_tick.fused_tick_plain): every state field, the snapshot planes,
el_dirty, the overflow counts, the trace snapshots and the observer build's
rows and carry bit-equal (tolerance zero: integers), with the launch
counted, on the synchronous soup, the laggard family (InstallSnapshot),
bench.py's compaction leg on a 56-row ring, a crash soup under the §10
mailbox (installs on the slot; [1, 3] delays and τ=0) and the synchronous
soup with int16 logs, at ragged group counts; the packed layout's §15
forms (both computes) and kernel #7's.

The kernels have no CPU mode, so every test here needs the card and skips
without one. The card's machine has no JAX; run them there with
`python -m pytest --noconftest -m cuda tests/test_torch_cuda_compaction.py`.
"""

import dataclasses

import pytest
import torch

from raft_kotlin_tpu_torch.api import fuzz
from raft_kotlin_tpu_torch.models.state import init_state, pack_state
from raft_kotlin_tpu_torch.ops import cuda_tick
from raft_kotlin_tpu_torch.ops import tick as ttick
from raft_kotlin_tpu_torch.ops.cuda_scan import make_cuda_scan
from raft_kotlin_tpu_torch.utils import telemetry as ttel
from raft_kotlin_tpu_torch.utils.config import RaftConfig, ScenarioSpec

SYNC = dict(n_nodes=3, log_capacity=64, cmd_period=3, p_drop=0.15, seed=11,
            compact_watermark=3, compact_chunk=1)


def configs():
    ring = RaftConfig(n_groups=1000, n_nodes=3, log_capacity=64,
                      cmd_period=2, p_drop=0.05, seed=0, compact_watermark=8,
                      compact_chunk=8,
                      scenario=ScenarioSpec(warmup_down=40)).stressed(10)
    mail = RaftConfig(n_groups=2051, n_nodes=3, log_capacity=32,
                      cmd_period=5, seed=9, p_drop=0.1, p_crash=0.05,
                      p_restart=0.3, delay_lo=1, delay_hi=3,
                      compact_watermark=4, compact_chunk=4).stressed(10)
    return {"sync": RaftConfig(n_groups=4099, **SYNC).stressed(10),
            "laggard": fuzz.laggard_config(2051),
            "ring": dataclasses.replace(ring, ring_capacity=56),
            "mail": mail,
            "tau0": dataclasses.replace(mail, delay_lo=0, delay_hi=0,
                                        mailbox=True),
            "sync16": RaftConfig(n_groups=4099, log_dtype="int16",
                                 **SYNC).stressed(10)}


NEW_FORMS = ["mail", "tau0", "sync16"]


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")


def warm(cfg, dev, ticks):
    st = init_state(cfg, dev)
    make_cuda_scan(cfg, ticks, aux_source="inkernel", fused_ticks=1,
                   device=dev)(st)
    return st


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sync", "laggard", "ring"] + NEW_FORMS)
def test_tick_kernel_compact_form_equals_plain(name):
    need_card()
    cfg = configs()[name]
    dev = torch.device("cuda")
    st = warm(cfg, dev, 90)
    base, tk, bk, scen = ttick.split_rng(ttick.make_rng(cfg, dev))
    n0 = cuda_tick.LAUNCHES["tick_kernel"]
    for i in range(6):
        s = ttick.flatten_state(cfg, st)
        aux, flags = ttick.make_aux(cfg, base, tk, bk, st, scen=scen)
        ref = {k: v.cpu() for k, v in s.items()}
        dirty = cuda_tick.tick_kernel(cfg, s, aux, flags)
        want = ttick.phase_body(cfg, ref, {k: v.cpu() for k, v in aux.items()},
                                flags)
        assert torch.equal(dirty.cpu(), want), i
        for k in ref:
            assert torch.equal(s[k].cpu(), ref[k]), (k, i)
        ttick.materialize_el(cfg, tk, s, dirty)
        st.tick += 1
    assert cuda_tick.LAUNCHES["tick_kernel"] == n0 + 6
    assert int(st.snap_index.max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("observers", [False, True])
@pytest.mark.parametrize("aux_source", ["staged", "inkernel"])
@pytest.mark.parametrize("name", ["sync", "laggard", "ring"] + NEW_FORMS)
def test_fused_kernel_compact_form_equals_plain(name, aux_source, observers):
    need_card()
    cfg = configs()[name]
    if cfg.scenario is not None and aux_source == "staged" \
            and cfg.scenario.needs_state:
        pytest.skip("leader programs need in-kernel draws")
    dev = torch.device("cuda")
    st = warm(cfg, dev, 60)
    base, tk, bk, scen = ttick.split_rng(ttick.make_rng(cfg, dev))
    stat = cuda_tick.inkernel_aux_statics(cfg, base, tk, bk, scen)
    flags = ttick.make_flags(cfg)
    key = "fused_tick_kernel[observers]" if observers \
        else "fused_tick_kernel"
    n0 = cuda_tick.LAUNCHES[key]
    for i in range(4):
        s = ttick.flatten_state(cfg, st)
        if aux_source == "inkernel":
            ops = cuda_tick.inkernel_aux_operands(stat, st.tick)
        else:
            ops = cuda_tick.staged_operands(cfg, base, tk, bk, st.tick, s, 4,
                                            None, scen=scen)
        ref = {k: v.cpu() for k, v in s.items()}
        mk = ttel.monitor_zeros(cfg.n_groups, 1, per_group=True, device=dev)
        mp = ttel.monitor_zeros(cfg.n_groups, 1, per_group=True,
                                device="cpu")
        ok = cuda_tick.kernel_observers(mk) if observers else None
        op = cuda_tick.kernel_observers(mp) if observers else None
        ov, snaps = cuda_tick.fused_tick_kernel(
            cfg, s, 4, flags, aux_source, ops, cuda_tick.FUSED_TRACE_FIELDS,
            obs=ok)
        wov, wsnaps = cuda_tick.fused_tick_plain(
            cfg, ref, 4, flags, aux_source, {k: v.cpu() for k, v in
                                             ops.items()},
            cuda_tick.FUSED_TRACE_FIELDS, obs=op)
        assert torch.equal(ov.cpu(), wov), i
        for k in ref:
            assert torch.equal(s[k].cpu(), ref[k]), (k, i)
        for k in wsnaps:
            assert torch.equal(snaps[k].cpu(), wsnaps[k]), (k, i)
        if observers:
            assert torch.equal(ok.rows.cpu(), op.rows), i
            for k in op.carry:
                assert torch.equal(ok.carry[k].cpu(), op.carry[k]), (k, i)
        st.tick += 4
    assert cuda_tick.LAUNCHES[key] == n0 + 4
    assert int(st.snap_index.max()) > 0


@pytest.mark.cuda
def test_laggard_runner_on_the_card_equals_the_cpu():
    """make_cuda_scan over 120 laggard ticks (in-kernel draws, T = 4, the
    recorder and monitor in the kernel) ≡ the same runner on the CPU, with
    installs delivered."""
    need_card()
    cfg = fuzz.laggard_config(2051)
    dev = torch.device("cuda")
    out = {}
    for d in (dev, torch.device("cpu")):
        out[d.type] = make_cuda_scan(cfg, 120, telemetry=True, monitor=True,
                                     fused_ticks=4, aux_source="inkernel",
                                     device=d)(init_state(cfg, d))
    (a, ta, ma), (b, tb, mb) = out["cuda"], out["cpu"]
    for k in a.fields():
        assert torch.equal(getattr(a, k).cpu(), getattr(b, k)), k
    assert ttel.summarize_telemetry(ta) == ttel.summarize_telemetry(tb)
    assert ttel.summarize_monitor(ma) == ttel.summarize_monitor(mb)
    assert ttel.summarize_telemetry(ta)["installsnap_deliveries"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("compute", ["unpacked", "packed"])
@pytest.mark.parametrize("name", ["sync", "mail"])
def test_packed_compact_forms_equal_plain(name, compute):
    """The packed layout's §15 forms (latched int16 positions, aq_hase an
    int8 plane): #1 over 3 ticks, #2 in-kernel with its observers over 2
    launches of T=4, the packed state and its latch ≡ the plain versions."""
    need_card()
    cfg = configs()[name]
    dev = torch.device("cuda")
    st = warm(cfg, dev, 60)
    base, tk, bk, scen = ttick.split_rng(ttick.make_rng(cfg, dev))
    stat = cuda_tick.inkernel_aux_statics(cfg, base, tk, bk, scen)
    flags = ttick.make_flags(cfg)
    ps = pack_state(cfg, st)
    for i in range(3):
        s = ttick.flatten_packed(cfg, ps)
        aux, fl = ttick.make_aux(cfg, base, tk, bk,
                                 ttick.packed_shim(cfg, s, st.tick),
                                 scen=scen)
        ref = {k: v.cpu() for k, v in s.items()}
        dirty = cuda_tick.tick_kernel(cfg, s, aux, fl, layout="packed",
                                      compute=compute)
        want = cuda_tick.tick_kernel(cfg, ref, {k: v.cpu() for k, v in
                                                aux.items()}, fl,
                                     layout="packed", compute=compute)
        assert torch.equal(dirty.cpu(), want), i
        for k in ref:
            assert torch.equal(s[k].cpu(), ref[k]), (k, i)
        ttick.materialize_el(cfg, tk, s, dirty)
        st.tick += 1
    for i in range(2):
        s = ttick.flatten_packed(cfg, ps)
        ops = cuda_tick.inkernel_aux_operands(stat, st.tick)
        ref = {k: v.cpu() for k, v in s.items()}
        mk = ttel.monitor_zeros(cfg.n_groups, 1, device=dev)
        mp = ttel.monitor_zeros(cfg.n_groups, 1, device="cpu")
        ok, op = cuda_tick.kernel_observers(mk), cuda_tick.kernel_observers(mp)
        ov, _ = cuda_tick.fused_tick_kernel(cfg, s, 4, flags, "inkernel", ops,
                                            layout="packed", compute=compute,
                                            obs=ok)
        wov, _ = cuda_tick.fused_tick_plain(
            cfg, ref, 4, flags, "inkernel",
            {k: v.cpu() for k, v in ops.items()}, layout="packed",
            compute=compute, obs=op)
        assert torch.equal(ov.cpu(), wov), i
        for k in ref:
            assert torch.equal(s[k].cpu(), ref[k]), (k, i)
        assert torch.equal(ok.rows.cpu(), op.rows), i
        st.tick += 4
    assert int(ps.ov.sum()) == 0 and int(ps.snap_index.max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sync", "mail", "sync16"])
def test_k_tick_compact_form_equals_plain(name):
    """Kernel #7's §15 form: 2 launches of K=4, the state and the draw
    tables' overflow counts ≡ k_tick_plain; make_cuda_scan(k_per_launch=4)
    on the card ≡ its staged T=1 run."""
    need_card()
    cfg = configs()[name]
    dev = torch.device("cuda")
    st = warm(cfg, dev, 60)
    base, tk, bk, scen = ttick.split_rng(ttick.make_rng(cfg, dev))
    n0 = cuda_tick.LAUNCHES["k_tick"]
    for i in range(2):
        s = ttick.flatten_state(cfg, st)
        ops = cuda_tick.staged_operands(cfg, base, tk, bk, st.tick, s, 4,
                                        scen=scen)
        el, bt = ops.pop("el_table"), ops.pop("b_table")
        ref = {k: v.cpu() for k, v in s.items()}
        ov = cuda_tick.k_tick_kernel(cfg, s, 4, ops, el, bt)
        want = cuda_tick.k_tick_plain(cfg, ref, 4,
                                      {k: v.cpu() for k, v in ops.items()},
                                      el.cpu(), bt.cpu())
        assert torch.equal(ov.cpu(), want), i
        for k in ref:
            assert torch.equal(s[k].cpu(), ref[k]), (k, i)
        st.tick += 4
    assert cuda_tick.LAUNCHES["k_tick"] == n0 + 2
    a = make_cuda_scan(cfg, 22, k_per_launch=4, device=dev)(
        init_state(cfg, dev))
    b = make_cuda_scan(cfg, 22, fused_ticks=1, device=dev)(
        init_state(cfg, dev))
    for k in a.fields():
        assert torch.equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mail", "tau0"])
def test_mailbox_runner_on_the_card_equals_the_cpu(name):
    """make_cuda_scan over 90 ticks of the mailbox family (in-kernel, T=4,
    the observers in the kernel) ≡ the same runner on the CPU, with
    installs delivered through the slots."""
    need_card()
    cfg = configs()[name]
    out = {}
    for d in (torch.device("cuda"), torch.device("cpu")):
        out[d.type] = make_cuda_scan(cfg, 90, telemetry=True, monitor=True,
                                     fused_ticks=4, aux_source="inkernel",
                                     device=d)(init_state(cfg, d))
    (a, ta, ma), (b, tb, mb) = out["cuda"], out["cpu"]
    for k in a.fields():
        assert torch.equal(getattr(a, k).cpu(), getattr(b, k)), k
    assert ttel.summarize_telemetry(ta) == ttel.summarize_telemetry(tb)
    assert ttel.summarize_monitor(ma) == ttel.summarize_monitor(mb)
    assert ttel.summarize_telemetry(ta)["installsnap_deliveries"] > 0
