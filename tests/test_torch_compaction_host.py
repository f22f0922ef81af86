"""The §15 compaction forms of the tick kernels that run under the §10
mailbox, in the §14 packed layout, with int16 logs and in kernel #7, on the
CPU: the kernels' §15 build (ops/csrc/*.cu with -DRAFT_COMPACT=1) is
compiled with g++ against the host stand-in for the CUDA runtime
(ops/host_build.py), launched through its C interface on CPU tensors, and
held against its plain version (ops/tick.phase_body under
BodyFlags.compact, cuda_tick.tick_plain_packed, k_tick_plain,
fused_tick_plain with the in-kernel observers' plain form): every state
field (the snapshot planes and the §10 slots included), el_dirty, the
overflow counts and the observer rows bit-equal (tolerance zero:
integers), at 16 three-node groups.

The mailbox family is a crash-heavy soup with 1-3-tick delays, warmed to
the ticks where an InstallSnapshot rides an append slot (aq_hase == 2) and
is delivered; its τ=0 twin delivers installs in the tick that sends them.
The card runs the same sources (tests/test_torch_cuda_compaction.py,
chip_smoke.py step 17).
"""

import ctypes
import dataclasses

import pytest
import torch

from raft_kotlin_tpu_torch.models.state import init_state, pack_state
from raft_kotlin_tpu_torch.ops import cuda_tick, host_build
from raft_kotlin_tpu_torch.ops import tick as ttick
from raft_kotlin_tpu_torch.utils import telemetry as ttel
from raft_kotlin_tpu_torch.utils.config import RaftConfig

# A compacting soup whose crashed followers fall behind their leader's
# snapshot base: installs go through the mailbox slots from tick ~50.
MAIL = RaftConfig(n_groups=16, n_nodes=3, log_capacity=32, cmd_period=5,
                  seed=9, p_drop=0.1, p_crash=0.05, p_restart=0.3,
                  delay_lo=1, delay_hi=3, compact_watermark=4,
                  compact_chunk=4).stressed(10)
TAU0 = dataclasses.replace(MAIL, delay_lo=0, delay_hi=0, mailbox=True)
SYNC16 = RaftConfig(n_groups=16, n_nodes=3, log_capacity=64, cmd_period=3,
                    p_drop=0.15, seed=11, compact_watermark=3,
                    compact_chunk=1, log_dtype="int16").stressed(10)
# (config, warm-up ticks, checked ticks): the checked ticks send and
# deliver installs (MAIL: sends at 50, deliveries 51-54; TAU0 from 38).
CASES = {"mail": (MAIL, 49, 6), "tau0": (TAU0, 37, 5),
         "sync_int16": (SYNC16, 40, 4)}
INSTALLS = ttel.OBS_SUM_FIELDS.index("installsnap_deliveries")


@pytest.fixture
def host(monkeypatch):
    if host_build.compiler() is None:
        pytest.skip("needs a host C++ compiler (g++)")
    # The launch arguments name a device index; the host build ignores it.
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)


def lib(source, *defines):
    L = host_build.build_host(source, ("RAFT_N=3", "RAFT_COMPACT=1")
                              + defines)
    for name in ("raft_tick_launch", "raft_fused_launch",
                 "raft_k_tick_launch"):
        fn = getattr(L, name, None)
        if fn is not None:
            fn.argtypes = [ctypes.c_void_p] * 3
            fn.restype = ctypes.c_int
    return L


def call(fn, ptrs, ints):
    return fn((ctypes.c_void_p * len(ptrs))(*ptrs),
              (ctypes.c_longlong * len(ints))(*ints), None)


def warm(cfg, ticks):
    st = init_state(cfg, "cpu")
    ttick.make_run(cfg, ticks, trace=False, device="cpu")(st)
    return st


def installs(pre, post):
    """Install slots a tick delivered from an earlier send (due 0 at its
    start) or newly filled (τ=0 delivers those at once), from the flat
    state before and after it (either layout: aq_hase is a plane under
    §15)."""
    if "aq_hase" not in pre:
        return 0
    was = pre["aq_hase"] == 2
    return int((was & (pre["aq_due"] == 0)).sum()
               + ((post["aq_hase"] == 2) & ~was).sum())


@pytest.mark.parametrize("name,layout,compute", [
    ("mail", "wide", "unpacked"), ("tau0", "wide", "unpacked"),
    ("sync_int16", "wide", "unpacked"), ("mail", "packed", "unpacked"),
    ("mail", "packed", "packed"), ("tau0", "packed", "packed")])
def test_tick_kernel_compact_forms_equal_plain(host, name, layout,
                                               compute):
    """#1's §15 forms: kMail with installs on the slot (τ=0 too), int16
    logs, and the packed layout (latched int16 positions, aq_hase an int8
    plane) with both computes."""
    cfg, warm_t, ticks = CASES[name]
    L = lib("tick_kernel.cu", *(("RAFT_PACKED=1",) if layout == "packed"
                                 else ()))
    st = warm(cfg, warm_t)
    base, tk, bk, scen = ttick.split_rng(ttick.make_rng(cfg, "cpu"))
    ps = pack_state(cfg, st) if layout == "packed" else None
    inst = 0
    for i in range(ticks):
        s = (ttick.flatten_packed(cfg, ps) if ps is not None
             else ttick.flatten_state(cfg, st))
        shim = ttick.packed_shim(cfg, s, st.tick) if ps is not None else st
        aux, flags = ttick.make_aux(cfg, base, tk, bk, shim, scen=scen)
        k = {f: v.clone() for f, v in s.items()}
        pre = {f: v.clone() for f, v in s.items() if f.startswith("aq_")}
        ptrs, ints, dirty = cuda_tick.tick_launch_args(cfg, k, aux, flags,
                                                       layout, compute)
        assert call(L.raft_tick_launch, ptrs, ints) == 0
        want = cuda_tick.tick_kernel(cfg, s, aux, flags, layout=layout,
                                     compute=compute)
        assert [f for f in s if not torch.equal(k[f], s[f])] == [], i
        assert torch.equal(dirty, want), i
        inst += installs(pre, s)
        ttick.materialize_el(cfg, tk, s, want)
        st.tick += 1
        if ps is not None:
            ps.tick = st.tick
            assert int(ps.ov.sum()) == 0
    if cfg.uses_mailbox:
        assert inst > 0  # installs rode the slots in the checked ticks
    assert int((st.snap_index if ps is None else ps.snap_index).max()) > 0


@pytest.mark.parametrize("name", ["mail", "sync_int16"])
def test_k_tick_kernel_compact_form_equals_plain(host, name):
    """#7's §15 form (wide, staged): two K=4 launches, the state and the
    draw tables' overflow counts."""
    cfg, warm_t, _ = CASES[name]
    L = lib("fused_tick_kernel.cu")
    st = warm(cfg, warm_t - 2)
    base, tk, bk, scen = ttick.split_rng(ttick.make_rng(cfg, "cpu"))
    flags = ttick.make_flags(cfg)
    for i in range(2):
        s = ttick.flatten_state(cfg, st)
        ops = cuda_tick.staged_operands(cfg, base, tk, bk, st.tick, s, 4,
                                        scen=scen)
        el, bt = ops.pop("el_table"), ops.pop("b_table")
        k = {f: v.clone() for f, v in s.items()}
        tensors, ints, ov, _ = cuda_tick.fused_operands(
            cfg, k, 4, flags, "staged", {**ops, "el_table": el,
                                         "b_table": bt}, ())
        assert call(L.raft_k_tick_launch,
                    [None if x is None else x.data_ptr() for x in tensors],
                    ints) == 0
        want = cuda_tick.k_tick_plain(cfg, s, 4, ops, el, bt)
        assert [f for f in s if not torch.equal(k[f], s[f])] == [], i
        assert torch.equal(ov, want) and int(want.sum()) == 0, i
        st.tick += 4


@pytest.mark.parametrize("name,layout,compute,observe", [
    ("mail", "wide", "unpacked", True), ("tau0", "wide", "unpacked", True),
    ("mail", "packed", "packed", True), ("mail", "packed", "unpacked",
                                         False)])
def test_fused_kernel_compact_forms_equal_plain(host, monkeypatch, name,
                                                layout, compute, observe):
    """#2's §15 forms under the mailbox, in-kernel: two T=3 launches, with
    the observer build (the recorder and the monitor, invariant 6 and the
    install counter included) or without, wide or packed. One thread a
    block, so the observers' warp reductions are the stand-in's
    identities."""
    monkeypatch.setattr(cuda_tick, "THREADS_PER_BLOCK", 1)
    cfg, warm_t, _ = CASES[name]
    packed = layout == "packed"
    L = lib("fused_tick_kernel.cu", *(("RAFT_PACKED=1",) if packed else ()),
            *(("RAFT_OBSERVE=1",) if observe else ()))
    st = warm(cfg, warm_t + 1)  # the launches deliver counted installs
    base, tk, bk, scen = ttick.split_rng(ttick.make_rng(cfg, "cpu"))
    stat = cuda_tick.inkernel_aux_statics(cfg, base, tk, bk, scen)
    flags = ttick.make_flags(cfg)
    G = cfg.n_groups
    mons = [ttel.monitor_init(G, 6, True, device="cpu") for _ in range(2)]
    ps = pack_state(cfg, st) if packed else None
    installs = 0
    for i in range(2):
        s = ttick.flatten_packed(cfg, ps) if packed else \
            ttick.flatten_state(cfg, st)
        ops = cuda_tick.inkernel_aux_operands(stat, st.tick)
        k = {f: v.clone() for f, v in s.items()}
        obs_k = cuda_tick.kernel_observers(mons[0]) if observe else None
        tensors, ints, ov, _ = cuda_tick.fused_operands(
            cfg, k, 3, flags, "inkernel", ops, (), layout, compute,
            obs=obs_k)
        assert call(L.raft_fused_launch,
                    [None if x is None else x.data_ptr() for x in tensors],
                    ints) == 0
        obs_p = cuda_tick.kernel_observers(mons[1]) if observe else None
        want, _ = cuda_tick.fused_tick_plain(
            cfg, s, 3, flags, "inkernel", ops, layout=layout,
            compute=compute, obs=obs_p)
        assert [f for f in s if not torch.equal(k[f], s[f])] == [], i
        assert torch.equal(ov, want), i
        if observe:
            assert torch.equal(obs_k.rows, obs_p.rows), i
            for c in obs_k.carry:
                assert torch.equal(obs_k.carry[c], obs_p.carry[c]), (c, i)
            installs += int(obs_p.rows[:, INSTALLS].sum())
        st.tick += 3
        if packed:
            ps.tick = st.tick
            assert int(ps.ov.sum()) == 0
    if observe:
        assert installs > 0
