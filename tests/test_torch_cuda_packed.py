"""The §14 packed layout and the §18 packed compute in the port's kernels on
the card: each packed instantiation of the one-tick and fused kernels (with
and without the §10 mailbox, staged and in-kernel draws, compute packed and
unpacked) against its plain version — the same packed state and operands,
every packed field with the width latch, el_dirty, the overflow counts and
every snapshot bit-equal (tolerance zero: integers) — at ragged group
counts, with int16 logs, with the config-gated int16 widths, and at seven
nodes; the packed runners on the card against the wide ones; the width
latch taken at each log write, against the plain version's at the launch's
end; the wrappers raising instead of falling back.

The kernels have no CPU mode, so every test here needs the card and skips
without one. The card's machine has no JAX; run them there with
`python -m pytest --noconftest -m cuda tests/test_torch_cuda_packed.py`.
"""

import pytest
import torch

from raft_kotlin_tpu_torch.api import fuzz
from raft_kotlin_tpu_torch.models.state import (
    init_state, narrow_gate_int8, pack_state)
from raft_kotlin_tpu_torch.ops import cuda_tick
from raft_kotlin_tpu_torch.ops import tick as ttick
from raft_kotlin_tpu_torch.ops.cuda_scan import make_cuda_scan
from raft_kotlin_tpu_torch.utils.config import (
    RaftConfig, headline_config, mailbox_config)

# (config, warm-up ticks, kernel ticks or launches, T)
CARD_CONFIGS = {
    "headline_ragged": (headline_config(4099), 40, 4, 4),
    "stage4b_ragged": (mailbox_config(4099), 40, 4, 4),
    "stage4b_aligned_ragged": (mailbox_config(4104), 40, 4, 4),
    "tau0_int16_logs": (RaftConfig(
        n_groups=1000, n_nodes=3, log_capacity=8, log_dtype="int16",
        cmd_period=3, p_drop=0.1, p_crash=0.02, p_restart=0.1, seed=5,
        delay_lo=0, delay_hi=2).stressed(10), 30, 5, 3),
    # Positions, the round window and the delays past int8: the int16 width
    # of every config-gated group but el / bo / hb.
    "int16_widths": (RaftConfig(
        n_groups=777, n_nodes=5, log_capacity=160, cmd_period=2,
        p_drop=0.1, p_crash=0.01, p_restart=0.05, seed=9, el_lo=5,
        el_hi=40, round_ticks=200, retry_ticks=5, hb_ticks=3, bo_lo=2,
        bo_hi=6, delay_lo=1, delay_hi=130), 60, 4, 4),
    "seven_nodes": (RaftConfig(
        n_groups=515, n_nodes=7, log_capacity=12, cmd_period=4, p_drop=0.2,
        p_link_fail=0.05, p_link_heal=0.1, seed=2).stressed(10), 40, 4, 5),
}
COMPUTES = ("unpacked", "packed")


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")


def warm_state(cfg, warm, dev):
    st = init_state(cfg, dev)
    make_cuda_scan(cfg, warm, aux_source="inkernel", fused_ticks=1,
                   device=dev)(st)
    assert int(st.term.max()) > 0
    return st


def assert_flat_equal(sa, sb, what):
    for k in sa:
        assert torch.equal(sa[k], sb[k]), f"{k} {what}"
    assert not sa["ov"].any(), f"width latch {what}"


def test_int16_widths_config_is_what_it_claims():
    cfg = CARD_CONFIGS["int16_widths"][0]
    assert [g for g in ("pos", "el", "bo", "round", "hb", "due")
            if not narrow_gate_int8(g, cfg)] == ["pos", "round", "due"]


@pytest.mark.cuda
@pytest.mark.parametrize("compute", COMPUTES)
@pytest.mark.parametrize("name", sorted(CARD_CONFIGS))
def test_packed_tick_kernel_equals_plain(name, compute):
    need_card()
    cfg, warm, ticks, _ = CARD_CONFIGS[name]
    dev = torch.device("cuda")
    st = warm_state(cfg, warm, dev)
    a, b = pack_state(cfg, st), pack_state(cfg, st)
    base, tk, bk = ttick.make_rng(cfg, dev)
    key = f"tick_kernel[packed,{compute}]"
    n0 = cuda_tick.LAUNCHES[key]
    for t in range(st.tick, st.tick + ticks):
        sa, sb = ttick.flatten_packed(cfg, a), ttick.flatten_packed(cfg, b)
        aux, flags = ttick.make_aux(cfg, base, tk, bk,
                                    ttick.packed_shim(cfg, sa, t))
        da = cuda_tick.tick_kernel(cfg, sa, aux, flags, layout="packed",
                                   compute=compute)
        db = cuda_tick.tick_plain_packed(cfg, sb, aux, flags, compute)
        assert_flat_equal(sa, sb, f"after tick {t}")
        assert torch.equal(da, db), f"el_dirty at tick {t}"
        ttick.materialize_el(cfg, tk, sa, da)
        ttick.materialize_el(cfg, tk, sb, db)
    assert cuda_tick.LAUNCHES[key] == n0 + ticks


@pytest.mark.cuda
@pytest.mark.parametrize("aux_source", ["staged", "inkernel"])
@pytest.mark.parametrize("compute", COMPUTES)
@pytest.mark.parametrize("name", sorted(CARD_CONFIGS))
def test_packed_fused_kernel_equals_plain(name, compute, aux_source):
    need_card()
    cfg, warm, launches, T = CARD_CONFIGS[name]
    dev = torch.device("cuda")
    st = warm_state(cfg, warm, dev)
    a, b = pack_state(cfg, st), pack_state(cfg, st)
    rng = ttick.make_rng(cfg, dev)
    base, tk, bk = rng
    stat = cuda_tick.inkernel_aux_statics(cfg, base, tk, bk)
    flags = ttick.make_flags(cfg)
    snap = cuda_tick.fused_snapshot_fields(cfg, telemetry=True, monitor=True,
                                           trace=True)
    kw = {"layout": "packed", "compute": compute}
    for i in range(launches):
        t = st.tick + i * T
        sa, sb = ttick.flatten_packed(cfg, a), ttick.flatten_packed(cfg, b)
        ops = (cuda_tick.inkernel_aux_operands(stat, t)
               if aux_source == "inkernel" else
               cuda_tick.staged_operands(cfg, base, tk, bk, t, sa, T))
        ova, snapa = cuda_tick.fused_tick_kernel(cfg, sa, T, flags,
                                                 aux_source, ops, snap, **kw)
        ovb, snapb = cuda_tick.fused_tick_plain(cfg, sb, T, flags,
                                                aux_source, ops, snap, **kw)
        assert_flat_equal(sa, sb, f"after launch {i}")
        assert torch.equal(ova, ovb) and not ova.any()
        for k in snap:
            assert snapa[k].dtype == snapb[k].dtype, k
            assert torch.equal(snapa[k], snapb[k]), f"snapshot {k}, launch {i}"


@pytest.mark.cuda
@pytest.mark.parametrize("compute", COMPUTES)
@pytest.mark.parametrize("name", ["headline_ragged", "stage4b_ragged",
                                  "int16_widths"])
def test_packed_runners_equal_wide_on_the_card(name, compute):
    """make_cuda_scan and make_run over the packed layout on the card ≡
    the wide runs: end state, trace, recorder, monitor (a remainder tick
    included)."""
    need_card()
    cfg = CARD_CONFIGS[name][0]
    dev = torch.device("cuda")

    def scan(aux_source, **kw):
        return make_cuda_scan(cfg, 42, fused_ticks=4, aux_source=aux_source,
                              trace=True, telemetry=True, monitor=True,
                              device=dev, **kw)(init_state(cfg, dev))
    for aux_source in ("inkernel", "staged"):
        ref = scan(aux_source)
        out = scan(aux_source, layout="packed", compute=compute)
        for k in ref[0].fields():
            assert torch.equal(getattr(out[0], k), getattr(ref[0], k)), k
        for i in (1, 2, 3):
            for k in ref[i]:
                assert torch.equal(torch.as_tensor(out[i][k]),
                                   torch.as_tensor(ref[i][k])), (i, k)
    wide = ttick.make_run(cfg, 12, trace=True, telemetry=True, device=dev)(
        init_state(cfg, dev))
    packed = ttick.make_run(cfg, 12, trace=True, telemetry=True, device=dev,
                            layout="packed", compute=compute)(
        init_state(cfg, dev))
    for k in wide[0].fields():
        assert torch.equal(getattr(packed[0], k), getattr(wide[0], k)), k
    for i in (1, 2):
        for k in wide[i]:
            assert torch.equal(packed[i][k], wide[i][k]), (i, k)


def forge_terms_near_int8(cfg, st):
    """Relabel each group's terms so its highest is 127, the top of the
    packed int8 log_term: the group's next election writes log entries past
    it. A shift of every term in a group leaves its dynamics as they were
    (terms are only compared with each other; 0 marks an empty entry)."""
    k = 127 - st.term.amax(0)
    st.term += k
    for f in ("log_term", "last_term"):
        v = getattr(st, f)
        v.copy_(torch.where(v != 0, v + k.to(v.dtype), v))


@pytest.mark.cuda
def test_packed_latch_takes_log_writes_as_they_happen():
    """The fused kernel latches a narrowed log write the moment it misses
    its range; the plain version (the JAX package's packed scan) latches
    the values left at the launch's end. So the kernel's latch holds the
    plain one's, and adds the groups whose out-of-range entry was
    overwritten in range within the launch: there the kernel had read the
    entry back wrapped, so its state could differ. Wherever the kernel did
    not latch, it equals the plain version. The case is planted by
    relabelling terms to the edge of int8 and stepping a wide reference
    tick by tick."""
    need_card()
    cfg = headline_config(8192)
    dev = torch.device("cuda")
    st = warm_state(cfg, 40, dev)
    forge_terms_near_int8(cfg, st)
    T = 4
    flags = ttick.make_flags(cfg)
    base, tk, bk = ttick.make_rng(cfg, dev)
    stat = cuda_tick.inkernel_aux_statics(cfg, base, tk, bk)
    step = make_cuda_scan(cfg, 1, aux_source="inkernel", fused_ticks=1,
                          device=dev)
    planted = extra = 0
    for _ in range(6):
        a, b = pack_state(cfg, st), pack_state(cfg, st)
        live = ~a.ov.bool()
        sa, sb = ttick.flatten_packed(cfg, a), ttick.flatten_packed(cfg, b)
        ops = cuda_tick.inkernel_aux_operands(stat, st.tick)
        cuda_tick.fused_tick_kernel(cfg, sa, T, flags, "inkernel", ops, (),
                                    layout="packed")
        cuda_tick.fused_tick_plain(cfg, sb, T, flags, "inkernel", ops, (),
                                   layout="packed")
        wrote = torch.zeros_like(live)
        for _ in range(T):
            step(st)
            wrote |= (st.log_term > 127).flatten(0, 1).any(0)
        ovk, ovp = sa["ov"].bool(), sb["ov"].bool()
        end = ttick.flatten_packed(cfg, pack_state(cfg, st))
        assert torch.equal(ovp, ~live | end["ov"].bool())
        assert not (ovp & ~ovk).any()
        assert not (wrote & live & ~ovk).any()
        for k in sa:
            assert torch.equal(sa[k][..., ~ovk], sb[k][..., ~ovk]), k
            assert torch.equal(sb[k][..., live], end[k][..., live]), k
        planted += int((wrote & live & ~ovp).sum())
        extra += int((ovk & ~ovp).sum())
    assert planted > 0 and extra >= planted


@pytest.mark.cuda
def test_packed_runners_return_the_wide_result_at_the_planted_state(
        monkeypatch):
    """The near-int8 relabelling through both packed runners, 24 ticks. On
    the whole relabelled state some value is out of range at a launch's
    end (the JAX package's rule fails) and both raise "width overflow".
    Kept only in the groups where that never happens, at make_cuda_scan's
    launch ends (every T ticks), some value is still out of range at a tick
    end inside a launch: the packed fused kernel's own latch fires there
    (asserted), and make_cuda_scan reruns wide (its fused launches
    counted twice) and returns what the wide scan returns. make_run's
    launches are single ticks, and a value that is out of range inside a
    tick and back in range by its end does not arise at this state; so
    there the one-tick kernel is wrapped to set `ov` on one group after
    each packed launch on the card, and make_run must rerun wide (its tick
    launches counted twice) and return what the wide run returns."""
    need_card()
    cfg = headline_config(8192)
    dev = torch.device("cuda")
    T, n = 4, 24
    st0 = warm_state(cfg, 40, dev)
    forged = st0.clone()
    forge_terms_near_int8(cfg, forged)
    probe = forged.clone()
    step = make_cuda_scan(cfg, 1, aux_source="inkernel", fused_ticks=1,
                          device=dev)
    # The launch-end rule: out of range at entry or at a launch's end.
    bad_scan = pack_state(cfg, probe).ov.bool()
    bad_run = bad_scan.clone()
    for t in range(1, n + 1):
        step(probe)
        ov = pack_state(cfg, probe).ov.bool()
        bad_run |= ov
        if t % T == 0:
            bad_scan |= ov
    assert bad_scan.any() and not bad_run.all()

    def plant(bad):
        out = forged.clone()
        for k in out.fields():
            getattr(out, k)[..., bad] = getattr(st0, k)[..., bad]
        return out
    planted = {"make_cuda_scan": plant(bad_scan),
               "make_run": plant(bad_run)}
    # The packed fused kernel's own latch on make_cuda_scan's planted state,
    # launch by launch.
    flags = ttick.make_flags(cfg)
    base, tk, bk = ttick.make_rng(cfg, dev)
    stat = cuda_tick.inkernel_aux_statics(cfg, base, tk, bk)
    fired, walk = False, planted["make_cuda_scan"].clone()
    for _ in range(n // T):
        pk = pack_state(cfg, walk)
        cuda_tick.fused_tick_kernel(
            cfg, ttick.flatten_packed(cfg, pk), T, flags, "inkernel",
            cuda_tick.inkernel_aux_operands(stat, walk.tick), (),
            layout="packed")
        fired |= bool(pk.ov.any())
        for _ in range(T):
            step(walk)
    assert fired
    one, victim = cuda_tick.tick_kernel, int((~bad_run).nonzero()[0])

    def one_early(cfg, s, *a, layout="wide", **kw):
        out = one(cfg, s, *a, layout=layout, **kw)
        if layout == "packed":
            s["ov"][victim] = 1
        return out
    runners = {
        "make_cuda_scan": (lambda **kw: make_cuda_scan(
            cfg, n, fused_ticks=T, aux_source="inkernel", trace=True,
            telemetry=True, device=dev, **kw), "fused_tick_kernel", n // T),
        "make_run": (lambda **kw: ttick.make_run(
            cfg, n, trace=True, telemetry=True, device=dev, **kw),
            "tick_kernel", n)}
    for name, (runner, key, launches) in runners.items():
        wide = runner()(planted[name].clone())
        for compute in COMPUTES:
            with pytest.raises(RuntimeError, match="width overflow"):
                runner(layout="packed", compute=compute)(forged.clone())
            if name == "make_run":
                monkeypatch.setattr(cuda_tick, "tick_kernel", one_early)
            n0 = cuda_tick.LAUNCHES[key]
            got = runner(layout="packed", compute=compute)(
                planted[name].clone())
            monkeypatch.setattr(cuda_tick, "tick_kernel", one)
            # The packed launches, then the wide rerun's.
            assert cuda_tick.LAUNCHES[key] - n0 == 2 * launches, (
                name, compute)
            for k in wide[0].fields():
                assert torch.equal(getattr(got[0], k),
                                   getattr(wide[0], k)), (name, compute, k)
            for i in (1, 2):
                for k in wide[i]:
                    assert torch.equal(torch.as_tensor(got[i][k]),
                                       torch.as_tensor(wide[i][k])), (
                        name, compute, i, k)


@pytest.mark.cuda
def test_packed_wrappers_raise_instead_of_falling_back():
    need_card()
    cfg = CARD_CONFIGS["headline_ragged"][0]
    dev = torch.device("cuda")
    st = init_state(cfg, dev)
    base, tk, bk = ttick.make_rng(cfg, dev)
    aux, flags = ttick.make_aux(cfg, base, tk, bk, st)
    # A wide state handed to the packed instantiation, and a packed state
    # with a wrong-width field, are refused before any launch.
    with pytest.raises(ValueError):
        cuda_tick.tick_kernel(cfg, ttick.flatten_state(cfg, st), aux, flags,
                              layout="packed")
    pf = ttick.flatten_packed(cfg, pack_state(cfg, st))
    pf["commit"] = pf["commit"].to(torch.int16)
    with pytest.raises(ValueError):
        cuda_tick.tick_kernel(cfg, pf, aux, flags, layout="packed")
    with pytest.raises(ValueError, match="requires layout='packed'"):
        cuda_tick.tick_kernel(cfg, ttick.flatten_state(cfg, st), aux, flags,
                              compute="packed")
    bank = fuzz.smoke_config(256)
    with pytest.raises(NotImplementedError):
        make_cuda_scan(bank, 4, aux_source="inkernel", layout="packed",
                       device=dev)
