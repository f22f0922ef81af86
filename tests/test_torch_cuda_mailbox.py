"""The §10 mailbox in the port's kernels on the card: the one-tick kernel,
the fused kernel (both aux forms) and the stand-alone in-kernel delay draw
against their plain versions — the same state and operands, every state
field with all 13 slot planes, el_dirty, the overflow counts and every
snapshot (the in-flight count included) bit-equal (tolerance zero:
integers) — at ragged group counts, at τ=0 with int16 logs and at seven
nodes; the wrappers raising instead of falling back; the runner on the
card against the same runner on the CPU.

The kernels have no CPU mode, so every test here needs the card and skips
without one. The card's machine has no JAX; run them there with
`python -m pytest --noconftest -m cuda tests/test_torch_cuda_mailbox.py`.
"""

import pytest
import torch

from raft_kotlin_tpu_torch.constants import LEADER
from raft_kotlin_tpu_torch.models.state import STATE_FIELDS, init_state
from raft_kotlin_tpu_torch.ops import cuda_tick
from raft_kotlin_tpu_torch.ops import tick as ttick
from raft_kotlin_tpu_torch.ops.cuda_scan import make_cuda_scan
from raft_kotlin_tpu_torch.utils import rng as trng
from raft_kotlin_tpu_torch.utils.config import RaftConfig, mailbox_config

# (config, warm-up ticks, kernel ticks or launches, T)
CARD_CONFIGS = {
    "stage4b_ragged": (mailbox_config(4099), 40, 4, 4),
    "tau0_int16_logs": (RaftConfig(
        n_groups=1000, n_nodes=3, log_capacity=8, log_dtype="int16",
        cmd_period=3, p_drop=0.1, p_crash=0.02, p_restart=0.1, seed=5,
        delay_lo=0, delay_hi=2).stressed(10), 30, 5, 3),
    "seven_nodes": (RaftConfig(
        n_groups=515, n_nodes=7, log_capacity=12, cmd_period=4, p_drop=0.2,
        p_link_fail=0.05, p_link_heal=0.1, seed=2, delay_lo=2,
        delay_hi=5).stressed(10), 40, 4, 5),
}


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")


def warm_state(cfg, warm, dev):
    st = init_state(cfg, dev)
    make_cuda_scan(cfg, warm, aux_source="inkernel", fused_ticks=1,
                   device=dev)(st)
    assert int((st.vq_due >= 0).sum() + (st.aq_due >= 0).sum()) > 0
    return st


def assert_flat_equal(sa, sb, what):
    for k in sa:
        assert torch.equal(sa[k], sb[k]), f"{k} {what}"


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_CONFIGS))
def test_mailbox_tick_kernel_equals_plain(name):
    need_card()
    cfg, warm, ticks, _ = CARD_CONFIGS[name]
    dev = torch.device("cuda")
    a = warm_state(cfg, warm, dev)
    b = a.clone()
    base, tk, bk = ttick.make_rng(cfg, dev)
    n0 = cuda_tick.LAUNCHES["tick_kernel"]
    for t in range(ticks):
        aux, flags = ttick.make_aux(cfg, base, tk, bk, a)
        assert flags.delay
        sa, sb = ttick.flatten_state(cfg, a), ttick.flatten_state(cfg, b)
        da = cuda_tick.tick_kernel(cfg, sa, aux, flags)
        db = ttick.phase_body(cfg, sb, aux, flags)
        assert_flat_equal(sa, sb, f"after tick {t}")
        assert torch.equal(da, db), f"el_dirty at tick {t}"
        ttick.finish_tick(cfg, tk, a, sa, da)
        ttick.finish_tick(cfg, tk, b, sb, db)
    assert cuda_tick.LAUNCHES["tick_kernel"] == n0 + ticks


@pytest.mark.cuda
@pytest.mark.parametrize("aux_source", ["staged", "inkernel"])
@pytest.mark.parametrize("name", sorted(CARD_CONFIGS))
def test_mailbox_fused_kernel_equals_plain(name, aux_source):
    need_card()
    cfg, warm, launches, T = CARD_CONFIGS[name]
    dev = torch.device("cuda")
    a = warm_state(cfg, warm, dev)
    b = a.clone()
    rng = ttick.make_rng(cfg, dev)
    stat = cuda_tick.inkernel_aux_statics(cfg, *rng)
    flags = ttick.make_flags(cfg)
    # Every field, so every snapshot path is compared, and the count.
    snap = STATE_FIELDS + (cuda_tick.INFLIGHT,)
    n0 = dict(cuda_tick.LAUNCHES)
    for i in range(launches):
        tick0 = warm + i * T
        sa, sb = ttick.flatten_state(cfg, a), ttick.flatten_state(cfg, b)
        ops = (cuda_tick.inkernel_aux_operands(stat, tick0)
               if aux_source == "inkernel" else cuda_tick.staged_operands(
                   cfg, *rng, tick0, sa, T))
        ova, snapa = cuda_tick.fused_tick_kernel(cfg, sa, T, flags,
                                                 aux_source, ops, snap)
        ovb, snapb = cuda_tick.fused_tick_plain(cfg, sb, T, flags,
                                                aux_source, ops, snap)
        assert torch.equal(ova, ovb) and int(ova.sum()) == 0
        assert_flat_equal(sa, sb, f"after launch {i}")
        assert_flat_equal(snapa, snapb, f"snapshots of launch {i}")
    drawn = aux_source == "inkernel" and cfg.delay_lo < cfg.delay_hi
    assert cuda_tick.LAUNCHES["fused_tick_kernel"] == \
        n0["fused_tick_kernel"] + launches
    assert cuda_tick.LAUNCHES["fused_tick_kernel[delay_draw]"] == \
        n0["fused_tick_kernel[delay_draw]"] + (launches if drawn else 0)
    assert int((a.role == LEADER).any(0).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["stage4b_ragged", "seven_nodes"])
def test_delay_draw_kernel_equals_plain(name):
    """kt_rng.cuh's delay_draw over whole pair lattices at several ticks
    against the staged draw of ops/tick.make_aux (utils/rng.delay_mask,
    groups-minor)."""
    need_card()
    cfg = CARD_CONFIGS[name][0]
    dev = torch.device("cuda")
    N, G = cfg.n_nodes, cfg.n_groups
    base, tk, bk = ttick.make_rng(cfg, dev)
    stat = cuda_tick.inkernel_aux_statics(cfg, base, tk, bk)
    for tick in (0, 1, 77, 4095):
        ktab = cuda_tick.inkernel_aux_operands(stat, tick)["ktab"]
        got = cuda_tick.delay_draw(cfg, ktab)
        want = trng.delay_mask(base, tick, (G, N, N), cfg.delay_lo,
                               cfg.delay_hi, dev)
        assert torch.equal(got, want.permute(1, 2, 0).reshape(N * N, G)
                           .to(torch.int16)), tick
        assert torch.equal(got, cuda_tick.delay_draw_plain(cfg, ktab))


@pytest.mark.cuda
def test_mailbox_wrappers_raise_instead_of_falling_back():
    need_card()
    cfg = mailbox_config(64)
    dev = torch.device("cuda")
    st = init_state(cfg, dev)
    s = ttick.flatten_state(cfg, st)
    rng = ttick.make_rng(cfg, dev)
    aux, flags = ttick.make_aux(cfg, *rng, st)
    stat = cuda_tick.inkernel_aux_statics(cfg, *rng)
    ops = cuda_tick.inkernel_aux_operands(stat, 0)
    n0 = dict(cuda_tick.LAUNCHES)
    for bad in (dict(s, vq_due=s["vq_due"].cpu()),
                dict(s, aq_ent_t=s["aq_ent_t"].to(torch.int16)),
                {k: v for k, v in s.items() if k != "aq_commit"}):
        with pytest.raises(ValueError):
            cuda_tick.tick_kernel(cfg, bad, aux, flags)
        with pytest.raises(ValueError):
            cuda_tick.fused_tick_kernel(cfg, bad, 2, flags, "inkernel", ops)
    with pytest.raises(ValueError):
        cuda_tick.tick_kernel(cfg, s, dict(aux, delay=aux["delay"].cpu()),
                              flags)
    with pytest.raises(ValueError):
        cuda_tick.delay_draw(cfg, ops["ktab"].to(torch.int64))
    assert cuda_tick.LAUNCHES == n0


@pytest.mark.cuda
def test_mailbox_cuda_scan_on_the_card_equals_the_cpu():
    """The stage-4b runner on the card (fused launches + an in-kernel
    remainder, every observer on) against the same runner on the CPU."""
    need_card()
    cfg = mailbox_config(300)
    outs = []
    for dev in ("cuda", "cpu"):
        run = make_cuda_scan(cfg, 43, fused_ticks=4, aux_source="inkernel",
                             telemetry=True, monitor=True, trace=True,
                             device=dev)
        outs.append(run(init_state(cfg, dev)))
    (ea, tra, tela, mona), (eb, trb, telb, monb) = outs
    for k in ea.fields():
        assert torch.equal(getattr(ea, k).cpu(), getattr(eb, k)), k
    for d1, d2 in ((tra, trb), (tela, telb), (mona, monb)):
        assert d1.keys() == d2.keys()
        for k in d1:
            assert torch.equal(d1[k].cpu(), d2[k]), k
    assert int(tela["mailbox_inflight_hw"]) > 0
