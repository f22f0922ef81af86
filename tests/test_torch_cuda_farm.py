"""The §12 scenario bank in the port's kernels on the card: the fused
kernel with in-kernel draws through a bank's rows (thresholds, delay
windows, partition programs with leader isolation, the warmup-down rule)
and the one-tick kernel with the bank's masks drawn on the host, against
their plain versions — the same state and operands, every state field,
the overflow counts and every snapshot bit-equal (tolerance zero:
integers) — at three and five nodes, with and without the §10 mailbox;
the wrapper raising instead of falling back; the farm on the card against
the farm on the CPU.

The kernels have no CPU mode, so every test here needs the card and skips
without one. The card's machine has no JAX; run them there with
`python -m pytest --noconftest -m cuda tests/test_torch_cuda_farm.py`.
"""

import dataclasses

import pytest
import torch

from raft_kotlin_tpu_torch.api import fuzz
from raft_kotlin_tpu_torch.models.state import STATE_FIELDS, init_state
from raft_kotlin_tpu_torch.ops import cuda_tick
from raft_kotlin_tpu_torch.ops import tick as ttick
from raft_kotlin_tpu_torch.ops.cuda_scan import make_cuda_scan
from raft_kotlin_tpu_torch.utils.config import RaftConfig, ScenarioSpec

SMOKE = fuzz.smoke_config(1000)
HET5 = RaftConfig(n_groups=515, n_nodes=5, seed=31, cmd_period=9,
                  p_link_fail=0.02, p_link_heal=0.1,
                  scenario=ScenarioSpec(
                      farm_seed=7, universe_base=100, drop_max=0.2,
                      crash_max=0.01, restart_max=0.1,
                      partitions=("split", "asym", "leader"),
                      part_period_lo=5, part_period_hi=20)).stressed(10)
# (config, warm-up ticks, launches, T)
CARD_CONFIGS = {
    "smoke_n3": (SMOKE, 30, 3, 4),
    "smoke_n3_delay_windows": (dataclasses.replace(
        SMOKE, n_groups=777, delay_lo=1, delay_hi=4,
        scenario=dataclasses.replace(SMOKE.scenario, delay_windows=True)),
        30, 3, 4),
    "het_n5": (HET5, 30, 3, 4),
    "het_n5_mailbox_int16": (dataclasses.replace(
        HET5, n_groups=300, log_dtype="int16", delay_lo=0, delay_hi=2,
        scenario=dataclasses.replace(HET5.scenario, delay_windows=True,
                                     link_fail_max=0.1, link_heal_max=0.2)),
        30, 3, 3),
    # Launches over ticks 6-17: held down, then the rejoin at W = 14.
    "warmup_n3": (RaftConfig(
        n_groups=513, n_nodes=3, log_capacity=24, cmd_period=2, seed=6,
        p_drop=0.1, scenario=ScenarioSpec(warmup_down=14, crash_max=0.02,
                                          restart_max=0.2)).stressed(10),
        6, 3, 4),
}


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")


def rng_of(cfg, dev):
    return ttick.split_rng(ttick.make_rng(cfg, dev))


def assert_flat_equal(sa, sb, what):
    for k in sa:
        assert torch.equal(sa[k], sb[k]), f"{k} {what}"


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_CONFIGS))
def test_bank_fused_kernel_equals_plain(name):
    need_card()
    cfg, warm, launches, T = CARD_CONFIGS[name]
    dev = torch.device("cuda")
    a = init_state(cfg, dev)
    make_cuda_scan(cfg, warm, aux_source="inkernel", fused_ticks=1,
                   device=dev)(a)
    b = a.clone()
    base, tk, bk, scen = rng_of(cfg, dev)
    stat = cuda_tick.inkernel_aux_statics(cfg, base, tk, bk, scen)
    flags = ttick.make_flags(cfg)
    snap = cuda_tick.fused_snapshot_fields(cfg, telemetry=True, monitor=True,
                                           per_group=True)
    n0 = dict(cuda_tick.LAUNCHES)
    for i in range(launches):
        ops = cuda_tick.inkernel_aux_operands(stat, a.tick)
        sa, sb = ttick.flatten_state(cfg, a), ttick.flatten_state(cfg, b)
        ova, snapa = cuda_tick.fused_tick_kernel(cfg, sa, T, flags,
                                                 "inkernel", ops, snap)
        ovb, snapb = cuda_tick.fused_tick_plain(cfg, sb, T, flags,
                                                "inkernel", ops, snap)
        assert_flat_equal(sa, sb, f"after launch {i}")
        assert_flat_equal(snapa, snapb, f"snapshot, launch {i}")
        assert torch.equal(ova, ovb) and int(ova.sum()) == 0
        a.tick += T
        b.tick += T
    assert cuda_tick.LAUNCHES["fused_tick_kernel"] == \
        n0["fused_tick_kernel"] + launches
    assert cuda_tick.LAUNCHES["scenario_rows"] == \
        n0["scenario_rows"] + launches
    if not cfg.scenario.warmup_down:
        assert int(((a.role == 2) & a.up).any(0).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_CONFIGS))
def test_bank_tick_kernel_equals_plain(name):
    need_card()
    cfg, warm, launches, T = CARD_CONFIGS[name]
    dev = torch.device("cuda")
    a = init_state(cfg, dev)
    make_cuda_scan(cfg, warm, aux_source="inkernel", fused_ticks=1,
                   device=dev)(a)
    b = a.clone()
    base, tk, bk, scen = rng_of(cfg, dev)
    for t in range(launches * T):
        aux, flags = ttick.make_aux(cfg, base, tk, bk, a, scen=scen)
        sa, sb = ttick.flatten_state(cfg, a), ttick.flatten_state(cfg, b)
        da = cuda_tick.tick_kernel(cfg, sa, aux, flags)
        db = ttick.phase_body(cfg, sb, aux, flags)
        assert_flat_equal(sa, sb, f"after tick {t}")
        assert torch.equal(da, db), f"el_dirty at tick {t}"
        ttick.finish_tick(cfg, tk, a, sa, da)
        ttick.finish_tick(cfg, tk, b, sb, db)


@pytest.mark.cuda
def test_bank_delay_draw_equals_plain():
    need_card()
    cfg = CARD_CONFIGS["smoke_n3_delay_windows"][0]
    dev = torch.device("cuda")
    base, tk, bk, scen = rng_of(cfg, dev)
    stat = cuda_tick.inkernel_aux_statics(cfg, base, tk, bk, scen)
    ktab = cuda_tick.inkernel_aux_operands(stat, 17)["ktab"]
    got = cuda_tick.delay_draw(cfg, ktab)
    assert torch.equal(got.cpu(), cuda_tick.delay_draw_plain(cfg, ktab.cpu()))
    lo, hi = scen["delay_lo"].cpu(), scen["delay_hi"].cpu()
    assert ((got.cpu() >= lo) & (got.cpu() <= hi)).all()


@pytest.mark.cuda
def test_bank_wrapper_raises_instead_of_falling_back():
    need_card()
    cfg = CARD_CONFIGS["smoke_n3"][0]
    dev = torch.device("cuda")
    st = init_state(cfg, dev)
    base, tk, bk, scen = rng_of(cfg, dev)
    stat = cuda_tick.inkernel_aux_statics(cfg, base, tk, bk, scen)
    ops = cuda_tick.inkernel_aux_operands(stat, 0)
    # A key table without the bank's rows is refused, not run scalar.
    ops["ktab"] = ops["ktab"][:4].contiguous()
    with pytest.raises(ValueError, match="ktab"):
        cuda_tick.fused_tick_kernel(cfg, ttick.flatten_state(cfg, st), 4,
                                    ttick.make_flags(cfg), "inkernel", ops)


@pytest.mark.cuda
def test_farm_on_the_card_equals_the_cpu():
    need_card()
    cfg = fuzz.smoke_config(300)
    card = fuzz.run_fuzz_batch(cfg, 60, device="cuda")
    cpu = fuzz.run_fuzz_batch(cfg, 60, device="cpu")
    assert card["summary"] == cpu["summary"]
    assert card["telemetry"] == cpu["telemetry"]
    for k in cpu["universe"]:
        assert (card["universe"][k] == cpu["universe"][k]).all(), k
    mf = lambda c: fuzz.committed_rewrite_mutator(c, 40, 7)  # noqa: E731
    clean = RaftConfig(n_groups=64, n_nodes=3, log_capacity=32, cmd_period=2,
                       seed=2, scenario=ScenarioSpec(farm_seed=1,
                                                     drop_max=0.05)
                       ).stressed(10)
    a = fuzz.fuzz_farm(clean, 50, mutator_factory=mf, triage_confirm=False,
                       device="cuda")
    b = fuzz.fuzz_farm(clean, 50, mutator_factory=mf, triage_confirm=False,
                       device="cpu")
    assert a == b
    end, _, _ = fuzz.make_batch_runner(cfg, 60, device="cuda")()
    cend, _, _ = fuzz.make_batch_runner(cfg, 60, device="cpu")()
    for k in STATE_FIELDS:
        assert torch.equal(getattr(end, k).cpu(), getattr(cend, k)), k
