"""The fused-T kernel (raft_kotlin_tpu_torch/ops/csrc/fused_tick_kernel.cu)
against its plain version (ops/cuda_tick.fused_tick_plain) on the card: the
same state and launch operands, every state field, the overflow counts and
every snapshot bit-equal (tolerance zero: integers), in both aux forms, at
ragged group counts, with int16 logs and at seven nodes; and the staged
draw tables' overflow raising through the runner.

The kernel has no CPU mode, so every test here needs the card and skips
without one. The card's machine has no JAX; run them there with
`python -m pytest --noconftest -m cuda tests/test_torch_cuda_fused.py`.
"""

import pytest
import torch

from raft_kotlin_tpu_torch.constants import LEADER
from raft_kotlin_tpu_torch.models.state import STATE_FIELDS, init_state
from raft_kotlin_tpu_torch.ops import cuda_tick
from raft_kotlin_tpu_torch.ops import tick as ttick
from raft_kotlin_tpu_torch.ops.cuda_scan import make_cuda_scan
from raft_kotlin_tpu_torch.utils.config import RaftConfig

HEADLINE = dict(n_nodes=5, log_capacity=32, cmd_period=10, p_drop=0.25,
                p_crash=0.01, p_restart=0.08, p_link_fail=0.02,
                p_link_heal=0.08, seed=0)

# (config, stress, warm-up ticks, launches, T)
CARD_CONFIGS = {
    "headline_ragged": (dict(n_groups=4099, **HEADLINE), 10, 60, 4, 4),
    "int16_logs": (dict(n_groups=1000, n_nodes=3, log_capacity=8,
                        log_dtype="int16", cmd_period=3, p_drop=0.1,
                        p_crash=0.02, p_restart=0.1, seed=5), 10, 40, 5, 3),
    "seven_nodes": (dict(n_groups=515, n_nodes=7, log_capacity=12,
                         cmd_period=4, p_drop=0.2, p_link_fail=0.05,
                         p_link_heal=0.1, seed=2), 10, 40, 4, 5),
}


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")


def launch_ops(cfg, aux_source, s, tick0, T, rng, stat, resets_bound=None):
    base, tk, bk = rng
    if aux_source == "inkernel":
        return cuda_tick.inkernel_aux_operands(stat, tick0)
    return cuda_tick.staged_operands(cfg, base, tk, bk, tick0, s, T,
                                     resets_bound)


def assert_fused_equals_plain(cfg, dev, warm, launches, T, aux_source,
                              resets_bound=None):
    a = init_state(cfg, dev)
    make_cuda_scan(cfg, warm, aux_source="inkernel", fused_ticks=1,
                   device=dev)(a)
    b = a.clone()
    rng = ttick.make_rng(cfg, dev)
    stat = cuda_tick.inkernel_aux_statics(cfg, *rng)
    flags = ttick.make_flags(cfg)
    snap = STATE_FIELDS  # every field, so every snapshot path is compared
    n0 = cuda_tick.LAUNCHES["fused_tick_kernel"]
    ov_seen = 0
    for i in range(launches):
        tick0 = warm + i * T
        sa, sb = ttick.flatten_state(cfg, a), ttick.flatten_state(cfg, b)
        ops = launch_ops(cfg, aux_source, sa, tick0, T, rng, stat,
                         resets_bound)
        ova, snapa = cuda_tick.fused_tick_kernel(cfg, sa, T, flags,
                                                 aux_source, ops, snap)
        ovb, snapb = cuda_tick.fused_tick_plain(cfg, sb, T, flags,
                                                aux_source, ops, snap)
        assert torch.equal(ova, ovb), f"overflow at launch {i}"
        for k in STATE_FIELDS:
            assert torch.equal(sa[k], sb[k]), f"{k} after launch {i}"
            assert torch.equal(snapa[k], snapb[k]), f"{k} snapshots, launch {i}"
        ov_seen += int(ova.sum())
    assert cuda_tick.LAUNCHES["fused_tick_kernel"] == n0 + launches
    assert int((a.role == LEADER).any(0).sum()) > 0
    return ov_seen


@pytest.mark.cuda
@pytest.mark.parametrize("aux_source", ["staged", "inkernel"])
@pytest.mark.parametrize("name", sorted(CARD_CONFIGS))
def test_fused_kernel_equals_plain(name, aux_source):
    need_card()
    kw, stress, warm, launches, T = CARD_CONFIGS[name]
    ov = assert_fused_equals_plain(RaftConfig(**kw).stressed(stress),
                                   torch.device("cuda"), warm, launches, T,
                                   aux_source)
    assert ov == 0


@pytest.mark.cuda
def test_fused_kernel_counts_overflow_as_the_plain_version_does():
    """With a one-reset table window the staged launches overflow: the
    kernel's clamped draws and its counts still equal the plain version's,
    and the runner refuses the result."""
    need_card()
    kw, stress, warm, launches, T = CARD_CONFIGS["headline_ragged"]
    cfg = RaftConfig(**kw).stressed(stress)
    dev = torch.device("cuda")
    assert assert_fused_equals_plain(cfg, dev, warm, launches, T, "staged",
                                     resets_bound=1) > 0
    run = make_cuda_scan(cfg, 40, fused_ticks=4, _resets_bound=1,
                         device=dev)
    with pytest.raises(RuntimeError, match="overflow"):
        run(init_state(cfg, dev))


@pytest.mark.cuda
def test_fused_wrapper_raises_instead_of_falling_back():
    need_card()
    cfg = RaftConfig(n_groups=64, **HEADLINE).stressed(10)
    dev = torch.device("cuda")
    st = init_state(cfg, dev)
    s = ttick.flatten_state(cfg, st)
    rng = ttick.make_rng(cfg, dev)
    stat = cuda_tick.inkernel_aux_statics(cfg, *rng)
    ops = cuda_tick.inkernel_aux_operands(stat, 0)
    flags = ttick.make_flags(cfg)
    n0 = cuda_tick.LAUNCHES["fused_tick_kernel"]
    with pytest.raises(ValueError):
        cuda_tick.fused_tick_kernel(cfg, dict(s, up=s["up"].cpu()), 2, flags,
                                    "inkernel", ops)
    with pytest.raises(ValueError):
        cuda_tick.fused_tick_kernel(cfg, s, 2, flags, "inkernel",
                                    dict(ops, tkw=ops["tkw"][:, :8]))
    with pytest.raises(ValueError):
        cuda_tick.fused_tick_kernel(cfg, s, 2, flags, "staged", ops)
    assert cuda_tick.LAUNCHES["fused_tick_kernel"] == n0


@pytest.mark.cuda
def test_cuda_scan_on_the_card_equals_the_cpu():
    """The runner on the card (fused launches + in-kernel remainder, every
    observer on) against the same runner on the CPU, which runs the plain
    versions."""
    need_card()
    cfg = RaftConfig(n_groups=300, **HEADLINE).stressed(10)
    outs = []
    for dev in ("cuda", "cpu"):
        run = make_cuda_scan(cfg, 43, fused_ticks=4, aux_source="inkernel",
                             telemetry=True, monitor=True, trace=True,
                             device=dev)
        outs.append(run(init_state(cfg, dev)))
    (ea, tra, tela, mona), (eb, trb, telb, monb) = outs
    for k in STATE_FIELDS:
        assert torch.equal(getattr(ea, k).cpu(), getattr(eb, k)), k
    for d1, d2 in ((tra, trb), (tela, telb), (mona, monb)):
        assert d1.keys() == d2.keys()
        for k in d1:
            assert torch.equal(d1[k].cpu(), d2[k]), k
