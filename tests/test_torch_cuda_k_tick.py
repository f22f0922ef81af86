"""Kernel #7 (the K-tick kernel, `raft_k_tick_launch` in
raft_kotlin_tpu_torch/ops/csrc/fused_tick_kernel.cu), kernel #8 (the
whole-log copy floor, ops/csrc/copy_floor.cu) and the §12 edge lattice
alone (kt_rng.cuh's part_down, `cuda_tick.part_down`) against their plain
versions on the card, tolerance zero (integers):

- the K-tick kernel ≡ ops/cuda_tick.k_tick_plain at five and three nodes,
  on the fault soup and the τ=0 mailbox (delay_lo == 0, the 8N - 3 reset
  bound), int16 and int32 logs, ragged group counts, its (N, G) overflow
  counts included — nonzero with the reset bound forced to 1;
- make_cuda_scan(k_per_launch=3) on the card ≡ the same on the CPU;
- the copy floor ≡ copy_floor_plain (the identity) at odd shapes, int16
  and int32, from aligned and misaligned starts;
- part_down ≡ part_down_plain at the farm's smoke bank (G = 3,000 and
  4,099), a leader program's cut edges included;
- the wrappers raise on what the kernels do not take.

The kernels have no CPU mode, so every test here needs the card and skips
without one. The card's machine has no JAX; run them there with
`python -m pytest --noconftest -m cuda tests/test_torch_cuda_k_tick.py`.
"""

import pytest
import torch

from raft_kotlin_tpu_torch.api import fuzz
from raft_kotlin_tpu_torch.constants import LEADER
from raft_kotlin_tpu_torch.models.state import STATE_FIELDS, init_state
from raft_kotlin_tpu_torch.ops import copy_floor, cuda_tick
from raft_kotlin_tpu_torch.ops import tick as ttick
from raft_kotlin_tpu_torch.ops.cuda_scan import make_cuda_scan
from raft_kotlin_tpu_torch.utils import rng as trng
from raft_kotlin_tpu_torch.utils.config import RaftConfig

SOUP = dict(cmd_period=5, p_drop=0.1, p_crash=0.02, p_restart=0.1,
            p_link_fail=0.02, p_link_heal=0.1)
CHURN = dict(el_lo=2, el_hi=3, hb_ticks=2, round_ticks=3, retry_ticks=2,
             bo_lo=2, bo_hi=3)

# (config, warm-up ticks, launches, K, resets bound override)
CASES = {
    "soup_n5": (RaftConfig(n_groups=4099, n_nodes=5, log_capacity=8,
                           seed=11, **SOUP).stressed(10), 40, 3, 4, None),
    "soup_n3_int16": (RaftConfig(n_groups=1000, n_nodes=3, log_capacity=8,
                                 log_dtype="int16", seed=5, **SOUP
                                 ).stressed(10), 40, 3, 3, None),
    "tau0_mailbox_n5": (RaftConfig(n_groups=2051, n_nodes=5, log_capacity=8,
                                   cmd_period=5, p_drop=0.1, p_crash=0.02,
                                   p_restart=0.1, mailbox=True, seed=21
                                   ).stressed(10), 30, 3, 3, None),
    "tau0_mailbox_n3": (RaftConfig(n_groups=1030, n_nodes=3, log_capacity=8,
                                   cmd_period=5, p_drop=0.1, p_crash=0.02,
                                   p_restart=0.1, mailbox=True, seed=21
                                   ).stressed(10), 30, 3, 3, None),
    # 2- and 4-byte rows 16-byte aligned (the tile's bulk copies), 1-byte
    # ones not, a last tile of 8 groups.
    "aligned_ragged_mailbox_n5": (RaftConfig(n_groups=4104, n_nodes=5,
                                             log_capacity=8, delay_lo=1,
                                             delay_hi=3, seed=4, **SOUP
                                             ).stressed(10), 30, 3, 4, None),
    "delayed_mailbox_n5": (RaftConfig(n_groups=777, n_nodes=5,
                                      log_capacity=8, delay_lo=1, delay_hi=3,
                                      seed=4, **SOUP).stressed(10), 30, 3, 4,
                           None),
    "churn_bound1_n3": (RaftConfig(n_groups=1500, n_nodes=3, log_capacity=8,
                                   seed=1, **CHURN), 6, 3, 4, 1),
    "churn_bound1_n5": (RaftConfig(n_groups=600, n_nodes=5, log_capacity=8,
                                   seed=2, **CHURN), 6, 3, 4, 1),
}


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")


def k_ops(cfg, rng, s, tick0, K, resets_bound=None):
    base, tk, bk, scen = ttick.split_rng(rng)
    ops = cuda_tick.staged_operands(cfg, base, tk, bk, tick0, s, K,
                                    resets_bound, scen=scen)
    return ops, ops.pop("el_table"), ops.pop("b_table")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_k_tick_kernel_equals_plain(name):
    need_card()
    dev = torch.device("cuda:0")
    cfg, warm, launches, K, rb = CASES[name]
    a = init_state(cfg, dev)
    make_cuda_scan(cfg, warm, fused_ticks=1, aux_source="inkernel",
                   device=dev)(a)
    b = a.clone()
    rng = ttick.make_rng(cfg, dev)
    n0 = cuda_tick.LAUNCHES["k_tick"]
    ov_seen = 0
    for i in range(launches):
        sa, sb = ttick.flatten_state(cfg, a), ttick.flatten_state(cfg, b)
        slabs, el, bt = k_ops(cfg, rng, sa, a.tick, K, rb)
        ova = cuda_tick.k_tick_kernel(cfg, sa, K, slabs, el, bt)
        ovb = cuda_tick.k_tick_plain(cfg, sb, K, slabs, el, bt)
        assert torch.equal(ova, ovb), f"overflow at launch {i}"
        for k in STATE_FIELDS:
            assert torch.equal(sa[k], sb[k]), f"{k} after launch {i}"
        ov_seen += int(ova.sum())
        a.tick += K
        b.tick += K
    assert cuda_tick.LAUNCHES["k_tick"] == n0 + launches
    assert int((a.role == LEADER).any(0).sum()) > 0
    assert (ov_seen > 0) == (rb is not None)


@pytest.mark.cuda
def test_k_tick_runner_on_the_card_equals_the_cpu():
    need_card()
    cfg, *_ = CASES["soup_n5"]
    card = init_state(cfg, "cuda")
    cpu = init_state(cfg, "cpu")
    cuda_tick.reset_launch_counts()
    make_cuda_scan(cfg, 10, k_per_launch=3, device="cuda")(card)
    assert cuda_tick.LAUNCHES["k_tick"] == 3
    assert cuda_tick.LAUNCHES["tick_kernel"] == 1
    assert cuda_tick.LAUNCHES["fused_tick_kernel"] == 0
    make_cuda_scan(cfg, 10, k_per_launch=3, device="cpu")(cpu)
    for k in STATE_FIELDS:
        assert torch.equal(getattr(card, k).cpu(), getattr(cpu, k)), k
    with pytest.raises(RuntimeError, match="overflow"):
        churn, *_ = CASES["churn_bound1_n3"]
        make_cuda_scan(churn, 24, k_per_launch=4, _resets_bound=1,
                       device="cuda")(init_state(churn, "cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
@pytest.mark.parametrize("shape,offset", [((3 * 1001, 4099), 0),
                                          ((7 * 13, 1027), 1),
                                          ((5, 3), 3), ((1, 1), 0)])
def test_copy_floor_equals_plain(dtype, shape, offset):
    need_card()
    n = shape[0] * shape[1]
    gen = torch.Generator(device="cuda").manual_seed(n + offset)
    buf = torch.randint(-30_000, 30_000, (2, n + offset), dtype=dtype,
                        device="cuda", generator=gen)
    lt, lc = (x[offset:].view(shape) for x in buf)
    want = buf.clone()
    n0 = copy_floor.LAUNCHES["copy_floor"]
    copy_floor.copy_floor(lt, lc)
    torch.cuda.synchronize()
    assert copy_floor.LAUNCHES["copy_floor"] == n0 + 1
    assert torch.equal(buf, want)
    pt, pc = lt.clone(), lc.clone()
    copy_floor.copy_floor_plain(pt, pc)
    assert torch.equal(pt, lt) and torch.equal(pc, lc)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [3000, 4099])
def test_part_down_equals_plain(groups):
    """Two ticks after a 30-tick warm-up, and the first later tick at which
    a leader program with a live leader is in its window: there it must
    cut that leader's edges."""
    need_card()
    dev = torch.device("cuda:0")
    cfg = fuzz.smoke_config(groups)
    st = init_state(cfg, dev)
    make_cuda_scan(cfg, 30, aux_source="inkernel", device=dev)(st)
    base, tk, bk, scen = ttick.split_rng(ttick.make_rng(cfg, dev))
    stat = cuda_tick.inkernel_aux_statics(cfg, base, tk, bk, scen)
    lead = (st.role == LEADER) & st.up
    N = cfg.n_nodes
    s_n, r_n = torch.arange(N * N, device=dev).div(N, rounding_mode="floor"), \
        torch.arange(N * N, device=dev) % N
    # (N*N, G): the edges a leader program cuts at tick t.
    leader_cut = lambda t: (  # noqa: E731
        (scen["part_kind"] == trng.PART_LEADER)
        & trng.scenario_active(scen, t)
        & (lead[s_n] | lead[r_n]) & (s_n != r_n)[:, None])
    t_lead = next(t for t in range(st.tick, st.tick + 200)
                  if bool(leader_cut(t).any()))
    for t in (st.tick, st.tick + 7, t_lead):
        ktab = cuda_tick.inkernel_aux_operands(stat, t)["ktab"]
        got = cuda_tick.part_down(cfg, ktab, lead)
        assert torch.equal(got, cuda_tick.part_down_plain(cfg, ktab, lead))
        assert 0 < int((~got).sum()) < got.numel()
    assert not bool(got[leader_cut(t_lead)].any())


@pytest.mark.cuda
def test_wrappers_raise_instead_of_falling_back():
    need_card()
    copy_floor.reset_counts()
    cfg, *_ = CASES["soup_n5"]
    st = init_state(cfg, "cuda")
    s = ttick.flatten_state(cfg, st)
    slabs, el, bt = k_ops(cfg, ttick.make_rng(cfg, "cuda"), s, 0, 2)
    with pytest.raises(ValueError):
        cuda_tick.k_tick_kernel(cfg, s, 2, slabs, el.to(torch.int32), bt)
    with pytest.raises(ValueError):
        cuda_tick.k_tick_kernel(cfg, s, 3, slabs, el, bt)  # K-stacked for 2
    lt = torch.zeros((6, 5), dtype=torch.int16, device="cuda")
    with pytest.raises(ValueError):
        copy_floor.copy_floor(lt, lt.to(torch.int32))
    with pytest.raises(ValueError):
        copy_floor.copy_floor(lt.t(), lt.t())
    with pytest.raises(ValueError):
        copy_floor.copy_floor(lt.float(), lt.float())
    assert copy_floor.PLAIN_ON_CUDA["copy_floor"] == 0
