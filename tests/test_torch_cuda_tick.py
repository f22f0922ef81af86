"""The tick kernel's wrapper (raft_kotlin_tpu_torch/ops/cuda_tick.py).

On the CPU the wrapper runs the kernel's plain version, and make_cuda_tick
must equal the JAX package's Pallas megakernel (make_pallas_tick, run in
interpret mode as tests/test_pallas.py runs it) tick by tick. The kernel
itself needs the card: the tests marked `cuda` compare it with the plain
version there and skip on a machine without one. Tolerance: zero (integers).

The card's machine has no JAX, so this file imports it only inside the test
that needs it; run the card tests there with
`python -m pytest --noconftest -m cuda tests/test_torch_cuda_tick.py`.
"""

import numpy as np
import pytest
import torch

from raft_kotlin_tpu_torch.constants import LEADER
from raft_kotlin_tpu_torch.models.state import (
    MAILBOX_FIELDS, STATE_FIELDS, init_state, state_to_numpy)
from raft_kotlin_tpu_torch.ops import cuda_tick
from raft_kotlin_tpu_torch.ops import tick as ttick
from raft_kotlin_tpu_torch.utils.config import RaftConfig, mailbox_config

HEADLINE = dict(n_nodes=5, log_capacity=32, cmd_period=10, p_drop=0.25,
                p_crash=0.01, p_restart=0.08, p_link_fail=0.02,
                p_link_heal=0.08, seed=0)


def headline(groups):
    return RaftConfig(n_groups=groups, **HEADLINE).stressed(10)


def test_make_cuda_tick_on_cpu_equals_pallas_interpret():
    """32 groups from tick 40 (elections, commits and faults live), 5 ticks:
    the port's kernel entry point on CPU tensors against the Pallas kernel
    in interpret mode (4 lane tiles of 8)."""
    import jax
    import jax.numpy as jnp

    from raft_kotlin_tpu.models.state import RaftState as JState
    from raft_kotlin_tpu.ops.pallas_tick import make_pallas_tick
    from raft_kotlin_tpu.utils.config import RaftConfig as JConfig

    jc = JConfig(n_groups=32, **HEADLINE).stressed(10)
    tc = headline(32)
    st = init_state(tc, "cpu")
    plain = ttick.make_tick(tc, "cpu")
    for _ in range(40):
        plain(st)
    arrs = state_to_numpy(st)
    js = JState(**{k: jnp.asarray(arrs[k]) for k in STATE_FIELDS},
                tick=jnp.asarray(arrs["tick"], jnp.int32))
    ptick = jax.jit(make_pallas_tick(jc, interpret=True, tile_g=8))
    ktick = cuda_tick.make_cuda_tick(tc, "cpu")
    before = dict(cuda_tick.LAUNCHES)
    for _ in range(5):
        js = ptick(js)
        ktick(st)
        jn = jax.device_get(js)
        for k in STATE_FIELDS:
            want = np.asarray(getattr(jn, k))
            got = getattr(st, k).numpy()
            assert got.dtype == want.dtype, k
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{k} at tick {st.tick}")
        assert st.tick == int(jn.tick)
    # The CPU path runs the plain version: no kernel launch is counted.
    assert cuda_tick.LAUNCHES == before


def test_kernel_operands_accept_the_tick_path():
    """What make_aux and flatten_state hand the kernel passes every operand
    check (dtype, shape, contiguity) — the checks the card run applies."""
    cfg = headline(37)
    st = init_state(cfg, "cpu")
    tick = ttick.make_tick(cfg, "cpu")
    for _ in range(3):
        tick(st)
    base, tk, bk = ttick.make_rng(cfg, "cpu")
    inject = torch.full((37, 5), -1, dtype=torch.int32)
    aux, flags = ttick.make_aux(cfg, base, tk, bk, st, inject)
    ops, bits = cuda_tick.kernel_operands(
        cfg, ttick.flatten_state(cfg, st), aux, flags)
    assert bits == 1 | 2 | 4 | 8
    # The state, the 13 §10 slots (none on this config), 10 aux channels
    # (every one but the §10 delays, the last).
    n_st, n_mb = len(STATE_FIELDS), len(MAILBOX_FIELDS)
    assert len(ops) == n_st + n_mb + 10
    assert all(o is not None for o in ops[:n_st] + ops[n_st + n_mb:-1])
    assert all(o is None for o in ops[n_st:n_st + n_mb]) and ops[-1] is None
    aux2, flags2 = ttick.make_aux(cfg, base, tk, bk, st)
    ops2, bits2 = cuda_tick.kernel_operands(
        cfg, ttick.flatten_state(cfg, st), aux2, flags2)
    assert bits2 == 1 | 2 | 4 and ops2[-2] is None  # no inject operand
    # On the §10 mailbox config the slots and the drawn delays ride too.
    mcfg = mailbox_config(37)
    mst = init_state(mcfg, "cpu")
    aux3, flags3 = ttick.make_aux(mcfg, *ttick.make_rng(mcfg, "cpu"), mst)
    ops3, bits3 = cuda_tick.kernel_operands(
        mcfg, ttick.flatten_state(mcfg, mst), aux3, flags3)
    assert bits3 == 1 | 2 | 4 | 16
    assert all(o is not None for o in ops3[n_st:n_st + n_mb] + [ops3[-1]])


def test_kernel_operands_reject_what_the_kernel_does_not_take():
    cfg = headline(16)
    st = init_state(cfg, "cpu")
    base, tk, bk = ttick.make_rng(cfg, "cpu")
    aux, flags = ttick.make_aux(cfg, base, tk, bk, st)
    s = ttick.flatten_state(cfg, st)
    for bad in (dict(s, term=s["term"].to(torch.int64)),
                dict(s, votes=s["votes"].t().contiguous().t()),
                dict(s, log_cmd=s["log_cmd"][:, :8])):
        with pytest.raises(ValueError):
            cuda_tick.kernel_operands(cfg, bad, aux, flags)
    with pytest.raises(ValueError):
        cuda_tick.kernel_operands(
            cfg, s, dict(aux, edge_iid=aux["edge_iid"].to(torch.int32)), flags)
    with pytest.raises(ValueError):  # the §10 flag on a config without it
        cuda_tick.kernel_operands(cfg, s, aux, ttick.BodyFlags(delay=True))
    with pytest.raises(NotImplementedError):  # the mailbox on deep logs
        cuda_tick.kernel_operands(cfg, s, aux, ttick.BodyFlags(
            delay=True, dyn_log=True, batched=True))


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")


CARD_CONFIGS = {
    "headline_ragged": (dict(n_groups=4099, **HEADLINE), 10, 100, 0),
    # Rows of 2- and 4-byte fields 16-byte aligned (the tile form's bulk
    # copies), of 1-byte ones not, and a last tile of 8 groups.
    "mailbox_aligned_ragged": (dict(n_groups=4104, delay_lo=1, delay_hi=3,
                                    **HEADLINE), 10, 100, 0),
    "int16_logs_inject": (dict(n_groups=1000, n_nodes=3, log_capacity=8,
                               log_dtype="int16", cmd_period=3, p_drop=0.1,
                               p_crash=0.02, p_restart=0.1, seed=5), 10, 150, 4),
    "seven_nodes": (dict(n_groups=515, n_nodes=7, log_capacity=12,
                         cmd_period=4, p_drop=0.2, p_link_fail=0.05,
                         p_link_heal=0.1, seed=2), 10, 120, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_CONFIGS))
def test_cuda_kernel_equals_plain(name):
    """The kernel and phase_body on the card, same state and aux every
    tick: all state fields and el_dirty bit-equal."""
    need_card()
    kw, stress, ticks, inject_every = CARD_CONFIGS[name]
    assert_kernel_equals_plain(RaftConfig(**kw).stressed(stress),
                               torch.device("cuda"), ticks, inject_every)


@pytest.mark.cuda
def test_cuda_kernel_on_the_last_card():
    """On a machine with several cards, the kernel runs on the card its
    tensors are on, not on the first one."""
    need_card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA cards")
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    assert_kernel_equals_plain(headline(1000), dev, 60, 0)


def assert_kernel_equals_plain(cfg, dev, ticks, inject_every):
    a = init_state(cfg, dev)
    b = a.clone()
    base, tk, bk = ttick.make_rng(cfg, dev)
    gen = np.random.default_rng(7)
    n0 = cuda_tick.LAUNCHES["tick_kernel"]
    for t in range(ticks):
        inj = None
        if inject_every and t % inject_every == 0:
            raw = gen.integers(-3, 50, (cfg.n_groups, cfg.n_nodes))
            inj = torch.from_numpy(np.where(raw < 0, -1, raw + 1000 * t)
                                   .astype(np.int32)).to(dev)
        aux, flags = ttick.make_aux(cfg, base, tk, bk, a, inj)
        sa, sb = ttick.flatten_state(cfg, a), ttick.flatten_state(cfg, b)
        da = cuda_tick.tick_kernel(cfg, sa, aux, flags)
        db = ttick.phase_body(cfg, sb, aux, flags)
        assert torch.equal(da, db), f"el_dirty at tick {a.tick}"
        for k in sa:
            assert torch.equal(sa[k], sb[k]), f"{k} at tick {a.tick}"
        ttick.finish_tick(cfg, tk, a, sa, da)
        ttick.finish_tick(cfg, tk, b, sb, db)
    assert cuda_tick.LAUNCHES["tick_kernel"] == n0 + ticks
    assert int((a.role == LEADER).any(0).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_nodes", [3, 5, 7])
def test_tile_form_fits_a_block_without_opting_in(n_nodes):
    """The tile form (the mailbox's one-tick launches with unpacked
    compute) asks for no more shared memory than a block may take without
    cudaFuncSetAttribute (48 KB), at every node count the port builds, and
    at least one block of it is resident on an SM."""
    need_card()
    cfg = RaftConfig(n_groups=4104, n_nodes=n_nodes, log_capacity=8,
                     delay_lo=1, delay_hi=3, seed=3, p_drop=0.1)
    dev = torch.device("cuda")
    st = init_state(cfg, dev)
    base, tk, bk = ttick.make_rng(cfg, dev)
    aux, flags = ttick.make_aux(cfg, base, tk, bk, st)
    info = cuda_tick.tick_kernel_info(cfg, ttick.flatten_state(cfg, st),
                                      aux, flags)
    assert info["tile"] == 1 and 0 < info["smem_bytes"] <= 48 * 1024, info
    assert info["blocks_per_sm"] >= 1, info


@pytest.mark.cuda
def test_cuda_wrapper_raises_instead_of_falling_back():
    need_card()
    cfg = headline(64)
    dev = torch.device("cuda")
    st = init_state(cfg, dev)
    base, tk, bk = ttick.make_rng(cfg, dev)
    aux, flags = ttick.make_aux(cfg, base, tk, bk, st)
    s = ttick.flatten_state(cfg, st)
    n0 = cuda_tick.LAUNCHES["tick_kernel"]
    with pytest.raises(ValueError):
        cuda_tick.tick_kernel(cfg, dict(s, up=s["up"].cpu()), aux, flags)
    with pytest.raises(ValueError):
        cuda_tick.tick_kernel(cfg, s, dict(aux, bdraw=aux["bdraw"].int()),
                              flags)
    assert cuda_tick.LAUNCHES["tick_kernel"] == n0
