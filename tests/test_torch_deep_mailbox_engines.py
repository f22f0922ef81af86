"""The deep mailbox's two engines against each other, port only, on the CPU
(tests/test_torch_deep_mailbox.py holds both to the JAX package).
Tolerance: zero — every field, the 13 slot planes included.

- the batched engine (the known-delivery batch through the deep gather's
  plain version: 6N+1 term rows, 3N cmd rows a node) ≡ the per-pair engine
  (make_tick(batched=False)) every tick over 100 ticks at the delay
  windows [1,1], [1,3] and [2,5] (tests/test_mailbox_deep.py's soups, 4
  groups), and at BASELINE config 5's shape (utils/config.deep_config:
  N = 7, C = 10,000, int16 logs) with [1,3] at 16 groups over 30 ticks;
  one gather a tick asks for rows in [0, C) only;
- the per-pair engine at τ=0 ([0,3]) ≡ the shallow direct-read lattice
  (tests/test_torch_deep.py's direct_read_tick) over 100 ticks, and the
  deep tick wrapper (make_deep_tick, make_run(impl="kernel")) on the CPU
  launches and counts nothing;
- the refusals that stay: §15 compaction, the frontier cache's mailbox
  half (make_deep_scan on a mailbox config raises before any work), and
  the shallow tick kernels on deep configs.
"""

import dataclasses

import pytest
import torch

from raft_kotlin_tpu_torch.models.state import check_supported, init_state
from raft_kotlin_tpu_torch.ops import (
    cuda_tick, deep_cache, deep_gather, deep_scatter)
from raft_kotlin_tpu_torch.ops import tick as ttick
from raft_kotlin_tpu_torch.ops.cuda_scan import make_cuda_scan
from raft_kotlin_tpu_torch.utils.config import RaftConfig, deep_config

BASE = dict(n_groups=4, n_nodes=3, log_capacity=256, cmd_period=3,
            p_drop=0.15, p_crash=0.02, p_restart=0.1, seed=13)


def mailbox(cfg, lo, hi, **kw):
    return dataclasses.replace(cfg, delay_lo=lo, delay_hi=hi, **kw)


# name -> (config, ticks); seeds as tests/test_mailbox_deep.py's (MB13's
# 13, the other windows' 17).
CASES = {
    "d11": (mailbox(RaftConfig(**BASE).stressed(10), 1, 1, seed=17), 100),
    "d13": (mailbox(RaftConfig(**BASE).stressed(10), 1, 3), 100),
    "d25": (mailbox(RaftConfig(**BASE).stressed(10), 2, 5, seed=17), 100),
    "config5_d13": (mailbox(deep_config(16), 1, 3), 30),
}


def assert_engines_equal(cfg, ticks, a_step, b_step):
    """Two steppers from boot stay bit-equal in every field each tick;
    returns the end state and the most append slots in flight at a tick's
    end."""
    a, b = init_state(cfg, "cpu"), init_state(cfg, "cpu")
    in_flight = 0
    for _ in range(ticks):
        a_step(a)
        b_step(b)
        for k in a.fields():
            assert torch.equal(getattr(a, k), getattr(b, k)), \
                f"{k} at tick {a.tick}"
        in_flight = max(in_flight, int((a.aq_due >= 0).sum()))
    return a, in_flight


@pytest.mark.parametrize("name", sorted(CASES))
def test_batched_mailbox_engine_equals_per_pair(name, monkeypatch):
    cfg, ticks = CASES[name]
    N, C = cfg.n_nodes, cfg.phys_capacity
    assert ttick.make_flags(cfg).batched
    rows = []
    plain = deep_gather.gather_plain

    def spy(lt, lc, r, N_, C_, Rc=None):
        assert int(r.min()) >= 0 and int(r.max()) < C
        rows.append((r.shape[0], Rc))
        return plain(lt, lc, r, N_, C_, Rc)

    monkeypatch.setattr(deep_gather, "gather_plain", spy)
    end, in_flight = assert_engines_equal(
        cfg, ticks, ttick.make_tick(cfg, "cpu"),
        ttick.make_tick(cfg, "cpu", batched=False))
    assert rows == [(N * (6 * N + 1), 3 * N)] * ticks
    assert int(end.commit.max()) > 0 and in_flight > 0


def direct_read_tick(cfg):
    """The shallow lattice on a deep config (tests/test_torch_deep.py's)."""
    def body(cfg, s, aux, flags):
        return ttick.phase_body(cfg, s, aux, dataclasses.replace(
            flags, dyn_log=False, batched=False))

    return ttick.make_stepper(cfg, "cpu", body)


def test_per_pair_tau0_equals_direct_reads():
    """τ=0 ([0,3]): make_flags pins the per-pair engine even when asked for
    the batched one; it equals the direct-read lattice over 100 ticks, and
    the deep tick wrapper on the CPU launches nothing and counts no plain
    call on a card."""
    cfg = mailbox(RaftConfig(**BASE).stressed(10), 0, 3, seed=17)
    assert not ttick.make_flags(cfg, batched=True).batched
    deep_gather.reset_counts()
    deep_scatter.reset_counts()
    end, in_flight = assert_engines_equal(
        cfg, 100, ttick.make_deep_tick(cfg, "cpu", batched=True),
        direct_read_tick(cfg))
    assert int(end.commit.max()) > 0 and in_flight > 0
    assert int((end.phys_len > end.last_index).sum()) > 0  # §3 ghost state
    assert deep_gather.LAUNCHES == {"deep_gather": 0}
    assert deep_scatter.LAUNCHES == {"deep_scatter": 0}
    assert deep_gather.PLAIN_ON_CUDA == {"deep_gather": 0}
    runs = [ttick.make_run(cfg, 20, trace=True, telemetry=True, impl=impl,
                           device="cpu")(init_state(cfg, "cpu"))
            for impl in ("kernel", "plain")]
    for k in runs[0][0].fields():
        assert torch.equal(getattr(runs[0][0], k), getattr(runs[1][0], k)), k


def test_refusals_that_stay():
    """§15 compaction under the mailbox pins the per-pair engine (JAX's
    rule; the batched flags raise ValueError) and make_deep_scan refuses
    it with JAX's ValueError; the frontier
    cache's mailbox half (make_deep_scan on a mailbox config raises
    NotImplementedError at build time, before the device is even
    resolved; pair_vals_for(True)); the batched engine at τ=0 (JAX's
    assert, a ValueError here); the shallow tick kernels on deep configs,
    the mailbox ones included."""
    deep_mb = CASES["d13"][0]
    compact = dataclasses.replace(deep_mb, compact_watermark=8,
                                  compact_chunk=4)
    assert not ttick.make_flags(compact, batched=True).batched
    ttick.check_flags(ttick.make_flags(compact))
    check_supported(compact)
    with pytest.raises(ValueError, match="per-pair engine"):
        ttick.check_flags(dataclasses.replace(ttick.make_flags(compact),
                                              batched=True))
    with pytest.raises(ValueError, match="§15 compaction"):
        deep_cache.make_deep_scan(compact, 4, device="cpu")
    tau0 = mailbox(deep_mb, 0, 3)
    for cfg in (deep_mb, tau0):
        # device="cuda" would raise RuntimeError on a machine without a
        # card if make_deep_scan got that far.
        with pytest.raises(NotImplementedError, match="mailbox half"):
            deep_cache.make_deep_scan(cfg, 4, device="cuda")
    with pytest.raises(NotImplementedError, match="item 3"):
        deep_cache.pair_vals_for(True)
    # The batched engine asked for at τ=0 directly (make_flags never does).
    s = ttick.flatten_state(tau0, init_state(tau0, "cpu"))
    with pytest.raises(ValueError, match="known-delivery"):
        ttick.phase_body(tau0, s, {}, dataclasses.replace(
            ttick.make_flags(tau0), batched=True))
    for cfg in (deep_mb, tau0, deep_config(8)):
        for entry in (lambda: cuda_tick.make_cuda_tick(cfg, "cpu"),
                      lambda: make_cuda_scan(cfg, 2, device="cpu")):
            with pytest.raises(NotImplementedError, match="deep"):
                entry()
