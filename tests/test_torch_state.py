"""The port's config copy and boot state must equal the JAX package's: the
config dataclasses field for field, init_state value for value in the same
storage dtypes, and the numpy bridge must round-trip a state exactly."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from raft_kotlin_tpu.models.state import init_state as j_init_state
from raft_kotlin_tpu.utils.config import RaftConfig as JConfig
from raft_kotlin_tpu.utils.config import ScenarioSpec as JSpec
from raft_kotlin_tpu_torch.models.state import (
    STATE_FIELDS, field_dtype, init_state, state_from_numpy, state_to_numpy)
from raft_kotlin_tpu_torch.ops.tick import make_tick
from raft_kotlin_tpu_torch.utils.config import RaftConfig, ScenarioSpec
from raft_kotlin_tpu_torch.utils.config import config_from_dict, deep_config

HEADLINE = dict(n_groups=64, n_nodes=5, log_capacity=32, cmd_period=10,
                p_drop=0.25, p_crash=0.01, p_restart=0.08, p_link_fail=0.02,
                p_link_heal=0.08, seed=0)
# tests/test_differential.py's configs that carry no §10 mailbox, the
# headline config at 64 groups, and an int16-log config.
STATE_CONFIGS = {
    "election": (dict(n_groups=4, n_nodes=3, seed=17), 1),
    "replication": (dict(n_groups=4, n_nodes=5, seed=23, cmd_period=25,
                         cmd_node=2), 1),
    "faults": (dict(n_groups=6, n_nodes=3, seed=31, p_drop=0.2), 1),
    "deep_dyn": (dict(n_groups=2, n_nodes=3, log_capacity=512, seed=29,
                      p_drop=0.15, cmd_period=3), 10),
    "deep_soup": (dict(n_groups=4, n_nodes=5, log_capacity=300, seed=61,
                       p_drop=0.2, p_crash=0.01, p_restart=0.1,
                       p_link_fail=0.03, p_link_heal=0.1, cmd_period=2), 10),
    "churn": (dict(n_groups=8, n_nodes=5, seed=47, p_drop=0.15, cmd_period=7,
                   cmd_node=1), 10),
    "headline": (HEADLINE, 10),
    "int16_logs": (dict(n_groups=5, n_nodes=7, log_capacity=16,
                        log_dtype="int16", seed=-3), 1),
    # BASELINE config 5 (utils/config.deep_config) at 4 groups.
    "config5": (dict(n_groups=4, n_nodes=7, log_capacity=10_000,
                     log_dtype="int16", cmd_period=2, p_drop=0.05, seed=3),
                10),
}


def both(name):
    kw, stress = STATE_CONFIGS[name]
    return JConfig(**kw).stressed(stress), RaftConfig(**kw).stressed(stress)


@pytest.mark.parametrize("name", sorted(STATE_CONFIGS))
def test_config_copy_equals_jax(name):
    jc, tc = both(name)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    for prop in ("phys_capacity", "majority", "uses_mailbox", "uses_dyn_log",
                 "uses_compaction", "uses_serving", "known_delivery"):
        assert getattr(jc, prop) == getattr(tc, prop), prop
    assert jc.state_bytes_per_group() == tc.state_bytes_per_group()


def test_config_from_dict_with_scenario():
    spec = dict(farm_seed=3, drop_max=0.2, partitions=["split", "asym"])
    jd = dataclasses.asdict(JConfig(n_groups=4, scenario=JSpec(**spec)))
    td = dataclasses.asdict(RaftConfig(n_groups=4, scenario=ScenarioSpec(**spec)))
    assert jd == td
    rt = config_from_dict(td)
    assert dataclasses.asdict(rt) == td
    assert isinstance(rt.scenario, ScenarioSpec)


@pytest.mark.parametrize("name", sorted(STATE_CONFIGS))
def test_init_state_equals_jax(name):
    jc, tc = both(name)
    js = jax.device_get(j_init_state(jc))
    ts = init_state(tc, "cpu")
    for k in STATE_FIELDS:
        want = np.asarray(getattr(js, k))
        got = getattr(ts, k).numpy()
        assert got.dtype == want.dtype, (k, got.dtype, want.dtype)
        assert getattr(ts, k).dtype == field_dtype(k, tc)
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert ts.tick == int(js.tick) == 0


def test_deep_state_crosses_the_numpy_bridge():
    """Config 5's boot state, (N*C, G)-deep int16 logs and NARROW16
    positions: the JAX package's init_state carried into the port through
    numpy equals the port's own init_state, and the port's deep_config is
    the JAX package's config-5 shape."""
    jc, tc = both("config5")
    assert dataclasses.asdict(deep_config(4)) == dataclasses.asdict(tc)
    assert tc.uses_dyn_log and tc.phys_capacity == 10_000
    js = jax.device_get(j_init_state(jc))
    arrs = {k: np.asarray(getattr(js, k)) for k in STATE_FIELDS}
    arrs["tick"] = int(js.tick)
    back = state_from_numpy(arrs, "cpu", cfg=tc)
    own = init_state(tc, "cpu")
    for k in STATE_FIELDS:
        assert torch.equal(getattr(back, k), getattr(own, k)), k
    assert own.log_term.shape == (7, 10_000, 4)
    assert own.log_term.dtype == torch.int16
    assert own.next_index.dtype == own.last_index.dtype == torch.int16
    again = state_to_numpy(back)
    for k in STATE_FIELDS:
        np.testing.assert_array_equal(again[k], arrs[k], err_msg=k)


@pytest.mark.parametrize("kw", [
    # The §10 mailbox on deep logs is ported (the first two: they run).
    dict(delay_lo=0, delay_hi=2, log_capacity=512),
    dict(mailbox=True, log_capacity=512),
    dict(compact_watermark=4, compact_chunk=2),
    # §12 banks are ported on shallow logs, without the §19 / §20 channels.
    dict(scenario=ScenarioSpec(drop_max=0.1, timeout_windows=True)),
    dict(compact_watermark=4, compact_chunk=2, delay_lo=1, delay_hi=3),
    dict(log_capacity=512, scenario=ScenarioSpec(drop_max=0.1)),
])
def test_unported_configs_raise(kw):
    cfg = RaftConfig(n_groups=4, **kw)
    if cfg.uses_compaction:
        # Ported: the state carries the three snapshot planes and widens
        # its positions to int32 (with the mailbox's slots too).
        st = init_state(cfg, "cpu")
        make_tick(cfg, "cpu")(st)
        assert st.snap_index.dtype == torch.int32 and st.tick == 1
        assert st.commit.dtype == torch.int32
        assert (st.vq_due is not None) == cfg.uses_mailbox
        return
    if cfg.uses_mailbox and cfg.uses_dyn_log and not cfg.uses_compaction \
            and cfg.scenario is None:
        # Ported: the state carries the slots, and the per-pair engine
        # (every τ=0 window's) steps it as the batched one asked for does.
        a, b = init_state(cfg, "cpu"), init_state(cfg, "cpu")
        make_tick(cfg, "cpu")(a)
        make_tick(cfg, "cpu", batched=False)(b)
        assert a.vq_due is not None and a.tick == 1
        for k in a.fields():
            assert torch.equal(getattr(a, k), getattr(b, k)), k
        return
    with pytest.raises(NotImplementedError):
        init_state(cfg, "cpu")
    with pytest.raises(NotImplementedError):
        make_tick(cfg, "cpu")


def test_numpy_bridge_roundtrip():
    _, cfg = both("headline")
    st = init_state(cfg, "cpu")
    tick = make_tick(cfg, "cpu")
    for _ in range(30):
        tick(st)
    arrs = state_to_numpy(st)
    assert arrs["tick"] == np.int32(30)
    back = state_from_numpy(arrs, "cpu", cfg=cfg)
    assert back.tick == 30
    for k in STATE_FIELDS:
        assert torch.equal(getattr(back, k), getattr(st, k)), k
    bad = dict(arrs, term=arrs["term"].astype(np.int64))
    with pytest.raises(ValueError):
        state_from_numpy(bad, "cpu", cfg=cfg)


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the request is valid here")
    _, cfg = both("election")
    with pytest.raises(RuntimeError, match="cuda"):
        init_state(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        make_tick(cfg)
