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
from raft_kotlin_tpu_torch.utils.config import config_from_dict

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


@pytest.mark.parametrize("kw", [
    dict(delay_lo=0, delay_hi=2),
    dict(mailbox=True),
    dict(compact_watermark=4, compact_chunk=2),
    dict(scenario=ScenarioSpec(drop_max=0.1)),
])
def test_unported_configs_raise(kw):
    cfg = RaftConfig(n_groups=4, **kw)
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
