"""Kernel #7's path on the CPU — ops/cuda_scan.make_cuda_scan(k_per_launch=K)
and ops/cuda_tick.k_tick_plain, the K-tick kernel's plain version — against
the JAX package's archival K-tick kernel (ops/pallas_tick.py
make_pallas_core_k, make_pallas_scan(k_per_launch=K)) in Pallas interpret
mode, at tolerance zero (integers):

(a) the runner over 10 ticks (3 K=3 launches and a 1-tick remainder) on the
    fault soup of tests/test_pallas.py::test_k_tick_kernel_matches_per_tick
    at three nodes (interpreting the JAX kernels at five nodes took 115 s
    on a CPU; at three, 41 s);
(b) one launch's (N, G) overflow counts and end state against the JAX
    kernel's own outputs, with the reset bound forced to 1 on the churn
    config of tests/test_pallas.py::test_k_tick_kernel_overflow_raises, so
    that the counts are nonzero;
(c) the runner raising "overflow" with _resets_bound=1 and running clean
    with the real bound;
(d) the τ=0 mailbox (delay_lo == 0, bound 8N - 3) at K=3 against the port's
    one-tick make_run;
(e) every JAX guard on k_per_launch > 1, with the JAX package's exception
    type.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_kotlin_tpu.api import fuzz as jfuzz
from raft_kotlin_tpu.models.state import RaftState as JState
from raft_kotlin_tpu.models.state import init_state as jinit_state
from raft_kotlin_tpu.ops import pallas_tick as jpt
from raft_kotlin_tpu.ops import tick as jtick
from raft_kotlin_tpu.utils.config import RaftConfig as JConfig
from raft_kotlin_tpu_torch.api import fuzz
from raft_kotlin_tpu_torch.models.state import (
    STATE_FIELDS, init_state, state_to_numpy)
from raft_kotlin_tpu_torch.ops import cuda_tick
from raft_kotlin_tpu_torch.ops import tick as ttick
from raft_kotlin_tpu_torch.ops.cuda_scan import make_cuda_scan
from raft_kotlin_tpu_torch.utils.config import RaftConfig

SOUP = dict(n_nodes=3, log_capacity=8, cmd_period=5, p_drop=0.1,
            p_crash=0.02, p_restart=0.1, p_link_fail=0.02, p_link_heal=0.1,
            seed=11)
CHURN = dict(n_groups=16, n_nodes=3, log_capacity=8, seed=1, el_lo=2,
             el_hi=3, hb_ticks=2, round_ticks=3, retry_ticks=2, bo_lo=2,
             bo_hi=3)
TAU0 = dict(n_groups=8, n_nodes=3, log_capacity=8, cmd_period=5, p_drop=0.1,
            p_crash=0.02, p_restart=0.1, mailbox=True, seed=21)


def assert_end_equal(end, jend):
    jn = jax.device_get(jend)
    for k in STATE_FIELDS:
        want = np.asarray(getattr(jn, k))
        got = getattr(end, k).numpy()
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert end.tick == int(jn.tick)


def test_k_per_launch_runner_equals_jax_pallas_k_tick():
    jcfg = JConfig(n_groups=8, **SOUP).stressed(10)
    cfg = RaftConfig(n_groups=8, **SOUP).stressed(10)
    jend = jpt.make_pallas_scan(jcfg, 10, interpret=True, k_per_launch=3)(
        jinit_state(jcfg), jtick.make_rng(jcfg))
    end = init_state(cfg, "cpu")
    assert make_cuda_scan(cfg, 10, k_per_launch=3, device="cpu")(end) is end
    assert_end_equal(end, jend)


def test_k_tick_overflow_counts_equal_the_jax_kernels():
    K, G, warm = 2, CHURN["n_groups"], 5
    jcfg, cfg = JConfig(**CHURN), RaftConfig(**CHURN)
    st = init_state(cfg, "cpu")
    ttick.make_run(cfg, warm, trace=False, impl="plain", device="cpu")(st)
    arrays = state_to_numpy(st)
    # The JAX kernel on the same state, its operands as make_pallas_scan's
    # K-tick body builds them.
    base, tkeys, bkeys, scen = jtick.split_rng(jtick.make_rng(jcfg))
    js = JState(**{k: jnp.asarray(arrays[k]) for k in STATE_FIELDS},
                tick=jnp.asarray(arrays["tick"], jnp.int32))
    flat = jtick.flatten_state(jcfg, js)
    for k in flat:
        if k not in ("log_term", "log_cmd"):
            flat[k] = flat[k].astype(jnp.int32)
    per, flags = [], None
    for k in range(K):
        shim = types.SimpleNamespace(tick=warm + k, t_ctr=flat["t_ctr"],
                                     b_ctr=flat["b_ctr"])
        aux_k, flags = jtick.make_aux(jcfg, base, tkeys, bkeys, shim, None,
                                      None, scen=scen)
        per.append(aux_k)
    call, sfields, aux_names = jpt.make_pallas_core_k(
        jcfg, G, G, True, K, resets_bound=1)(flags)
    slabs = [jnp.concatenate([p[nm].astype(jnp.int16) if nm in jpt._BOOL_AUX
                              else p[nm] for p in per]) for nm in aux_names]
    el_tab, b_tab = jpt.draw_tables(jcfg, tkeys, bkeys, flat["t_ctr"],
                                    flat["b_ctr"], K, resets_bound=1)
    outs = call(*([flat[k] for k in sfields] + slabs + [el_tab, b_tab]))
    want_ov = np.asarray(outs[-1])
    want = dict(zip(sfields, (np.asarray(o) for o in outs[:-1])))
    # The port's plain version on the same state and its own staged operands.
    s = ttick.flatten_state(cfg, st)
    tb, ttk, tbk = ttick.make_rng(cfg, "cpu")
    ops = cuda_tick.staged_operands(cfg, tb, ttk, tbk, warm, s, K, 1)
    el, bt = ops.pop("el_table"), ops.pop("b_table")
    ov = cuda_tick.k_tick_plain(cfg, s, K, ops, el, bt)
    assert ov.dtype == torch.int32 and ov.shape == want_ov.shape
    np.testing.assert_array_equal(ov.numpy(), want_ov)
    assert int(ov.sum()) > 0
    for k in sfields:
        np.testing.assert_array_equal(
            s[k].to(torch.int32).numpy(), want[k].astype(np.int32),
            err_msg=k)


def test_k_per_launch_overflow_raises_and_the_real_bound_runs_clean():
    cfg = RaftConfig(**CHURN)
    run = make_cuda_scan(cfg, 24, k_per_launch=4, _resets_bound=1,
                         device="cpu")
    with pytest.raises(RuntimeError, match="overflow"):
        run(init_state(cfg, "cpu"))
    end = init_state(cfg, "cpu")
    make_cuda_scan(cfg, 24, k_per_launch=4, device="cpu")(end)
    assert end.tick == 24


def test_k_per_launch_tau0_mailbox_equals_make_run():
    cfg = RaftConfig(**TAU0).stressed(10)
    assert cuda_tick.config_resets_bound(cfg) == 8 * cfg.n_nodes - 3
    a, b = init_state(cfg, "cpu"), init_state(cfg, "cpu")
    make_cuda_scan(cfg, 30, k_per_launch=3, device="cpu")(a)
    ttick.make_run(cfg, 30, trace=False, impl="plain", device="cpu")(b)
    for k in a.fields():
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert a.tick == b.tick == 30


GUARDS = {
    "inkernel": (dict(aux_source="inkernel"), "k_per_launch"),
    "packed_layout": (dict(layout="packed"), "k_per_launch"),
    "packed_compute": (dict(layout="packed", compute="packed"),
                       "k_per_launch"),
    "telemetry": (dict(telemetry=True), "k_per_launch"),
    "monitor": (dict(monitor=True), "k_per_launch"),
    "trace": (dict(trace=True), "k_per_launch"),
    "serving": (dict(serving=True), "k_per_launch"),
    "fused_ticks": (dict(fused_ticks=2), "k_per_launch"),
    "leader_isolation": (dict(), "leader-isolation"),
}


@pytest.mark.parametrize("name", list(GUARDS))
def test_k_per_launch_guards_match_jax(name):
    kw, match = GUARDS[name]
    if name == "leader_isolation":
        jcfg, cfg = jfuzz.smoke_config(8), fuzz.smoke_config(8)
        assert cfg.scenario.needs_state
    else:
        jcfg = JConfig(n_groups=8, **SOUP).stressed(10)
        cfg = RaftConfig(n_groups=8, **SOUP).stressed(10)
    with pytest.raises(ValueError, match=match):
        jpt.make_pallas_scan(jcfg, 4, interpret=True, k_per_launch=2, **kw)
    with pytest.raises(ValueError, match=match):
        make_cuda_scan(cfg, 4, k_per_launch=2, device="cpu", **kw)
