"""§12 scenario banks in the port (raft_kotlin_tpu_torch) against the JAX
package, on the CPU. Tolerance: zero — banks, masks, draws and states are
integers, so everything compared is bit-equal.

- randint over the bank's wide spans;
- the bank (utils/rng.sample_scenario_bank) and its key-table layout
  (scen_layout, inkernel_table_rows) on the farm's specs: the smoke spec,
  tests/test_fuzz.py's heterogeneous HET_SPEC, the degenerate bank, a
  delay-window spec, a warmup-down spec, and the universe-id override;
- the host evaluators: scenario_link_down, apply_warmup_faults and the
  kernel twin kt_part_down on random role / up planes;
- the staged draws (ops/tick.make_aux) with a bank, against JAX's make_aux
  on the same mid-run states;
- the in-kernel draws' plain version (ops/cuda_tick._kt_aux) against the
  port's staged make_aux, and leader-isolation universes fused at T=2
  against the staged runner at T=1 (tests/test_inkernel_aux.py:348-363);
- make_run with the recorder and the monitor against JAX's XLA make_run on
  HET and on the degenerate bank (6 groups, 3 nodes, 80 ticks).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_kotlin_tpu.models.state import RaftState as JState
from raft_kotlin_tpu.models.state import init_state as j_init_state
from raft_kotlin_tpu.ops import pallas_tick as jpt
from raft_kotlin_tpu.ops import tick as jtick
from raft_kotlin_tpu.utils import rng as jrng
from raft_kotlin_tpu.utils import telemetry as jtel
from raft_kotlin_tpu.utils.config import RaftConfig as JConfig
from raft_kotlin_tpu.utils.config import ScenarioSpec as JSpec
from raft_kotlin_tpu_torch.models.state import (
    STATE_FIELDS, init_state, state_to_numpy)
from raft_kotlin_tpu_torch.ops import cuda_tick
from raft_kotlin_tpu_torch.ops import tick as ttick
from raft_kotlin_tpu_torch.ops.cuda_scan import make_cuda_scan
from raft_kotlin_tpu_torch.utils import rng as trng
from raft_kotlin_tpu_torch.utils import telemetry as ttel
from raft_kotlin_tpu_torch.utils.config import RaftConfig, ScenarioSpec

PARTS = ("split", "asym", "leader")
SPECS = {
    # api/fuzz.smoke_spec
    "smoke": dict(farm_seed=12, drop_max=0.25, crash_max=0.02,
                  restart_max=0.2, partitions=PARTS, part_period_lo=5,
                  part_period_hi=40),
    # tests/test_fuzz.py HET_SPEC
    "het": dict(farm_seed=7, universe_base=100, drop_max=0.2, crash_max=0.01,
                restart_max=0.1, partitions=PARTS, part_period_lo=5,
                part_period_hi=20),
    "degenerate": dict(degenerate=True),
    "delay_windows": dict(farm_seed=3, delay_windows=True, link_fail_max=0.1,
                          link_heal_max=0.3, partitions=("asym", "split")),
    "warmup": dict(farm_seed=5, warmup_down=26, drop_max=0.1),
}
# The run config under each spec (a mailbox with a 1-4 window, as
# scripts/fuzz_farm.py --delay 1 4 builds it, for the delay windows).
CFGS = {
    "smoke": dict(n_nodes=3, log_capacity=32, cmd_period=5, seed=9),
    "het": dict(n_nodes=3, seed=31, cmd_period=9),
    "degenerate": dict(n_nodes=5, log_capacity=16, cmd_period=7, p_drop=0.1,
                       p_crash=0.01, p_restart=0.05, p_link_fail=0.02,
                       p_link_heal=0.1, delay_lo=0, delay_hi=2, seed=5),
    "delay_windows": dict(n_nodes=3, log_capacity=32, cmd_period=5,
                          delay_lo=1, delay_hi=4, seed=4),
    "warmup": dict(n_nodes=5, log_capacity=24, cmd_period=2, p_crash=0.01,
                   p_restart=0.05, seed=6),
}
G = 37


def both(name, n_groups=G, **over):
    kw = dict(CFGS[name], n_groups=n_groups, **over)
    return (JConfig(**kw, scenario=JSpec(**SPECS[name])).stressed(10),
            RaftConfig(**kw, scenario=ScenarioSpec(**SPECS[name])).stressed(10))


def eq(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got.astype(np.int64),
                                  np.asarray(want).astype(np.int64),
                                  err_msg=what)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_bank_and_layout_equal_jax(name):
    jc, tc = both(name)
    jb = jrng.sample_scenario_bank(jc)
    tb = trng.sample_scenario_bank(tc)
    assert tuple(tb) == tuple(jb) == trng.scen_layout(tc) \
        == jrng.scen_layout(jc)
    assert cuda_tick.inkernel_table_rows(tc) == jpt.inkernel_table_rows(jc)
    assert tb, "the spec samples no channel"
    for k in jb:
        assert tb[k].dtype == torch.int32, k
        eq(tb[k], jb[k], k)
    # make_rng carries the bank as its fourth operand.
    assert ttick.make_rng(tc, "cpu")[3].keys() == tb.keys()


@pytest.mark.parametrize("span", [3, 65_536, 70_001, 2 ** 23 + 1])
def test_randint_over_wide_spans_equals_jax(span):
    """jax.random.randint squares 2^16 mod span in u32: past 2^16 it wraps
    (the bank's threshold draws span up to 2^23 + 1)."""
    import jax

    key = jrng.base_key(12)
    want = jax.random.randint(jax.random.fold_in(key, 5), (64,), 7,
                              7 + span, dtype=jnp.int32)
    got = trng.randint_at(trng.fold_in(trng.base_key(12), 5),
                          torch.arange(64, dtype=torch.int64), 7, span)
    eq(got, want, f"span {span}")


def test_bank_universe_id_override_equals_jax():
    jc, tc = both("smoke", n_groups=6)
    uids = np.array([5, 2 ** 20 + 3, 0, 77, 5, 40_000], np.int32)
    jb = jrng.sample_scenario_bank(jc, uids=jnp.asarray(uids))
    tb = trng.sample_scenario_bank(tc, uids=uids)
    for k in jb:
        eq(tb[k], jb[k], k)
    # A universe's row depends on its id alone: universe_base + g.
    shifted = dataclasses.replace(tc, scenario=dataclasses.replace(
        tc.scenario, universe_base=77))
    row = trng.sample_scenario_bank(shifted)
    for k in tb:
        assert int(row[k][0]) == int(tb[k][3]), k


def test_partition_masks_and_warmup_equal_jax():
    gen = np.random.default_rng(11)
    for name, N in (("smoke", 3), ("het", 5)):
        jc, tc = both(name, n_nodes=N)
        jb = jrng.sample_scenario_bank(jc)
        tb = trng.sample_scenario_bank(tc)
        for tick in (0, 3, 17, 40, 129):
            lead = gen.random((G, N)) < 0.3
            want = jrng.scenario_link_down(jb, tick, jnp.asarray(lead), N)
            eq(trng.scenario_link_down(tb, tick, torch.from_numpy(lead), N),
               want, f"{name} link_down t{tick}")
            eq(trng.scenario_link_down(tb, tick, None, N),
               jrng.scenario_link_down(jb, tick, None, N), "no leaders")
            # The kernel twin on the (N*N, L) orientation.
            p = np.arange(N * N)[:, None]
            s_id, r_id = p // N + 1, p % N + 1
            lead_s, lead_r = lead.T[s_id[:, 0] - 1], lead.T[r_id[:, 0] - 1]
            row = {k: v[None] for k, v in jb.items()}
            jd = jrng.kt_part_down(
                row["part_kind"], row["part_cut"], row["part_src"],
                row["part_dst"], jrng.scenario_active(row, tick),
                jnp.asarray(s_id, jnp.int32), jnp.asarray(r_id, jnp.int32),
                jnp.asarray(lead_s), jnp.asarray(lead_r))
            trow = {k: v[None] for k, v in tb.items()}
            td = trng.kt_part_down(
                trow["part_kind"], trow["part_cut"], trow["part_src"],
                trow["part_dst"], trng.scenario_active(trow, tick),
                torch.from_numpy(s_id.astype(np.int32)),
                torch.from_numpy(r_id.astype(np.int32)),
                torch.from_numpy(lead_s), torch.from_numpy(lead_r))
            eq(td, jd, f"{name} kt_part_down t{tick}")
            eq(td, want.reshape(G, N * N).T, "twin == host function")
    jc, tc = both("warmup")
    for tick in (0, 25, 26, 27):
        crash = gen.random((G, 5)) < 0.2
        restart = gen.random((G, 5)) < 0.2
        jw = jrng.apply_warmup_faults(jc.scenario, jc.cmd_node, tick,
                                      jnp.asarray(crash), jnp.asarray(restart))
        tw = trng.apply_warmup_faults(tc.scenario, tc.cmd_node, tick,
                                      torch.from_numpy(crash),
                                      torch.from_numpy(restart))
        eq(tw[0], jw[0], f"crash t{tick}")
        eq(tw[1], jw[1], f"restart t{tick}")


@functools.lru_cache(maxsize=None)
def port_states(name, ticks=(0, 9, 27, 41)):
    """Port states of `name` at each of `ticks` (read-only), from the
    port's plain make_tick."""
    _, tc = both(name)
    tick = ttick.make_tick(tc, "cpu")
    st = init_state(tc, "cpu")
    out = {}
    for t in range(max(ticks) + 1):
        if t in ticks:
            out[t] = st.clone()
        tick(st)
    return out


def to_jax(st) -> JState:
    arrs = state_to_numpy(st)
    return JState(**{k: jnp.asarray(arrs[k]) for k in STATE_FIELDS},
                  tick=jnp.asarray(arrs["tick"], jnp.int32))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_make_aux_with_a_bank_equals_jax(name):
    jc, tc = both(name)
    jbase, jtk, jbk, jscen = jtick.split_rng(jtick.make_rng(jc))
    base, tk, bk, scen = ttick.split_rng(ttick.make_rng(tc, "cpu"))
    for t, st in port_states(name).items():
        jaux, jflags = jtick.make_aux(jc, jbase, jtk, jbk, to_jax(st), None,
                                      None, scen=jscen)
        taux, tflags = ttick.make_aux(tc, base, tk, bk, st, scen=scen)
        assert set(taux) == set(jaux), t
        for k in jaux:
            assert taux[k].numpy().dtype == np.asarray(jaux[k]).dtype, k
            eq(taux[k], jaux[k], f"{name} t{t} {k}")
        assert (tflags.faults, tflags.links, tflags.delay) == (
            jflags.faults, jflags.links, jflags.delay)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_kt_aux_with_a_bank_equals_staged_make_aux(name):
    _, tc = both(name)
    base, tk, bk, scen = ttick.split_rng(ttick.make_rng(tc, "cpu"))
    stat = cuda_tick.inkernel_aux_statics(tc, base, tk, bk, scen)
    for t, st in port_states(name).items():
        want, flags = ttick.make_aux(tc, base, tk, bk, st, scen=scen)
        ops = cuda_tick.inkernel_aux_operands(stat, st.tick)
        kt = cuda_tick._kt_consts(tc, trng.scen_layout(tc), ops["ktab"],
                                  ops["tkw"], ops["bkw"])
        got = cuda_tick._kt_aux(tc, flags, kt, ttick.flatten_state(tc, st),
                                0)
        assert set(got) == set(want)
        for k in want:
            eq(got[k], want[k], f"{name} t{t} {k}")


def test_leader_isolation_fuses_in_kernel_and_matches_staged_t1():
    """Leader programs read each tick's pre-tick roles: the in-kernel draws
    read the live planes inside a fused launch, so T=2 equals the staged
    runner, which stays at one tick a launch."""
    _, tc = both("het", n_groups=6)
    runs = {}
    for key, src, T in (("staged_T1", "staged", 1),
                        ("inkernel_T2", "inkernel", 2),
                        ("inkernel_T4", "inkernel", 4)):
        runs[key] = make_cuda_scan(tc, 42, fused_ticks=T, aux_source=src,
                                   telemetry=True, monitor=True, trace=True,
                                   device="cpu")(init_state(tc, "cpu"))
    ref_end, ref_tr, ref_tel, ref_mon = runs["staged_T1"]
    assert int(((ref_tr["role"] == 2).sum(1) > 0).sum()) > 0
    for key in ("inkernel_T2", "inkernel_T4"):
        end, tr, tel, mon = runs[key]
        for k in STATE_FIELDS:
            assert torch.equal(getattr(end, k), getattr(ref_end, k)), (key, k)
        for k in tr:
            assert torch.equal(tr[k], ref_tr[k]), (key, k)
        assert ttel.summarize_telemetry(tel) == \
            ttel.summarize_telemetry(ref_tel)
        for k in mon:
            assert torch.equal(mon[k], ref_mon[k]), (key, k)
    with pytest.raises(ValueError, match="leader-isolation"):
        make_cuda_scan(tc, 8, fused_ticks=2, aux_source="staged",
                       device="cpu")


# tests/test_fuzz.py's SOUP / DEG and HET, at their size.
SOUP = dict(n_groups=6, n_nodes=3, log_capacity=16, cmd_period=7, p_drop=0.1,
            p_crash=0.005, p_restart=0.05, seed=5)
HET = dict(n_groups=6, n_nodes=3, seed=31, cmd_period=9)
RUNS = {"het": (HET, SPECS["het"]), "degenerate": (SOUP, SPECS["degenerate"])}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_make_run_with_a_bank_equals_jax(name):
    kw, spec = RUNS[name]
    jc = JConfig(**kw, scenario=JSpec(**spec)).stressed(10)
    tc = RaftConfig(**kw, scenario=ScenarioSpec(**spec)).stressed(10)
    n = 80
    jend, jys, jtl, jmon = jtick.make_run(
        jc, n, trace=True, telemetry=True, monitor=True)(j_init_state(jc))
    tend, tys, ttl, tmon = ttick.make_run(
        tc, n, trace=True, telemetry=True, monitor=True, device="cpu")(
        init_state(tc, "cpu"))
    arrs = state_to_numpy(tend)
    for k in STATE_FIELDS:
        eq(arrs[k], getattr(jend, k), f"end {k}")
    for k in jys:
        eq(tys[k], jys[k], f"trace {k}")
    assert ttel.summarize_telemetry(ttl) == jtel.summarize_telemetry(jtl)
    for k in jmon:
        eq(tmon[k], jmon[k], f"monitor {k}")
    assert jtel.summarize_telemetry(jtl)["fault_events"] > 0
    # The in-kernel fused runner on the CPU takes the same path.
    fend, ftl, fmon = make_cuda_scan(
        tc, n, fused_ticks=4, aux_source="inkernel", telemetry=True,
        monitor=True, device="cpu")(init_state(tc, "cpu"))
    for k in STATE_FIELDS:
        assert torch.equal(getattr(fend, k), getattr(tend, k)), k
    assert ttel.summarize_telemetry(ftl) == ttel.summarize_telemetry(ttl)
    for k in tmon:
        assert torch.equal(fmon[k], tmon[k]), k
