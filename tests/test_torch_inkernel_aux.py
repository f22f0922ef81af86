"""The port's in-kernel aux against the JAX package's, on the CPU, at
tolerance zero (the draws are integers):

- every kt_* twin of raft_kotlin_tpu_torch/utils/rng.py against the JAX
  package's kt_* over random key / counter lattices, negative fold-in ids
  and counters past 2^31 included, and against the port's int64-held
  threefry (threefry_block / fold_in) they must give the words of;
- the plain in-kernel aux (_kt_aux over inkernel_aux_operands) against the
  port's staged make_aux, channel by channel, on mid-run states of the
  headline soup at 37 groups (ragged), and the launch operands against the
  JAX package's inkernel_aux_statics / inkernel_aux_operands;
- the staged fused pre-pass (draw_tables, the T-stacked slabs) against the
  JAX package's draw_tables / fused_launch_aux.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_kotlin_tpu.ops import pallas_tick as jpt
from raft_kotlin_tpu.ops import tick as jtick
from raft_kotlin_tpu.utils import rng as jrng
from raft_kotlin_tpu.utils.config import RaftConfig as JConfig
from raft_kotlin_tpu.utils.config import ScenarioSpec as JScenario
from raft_kotlin_tpu_torch.models.state import init_state
from raft_kotlin_tpu_torch.ops import cuda_tick
from raft_kotlin_tpu_torch.ops import tick as ttick
from raft_kotlin_tpu_torch.utils import rng as trng
from raft_kotlin_tpu_torch.utils.config import RaftConfig, ScenarioSpec

SEEDS = (0, 17, 2 ** 31 - 1, -5)
HEADLINE = dict(n_groups=37, n_nodes=5, log_capacity=32, cmd_period=10,
                p_drop=0.25, p_crash=0.01, p_restart=0.08, p_link_fail=0.02,
                p_link_heal=0.08, seed=0)


def i32(size, seed=0) -> np.ndarray:
    """Random int32 words covering the whole u32 range (negatives = words
    past 2^31), led by the edges 0, 1, -1, INT32_MIN, INT32_MAX."""
    gen = np.random.default_rng(seed)
    w = gen.integers(-2 ** 31, 2 ** 31, size=(size,), dtype=np.int64)
    edges = (0, 1, -1, -2 ** 31, 2 ** 31 - 1)[:size]
    w[:len(edges)] = edges
    return w.astype(np.int32)


def jwords(x):
    return jnp.asarray(x, jnp.int32)


def twords(x):
    return torch.from_numpy(np.asarray(x, np.int32))


def eq(got: torch.Tensor, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", SEEDS)
def test_kt_key_words(seed):
    jk = jrng.kt_key_words(jrng.base_key(seed))
    tk = trng.kt_key_words(trng.base_key(seed))
    assert (int(tk[0]), int(tk[1])) == (int(jk[0]), int(jk[1]))
    # (N, G) key planes: the port's int64-held grids as int32 words.
    jg = jrng.kt_key_words(jrng.grid_keys(jrng.base_key(seed),
                                          jrng.KIND_TIMEOUT, 6, 5))
    tg = trng.kt_key_words(trng.grid_keys(trng.base_key(seed),
                                          trng.KIND_TIMEOUT, 6, 5, "cpu"))
    eq(tg[0], jg[0])
    eq(tg[1], jg[1])


@pytest.mark.parametrize("r", [1, 6, 13, 26, 31])
def test_kt_rotl(r):
    x = i32(64, seed=9)
    eq(trng._kt_rotl(twords(x), r), jrng._kt_rotl(jwords(x), r))


@pytest.mark.parametrize("n", [1, 200])
def test_kt_block_and_fold(n):
    k0, k1, c0, c1 = (i32(n, seed=j) for j in range(4))
    got = trng.kt_block(*(twords(v) for v in (k0, k1, c0, c1)))
    want = jrng.kt_block(*(jwords(v) for v in (k0, k1, c0, c1)))
    eq(got[0], want[0])
    eq(got[1], want[1])
    # The same words as the port's int64-held threefry.
    u = [torch.from_numpy(v.astype(np.int64) & 0xFFFFFFFF)
         for v in (k0, k1, c0, c1)]
    ref = trng.threefry_block(*u)
    eq(got[0].to(torch.int64) & 0xFFFFFFFF, ref[0])
    # fold_in with negative ids (their u32 patterns) and int ids.
    for d in (twords(c1), -1, 0, 7, 2 ** 31 + 5):
        got = trng.kt_fold(twords(k0), twords(k1), d)
        jd = jwords(np.asarray(d).astype(np.int64).astype(np.int32)) \
            if not isinstance(d, torch.Tensor) else jwords(d.numpy())
        want = jrng.kt_fold(jwords(k0), jwords(k1), jd)
        eq(got[0], want[0])
        eq(got[1], want[1])


@pytest.mark.parametrize("seed", SEEDS)
def test_kt_bits_and_event_masks(seed):
    base_j = jrng.kt_key_words(jrng.base_key(seed))
    base_t = trng.kt_key_words(trng.base_key(seed))
    idx = np.arange(5 * 25, dtype=np.int32)
    for tick in (0, 3, 2 ** 31 - 1, -1):
        ej = jrng.kt_event_key(*base_j, jrng.KIND_CRASH, jwords(tick))
        et = trng.kt_event_key(*base_t, trng.KIND_CRASH, twords(tick))
        eq(et[0], ej[0])
        eq(trng.kt_bits32(*et, twords(idx)), jrng.kt_bits32(*ej, jwords(idx)))
        eq(trng.kt_bits23(*et, twords(idx)), jrng.kt_bits23(*ej, jwords(idx)))
        for p in (0.01, 0.25, 1.0 / (1 << trng.P_BITS), 1.0):
            th = trng.p_threshold(p)
            eq(trng.kt_edge_ok_mask(*base_t, twords(tick), twords(idx), th),
               jrng.kt_edge_ok_mask(*base_j, jwords(tick), jwords(idx), th))
            for kind in (trng.KIND_CRASH, trng.KIND_LINK_HEAL):
                eq(trng.kt_event_mask(*base_t, kind, twords(tick),
                                      twords(idx), th),
                   jrng.kt_event_mask(*base_j, kind, jwords(tick),
                                      jwords(idx), th))
    # The twins equal the port's host channels on the canonical lattice.
    G, N = 4, 5
    want = trng.edge_ok_mask(trng.base_key(seed), 9, (G, N, N), 0.25, "cpu")
    got = trng.kt_edge_ok_mask(*base_t, 9, torch.arange(
        G * N * N, dtype=torch.int32), trng.p_threshold(0.25))
    assert torch.equal(got.reshape(G, N, N), want)


@pytest.mark.parametrize("span", [1, 3, 31, 1000, 46340])
def test_kt_umod_and_randint(span):
    x = i32(300, seed=1)
    eq(trng._kt_umod(twords(x), span), jrng._kt_umod(jwords(x), span))
    k0, k1, idx = (i32(300, seed=j) for j in (2, 3, 4))
    got = trng.kt_randint(twords(k0), twords(k1), twords(idx), -7, span)
    want = jrng.kt_randint(jwords(k0), jwords(k1), jwords(idx), -7, span)
    eq(got, want)
    # Per-element spans, as the §12 per-group windows pass them.
    spans = (np.abs(i32(300, seed=5).astype(np.int64)) % span + 1)\
        .astype(np.int32)
    got = trng.kt_randint(twords(k0), twords(k1), twords(idx), 2,
                          twords(spans))
    want = jrng.kt_randint(jwords(k0), jwords(k1), jwords(idx), 2,
                           jwords(spans))
    eq(got, want)


@pytest.mark.parametrize("lo,hi", [(20, 23), (2, 3), (7, 7), (200, 230)])
def test_kt_draw_uniform(lo, hi):
    k0, k1, ctr = (i32(50, seed=j) for j in (6, 7, 8))
    ctr[5:8] = (-1, 2 ** 31 - 1, -2 ** 31)  # counters past 2^31 wrap
    eq(trng.kt_draw_uniform(twords(k0), twords(k1), twords(ctr), lo, hi),
       jrng.kt_draw_uniform(jwords(k0), jwords(k1), jwords(ctr), lo, hi))
    # ... and equal the port's keyed host draw.
    keys = tuple(torch.from_numpy(v.astype(np.int64) & 0xFFFFFFFF)
                 for v in (k0, k1))
    want = trng.draw_uniform_keyed(keys, torch.from_numpy(ctr), lo, hi)
    assert torch.equal(
        trng.kt_draw_uniform(twords(k0), twords(k1), twords(ctr), lo, hi)
        .to(torch.int64), want)


def test_scen_layout():
    assert trng.scen_layout(RaftConfig(**HEADLINE)) == \
        jrng.scen_layout(JConfig(**HEADLINE)) == ()
    assert cuda_tick.inkernel_table_rows(RaftConfig(**HEADLINE)) == \
        jpt.inkernel_table_rows(JConfig(**HEADLINE)) == 4
    spec = dict(farm_seed=3, drop_max=0.3)
    jcfg = JConfig(**HEADLINE, scenario=JScenario(**spec))
    tcfg = RaftConfig(**HEADLINE, scenario=ScenarioSpec(**spec))
    assert trng.scen_layout(tcfg) == jrng.scen_layout(jcfg) == ("drop_t",)
    assert cuda_tick.inkernel_table_rows(tcfg) == \
        jpt.inkernel_table_rows(jcfg) == 5


@functools.lru_cache(maxsize=None)
def mid_run_states(ticks=(0, 23, 41)):
    """Port states of the headline soup at 37 groups at each of `ticks`
    (read-only: the tests below do not advance them)."""
    cfg = RaftConfig(**HEADLINE).stressed(10)
    st = init_state(cfg, "cpu")
    step = ttick.make_tick(cfg, "cpu")
    out = []
    for t in range(max(ticks) + 1):
        if t in ticks:
            out.append(st.clone())
        step(st)
    return cfg, out


@pytest.mark.parametrize("k", [0, 1, 2])
def test_kt_aux_equals_staged_make_aux(k):
    cfg, states = mid_run_states()
    st = states[k]
    base, tk, bk = ttick.make_rng(cfg, "cpu")
    want, flags = ttick.make_aux(cfg, base, tk, bk, st)
    stat = cuda_tick.inkernel_aux_statics(cfg, base, tk, bk)
    ops = cuda_tick.inkernel_aux_operands(stat, st.tick)
    kt = cuda_tick._kt_consts(cfg, (), ops["ktab"], ops["tkw"], ops["bkw"])
    got = cuda_tick._kt_aux(cfg, flags, kt, ttick.flatten_state(cfg, st), 0)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(
            got[name].to(torch.int64).numpy(),
            want[name].to(torch.int64).numpy(), err_msg=name)
    # Tick offsets inside a launch: _kt_aux(t) at tick0 equals make_aux at
    # tick0 + t for the (kind, tick) channels.
    ops0 = cuda_tick.inkernel_aux_operands(stat, st.tick - 3)
    kt0 = cuda_tick._kt_consts(cfg, (), ops0["ktab"], ops0["tkw"],
                               ops0["bkw"])
    got3 = cuda_tick._kt_aux(cfg, flags, kt0, ttick.flatten_state(cfg, st), 3)
    for name in ("edge_iid", "crash_m", "link_heal", "periodic"):
        np.testing.assert_array_equal(
            got3[name].to(torch.int64).numpy(),
            want[name].to(torch.int64).numpy(), err_msg=name)


def test_inkernel_operands_equal_jax():
    cfg = RaftConfig(**HEADLINE).stressed(10)
    jcfg = JConfig(**HEADLINE).stressed(10)
    base, tk, bk = ttick.make_rng(cfg, "cpu")
    jb, jt, jbk, scen = jtick.split_rng(jtick.make_rng(jcfg))
    got = cuda_tick.inkernel_aux_operands(
        cuda_tick.inkernel_aux_statics(cfg, base, tk, bk), 57)
    want = jpt.inkernel_aux_operands(
        jpt.inkernel_aux_statics(jcfg, jb, jt, jbk, scen), 57)
    for name, w in zip(("ktab", "tkw", "bkw"), want):
        eq(got[name], w)


@pytest.mark.parametrize("K,bound", [(1, None), (4, None), (3, 2)])
def test_draw_tables_equal_jax(K, bound):
    cfg, states = mid_run_states()
    jcfg = JConfig(**HEADLINE).stressed(10)
    st = states[2]
    base, tk, bk = ttick.make_rng(cfg, "cpu")
    jb, jt, jbk, _ = jtick.split_rng(jtick.make_rng(jcfg))
    got = cuda_tick.draw_tables(cfg, tk, bk, st.t_ctr, st.b_ctr, K,
                                resets_bound=bound)
    want = jpt.draw_tables(jcfg, jt, jbk, jnp.asarray(st.t_ctr.numpy()),
                           jnp.asarray(st.b_ctr.numpy()), K,
                           resets_bound=bound)
    for g, w in zip(got, want):
        assert g.dtype == torch.int16
        eq(g.to(torch.int32), w)


def test_fused_launch_slabs_equal_jax():
    cfg, states = mid_run_states()
    jcfg = JConfig(**HEADLINE).stressed(10)
    st = states[1]
    base, tk, bk = ttick.make_rng(cfg, "cpu")
    jb, jt, jbk, _ = jtick.split_rng(jtick.make_rng(jcfg))
    T = 3
    ops = cuda_tick.staged_operands(cfg, base, tk, bk, st.tick,
                                    ttick.flatten_state(cfg, st), T)
    per, flags, _ = jpt.fused_launch_aux(
        jcfg, jb, jt, jbk, st.tick, jnp.asarray(st.t_ctr.numpy()),
        jnp.asarray(st.b_ctr.numpy()), T)
    names = cuda_tick.fused_aux_names(cfg, ttick.make_flags(cfg))
    assert names == tuple(k for k in jtick.AUX_FIELDS if k in names)
    for nm, slab in zip(names, jpt.fused_aux_slabs(per, names)):
        np.testing.assert_array_equal(ops[nm].to(torch.int32).numpy(),
                                      np.asarray(slab).astype(np.int32),
                                      err_msg=nm)
