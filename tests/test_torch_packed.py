"""The port's §14 packed state layout and §18 packed compute against the JAX
package, at tolerance zero (integers):

- the §18 word algebra (popcount32, the peer and ctrl words,
  synth_vote_bits, enter/exit_packed_compute) on seeded numpy inputs;
- pack_state of evolved port states, field for field with dtypes and the
  per-group width latch, and the unpack_state roundtrip;
- the width-overflow latch on the JAX package's three forged states
  (tests/test_layout.py), and the runners raising "width overflow";
- the packed-compute lattice ≡ the unpacked one, and make_run /
  make_cuda_scan(device="cpu") over the packed layout ≡ the wide runs, on
  the synchronous soup, the §10 mailbox [1, 3] and τ=0;
- the JAX package's make_run(layout="packed", compute="packed") with the
  trace, recorder and monitor ≡ the port's;
- the guards (packed compute without the packed layout, the K-tick
  kernel, a §12 bank, packed compute on deep logs) and the entry points'
  default device.

The packed kernels themselves run only on the card
(tests/test_torch_cuda_packed.py); here every launch is its plain
version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_kotlin_tpu.models import state as jstate
from raft_kotlin_tpu.models.state import RaftState as JState
from raft_kotlin_tpu.ops import tick as jtick
from raft_kotlin_tpu.utils.config import RaftConfig as JConfig
from raft_kotlin_tpu_torch.api import fuzz
from raft_kotlin_tpu_torch.models import state as tstate
from raft_kotlin_tpu_torch.models.state import (
    PACKED_FIELDS, PACKED_MAILBOX_FIELDS, check_packed_ov, init_state,
    pack_state, packed_field_dtype, unpack_state)
from raft_kotlin_tpu_torch.ops import cuda_tick
from raft_kotlin_tpu_torch.ops import tick as ttick
from raft_kotlin_tpu_torch.ops.cuda_scan import make_cuda_scan
from raft_kotlin_tpu_torch.utils import rng as trng
from raft_kotlin_tpu_torch.utils.config import RaftConfig

# tests/test_layout.py's and tests/test_packed_compute.py's configs, the
# headline's shape (five nodes, 32-entry logs) at 16 groups, and a mailbox
# config whose positions, round window and delays pack int16 (no stress).
CONFIGS = {
    "soup": dict(n_groups=8, n_nodes=3, log_capacity=8, cmd_period=3,
                 p_drop=0.2, p_crash=0.02, p_restart=0.1, seed=11),
    "mailbox": dict(n_groups=8, n_nodes=3, log_capacity=8, cmd_period=3,
                    p_drop=0.2, delay_lo=1, delay_hi=3, seed=7),
    "tau0": dict(n_groups=8, n_nodes=3, log_capacity=8, cmd_period=3,
                 p_drop=0.2, mailbox=True, seed=3),
    "headline": dict(n_groups=16, n_nodes=5, log_capacity=32, cmd_period=10,
                     p_drop=0.25, p_crash=0.01, p_restart=0.08,
                     p_link_fail=0.02, p_link_heal=0.08, seed=0),
    "widths": dict(n_groups=8, n_nodes=5, log_capacity=160, cmd_period=2,
                   p_drop=0.1, p_crash=0.01, p_restart=0.05, seed=9, el_lo=5,
                   el_hi=40, round_ticks=200, retry_ticks=5, hb_ticks=3,
                   bo_lo=2, bo_hi=6, delay_lo=1, delay_hi=130),
}
TICKS = 25


def both(name, **kw):
    c = dict(CONFIGS[name], **kw)
    if name == "widths":
        return JConfig(**c), RaftConfig(**c)
    return JConfig(**c).stressed(10), RaftConfig(**c).stressed(10)


def to_jax(state) -> JState:
    """A port RaftState as the JAX package's (dtypes kept)."""
    arrs = tstate.state_to_numpy(state)
    tick = arrs.pop("tick")
    return JState(**{k: jnp.asarray(v) for k, v in arrs.items()},
                  tick=jnp.asarray(tick))


def bits(x) -> np.ndarray:
    """An integer array as int64, an int32 one by its bits as uint32 (JAX's
    u32 ctrl words and the port's int32 ones compare by bit pattern)."""
    a = np.asarray(x)
    return (a.view(np.uint32) if a.dtype == np.int32 else a).astype(np.int64)


def evolved(name, ticks=TICKS):
    _, cfg = both(name)
    st = init_state(cfg, "cpu")
    ttick.make_run(cfg, ticks, trace=False, device="cpu")(st)
    return cfg, st


def same_state(a, b):
    return [k for k in a.fields() if not torch.equal(getattr(a, k),
                                                     getattr(b, k))]


def same_dict(a, b):
    return [k for k in a if not torch.equal(torch.as_tensor(a[k]),
                                            torch.as_tensor(b[k]))]


# -- the §18 word algebra ----------------------------------------------------

@pytest.mark.parametrize("N", [3, 5])
def test_word_algebra_equals_jax(N):
    gen = np.random.default_rng(N)
    G = 64
    words = gen.integers(0, 1 << 30, size=(4, G)).astype(np.int32)
    words[0, :4] = [0, 1, (1 << 30) - 1, 0x15555555]
    np.testing.assert_array_equal(
        tstate.popcount32(torch.from_numpy(words)).numpy(),
        np.asarray(jstate.popcount32(jnp.asarray(words))))
    plane = (gen.random((N * N, G)) < 0.4).astype(np.int32)
    tw = tstate.pack_peer_word_i32(torch.from_numpy(plane), N)
    jw = jstate.pack_peer_word_i32(jnp.asarray(plane), N)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(
        tstate.unpack_peer_word_i32(tw, N).numpy(),
        np.asarray(jstate.unpack_peer_word_i32(jw, N)))
    heads = [gen.integers(0, 3, (N, G)).astype(np.int32) for _ in range(2)] \
        + [(gen.random((N, G)) < 0.5).astype(np.int32) for _ in range(3)]
    tc = tstate.pack_ctrl_words_i32(*map(torch.from_numpy, heads))
    jc = jstate.pack_ctrl_words_i32(*map(jnp.asarray, heads))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    tu, ju = (tstate.unpack_ctrl_words_i32(tc, N),
              jstate.unpack_ctrl_words_i32(jc, N))
    for k in ju:
        np.testing.assert_array_equal(tu[k].numpy(), np.asarray(ju[k]), k)
    rb = tw.numpy()
    votes = np.minimum(gen.integers(0, N + 1, (N, G)),
                       np.vectorize(lambda v: int(v).bit_count())(rb))
    np.testing.assert_array_equal(
        tstate.synth_vote_bits(torch.from_numpy(rb),
                               torch.from_numpy(votes), N).numpy(),
        np.asarray(jstate.synth_vote_bits(jnp.asarray(rb),
                                          jnp.asarray(votes), N)))


@pytest.mark.parametrize("name", ["soup", "headline"])
def test_enter_exit_packed_compute_equal_jax(name):
    cfg, st = evolved(name)
    jc, _ = both(name)
    ts = ttick.flatten_state(cfg, st)
    js = jtick.flatten_state(jc, to_jax(st))
    tp = tstate.enter_packed_compute(cfg, ts)
    jp = jstate.enter_packed_compute(jc, js)
    assert int(tp["vote_bits"].sum()) > 0, "no vote in the state"
    for k in ("responded_bits", "vote_bits"):
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]), k)
    dt = {k: ts[k].dtype for k in ("responded", "votes", "responses")}
    tx = tstate.exit_packed_compute(cfg, tp, dt)
    jx = jstate.exit_packed_compute(jc, jp)
    for k in dt:
        assert tx[k].dtype == ts[k].dtype, k
        assert torch.equal(tx[k], ts[k]), k  # the §18 identities
        np.testing.assert_array_equal(bits(tx[k].to(torch.int32)),
                                      bits(np.asarray(jx[k])), k)


# -- the packed layout -------------------------------------------------------

@pytest.mark.parametrize("name", ["soup", "mailbox", "headline", "widths"])
def test_pack_state_equals_jax(name):
    jc, _ = both(name)
    cfg, st = evolved(name)
    assert int(st.last_index.max()) > 0, "the log stayed empty"
    for s in (init_state(cfg, "cpu"), st):
        tp = pack_state(cfg, s)
        jp = jstate.pack_state(jc, to_jax(s))
        assert tuple(tp.fields()) == PACKED_FIELDS + (
            PACKED_MAILBOX_FIELDS if cfg.uses_mailbox else ())
        for k in tp.fields():
            t, j = getattr(tp, k), np.asarray(getattr(jp, k))
            assert t.dtype == packed_field_dtype(k, cfg), k
            assert t.element_size() == j.dtype.itemsize, k
            assert tuple(t.shape) == j.shape, k
            np.testing.assert_array_equal(bits(t.numpy()), bits(j), k)
        assert not tp.ov.any()
        u = unpack_state(cfg, tp)
        for k in s.fields():
            assert getattr(u, k).dtype == getattr(s, k).dtype, k
            assert torch.equal(getattr(u, k), getattr(s, k)), k


def test_packed_dtypes_equal_jax():
    for name in CONFIGS:
        jc, tc = both(name)
        for k in PACKED_FIELDS + PACKED_MAILBOX_FIELDS:
            jd = np.dtype(jstate.packed_field_dtype(k, jc))
            assert packed_field_dtype(k, tc).itemsize == jd.itemsize, k
            assert torch.iinfo(packed_field_dtype(k, tc)).bits == \
                np.iinfo(jd).bits, k


def forged(cfg):
    """The JAX package's forged states (tests/test_layout.py): a term past
    int16, a log term past int8, a role outside its 2-bit lane."""
    st = init_state(cfg, "cpu")
    out = []
    for field, idx, v in (("term", (0, 0), 40_000),
                          ("log_term", (0, 0, 0), 200), ("role", (0, 0), 5)):
        s = st.clone()
        getattr(s, field)[idx] = v
        out.append(s)
    return st, out


def test_width_overflow_latch_equals_jax():
    jc, cfg = both("soup")
    st, bad = forged(cfg)
    for s in bad:
        tp, jp = pack_state(cfg, s), jstate.pack_state(jc, to_jax(s))
        np.testing.assert_array_equal(tp.ov.numpy(), np.asarray(jp.ov))
        np.testing.assert_array_equal(bits(tp.ctrl_bits.numpy()),
                                      bits(jp.ctrl_bits))
        assert tp.ov.any()
        with pytest.raises(RuntimeError, match="width overflow"):
            check_packed_ov(tp.ov)
    check_packed_ov(pack_state(cfg, st).ov)
    # A packed run fails loudly; the wide one carries the state.
    doctored = bad[0]
    for compute in ("unpacked", "packed"):
        with pytest.raises(RuntimeError, match="width overflow"):
            ttick.make_run(cfg, 3, trace=False, layout="packed",
                           compute=compute, device="cpu")(doctored.clone())
        for aux_source in ("inkernel", "staged"):
            with pytest.raises(RuntimeError, match="width overflow"):
                make_cuda_scan(cfg, 5, fused_ticks=2, aux_source=aux_source,
                               layout="packed", compute=compute,
                               device="cpu")(doctored.clone())
    ttick.make_run(cfg, 3, trace=False, device="cpu")(doctored.clone())
    make_cuda_scan(cfg, 5, fused_ticks=2, device="cpu")(doctored.clone())


def test_latch_taken_at_the_launch_end():
    """A term that outgrows int16 during a run latches its group (and only
    its group) in the packed scan, and the run raises."""
    _, cfg = both("headline")
    st = init_state(cfg, "cpu")
    make_cuda_scan(cfg, 30, fused_ticks=4, device="cpu")(st)
    st.term[:, 3] = 32_767
    s = ttick.flatten_packed(cfg, pack_state(cfg, st))
    assert not s["ov"].any()
    base, tk, bk = ttick.make_rng(cfg, "cpu")
    stat = cuda_tick.inkernel_aux_statics(cfg, base, tk, bk)
    flags = ttick.make_flags(cfg)
    for i in range(4):
        cuda_tick.fused_tick_kernel(
            cfg, s, 4, flags, "inkernel",
            cuda_tick.inkernel_aux_operands(stat, st.tick + 4 * i),
            layout="packed", compute="packed")
    assert s["ov"].nonzero().flatten().tolist() == [3]


def early_latch(monkeypatch, group: int) -> None:
    """Wrap both tick kernels so that each packed launch, after its plain
    run, sets `ov` on `group`: the kernels' early latch (a log or §10 slot
    write that missed its range and was overwritten in range) where the
    launch-end rule latches nothing."""
    fused, one = cuda_tick.fused_tick_kernel, cuda_tick.tick_kernel

    def fused_early(cfg, s, *a, layout="wide", **kw):
        out = fused(cfg, s, *a, layout=layout, **kw)
        if layout == "packed":
            s["ov"][group] = 1
        return out

    def one_early(cfg, s, *a, layout="wide", **kw):
        out = one(cfg, s, *a, layout=layout, **kw)
        if layout == "packed":
            s["ov"][group] = 1
        return out
    monkeypatch.setattr(cuda_tick, "fused_tick_kernel", fused_early)
    monkeypatch.setattr(cuda_tick, "tick_kernel", one_early)


@pytest.mark.parametrize("compute", ["unpacked", "packed"])
def test_early_latch_follows_the_launch_end_rule(monkeypatch, compute,
                                                 jax_packed_run):
    """Where only the kernels' early latch is set, make_cuda_scan and
    make_run over the packed layout rerun wide under the JAX package's
    launch-end rule: no raise, the wide run's results, and the JAX
    package's packed run's end state and trace."""
    jend, jys, _, _ = jax_packed_run
    _, cfg = both("soup")
    early_latch(monkeypatch, group=5)
    scan_kw = dict(fused_ticks=4, aux_source="staged", trace=True,
                   telemetry=True, monitor=True, device="cpu")
    ref = make_cuda_scan(cfg, TICKS, **scan_kw)(init_state(cfg, "cpu"))
    out = make_cuda_scan(cfg, TICKS, layout="packed", compute=compute,
                         **scan_kw)(init_state(cfg, "cpu"))
    assert not same_state(out[0], ref[0])
    for i in (1, 2, 3):
        assert not same_dict(out[i], ref[i]), i
    run_kw = dict(trace=True, telemetry=True, monitor=True, impl="kernel",
                  device="cpu")
    rref = ttick.make_run(cfg, TICKS, **run_kw)(init_state(cfg, "cpu"))
    rout = ttick.make_run(cfg, TICKS, layout="packed", compute=compute,
                          **run_kw)(init_state(cfg, "cpu"))
    assert not same_state(rout[0], rref[0])
    for i in (1, 2, 3):
        assert not same_dict(rout[i], rref[i]), i
    for end in (out[0], rout[0]):
        for k in end.fields():
            np.testing.assert_array_equal(getattr(end, k).numpy(),
                                          np.asarray(getattr(jend, k)), k)
    for k in rout[1]:
        np.testing.assert_array_equal(rout[1][k].numpy(), np.asarray(jys[k]),
                                      k)


def test_early_latch_still_raises_at_the_launch_end(monkeypatch):
    """The early latch reruns wide, and a term that outgrows int16 by a
    launch's end (test_latch_taken_at_the_launch_end's state) still raises
    "width overflow" there, as the JAX package's packed scan does."""
    _, cfg = both("headline")
    st = init_state(cfg, "cpu")
    make_cuda_scan(cfg, 30, fused_ticks=4, device="cpu")(st)
    st.term[:, 3] = 32_767
    early_latch(monkeypatch, group=0)
    for aux_source in ("inkernel", "staged"):
        with pytest.raises(RuntimeError, match="width overflow"):
            make_cuda_scan(cfg, 16, fused_ticks=4, aux_source=aux_source,
                           layout="packed", compute="packed",
                           device="cpu")(st.clone())
    with pytest.raises(RuntimeError, match="width overflow"):
        ttick.make_run(cfg, 16, trace=False, impl="kernel", layout="packed",
                       device="cpu")(st.clone())


# -- the lattice and the runners -------------------------------------------

RUNS = [(layout, compute) for layout, compute in (
    ("wide", "packed"), ("packed", "unpacked"), ("packed", "packed"))]


@pytest.mark.parametrize("name", ["soup", "mailbox", "tau0"])
def test_make_run_packed_equals_wide(name):
    """make_run over the packed layout (the one-tick kernel's plain packed
    version) and the §18 lattice ≡ the wide run: trace, end state,
    recorder, monitor."""
    _, cfg = both(name)

    def run(**kw):
        return ttick.make_run(cfg, TICKS, trace=True, telemetry=True,
                              monitor=True, device="cpu", **kw)(
            init_state(cfg, "cpu"))
    ref = run()
    assert int(ref[0].term.max()) > 0, "the soup did nothing"
    assert int(ref[2]["elections_started"]) > 0
    for layout, compute in RUNS:
        out = run(layout=layout, compute=compute)
        what = f"{layout},{compute}"
        assert not same_state(out[0], ref[0]), what
        for i in (1, 2, 3):
            assert not same_dict(out[i], ref[i]), (what, i)


@pytest.mark.parametrize("name", ["soup", "mailbox", "tau0", "widths"])
@pytest.mark.parametrize("aux_source", ["inkernel", "staged"])
def test_cuda_scan_packed_equals_wide(name, aux_source):
    """make_cuda_scan(device="cpu") at T=4 over the packed layout, with a
    remainder tick (three launches and one), ≡ the wide run: end state,
    trace, recorder, monitor."""
    _, cfg = both(name)

    def run(**kw):
        return make_cuda_scan(cfg, 13, fused_ticks=4, aux_source=aux_source,
                              trace=True, telemetry=True, monitor=True,
                              device="cpu", **kw)(init_state(cfg, "cpu"))
    ref = run()
    for compute in ("unpacked", "packed"):
        out = run(layout="packed", compute=compute)
        assert not same_state(out[0], ref[0]), compute
        for i in (1, 2, 3):
            assert not same_dict(out[i], ref[i]), (compute, i)


def test_packed_compute_phase_body_equals_unpacked():
    """One lattice step from an evolved state, each phase cut, in the §18
    form ≡ the wide form (the exit restores the tallies)."""
    cfg, st = evolved("headline", ticks=40)
    base, tk, bk = ttick.make_rng(cfg, "cpu")
    aux, flags = ttick.make_aux(cfg, base, tk, bk, st)
    for cut in (1, 2, 3, 4, None):
        a = ttick.flatten_state(cfg, st.clone())
        b = ttick.flatten_state(cfg, st.clone())
        da = ttick.phase_body(cfg, a, aux, flags, cut=cut)
        dt = {k: b[k].dtype for k in ("responded", "votes", "responses")}
        bp = tstate.enter_packed_compute(cfg, b)
        db = ttick.phase_body(cfg, bp, aux, dataclasses.replace(
            flags, packed_compute=True), cut=cut)
        bx = tstate.exit_packed_compute(cfg, bp, dt)
        assert torch.equal(da, db), cut
        assert not same_dict(a, bx), cut


@pytest.fixture(scope="module")
def jax_packed_run():
    """The JAX package's make_run(layout="packed", compute="packed") on its
    SOUP (tests/test_packed_compute.py), with the trace, recorder and
    monitor: one XLA compile for the module."""
    jc, _ = both("soup")
    out = jtick.make_run(jc, TICKS, trace=True, telemetry=True, monitor=True,
                         layout="packed", compute="packed")(
        jstate.init_state(jc))
    return jax.device_get(out)


def test_make_run_packed_equals_jax(jax_packed_run):
    jend, jys, jtel, jmon = jax_packed_run
    _, cfg = both("soup")
    end, ys, tel, mon = ttick.make_run(
        cfg, TICKS, trace=True, telemetry=True, monitor=True,
        layout="packed", compute="packed", device="cpu")(
        init_state(cfg, "cpu"))
    for k in end.fields():
        np.testing.assert_array_equal(getattr(end, k).numpy(),
                                      np.asarray(getattr(jend, k)), k)
    for k in ys:
        np.testing.assert_array_equal(ys[k].numpy(), np.asarray(jys[k]), k)
    assert set(tel) == set(jtel)
    for k in jtel:
        np.testing.assert_array_equal(tel[k].numpy(), np.asarray(jtel[k]), k)
    for k in jmon:
        np.testing.assert_array_equal(np.asarray(mon[k]),
                                      np.asarray(jmon[k]), k)


# -- guards and defaults -------------------------------------------------------

def test_guards():
    _, cfg = both("soup")
    with pytest.raises(ValueError, match="requires layout='packed'"):
        make_cuda_scan(cfg, 4, compute="packed", device="cpu")
    with pytest.raises(ValueError, match="requires layout='packed'"):
        ttick.make_run(cfg, 4, impl="kernel", compute="packed", device="cpu")
    for kw in (dict(layout="packed"), dict(layout="packed",
                                           compute="packed")):
        with pytest.raises(ValueError, match="k_per_launch"):
            make_cuda_scan(cfg, 4, k_per_launch=2, device="cpu", **kw)
    with pytest.raises(ValueError, match="unknown"):
        ttick.make_run(cfg, 4, layout="narrow", device="cpu")
    # A §12 bank with the packed layout is not ported.
    with pytest.raises(NotImplementedError, match="bank"):
        make_cuda_scan(fuzz.smoke_config(8), 4, aux_source="inkernel",
                       layout="packed", device="cpu")
    # §18 packed compute on deep logs equals unpacked compute (against
    # JAX: tests/test_torch_deep_mailbox.py); the packed layout on a deep
    # config is the per-tick pack and unpack around the deep tick.
    deep = RaftConfig(n_groups=2, n_nodes=3, log_capacity=512, seed=29,
                      p_drop=0.15, cmd_period=3).stressed(10)
    computed = [ttick.make_run(deep, 12, trace=True, impl="plain",
                               compute=compute, device="cpu")(
        init_state(deep, "cpu")) for compute in ("packed", "unpacked")]
    assert not same_state(computed[0][0], computed[1][0])
    assert not same_dict(computed[0][1], computed[1][1])
    runs = [ttick.make_run(deep, 12, trace=True, layout=layout,
                           device="cpu")(init_state(deep, "cpu"))
            for layout in ("wide", "packed")]
    assert int(runs[0][0].last_index.max()) > 0
    assert not same_state(runs[1][0], runs[0][0])
    assert not same_dict(runs[1][1], runs[0][1])


def test_entry_points_default_to_the_card(monkeypatch):
    """sample_scenario_bank, like every entry point, runs on the card unless
    the caller names the CPU: with no card it raises, never falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = fuzz.smoke_config(8)
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        trng.sample_scenario_bank(cfg)
    assert trng.sample_scenario_bank(cfg, device="cpu")
    for fn in (lambda: make_cuda_scan(cfg, 4, layout="wide"),
               lambda: ttick.make_run(both("soup")[1], 4, layout="packed")):
        with pytest.raises(RuntimeError, match="device 'cuda'"):
            fn()
