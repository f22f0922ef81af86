"""The port's checkpoint module (raft_kotlin_tpu_torch/utils/checkpoint.py)
and §15 soak, against the JAX package on the CPU at tolerance zero:

- a checkpoint crosses the packages both ways (the same npz v9 file:
  keys, header, dtypes) and resumes bit-exact across a truncation boundary
  (snap_index > 0 at the save) ≡ the unbroken run;
- the §16 ring window resizes on load in both directions, and refuses a
  live window that does not fit;
- the packed layout of a compaction config: a JAX packed save loads
  packed in the port ≡ the port's pack_state, and the port's packed save
  loads packed in the JAX package ≡ its pack_state;
- a config mismatch, a corrupt file and the unported forms are refused;
  older versions load as the JAX package migrates them;
- soak_run's summary ≡ the JAX package's soak_run at 16 groups, on the
  laggard family and on the snapshot-during-partition family.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from raft_kotlin_tpu.api import fuzz as jfuzz
from raft_kotlin_tpu.models.state import init_state as j_init_state
from raft_kotlin_tpu.models.state import pack_state as j_pack_state
from raft_kotlin_tpu.ops import tick as jtick
from raft_kotlin_tpu.utils import checkpoint as jck
from raft_kotlin_tpu.utils.config import RaftConfig as JConfig
from raft_kotlin_tpu_torch.api import fuzz
from raft_kotlin_tpu_torch.models.state import (
    init_state, pack_state, state_to_numpy)
from raft_kotlin_tpu_torch.ops import tick as ttick
from raft_kotlin_tpu_torch.utils import checkpoint as ck
from raft_kotlin_tpu_torch.utils.config import (
    RaftConfig, ScenarioSpec, config_from_dict)

SYNC = dict(n_groups=8, n_nodes=3, log_capacity=64, cmd_period=3,
            p_drop=0.15, seed=11, compact_watermark=3, compact_chunk=1)
HALF = 30


def sync_configs():
    return JConfig(**SYNC).stressed(10), RaftConfig(**SYNC).stressed(10)


def run(cfg, ticks, st=None):
    st = st if st is not None else init_state(cfg, "cpu")
    return ttick.make_run(cfg, ticks, trace=False, device="cpu")(st)[0]


def assert_same(a, b):
    x, y = state_to_numpy(a), state_to_numpy(b)
    assert sorted(x) == sorted(y)
    for k in x:
        assert x[k].dtype == y[k].dtype, k
        np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.fixture(scope="module")
def unbroken():
    """The port's unbroken 2 x HALF-tick run and its state at HALF (the
    JAX package's make_run ≡ it: tests/test_torch_compaction.py)."""
    _, tc = sync_configs()
    mid = run(tc, HALF)
    assert int(mid.snap_index.max()) > 0  # a truncation boundary
    return mid.clone(), run(tc, HALF, mid.clone())


def test_port_save_resumes_in_jax_and_back(tmp_path, unbroken):
    """Port save at HALF → JAX load (bit-equal state, expect_cfg accepted)
    → JAX save → port load → HALF more ticks ≡ the unbroken run."""
    jc, tc = sync_configs()
    mid, end = unbroken
    p, q = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    ck.save(p, mid, tc, extra={"segment": 1})
    js, jcfg = jck.load(p, expect_cfg=jc)
    assert jcfg == jc
    jn, want = jax.device_get(js), state_to_numpy(mid)
    for k in want:
        np.testing.assert_array_equal(np.asarray(getattr(jn, k)), want[k],
                                      err_msg=k)
    assert jck.load_with_extra(p)[2] == {"segment": 1}
    jck.save(q, js, jc)
    back, cfg, extra = ck.load_with_extra(q, expect_cfg=tc, device="cpu")
    assert cfg == tc and extra == {}
    assert_same(back, mid)
    assert_same(run(tc, HALF, back), end)


def test_jax_save_resumes_in_the_port(tmp_path, unbroken):
    """A JAX run of HALF ticks, saved by the JAX package, loads in the port
    (≡ the port's own state at HALF) and resumes to the unbroken end."""
    jc, tc = sync_configs()
    mid, end = unbroken
    js = jtick.make_run(jc, HALF, trace=False)(j_init_state(jc))[0]
    path = str(tmp_path / "j.npz")
    jck.save(path, js, jc)
    st, cfg = ck.load(path, device="cpu")
    assert cfg == tc
    assert_same(st, mid)
    assert_same(run(tc, HALF, st), end)


def test_packed_saves_cross_the_packages(tmp_path, unbroken):
    """The state at HALF (snap_index > 0), packed by the JAX package and
    saved there, loads with layout="packed" in the port ≡ the port's
    pack_state (latched int16 positions, the int32 digest, aq_hase's
    plane rule); the port's save of that packed state loads with
    layout="packed" in the JAX package ≡ the JAX package's pack_state."""
    jc, tc = sync_configs()
    mid, _ = unbroken
    p, q, r = (str(tmp_path / f"{n}.npz") for n in ("w", "jp", "tp"))
    ck.save(p, mid, tc)
    js, _ = jck.load(p, expect_cfg=jc)
    jp = jax.device_get(j_pack_state(jc, js))
    jck.save(q, jp, jc)
    got, cfg = ck.load(q, expect_cfg=tc, device="cpu", layout="packed")
    want = pack_state(tc, mid)
    assert cfg == tc and got.fields() == want.fields()
    for k in want.fields():
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert got.snap_index.dtype == torch.int16 \
        and got.snap_digest.dtype == torch.int32
    ck.save(r, got, tc)
    back, _ = jck.load(r, expect_cfg=jc, layout="packed")
    back = jax.device_get(back)
    for k in want.fields():
        np.testing.assert_array_equal(np.asarray(getattr(back, k)),
                                      np.asarray(getattr(jp, k)), err_msg=k)


def ring_cfg(ring):
    cfg = RaftConfig(n_groups=8, n_nodes=3, log_capacity=64, cmd_period=2,
                     p_drop=0.05, seed=0, compact_watermark=8,
                     compact_chunk=8,
                     scenario=ScenarioSpec(warmup_down=40)).stressed(10)
    return dataclasses.replace(cfg, ring_capacity=ring)


def test_ring_resize_both_ways(tmp_path):
    """A run saved on the full window and loaded on a 56-row ring, and one
    saved on the ring and loaded on the full window, each resume ≡ their
    unbroken runs in every non-log field (positions past the ring by
    then); a 16-row ring does not hold the live window and is refused."""
    full, ring = ring_cfg(None), ring_cfg(56)
    ends = {}
    for src, dst in ((full, ring), (ring, full)):
        mid = run(src, 140)
        path = str(tmp_path / f"{src.phys_capacity}.npz")
        ck.save(path, mid, src)
        st, cfg = ck.load(path, expect_cfg=dst, device="cpu")
        assert cfg == dst and st.log_term.shape[1] == dst.phys_capacity
        ends[dst.phys_capacity] = run(dst, 60, st)
    straight = run(full, 200)
    assert int(straight.last_index.max()) > 64
    for end in ends.values():
        for k in straight.fields():
            if k not in ("log_term", "log_cmd"):
                assert torch.equal(getattr(end, k),
                                   getattr(straight, k)), k
    with pytest.raises(ValueError, match="does not fit"):
        ck.load(path, expect_cfg=ring_cfg(16), device="cpu")


def test_refusals_and_migrations(tmp_path, unbroken):
    """A config mismatch and a truncated file raise ValueError; the
    unported forms raise NotImplementedError naming ROADMAP; a v6 file
    (no capacity latch) loads with a clean latch; a packed state saves
    wide and loads back packed, with compaction too."""
    _, tc = sync_configs()
    mid, _ = unbroken
    path = str(tmp_path / "c.npz")
    ck.save(path, mid, tc)
    with pytest.raises(ValueError, match="mismatch"):
        ck.load(path, expect_cfg=dataclasses.replace(tc, seed=12),
                device="cpu")
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    del arrays["snap_term"]
    np.savez(str(tmp_path / "bad.npz"), **arrays)
    with pytest.raises(ValueError, match="missing arrays"):
        ck.load(str(tmp_path / "bad.npz"), device="cpu")
    for entry in (lambda: ck.save_sharded(str(tmp_path), mid, tc),
                  lambda: ck.load_sharded(str(tmp_path)),
                  lambda: ck.load_serving(path),
                  lambda: ck.save(path, mid, tc, serving={})):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            entry()
    packed, _ = ck.load(path, device="cpu", layout="packed")
    assert torch.equal(packed.snap_digest, mid.snap_digest)
    off = dataclasses.replace(tc, compact_watermark=0)
    st = run(off, 20)
    old = state_to_numpy(st)
    del old["cap_ov"]
    old.update({ck._HEADER_KEY: np.frombuffer(
        json.dumps(dataclasses.asdict(off)).encode(), dtype=np.uint8),
        ck._VERSION_KEY: np.asarray(6, np.int32)})
    np.savez(str(tmp_path / "v6.npz"), **old)
    back, _ = ck.load(str(tmp_path / "v6.npz"), device="cpu")
    assert not back.cap_ov.any()
    ck.save(str(tmp_path / "p.npz"), pack_state(off, st), off)
    wide, _ = ck.load(str(tmp_path / "p.npz"), device="cpu")
    assert_same(wide, st)
    packed, _ = ck.load(str(tmp_path / "p.npz"), device="cpu",
                        layout="packed")
    assert torch.equal(packed.ctrl_bits, pack_state(off, st).ctrl_bits)


def test_soak_run_equals_jax():
    """soak_run at 16 laggard universes, two 48-tick segments of
    checkpoint rotation: every summary field ≡ the JAX package's."""
    jc = jfuzz.laggard_config(16)
    tc = fuzz.laggard_config(16)
    assert config_from_dict(dataclasses.asdict(jc)) == tc
    want = jfuzz.soak_run(jc, 96, segment=48)
    got = fuzz.soak_run(tc, 96, segment=48, device="cpu")
    assert got == want
    assert got["segments"] == 2 and got["telemetry"]["snapshots_taken"] > 0
    with pytest.raises(ValueError, match="compaction"):
        fuzz.soak_run(fuzz.smoke_config(4), 8, device="cpu")


def test_partition_snapshot_soak_equals_jax():
    """The snapshot-during-partition family (split / asym / leader
    programs over a compacting cluster): the spec and the config ≡ the JAX
    package's, and soak_run at 16 universes, two 48-tick segments, ≡ its
    summary."""
    assert dataclasses.asdict(fuzz.partition_snapshot_spec(5)) == \
        dataclasses.asdict(jfuzz.partition_snapshot_spec(5))
    jc = jfuzz.partition_snapshot_config(16)
    tc = fuzz.partition_snapshot_config(16)
    assert config_from_dict(dataclasses.asdict(jc)) == tc
    want = jfuzz.soak_run(jc, 96, segment=48)
    got = fuzz.soak_run(tc, 96, segment=48, device="cpu")
    assert got == want
    assert got["telemetry"]["snapshots_taken"] > 0
    assert got["telemetry"]["installsnap_deliveries"] > 0
