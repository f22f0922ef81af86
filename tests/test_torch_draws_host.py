"""The §12 edge channel of a scenario bank, run on the CPU: the fused kernel's
source (ops/csrc/fused_tick_kernel.cu with kt_rng.cuh) is built with g++
against the host stand-in for the CUDA runtime (ops/host_build.py) at
three and five nodes, and launched through its C interface on CPU tensors.
Tolerance zero: every value compared is a bit.

- `raft_part_down_launch` (the edge lattice alone: the drop draw, then the
  group's cut mask) ≡ its plain version (ops/cuda_tick.part_down_plain)
  and ≡ the JAX package's `kt_edge_ok_mask(...) & ~kt_part_down(...)` on
  the same key table and random live-leader planes, at G = 256 and 100,
  at ticks inside and outside the flapping windows, so that the split,
  asym and leader programs each cut some edges;
- one in-kernel kScen launch of the fused kernel (T = 4, three nodes, no
  observers) ≡ ops/cuda_tick.fused_tick_plain on a warmed farm state, and
  one in the farm's mailbox regime (the bank's delay windows);
- the launcher refuses a G at which its 32-bit offsets would overflow.

The card runs the same source (tests/test_torch_cuda_k_tick.py,
chip_smoke.py step 11).
"""

import ctypes
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_kotlin_tpu.utils import rng as jrng
from raft_kotlin_tpu_torch.api import fuzz
from raft_kotlin_tpu_torch.constants import LEADER
from raft_kotlin_tpu_torch.models.state import STATE_FIELDS, init_state
from raft_kotlin_tpu_torch.ops import build, cuda_tick, host_build
from raft_kotlin_tpu_torch.ops import tick as ttick
from raft_kotlin_tpu_torch.ops.cuda_scan import make_cuda_scan
from raft_kotlin_tpu_torch.utils import rng as trng
from raft_kotlin_tpu_torch.utils.config import RaftConfig

# Ticks of the edge-lattice check: boot, and ticks spread over the smoke
# bank's 5-40-tick flapping periods.
TICKS = (0, 3, 11, 26, 47, 90)
KINDS = {"split": trng.PART_SPLIT, "asym": trng.PART_ASYM,
         "leader": trng.PART_LEADER}


@pytest.fixture
def host(monkeypatch):
    if host_build.compiler() is None:
        pytest.skip("needs a host C++ compiler (g++)")
    # The launch arguments name a device index; the host build ignores it.
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)


def lib(n_nodes):
    L = host_build.build_host("fused_tick_kernel.cu", (f"RAFT_N={n_nodes}",))
    for name in ("raft_part_down_launch", "raft_part_down_info",
                 "raft_fused_launch"):
        getattr(L, name).argtypes = [ctypes.c_void_p] * 3
        getattr(L, name).restype = ctypes.c_int
    return L


def call(fn, ptrs, ints, out=None):
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_ints = (ctypes.c_longlong * len(ints))(*ints)
    return fn(c_ptrs, c_ints,
              None if out is None else ctypes.cast(out, ctypes.c_void_p))


def farm_config(n_nodes, groups):
    """api/fuzz.smoke_config at three nodes; its bank over five-node
    groups otherwise."""
    if n_nodes == 3:
        return fuzz.smoke_config(groups)
    return RaftConfig(n_groups=groups, n_nodes=n_nodes, log_capacity=32,
                      cmd_period=5, seed=9,
                      scenario=fuzz.smoke_spec(12)).stressed(10)


def jax_edges(cfg, ktab, lead):
    """The JAX package's in-kernel edge lattice on the key table's tick:
    the drop draw's survivors minus the partition program's cut edges,
    (N*N, G) bool, and the cut alone."""
    N = cfg.n_nodes
    k = ktab.numpy()
    rows = {nm: jnp.asarray(k[4 + i:5 + i])
            for i, nm in enumerate(trng.scen_layout(cfg))}
    p = np.arange(N * N, dtype=np.int32)[:, None]
    s_id, r_id = p // N + 1, p % N + 1
    ld = lead.numpy()
    tick = jnp.asarray(k[2:3])
    ok = jrng.kt_edge_ok_mask(jnp.asarray(k[0:1]), jnp.asarray(k[1:2]),
                              tick, jnp.asarray(k[3:4] * (N * N) + p),
                              rows["drop_t"])
    cut = jrng.kt_part_down(
        rows["part_kind"], rows["part_cut"], rows["part_src"],
        rows["part_dst"], jrng.scenario_active(rows, tick),
        jnp.asarray(s_id), jnp.asarray(r_id),
        jnp.asarray(ld[s_id[:, 0] - 1]), jnp.asarray(ld[r_id[:, 0] - 1]))
    return np.asarray(ok & ~cut), np.asarray(cut)


@pytest.mark.parametrize("n_nodes,G", [(3, 256), (3, 100), (5, 256),
                                       (5, 100)])
def test_part_down_equals_plain_and_jax(host, n_nodes, G):
    cfg = farm_config(n_nodes, G)
    L = lib(n_nodes)
    base, tk, bk, scen = ttick.split_rng(ttick.make_rng(cfg, "cpu"))
    stat = cuda_tick.inkernel_aux_statics(cfg, base, tk, bk, scen)
    kinds = scen["part_kind"].numpy()
    gen = np.random.default_rng(G + n_nodes)
    cut_kinds = set()
    for tick in TICKS:
        ktab = cuda_tick.inkernel_aux_operands(stat, tick)["ktab"]
        lead = torch.from_numpy(gen.random((n_nodes, G)) < 0.3)
        out = torch.ones((n_nodes ** 2, G), dtype=torch.bool)
        ptrs, ints = cuda_tick.part_down_args(cfg, ktab, lead, out)
        assert call(L.raft_part_down_launch, ptrs, ints) == 0
        assert torch.equal(out, cuda_tick.part_down_plain(cfg, ktab, lead)), \
            tick
        want, cut = jax_edges(cfg, ktab, lead)
        np.testing.assert_array_equal(out.numpy(), want, err_msg=str(tick))
        assert cut.any(), f"no partition program cuts an edge at {tick}"
        cut_kinds |= set(kinds[cut.any(axis=0)].tolist())
    assert cut_kinds == set(KINDS.values())
    info = (ctypes.c_longlong * len(cuda_tick.TICK_INFO))()
    assert call(L.raft_part_down_info, ptrs, ints, info) == 0
    got = dict(zip(cuda_tick.TICK_INFO, info))
    assert got["tile"] == 0 and 0 < got["blocks"] <= G and got["threads"] > 0


def test_part_down_refuses_offsets_past_32_bits(host):
    """A G at which the output's N*N rows pass 2^31 - 1 elements: the
    wrapper raises before a launch, and the launcher refuses the ints
    without touching an operand."""
    cfg = fuzz.smoke_config(8)
    G = build.MAX_GROUPS // 9 + 1
    with pytest.raises(ValueError, match="32-bit"):
        build.check_offsets("part_down", 9, G)
    build.check_offsets("part_down", 9, G - 1)
    ktab = torch.zeros((cuda_tick.inkernel_table_rows(cfg), 8),
                       dtype=torch.int32)
    _, ints = cuda_tick.part_down_args(
        cfg, ktab, torch.zeros((3, 8), dtype=torch.bool),
        torch.zeros((9, 8), dtype=torch.bool))
    assert call(lib(3).raft_part_down_launch, [None] * 3,
                (G,) + ints[1:]) != 0


@pytest.mark.parametrize("mailbox", [False, True])
def test_kscen_fused_launch_equals_plain(host, mailbox):
    """One T = 4 in-kernel launch over the smoke bank (thresholds, split /
    asym / leader programs) from a farm state warmed 30 ticks; with
    `mailbox`, the farm's mailbox regime (1-4-tick delays in the bank's
    per-universe windows)."""
    cfg = fuzz.smoke_config(128)
    if mailbox:
        cfg = dataclasses.replace(
            cfg, delay_lo=1, delay_hi=4,
            scenario=dataclasses.replace(cfg.scenario, delay_windows=True))
    st = init_state(cfg, "cpu")
    make_cuda_scan(cfg, 30, aux_source="inkernel", device="cpu")(st)
    base, tk, bk, scen = ttick.split_rng(ttick.make_rng(cfg, "cpu"))
    stat = cuda_tick.inkernel_aux_statics(cfg, base, tk, bk, scen)
    ops = cuda_tick.inkernel_aux_operands(stat, st.tick)
    _, cut = jax_edges(cfg, ops["ktab"], (st.role == LEADER) & st.up)
    flags = ttick.make_flags(cfg)
    s = ttick.flatten_state(cfg, st)
    k = {f: v.clone() for f, v in s.items()}
    tensors, ints, ov, _ = cuda_tick.fused_operands(cfg, k, 4, flags,
                                                    "inkernel", ops, ())
    assert call(lib(3).raft_fused_launch,
                [None if x is None else x.data_ptr() for x in tensors],
                ints) == 0
    want, _ = cuda_tick.fused_tick_plain(cfg, s, 4, flags, "inkernel", ops)
    assert [f for f in STATE_FIELDS if f in s
            and not torch.equal(k[f], s[f])] == []
    assert torch.equal(ov, want)
    # Partition programs cut edges at the launch's first tick.
    assert cut.any()
