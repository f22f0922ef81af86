"""The one-tick kernel (#1, #4's one-tick forms) in its tile and row forms,
and the K-tick kernel (#7), run on the CPU: each kernel source is built with
g++ against the host stand-in for the CUDA runtime (ops/host_build.py),
launched through its C interface on CPU tensors, and held against its
plain version (ops/tick.phase_body, ops/cuda_tick.tick_plain_packed,
k_tick_plain): every state field, el_dirty and the overflow counts
bit-equal (tolerance zero: integers).

The group counts cover the tile's two ways in and out of shared memory
(csrc/tile.cuh): 256 (every row 16-byte aligned, whole tiles of 64: the
bulk copies), 136 (1-byte rows unaligned: per-thread loads; 2- and 4-byte
rows aligned; a last tile of 8 groups) and 100 (only 4-byte rows
aligned; a last tile of 36). The card runs the same sources
(tests/test_torch_cuda_*.py, chip_smoke.py); here they run without one.
"""

import ctypes

import pytest
import torch

from raft_kotlin_tpu_torch.api import fuzz
from raft_kotlin_tpu_torch.models.state import init_state, pack_state
from raft_kotlin_tpu_torch.ops import cuda_tick, host_build
from raft_kotlin_tpu_torch.ops import tick as ttick
from raft_kotlin_tpu_torch.ops.cuda_scan import make_cuda_scan
from raft_kotlin_tpu_torch.utils.config import (
    RaftConfig, headline_config, mailbox_config)

SOUP = dict(cmd_period=5, p_drop=0.1, p_crash=0.02, p_restart=0.1,
            p_link_fail=0.02, p_link_heal=0.1)
WIDTHS = dict(n_nodes=5, log_capacity=160, cmd_period=2, p_drop=0.1,
              p_crash=0.01, p_restart=0.05, seed=9, el_lo=5, el_hi=40,
              round_ticks=200, retry_ticks=5, hb_ticks=3, bo_lo=2, bo_hi=6,
              delay_lo=1, delay_hi=130)


@pytest.fixture
def host(monkeypatch):
    if host_build.compiler() is None:
        pytest.skip("needs a host C++ compiler (g++)")
    # The launch arguments name a device index; the host build ignores it.
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)


def lib(n_nodes, packed=False, source="tick_kernel.cu", extra=()):
    L = host_build.build_host(source, (f"RAFT_N={n_nodes}",)
                              + (("RAFT_PACKED=1",) if packed else ())
                              + tuple(extra))
    for name in ("raft_tick_launch", "raft_tick_info", "raft_k_tick_launch",
                 "raft_k_tick_info"):
        fn = getattr(L, name, None)
        if fn is not None:
            fn.argtypes = [ctypes.c_void_p] * 3
            fn.restype = ctypes.c_int
    return L


def call(fn, ptrs, ints, out=None):
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_ints = (ctypes.c_longlong * len(ints))(*ints)
    return fn(c_ptrs, c_ints,
              None if out is None else ctypes.cast(out, ctypes.c_void_p))


def warm(cfg, ticks):
    st = init_state(cfg, "cpu")
    make_cuda_scan(cfg, ticks, fused_ticks=1, device="cpu")(st)
    return st


def run_tick(cfg, L, layout="wide", compute="unpacked", ticks=3, warm_t=25):
    """`ticks` ticks through the host-built kernel and the plain version
    from one state; returns the launch description."""
    st = warm(cfg, warm_t)
    base, tk, bk, scen = ttick.split_rng(ttick.make_rng(cfg, "cpu"))
    ps = pack_state(cfg, st) if layout == "packed" else None
    info = (ctypes.c_longlong * len(cuda_tick.TICK_INFO))()
    for i in range(ticks):
        s = (ttick.flatten_packed(cfg, ps) if ps is not None
             else ttick.flatten_state(cfg, st))
        shim = ttick.packed_shim(cfg, s, st.tick) if ps is not None else st
        aux, flags = ttick.make_aux(cfg, base, tk, bk, shim, scen=scen)
        k = {f: v.clone() for f, v in s.items()}
        ptrs, ints, dirty = cuda_tick.tick_launch_args(cfg, k, aux, flags,
                                                       layout, compute)
        assert call(L.raft_tick_info, ptrs, ints, info) == 0
        assert call(L.raft_tick_launch, ptrs, ints) == 0
        want = cuda_tick.tick_kernel(cfg, s, aux, flags, layout=layout,
                                     compute=compute)
        assert [f for f in s if not torch.equal(k[f], s[f])] == [], i
        assert torch.equal(dirty, want), i
        ttick.materialize_el(cfg, tk, s, want)
        st.tick += 1
        if ps is not None:
            ps.tick = st.tick
    return dict(zip(cuda_tick.TICK_INFO, info))


TICK_CASES = [(name, G, layout, compute)
              for name in ("headline", "mailbox") for G in (256, 136, 100)
              for layout, compute in (("wide", "unpacked"),
                                      ("packed", "unpacked"),
                                      ("packed", "packed"))]


@pytest.mark.parametrize("name,G,layout,compute", TICK_CASES)
def test_tile_tick_kernel_equals_plain(host, name, G, layout, compute):
    """The mailbox's instantiations with unpacked compute run the tile
    form, the others the row form (tile_form)."""
    cfg = (headline_config if name == "headline" else mailbox_config)(G)
    info = run_tick(cfg, lib(5, layout == "packed"), layout, compute)
    assert info["tile"] == int(name == "mailbox" and compute == "unpacked")
    if info["tile"]:
        # Some staged tensor comes in bulk at every G here (the 4-byte
        # ones at G = 100).
        assert info["smem_bytes"] > 0 and info["bulk_segments"] > 0


@pytest.mark.parametrize("packed", [False, True])
def test_tile_tick_kernel_int16_widths(host, packed):
    """Positions, the round window and the delays past int8 (packed:
    int16 narrow rows, per-thread at 200 groups for the 1-byte ones)."""
    cfg = RaftConfig(n_groups=200, **WIDTHS)
    run_tick(cfg, lib(5, packed), "packed" if packed else "wide",
             "packed" if packed else "unpacked", warm_t=40)


def test_tile_tick_kernel_three_and_seven_nodes(host):
    """The farm's three-node universes with their bank's staged masks, a
    τ=0 mailbox with int16 logs, and seven-node groups."""
    run_tick(fuzz.smoke_config(192), lib(3))
    run_tick(RaftConfig(n_groups=130, n_nodes=3, log_capacity=8,
                        log_dtype="int16", cmd_period=3, p_drop=0.1,
                        p_crash=0.02, p_restart=0.1, seed=5, delay_lo=0,
                        delay_hi=2).stressed(10), lib(3), warm_t=30)
    run_tick(RaftConfig(n_groups=150, n_nodes=7, log_capacity=12,
                        cmd_period=4, p_drop=0.2, p_link_fail=0.05,
                        p_link_heal=0.1, seed=2).stressed(10), lib(7))


K_CASES = {
    "soup_ragged": (RaftConfig(n_groups=200, n_nodes=5, log_capacity=8,
                               seed=11, **SOUP).stressed(10), 4),
    "mailbox_aligned_ragged": (RaftConfig(
        n_groups=136, n_nodes=5, log_capacity=8, delay_lo=1, delay_hi=3,
        seed=4, **SOUP).stressed(10), 4),
    "tau0": (RaftConfig(n_groups=128, n_nodes=5, log_capacity=8,
                        cmd_period=5, p_drop=0.1, p_crash=0.02,
                        p_restart=0.1, mailbox=True, seed=21).stressed(10),
             3),
    "mailbox_odd_k": (mailbox_config(100), 5),
}


@pytest.mark.parametrize("name", list(K_CASES))
def test_tile_k_tick_kernel_equals_plain(host, name):
    """Kernel #7, which keeps the row form (no tile staging beat it)."""
    cfg, K = K_CASES[name]
    L = lib(5, source="fused_tick_kernel.cu")
    st = warm(cfg, 30)
    base, tk, bk, scen = ttick.split_rng(ttick.make_rng(cfg, "cpu"))
    flags = ttick.make_flags(cfg)
    info = (ctypes.c_longlong * len(cuda_tick.TICK_INFO))()
    for i in range(3):
        s = ttick.flatten_state(cfg, st)
        ops = cuda_tick.staged_operands(cfg, base, tk, bk, st.tick, s, K,
                                        scen=scen)
        el, bt = ops.pop("el_table"), ops.pop("b_table")
        k = {f: v.clone() for f, v in s.items()}
        tensors, ints, ov, _ = cuda_tick.fused_operands(
            cfg, k, K, flags, "staged", {**ops, "el_table": el,
                                         "b_table": bt}, ())
        ptrs = [None if x is None else x.data_ptr() for x in tensors]
        assert call(L.raft_k_tick_info, ptrs, ints, info) == 0
        assert call(L.raft_k_tick_launch, ptrs, ints) == 0
        want = cuda_tick.k_tick_plain(cfg, s, K, ops, el, bt)
        assert [f for f in s if not torch.equal(k[f], s[f])] == [], i
        assert torch.equal(ov, want), i
        st.tick += K
    assert info[0] == 0


@pytest.mark.parametrize("n_nodes", [3, 5, 7])
def test_tile_fits_a_block_without_opting_in(host, n_nodes):
    """The tile (the due planes and the aux rows of 64 groups) stays within
    the 48 KB a block may take without cudaFuncSetAttribute, at every node
    count the port builds, packed or wide: the launchers ask for no more."""
    cfg = RaftConfig(n_groups=256, n_nodes=n_nodes, log_capacity=8,
                     delay_lo=1, delay_hi=3, seed=3, **SOUP)
    for packed in (False, True):
        st = init_state(cfg, "cpu")
        base, tk, bk = ttick.make_rng(cfg, "cpu")
        s = (ttick.flatten_packed(cfg, pack_state(cfg, st)) if packed
             else ttick.flatten_state(cfg, st))
        shim = ttick.packed_shim(cfg, s, 0) if packed else st
        aux, flags = ttick.make_aux(cfg, base, tk, bk, shim)
        ptrs, ints, _ = cuda_tick.tick_launch_args(
            cfg, s, aux, flags, "packed" if packed else "wide")
        info = (ctypes.c_longlong * len(cuda_tick.TICK_INFO))()
        assert call(lib(n_nodes, packed).raft_tick_info, ptrs, ints,
                    info) == 0
        got = dict(zip(cuda_tick.TICK_INFO, info))
        assert got["tile"] == 1 and 0 < got["smem_bytes"] <= 48 * 1024, got
