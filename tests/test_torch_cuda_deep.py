"""The deep-log kernels' wrappers (raft_kotlin_tpu_torch/ops/deep_gather.py,
ops/deep_scatter.py) on the card: each CUDA kernel against its plain
version on the same inputs, the deep make_run on the card against the plain
CPU run, and no fallback. Tolerance: zero (integers).

Every test here needs the card (`cuda` marker) and skips on a machine
without one. The card's machine has no JAX, and this file imports none;
run it there with
`python -m pytest --noconftest -m cuda tests/test_torch_cuda_deep.py`.
tests/test_torch_deep_host.py runs the same two kernel sources on the CPU
through the host stand-in. The plain versions are held to the JAX package
on the CPU by tests/test_torch_deep_gather.py, test_torch_deep_scatter.py
and test_torch_deep.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from raft_kotlin_tpu_torch.constants import LEADER
from raft_kotlin_tpu_torch.models.state import STATE_FIELDS, init_state
from raft_kotlin_tpu_torch.ops import (
    build, cuda_tick, deep_gather, deep_scatter)
from raft_kotlin_tpu_torch.ops import tick as ttick
from raft_kotlin_tpu_torch.utils import telemetry as ttel
from raft_kotlin_tpu_torch.utils.config import deep_config


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")


def logs(rng, N, C, G, dtype, dev):
    return tuple(torch.from_numpy(rng.integers(
        -2 ** 15, 2 ** 15, (N * C, G)).astype(dtype)).to(dev)
        for _ in range(2))


def gather_case(seed, N, C, Rt, G, dtype, dev):
    rng = np.random.default_rng(seed)
    lt, lc = logs(rng, N, C, G, dtype, dev)
    rows = rng.integers(0, C, (N * Rt, G)).astype(np.int32)
    rows[0], rows[1], rows[-1] = 0, C - 1, C - 1
    rows[2], rows[Rt + N] = -1, C  # outside the window: read 0
    return lt, lc, torch.from_numpy(rows).to(dev)


# The engine's batches at N = 7: (Rt, Rc) of the synchronous one (cmd rows
# the term rows [7, 14)) and of the known-delivery mailbox one ([7, 28)).
BATCHES = {"sync": (29, 7), "mailbox": (43, 21)}


def shifted(t, offset):
    """A copy of `t` whose base lies `offset` elements past the start of
    its allocation (the allocator's blocks start 16-byte aligned)."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


# (G, offset): the 16-byte path at 4,096 groups; the one-element path at a
# ragged 4,099 and where every operand starts one element past a 16-byte
# boundary.
WIDTHS = [(4096, 0), (4099, 0), (4096, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("batch", sorted(BATCHES))
@pytest.mark.parametrize("G,offset", WIDTHS)
@pytest.mark.parametrize("dtype", [np.int16, np.int32])
def test_deep_gather_kernel_equals_plain(dtype, G, offset, batch):
    """Config 5's row counts (N=7; Rt = 29 with cmd rows [7, 14), and the
    mailbox batch's Rt = 43 with cmd rows [7, 28)) at C = 10,000, on the
    16-byte path and on the one-element one, as the launcher reports it."""
    need_card()
    dev = torch.device("cuda")
    N, C = 7, 10_000
    Rt, Rc = BATCHES[batch]
    lt, lc, rows = (shifted(x, offset)
                    for x in gather_case(1, N, C, Rt, G, dtype, dev))
    V = 16 // lt.element_size()
    lib = build.load_deep_library("deep_gather.cu")
    probe = torch.empty((N * Rc, G), dtype=lt.dtype, device=dev)
    ptrs, ints = deep_gather.launch_args(lt, lc, rows, probe, probe, N, C,
                                         Rc)
    assert deep_gather.vector_path(lib, ptrs, ints) == (
        G % V == 0 and offset == 0)
    n0 = deep_gather.LAUNCHES["deep_gather"]
    kt, kc = deep_gather.gather(lt, lc, rows, N, C, Rc)
    pt, pc = deep_gather.gather_plain(lt, lc, rows, N, C, Rc)
    torch.cuda.synchronize()
    assert deep_gather.LAUNCHES["deep_gather"] == n0 + 1
    assert kt.dtype == lt.dtype and kc.shape == (N * Rc, G)
    assert torch.equal(kt, pt) and torch.equal(kc, pc)
    assert (kt[2] == 0).all() and (kt[Rt + N] == 0).all()
    assert (kc[Rc] == 0).all()  # node 1's first cmd row is its term row N


@pytest.mark.cuda
@pytest.mark.parametrize("G,offset", WIDTHS)
@pytest.mark.parametrize("dtype", [np.int16, np.int32])
def test_deep_scatter_kernel_equals_plain(dtype, G, offset):
    """K = 8 writes per (node, lane) — dropped rows, rows outside the
    window, duplicates resolved to one value — at C = 10,000, rows read in
    16-byte words and one at a time: both logs equal after the kernel and
    the plain version."""
    need_card()
    dev = torch.device("cuda")
    N, C, K = 7, 10_000, 8
    rng = np.random.default_rng(2)
    rows = rng.integers(C - 20, C + 4, (N * K, G)).astype(np.int32)
    rows = np.minimum(rows, C)
    rows[0], rows[1] = -1, C + 9
    vt = rng.integers(-2 ** 15, 2 ** 15, (N, K, G))
    vc = rng.integers(-2 ** 15, 2 ** 15, (N, K, G))
    # Duplicates carry the value of the last write at their row.
    r3 = rows.reshape(N, K, G)
    eq = r3[:, :, None, :] == r3[:, None, :, :]  # [n, k, j, g]
    last = K - 1 - np.argmax(eq[:, :, ::-1, :], axis=2)
    vt = np.take_along_axis(vt, last, axis=1).reshape(N * K, G)
    vc = np.take_along_axis(vc, last, axis=1).reshape(N * K, G)
    t = lambda a: shifted(torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a)).to(dev), offset)
    rows_t, vt_t, vc_t = t(rows), t(vt.astype(dtype)), t(vc.astype(dtype))
    lt, lc = (shifted(x, offset)
              for x in logs(np.random.default_rng(3), N, C, G, dtype, dev))
    a_t, a_c = shifted(lt, offset), shifted(lc, offset)
    b_t, b_c = lt.clone(), lc.clone()
    lib = build.load_deep_library("deep_scatter.cu")
    ptrs, ints = deep_scatter.launch_args(a_t, a_c, rows_t, vt_t, vc_t, N,
                                          C, K)
    assert deep_scatter.vector_path(lib, ptrs, ints) == (
        G % 4 == 0 and offset == 0)
    n0 = deep_scatter.LAUNCHES["deep_scatter"]
    deep_scatter.scatter(a_t, a_c, rows_t, vt_t, vc_t, N, C, K)
    deep_scatter.scatter_plain(b_t, b_c, rows_t, vt_t, vc_t, N, C, K)
    torch.cuda.synchronize()
    assert deep_scatter.LAUNCHES["deep_scatter"] == n0 + 1
    assert torch.equal(a_t, b_t) and torch.equal(a_c, b_c)
    assert not torch.equal(a_t, lt)  # something was written


@pytest.mark.cuda
def test_deep_run_on_the_card_equals_the_cpu():
    """Config 5's soup at C = 10,000 over 515 groups, 60 ticks through
    make_run on the card (the deep kernels, one gather and one scatter
    launch a tick, no plain read or write on the card) against the plain
    run on the CPU: end state and recorder equal."""
    need_card()
    cfg = deep_config(515)
    ticks = 60
    deep_gather.reset_counts()
    deep_scatter.reset_counts()
    card = ttick.make_run(cfg, ticks, trace=False, telemetry=True,
                          device="cuda")(init_state(cfg, "cuda"))
    assert deep_gather.LAUNCHES == {"deep_gather": ticks}
    assert deep_scatter.LAUNCHES == {"deep_scatter": ticks}
    assert deep_gather.PLAIN_ON_CUDA == {"deep_gather": 0}
    assert deep_scatter.PLAIN_ON_CUDA == {"deep_scatter": 0}
    cpu = ttick.make_run(cfg, ticks, trace=False, telemetry=True,
                         device="cpu")(init_state(cfg, "cpu"))
    for k in STATE_FIELDS:
        assert torch.equal(getattr(card[0], k).cpu(), getattr(cpu[0], k)), k
    assert ttel.summarize_telemetry(card[2]) == ttel.summarize_telemetry(
        cpu[2])
    assert int((card[0].role == LEADER).any(0).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [None, False])
def test_deep_mailbox_run_on_the_card_equals_the_cpu(batched):
    """Config 5 with delays [1,3] over 515 groups, 30 ticks through
    make_run on the card: the batched engine launches the deep gather (its
    mailbox batch) and the deep scatter once a tick, the per-pair engine
    neither, no plain read or write on the card; end state (every slot
    too) and recorder equal to the plain CPU run."""
    need_card()
    cfg = dataclasses.replace(deep_config(515), delay_lo=1, delay_hi=3)
    ticks = 30
    deep_gather.reset_counts()
    deep_scatter.reset_counts()
    card = ttick.make_run(cfg, ticks, trace=False, telemetry=True,
                          batched=batched, device="cuda")(
        init_state(cfg, "cuda"))
    n = ticks if batched is None else 0
    assert deep_gather.LAUNCHES == {"deep_gather": n}
    assert deep_scatter.LAUNCHES == {"deep_scatter": n}
    assert deep_gather.PLAIN_ON_CUDA == {"deep_gather": 0}
    assert deep_scatter.PLAIN_ON_CUDA == {"deep_scatter": 0}
    cpu = ttick.make_run(cfg, ticks, trace=False, telemetry=True,
                         device="cpu")(init_state(cfg, "cpu"))
    for k in card[0].fields():
        assert torch.equal(getattr(card[0], k).cpu(), getattr(cpu[0], k)), k
    assert ttel.summarize_telemetry(card[2]) == ttel.summarize_telemetry(
        cpu[2])
    assert int(cpu[0].commit.max()) > 0


@pytest.mark.cuda
def test_deep_wrappers_raise_instead_of_falling_back():
    need_card()
    dev = torch.device("cuda")
    N, C, Rt, G = 3, 256, 13, 64
    lt, lc, rows = gather_case(4, N, C, Rt, G, np.int16, dev)
    g0 = dict(deep_gather.LAUNCHES)
    s0 = dict(deep_scatter.LAUNCHES)
    for bad in (dict(rows=rows.long()), dict(lc=lc.int()),
                dict(rows=rows.cpu()), dict(lt=lt[:, :32]),
                dict(rows=rows[:N * (2 * N - 1)])):
        args = {**dict(lt=lt, lc=lc, rows=rows), **bad}
        with pytest.raises(ValueError):
            deep_gather.gather(**args, N=N, C=C)
    rows = torch.full((N * 4, G), C, dtype=torch.int32, device=dev)
    vals = torch.zeros((N * 4, G), dtype=torch.int16, device=dev)
    with pytest.raises(ValueError):
        deep_scatter.scatter(lt, lc, rows, vals.int(), vals, N, C, 4)
    with pytest.raises(ValueError):
        deep_scatter.scatter(lt, lc, rows[:, 1:], vals, vals, N, C, 4)
    assert deep_gather.LAUNCHES == g0 and deep_scatter.LAUNCHES == s0
    # The shallow tick kernel is never chosen for a deep config.
    with pytest.raises(NotImplementedError):
        cuda_tick.make_cuda_tick(deep_config(64), dev)
