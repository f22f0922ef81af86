"""The deep gather (#6, ops/csrc/deep_gather.cu) and the deep scatter (#5,
ops/csrc/deep_scatter.cu) run on the CPU: each source is built with g++
against the host stand-in for the CUDA runtime (ops/host_build.py),
launched through its C interface on CPU tensors, and held bit-equal to its
plain version (ops/deep_gather.gather_plain, ops/deep_scatter.
scatter_plain; tolerance zero: integers).

The group counts cover both ways a thread reads and writes: 256 (every
base 16-byte aligned: the 16-byte path), 100 (int16 rows 8-byte aligned
only: the one-element path for the gather's int16 launch, the 16-byte one
for its int32 launch and for the scatter) and 37 (odd: one element at a
time everywhere), and a log whose base is one element past a 16-byte
boundary. Rows take the window's edges and the values outside it (-1, 0,
C - 1, C, C + 9). Every output sits between guard elements that must
come back untouched. The launches use 16 threads a block, so that a
launch has several blocks along x at these widths. The card runs the same
sources (tests/test_torch_cuda_deep.py, chip_smoke.py).
"""

import ctypes

import numpy as np
import pytest
import torch

from raft_kotlin_tpu_torch.ops import deep_gather, deep_scatter, host_build

C = 64
THREADS = 16
GUARD = 64  # bytes of guard before and after each output: keeps alignment
SENTINEL = -12345


@pytest.fixture(scope="module")
def libs():
    if host_build.compiler() is None:
        pytest.skip("needs a host C++ compiler (g++)")
    out = {}
    for src, fn in (("deep_gather.cu", "raft_deep_gather_launch"),
                    ("deep_scatter.cu", "raft_deep_scatter_launch")):
        L = host_build.build_host(src)
        getattr(L, fn).argtypes = [ctypes.c_void_p] * 3
        getattr(L, fn).restype = ctypes.c_int
        out[src] = L
    return out


@pytest.fixture
def host(libs, monkeypatch):
    # The launch arguments name a device index; the host build ignores it.
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    return libs


def guarded(shape, dtype, offset=0, fill=None):
    """A tensor of `shape` inside a buffer with GUARD bytes of SENTINEL on
    both sides (its base `offset` elements past a 16-byte boundary);
    returns (tensor, buffer)."""
    g = GUARD // torch.empty((), dtype=dtype).element_size()
    n = int(np.prod(shape))
    buf = torch.full((2 * g + n + offset,), SENTINEL, dtype=dtype)
    t = buf[g + offset:g + offset + n].view(shape)
    if fill is not None:
        t.copy_(fill)
    return t, buf


def guards_intact(t, buf):
    lo = t.data_ptr() - buf.data_ptr()
    k = lo // buf.element_size()
    return bool((buf[:k] == SENTINEL).all()
                and (buf[k + t.numel():] == SENTINEL).all())


def launch(L, name, ptrs, ints):
    ints = ints[:5] + (THREADS,) + ints[6:]
    err = getattr(L, name)((ctypes.c_void_p * 5)(*ptrs),
                           (ctypes.c_longlong * len(ints))(*ints), None)
    assert err == 0


def edges(rows, rng, picks):
    """Put the window's edges and the values outside it at random places,
    and into the rows named by `picks`."""
    for v in (-1, 0, C - 1, C, C + 9):
        rows[rng.integers(0, rows.shape[0], 6),
             rng.integers(0, rows.shape[1], 6)] = v
    for r, v in picks:
        rows[r] = v


def logs(rng, N, G, dtype, offset=0):
    tdt = torch.from_numpy(np.zeros(1, dtype)).dtype
    return tuple(guarded((N * C, G), tdt, offset, torch.from_numpy(
        rng.integers(-2 ** 15, 2 ** 15, (N * C, G)).astype(dtype)))
        for _ in range(2))


# (dtype, N, G, base offset, batch): the synchronous batch (Rt = 4N + 1,
# Rc = N) at every width, the known-delivery mailbox batch (Rt = 6N + 1,
# Rc = 3N) at N = 3 and 7 (Rt = 43, Rc = 21) on both paths.
GATHER_CASES = [(dtype, N, G, 0, "sync") for dtype in (np.int16, np.int32)
                for N in (3, 7) for G in (256, 100, 37)] + [
    (np.int16, 3, 256, 1, "sync")] + [
    (dtype, N, G, 0, "mailbox") for dtype in (np.int16, np.int32)
    for N in (3, 7) for G in (256, 37)]


@pytest.mark.parametrize("dtype,N,G,offset,batch", [
    pytest.param(*c, id="-".join(map(str, (np.dtype(c[0]).name, *c[1:4])))
                 + ("" if c[4] == "sync" else "-mailbox"))
    for c in GATHER_CASES])
def test_host_deep_gather_equals_plain(host, dtype, N, G, offset, batch):
    Rt, Rc = (4 * N + 1, N) if batch == "sync" else (6 * N + 1, 3 * N)
    rng = np.random.default_rng(N * 1000 + G)
    (lt, lt_buf), (lc, lc_buf) = logs(rng, N, G, dtype, offset)
    rows = rng.integers(0, C, (N * Rt, G)).astype(np.int32)
    # Node 0's first entry row and node 1's last read outside the window.
    edges(rows, rng, [(N, C), (Rt + N + Rc - 1, -1), (2, C + 9)])
    rows = torch.from_numpy(rows)
    tdt = lt.dtype
    vt, vt_buf = guarded((N * Rt, G), tdt)
    vc, vc_buf = guarded((N * Rc, G), tdt)
    ptrs, ints = deep_gather.launch_args(lt, lc, rows, vt, vc, N, C, Rc)
    V = 16 // lt.element_size()
    L = host["deep_gather.cu"]
    assert deep_gather.vector_path(L, ptrs, ints) == (G % V == 0
                                                      and offset == 0)
    launch(L, "raft_deep_gather_launch", ptrs, ints)
    want_t, want_c = deep_gather.gather_plain(lt, lc, rows, N, C, Rc)
    assert torch.equal(vt, want_t) and torch.equal(vc, want_c)
    assert (vc[0] == 0).all() and (vt[2] == 0).all()
    for t, buf in ((vt, vt_buf), (vc, vc_buf), (lt, lt_buf), (lc, lc_buf)):
        assert guards_intact(t, buf)


SCATTER_CASES = [(dtype, N, G, 0) for dtype in (np.int16, np.int32)
                 for N in (3, 7) for G in (256, 100, 37)] + [
    (np.int16, 3, 256, 1)]


@pytest.mark.parametrize("dtype,N,G,offset", SCATTER_CASES)
def test_host_deep_scatter_equals_plain(host, dtype, N, G, offset):
    K = 6
    rng = np.random.default_rng(N * 1000 + G + 7)
    # Mostly dropped (row C) and the rest crowded near the window's top,
    # so that duplicates within a group are common.
    rows = np.minimum(rng.integers(C - 8, C + 4, (N * K, G)), C).astype(
        np.int32)
    edges(rows, rng, [(1, C + 9), (K, -1)])
    vt = rng.integers(-2 ** 15, 2 ** 15, (N, K, G))
    vc = rng.integers(-2 ** 15, 2 ** 15, (N, K, G))
    # Duplicates carry the value of the last write at their row.
    r3 = rows.reshape(N, K, G)
    eq = r3[:, :, None, :] == r3[:, None, :, :]  # [n, k, j, g]
    assert (eq.sum(2) > 1).any()
    last = K - 1 - np.argmax(eq[:, :, ::-1, :], axis=2)
    vt = np.take_along_axis(vt, last, axis=1).reshape(N * K, G)
    vc = np.take_along_axis(vc, last, axis=1).reshape(N * K, G)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    rows_t, vt_t, vc_t = t(rows), t(vt.astype(dtype)), t(vc.astype(dtype))
    (lt, lt_buf), (lc, lc_buf) = logs(rng, N, G, dtype, offset)
    before_t, before_c = lt.clone(), lc.clone()
    ptrs, ints = deep_scatter.launch_args(lt, lc, rows_t, vt_t, vc_t, N, C,
                                          K)
    L = host["deep_scatter.cu"]
    assert deep_scatter.vector_path(L, ptrs, ints) == (G % 4 == 0)
    launch(L, "raft_deep_scatter_launch", ptrs, ints)
    want_t, want_c = before_t.clone(), before_c.clone()
    deep_scatter.scatter_plain(want_t, want_c, rows_t, vt_t, vc_t, N, C, K)
    assert torch.equal(lt, want_t) and torch.equal(lc, want_c)
    # Nothing but the kept writes' places changed: no dropped row and no
    # row outside the window was written.
    kept = np.zeros((N * C, G), dtype=bool)
    n_of = np.repeat(np.arange(N), K)[:, None]
    ok = (rows >= 0) & (rows < C)
    kept[(n_of * C + rows)[ok], np.broadcast_to(np.arange(G), rows.shape)
         [ok]] = True
    for log, before in ((lt, before_t), (lc, before_c)):
        changed = (log != before).numpy()
        assert not (changed & ~kept).any()
    assert (lt != before_t).any()
    for x, buf in ((lt, lt_buf), (lc, lc_buf)):
        assert guards_intact(x, buf)


def test_deep_launch_args_refuse_grids_past_the_card_limits():
    """The grid's y and z extents (Rt or K, and N) and G are checked before
    any pointer is taken."""
    meta = lambda *s: torch.empty(s, dtype=torch.int16,  # noqa: E731
                                  device="meta")
    rows = torch.empty((65_536 * 2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        deep_gather.launch_args(meta(2 * 8, 4), meta(2 * 8, 4), rows,
                                meta(1, 4), meta(1, 4), 2, 8)
    with pytest.raises(ValueError):
        deep_scatter.launch_args(meta(2 * 8, 4), meta(2 * 8, 4), rows,
                                 rows, rows, 2, 8, 65_536)
    with pytest.raises(ValueError):
        deep_scatter.launch_args(meta(1, 2 ** 31), meta(1, 2 ** 31),
                                 meta(1, 2 ** 31), meta(1, 2 ** 31),
                                 meta(1, 2 ** 31), 1, 1, 1)
