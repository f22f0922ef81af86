"""The deep-log batched read (raft_kotlin_tpu_torch/ops/deep_gather.py)
against the JAX package's Pallas gather (ops/deep_gather.build_gather, in
interpret mode as tests/test_deep_gather.py runs it), on seeded numpy
inputs, at both of the engine's batches (Rc = N and the mailbox's Rc =
3N). Tolerance: zero (integers, values in the log dtype).

The CUDA kernel itself is held to the plain version on the card by
tests/test_torch_cuda_deep.py (`cuda` marker).
"""

import numpy as np
import pytest
import torch

from raft_kotlin_tpu.ops import deep_gather as jgather
from raft_kotlin_tpu_torch.ops import deep_gather

# N, C, G, and the engine's batches at N=3: (Rt, Rc) = (4N + 1, N), the
# synchronous batch (cmd rows the term rows [N, 2N)), and (6N + 1, 3N), the
# known-delivery mailbox batch (cmd rows the term rows [N, 4N)).
N3, C256, G8 = 3, 256, 8
BATCHES = {"sync": (4 * N3 + 1, N3), "mailbox": (6 * N3 + 1, 3 * N3)}
SHAPE = (N3, C256, BATCHES["sync"][0], G8)


def case(seed, dtype, Rt=SHAPE[2], Rc=N3):
    N, C, _, G = SHAPE
    rng = np.random.default_rng(seed)
    lt = rng.integers(-300, 30000, (N * C, G)).astype(dtype)
    lc = rng.integers(-5, 70, (N * C, G)).astype(dtype)
    rows = rng.integers(0, C, (N * Rt, G)).astype(np.int32)
    # The edges of each node's window: slot 0 and slot C - 1, the last
    # also as the last node's last cmd row.
    rows[0], rows[1], rows[(N - 1) * Rt + N + Rc - 1] = 0, C - 1, C - 1
    return lt, lc, rows


def jax_cmd_rows(rows, Rt=SHAPE[2], Rc=N3):
    """The JAX kernel's second row operand: each node's rows [N, N + Rc)."""
    N, _, _, G = SHAPE
    return np.ascontiguousarray(
        rows.reshape(N, Rt, G)[:, N:N + Rc].reshape(N * Rc, G))


@pytest.mark.parametrize("dtype,batch", [
    pytest.param(dtype, batch, id=np.dtype(dtype).name
                 + ("" if batch == "sync" else f"-{batch}"))
    for batch in BATCHES for dtype in (np.int16, np.int32)])
def test_gather_plain_equals_pallas_interpret(dtype, batch):
    N, C, _, G = SHAPE
    Rt, Rc = BATCHES[batch]
    lt, lc, rows = case(5, dtype, Rt, Rc)
    call = jgather.build_gather(N, C, Rt, Rc, np.dtype(dtype).name, G, True)
    want_t, want_c = (np.asarray(v)
                      for v in call(lt, lc, rows, jax_cmd_rows(rows, Rt, Rc)))
    args = [torch.from_numpy(a) for a in (lt, lc, rows)]
    got_t, got_c = deep_gather.gather_plain(*args, N, C, Rc)
    # The wrapper takes the plain version for CPU tensors, uncounted.
    n0 = dict(deep_gather.LAUNCHES)
    via_t, via_c = deep_gather.gather(*args, N, C, Rc)
    assert deep_gather.LAUNCHES == n0
    assert got_c.shape == (N * Rc, G)
    for got, via, want in ((got_t, via_t, want_t), (got_c, via_c, want_c)):
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(via.numpy(), want)


def test_gather_plain_reads_zero_outside_the_window():
    """A row outside [0, C) reads 0 and never a neighbour node's slot."""
    N, C, Rt, G = SHAPE
    lt, lc, rows = case(6, np.int32)
    rows[1], rows[2], rows[N] = -1, C, C + 7
    got_t, got_c = deep_gather.gather_plain(
        *(torch.from_numpy(a) for a in (lt, lc, rows)), N, C)
    assert (got_t[1] == 0).all() and (got_t[2] == 0).all()
    assert (got_t[N] == 0).all() and (got_c[0] == 0).all()
    g = np.arange(G)
    np.testing.assert_array_equal(got_t[5].numpy(), lt[rows[5], g])
    np.testing.assert_array_equal(got_c[1].numpy(), lc[rows[N + 1], g])
