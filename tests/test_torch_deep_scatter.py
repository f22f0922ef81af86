"""The deep-log deferred writes (raft_kotlin_tpu_torch/ops/deep_scatter.py)
against the JAX package's Pallas scatter in both its forms
(ops/deep_scatter.build_scatter, DMA and grid, in interpret mode as
tests/test_deep_scatter.py runs them), on seeded numpy inputs with dropped
rows (row == C) and duplicate rows resolved to the last write's value (the
engine's contract). Tolerance: zero (integers).

The CUDA kernel itself is held to the plain version on the card by
tests/test_torch_cuda_deep.py (`cuda` marker).
"""

import numpy as np
import pytest
import torch

from raft_kotlin_tpu.ops import deep_scatter as jscatter
from raft_kotlin_tpu_torch.ops import deep_scatter

# N, C, K, G: K = N + 1 is the engine's write count at N=3 with a
# periodic command; K = 5 pads to the Pallas form's 8-row blocks.
SHAPES = ((3, 256, 4, 8), (2, 64, 5, 16))


def case(seed, N, C, K, G, dtype):
    rng = np.random.default_rng(seed)
    lt = rng.integers(-5, 90, (N * C, G)).astype(dtype)
    lc = rng.integers(0, 70, (N * C, G)).astype(dtype)
    # Few distinct rows, so duplicates within a lane are common; C + 3 and
    # above clip to C (dropped).
    rows = np.minimum(rng.integers(C - 6, C + 3, (N * K, G)), C).astype(
        np.int32)
    rows[::2] = rng.integers(0, 4, rows[::2].shape)  # slots 0..3 as well
    vt = rng.integers(1, 50, (N * K, G)).astype(np.int32)
    vc = vt + 7
    # The caller's contract: a duplicate row carries its LAST write's value.
    for n in range(N):
        for g in range(G):
            last = {}
            for k in range(K):
                last[rows[n * K + k, g]] = k
            for k in range(K):
                kk = last[rows[n * K + k, g]]
                vt[n * K + k, g] = vt[n * K + kk, g]
                vc[n * K + k, g] = vc[n * K + kk, g]
    return lt, lc, rows, vt.astype(dtype), vc.astype(dtype)


@pytest.mark.parametrize("dma", [True, False], ids=["dma", "grid"])
@pytest.mark.parametrize("dtype", [np.int16, np.int32])
def test_scatter_plain_equals_pallas_interpret(dtype, dma):
    for seed, (N, C, K, G) in enumerate(SHAPES):
        lt, lc, rows, vt, vc = case(seed, N, C, K, G, dtype)
        assert (rows == C).any() and (rows < C).any()
        call = jscatter.build_scatter(N, C, K, np.dtype(dtype).name, G, True,
                                      dma=dma)
        want_t, want_c = (np.asarray(v) for v in call(lt, lc, rows, vt, vc))
        got_t, got_c = torch.from_numpy(lt.copy()), torch.from_numpy(lc.copy())
        deep_scatter.scatter_plain(got_t, got_c, torch.from_numpy(rows),
                                   torch.from_numpy(vt), torch.from_numpy(vc),
                                   N, C, K)
        np.testing.assert_array_equal(got_t.numpy(), want_t)
        np.testing.assert_array_equal(got_c.numpy(), want_c)
        # The wrapper takes the plain version for CPU tensors, uncounted.
        via_t, via_c = torch.from_numpy(lt.copy()), torch.from_numpy(lc.copy())
        n0 = dict(deep_scatter.LAUNCHES)
        deep_scatter.scatter(via_t, via_c, torch.from_numpy(rows),
                             torch.from_numpy(vt), torch.from_numpy(vc),
                             N, C, K)
        assert deep_scatter.LAUNCHES == n0
        assert torch.equal(via_t, got_t) and torch.equal(via_c, got_c)


def test_scatter_plain_drops_every_row_outside_the_window():
    """Rows C, -1 and C + 5 write nothing, here or in a neighbour node."""
    N, C, K, G = 3, 64, 4, 8
    lt, lc, rows, vt, vc = case(9, N, C, K, G, np.int16)
    rows[:] = C
    rows[1], rows[K + 2] = -1, C + 5
    got_t, got_c = torch.from_numpy(lt.copy()), torch.from_numpy(lc.copy())
    deep_scatter.scatter_plain(got_t, got_c, torch.from_numpy(rows),
                               torch.from_numpy(vt), torch.from_numpy(vc),
                               N, C, K)
    np.testing.assert_array_equal(got_t.numpy(), lt)
    np.testing.assert_array_equal(got_c.numpy(), lc)
