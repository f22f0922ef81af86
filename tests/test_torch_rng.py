"""The port's counted threefry (raft_kotlin_tpu_torch/utils/rng.py) must give
jax.random's bits exactly: key words, fold_in, the static key grids, the
keyed scalar draws, the boot draw and the shaped event masks — including
counters and ticks past 2^31 read as u32, and the p = 0 / p = 1 edges.
Tolerance: zero (bit-equal integers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_kotlin_tpu.utils import rng as jrng
from raft_kotlin_tpu_torch.utils import rng as trng

SEEDS = (0, 17, 2 ** 31 - 1, -5)


def key_words(k) -> tuple:
    return tuple(int(w) for w in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("seed", SEEDS)
def test_base_key_and_fold_in(seed):
    jb, tb = jrng.base_key(seed), trng.base_key(seed)
    assert key_words(jb) == tb
    for d in (0, 1, 7, 2 ** 31 + 3, 2 ** 32 - 1):
        assert key_words(jax.random.fold_in(jb, d)) == trng.fold_in(tb, d)


@pytest.mark.parametrize("seed", SEEDS)
def test_grid_keys(seed):
    G, N = 9, 5
    jk = np.asarray(jax.random.key_data(
        jrng.grid_keys(jrng.base_key(seed), jrng.KIND_BACKOFF, G, N)))
    k0, k1 = trng.grid_keys(trng.base_key(seed), trng.KIND_BACKOFF, G, N,
                            "cpu")
    np.testing.assert_array_equal(k0.numpy(), jk[..., 0])
    np.testing.assert_array_equal(k1.numpy(), jk[..., 1])


@pytest.mark.parametrize("seed,lo,hi", [(0, 20, 23), (3, 2, 3), (-5, 200, 230),
                                        (11, 7, 7)])
def test_draw_uniform_keyed(seed, lo, hi):
    G, N = 7, 5
    ctrs = np.random.default_rng(seed & 0xFF).integers(
        -2 ** 31, 2 ** 31 - 1, size=(N, G)).astype(np.int32)
    ctrs[0, :3] = (0, 1, -1)  # -1 is counter 2^32 - 1 in u32
    jk = jrng.grid_keys(jrng.base_key(seed), jrng.KIND_TIMEOUT, G, N).T
    want = np.asarray(jrng.draw_uniform_keyed(jk, jnp.asarray(ctrs), lo, hi))
    tk = trng.grid_keys(trng.base_key(seed), trng.KIND_TIMEOUT, G, N, "cpu")
    got = trng.draw_uniform_keyed((tk[0].T, tk[1].T), torch.from_numpy(ctrs),
                                  lo, hi)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_boot_draw_uniform_grid(seed):
    G, N = 11, 3
    want = np.asarray(jrng.draw_uniform_grid(
        jrng.base_key(seed), jrng.KIND_TIMEOUT, jnp.zeros((G, N), jnp.int32),
        20, 23))
    got = trng.draw_uniform_grid(trng.base_key(seed), trng.KIND_TIMEOUT,
                                 torch.zeros((G, N), dtype=torch.int64), 20, 23)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p", [0.0, 0.25, 0.5, 1.0])
@pytest.mark.parametrize("tick", [0, 77, 2 ** 31 + 5])
def test_edge_ok_mask(p, tick):
    shape = (6, 5, 5)
    jt = jnp.uint32(tick)
    for seed in (0, 9):
        want = np.asarray(jrng.edge_ok_mask(jrng.base_key(seed), jt, shape, p))
        got = trng.edge_ok_mask(trng.base_key(seed), tick, shape, p, "cpu")
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", [jrng.KIND_CRASH, jrng.KIND_RESTART,
                                  jrng.KIND_LINK_FAIL, jrng.KIND_LINK_HEAL])
@pytest.mark.parametrize("p", [0.0, 0.01, 0.08, 1.0])
def test_event_mask(kind, p):
    for shape, tick in (((6, 5), 3), ((4, 3, 3), 2 ** 31 + 9)):
        want = np.asarray(jrng.event_mask(jrng.base_key(1), kind,
                                          jnp.uint32(tick), shape, p))
        got = trng.event_mask(trng.base_key(1), kind, tick, shape, p, "cpu")
        np.testing.assert_array_equal(got.numpy(), want)


def test_p_threshold_and_kinds():
    for p in (0.0, 1e-9, 0.01, 0.08, 0.25, 1 / 3, 0.999999, 1.0, 2.0,
              float("nan")):
        assert trng.p_threshold(p) == jrng.p_threshold(p)
    for name in ("KIND_TIMEOUT", "KIND_BACKOFF", "KIND_FAULT", "KIND_CRASH",
                 "KIND_RESTART", "KIND_LINK_FAIL", "KIND_LINK_HEAL", "P_SHIFT"):
        assert getattr(trng, name) == getattr(jrng, name)
