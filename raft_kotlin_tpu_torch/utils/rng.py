"""Counted threefry2x32 draws in PyTorch, bit-identical to the JAX package.

Every random draw of the simulation is a counted threefry evaluation keyed by
(kind, group, node, counter) (SEMANTICS.md §4). The draws are part of the
semantics, so they cannot become `torch.Generator` draws: this module
re-derives JAX's bits exactly, on the conventions the JAX package's `kt_*`
kernel twins spell out on int32 words (`raft_kotlin_tpu/utils/rng.py`):

- `jax.random.key(seed)` has key words (0, seed);
- `fold_in(key, d)` is one threefry2x32 block at counter (0, d);
- with `jax_threefry_partitionable`, the u32 draw at flat (row-major) index
  i of a shaped `bits(key, shape)` is `b0 ^ b1` of the block at (0, i);
- `randint(key, (), lo, hi + 1)` splits the key into fold_in(key, 0) and
  fold_in(key, 1), draws one u32 from each and combines them as
  `(hi_bits % span * (2^32 % span) + lo_bits % span) % span` in u32.

Words are held as int64 tensors (or Python ints) with values in [0, 2^32):
int64 adds never overflow, so `& M32` after each add is exact u32 wrapping,
and `>>` on a non-negative int64 is the logical shift threefry needs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

KIND_TIMEOUT = 0
KIND_BACKOFF = 1
KIND_FAULT = 2
KIND_CRASH = 3
KIND_RESTART = 4
KIND_LINK_FAIL = 5
KIND_LINK_HEAL = 6

# Event probabilities live in a 23-bit integer domain: jax's f32 uniform is
# (bits >> 9) * 2^-23, so `bernoulli(key, p) == (bits >> 9) < p_threshold(p)`.
P_BITS = 23
P_SHIFT = 32 - P_BITS

M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
# Key-schedule injections after each 4-round group: (ks index for x0,
# ks index for x1, round-group counter added into x1).
_INJ = ((1, 2, 1), (2, 0, 2), (0, 1, 3), (1, 2, 4), (2, 0, 5))


def p_threshold(p: float) -> int:
    """The 23-bit threshold t with `uniform < f32(p)  <=>  (bits >> 9) < t`:
    f32(p) * 2^23 is exact in double, and ceil counts the lattice points
    strictly below p."""
    p32 = float(np.float32(p)) if p == p else 0.0  # NaN -> 0
    return max(0, min(math.ceil(p32 * (1 << P_BITS)), 1 << P_BITS))


def threefry_block(k0, k1, c0, c1):
    """One threefry2x32 block (20 rounds) on u32 words: key (k0, k1), counter
    (c0, c1). Operands are Python ints or int64 tensors holding u32 values
    and broadcast; returns (x0, x1) of the same kind."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (c0 + k0) & M32
    x1 = (c1 + k1) & M32
    tensors = isinstance(x0, torch.Tensor) or isinstance(x1, torch.Tensor)
    if tensors:
        dev = (x0 if isinstance(x0, torch.Tensor) else x1).device
        x0, x1 = torch.broadcast_tensors(
            torch.as_tensor(x0, dtype=torch.int64, device=dev),
            torch.as_tensor(x1, dtype=torch.int64, device=dev))
        x0, x1 = x0.clone(), x1.clone()
    for grp in range(5):
        for r in _ROT[grp % 2]:
            if tensors:
                x0.add_(x1).bitwise_and_(M32)
                hi = (x1 << r).bitwise_and_(M32)
                x1.bitwise_right_shift_(32 - r).bitwise_or_(hi).bitwise_xor_(x0)
            else:
                x0 = (x0 + x1) & M32
                x1 = (((x1 << r) & M32) | (x1 >> (32 - r))) ^ x0
        a, b, d = _INJ[grp]
        if tensors:
            x0.add_(ks[a]).bitwise_and_(M32)
            x1.add_(ks[b]).add_(d).bitwise_and_(M32)
        else:
            x0 = (x0 + ks[a]) & M32
            x1 = (x1 + ks[b] + d) & M32
    return x0, x1


def base_key(seed: int) -> tuple:
    """Key words of `jax.random.key(seed)` for an int32 seed: (0, seed)."""
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed must fit int32, got {seed}")
    return (0, seed & M32)


def fold_in(key, d):
    """Key words of `jax.random.fold_in(key, d)`; d is an int or a tensor
    (its int32 bit pattern is read as u32)."""
    k0, k1 = key
    if isinstance(d, torch.Tensor):
        d = d.to(torch.int64) & M32
    else:
        d = d & M32
    return threefry_block(k0, k1, 0, d)


def bits32(key, idx):
    """u32 draw of `bits(key, shape)` at flat lattice index `idx` (int64)."""
    b0, b1 = threefry_block(key[0], key[1], 0, idx)
    return b0 ^ b1


def _lattice(shape, device) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    return torch.arange(n, dtype=torch.int64, device=device).reshape(shape)


def randint_at(key, idx, lo: int, span: int):
    """`jax.random.randint(key, shape, lo, lo + span)` at flat index `idx`:
    two u32 lattices (keys fold_in(key, 0) / fold_in(key, 1)) combined in
    u32 arithmetic as jax does."""
    hb = bits32(fold_in(key, 0), idx)
    lb = bits32(fold_in(key, 1), idx)
    mult = ((65536 % span) ** 2) % span  # 2^32 mod span
    off = (((hb % span) * mult) & M32) + (lb % span)
    return lo + (off & M32) % span


def grid_keys(base, kind: int, G: int, N: int, device) -> tuple:
    """(G, N) key words of the static prefix of §4's derivation:
    [g, i] == fold_in(fold_in(fold_in(base, kind), g), i + 1)."""
    kk = fold_in(base, kind)
    g = torch.arange(G, dtype=torch.int64, device=device)[:, None]
    n = torch.arange(1, N + 1, dtype=torch.int64, device=device)[None, :]
    kg = threefry_block(kk[0], kk[1], 0, g.expand(G, N))
    return threefry_block(kg[0], kg[1], 0, n.expand(G, N))


def draw_uniform_keyed(keys, ctrs: torch.Tensor, lo: int,
                       hi: int) -> torch.Tensor:
    """Inclusive-uniform draws on [lo, hi] from static-prefix keys (see
    grid_keys): element [..] folds ctrs[..] into keys[..] and draws one
    scalar randint. keys are (k0, k1) tensors of ctrs' shape; int64 out."""
    k = fold_in(keys, ctrs)
    return randint_at(k, torch.zeros_like(ctrs, dtype=torch.int64), lo,
                      hi - lo + 1)


def draw_uniform_grid(base, kind: int, ctrs: torch.Tensor, lo: int,
                      hi: int) -> torch.Tensor:
    """Draws over a (G, N) counter grid; element [g, i] is the counted draw
    of (kind, g, node i + 1, ctrs[g, i]) — the boot draw's form."""
    G, N = ctrs.shape
    return draw_uniform_keyed(grid_keys(base, kind, G, N, ctrs.device),
                              ctrs, lo, hi)


def _event_bits(base, kind: int, tick: int, shape, device) -> torch.Tensor:
    """The 23-bit uniform lattice behind every shaped event mask."""
    k = fold_in(fold_in(base, kind), tick)
    return bits32(k, _lattice(shape, device)) >> P_SHIFT


def edge_ok_mask(base, tick: int, shape, p_drop: float, device) -> torch.Tensor:
    """Canonical (G, N, N) bool: [g, s-1, r-1] is True iff the directed
    message s -> r of group g survives tick `tick` (SEMANTICS.md §4)."""
    if p_drop <= 0.0:
        return torch.ones(shape, dtype=torch.bool, device=device)
    return _event_bits(base, KIND_FAULT, tick, shape, device) \
        >= p_threshold(p_drop)


def event_mask(base, kind: int, tick: int, shape, p: float,
               device) -> torch.Tensor:
    """Shaped bool event draw (True = the event fires) for tick `tick`:
    crash/restart/link-fail/link-heal (SEMANTICS.md §9)."""
    if p <= 0.0:
        return torch.zeros(shape, dtype=torch.bool, device=device)
    return _event_bits(base, kind, tick, shape, device) < p_threshold(p)
