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

from raft_kotlin_tpu_torch.utils.config import (
    PART_ASYM, PART_LEADER, PART_NONE, PART_SPLIT)

KIND_TIMEOUT = 0
KIND_BACKOFF = 1
KIND_FAULT = 2
KIND_CRASH = 3
KIND_RESTART = 4
KIND_LINK_FAIL = 5
KIND_LINK_HEAL = 6
KIND_DELAY = 7

# Scenario-bank sampling kinds (SEMANTICS.md §12): one counted threefry
# stream per channel, keyed by (farm_seed, kind, universe_id) — never by the
# batch shape. Disjoint from the per-tick kinds above.
SCEN_KIND_DROP = 32
SCEN_KIND_CRASH = 33
SCEN_KIND_RESTART = 34
SCEN_KIND_LINK_FAIL = 35
SCEN_KIND_LINK_HEAL = 36
SCEN_KIND_DELAY_LO = 37
SCEN_KIND_DELAY_HI = 38
SCEN_KIND_PART_KIND = 39
SCEN_KIND_PART_CUT = 40
SCEN_KIND_PART_SRC = 41
SCEN_KIND_PART_DST = 42
SCEN_KIND_PART_PERIOD = 43
SCEN_KIND_PART_DUTY = 44
SCEN_KIND_PART_PHASE = 45

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
    u32 arithmetic as jax does; lo / span may be tensors."""
    hb = bits32(fold_in(key, 0), idx)
    lb = bits32(fold_in(key, 1), idx)
    # 2^32 mod span, squared in u32 as jax does (it wraps for spans past
    # 2^16, e.g. a bank's 23-bit threshold draw).
    mult = (((65536 % span) ** 2) & M32) % span
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


def _thresh_bcast(thresh, shape):
    """A scalar or per-group (G,) threshold, broadcastable against a
    (G, ...) event shape."""
    if isinstance(thresh, torch.Tensor) and thresh.dim() == 1:
        return thresh.to(torch.int64).reshape(
            thresh.shape + (1,) * (len(shape) - 1))
    return thresh


def edge_ok_mask(base, tick: int, shape, p_drop: float, device,
                 thresh=None) -> torch.Tensor:
    """Canonical (G, N, N) bool: [g, s-1, r-1] is True iff the directed
    message s -> r of group g survives tick `tick` (SEMANTICS.md §4).
    `thresh`, a (G,) tensor of 23-bit thresholds (the scenario bank's drop
    channel, §12), replaces p_drop on the same integer compare."""
    if thresh is None:
        if p_drop <= 0.0:
            return torch.ones(shape, dtype=torch.bool, device=device)
        thresh = p_threshold(p_drop)
    return _event_bits(base, KIND_FAULT, tick, shape, device) \
        >= _thresh_bcast(thresh, shape)


def event_mask(base, kind: int, tick: int, shape, p: float,
               device, thresh=None) -> torch.Tensor:
    """Shaped bool event draw (True = the event fires) for tick `tick`:
    crash/restart/link-fail/link-heal (SEMANTICS.md §9). `thresh` selects
    the per-group scenario-bank channel, as in edge_ok_mask."""
    if thresh is None:
        if p <= 0.0:
            return torch.zeros(shape, dtype=torch.bool, device=device)
        thresh = p_threshold(p)
    return _event_bits(base, kind, tick, shape, device) \
        < _thresh_bcast(thresh, shape)


def delay_mask(base, tick: int, shape, lo: int, hi: int,
               device, lo_g=None, hi_g=None) -> torch.Tensor:
    """Canonical (G, N, N) int32: [g, s-1, r-1] is the delay of the exchange
    s sends to r at tick `tick`, uniform on [lo, hi] inclusive (SEMANTICS.md
    §10). One shaped randint on fold_in(fold_in(base, KIND_DELAY), tick);
    no draw at all when lo == hi. `lo_g` / `hi_g` ((G,) tensors, the
    scenario bank's delay windows) replace the bounds per group over the
    same drawn bits."""
    if lo_g is None and lo == hi:
        return torch.full(shape, lo, dtype=torch.int32, device=device)
    k = fold_in(fold_in(base, KIND_DELAY), tick)
    if lo_g is not None:
        lo = _thresh_bcast(lo_g, shape)
        span = _thresh_bcast(hi_g, shape) - lo + 1
    else:
        span = hi - lo + 1
    return randint_at(k, _lattice(shape, device), lo, span).to(torch.int32)


# ---------------------------------------------------------------------------
# Scenario bank (SEMANTICS.md §12): per-group fault thresholds, delay
# windows and scripted partition programs, sampled from a counted threefry
# stream keyed by (farm_seed, channel, universe_id) — the JAX package's
# utils/rng.py:230-475.

# Bank key -> (spec field of its maximum, the config's scalar, kind). Every
# bank value is a (G,) int32 row:
#   drop_t/crash_t/restart_t/link_fail_t/link_heal_t  23-bit thresholds
#   delay_lo/delay_hi                                 per-group §10 windows
#   part_kind (PART_* code) / part_cut (split block size) / part_src,
#   part_dst (asym directed edge) / part_period, part_duty, part_phase
#   (the flapping window: active iff (tick + phase) % period < duty)
THRESHOLD_CHANNELS = {
    "drop_t": ("drop_max", "p_drop", SCEN_KIND_DROP),
    "crash_t": ("crash_max", "p_crash", SCEN_KIND_CRASH),
    "restart_t": ("restart_max", "p_restart", SCEN_KIND_RESTART),
    "link_fail_t": ("link_fail_max", "p_link_fail", SCEN_KIND_LINK_FAIL),
    "link_heal_t": ("link_heal_max", "p_link_heal", SCEN_KIND_LINK_HEAL),
}
PARTITION_KEYS = ("part_kind", "part_cut", "part_src", "part_dst",
                  "part_period", "part_duty", "part_phase")


def _scen_draw(fkey, kind: int, uids: torch.Tensor, lo, hi) -> torch.Tensor:
    """(G,) int32: element u is the counted inclusive-uniform draw for
    universe uids[u] on [lo[u], hi[u]] (ints or (G,) tensors) — keyed by
    (farm_seed, kind, universe_id) alone: randint at lattice index 0 of
    fold_in(fold_in(farm key, kind), universe_id)."""
    k = fold_in(fold_in(fkey, kind), uids.to(torch.int64))
    lo = torch.as_tensor(lo, dtype=torch.int64, device=uids.device)
    span = torch.as_tensor(hi, dtype=torch.int64, device=uids.device) - lo + 1
    return randint_at(k, torch.zeros_like(uids, dtype=torch.int64),
                      lo, span).to(torch.int32)


def sample_scenario_bank(cfg, uids=None, device="cpu") -> dict:
    """The ScenarioBank of `cfg` (cfg.scenario must be set): a dict of
    (n_groups,) int32 tensors on `device` (see THRESHOLD_CHANNELS above).
    A key is present iff its channel is (scen_layout gives the order).

    `uids` overrides the universe-id row (universe_base + arange(G)) with
    an explicit (G,) sequence: draws are keyed by (farm_seed, kind,
    universe_id) only, so a universe's row does not depend on its batch.

    degenerate=True builds the bank from the config's own scalar fault
    fields instead of sampling: every group alike, every active scalar
    channel routed through the bank's path."""
    spec = cfg.scenario
    if spec is None:
        raise ValueError("sample_scenario_bank needs cfg.scenario")
    G, N = cfg.n_groups, cfg.n_nodes
    dev = torch.device(device)

    def full(v):
        return torch.full((G,), v, dtype=torch.int32, device=dev)

    bank: dict = {}
    if spec.degenerate:
        for key, (_mx, scalar, _kind) in THRESHOLD_CHANNELS.items():
            p = getattr(cfg, scalar)
            if p > 0:
                bank[key] = full(p_threshold(p))
        if cfg.delay_lo < cfg.delay_hi:
            bank["delay_lo"] = full(cfg.delay_lo)
            bank["delay_hi"] = full(cfg.delay_hi)
        return bank
    fkey = base_key(spec.farm_seed)
    if uids is None:
        uids = spec.universe_base + torch.arange(G, dtype=torch.int64,
                                                 device=dev)
    else:
        uids = torch.as_tensor(uids, device=dev).to(torch.int64)
        if tuple(uids.shape) != (G,):
            raise ValueError(f"uids must be ({G},), got {tuple(uids.shape)}")
    for key, (mx_name, _scalar, kind) in THRESHOLD_CHANNELS.items():
        mx = getattr(spec, mx_name)
        if mx > 0:
            bank[key] = _scen_draw(fkey, kind, uids, 0, p_threshold(mx))
    if spec.delay_windows:
        lo = _scen_draw(fkey, SCEN_KIND_DELAY_LO, uids, cfg.delay_lo,
                        cfg.delay_hi)
        bank["delay_lo"] = lo
        bank["delay_hi"] = _scen_draw(fkey, SCEN_KIND_DELAY_HI, uids, lo,
                                      cfg.delay_hi)
    if spec.partitions:
        codes = {"split": PART_SPLIT, "asym": PART_ASYM,
                 "leader": PART_LEADER}
        table = torch.tensor((PART_NONE,) + tuple(
            codes[k] for k in spec.partitions), dtype=torch.int32,
            device=dev)
        idx = _scen_draw(fkey, SCEN_KIND_PART_KIND, uids, 0,
                         len(spec.partitions))
        bank["part_kind"] = table[idx.long()]
        bank["part_cut"] = _scen_draw(fkey, SCEN_KIND_PART_CUT, uids, 1,
                                      max(1, N - 1))
        src = _scen_draw(fkey, SCEN_KIND_PART_SRC, uids, 1, N)
        dst0 = _scen_draw(fkey, SCEN_KIND_PART_DST, uids, 1, max(1, N - 1))
        bank["part_src"] = src
        # dst uniform over [1, N] without src (the spec needs N >= 2).
        bank["part_dst"] = dst0 + (dst0 >= src).to(torch.int32)
        period = _scen_draw(fkey, SCEN_KIND_PART_PERIOD, uids,
                            spec.part_period_lo, spec.part_period_hi)
        bank["part_period"] = period
        bank["part_duty"] = _scen_draw(fkey, SCEN_KIND_PART_DUTY, uids, 1,
                                       period)
        bank["part_phase"] = _scen_draw(fkey, SCEN_KIND_PART_PHASE, uids, 0,
                                        period - 1)
    unported = [k for k in scen_layout(cfg) if k not in bank]
    if unported:
        raise NotImplementedError(
            f"scenario bank channels {unported} (§19 timeout windows and "
            "lifetimes, §20 client streams) are not ported")
    return bank


def scenario_active(scen: dict, tick):
    """The §12 flapping window: True where a group's partition program is
    active at `tick` — (tick + phase) % period < duty (floor modulo)."""
    return torch.remainder(tick + scen["part_phase"], scen["part_period"]) \
        < scen["part_duty"]


def scenario_link_down(scen: dict, tick, leader_gn, N: int) -> torch.Tensor:
    """The per-tick scheduled-partition mask: (G, N, N) bool, True where the
    directed edge s -> r is down this tick under the group's partition
    program (SEMANTICS.md §12), gated by the flapping window and never on a
    self-edge:
    - PART_SPLIT: {1..cut} vs {cut+1..N}, cross edges down both ways;
    - PART_ASYM: the one directed edge src -> dst down;
    - PART_LEADER: every edge touching a node that was a live leader at
      the tick's start (`leader_gn`, (G, N) bool, the pre-tick state)."""
    kind = scen["part_kind"]
    G = kind.shape[0]
    dev = kind.device
    active = scenario_active(scen, tick)
    ids = torch.arange(1, N + 1, dtype=kind.dtype, device=dev)
    s_id, r_id = ids[None, :, None], ids[None, None, :]
    k = kind[:, None, None]
    cut = scen["part_cut"][:, None, None]
    split = (s_id <= cut) != (r_id <= cut)
    asym = (s_id == scen["part_src"][:, None, None]) \
        & (r_id == scen["part_dst"][:, None, None])
    if leader_gn is None:
        ldr = torch.zeros((G, N, N), dtype=torch.bool, device=dev)
    else:
        lg = leader_gn != 0
        ldr = lg[:, :, None] | lg[:, None, :]
    down = ((k == PART_SPLIT) & split) | ((k == PART_ASYM) & asym) \
        | ((k == PART_LEADER) & ldr)
    return down & active[:, None, None] & (s_id != r_id)


def apply_warmup_faults(spec, cmd_node: int, tick, crash, restart) -> tuple:
    """§15 warmup-down on the §9 crash/restart masks (canonical (G, N)
    orientation, 0-based tick): for warmup_down = W > 0 every node but
    cmd_node is held crashed on ticks t < W (random restarts suppressed)
    and restarted at exactly t == W. No draw is consumed."""
    W = 0 if spec is None else getattr(spec, "warmup_down", 0)
    if not W:
        return crash, restart
    N = crash.shape[-1]
    notcmd = (torch.arange(N, device=crash.device) != (cmd_node - 1))[None, :]
    hold = (tick < W) & notcmd
    rejoin = (tick == W) & notcmd
    return crash | hold, (restart & ~hold) | rejoin


# ---------------------------------------------------------------------------
# Kernel twins (SEMANTICS.md §17): the same counted threefry as plain int32
# word-plane arithmetic — the form the fused CUDA kernel evaluates per
# thread (ops/csrc/kt_rng.cuh) and the plain version of its in-kernel aux
# (ops/cuda_tick._kt_aux). Twins of the JAX package's kt_* functions
# (raft_kotlin_tpu/utils/rng.py:489-649): a word is the int32 BIT PATTERN
# of a u32; int32 adds wrap (two's complement), which is u32 addition; a
# u32 right shift is the arithmetic shift masked to the bits it keeps. The
# tests hold every twin bit-equal to the JAX package's, and to the
# int64-held functions above.

_I32 = torch.int32
_KT_MASK31 = 0x7FFFFFFF


def _to_i32(x) -> int:
    """The int32 bit pattern of a Python int read as u32."""
    x &= M32
    return x - (1 << 32) if x >= (1 << 31) else x


def _words(x, like=None) -> torch.Tensor:
    """A word operand as an int32 tensor (Python ints become 0-d tensors
    on `like`'s device)."""
    if isinstance(x, torch.Tensor):
        return x if x.dtype == _I32 else x.to(torch.int64).to(_I32)
    dev = like.device if isinstance(like, torch.Tensor) else "cpu"
    return torch.tensor(_to_i32(int(x)), dtype=_I32, device=dev)


def kt_key_words(keys) -> tuple:
    """Key words (k0, k1) — u32 values as Python ints or int64 tensors, the
    form base_key/fold_in/grid_keys return — as int32 bit-pattern tensors,
    shape preserved (0-d for Python ints)."""
    return _words(keys[0]), _words(keys[1])


def _kt_rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    """u32 rotate-left on int32 words: the arithmetic `>>` is masked to the
    r bits a logical shift keeps."""
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def kt_block(k0, k1, c0, c1) -> tuple:
    """One threefry2x32 block (20 rounds) on int32 words; operands
    broadcast (ints allowed). Returns (x0, x1) int32 tensors."""
    ref = next((v for v in (k0, k1, c0, c1) if isinstance(v, torch.Tensor)),
               None)
    k0, k1, c0, c1 = (_words(v, ref) for v in (k0, k1, c0, c1))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = c0 + k0
    x1 = c1 + k1
    for grp in range(5):
        for r in _ROT[grp % 2]:
            x0 = x0 + x1
            x1 = _kt_rotl(x1, r) ^ x0
        a, b, d = _INJ[grp]
        x0 = x0 + ks[a]
        x1 = x1 + ks[b] + d
    return x0, x1


def kt_fold(k0, k1, d) -> tuple:
    """fold_in twin: the words of fold_in(key, d), d an int or int32 tensor
    (negative ids are their u32 bit patterns)."""
    return kt_block(k0, k1, 0, d)


def kt_bits32(k0, k1, idx) -> torch.Tensor:
    """bits(key, shape) twin at flat lattice index idx: the int32 bit
    pattern of the u32 draw."""
    b0, b1 = kt_block(k0, k1, 0, idx)
    return b0 ^ b1


def kt_bits23(k0, k1, idx) -> torch.Tensor:
    """The 23-bit uniform lattice (u32 bits >> P_SHIFT), nonnegative."""
    return (kt_bits32(k0, k1, idx) >> P_SHIFT) & ((1 << P_BITS) - 1)


def _kt_umod(x: torch.Tensor, s):
    """u32 x mod s on int32 bit patterns (0 < s < 2^30):
    (x mod s) == ((x & 0x7fffffff) mod s + sign_bit * (2^31 mod s)) mod s."""
    lo = torch.remainder(x & _KT_MASK31, s)
    sign = (x >> 31) & 1
    top = torch.remainder(2 * torch.remainder(
        torch.as_tensor(2 ** 30, dtype=_I32, device=x.device), s), s)
    return torch.remainder(lo + sign * top, s)


def kt_randint(k0, k1, idx, lo, span) -> torch.Tensor:
    """jax.random.randint twin on [lo, lo + span) at flat index idx over the
    (already folded) key words; lo/span ints or int32 tensors, span^2 <
    2^31."""
    ka0, ka1 = kt_fold(k0, k1, 0)
    kb0, kb1 = kt_fold(k0, k1, 1)
    hb = kt_bits32(ka0, ka1, idx)
    lb = kt_bits32(kb0, kb1, idx)
    span = torch.as_tensor(span, dtype=_I32, device=hb.device)
    mult = torch.remainder(torch.remainder(
        torch.as_tensor(2 ** 16, dtype=_I32, device=hb.device), span) ** 2,
        span)
    off = torch.remainder(_kt_umod(hb, span) * mult + _kt_umod(lb, span),
                          span)
    return lo + off


def kt_draw_uniform(k0, k1, ctr, lo, hi) -> torch.Tensor:
    """draw_uniform_keyed twin: fold the live counter into the static-prefix
    key words, then the scalar randint (lattice index 0) on [lo, hi]."""
    c0, c1 = kt_fold(k0, k1, ctr)
    return kt_randint(c0, c1, torch.zeros_like(c0), lo, hi - lo + 1)


def kt_event_key(k0, k1, kind: int, tick) -> tuple:
    """Per-(kind, tick) channel key words: fold_in(fold_in(base, kind),
    tick)."""
    e0, e1 = kt_fold(k0, k1, kind)
    return kt_fold(e0, e1, tick)


def kt_edge_ok_mask(k0, k1, tick, idx, thresh) -> torch.Tensor:
    """edge_ok_mask twin at flat (g*N*N + (s-1)*N + (r-1)) index: True iff
    the message survives (bits23 >= thresh). The p_drop <= 0 fast path is
    the caller's."""
    e0, e1 = kt_event_key(k0, k1, KIND_FAULT, tick)
    return kt_bits23(e0, e1, idx) >= thresh


def kt_event_mask(k0, k1, kind: int, tick, idx, thresh) -> torch.Tensor:
    """event_mask twin: True = the event fires (bits23 < thresh). The p <= 0
    fast path is the caller's."""
    e0, e1 = kt_event_key(k0, k1, kind, tick)
    return kt_bits23(e0, e1, idx) < thresh


def kt_delay_mask(k0, k1, tick, idx, lo, hi) -> torch.Tensor:
    """delay_mask twin at the pair lattice index (g*N*N + (s-1)*N + (r-1)):
    the [lo, hi]-inclusive per-directed-pair delay. The lo == hi fast path
    (a constant, no draw) is the caller's."""
    d0, d1 = kt_event_key(k0, k1, KIND_DELAY, tick)
    return kt_randint(d0, d1, idx, lo, hi - lo + 1)


def kt_part_down(kind, cut, src, dst, active, s_id, r_id, lead_s=None,
                 lead_r=None) -> torch.Tensor:
    """scenario_link_down twin on the kernel's (N*N, L) pair orientation:
    bank rows (1, L), s_id / r_id (N*N, 1), lead_s / lead_r whether the
    edge's sender / receiver was a live leader at the tick's start (None:
    no leader program). Same programs, flapping gate (`active`) and
    self-edge exemption as the host function."""
    split = (s_id <= cut) != (r_id <= cut)
    asym = (s_id == src) & (r_id == dst)
    if lead_s is None:
        ldr = torch.zeros(torch.broadcast_shapes(s_id.shape, kind.shape),
                          dtype=torch.bool, device=kind.device)
    else:
        ldr = (lead_s != 0) | (lead_r != 0)
    down = ((kind == PART_SPLIT) & split) | ((kind == PART_ASYM) & asym) \
        | ((kind == PART_LEADER) & ldr)
    return down & active & (s_id != r_id)


def scen_layout(cfg) -> tuple:
    """The ordered ScenarioBank keys sample_scenario_bank(cfg) produces —
    from the config alone, so an in-kernel launch lays the (G,) bank rows
    out as key-table rows 4 + i in this order. Mirrors the bank's presence
    rules, the JAX package's channels the port does not run included (they
    are refused where a bank is sampled)."""
    spec = getattr(cfg, "scenario", None)
    if spec is None:
        return ()
    keys = []
    if spec.degenerate:
        for key, (_mx, scalar, _kind) in THRESHOLD_CHANNELS.items():
            if getattr(cfg, scalar) > 0:
                keys.append(key)
        if cfg.delay_lo < cfg.delay_hi:
            keys += ["delay_lo", "delay_hi"]
        return tuple(keys)
    for key, (mx_name, _scalar, _kind) in THRESHOLD_CHANNELS.items():
        if getattr(spec, mx_name) > 0:
            keys.append(key)
    if spec.delay_windows:
        keys += ["delay_lo", "delay_hi"]
    if spec.partitions:
        keys += list(PARTITION_KEYS)
    if spec.timeout_windows:
        keys += ["el_lo", "el_hi"]
    if spec.life_hi > 0:
        keys += ["life"]
    if spec.client_rate_max > 0:
        keys += ["client_rate"]
    if spec.client_read_max > 0:
        keys += ["client_read"]
    if spec.client_hot_max > 0:
        keys += ["client_hot"]
    return tuple(keys)
