// Counted threefry2x32 on u32 words, per thread: the CUDA form of the JAX
// package's kt_* kernel twins (raft_kotlin_tpu/utils/rng.py:489-649) and of
// the port's plain twins (raft_kotlin_tpu_torch/utils/rng.py kt_*), which
// the tests hold bit-equal to jax.random's derivation under
// jax_threefry_partitionable:
//
// - a key is two u32 words; fold_in(key, d) is one block at counter (0, d);
// - the u32 draw at flat lattice index i of a shaped bits(key, shape) is
//   b0 ^ b1 of the block at counter (0, i);
// - a 23-bit uniform is bits >> 9, compared against an integer threshold;
// - randint on [lo, lo + span) draws one u32 under fold_in(key, 0) and one
//   under fold_in(key, 1) and combines them in u32 arithmetic as
//   (hi % span * (2^32 % span) + lo % span) % span;
// - a §12 partition program cuts a directed edge by part_down.
//
// Native u32 adds wrap and __funnelshift_l is the rotate, so none of the
// int32 tricks the torch twins need (masked arithmetic shifts, the
// unsigned-mod identity) appear here.

#pragma once

#include <cstdint>

namespace kt {

struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// One threefry2x32 block (20 rounds): key k, counter (c0, c1). Out of
// line: the fused kernel draws at ~170 sites a tick, and with the block
// inlined at each (~14k instructions) the warps of an SM, drifting apart
// over the ticks of a launch, stopped sharing instruction-cache lines — the
// in-kernel form's device time per tick grew from 0.35 ms at T=1 to 0.97 ms
// at T=8 (no snapshots, one H100, headline shape); with one copy it is
// 0.20-0.24 ms at every T (raft_kotlin_tpu_torch/kernel_ab.py).
__device__ __noinline__ Key block(Key k, uint32_t c0, uint32_t c1) {
  const uint32_t ks0 = k.k0, ks1 = k.k1, ks2 = k.k0 ^ k.k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + ks0, x1 = c1 + ks1;
#define KT_ROUND(r) x0 += x1; x1 = rotl(x1, r) ^ x0;
#define KT_EVEN KT_ROUND(13) KT_ROUND(15) KT_ROUND(26) KT_ROUND(6)
#define KT_ODD KT_ROUND(17) KT_ROUND(29) KT_ROUND(16) KT_ROUND(24)
  KT_EVEN x0 += ks1; x1 += ks2 + 1u;
  KT_ODD  x0 += ks2; x1 += ks0 + 2u;
  KT_EVEN x0 += ks0; x1 += ks1 + 3u;
  KT_ODD  x0 += ks1; x1 += ks2 + 4u;
  KT_EVEN x0 += ks2; x1 += ks0 + 5u;
#undef KT_ODD
#undef KT_EVEN
#undef KT_ROUND
  return {x0, x1};
}

__device__ __forceinline__ Key fold(Key k, uint32_t d) {
  return block(k, 0u, d);
}

__device__ __forceinline__ uint32_t bits32(Key k, uint32_t idx) {
  const Key b = block(k, 0u, idx);
  return b.k0 ^ b.k1;
}

__device__ __forceinline__ int bits23(Key k, uint32_t idx) {
  return static_cast<int>(bits32(k, idx) >> 9);
}

// randint's combination of the two u32 draws at flat index idx, from the
// already folded halves ka = fold_in(key, 0) and kb = fold_in(key, 1).
__device__ __forceinline__ int randint_folded(Key ka, Key kb, uint32_t idx,
                                              int lo, int span) {
  const uint32_t hb = bits32(ka, idx);
  const uint32_t lb = bits32(kb, idx);
  const uint32_t s = static_cast<uint32_t>(span);
  const uint32_t m = 65536u % s;
  const uint32_t mult = (m * m) % s;  // 2^32 mod span
  return lo + static_cast<int>(((hb % s) * mult + lb % s) % s);
}

// jax.random.randint(key, (), lo, lo + span) at flat index idx (span >= 1,
// span^2 < 2^31 as every config window is).
__device__ __forceinline__ int randint(Key k, uint32_t idx, int lo,
                                      int span) {
  return randint_folded(fold(k, 0u), fold(k, 1u), idx, lo, span);
}

// The counted per-node draw on [lo, hi]: fold the counter into the node's
// static-prefix key, then randint at lattice index 0.
__device__ __forceinline__ int draw_uniform(Key k, int ctr, int lo, int hi) {
  return randint(fold(k, static_cast<uint32_t>(ctr)), 0u, lo, hi - lo + 1);
}

// fold_in(fold_in(base, kind), tick): the key of one channel's tick.
__device__ __forceinline__ Key event_key(Key base, int kind, int tick) {
  return fold(fold(base, static_cast<uint32_t>(kind)),
              static_cast<uint32_t>(tick));
}

// The §10 delay channel of one tick, folded once: randint's two halves of
// fold_in(fold_in(base, KIND_DELAY), tick) (four blocks a tick), so that
// each pair's draw costs two.
constexpr int KIND_DELAY = 7;
struct DelayKey {
  Key a, b;
};

__device__ __forceinline__ DelayKey delay_key(Key base, int tick) {
  const Key k = event_key(base, KIND_DELAY, tick);
  return {fold(k, 0u), fold(k, 1u)};
}

// utils/rng.py::delay_mask element [g, s-1, r-1] — the delay of the exchange
// s sends r this tick, uniform on [lo, hi] — at pair_idx = g*N*N + (s-1)*N +
// (r-1), the pair lattice's index (not the node lattice's). lo == hi is the
// caller's constant, drawn nowhere.
__device__ __forceinline__ int delay_draw(const DelayKey& k, uint32_t pair_idx,
                                         int lo, int hi) {
  return randint_folded(k.a, k.b, pair_idx, lo, hi - lo + 1);
}

// utils/rng.py::scenario_link_down (kt_part_down) for one directed edge
// s -> r (1-based ids): whether the group's §12 partition program cuts it
// this tick. kind: 0 none, 1 split {1..cut} | {cut+1..N} (cross edges both
// ways), 2 the one edge src -> dst, 3 every edge touching a node that was a
// live leader at the tick's start (lead_s / lead_r); gated by the flapping
// window `active` = (tick + phase) % period < duty; a self-edge is never
// cut.
__device__ __forceinline__ bool part_down(int kind, int cut, int src,
                                          int dst, bool active, int s_id,
                                          int r_id, bool lead_s,
                                          bool lead_r) {
  if (!active || s_id == r_id) return false;
  switch (kind) {
    case 1: return (s_id <= cut) != (r_id <= cut);
    case 2: return s_id == src && r_id == dst;
    case 3: return lead_s || lead_r;
    default: return false;
  }
}

}  // namespace kt
