#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA tick kernel from the sources in this checkout;
3. kernel vs plain: at the headline shape (102,400 five-node groups, the
   fault soup of bench.py's BASELINE config), advanced 60 ticks, 20 more
   ticks step one copy through the kernel and one through the plain
   PyTorch phase lattice on the same card; every state field and el_dirty
   must be bit-equal each tick (tolerance 0: the state is all integers).
   These ticks also give the kernel's device time (CUDA events around a
   launch queued behind a spinning card) and its bound (the bytes the
   ticks' own data needs, over the memory bandwidth);
4. main path: make_run(headline, 200 ticks) through the normal entry point;
   exactly 200 kernel launches, leaders elected, commits advancing;
5. prefix parity: the plain version on the CPU for the first 2,048 groups
   must equal the first 2,048 columns of step 4's end state (every draw is
   keyed by the group index, never by the group count).

Any failed check raises, so the script exits non-zero; without a card it
exits non-zero before printing any result. The last line is one JSON object
naming the device.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import torch

from raft_kotlin_tpu_torch.constants import LEADER
from raft_kotlin_tpu_torch.models.state import (
    LOG_FIELDS, STATE_FIELDS, init_state)
from raft_kotlin_tpu_torch.ops import build, cuda_tick
from raft_kotlin_tpu_torch.ops import tick as tick_mod
from raft_kotlin_tpu_torch.utils.config import RaftConfig

# H100 SXM data-sheet peaks: HBM
# bandwidth, and the float32 rate outside the tensor cores, used here as
# the rate of the kernel's 32-bit integer ALU work.
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
GROUPS, WARM, CHECK, TICKS, PREFIX = 102_400, 60, 20, 200, 2_048
# Clock cycles the card spins before a timed kernel launch, so the launch
# is queued behind the start event and the event pair times the device only
# (~20 ms at the H100's clocks; the wrapper's host work takes under 1 ms).
PRIME_CYCLES = 40_000_000


def headline(groups: int) -> RaftConfig:
    return RaftConfig(n_groups=groups, n_nodes=5, log_capacity=32,
                      cmd_period=10, p_drop=0.25, p_crash=0.01,
                      p_restart=0.08, p_link_fail=0.02, p_link_heal=0.08,
                      seed=0).stressed(10)


def log(msg: str) -> None:
    print(msg, flush=True)


class Timer:
    """CUDA-event timing of one region; mean over its calls."""

    def __init__(self):
        self._pairs = []

    def __enter__(self):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        self._pairs.append((a, b))
        return self

    def __exit__(self, *exc):
        self._pairs[-1][1].record()

    def mean_ms(self) -> float:
        torch.cuda.synchronize()
        ts = [a.elapsed_time(b) for a, b in self._pairs]
        return sum(ts) / len(ts)


def max_abs_diff(a: dict, b: dict) -> int:
    return max(int((a[k].to(torch.int64) - b[k].to(torch.int64)).abs().max())
               for k in a)


def tick_bytes(cfg: RaftConfig, s: dict, aux: dict, flags, touched: dict):
    """Bytes one tick must move, each counted once: the non-log state read
    and written, the aux channels the kernel takes read, el_dirty written,
    and the log slots this tick's data needs (phase_body's `touched`)."""
    ops, _ = cuda_tick.kernel_operands(cfg, s, aux, flags)
    state = sum(s[k].nbytes for k in STATE_FIELDS if k not in LOG_FIELDS)
    aux_b = sum(t.nbytes for t in ops[len(STATE_FIELDS):] if t is not None)
    slots = (int(touched["log_term_read"].sum())
             + int(touched["log_cmd_read"].sum())
             + 2 * int(touched["log_written"].sum()))
    return 2 * state + aux_b + s["term"].numel() \
        + slots * s["log_term"].element_size()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"[device] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    build.load_tick_library(5)
    info = build.BUILD_INFO[("tick_kernel.cu", ("RAFT_N=5",))]
    log(f"[build] tick_kernel.cu in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {info['seconds']:.1f} s)")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    cfg = headline(GROUPS)
    N = cfg.n_nodes

    # -- 3. kernel vs plain on the card --------------------------------------
    ktick = cuda_tick.make_cuda_tick(cfg, dev)
    base, tkeys, bkeys = tick_mod.make_rng(cfg, dev)
    a = init_state(cfg, dev)
    for _ in range(WARM):
        ktick(a)
    b = a.clone()
    t_kernel, t_plain, t_prime = Timer(), Timer(), Timer()
    worst, moved, queue_ms = 0, 0, 0.0
    for _ in range(CHECK):
        aux, flags = tick_mod.make_aux(cfg, base, tkeys, bkeys, a)
        sa, sb = tick_mod.flatten_state(cfg, a), tick_mod.flatten_state(cfg, b)
        # The kernel's device time: the card spins while the host records
        # the start event and runs the wrapper, so the start event and the
        # launch reach the card back to back.
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        with t_prime:
            torch.cuda._sleep(PRIME_CYCLES)
        with t_kernel:
            da = cuda_tick.tick_kernel(cfg, sa, aux, flags)
        queue_ms = max(queue_ms, (time.perf_counter() - h0) * 1e3)
        # The tick's log traffic, counted untimed on a copy of the state.
        probe, touched = {k: v.clone() for k, v in sb.items()}, {}
        tick_mod.phase_body(cfg, probe, aux, flags, touched=touched)
        moved += tick_bytes(cfg, probe, aux, flags, touched)
        del probe
        with t_plain:
            db = tick_mod.phase_body(cfg, sb, aux, flags)
        err = max(max_abs_diff(sa, sb), max_abs_diff({"d": da}, {"d": db}))
        worst = max(worst, err)
        if err != 0:
            bad = [k for k in sa if not torch.equal(sa[k], sb[k])]
            raise AssertionError(f"kernel != plain at tick {a.tick}: "
                                 f"{bad or ['el_dirty']}")
        tick_mod.finish_tick(cfg, tkeys, a, sa, da)
        tick_mod.finish_tick(cfg, tkeys, b, sb, db)
    kernel_ms, prime_ms = t_kernel.mean_ms(), t_prime.mean_ms()
    if queue_ms >= 0.5 * prime_ms:
        raise AssertionError(f"the host took {queue_ms:.3f} ms to queue a "
                             f"timed launch, the card spun {prime_ms:.3f} ms")
    live = int(((a.role == LEADER) & a.up).any(0).sum())
    log(f"[kernel=plain] {CHECK} ticks from tick {WARM} at G={GROUPS}: "
        f"bit-equal (max_abs_err {worst}); groups with a live leader "
        f"{live}; kernel {kernel_ms:.4f} ms on the device, plain "
        f"{t_plain.mean_ms():.3f} ms per tick")

    # Least time for those ticks' work, the larger of: the bytes they must
    # move (tick_bytes, mean over the CHECK ticks) over the memory
    # bandwidth; and their integer operations over the ALU rate — an
    # over-count of ~80 per (owner, peer) pair (phases 3 and 5) and ~60 per
    # node, every exchange taken as live.
    moved /= CHECK
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = GROUPS * (80 * N * N + 60 * N) / ALU_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    log(f"[bound] {moved:.0f} B per tick ({moved / GROUPS:.1f} per group): "
        f"{bytes_ms:.4f} ms at {HBM_BYTES_PER_S / 1e12} TB/s; operations "
        f"{ops_ms:.4f} ms; kernel at {kernel_ms / bound_ms:.2f}x its bound")

    # -- 4. main path ---------------------------------------------------------
    run = tick_mod.make_run(cfg, TICKS, trace=False, device=dev)
    st0 = init_state(cfg, dev)
    torch.cuda.synchronize()
    cuda_tick.reset_launch_counts()
    t0 = time.perf_counter()
    end, ys = run(st0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = cuda_tick.LAUNCHES["tick_kernel"]
    if launches != TICKS:
        raise AssertionError(f"{launches} kernel launches in {TICKS} ticks")
    if tuple(ys.shape) != (TICKS, GROUPS) or end.tick != TICKS:
        raise AssertionError(f"bad run output {tuple(ys.shape)} / {end.tick}")
    leaders = int((end.role == LEADER).any(0).sum())
    max_commit = int(end.commit.max())
    if leaders <= 0 or max_commit <= 0:
        raise AssertionError(f"no progress: {leaders} groups with a leader, "
                             f"max commit {max_commit}")
    # Where a tick's time goes: the same three stages one by one on the
    # continuing run (these launches come after the count was read), host
    # clock around each synchronised stage — the draws are launch-bound, so
    # their cost is host time. The kernel call is the wrapper's checks and
    # launch plus the device time measured in step 3.
    host = {"make_aux_ms": [], "kernel_call_ms": [], "materialize_el_ms": []}
    cont = end.clone()
    for _ in range(CHECK):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aux, flags = tick_mod.make_aux(cfg, base, tkeys, bkeys, cont)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        s = tick_mod.flatten_state(cfg, cont)
        d = cuda_tick.tick_kernel(cfg, s, aux, flags)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        tick_mod.finish_tick(cfg, tkeys, cont, s, d)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, dt_k in zip(host, (t1 - t0, t2 - t1, t3 - t2)):
            host[k].append(dt_k * 1e3)
    split = {k: sum(v) / len(v) for k, v in host.items()}
    split["kernel_device_ms"] = kernel_ms
    log("[main path] " + json.dumps({
        "ticks": TICKS, "groups": GROUPS, "elapsed_s": dt,
        "group_steps_per_sec": GROUPS * TICKS / dt,
        "ms_per_tick": dt * 1e3 / TICKS, "kernel_launches": launches,
        "groups_with_leader": leaders, "max_commit": max_commit,
        "elections_started": int(end.rounds.to(torch.int64).sum()),
        **split, "kernel_bound_ms": bound_ms, "kernel_bytes": moved,
        "kernel_ops_ms": ops_ms}))

    # -- 5. CPU prefix parity -------------------------------------------------
    pcfg = dataclasses.replace(cfg, n_groups=PREFIX)
    t0 = time.perf_counter()
    pend, _ = tick_mod.make_run(pcfg, TICKS, trace=False, impl="plain",
                                device="cpu")(init_state(pcfg, "cpu"))
    bad = [k for k in STATE_FIELDS
           if not torch.equal(getattr(pend, k),
                              getattr(end, k)[..., :PREFIX].cpu())]
    if bad:
        raise AssertionError(f"CPU prefix differs from the card run: {bad}")
    log(f"[prefix] plain CPU run of the first {PREFIX} groups over {TICKS} "
        f"ticks equals the card's columns ({time.perf_counter() - t0:.1f} s)")

    log(json.dumps({"kernels": [{
        "name": "tick_kernel", "route": "cuda",
        "source": "raft_kotlin_tpu_torch/ops/csrc/tick_kernel.cu",
        "replaces": "raft_kotlin_tpu/ops/pallas_tick.py:724",
        "launches": launches, "max_abs_err": worst,
        "ms": kernel_ms, "plain_ms": t_plain.mean_ms(),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
