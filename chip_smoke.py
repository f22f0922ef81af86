#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

At the headline shape (102,400 five-node groups, the fault soup of
bench.py's BASELINE config), then with its §10 mailbox, as the §12 fuzz
farm's 102,400 three-node universes and at BASELINE config 5, every check
at tolerance 0 (the state is all integers):

1. device: the card's name and power limit (nvidia-smi);
2. build: every CUDA kernel from the sources in this checkout (the tick
   kernels for five- and three-node groups), one nvcc per source and node
   count, started together;
3. tick kernel vs plain: from tick 60, 20 ticks step one copy through the
   one-tick kernel and one through the plain PyTorch phase lattice; every
   state field and el_dirty bit-equal each tick. Also the kernel's device
   time (CUDA events around a launch queued behind a spinning card) and its
   bound (the bytes the ticks' own data needs);
4. fused kernel vs plain: from there, 2 launches of T=4 ticks in each aux
   form (staged draws, in-kernel draws) through the fused kernel and
   through its plain version; state, overflow counts and every snapshot of
   the headline observers bit-equal; device time and bound as in 3;
5. main path: make_cuda_scan(headline, 200 ticks, T=4, in-kernel draws,
   flight recorder + safety monitor) — exactly 50 fused launches, no host
   draw (make_aux / materialize_el), no overflow, leaders elected and
   commits advancing, and a clean monitor or one whose first violation
   the plain version reproduces on the CPU (this soup latches one, as the
   JAX package's monitor does too); the same run with the observers off;
   the stage split of the path;
6. cross-path identity over 203 ticks (so a remainder runs): in-kernel T=4,
   staged T=4 and staged T=1 runners bit-equal in end state, recorder and
   monitor, and the one-tick make_run (the earlier main path, its launches
   counted) equal in end state and recorder; that path's stage split;
7. prefix parity: the plain versions on the CPU for the first 2,048 groups
   equal the card's columns of step 5's and step 6's end states (every
   draw is keyed by the group index, never by the group count);
8. ms/tick of the main path at T in {1, 2, 4, 8}, observers off (a
   measurement only);
9. the deep path, BASELINE config 5 (`deep_config()`: 102,400 seven-node
   groups, 10,000-entry int16 logs — 28.7 GB on the card), once steps 3-8
   have freed their tensors:
   (b) the main deep run: ops/tick.make_run(telemetry=True), 30 warm-up
       plus 30 timed ticks (bench.py's deep stage times 30) — exactly one
       deep-gather and one deep-scatter launch a tick, no plain read or
       write on the card, leaders elected and commits advancing; ms/tick,
       group-steps/s and the stage split (make_aux, lattice, gather,
       scatter, materialize_el);
   (a) kernels vs plain: from that state, 4 ticks through the two kernels
       and through their plain versions on a second copy — every state
       field, el_dirty and the gather's outputs bit-equal each tick; each
       kernel's device time, the plain version's, the library call's
       (#6: torch.gather on the (N, C, G) views, timed as the kernel is;
       #5 has none), and the bound from the bytes the function needs: the
       rows, the values it writes or the kept writes' value sectors, and
       the distinct log sectors its rows address;
   (c) prefix parity: the plain version on the CPU and the kernels on the
       card, each over the first 256 groups, equal the card's columns of
       (b)'s end state, and their recorders are equal;
   (d) the card's busy time over 2 more ticks of the main path from a
       torch.profiler trace, and so its idle share (last: profiling
       slows the host-bound work after it);
10. the §10 mailbox at headline scale, bench.py's stage 4b
   (`mailbox_config()`: the headline soup with 1-3-tick delivery delays,
   seed 5, and 13 slot planes on the card), run after step 8 and
   before step 9:
   (a) kernels vs plain, as in 3 and 4: the one-tick kernel over 20 ticks
       from tick 60, the fused kernel over 2 launches of T=4 in each aux
       form — state with every slot, el_dirty, overflow counts and
       snapshots bit-equal; device times and bounds counting the slot
       bytes the ticks touch; and the in-kernel delay draw (kt_rng.cuh's
       delay_draw) alone over a tick's pair lattice, held to the staged
       draw of ops/tick.make_aux;
   (b) the main path: make_cuda_scan(200 ticks, T=4, in-kernel draws,
       observers on, then off) — exactly 50 fused launches, each drawing
       its delays in the kernel, no host draw, no overflow, leaders and
       commits, slots in flight, and a clean monitor or a first violation
       the plain version reproduces on the CPU; ms/tick, group-steps/s;
   (c) cross-path: staged T=4, staged T=1 and make_run bit-equal to (b)
       in end state and recorder (the scans in monitor too);
   (d) prefix parity: the plain version on the CPU over the first 2,048
       groups equals the card's columns of (b);
11. the §12 scenario-bank fuzz farm at api/fuzz.smoke_config(102400) (the
   JAX farm's smoke family: three-node universes, 32-entry logs, per-
   universe fault thresholds and split / asym / leader partition
   programs), run after step 10 and before step 9:
   (a) kernels vs plain: the one-tick kernel with the bank's masks drawn
       on the host, 20 ticks from tick 60; the fused kernel with in-kernel
       draws through the bank's rows, 2 launches of T=4, at the smoke
       config and at its mailbox regime (1-4-tick delays in per-universe
       windows, scripts/fuzz_farm.py --delay 1 4); device times and bounds;
   (b) the farm end to end: api/fuzz.make_batch_runner over 200 ticks —
       exactly 50 fused launches, each reading the bank's rows, no host
       draw, coverage (fault, election, taint and partition universes);
       fuzz_farm over the same universes: one artifact exactly when the
       batch latched, confirmed by its replay on the card, the batch's
       latch reproduced by the plain version on the CPU; the staged runner
       (one tick a launch: leader programs) equal to the batch; ms/tick,
       universe-ticks/s, the per-launch split;
   (c) prefix parity: the plain farm batch on the CPU over the first 2,048
       universes equals the card's columns (end state, per-group monitor
       counters, taint masks);
   (d) seeded mutation at 102,400 universes (tests/test_fuzz.py's
       committed rewrite at tick 70, on a group >= 50,000 picked from an
       unmutated run): the farm latches at exactly (70, group), shrinks to
       horizon 71 and no fault channel, its artifact replays and a
       perturbed one (tick 71) does not;
   (e) the mailbox regime's batch over 100 ticks with (b)'s gates but the
       corpus.

Any failed check raises, so the script exits non-zero; without a card it
exits non-zero before printing any result. The line before the card's
name lists every kernel with its numbers; the last line is one JSON object
naming the device.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time

import torch

from raft_kotlin_tpu_torch.api import fuzz
from raft_kotlin_tpu_torch.constants import LEADER
from raft_kotlin_tpu_torch.models.state import (
    LOG_FIELDS, MAILBOX_FIELDS, STATE_FIELDS, field_dtype, init_state)
from raft_kotlin_tpu_torch.ops import (
    build, cuda_scan, cuda_tick, deep_gather, deep_scatter)
from raft_kotlin_tpu_torch.ops import tick as tick_mod
from raft_kotlin_tpu_torch.utils import telemetry as telemetry_mod
from raft_kotlin_tpu_torch.utils import rng as rngmod
from raft_kotlin_tpu_torch.utils.config import (
    RaftConfig, ScenarioSpec, config_from_dict, deep_config, headline_config,
    mailbox_config)
from raft_kotlin_tpu_torch.utils.timing import DeviceTimer, Timer, sync

# H100 SXM peaks. HBM bandwidth: NVIDIA's data sheet. 32-bit integer ALU
# rate: NVIDIA's H100 Tensor Core GPU Architecture white paper gives each
# Hopper SM 64 INT32 lanes (16 per SM sub-partition, one operation each per
# clock), so 132 SMs x 64 x 1.98 GHz (the SXM5 boost clock) = 16.7e12/s.
# (The 67e12 float32 rate counts an FMA as two operations on 128 lanes per
# SM; integer work issues on half the lanes, one operation each.)
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 132 * 64 * 1.98e9
# u32 operations of one threefry2x32 block: 20 rounds of add, rotate (one
# funnel shift) and xor, 5 key injections of 3 adds, the key schedule's 2
# xors and the 2 counter adds.
THREEFRY_OPS = 20 * 3 + 5 * 3 + 2 + 2
GROUPS, WARM, CHECK, TICKS, PREFIX = 102_400, 60, 20, 200, 2_048
FUSED_T, FUSED_LAUNCHES, CROSS_TICKS, SPLIT_LAUNCHES = 4, 2, 203, 10
SWEEP_T, SWEEP_TICKS = (1, 2, 4, 8), 80
# Step 11, the farm: the mailbox leg's ticks; the seeded mutation's tick,
# the lowest group it may pick and its farm's horizon (tests/test_fuzz.py's
# mutation, at the card's scale).
MAIL_TICKS, MUT_TICK, MUT_MIN_GROUP, MUT_HORIZON = 100, 70, 50_000, 90
# Step 9, the deep path: warm-up and timed ticks of the main run (bench.py's
# deep stage times 30), kernel-vs-plain ticks, stage-split ticks, and the
# groups of the CPU prefix run.
DEEP_WARM, DEEP_TICKS, DEEP_CHECK, DEEP_SPLIT, DEEP_PREFIX = 30, 30, 4, 5, 256
# Ticks of the main deep path traced with torch.profiler for the card's
# busy time.
DEEP_PROFILE = 2
# Integer operations per element a deep kernel computes (address and
# bounds arithmetic) — an over-count; both kernels are bound by bytes.
DEEP_OPS_PER_ELEMENT = 12
SOURCES = "raft_kotlin_tpu_torch/ops/csrc/"


def log(msg: str) -> None:
    print(msg, flush=True)


def field_err(x: torch.Tensor, y: torch.Tensor) -> int:
    """max |x - y| over two same-shape integer tensors, in row chunks (a
    config-5 log is 14.3 GB; widening it whole would not fit)."""
    if torch.equal(x, y):
        return 0
    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               for a, b in zip(x.split(4096), y.split(4096)))


def max_abs_diff(a: dict, b: dict) -> int:
    return max(field_err(a[k], b[k]) for k in a)


def states_differ(a, b) -> list:
    return [k for k in a.fields()
            if not torch.equal(getattr(a, k), getattr(b, k))]


def body_ops(cfg: RaftConfig, groups: int, ticks: int) -> int:
    """The lattice's integer operations: an over-count of ~80 per (owner,
    peer) pair (phases 3 and 5) and ~60 per node a tick, every exchange
    taken as live."""
    N = cfg.n_nodes
    return groups * ticks * (80 * N * N + 60 * N)


def bound(nbytes: float, ops: float) -> tuple:
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the 32-bit integer rate."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ALU_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                          "operations")


def mail_bytes(cfg: RaftConfig, G: int, mail) -> int:
    """The §10 slot bytes a tick (or a fused launch) needs: both due planes
    read and written once, and the payload of each delivery it reads and of
    each send it writes (`mail`: phase_body's counts; None without the
    mailbox)."""
    if not mail:
        return 0
    N = cfg.n_nodes

    def payload(prefix):
        return sum(field_dtype(k, cfg).itemsize for k in MAILBOX_FIELDS
                   if k.startswith(prefix) and not k.endswith("_due"))
    return 2 * 2 * N * N * G * field_dtype("vq_due", cfg).itemsize \
        + payload("vq_") * (mail["vote_read"] + mail["vote_sent"]) \
        + payload("aq_") * (mail["append_read"] + mail["append_sent"])


def tick_bytes(cfg: RaftConfig, s: dict, aux: dict, flags, touched: dict):
    """Bytes one tick must move, each counted once: the non-log state read
    and written, the aux channels the kernel takes read, el_dirty written,
    the log slots this tick's data needs (phase_body's `touched`) and, under
    the mailbox, the slot bytes (mail_bytes)."""
    ops, _ = cuda_tick.kernel_operands(cfg, s, aux, flags)
    state = sum(s[k].nbytes for k in STATE_FIELDS if k not in LOG_FIELDS)
    aux_b = sum(t.nbytes for t in ops[len(STATE_FIELDS) + len(MAILBOX_FIELDS):]
                if t is not None)
    slots = (int(touched["log_term_read"].sum())
             + int(touched["log_cmd_read"].sum())
             + 2 * int(touched["log_written"].sum()))
    return 2 * state + aux_b + s["term"].numel() \
        + slots * s["log_term"].element_size() \
        + mail_bytes(cfg, s["term"].shape[-1], touched.get("mail"))


def fused_bytes(cfg: RaftConfig, s: dict, ops: dict, snaps: dict,
                work: dict) -> int:
    """Bytes one fused launch must move, each counted once: the non-log
    state read and written once, the overflow counts and the snapshots
    written; of the launch operands, the in-kernel key planes whole, and of
    the staged slabs and draw tables only the entries the launch's ticks use
    (`work["staged_reads"]`: an edge where the link and both ends are up, a
    heal draw for a failed link, one table entry per draw, ...); of the
    logs, all of both read when the snapshots copy them (else the slots the
    launch reads), plus the slots it writes; the mailbox's slot bytes
    (mail_bytes)."""
    N = cfg.n_nodes
    G = s["term"].shape[-1]
    state = sum(s[k].nbytes for k in STATE_FIELDS if k not in LOG_FIELDS)
    elt = s["log_term"].element_size()
    if "log_term" in snaps:
        logs = s["log_term"].nbytes + s["log_cmd"].nbytes
    else:
        logs = int(work["log_read"].sum()) * elt
    logs += 2 * int(work["log_written"].sum()) * elt
    if "el_table" in ops:
        operands = sum(n * ops[k].element_size()
                       for k, n in work["staged_reads"].items())
    else:
        operands = sum(t.nbytes for t in ops.values())
    return 2 * state + logs + operands + N * G * 4 \
        + sum(t.nbytes for t in snaps.values()) \
        + mail_bytes(cfg, G, work.get("mail"))


def launch_ops(cfg, aux_source, s, tick0, T, rng, stat) -> dict:
    base, tkeys, bkeys, scen = tick_mod.split_rng(rng)
    if aux_source == "inkernel":
        return cuda_tick.inkernel_aux_operands(stat, tick0)
    return cuda_tick.staged_operands(cfg, base, tkeys, bkeys, tick0, s, T,
                                    scen=scen)


def check_fused(cfg, warm, aux_source, rng, stat, snap) -> dict:
    """FUSED_LAUNCHES launches of FUSED_T ticks from `warm` through the
    fused kernel and through its plain version on the card: everything
    bit-equal; the kernel's device time, the plain version's time, and the
    launches' bound from their own data."""
    flags = tick_mod.make_flags(cfg)
    # A kernel's first launch loads its module, which waits for the card:
    # launch this form once, untimed, on a copy.
    w = tick_mod.flatten_state(cfg, warm.clone())
    cuda_tick.fused_tick_kernel(cfg, w, FUSED_T, flags, aux_source, launch_ops(
        cfg, aux_source, w, warm.tick, FUSED_T, rng, stat), snap)
    del w
    a, b = warm.clone(), warm.clone()
    dt, t_plain = DeviceTimer(), Timer()
    worst, moved, ops_n = 0, 0, 0
    for i in range(FUSED_LAUNCHES):
        sa, sb = tick_mod.flatten_state(cfg, a), tick_mod.flatten_state(cfg, b)
        ops = launch_ops(cfg, aux_source, sa, a.tick, FUSED_T, rng, stat)
        # What the launch's data needs, counted untimed on a copy.
        probe, work = {k: v.clone() for k, v in sb.items()}, {}
        _, psnaps = cuda_tick.fused_tick_plain(cfg, probe, FUSED_T, flags,
                                               aux_source, ops, snap,
                                               work=work)
        moved += fused_bytes(cfg, sb, ops, psnaps, work)
        ops_n += body_ops(cfg, GROUPS, FUSED_T) + (
            work["blocks"] * THREEFRY_OPS if aux_source == "inkernel" else 0)
        del probe, psnaps
        ova, snapa = dt.run(lambda: cuda_tick.fused_tick_kernel(
            cfg, sa, FUSED_T, flags, aux_source, ops, snap))
        with t_plain:
            ovb, snapb = cuda_tick.fused_tick_plain(cfg, sb, FUSED_T, flags,
                                                    aux_source, ops, snap)
        err = max(max_abs_diff(sa, sb), max_abs_diff({"ov": ova}, {"ov": ovb}),
                  max_abs_diff(snapa, snapb))
        worst = max(worst, err)
        if err != 0:
            bad = [k for k in sa if not torch.equal(sa[k], sb[k])] + [
                f"snapshot {k}" for k in snapa
                if not torch.equal(snapa[k], snapb[k])]
            raise AssertionError(f"fused kernel ({aux_source}) != plain at "
                                 f"launch {i}: {bad or ['overflow']}")
        if int(ova.sum()) != 0:
            raise AssertionError(f"fused kernel ({aux_source}): draw-table "
                                 f"overflow at launch {i}")
        a.tick += FUSED_T
        b.tick += FUSED_T
    bound_ms, bound_by = bound(moved / FUSED_LAUNCHES, ops_n / FUSED_LAUNCHES)
    return {"ms": dt.mean_ms(), "plain_ms": t_plain.mean_ms(),
            "max_abs_err": worst, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": moved / FUSED_LAUNCHES, "ops": ops_n / FUSED_LAUNCHES,
            "bytes_ms": moved / FUSED_LAUNCHES / HBM_BYTES_PER_S * 1e3,
            "ops_ms": ops_n / FUSED_LAUNCHES / ALU_OPS_PER_S * 1e3}


def check_tick(cfg: RaftConfig, rng, dev) -> tuple:
    """WARM ticks through the one-tick kernel from boot, then CHECK ticks
    stepping one copy through the kernel and one through the plain phase
    lattice: every state field and el_dirty bit-equal each tick; the
    kernel's device time, the plain version's time and the bound from the
    ticks' own data. Returns (the kernel's entry, the kernel's state)."""
    base, tkeys, bkeys, scen = tick_mod.split_rng(rng)
    ktick = cuda_tick.make_cuda_tick(cfg, dev)
    a = init_state(cfg, dev)
    for _ in range(WARM):
        ktick(a)
    b = a.clone()
    dt1, t_plain = DeviceTimer(), Timer()
    worst, moved = 0, 0
    for _ in range(CHECK):
        aux, flags = tick_mod.make_aux(cfg, base, tkeys, bkeys, a, scen=scen)
        sa, sb = tick_mod.flatten_state(cfg, a), tick_mod.flatten_state(cfg, b)
        da = dt1.run(lambda: cuda_tick.tick_kernel(cfg, sa, aux, flags))
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
    kernel_ms = dt1.mean_ms()
    bound1, by1 = bound(moved / CHECK, body_ops(cfg, GROUPS, 1))
    what = ", ".join(w for w, on in (
        ("mailbox", cfg.uses_mailbox),
        ("scenario bank", cfg.scenario is not None)) if on)
    log(f"[kernel=plain] tick_kernel, {CHECK} ticks from tick {WARM} at "
        f"G={GROUPS}{f' ({what})' if what else ''}: bit-equal "
        f"(max_abs_err {worst}); kernel {kernel_ms:.4f} ms on the device, "
        f"plain {t_plain.mean_ms():.3f} ms; bound {bound1:.4f} ms ({by1}: "
        f"{moved / CHECK:.0f} B, {body_ops(cfg, GROUPS, 1):.3g} ops)")
    return {"source": "tick_kernel.cu",
            "replaces": "raft_kotlin_tpu/ops/pallas_tick.py:724",
            "max_abs_err": worst, "ms": kernel_ms,
            "plain_ms": t_plain.mean_ms(), "bound_ms": bound1,
            "bound_by": by1}, a


def check_latch(cfg: RaftConfig, summary: dict) -> float:
    """The monitor must be clean, or its first violation must be the plain
    version's: the plain runner on the CPU over the groups up to the
    latched one (draws are keyed by the group index) and the ticks up to
    the latched tick must latch the same (tick, group, invariant). Returns
    the seconds that check took (0 for a clean monitor)."""
    latch = summary["latch"]
    if latch is None:
        return 0.0
    t0 = time.perf_counter()
    sub = dataclasses.replace(cfg, n_groups=latch["group"] + 1)
    run = cuda_scan.make_cuda_scan(sub, latch["tick"] + 1, fused_ticks=1,
                                   aux_source="inkernel", monitor=True,
                                   device="cpu")
    _, mon = run(init_state(sub, "cpu"))
    plain = telemetry_mod.summarize_monitor(mon)["inv_status"]
    if plain != summary["inv_status"]:
        raise AssertionError(f"monitor: the card latched "
                             f"{summary['inv_status']}, the plain version "
                             f"{plain}")
    return time.perf_counter() - t0


def counted(fn):
    """Run fn with every launch, host-draw and plain-on-card count set to 0
    just before; returns (fn's result, seconds, kernel launch counts, host
    calls: the draws and the deep path's plain read / write on the card)."""
    sync()
    cuda_tick.reset_launch_counts()
    deep_gather.reset_counts()
    deep_scatter.reset_counts()
    tick_mod.reset_call_counts()
    t0 = time.perf_counter()
    out = fn()
    sync()
    launches = {**cuda_tick.LAUNCHES, **deep_gather.LAUNCHES,
                **deep_scatter.LAUNCHES}
    calls = {**tick_mod.CALLS,
             "gather_plain_on_card": deep_gather.PLAIN_ON_CUDA["deep_gather"],
             "scatter_plain_on_card":
                 deep_scatter.PLAIN_ON_CUDA["deep_scatter"]}
    return out, time.perf_counter() - t0, launches, calls


def expect(name, got: dict, want: dict) -> None:
    """Every count in `got` is `want`'s, 0 where `want` names none."""
    full = {k: want.get(k, 0) for k in got}
    if set(want) - set(got) or got != full:
        raise AssertionError(f"{name}: counts {got}, expected {full}")


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
    # The tick kernels for the headline's five-node groups and the farm's
    # three-node universes, and the deep kernels: one nvcc each, together.
    t0 = time.perf_counter()
    jobs = build.build_jobs(5) + [job for job in build.build_jobs(3)
                                  if job not in build.build_jobs(5)]
    build.build_many(jobs)
    log(f"[build] {', '.join(f'{src} {d}' for src, d in jobs)} in "
        f"{time.perf_counter() - t0:.1f} s (in parallel)")
    for job in jobs:
        info = build.BUILD_INFO[job]
        log(f"[build] {job[0]} {job[1]}: nvcc {info['seconds']:.1f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "entry" in line:
                log(f"[build]   {line.strip()}")

    kernels = headline_steps(dev)
    kernels.update(mailbox_steps(dev))
    gc.collect()
    torch.cuda.empty_cache()
    kernels.update(farm_steps(dev))
    # The earlier steps' tensors are gone; hand their cached blocks back
    # before the deep path's two 14.3 GB logs (and, in 9a, a second copy).
    gc.collect()
    torch.cuda.empty_cache()
    kernels.update(deep_steps(dev))

    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES + k["source"],
         "replaces": k["replaces"], "launches": k["launches"],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
         "bound_by": k["bound_by"], "library_ms": k.get("library_ms")}
        for name, k in kernels.items()]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def headline_steps(dev) -> dict:
    """Steps 3-8 at the headline shape; returns the kernels' entries."""
    cfg = headline_config(GROUPS)
    N = cfg.n_nodes
    rng = tick_mod.make_rng(cfg, dev)
    base, tkeys, bkeys = rng
    kernels = {}

    # -- 3. tick kernel vs plain on the card --------------------------------
    kernels["tick_kernel"], a = check_tick(cfg, rng, dev)

    # -- 4. fused kernel vs plain, both aux forms ----------------------------
    snap = cuda_tick.fused_snapshot_fields(cfg, telemetry=True, monitor=True)
    stat = cuda_tick.inkernel_aux_statics(cfg, base, tkeys, bkeys)
    for aux_source in ("staged", "inkernel"):
        r = check_fused(cfg, a, aux_source, rng, stat, snap)
        kernels[f"fused_tick_kernel[{aux_source}]"] = {
            "source": "fused_tick_kernel.cu",
            "replaces": "raft_kotlin_tpu/ops/pallas_tick.py:999",
            **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by")}}
        log(f"[fused=plain] {aux_source}: {FUSED_LAUNCHES} launches of T="
            f"{FUSED_T} from tick {a.tick}, snapshots {list(snap)}: bit-equal "
            f"(max_abs_err {r['max_abs_err']}), overflow 0; " + json.dumps({
                k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "bytes", "bytes_ms", "ops", "ops_ms")}))

    # -- 5. main path ---------------------------------------------------------
    main_run = cuda_scan.make_cuda_scan(
        cfg, TICKS, fused_ticks=FUSED_T, aux_source="inkernel",
        telemetry=True, monitor=True, device=dev)
    (end, tel, mon), dt_main, launches, calls = counted(
        lambda: main_run(init_state(cfg, dev)))
    main_launches = launches["fused_tick_kernel"]
    expect("main path launches", launches,
           {"tick_kernel": 0, "fused_tick_kernel": TICKS // FUSED_T})
    expect("main path host draws", calls, {"make_aux": 0,
                                           "materialize_el": 0})
    summary = telemetry_mod.summarize_monitor(mon)
    leaders = int(((end.role == LEADER) & end.up).any(0).sum())
    max_commit = int(end.commit.max())
    latch_check_s = check_latch(cfg, summary)
    if end.tick != TICKS or leaders <= 0 or max_commit <= 0 \
            or int(tel["commit_advances"]) <= 0:
        raise AssertionError(f"no progress: tick {end.tick}, {leaders} "
                             f"groups with a live leader, max commit "
                             f"{max_commit}")
    off_run = cuda_scan.make_cuda_scan(cfg, TICKS, fused_ticks=FUSED_T,
                                       aux_source="inkernel", device=dev)
    _, dt_off, launches_off, _ = counted(
        lambda: off_run(init_state(cfg, dev)))
    expect("observers-off launches", launches_off,
           {"tick_kernel": 0, "fused_tick_kernel": TICKS // FUSED_T})
    # Where a launch's time goes, stage by stage on the continuing state,
    # each stage synchronised and timed by host clock (these launches come
    # after the counts were read).
    cont = end.clone()
    s = tick_mod.flatten_state(cfg, cont)
    flags = tick_mod.make_flags(cfg)
    prev = {k: s[k].clone() for k in snap}
    tel_c = telemetry_mod.telemetry_zeros(dev)
    mon_c = telemetry_mod.monitor_init(GROUPS, SPLIT_LAUNCHES * FUSED_T,
                                       device=dev)
    stages = {"operands_ms": [], "kernel_call_ms": [], "observers_ms": []}
    for _ in range(SPLIT_LAUNCHES):
        sync()
        h = [time.perf_counter()]
        ops = cuda_tick.inkernel_aux_operands(stat, cont.tick)
        sync()
        h.append(time.perf_counter())
        _, snaps = cuda_tick.fused_tick_kernel(cfg, s, FUSED_T, flags,
                                               "inkernel", ops, snap)
        sync()
        h.append(time.perf_counter())
        ticks = cuda_tick.unpack_fused_outputs(snaps, FUSED_T)
        tel_c, mon_c = cuda_tick.fused_observe(cfg, prev, ticks, tel_c, mon_c)
        prev = ticks[-1]
        sync()
        h.append(time.perf_counter())
        cont.tick += FUSED_T
        for k, x, y in zip(stages, h, h[1:]):
            stages[k].append((y - x) * 1e3)
    split = {k: sum(v) / len(v) for k, v in stages.items()}
    split["kernel_device_ms"] = kernels["fused_tick_kernel[inkernel]"]["ms"]
    log("[main path] " + json.dumps({
        "runner": "make_cuda_scan", "ticks": TICKS, "groups": GROUPS,
        "fused_ticks": FUSED_T, "aux_source": "inkernel",
        "elapsed_s": dt_main, "ms_per_tick": dt_main * 1e3 / TICKS,
        "group_steps_per_sec": GROUPS * TICKS / dt_main,
        "observers_off_ms_per_tick": dt_off * 1e3 / TICKS,
        "observers_off_group_steps_per_sec": GROUPS * TICKS / dt_off,
        "fused_launches": main_launches, "tick_kernel_launches": 0,
        "make_aux_calls": calls["make_aux"],
        "materialize_el_calls": calls["materialize_el"],
        "inv_status": summary["inv_status"],
        "inv_violations": summary["violations"],
        "latch_reproduced_by_plain_cpu_s": latch_check_s,
        "groups_with_live_leader": leaders, "max_commit": max_commit,
        "commit_advances": int(tel["commit_advances"]),
        "per_launch_split": split,
        "snapshot_bytes_per_launch": sum(
            GROUPS * FUSED_T * (N * cfg.phys_capacity if k in LOG_FIELDS
                                else N * N if k in ("responded", "next_index",
                                                    "match_index", "link_up")
                                else N)
            * cuda_tick.snapshot_dtype(cfg, k).itemsize for k in snap)}))

    # -- 6. cross-path identity over 203 ticks -------------------------------
    legs = {}
    for name, aux_source, T in (("inkernel_T4", "inkernel", FUSED_T),
                                ("staged_T4", "staged", FUSED_T),
                                ("staged_T1", "staged", 1)):
        run = cuda_scan.make_cuda_scan(cfg, CROSS_TICKS, fused_ticks=T,
                                       aux_source=aux_source, telemetry=True,
                                       monitor=True, device=dev)
        legs[name] = counted(lambda: run(init_state(cfg, dev)))
    rem = CROSS_TICKS % FUSED_T
    full = CROSS_TICKS // FUSED_T
    expect("inkernel_T4 launches", legs["inkernel_T4"][2],
           {"tick_kernel": 0, "fused_tick_kernel": full + rem})
    expect("inkernel_T4 host draws", legs["inkernel_T4"][3],
           {"make_aux": 0, "materialize_el": 0})
    expect("staged_T4 launches", legs["staged_T4"][2],
           {"tick_kernel": rem, "fused_tick_kernel": full})
    expect("staged_T1 launches", legs["staged_T1"][2],
           {"tick_kernel": CROSS_TICKS, "fused_tick_kernel": 0})
    ref_end, ref_tel, ref_mon = legs["inkernel_T4"][0]
    for name in ("staged_T4", "staged_T1"):
        e, tl, mn = legs[name][0]
        bad = states_differ(e, ref_end) + [
            f"recorder {k}" for k in tl if int(tl[k]) != int(ref_tel[k])] + [
            f"monitor {k}" for k in mn if not torch.equal(mn[k], ref_mon[k])]
        if bad:
            raise AssertionError(f"{name} != inkernel_T4: {bad}")
    # The earlier main path: make_run through the one-tick kernel.
    mrun = tick_mod.make_run(cfg, CROSS_TICKS, trace=False, telemetry=True,
                             device=dev)
    (r_end, _, r_tel), dt_r, launches_r, _ = counted(
        lambda: mrun(init_state(cfg, dev)))
    expect("make_run launches", launches_r,
           {"tick_kernel": CROSS_TICKS, "fused_tick_kernel": 0})
    bad = states_differ(r_end, ref_end) + [
        f"recorder {k}" for k in r_tel if int(r_tel[k]) != int(ref_tel[k])]
    if bad:
        raise AssertionError(f"make_run != inkernel_T4: {bad}")
    kernels["tick_kernel"]["launches"] = launches_r["tick_kernel"]
    kernels["fused_tick_kernel[staged]"]["launches"] = \
        legs["staged_T4"][2]["fused_tick_kernel"]
    kernels["fused_tick_kernel[inkernel]"]["launches"] = main_launches
    # The one-tick path's stage split, on its continuing state.
    host = {"make_aux_ms": [], "kernel_call_ms": [], "materialize_el_ms": []}
    cont = r_end.clone()
    for _ in range(CHECK):
        sync()
        h = [time.perf_counter()]
        aux, fl = tick_mod.make_aux(cfg, base, tkeys, bkeys, cont)
        sync()
        h.append(time.perf_counter())
        s = tick_mod.flatten_state(cfg, cont)
        d = cuda_tick.tick_kernel(cfg, s, aux, fl)
        sync()
        h.append(time.perf_counter())
        tick_mod.finish_tick(cfg, tkeys, cont, s, d)
        sync()
        h.append(time.perf_counter())
        for k, x, y in zip(host, h, h[1:]):
            host[k].append((y - x) * 1e3)
    log("[cross-path] " + json.dumps({
        "ticks": CROSS_TICKS,
        "equal": ["inkernel_T4", "staged_T4", "staged_T1", "make_run"],
        "ms_per_tick": {**{k: v[1] * 1e3 / CROSS_TICKS
                           for k, v in legs.items()},
                        "make_run": dt_r * 1e3 / CROSS_TICKS},
        "launches": {**{k: v[2] for k, v in legs.items()},
                     "make_run": launches_r},
        "host_draw_calls": {k: v[3] for k, v in legs.items()},
        "make_run_split": {k: sum(v) / len(v) for k, v in host.items()},
        "inv_status": telemetry_mod.summarize_monitor(ref_mon)["inv_status"]}))

    # -- 7. CPU prefix parity -------------------------------------------------
    pcfg = dataclasses.replace(cfg, n_groups=PREFIX)
    for name, ticks, card_end, runner in (
            ("make_cuda_scan", TICKS, end, cuda_scan.make_cuda_scan(
                pcfg, TICKS, fused_ticks=FUSED_T, aux_source="inkernel",
                device="cpu")),
            ("make_run", CROSS_TICKS, r_end, lambda st: tick_mod.make_run(
                pcfg, CROSS_TICKS, trace=False, impl="plain",
                device="cpu")(st)[0])):
        t0 = time.perf_counter()
        pend = runner(init_state(pcfg, "cpu"))
        bad = [k for k in STATE_FIELDS
               if not torch.equal(getattr(pend, k),
                                  getattr(card_end, k)[..., :PREFIX].cpu())]
        if bad:
            raise AssertionError(f"{name}: CPU prefix differs from the card "
                                 f"run: {bad}")
        log(f"[prefix] {name}: plain CPU run of the first {PREFIX} groups "
            f"over {ticks} ticks equals the card's columns "
            f"({time.perf_counter() - t0:.1f} s)")

    # -- 8. fused depth sweep, observers off ---------------------------------
    sweep = {}
    for T in SWEEP_T:
        run = cuda_scan.make_cuda_scan(cfg, SWEEP_TICKS, fused_ticks=T,
                                       aux_source="inkernel", device=dev)
        st = end.clone()
        _, dt_t, launches_t, _ = counted(lambda: run(st))
        expect(f"sweep T={T} launches", launches_t,
               {"tick_kernel": 0, "fused_tick_kernel": SWEEP_TICKS // T})
        sweep[T] = dt_t * 1e3 / SWEEP_TICKS
    log("[sweep] ms/tick by fused depth, observers off, "
        f"{SWEEP_TICKS} ticks from tick {TICKS}: " + json.dumps(sweep))
    return kernels


# ---------------------------------------------------------------------------
# Step 10: the §10 mailbox at headline scale (bench.py stage 4b).

def mailbox_steps(dev) -> dict:
    """Step 10 at mailbox_config(): (a) the kernels and the delay draw vs
    their plain versions, (b) the main path, (c) the other runners, (d) CPU
    prefix parity. Returns the kernels' entries."""
    cfg = mailbox_config(GROUPS)
    N = cfg.n_nodes
    rng = tick_mod.make_rng(cfg, dev)
    base, tkeys, bkeys = rng
    kernels = {}
    slot_mb = sum(field_dtype(k, cfg).itemsize
                  for k in MAILBOX_FIELDS) * N * N * GROUPS / 1e6

    # -- 10a. kernels vs plain ------------------------------------------------
    kernels["tick_kernel[mailbox]"], a = check_tick(cfg, rng, dev)
    snap = cuda_tick.fused_snapshot_fields(cfg, telemetry=True, monitor=True)
    stat = cuda_tick.inkernel_aux_statics(cfg, base, tkeys, bkeys)
    for aux_source in ("staged", "inkernel"):
        r = check_fused(cfg, a, aux_source, rng, stat, snap)
        kernels[f"fused_tick_kernel[{aux_source},mailbox]"] = {
            "source": "fused_tick_kernel.cu",
            "replaces": "raft_kotlin_tpu/ops/pallas_tick.py:999",
            **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by")}}
        log(f"[mailbox fused=plain] {aux_source}: {FUSED_LAUNCHES} launches "
            f"of T={FUSED_T} from tick {a.tick}, snapshots {list(snap)}: "
            f"bit-equal (max_abs_err {r['max_abs_err']}), overflow 0; "
            + json.dumps({k: r[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "bytes",
                "bytes_ms", "ops", "ops_ms")}))
    # The delay draw alone over one tick's pair lattice, against the staged
    # draw of ops/tick.make_aux (utils/rng.delay_mask, groups-minor).
    ktab = cuda_tick.inkernel_aux_operands(stat, a.tick)["ktab"]
    cuda_tick.delay_draw(cfg, ktab)  # loads the module, untimed
    dt_d, t_d = DeviceTimer(), Timer()
    for _ in range(3):
        got = dt_d.run(lambda: cuda_tick.delay_draw(cfg, ktab))
        with t_d:
            want = rngmod.delay_mask(base, a.tick, (GROUPS, N, N),
                                     cfg.delay_lo, cfg.delay_hi, dev)
            want = want.permute(1, 2, 0).reshape(N * N, GROUPS).to(
                torch.int16)
    d_err = field_err(got, want)
    if d_err:
        raise AssertionError("delay_draw != the staged delay draw")
    # Two blocks a pair, four a group for the tick's folded key; the
    # (N*N, G) int16 plane written, the key table read.
    d_bound, d_by = bound(got.nbytes + ktab.nbytes,
                          (2 * N * N + 4) * GROUPS * THREEFRY_OPS)
    kernels["delay_draw"] = {
        "source": "kt_rng.cuh", "replaces": "raft_kotlin_tpu/utils/rng.py:621",
        "max_abs_err": d_err, "ms": dt_d.mean_ms(), "plain_ms": t_d.mean_ms(),
        "bound_ms": d_bound, "bound_by": d_by}
    log(f"[delay_draw=plain] tick {a.tick}, {N * N} x {GROUPS} delays on "
        f"[{cfg.delay_lo}, {cfg.delay_hi}]: bit-equal; kernel "
        f"{dt_d.mean_ms():.4f} ms, plain {t_d.mean_ms():.3f} ms; bound "
        f"{d_bound:.4f} ms ({d_by})")

    # -- 10b. the main path ---------------------------------------------------
    main_run = cuda_scan.make_cuda_scan(
        cfg, TICKS, fused_ticks=FUSED_T, aux_source="inkernel",
        telemetry=True, monitor=True, device=dev)
    (end, tel, mon), dt_main, launches, calls = counted(
        lambda: main_run(init_state(cfg, dev)))
    expect("mailbox main path launches", launches,
           {"fused_tick_kernel": TICKS // FUSED_T,
            "delay_draw": TICKS // FUSED_T})
    expect("mailbox main path host draws", calls,
           {"make_aux": 0, "materialize_el": 0})
    summary = telemetry_mod.summarize_monitor(mon)
    rec = telemetry_mod.summarize_telemetry(tel)
    leaders = int(((end.role == LEADER) & end.up).any(0).sum())
    max_commit = int(end.commit.max())
    latch_check_s = check_latch(cfg, summary)
    if end.tick != TICKS or leaders <= 0 or max_commit <= 0 \
            or rec["commit_advances"] <= 0 or rec["mailbox_inflight_hw"] <= 0:
        raise AssertionError(f"mailbox: no progress: tick {end.tick}, "
                             f"{leaders} groups with a live leader, max "
                             f"commit {max_commit}, recorder {rec}")
    off_run = cuda_scan.make_cuda_scan(cfg, TICKS, fused_ticks=FUSED_T,
                                       aux_source="inkernel", device=dev)
    _, dt_off, launches_off, _ = counted(
        lambda: off_run(init_state(cfg, dev)))
    expect("mailbox observers-off launches", launches_off,
           {"fused_tick_kernel": TICKS // FUSED_T,
            "delay_draw": TICKS // FUSED_T})
    log("[mailbox main path] " + json.dumps({
        "config": "mailbox_config(): bench.py stage 4b, bench.py:1418-1424",
        "runner": "make_cuda_scan", "ticks": TICKS, "groups": GROUPS,
        "delay": [cfg.delay_lo, cfg.delay_hi], "slot_planes_mb": slot_mb,
        "fused_ticks": FUSED_T, "aux_source": "inkernel",
        "elapsed_s": dt_main, "ms_per_tick": dt_main * 1e3 / TICKS,
        "group_steps_per_sec": GROUPS * TICKS / dt_main,
        "elections_per_sec": rec["elections_started"] / dt_main,
        "observers_off_ms_per_tick": dt_off * 1e3 / TICKS,
        "observers_off_group_steps_per_sec": GROUPS * TICKS / dt_off,
        "launches": launches, "host_draw_calls": calls,
        "inv_status": summary["inv_status"],
        "inv_violations": summary["violations"],
        "latch_reproduced_by_plain_cpu_s": latch_check_s,
        "groups_with_live_leader": leaders, "max_commit": max_commit,
        "recorder": rec,
        "ring_inflight_hw": max(w["inflight_hw"] for w in summary["ring"])}))

    # -- 10c. cross-path identity with the main path -------------------------
    legs = {}
    for name, aux_source, T in (("staged_T4", "staged", FUSED_T),
                                ("staged_T1", "staged", 1)):
        run = cuda_scan.make_cuda_scan(cfg, TICKS, fused_ticks=T,
                                       aux_source=aux_source, telemetry=True,
                                       monitor=True, device=dev)
        legs[name] = counted(lambda: run(init_state(cfg, dev)))
    expect("mailbox staged_T4 launches", legs["staged_T4"][2],
           {"fused_tick_kernel": TICKS // FUSED_T})
    expect("mailbox staged_T1 launches", legs["staged_T1"][2],
           {"tick_kernel": TICKS})
    mrun = tick_mod.make_run(cfg, TICKS, trace=False, telemetry=True,
                             device=dev)
    legs["make_run"] = counted(lambda: mrun(init_state(cfg, dev)))
    expect("mailbox make_run launches", legs["make_run"][2],
           {"tick_kernel": TICKS})
    for name, (out, _, _, _) in legs.items():
        # make_run returns (state, leader counts, recorder).
        e, tl, mn = (out[0], out[2], {}) if name == "make_run" else out
        bad = states_differ(e, end) + [
            f"recorder {k}" for k in tl if int(tl[k]) != int(tel[k])] + [
            f"monitor {k}" for k in mn if not torch.equal(mn[k], mon[k])]
        if bad:
            raise AssertionError(f"mailbox {name} != the main path: {bad}")
    kernels["tick_kernel[mailbox]"]["launches"] = \
        legs["make_run"][2]["tick_kernel"]
    kernels["fused_tick_kernel[staged,mailbox]"]["launches"] = \
        legs["staged_T4"][2]["fused_tick_kernel"]
    kernels["fused_tick_kernel[inkernel,mailbox]"]["launches"] = \
        launches["fused_tick_kernel"]
    kernels["delay_draw"]["launches"] = launches["delay_draw"]
    log("[mailbox cross-path] " + json.dumps({
        "ticks": TICKS,
        "equal_to_main_path": list(legs),
        "ms_per_tick": {k: v[1] * 1e3 / TICKS for k, v in legs.items()},
        "launches": {k: v[2] for k, v in legs.items()},
        "host_draw_calls": {k: v[3] for k, v in legs.items()}}))

    # -- 10d. CPU prefix parity ----------------------------------------------
    t0 = time.perf_counter()
    pcfg = dataclasses.replace(cfg, n_groups=PREFIX)
    pend = cuda_scan.make_cuda_scan(pcfg, TICKS, fused_ticks=FUSED_T,
                                    aux_source="inkernel",
                                    device="cpu")(init_state(pcfg, "cpu"))
    bad = [k for k in pend.fields()
           if not torch.equal(getattr(pend, k),
                              getattr(end, k)[..., :PREFIX].cpu())]
    if bad:
        raise AssertionError(f"mailbox: CPU prefix differs from the card "
                             f"run: {bad}")
    log(f"[mailbox prefix] plain CPU run of the first {PREFIX} groups over "
        f"{TICKS} ticks equals the card's columns, slots included "
        f"({time.perf_counter() - t0:.1f} s)")
    return kernels


# ---------------------------------------------------------------------------
# Step 11: the §12 scenario-bank fuzz farm (api/fuzz.smoke_config).

def farm_partition_universes(bank: dict, ticks: int) -> int:
    """Universes whose partition program is active on at least one of the
    first `ticks` ticks (the §12 flapping window on the bank's rows)."""
    t = torch.arange(ticks, device=bank["part_kind"].device)[:, None]
    active = rngmod.scenario_active(bank, t)
    return int(((bank["part_kind"] != 0) & active.any(0)).sum())


def farm_gates(name: str, cfg: RaftConfig, end, tel, mon, ticks: int,
               launches: dict, calls: dict, dev) -> dict:
    """The farm batch's gates: the launch counts (one fused in-kernel
    launch per FUSED_T ticks, each reading the bank's rows, the mailbox's
    drawing its delays), no host draw, progress, and coverage (fault,
    election and taint universes, and universes whose partition program was
    active). Returns the batch's summary fields."""
    n = ticks // FUSED_T
    expect(f"{name} launches", launches, {
        "fused_tick_kernel": n, "scenario_rows": n,
        **({"delay_draw": n} if cfg.uses_mailbox else {})})
    expect(f"{name} host draws", calls, {"make_aux": 0, "materialize_el": 0})
    summary = telemetry_mod.summarize_monitor(mon)
    uni = telemetry_mod.universe_stats(mon)
    bank = tick_mod.split_rng(tick_mod.make_rng(cfg, dev))[3]
    cov = {
        "fault_universes": int((uni["grp_fault_events"] > 0).sum()),
        "election_universes": int((uni["grp_elections"] > 0).sum()),
        "taint_restart_universes": int(uni["taint_restart"].sum()),
        "taint_unsafe_universes": int(uni["taint_unsafe"].sum()),
        "violation_universes": int((uni["grp_violations"] > 0).sum()),
        "partition_universes": farm_partition_universes(bank, ticks)}
    leaders = int(((end.role == LEADER) & end.up).any(0).sum())
    if end.tick != ticks or leaders <= 0 or int(end.commit.max()) <= 0 \
            or min(cov[k] for k in (
                "fault_universes", "election_universes",
                "taint_restart_universes", "partition_universes")) <= 0:
        raise AssertionError(f"{name}: no progress or no coverage: tick "
                             f"{end.tick}, {leaders} universes with a live "
                             f"leader, coverage {cov}")
    return {"summary": summary, "coverage": cov, "leaders": leaders,
            "recorder": telemetry_mod.summarize_telemetry(tel)}


def check_farm_latch(cfg: RaftConfig, summary: dict, farm: dict) -> dict:
    """The farm over the batch whose monitor is `summary`: one artifact
    exactly when the batch latched. A latched batch's latch must be
    reproduced by the plain version on the CPU over the first group + 1
    universes (draws are keyed by the group's index, the bank by its
    universe id), and the farm's shrunk artifact (whose latch may have
    moved with its channels) confirmed by its replay on the card. Returns
    what was checked."""
    latch = summary["latch"]
    if farm["violations"] != (latch is not None):
        raise AssertionError(f"fuzz_farm: {farm['violations']} artifacts "
                             f"from a batch that latched {latch}")
    if latch is None:
        return {}
    art = farm["records"][0]
    if not art["replay_confirmed"]:
        raise AssertionError(f"farm artifact {art['status']} not confirmed "
                             f"by its replay on the card")
    t0 = time.perf_counter()
    sub = dataclasses.replace(cfg, n_groups=latch["group"] + 1)
    plain = fuzz.run_fuzz_batch(sub, latch["tick"] + 1, device="cpu")
    if plain["summary"]["inv_status"] != summary["inv_status"]:
        raise AssertionError(f"farm batch latched {summary['inv_status']} "
                             f"on the card, the plain version "
                             f"{plain['summary']['inv_status']}")
    return {"artifact": art["status"], "horizon": art["horizon"],
            "shrink": art["shrink"], "replay_confirmed": True,
            "latch_reproduced_by_plain_cpu_s": time.perf_counter() - t0}


def farm_steps(dev) -> dict:
    """Step 11 at fuzz.smoke_config(GROUPS): (a) the kernels vs their plain
    versions, (b) the farm end to end, (c) CPU prefix parity, (d) a seeded
    mutation at the card's scale, (e) the mailbox regime. Returns the
    kernels' entries."""
    cfg = fuzz.smoke_config(GROUPS)
    mcfg = dataclasses.replace(  # scripts/fuzz_farm.py --delay 1 4
        cfg, delay_lo=1, delay_hi=4,
        scenario=dataclasses.replace(cfg.scenario, delay_windows=True))
    rng = tick_mod.make_rng(cfg, dev)
    base, tkeys, bkeys, scen = tick_mod.split_rng(rng)
    kernels = {}
    snap = cuda_tick.fused_snapshot_fields(cfg, telemetry=True, monitor=True,
                                           per_group=True)

    # -- 11a. kernels vs plain ------------------------------------------------
    kernels["tick_kernel[farm]"], a = check_tick(cfg, rng, dev)
    stat = cuda_tick.inkernel_aux_statics(cfg, base, tkeys, bkeys, scen)
    legs_a = {"fused_tick_kernel[inkernel,farm]": (cfg, a, rng, stat)}
    mrng = tick_mod.make_rng(mcfg, dev)
    mb, mtk, mbk, mscen = tick_mod.split_rng(mrng)
    mstat = cuda_tick.inkernel_aux_statics(mcfg, mb, mtk, mbk, mscen)
    mwarm = cuda_scan.make_cuda_scan(mcfg, WARM, fused_ticks=FUSED_T,
                                     aux_source="inkernel", device=dev)(
        init_state(mcfg, dev))
    legs_a["fused_tick_kernel[inkernel,farm,mailbox]"] = (mcfg, mwarm, mrng,
                                                          mstat)
    for name, (c, warm, r_, st_) in legs_a.items():
        sn = cuda_tick.fused_snapshot_fields(c, telemetry=True, monitor=True,
                                             per_group=True)
        r = check_fused(c, warm, "inkernel", r_, st_, sn)
        kernels[name] = {
            "source": "fused_tick_kernel.cu",
            "replaces": "raft_kotlin_tpu/ops/pallas_tick.py:999",
            **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by")}}
        log(f"[farm fused=plain] {name}: {FUSED_LAUNCHES} launches of T="
            f"{FUSED_T} from tick {warm.tick}, bank rows "
            f"{list(rngmod.scen_layout(c))}: bit-equal (max_abs_err "
            f"{r['max_abs_err']}), overflow 0; " + json.dumps({
                k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "bytes", "bytes_ms", "ops", "ops_ms")}))
    del mwarm

    # -- 11b. the farm end to end --------------------------------------------
    runner = fuzz.make_batch_runner(cfg, TICKS, device=dev)
    (end, tel, mon), dt_main, launches, calls = counted(runner)
    g = farm_gates("farm batch", cfg, end, tel, mon, TICKS, launches, calls,
                   dev)
    kernels["fused_tick_kernel[inkernel,farm]"]["launches"] = \
        launches["fused_tick_kernel"]
    t0 = time.perf_counter()
    farm = fuzz.fuzz_farm(cfg, TICKS, triage_confirm=False, device=dev)
    farm_s = time.perf_counter() - t0
    if farm["coverage"] != {k: v for k, v in g["coverage"].items()
                            if k != "partition_universes"}:
        raise AssertionError("fuzz_farm's batch != the counted batch")
    latch = check_farm_latch(cfg, g["summary"], farm)
    # Where a launch's time goes, on the continuing state: the key table,
    # the kernel call, the observers' replay (per-group monitor).
    cont = end.clone()
    s = tick_mod.flatten_state(cfg, cont)
    flags = tick_mod.make_flags(cfg)
    prev = {k: s[k].clone() for k in snap}
    tel_c = telemetry_mod.telemetry_zeros(dev)
    mon_c = telemetry_mod.monitor_init(GROUPS, SPLIT_LAUNCHES * FUSED_T,
                                       per_group=True, device=dev)
    stages = {"operands_ms": [], "kernel_call_ms": [], "observers_ms": []}
    for _ in range(SPLIT_LAUNCHES):
        sync()
        h = [time.perf_counter()]
        ops = cuda_tick.inkernel_aux_operands(stat, cont.tick)
        sync()
        h.append(time.perf_counter())
        _, snaps = cuda_tick.fused_tick_kernel(cfg, s, FUSED_T, flags,
                                               "inkernel", ops, snap)
        sync()
        h.append(time.perf_counter())
        ticks = cuda_tick.unpack_fused_outputs(snaps, FUSED_T)
        tel_c, mon_c = cuda_tick.fused_observe(cfg, prev, ticks, tel_c, mon_c)
        prev = ticks[-1]
        sync()
        h.append(time.perf_counter())
        cont.tick += FUSED_T
        for k, x, y in zip(stages, h, h[1:]):
            stages[k].append((y - x) * 1e3)
    del cont, s, prev, tel_c, mon_c
    # The staged cross-check: leader programs keep the staged runner at one
    # tick a launch (the one-tick kernel, the bank's masks drawn on the
    # host from each pre-tick state), which must equal the farm's batch.
    srun = cuda_scan.scan_core(cfg, TICKS, telemetry=True, monitor=True,
                               per_group=True, aux_source="staged",
                               device=dev)
    (s_end, _, s_tel, s_mon), dt_s, launches_s, _ = counted(
        lambda: srun(init_state(cfg, dev)))
    expect("farm staged launches", launches_s, {"tick_kernel": TICKS})
    bad = states_differ(s_end, end) + [
        f"recorder {k}" for k in s_tel if int(s_tel[k]) != int(tel[k])] + [
        f"monitor {k}" for k in s_mon if not torch.equal(s_mon[k], mon[k])]
    if bad:
        raise AssertionError(f"farm: the staged T=1 runner != the batch: "
                             f"{bad}")
    kernels["tick_kernel[farm]"]["launches"] = launches_s["tick_kernel"]
    log("[farm] " + json.dumps({
        "config": "api/fuzz.smoke_config(102400): raft_kotlin_tpu/api/"
                  "fuzz.py:1129-1147 at the headline's group count",
        "runner": "api/fuzz.make_batch_runner (fused T=4, in-kernel draws, "
                  "recorder + per-group monitor)",
        "ticks": TICKS, "universes": GROUPS,
        "bank_rows": list(rngmod.scen_layout(cfg)),
        "elapsed_s": dt_main, "ms_per_tick": dt_main * 1e3 / TICKS,
        "universe_ticks_per_sec": GROUPS * TICKS / dt_main,
        "launches": launches, "host_draw_calls": calls,
        "coverage": g["coverage"], "groups_with_live_leader": g["leaders"],
        "recorder": g["recorder"],
        "batch_inv_status": g["summary"]["inv_status"],
        "batch_violations": g["summary"]["violations"],
        "inv_status": farm["inv_status"], "artifacts": farm["violations"],
        "corpus_hash": farm["corpus_hash"], "fuzz_farm_s": farm_s,
        **latch,
        "per_launch_split": {k: sum(v) / len(v) for k, v in stages.items()},
        "kernel_device_ms":
            kernels["fused_tick_kernel[inkernel,farm]"]["ms"],
        "staged_T1_equal": True, "staged_T1_ms_per_tick":
            dt_s * 1e3 / TICKS}))
    del s_end, s_tel, s_mon

    # -- 11c. CPU prefix parity ------------------------------------------------
    t0 = time.perf_counter()
    pcfg = dataclasses.replace(cfg, n_groups=PREFIX)
    pend, ptel, pmon = fuzz.make_batch_runner(pcfg, TICKS, device="cpu")()
    bad = [k for k in STATE_FIELDS
           if not torch.equal(getattr(pend, k),
                              getattr(end, k)[..., :PREFIX].cpu())]
    bad += [k for k in telemetry_mod.PER_GROUP_KEYS + (
        "taint_restart", "taint_unsafe")
        if not torch.equal(pmon[k], mon[k][:PREFIX].cpu())]
    if bad:
        raise AssertionError(f"farm: CPU prefix differs from the card: {bad}")
    log(f"[farm prefix] plain CPU run of the first {PREFIX} universes over "
        f"{TICKS} ticks equals the card's columns: end state, per-group "
        f"counters, taint masks ({time.perf_counter() - t0:.1f} s)")
    del end, tel, mon

    # -- 11d. seeded mutation at the card's scale ------------------------------
    clean = RaftConfig(n_groups=GROUPS, n_nodes=3, log_capacity=32,
                       cmd_period=2, seed=2,
                       scenario=ScenarioSpec(farm_seed=1, drop_max=0.05)
                       ).stressed(10)
    c_end, _, c_mon = fuzz.make_batch_runner(clean, MUT_TICK, device=dev)()
    if telemetry_mod.summarize_monitor(c_mon)["latch"] is not None:
        raise AssertionError("the mutation's config latches unmutated "
                             "before the mutation tick")
    ok = ((c_end.commit[0] >= 1) & ~c_mon["taint_restart"]
          & ~c_mon["taint_unsafe"]).cpu()
    ok[:MUT_MIN_GROUP] = False
    if not bool(ok.any()):
        raise AssertionError(f"no group >= {MUT_MIN_GROUP} commits node 1's "
                             f"slot 0 before the mutation tick")
    g_m = int(ok.nonzero()[0])
    log(f"[farm mutation] group {g_m}: node 1's slot 0 committed before tick "
        f"{MUT_TICK}, the unmutated monitor clean through tick "
        f"{MUT_TICK - 1}; committed_rewrite_mutator at ({MUT_TICK}, {g_m})")
    del c_end, c_mon

    def mf(c):
        return fuzz.committed_rewrite_mutator(c, MUT_TICK, g_m)

    (mfarm, dt_mut, launches_m, _) = counted(lambda: fuzz.fuzz_farm(
        clean, MUT_HORIZON, mutator_factory=mf, triage_confirm=False,
        device=dev))
    art = mfarm["records"][0] if mfarm["records"] else {}
    min_cfg = config_from_dict(art["config"]) if art else None
    if mfarm["violations"] != 1 or (art["tick"], art["group"]) != (
            MUT_TICK, g_m) or art["horizon"] != MUT_TICK + 1 \
            or fuzz.scenario_channels(min_cfg) != [] \
            or not art["replay_confirmed"]:
        raise AssertionError(f"seeded mutation: {mfarm['inv_status']}, "
                             f"artifact {json.dumps(art)[:2000]}")
    if fuzz.replay_artifact(dict(art, tick=art["tick"] + 1),
                            mutator_factory=mf, device=dev):
        raise AssertionError("seeded mutation: a perturbed artifact (tick + "
                             "1) replayed")
    log("[farm mutation] " + json.dumps({
        "latch": art["status"], "horizon": art["horizon"],
        "shrink": art["shrink"], "replay_confirmed": True,
        "perturbed_replay_refused": True, "fuzz_farm_s": dt_mut,
        "fused_launches": launches_m["fused_tick_kernel"],
        "corpus_hash": mfarm["corpus_hash"]}))

    # -- 11e. the mailbox regime ------------------------------------------------
    mrunner = fuzz.make_batch_runner(mcfg, MAIL_TICKS, device=dev)
    (m_end, m_tel, m_mon), dt_m, launches_mb, calls_mb = counted(mrunner)
    gm = farm_gates("farm mailbox batch", mcfg, m_end, m_tel, m_mon,
                    MAIL_TICKS, launches_mb, calls_mb, dev)
    kernels["fused_tick_kernel[inkernel,farm,mailbox]"]["launches"] = \
        launches_mb["fused_tick_kernel"]
    mfarm2 = fuzz.fuzz_farm(mcfg, MAIL_TICKS, triage_confirm=False,
                            device=dev)
    mlatch = check_farm_latch(mcfg, gm["summary"], mfarm2)
    if gm["recorder"]["mailbox_inflight_hw"] <= 0:
        raise AssertionError("farm mailbox: no slot ever in flight")
    log("[farm mailbox] " + json.dumps({
        "config": "smoke_config(102400) with delay 1-4 and per-universe "
                  "delay windows (scripts/fuzz_farm.py --delay 1 4)",
        "ticks": MAIL_TICKS, "universes": GROUPS,
        "bank_rows": list(rngmod.scen_layout(mcfg)),
        "elapsed_s": dt_m, "ms_per_tick": dt_m * 1e3 / MAIL_TICKS,
        "universe_ticks_per_sec": GROUPS * MAIL_TICKS / dt_m,
        "launches": launches_mb, "host_draw_calls": calls_mb,
        "coverage": gm["coverage"], "groups_with_live_leader": gm["leaders"],
        "recorder": gm["recorder"],
        "batch_inv_status": gm["summary"]["inv_status"],
        "batch_violations": gm["summary"]["violations"],
        "inv_status": mfarm2["inv_status"], **mlatch}))
    return kernels


# ---------------------------------------------------------------------------
# Step 9: the deep-log path (BASELINE config 5).

def log_sectors(rows: torch.Tensor, N: int, C: int, G: int, elt: int,
                keep=None) -> int:
    """Distinct 32-byte sectors of an (N*C, G) log that the local `rows`
    ((N*R, G), node n's rows in block n) address; rows outside [0, C), and
    where `keep` is False, address none."""
    R = rows.shape[0] // N
    base = (torch.arange(N, device=rows.device) * C).repeat_interleave(R)
    ok = (rows >= 0) & (rows < C)
    if keep is not None:
        ok = ok & keep
    flat = (base[:, None] + rows.long()) * G + torch.arange(
        G, device=rows.device)[None]
    return int(torch.unique(flat[ok] * elt // 32).numel())


def device_busy_ms(fn) -> tuple:
    """(host ms, device-busy ms) of fn() under torch.profiler: busy is the
    union of the intervals of the trace's device events (kernels, copies,
    sets); None when the trace holds no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        host_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return host_ms, None
    busy_us, lo, hi = 0.0, *spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy_us, lo = busy_us + hi - lo, a
        hi = max(hi, b)
    return host_ms, (busy_us + hi - lo) / 1e3


def deep_steps(dev) -> dict:
    """Step 9 at deep_config(): (b) the main deep run, its stage split,
    (a) kernels vs plain, the kernels' times and bounds, (c) CPU prefix
    parity. Returns the two deep kernels' entries."""
    cfg = deep_config(GROUPS)
    N, C = cfg.n_nodes, cfg.phys_capacity
    rng = tick_mod.make_rng(cfg, dev)
    base, tkeys, bkeys = rng

    # -- 9b. the main deep run --------------------------------------------
    st = init_state(cfg, dev)
    log_gb = (st.log_term.nbytes + st.log_cmd.nbytes) / 1e9
    warm = tick_mod.make_run(cfg, DEEP_WARM, trace=False, telemetry=True,
                             device=dev)
    timed = tick_mod.make_run(cfg, DEEP_TICKS, trace=False, telemetry=True,
                              device=dev)
    torch.cuda.reset_peak_memory_stats(dev)

    def main_run():
        t0 = time.perf_counter()
        tel_w = warm(st)[2]
        sync()
        t1 = time.perf_counter()
        tel_t = timed(st)[2]
        return tel_w, tel_t, t1 - t0

    (tel_w, tel_t, dt_warm), dt_all, launches, calls = counted(main_run)
    ticks = DEEP_WARM + DEEP_TICKS
    dt_timed = dt_all - dt_warm
    expect("deep path launches", launches,
           {"deep_gather": ticks, "deep_scatter": ticks})
    expect("deep path host calls", calls,
           {"make_aux": ticks, "materialize_el": ticks})
    tel = {k: int(tel_w[k]) + int(tel_t[k]) for k in tel_w}
    leaders = int(((st.role == LEADER) & st.up).any(0).sum())
    max_commit = int(st.commit.max())
    if st.tick != ticks or leaders <= 0 or max_commit <= 0 \
            or tel["commit_advances"] <= 0:
        raise AssertionError(f"deep path: no progress: tick {st.tick}, "
                             f"{leaders} groups with a live leader, max "
                             f"commit {max_commit}")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    prefix = {k: getattr(st, k)[..., :DEEP_PREFIX].to("cpu", copy=True)
              for k in STATE_FIELDS}

    # Where a tick's time goes, stage by stage on the continuing state,
    # each stage synchronised and timed by host clock.
    split = {"make_aux_ms": 0.0, "lattice_ms": 0.0, "gather_ms": 0.0,
             "scatter_ms": 0.0, "materialize_el_ms": 0.0}

    def stage(key, fn):
        def run(*args):
            sync()
            t0 = time.perf_counter()
            out = fn(*args)
            sync()
            split[key] += (time.perf_counter() - t0) * 1e3
            return out
        return run

    for _ in range(DEEP_SPLIT):
        aux, fl = stage("make_aux_ms", tick_mod.make_aux)(
            cfg, base, tkeys, bkeys, st)
        s = tick_mod.flatten_state(cfg, st)
        d = stage("lattice_ms", tick_mod.phase_body)(
            cfg, s, aux, fl, None, None,
            stage("gather_ms", deep_gather.gather),
            stage("scatter_ms", deep_scatter.scatter))
        stage("materialize_el_ms", tick_mod.finish_tick)(cfg, tkeys, st, s, d)
    split = {k: v / DEEP_SPLIT for k, v in split.items()}
    split["lattice_ms"] -= split["gather_ms"] + split["scatter_ms"]

    # -- 9a. kernels vs plain, from the warmed state ------------------------
    a, b = st, st.clone()
    dt_g, dt_s, t_pg, t_ps = DeviceTimer(), DeviceTimer(), Timer(), Timer()
    cap, worst = {}, 0

    def k_gather(*args):
        cap["k_gather"] = dt_g.run(lambda: deep_gather.gather(*args))
        cap["gather_rows"] = args[2]
        return cap["k_gather"]

    def p_gather(*args):
        with t_pg:
            cap["p_gather"] = deep_gather.gather_plain(*args)
        return cap["p_gather"]

    def k_scatter(*args):
        cap["scatter_args"] = args[2:5]
        dt_s.run(lambda: deep_scatter.scatter(*args))

    def p_scatter(*args):
        with t_ps:
            deep_scatter.scatter_plain(*args)

    # (Both kernels' modules are loaded: the main run launched them.)
    for _ in range(DEEP_CHECK):
        aux, fl = tick_mod.make_aux(cfg, base, tkeys, bkeys, a)
        sa, sb = tick_mod.flatten_state(cfg, a), tick_mod.flatten_state(cfg, b)
        da = tick_mod.phase_body(cfg, sa, aux, fl, gather=k_gather,
                                 scatter=k_scatter)
        db = tick_mod.phase_body(cfg, sb, aux, fl, gather=p_gather,
                                 scatter=p_scatter)
        errs = {k: field_err(sa[k], sb[k]) for k in sa}
        errs["el_dirty"] = field_err(da, db)
        errs["gather_t"] = field_err(cap["k_gather"][0], cap["p_gather"][0])
        errs["gather_c"] = field_err(cap["k_gather"][1], cap["p_gather"][1])
        worst = max(worst, *errs.values())
        if worst != 0:
            raise AssertionError(f"deep kernels != plain at tick {a.tick}: "
                                 f"{[k for k, v in errs.items() if v]}")
        tick_mod.finish_tick(cfg, tkeys, a, sa, da)
        tick_mod.finish_tick(cfg, tkeys, b, sb, db)

    # Bounds and the library calls, on the last checked tick's operands.
    G, elt = GROUPS, a.log_term.element_size()
    # #6 reads one row tensor, the cmd rows being each node's entry rows.
    rows = cap["gather_rows"]
    rows_c = deep_gather.cmd_rows(rows, N)
    vt, vc = cap["k_gather"]
    g_sectors = (log_sectors(rows, N, C, G, elt)
                 + log_sectors(rows_c, N, C, G, elt))
    g_bytes = rows.nbytes + vt.nbytes + vc.nbytes + 32 * g_sectors
    g_bound, g_by = bound(g_bytes, DEEP_OPS_PER_ELEMENT
                          * (vt.numel() + vc.numel()))
    # #5 reads every row, but values only at the kept entries: their
    # distinct sectors, in both value planes; each written log sector is
    # read and written, in both logs.
    rows_s, svt, svc = cap["scatter_args"]
    K = rows_s.shape[0] // N
    kept = (rows_s >= 0) & (rows_s < C)
    s_sectors = log_sectors(rows_s, N, C, G, elt)
    v_sectors = int(torch.unique(
        kept.flatten().nonzero().flatten() * elt // 32).numel())
    s_bytes = rows_s.nbytes + 2 * 32 * v_sectors + 2 * 2 * 32 * s_sectors
    s_bound, s_by = bound(s_bytes, DEEP_OPS_PER_ELEMENT * rows_s.numel())
    # #6's library call: two torch.gather on the (N, C, G) views, timed as
    # the kernel is, queued behind a spinning card.
    lt3, lc3 = a.log_term.view(N, C, G), a.log_cmd.view(N, C, G)
    it = rows.view(N, -1, G).long()
    ic = rows_c.view(N, -1, G).long()
    t_lib = DeviceTimer()
    for _ in range(3):
        lib_t, lib_c = t_lib.run(lambda: (torch.gather(lt3, 1, it),
                                          torch.gather(lc3, 1, ic)))
    # (The logs have moved on since that tick: compare on the same logs.)
    ref_t, ref_c = deep_gather.gather(a.log_term.view(N * C, G),
                                      a.log_cmd.view(N * C, G), rows, N, C)
    if not (torch.equal(lib_t.view_as(ref_t), ref_t)
            and torch.equal(lib_c.view_as(ref_c), ref_c)):
        raise AssertionError("torch.gather disagrees with the deep gather")
    # #5 has no one PyTorch call that drops masked rows; as a note, an
    # index_put_ of the kept writes (re-applied: the log already holds
    # them, so neither copy changes).
    nrow = torch.arange(N, device=dev).repeat_interleave(K)[:, None] * C
    flat = ((nrow + rows_s.long()) * G
            + torch.arange(G, device=dev)[None])[kept]
    kvt, kvc = svt[kept], svc[kept]
    t_put = DeviceTimer()
    for _ in range(3):
        t_put.run(lambda: (a.log_term.view(-1).index_put_((flat,), kvt),
                           a.log_cmd.view(-1).index_put_((flat,), kvc)))
    if field_err(a.log_term, b.log_term) or field_err(a.log_cmd, b.log_cmd):
        raise AssertionError("re-applying the kept writes changed the logs")
    del b, lib_t, lib_c, ref_t, ref_c, it, ic, flat, kvt, kvc
    gc.collect()
    torch.cuda.empty_cache()

    # -- 9c. CPU prefix parity ----------------------------------------------
    t0 = time.perf_counter()
    pcfg = deep_config(DEEP_PREFIX)
    ends, tels = {}, {}
    for where in ("cpu", dev):
        pst = init_state(pcfg, where)
        tw = tick_mod.make_run(pcfg, DEEP_WARM, trace=False, telemetry=True,
                               device=where)(pst)[2]
        tt = tick_mod.make_run(pcfg, DEEP_TICKS, trace=False, telemetry=True,
                               device=where)(pst)[2]
        ends[str(where)] = pst
        tels[str(where)] = {k: int(tw[k]) + int(tt[k]) for k in tw}
    cpu_end, card_end = ends["cpu"], ends[str(dev)]
    bad = [k for k in STATE_FIELDS
           if not torch.equal(getattr(cpu_end, k), prefix[k])
           or not torch.equal(getattr(card_end, k).cpu(), prefix[k])]
    if bad or tels["cpu"] != tels[str(dev)]:
        raise AssertionError(f"deep path: the CPU prefix differs from the "
                             f"card: {bad or 'recorder'}")
    prefix_s = time.perf_counter() - t0

    # The card's busy time over a few more ticks of the main path, traced
    # last: a torch.profiler session slows later host-bound work.
    prof_ms, busy_ms = device_busy_ms(lambda: tick_mod.make_run(
        cfg, DEEP_PROFILE, trace=False, telemetry=True, device=dev)(a))
    busy = None if busy_ms is None else {
        "ticks": DEEP_PROFILE, "from_tick": a.tick - DEEP_PROFILE,
        "busy_ms_per_tick": busy_ms / DEEP_PROFILE,
        "traced_ms_per_tick": prof_ms / DEEP_PROFILE,
        "idle_share_traced": 1 - busy_ms / prof_ms,
        "idle_share_of_timed_tick":
            1 - busy_ms / DEEP_PROFILE / (dt_timed * 1e3 / DEEP_TICKS)}

    log("[deep path] " + json.dumps({
        "config": "deep_config(): BASELINE config 5, bench.py:1441-1444",
        "groups": GROUPS, "nodes": N, "log_capacity": C,
        "log_dtype": cfg.log_dtype, "logs_gb": log_gb,
        "peak_allocated_gb": peak_gb,
        "runner": "ops/tick.make_run(telemetry=True)",
        "warm_ticks": DEEP_WARM, "timed_ticks": DEEP_TICKS,
        "ms_per_tick": dt_timed * 1e3 / DEEP_TICKS,
        "group_steps_per_sec": GROUPS * DEEP_TICKS / dt_timed,
        "warm_ms_per_tick": dt_warm * 1e3 / DEEP_WARM,
        "launches": launches, "host_calls": calls,
        "groups_with_live_leader": leaders, "max_commit": max_commit,
        "recorder": tel, "stage_split_ms_per_tick": split,
        "device_busy": busy}))
    log("[deep kernels=plain] " + json.dumps({
        "ticks": DEEP_CHECK, "from_tick": ticks + DEEP_SPLIT,
        "max_abs_err": worst,
        "gather": {"ms": dt_g.mean_ms(), "plain_ms": t_pg.mean_ms(),
                   "library_ms": t_lib.mean_ms(), "bytes": g_bytes,
                   "sectors": g_sectors, "bound_ms": g_bound,
                   "rows": [rows.shape[0], rows_c.shape[0]]},
        "scatter": {"ms": dt_s.mean_ms(), "plain_ms": t_ps.mean_ms(),
                    "index_put_kept_ms": t_put.mean_ms(), "K": K,
                    "kept_writes": int(kept.sum()), "bytes": s_bytes,
                    "log_sectors": s_sectors, "value_sectors": v_sectors,
                    "bound_ms": s_bound}}))
    log(f"[deep prefix] plain CPU run and a card run of the first "
        f"{DEEP_PREFIX} groups over {ticks} ticks equal the card's columns "
        f"and each other's recorder ({prefix_s:.1f} s)")
    return {
        "deep_gather": {
            "source": "deep_gather.cu",
            "replaces": "raft_kotlin_tpu/ops/deep_gather.py:139",
            "launches": launches["deep_gather"], "max_abs_err": worst,
            "ms": dt_g.mean_ms(), "plain_ms": t_pg.mean_ms(),
            "bound_ms": g_bound, "bound_by": g_by,
            "library_ms": t_lib.mean_ms()},
        "deep_scatter": {
            "source": "deep_scatter.cu",
            "replaces": "raft_kotlin_tpu/ops/deep_scatter.py:263",
            "launches": launches["deep_scatter"], "max_abs_err": worst,
            "ms": dt_s.mean_ms(), "plain_ms": t_ps.mean_ms(),
            "bound_ms": s_bound, "bound_by": s_by, "library_ms": None},
    }


if __name__ == "__main__":
    sys.exit(main())
