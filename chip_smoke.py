#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

At the headline shape (102,400 five-node groups, the fault soup of
bench.py's BASELINE config), then with its §10 mailbox, both again in the
§14 packed layout and through the K-tick kernel, as the §12 fuzz farm's
102,400 three-node universes and at BASELINE config 5 (with the whole-log
copy floor, and with 1-3-tick delays: the deep mailbox), every check at
tolerance 0 (the state is all integers):

1. device: the card's name and power limit (nvidia-smi);
2. build: every CUDA kernel from the sources in this checkout (the tick
   kernels for five- and three-node groups, and for five-node groups in
   the packed layout too), one nvcc per source, node count and layout,
   started together;
3. tick kernel vs plain: from tick 60, 20 ticks step one copy through the
   one-tick kernel and one through the plain PyTorch phase lattice; every
   state field and el_dirty bit-equal each tick. Also the kernel's device
   time (CUDA events around a launch queued behind a spinning card) and its
   bound (the bytes the ticks' own data needs);
4. fused kernel vs plain: from there, 2 launches of T=4 ticks in each aux
   form (staged draws, in-kernel draws) through the fused kernel's
   observer build (the flight recorder and the safety monitor computed
   in the launch, folded after it) and through its plain route
   (fused_tick_plain storing the observers' per-tick snapshots, then
   fused_observe); state, overflow counts, recorder and monitor carry
   bit-equal; then (in-kernel draws) one more launch through the trace
   route, the observer build storing the trace's per-tick snapshots
   (FUSED_TRACE_FIELDS), those snapshots bit-equal to the plain route's;
   device time and bound as in 3; and the A/B of the redesign in turns:
   the launch storing the snapshots against the observer build, device ms
   and host ms with the replay or the fold (in each aux form here; on the
   other observed legs in their main path's form);
5. main path: make_cuda_scan(headline, 200 ticks, T=4, in-kernel draws,
   flight recorder + safety monitor) — exactly 50 fused launches, all of
   the observer build, no snapshot byte, no host draw (make_aux /
   materialize_el), no overflow, leaders elected and commits advancing,
   the known latch (leader_completeness@t24/g44835, 175 violations, as
   the JAX package's monitor latches) and the recorder and monitor carry
   (latch, counts, ring, per-group taints) equal to the plain route's over
   all 102,400 groups and 200 ticks (max_abs_err 0); the same run with the
   observers off; the stage split of the path;
6. cross-path identity over 63 ticks (so a remainder runs): in-kernel T=4,
   staged T=4 and staged T=1 runners bit-equal in end state, recorder and
   monitor, and the one-tick make_run (the earlier main path, its launches
   counted) equal in end state and recorder; the staged T=4 runner's
   observers equal to the plain route's; that path's stage split;
7. prefix parity: the plain versions on the CPU for the first 2,048 groups
   equal the card's columns of step 5's and step 6's end states (every
   draw is keyed by the group index, never by the group count);
8. ms/tick of the main path at T in {1, 2, 4, 8}, observers off (a
   measurement only);
9. the deep path, BASELINE config 5 (`deep_config()`: 102,400 seven-node
   groups, 10,000-entry int16 logs — 28.7 GB on the card), once steps 3-8
   have freed their tensors:
   (b) the main deep run: ops/tick.make_run(telemetry=True), 30 warm-up
       plus 20 timed ticks (bench.py's deep stage times 30; cut for the
       script's time, as step 15 times 20) — exactly one
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
       the distinct log sectors its rows address; which way each launch
       read and wrote (16-byte words or one element at a time), as its
       launcher decides;
   (d) the frontier cache at (b)'s width, ticks and rng, from boot on a
       second 28.7 GB state, right after (b): first the cached tick
       itself stepped 50 ticks with no rerun (refill_all, then make_aux,
       phase_body(fcache=), finish_tick) — every group that raised no OV
       flag equal to (b)'s end in every field, exactly one deep-scatter
       launch a tick and no deep-gather launch, ms/tick by host clock, the
       OV groups by tick; then ops/deep_cache.make_deep_scan(
       return_state=True, telemetry=True) from the rebuilt boot state: its
       end state equal to (b)'s over all 102,400 groups, field by field,
       and its recorder equal (ov_fallbacks, the count of OV ticks,
       aside); one deep-scatter launch a tick of each pass and deep-gather
       launches only when it prints that the OV rerun ran; ms/tick beside
       (b)'s, ov, the peak memory (the entry state is rebuilt in place on
       OV, not cloned: two 28.7 GB states fit, three would not);
   (c) prefix parity and (d)'s monitor leg: make_run and make_deep_scan,
       recorder and safety monitor on, over the first 256 groups (the
       size bench.py's deep invariant leg runs on an accelerator) and
       the first 20 of (b)'s ticks, each on the CPU (the plain versions)
       and on the card: every end state equals the card's columns of
       (b)'s after those ticks, and the four recorders and monitors are
       equal; the monitor's status;
   (e) the card's busy time over 2 more ticks of the main path from a
       torch.profiler trace, and so its idle share (last: profiling
       slows the host-bound work after it);
10. the §10 mailbox at headline scale, bench.py's stage 4b
   (`mailbox_config()`: the headline soup with 1-3-tick delivery delays,
   seed 5, and 13 slot planes on the card), run after step 8 and
   before step 9:
   (a) kernels vs plain, as in 3 and 4: the one-tick kernel over 20 ticks
       from tick 60, the fused kernel over 2 launches of T=4 in each aux
       form — state with every slot, el_dirty, overflow counts, recorder
       and monitor carry bit-equal; device times and bounds counting the slot
       bytes the ticks touch; and the in-kernel delay draw (kt_rng.cuh's
       delay_draw) alone over a tick's pair lattice, held to the staged
       draw of ops/tick.make_aux;
   (b) the main path: make_cuda_scan(200 ticks, T=4, in-kernel draws,
       observers on, then off) — exactly 50 fused launches, each drawing
       its delays in the kernel and observing in it, no host draw, no
       overflow, leaders and commits, slots in flight, the known latch
       (@t37/g35421, 61 violations) and the observers equal to the plain
       route's at full width; ms/tick, group-steps/s;
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
       draw, coverage (fault, election, taint and partition universes),
       the known latch (committed_prefix@t44/g11387) and the observers
       (per-group counters too) equal to the plain route's at full width;
       fuzz_farm over the same universes: one artifact exactly when the
       batch latched, confirmed by its replay on the card; the staged
       runner (one tick a launch: leader programs) equal to the batch;
       ms/tick, universe-ticks/s, the per-launch split;
   (c) prefix parity: the plain farm batch on the CPU over the first 2,048
       universes equals the card's columns (end state, per-group monitor
       counters, taint masks);
   (d) seeded mutation at 102,400 universes (tests/test_fuzz.py's
       committed rewrite at tick 70, on a group >= 50,000 picked from an
       unmutated run): the farm latches at exactly (70, group), shrinks to
       horizon 71 and no fault channel, its artifact replays and a
       perturbed one (tick 71) does not;
   (e) the mailbox regime's batch over 100 ticks with (b)'s gates but the
       corpus (latch leader_completeness@t28/g40756);
12. the §14 packed state layout and the §18 packed compute (kernel #4,
   the kPC instantiations), at the headline and at its mailbox, run after
   step 10 and before step 11:
   (a) kernels vs plain at 102,400 groups: every packed instantiation —
       the one-tick kernel over 3 ticks, the fused kernel over 1 launch of
       T=4 in each aux form — at compute "packed" and "unpacked", from
       tick 60 of the wide main path: the packed state with its width
       latch (0), el_dirty, overflow counts and the observers bit-equal;
       device time, plain time and the bound from the packed bytes;
   (b) the packed main paths: make_cuda_scan(200 ticks, T=4, in-kernel
       draws, observers on, then off, layout "packed", compute "packed"
       and "unpacked") equal to the wide path of the same seed in end
       state, recorder and monitor, exactly 50 fused launches of the
       packed instantiation, no host draw, the latch 0, the wide path's
       monitor latch (leader_completeness@t24/g44835,
       @t37/g35421 at the mailbox) reproduced; the packed observers equal
       to the plain route's at full width (compute "packed"); the staged
       packed runner and make_run(layout="packed") over 40 ticks equal to
       the wide run;
   (c) prefix parity: the plain packed path on the CPU over the first
       2,048 groups equals the card's columns;
   (d) the wide and packed rest-state bytes, per group and in total;
13. kernel #7, the archival K-tick kernel (make_cuda_scan(k_per_launch=K)),
   at the headline and at its mailbox (the kSync and kMail
   instantiations), from the tick-60 state, run after step 10:
   (a) two K=4 launches through the kernel and through its plain version:
       state and (N, G) overflow counts bit-equal, the counts zero; device
       time, plain time, and the bound from the bytes the launches' own
       data need (state in and out once, the slab and table entries they
       select, the log and slot bytes they touch);
   (b) make_cuda_scan(k_per_launch=4) over 22 ticks: exactly 5 K-tick
       launches and 2 one-tick launches (the remainder), no fused launch,
       equal in end state to the staged T=1 runner; with _resets_bound=1
       the same run raises (headline);
   (c) device ms of one launch at K = 1, 2, 4, 8 beside the one-tick kernel
       times K and the fused kernel's staged form at T = K without
       snapshots, from the same state (headline);
14. kernel #8, the whole-log copy floor, and the write-floor probe, run
   after step 9 has freed its logs:
   (a) the copy kernel vs its plain version at odd shapes (int16 from a
       2-byte-misaligned start, int32): bit-equal, the logs unchanged;
   (b) at config 5's full width (102,400 x 7 x 10,000 int16, 28.7 GB): the
       logs' int64 sums and first and last rows unchanged by 21
       applications, the time at or above the byte bound, torch's copy_
       beside it (library_ms), the plain version's time;
   (c) the probe's lines (raft_kotlin_tpu_torch/probe_write_floor.py): the
       deep scatter on clustered and uniform rows and the K sweep.
15. the deep mailbox: BASELINE config 5 with 1-3-tick delays (the JAX
   package's mbdeep_cfg window, bench.py:1673; 13 slot planes of 49 pairs
   beside the 28.7 GB logs), run after step 9 has freed its tensors and
   before step 14:
   (b) the batched engine's main run, ops/tick.make_run(telemetry=True),
       20 warm-up plus 20 timed ticks — exactly one deep-gather launch (the
       known-delivery batch: Rt = 6N+1 term rows, Rc = 3N cmd rows a node)
       and one deep-scatter launch a tick, no plain read or write on the
       card, leaders elected, commits advancing, slots in flight; ms/tick,
       group-steps/s, the peak memory;
   (c) the per-pair engine (make_run(batched=False): every read and write
       in place on the stored logs) on a second state over the same 40
       ticks — end state and recorders equal to (b)'s in every field over
       all 102,400 groups, no deep-gather or deep-scatter launch, and a
       peak within the two states plus 2 GB (no log-sized temporary);
       ms/tick;
   (a) from (b)'s state, one tick whose gather runs the kernel and its
       plain version on the same logs and rows: bit-equal, and equal to two
       torch.gather calls on the (N, C, G) views (library_ms); device ms,
       plain ms and the bound from the rows, the values and the distinct
       log sectors the rows address;
   (d) τ=0 (delay_lo=0, delay_hi=3) through the per-pair engine, 20 ticks
       on the same memory: no deep kernel launch, leaders, slots in
       flight; ms/tick;
   (e) prefix parity: the plain versions on the CPU for the first 2,048
       groups equal the card's columns of (b)'s and (d)'s end states;
   (f) the monitor leg at deep_config(256) with the same delays over 30
       ticks, make_run(telemetry=True, monitor=True) through both engines
       on the CPU and on the card: end states, recorders and monitors all
       equal.
Step 11 (a) also holds the §12 bank's edge lattice alone (the drop draw
and the partition programs' cut masks, kt_rng.cuh's cut_mask,
`cuda_tick.part_down`) to its plain version, with its device time,
operations bound, launch geometry and registers. The part_down and
delay_draw rows of the kernels line take their ms from these stand-alone
kernels and their launches from the main path's fused launches that run
the device function inside (`LAUNCHES["fused_tick_kernel[part_down]"]`,
`["fused_tick_kernel[delay_draw]"]`), and say so in `launches_of`.

On every leg with observers no fused launch allocates a per-tick snapshot
byte (counted: `snapshot_bytes`). Any failed check raises, so the script
exits non-zero; without a card it
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
    LOG_FIELDS, MAILBOX_FIELDS, PACKED_FIELDS, PACKED_MAILBOX_FIELDS,
    PackedRaftState,
    STATE_FIELDS, field_dtype, init_state, pack_state, packed_field_dtype,
    unpack_state)
from raft_kotlin_tpu_torch import probe_write_floor as probe
from raft_kotlin_tpu_torch.ops import (
    build, copy_floor, cuda_scan, cuda_tick, deep_cache, deep_gather,
    deep_scatter)
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
FUSED_T, FUSED_LAUNCHES, CROSS_TICKS, SPLIT_LAUNCHES = 4, 2, 63, 10
# Step 12, the packed layout: one-tick kernel-vs-plain ticks per
# instantiation; ticks of the staged and one-tick packed runners (their
# draws run on the host: ~70 and ~33 ms a tick at the headline).
PACK_CHECK, PACK_CROSS_TICKS = 3, 40
SWEEP_T, SWEEP_TICKS = (1, 2, 4, 8), 80
# Step 11, the farm: the mailbox leg's ticks; the seeded mutation's tick,
# the lowest group it may pick and its farm's horizon (tests/test_fuzz.py's
# mutation, at the card's scale).
MAIL_TICKS, MUT_TICK, MUT_MIN_GROUP, MUT_HORIZON = 100, 70, 50_000, 90
# Step 9, the deep path: warm-up and timed ticks of the main run (bench.py's
# deep stage times 30; 20 keep the script inside its time, and 50 ticks
# still reach config 5's two frontier-cache overflows, ticks 46 and 48),
# kernel-vs-plain ticks, stage-split ticks, and the groups of the CPU
# prefix run.
DEEP_WARM, DEEP_TICKS, DEEP_CHECK, DEEP_SPLIT, DEEP_PREFIX = 30, 20, 4, 5, 256
# 9c's ticks: the CPU prefix and the monitor leg, over the first ticks of
# 9b's warm-up (the monitor sweeps the whole (C, G) log planes each tick,
# which sets this leg's time on the CPU).
DEEP_MONITOR = 20
# Step 15, the deep mailbox: warm-up and timed ticks of the main run (both
# engines), the τ=0 run's ticks, and the monitor leg's ticks.
MB_DEEP_WARM, MB_DEEP_TICKS, MB_DEEP_TAU0, MB_DEEP_MONITOR = 20, 20, 20, 30
# Ticks of the main deep path traced with torch.profiler for the card's
# busy time.
DEEP_PROFILE = 2
# Integer operations per element a deep kernel computes (address and
# bounds arithmetic) — an over-count; both kernels are bound by bytes.
DEEP_OPS_PER_ELEMENT = 12
# Step 13, kernel #7: ticks a launch of the checked launches and the
# runner, the runner's ticks (5 launches and a 2-tick remainder), and the
# K of the device-time sweep.
K_TICK, K_CHECK, K_RUN_TICKS, K_SWEEP = 4, 2, 22, (1, 2, 4, 8)
# Step 14, kernel #8: the odd shapes of its check against the plain version
# (an element count that is no whole number of 16-byte vectors, one log
# starting 2 bytes past a 16-byte boundary), and the probe at config 5's
# full width.
FLOOR_ODD = ((3 * 1001, 102_397), (7 * 1000, 102_397))
SOURCES = "raft_kotlin_tpu_torch/ops/csrc/"


def log(msg: str) -> None:
    print(msg, flush=True)


def field_err(x: torch.Tensor, y: torch.Tensor) -> int:
    """max |x - y| over two same-shape integer tensors, in row chunks (a
    config-5 log is 14.3 GB; widening it whole would not fit)."""
    if torch.equal(x, y):
        return 0
    if x.dim() == 0:
        return abs(int(x) - int(y))
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


def mail_bytes(cfg: RaftConfig, G: int, mail, layout: str = "wide") -> int:
    """The §10 slot bytes a tick (or a fused launch) needs: both due planes
    read and written once, and the payload of each delivery it reads and of
    each send it writes (`mail`: phase_body's counts; None without the
    mailbox), in the layout's dtypes (a packed aq_hase bit counted as the
    byte of its mask)."""
    if not mail:
        return 0
    N = cfg.n_nodes
    size = (lambda k: packed_field_dtype(k, cfg).itemsize) \
        if layout == "packed" else (lambda k: field_dtype(k, cfg).itemsize)
    fields = PACKED_MAILBOX_FIELDS if layout == "packed" else MAILBOX_FIELDS

    def payload(prefix):
        return sum(size(k) for k in fields
                   if k.startswith(prefix) and not k.endswith("_due"))
    return 2 * 2 * N * N * G * size("vq_due") \
        + payload("vq_") * (mail["vote_read"] + mail["vote_sent"]) \
        + payload("aq_") * (mail["append_read"] + mail["append_sent"])


def rest_fields(layout: str) -> tuple:
    """A layout's state fields other than the logs and the slots."""
    fields = PACKED_FIELDS if layout == "packed" else STATE_FIELDS
    return tuple(k for k in fields if k not in LOG_FIELDS)


def log_pair_bytes(s: dict) -> int:
    """Bytes of one slot of both logs."""
    return s["log_term"].element_size() + s["log_cmd"].element_size()


def tick_bytes(cfg: RaftConfig, s: dict, aux: dict, flags, touched: dict,
               layout: str = "wide"):
    """Bytes one tick must move, each counted once: the non-log state read
    and written, the aux channels the kernel takes read, el_dirty written,
    the log slots this tick's data needs (phase_body's `touched`) and, under
    the mailbox, the slot bytes (mail_bytes) — in the layout's dtypes."""
    ops, _ = cuda_tick.kernel_operands(cfg, s, aux, flags, layout)
    n_state = len(PACKED_FIELDS if layout == "packed" else STATE_FIELDS)
    state = sum(s[k].nbytes for k in rest_fields(layout))
    aux_b = sum(t.nbytes for t in ops[n_state + len(MAILBOX_FIELDS):]
                if t is not None)
    slots = (int(touched["log_term_read"].sum())
             * s["log_term"].element_size()
             + int(touched["log_cmd_read"].sum())
             * s["log_cmd"].element_size()
             + int(touched["log_written"].sum()) * log_pair_bytes(s))
    return 2 * state + aux_b + s["term"].numel() + slots \
        + mail_bytes(cfg, s["term"].shape[-1], touched.get("mail"), layout)


def fused_bytes(cfg: RaftConfig, s: dict, ops: dict, snaps: dict,
                work: dict, layout: str = "wide", observed: int = 0) -> int:
    """Bytes one fused launch must move, each counted once: the non-log
    state read and written once, the overflow counts written, the
    snapshots `snaps` written (none on a launch that observes in the
    kernel); of the launch operands, the in-kernel key planes whole, and of
    the staged slabs and draw tables only the entries the launch's ticks use
    (`work["staged_reads"]`: an edge where the link and both ends are up, a
    heal draw for a failed link, one table entry per draw, ...); of the
    logs, all of both read when the snapshots copy them, else the slots the
    launch reads before it writes them (`work["log_read"]`: the in-kernel
    monitor's pair and top-of-commit reads among them), plus the slots it
    writes; the mailbox's slot bytes (mail_bytes); and `observed`, the
    in-kernel observers' rows and per-group carry (obs_bytes) — in the
    layout's dtypes."""
    N = cfg.n_nodes
    G = s["term"].shape[-1]
    state = sum(s[k].nbytes for k in rest_fields(layout))
    if "log_term" in snaps:
        logs = s["log_term"].nbytes + s["log_cmd"].nbytes
    else:
        logs = int(work["log_read"].sum()) * log_pair_bytes(s) // 2
    logs += int(work["log_written"].sum()) * log_pair_bytes(s)
    if "el_table" in ops:
        operands = sum(n * ops[k].element_size()
                       for k, n in work["staged_reads"].items())
    else:
        operands = sum(t.nbytes for t in ops.values())
    return 2 * state + logs + operands + N * G * 4 \
        + sum(t.nbytes for t in snaps.values()) \
        + mail_bytes(cfg, G, work.get("mail"), layout) + observed


def obs_bytes(T: int, carry: dict) -> int:
    """The in-kernel observers' bytes of a T-tick launch: its (T, OBS_R)
    int64 rows written, the monitor's per-group carry read and written."""
    return T * telemetry_mod.OBS_R * 8 + 2 * sum(v.nbytes
                                                 for v in carry.values())


def wide_view(cfg: RaftConfig, st, fields: tuple) -> dict:
    """A copy of `fields` of a (packed) state's wide flat view, INFLIGHT
    counted from its due planes: a replay's pre-launch view."""
    src = tick_mod.flatten_state(
        cfg, unpack_state(cfg, st) if isinstance(st, PackedRaftState) else st)
    return {k: telemetry_mod.mailbox_snapshot(src)
            if k == cuda_tick.INFLIGHT else src[k].clone() for k in fields}


def launch_ops(cfg, aux_source, s, tick0, T, rng, stat) -> dict:
    base, tkeys, bkeys, scen = tick_mod.split_rng(rng)
    if aux_source == "inkernel":
        return cuda_tick.inkernel_aux_operands(stat, tick0)
    return cuda_tick.staged_operands(cfg, base, tkeys, bkeys, tick0, s, T,
                                    scen=scen)


def flat_of(cfg: RaftConfig, st, layout: str) -> dict:
    """The flat dict a kernel of `layout` takes of a (packed) state."""
    return (tick_mod.flatten_packed if layout == "packed"
            else tick_mod.flatten_state)(cfg, st)


def check_fused(cfg, warm, aux_source, rng, stat, snap, layout="wide",
                compute="unpacked", launches=FUSED_LAUNCHES,
                per_group=False, trace=False) -> dict:
    """`launches` launches of FUSED_T ticks from `warm` (under the packed
    layout, from two packs of it) through the fused kernel's observer
    build — the recorder's and the monitor's steps in the launch, its rows
    folded after it — and through the plain route on the card
    (fused_tick_plain storing the observers' snapshots `snap`, then
    fused_observe): the state (width latch included), the overflow counts,
    the recorder and the monitor carry (`per_group`: with its per-group
    counters) bit-equal after every launch; the kernel's device time, the
    plain route's time, and the launches' bound from their own data (no
    snapshot: the rows and the carry in its place). `trace`: one more
    launch, untimed, through the trace route — the observer build storing
    the trace's per-tick snapshots (FUSED_TRACE_FIELDS) beside its
    observers — with those snapshots bit-equal to fused_tick_plain's."""
    flags = tick_mod.make_flags(cfg)
    kw = {"layout": layout, "compute": compute}
    dev = warm.term.device

    def fresh():
        return pack_state(cfg, warm) if layout == "packed" else warm.clone()

    def zeros():
        return (telemetry_mod.telemetry_zeros(dev),
                telemetry_mod.monitor_zeros(GROUPS, 1, per_group=per_group,
                                            device=dev))
    # A kernel's first launch loads its module, which waits for the card:
    # launch this form once, untimed, on a copy.
    w = flat_of(cfg, fresh(), layout)
    cuda_tick.fused_tick_kernel(cfg, w, FUSED_T, flags, aux_source, launch_ops(
        cfg, aux_source, w, warm.tick, FUSED_T, rng, stat),
        obs=cuda_tick.kernel_observers(zeros()[1]), **kw)
    del w
    a, b = fresh(), fresh()
    (tel_a, mon_a), (tel_b, mon_b) = zeros(), zeros()
    prev = wide_view(cfg, b, snap)
    dt, t_plain = DeviceTimer(), Timer()
    worst, moved, ops_n = 0, 0, 0
    for i in range(launches):
        sa, sb = flat_of(cfg, a, layout), flat_of(cfg, b, layout)
        ops = launch_ops(cfg, aux_source, sa, a.tick, FUSED_T, rng, stat)
        # What the launch's data needs, counted untimed on a wide copy.
        probe = (tick_mod.unpack_flat(cfg, sb) if layout == "packed"
                 else {k: v.clone() for k, v in sb.items()})
        work = {}
        pobs = cuda_tick.kernel_observers({k: v.clone()
                                           for k, v in mon_b.items()})
        cuda_tick.fused_tick_plain(cfg, probe, FUSED_T, flags, aux_source,
                                   ops, work=work, obs=pobs)
        moved += fused_bytes(cfg, sb, ops, {}, work, layout,
                             obs_bytes(FUSED_T, pobs.carry))
        ops_n += body_ops(cfg, GROUPS, FUSED_T) + (
            work["blocks"] * THREEFRY_OPS if aux_source == "inkernel" else 0)
        del probe, pobs
        oa = cuda_tick.kernel_observers(mon_a)
        ova, _ = dt.run(lambda: cuda_tick.fused_tick_kernel(
            cfg, sa, FUSED_T, flags, aux_source, ops, obs=oa, **kw))
        tel_a, mon_a = telemetry_mod.fold_obs_rows(oa.rows, tel_a, mon_a)
        with t_plain:
            ovb, snaps = cuda_tick.fused_tick_plain(cfg, sb, FUSED_T, flags,
                                                    aux_source, ops, snap,
                                                    **kw)
            ticks = cuda_tick.unpack_fused_outputs(snaps, FUSED_T)
            tel_b, mon_b = cuda_tick.fused_observe(cfg, prev, ticks, tel_b,
                                                   mon_b)
        prev = ticks[-1]
        err = max(max_abs_diff(sa, sb), max_abs_diff({"ov": ova}, {"ov": ovb}),
                  max_abs_diff(tel_a, tel_b), max_abs_diff(mon_a, mon_b))
        worst = max(worst, err)
        if err != 0 or set(mon_a) != set(mon_b):
            bad = [k for k in sa if not torch.equal(sa[k], sb[k])] + [
                f"recorder {k}" for k in tel_b
                if not torch.equal(tel_a[k], tel_b[k])] + [
                f"monitor {k}" for k in mon_b
                if not torch.equal(mon_a[k], mon_b[k])]
            raise AssertionError(f"fused kernel ({aux_source}) != plain at "
                                 f"launch {i}: {bad or ['overflow']}")
        if int(ova.sum()) != 0 or int(sa.get("ov", ova).sum()) != 0:
            raise AssertionError(f"fused kernel ({aux_source}): draw-table "
                                 f"or width overflow at launch {i}")
        a.tick += FUSED_T
        b.tick += FUSED_T
        del snaps, ticks
    if trace:
        trace_f = cuda_tick.FUSED_TRACE_FIELDS
        sa, sb = flat_of(cfg, a, layout), flat_of(cfg, b, layout)
        ops = launch_ops(cfg, aux_source, sa, a.tick, FUSED_T, rng, stat)
        oa = cuda_tick.kernel_observers(mon_a)
        _, ksnaps = cuda_tick.fused_tick_kernel(
            cfg, sa, FUSED_T, flags, aux_source, ops, trace_f, obs=oa, **kw)
        tel_a, mon_a = telemetry_mod.fold_obs_rows(oa.rows, tel_a, mon_a)
        _, snaps = cuda_tick.fused_tick_plain(
            cfg, sb, FUSED_T, flags, aux_source, ops,
            snap + tuple(f for f in trace_f if f not in snap), **kw)
        tel_b, mon_b = cuda_tick.fused_observe(
            cfg, prev, cuda_tick.unpack_fused_outputs(snaps, FUSED_T), tel_b,
            mon_b)
        if set(ksnaps) != set(trace_f):
            raise AssertionError(f"trace launch stored {sorted(ksnaps)}")
        err = max(max_abs_diff(ksnaps, snaps), max_abs_diff(sa, sb),
                  max_abs_diff(tel_a, tel_b), max_abs_diff(mon_a, mon_b))
        if err != 0:
            raise AssertionError(f"fused kernel ({aux_source}) trace launch "
                                 f"!= plain: max_abs_err {err}")
        worst = max(worst, err)
        del ksnaps, snaps
    bound_ms, bound_by = bound(moved / launches, ops_n / launches)
    return {"ms": dt.mean_ms(), "plain_ms": t_plain.mean_ms(),
            "max_abs_err": worst, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": moved / launches, "ops": ops_n / launches,
            "bytes_ms": moved / launches / HBM_BYTES_PER_S * 1e3,
            "ops_ms": ops_n / launches / ALU_OPS_PER_S * 1e3,
            "violations": int(mon_a["viol_total"])}


def observers_ab(cfg, warm, aux_source, rng, stat, snap, layout="wide",
                 compute="unpacked", per_group=False, reps=2) -> dict:
    """The redesigned launch against the one it replaces, in one call and
    in turns (snapshots, observers, observers, snapshots; `reps` times),
    each on a fresh copy of `warm`: device ms of one FUSED_T-tick launch
    storing the observers' per-tick snapshots `snap` (the other build)
    and of the observer build; and, host clock around a synchronised
    launch and its observers, each launch followed by the replay of its
    snapshots (fused_observe) or by the fold of its rows."""
    flags = tick_mod.make_flags(cfg)
    kw = {"layout": layout, "compute": compute}
    dev = warm.term.device
    dtimer = {"snapshots": DeviceTimer(), "observers": DeviceTimer()}
    host = {"snapshots": [], "observers": []}
    # Each form once untimed first: a kernel's first launch loads its
    # module, which waits for the card.
    warm_turns = [(form, "warm") for form in dtimer]
    turns = [(form, clock) for _ in range(reps)
             for form in ("snapshots", "observers", "observers", "snapshots")
             for clock in ("device", "host")]
    for form, clock in warm_turns + turns:
        st = pack_state(cfg, warm) if layout == "packed" else warm.clone()
        s = flat_of(cfg, st, layout)
        ops = launch_ops(cfg, aux_source, s, warm.tick, FUSED_T, rng, stat)
        tel = telemetry_mod.telemetry_zeros(dev)
        mon = telemetry_mod.monitor_zeros(GROUPS, 1, per_group=per_group,
                                          device=dev)
        on = form == "observers"
        obs = cuda_tick.kernel_observers(mon) if on else None
        prev = None if on else wide_view(cfg, st, snap)

        def launch():
            return cuda_tick.fused_tick_kernel(
                cfg, s, FUSED_T, flags, aux_source, ops, () if on else snap,
                obs=obs, **kw)
        if clock == "warm":
            launch()
            continue
        if clock == "device":
            dtimer[form].run(launch)
            continue
        sync()
        h0 = time.perf_counter()
        _, snaps = launch()
        if on:
            telemetry_mod.fold_obs_rows(obs.rows, tel, mon)
        else:
            cuda_tick.fused_observe(
                cfg, prev, cuda_tick.unpack_fused_outputs(snaps, FUSED_T),
                tel, mon)
        sync()
        host[form].append((time.perf_counter() - h0) * 1e3)
        del snaps
    return {"snapshots_ms": dtimer["snapshots"].mean_ms(),
            "observers_ms": dtimer["observers"].mean_ms(),
            "snapshots_launch_and_replay_host_ms":
                sum(host["snapshots"]) / len(host["snapshots"]),
            "observers_launch_and_fold_host_ms":
                sum(host["observers"]) / len(host["observers"])}


def fused_entry(r: dict, replaces: str) -> dict:
    """A fused kernel's entry of the kernels line from check_fused."""
    return {"source": "fused_tick_kernel.cu", "replaces": replaces,
            **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by")}}


def plain_route(cfg, ticks, aux_source, layout, compute, per_group, dev):
    """The observers' plain route on the card, the one the in-kernel
    observers replace: `ticks` ticks from boot in launches of FUSED_T
    ticks (the remainder one tick a launch) through fused_tick_plain, each
    launch's per-tick snapshots replayed by fused_observe. Returns (end
    state, recorder, raw monitor carry)."""
    flags = tick_mod.make_flags(cfg)
    rng = tick_mod.make_rng(cfg, dev)
    stat = (cuda_tick.inkernel_aux_statics(cfg, *tick_mod.split_rng(rng))
            if aux_source == "inkernel" else None)
    snap = cuda_tick.fused_snapshot_fields(cfg, telemetry=True, monitor=True,
                                           per_group=per_group)
    st = init_state(cfg, dev)
    ps = pack_state(cfg, st) if layout == "packed" else None
    s = flat_of(cfg, ps if ps is not None else st, layout)
    prev = wide_view(cfg, st, snap)
    tel = telemetry_mod.telemetry_zeros(dev)
    mon = telemetry_mod.monitor_init(GROUPS, ticks, per_group=per_group,
                                     device=dev)
    n, rem = divmod(ticks, FUSED_T)
    launches = [FUSED_T] * n + [1] * rem
    for i, T in enumerate(launches):
        t = sum(launches[:i])
        ops = launch_ops(cfg, aux_source, s, t, T, rng, stat)
        _, snaps = cuda_tick.fused_tick_plain(cfg, s, T, flags, aux_source,
                                              ops, snap, layout=layout,
                                              compute=compute)
        tks = cuda_tick.unpack_fused_outputs(snaps, T)
        tel, mon = cuda_tick.fused_observe(cfg, prev, tks, tel, mon)
        prev = tks[-1]
        del snaps, tks
    if ps is not None:
        st = unpack_state(cfg, ps)
    st.tick = ticks
    return st, tel, mon


def observer_parity(name: str, cfg, ticks: int, dev, aux_source="inkernel",
                    layout="wide", compute="unpacked", per_group=False,
                    kernel_out=None, final=None) -> dict:
    """The in-kernel observers against the plain route (plain_route) at
    full width over `ticks` ticks from boot: end state, every recorder
    counter, the monitor's latch, counts, ring, taints and (`per_group`)
    per-group counters, max_abs_err 0. `kernel_out` is the kernel route's
    (end, recorder, raw monitor), else scan_core runs it here — every fused
    launch observing in the kernel, no snapshot byte allocated. `final`, a
    make_cuda_scan main path's (recorder, finalized monitor), must equal
    the kernel route's too. Returns the leg's line."""
    out = {"leg": name, "ticks": ticks, "aux_source": aux_source,
           "layout": layout, "compute": compute}
    if kernel_out is None:
        core = cuda_scan.scan_core(cfg, ticks, telemetry=True, monitor=True,
                                   per_group=per_group, fused_ticks=FUSED_T,
                                   aux_source=aux_source, layout=layout,
                                   compute=compute, device=dev)
        (end, _, tel, mon), dt_k, launches, _ = counted(
            lambda: core(init_state(cfg, dev)))
        n = ticks // FUSED_T
        if ticks % FUSED_T or launches["fused_tick_kernel[observers]"] != n \
                or launches["fused_tick_kernel"] != n \
                or launches["snapshot_bytes"] != 0:
            raise AssertionError(f"{name}: kernel route launches {launches}")
        out["kernel_route_s"] = dt_k
    else:
        end, tel, mon = kernel_out
    t0 = time.perf_counter()
    p_end, p_tel, p_mon = plain_route(cfg, ticks, aux_source, layout,
                                      compute, per_group, dev)
    out["plain_route_s"] = time.perf_counter() - t0
    bad = states_differ(end, p_end) + [
        f"recorder {k}" for k in p_tel if not torch.equal(tel[k], p_tel[k])
    ] + [f"monitor {k}" for k in p_mon if not torch.equal(mon[k], p_mon[k])]
    if bad or set(mon) != set(p_mon) or set(tel) != set(p_tel):
        raise AssertionError(f"{name}: in-kernel observers != the plain "
                             f"route: {bad}")
    if final is not None:
        f_tel, f_mon = final
        fin = telemetry_mod.monitor_finalize(mon)
        bad = [f"recorder {k}" for k in f_tel
               if not torch.equal(f_tel[k], tel[k])] + [
            f"monitor {k}" for k in f_mon
            if not torch.equal(f_mon[k], fin[k])]
        if bad:
            raise AssertionError(f"{name}: make_cuda_scan != scan_core: {bad}")
    summary = telemetry_mod.summarize_monitor(mon)
    out.update(max_abs_err=max(max_abs_diff(tel, p_tel),
                               max_abs_diff(mon, p_mon)),
               inv_status=summary["inv_status"],
               violations=summary["violations"],
               compared=sorted(p_tel) + sorted(p_mon))
    log("[observers=plain route] " + json.dumps(out))
    return out


def staged_ms(info: dict, groups: int) -> float:
    """The tile form's own traffic through device memory (csrc/tile.cuh):
    a group's staged rows in and the written-back rows out (launch_info's
    staged_in / staged_out; 0 in the row form) over the card's memory rate.
    The tile stages only rows the bound counts (the aux, the due planes),
    so its byte floor is the bound; the state, the logs and the slot
    payloads it touches in place are the bound's too. Printed in the
    [kernel=plain] lines only: it is a byte count over a rate, not a
    measurement."""
    return groups * (info["staged_in"] + info["staged_out"]) \
        / HBM_BYTES_PER_S * 1e3


def describe(info: dict) -> str:
    """A launch description (cuda_tick.TICK_INFO) as a [build] line."""
    warps = info["blocks_per_sm"] * info["threads"] // 32
    return (f"{'tile' if info['tile'] else 'row'} form, "
            f"{info['threads']} threads, {info['smem_bytes']} B shared "
            f"memory a block, {info['blocks_per_sm']} resident blocks an SM "
            f"({warps} warps), {info['registers']} registers, "
            f"{info['local_bytes']} B local a thread, {info['blocks']} "
            f"blocks, {info['bulk_segments']} tensors bulk-copied, "
            f"{info['staged_in']} / {info['staged_out']} B a group staged in "
            f"/ out")


def launch_lines(dev) -> None:
    """[build] lines of how the one-tick kernel's (#1, #4's one-tick forms)
    and kernel #7's instantiations on the main paths run at GROUPS: the
    form, shared memory a block, resident blocks an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers and local
    bytes a thread (cudaFuncGetAttributes). Nothing is launched."""
    cases = [("headline", headline_config(GROUPS), "wide", "unpacked"),
             ("mailbox", mailbox_config(GROUPS), "wide", "unpacked")] + [
        (name, cfg, "packed", compute)
        for name, cfg in (("headline", headline_config(GROUPS)),
                          ("mailbox", mailbox_config(GROUPS)))
        for compute in tick_mod.COMPUTES] + [
        ("farm", fuzz.smoke_config(GROUPS), "wide", "unpacked")]
    for name, cfg, layout, compute in cases:
        st = init_state(cfg, dev)
        rng = tick_mod.make_rng(cfg, dev)
        base, tkeys, bkeys, scen = tick_mod.split_rng(rng)
        s = flat_of(cfg, pack_state(cfg, st) if layout == "packed" else st,
                    layout)
        shim = tick_mod.packed_shim(cfg, s, 0) if layout == "packed" else st
        aux, flags = tick_mod.make_aux(cfg, base, tkeys, bkeys, shim,
                                       scen=scen)
        log(f"[build] tick_kernel.cu {name} {layout},{compute}: " + describe(
            cuda_tick.tick_kernel_info(cfg, s, aux, flags, layout, compute)))
        if layout == "wide" and name != "farm":
            log(f"[build] fused_tick_kernel.cu #7 {name} K={K_TICK}: "
                + describe(cuda_tick.k_tick_kernel_info(
                    cfg, s, K_TICK, *k_ops(cfg, rng, s, 0, K_TICK))))
        del st, s, aux, shim


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
    info = cuda_tick.tick_kernel_info(cfg, sa, aux, flags)
    bound1, by1 = bound(moved / CHECK, body_ops(cfg, GROUPS, 1))
    what = ", ".join(w for w, on in (
        ("mailbox", cfg.uses_mailbox),
        ("scenario bank", cfg.scenario is not None)) if on)
    log(f"[kernel=plain] tick_kernel, {CHECK} ticks from tick {WARM} at "
        f"G={GROUPS}{f' ({what})' if what else ''}: bit-equal "
        f"(max_abs_err {worst}); kernel {kernel_ms:.4f} ms on the device, "
        f"plain {t_plain.mean_ms():.3f} ms; bound {bound1:.4f} ms ({by1}: "
        f"{moved / CHECK:.0f} B, {body_ops(cfg, GROUPS, 1):.3g} ops); "
        f"{'tile' if info['tile'] else 'row'} form, staged "
        f"{staged_ms(info, GROUPS):.4f} ms")
    return {"source": "tick_kernel.cu",
            "replaces": "raft_kotlin_tpu/ops/pallas_tick.py:724",
            "max_abs_err": worst, "ms": kernel_ms,
            "plain_ms": t_plain.mean_ms(), "bound_ms": bound1,
            "bound_by": by1}, a


def counted(fn):
    """Run fn with every launch, host-draw and plain-on-card count set to 0
    just before; returns (fn's result, seconds, kernel launch counts — with
    "snapshot_bytes", the per-tick snapshot bytes the fused wrapper
    allocated — , host calls: the draws and the deep path's plain read /
    write on the card)."""
    sync()
    cuda_tick.reset_launch_counts()
    deep_gather.reset_counts()
    deep_scatter.reset_counts()
    copy_floor.reset_counts()
    tick_mod.reset_call_counts()
    t0 = time.perf_counter()
    out = fn()
    sync()
    launches = {**cuda_tick.LAUNCHES, **deep_gather.LAUNCHES,
                **deep_scatter.LAUNCHES, **copy_floor.LAUNCHES,
                "snapshot_bytes": cuda_tick.SNAPSHOT_BYTES[
                    "fused_tick_kernel"]}
    calls = {**tick_mod.CALLS,
             "gather_plain_on_card": deep_gather.PLAIN_ON_CUDA["deep_gather"],
             "scatter_plain_on_card":
                 deep_scatter.PLAIN_ON_CUDA["deep_scatter"],
             "copy_floor_plain_on_card":
                 copy_floor.PLAIN_ON_CUDA["copy_floor"]}
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
    jobs = build.build_jobs(5) + [job for job in build.build_jobs(
        3, packed=False) if job not in build.build_jobs(5)]
    build.build_many(jobs)
    log(f"[build] {', '.join(f'{src} {d}' for src, d in jobs)} in "
        f"{time.perf_counter() - t0:.1f} s (in parallel)")
    for job in jobs:
        info = build.BUILD_INFO[job]
        log(f"[build] {job[0]} {job[1]}: nvcc {info['seconds']:.1f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "entry" in line:
                log(f"[build]   {line.strip()}")
    launch_lines(dev)

    # Each step's host seconds, the build included in "build".
    secs = {"build": time.perf_counter() - t0}

    def step(name, fn):
        t1 = time.perf_counter()
        out = fn(dev)
        gc.collect()
        torch.cuda.empty_cache()
        secs[name] = time.perf_counter() - t1
        return out

    # The earlier steps' tensors are gone before the deep path's two 14.3
    # GB logs (and, in 9a, a second copy).
    kernels = step("3-8 headline", headline_steps)
    for name, fn in (("10 mailbox", mailbox_steps),
                     ("13 k-tick", k_tick_steps),
                     ("12 packed", packed_steps), ("11 farm", farm_steps),
                     ("9 deep", deep_steps)):
        kernels.update(step(name, fn))
    mb = step("15 deep mailbox", deep_mailbox_steps)
    for name in ("deep_gather", "deep_scatter"):
        kernels[name]["launches_of"]["15b make_run, deep mailbox"] = \
            mb["launches"][name]
        kernels[name]["launches"] += mb["launches"][name]
    kernels["deep_gather[mailbox]"] = mb["deep_gather[mailbox]"]
    kernels.update(step("14 write floor", write_floor_steps))
    log("[timing] host s by step: " + json.dumps(secs))

    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES + k["source"],
         "replaces": k["replaces"], "launches": k["launches"],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
         "bound_by": k["bound_by"], "library_ms": k.get("library_ms"),
         **({"launches_of": k["launches_of"]} if "launches_of" in k else {})}
        for name, k in kernels.items()]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# The monitor's first violation and violation count on each main path (the
# JAX package's monitor latches the same: tests/test_torch_fused.py,
# test_torch_mailbox.py, test_torch_fuzz.py).
KNOWN_LATCH = {"headline": ("leader_completeness@t24/g44835", 175),
               "mailbox": ("leader_completeness@t37/g35421", 61),
               "farm": ("committed_prefix@t44/g11387", None),
               "farm mailbox": ("leader_completeness@t28/g40756", None)}


def check_known_latch(name: str, summary: dict) -> None:
    status, count = KNOWN_LATCH[name]
    if summary["inv_status"] != status or (
            count is not None and summary["violations"] != count):
        raise AssertionError(f"{name}: the monitor latched "
                             f"{summary['inv_status']} with "
                             f"{summary['violations']} violations, expected "
                             f"{status} ({count})")


def launch_split(cfg, end, stat, per_group=False) -> dict:
    """Where an observed in-kernel launch's time goes, stage by stage on a
    copy of the state `end`, each stage synchronised and timed by host
    clock: the key-table operands, the kernel call (observer build), the
    fold of its rows into the carry."""
    cont = end.clone()
    s = tick_mod.flatten_state(cfg, cont)
    flags = tick_mod.make_flags(cfg)
    dev = end.term.device
    tel = telemetry_mod.telemetry_zeros(dev)
    mon = telemetry_mod.monitor_init(GROUPS, SPLIT_LAUNCHES * FUSED_T,
                                     per_group=per_group, device=dev)
    stages = {"operands_ms": [], "kernel_call_ms": [], "observers_ms": []}
    for _ in range(SPLIT_LAUNCHES):
        sync()
        h = [time.perf_counter()]
        ops = cuda_tick.inkernel_aux_operands(stat, cont.tick)
        sync()
        h.append(time.perf_counter())
        obs = cuda_tick.kernel_observers(mon)
        cuda_tick.fused_tick_kernel(cfg, s, FUSED_T, flags, "inkernel", ops,
                                    obs=obs)
        sync()
        h.append(time.perf_counter())
        tel, mon = telemetry_mod.fold_obs_rows(obs.rows, tel, mon)
        sync()
        h.append(time.perf_counter())
        cont.tick += FUSED_T
        for k, x, y in zip(stages, h, h[1:]):
            stages[k].append((y - x) * 1e3)
    return {k: sum(v) / len(v) for k, v in stages.items()}


def headline_steps(dev) -> dict:
    """Steps 3-8 at the headline shape; returns the kernels' entries."""
    cfg = headline_config(GROUPS)
    rng = tick_mod.make_rng(cfg, dev)
    base, tkeys, bkeys = rng
    kernels = {}

    # -- 3. tick kernel vs plain on the card --------------------------------
    kernels["tick_kernel"], a = check_tick(cfg, rng, dev)

    # -- 4. fused kernel vs plain, both aux forms ----------------------------
    snap = cuda_tick.fused_snapshot_fields(cfg, telemetry=True, monitor=True)
    stat = cuda_tick.inkernel_aux_statics(cfg, base, tkeys, bkeys)
    for aux_source in ("staged", "inkernel"):
        trace = aux_source == "inkernel"
        r = check_fused(cfg, a, aux_source, rng, stat, snap, trace=trace)
        kernels[f"fused_tick_kernel[{aux_source}]"] = fused_entry(
            r, "raft_kotlin_tpu/ops/pallas_tick.py:999")
        log(f"[fused=plain] {aux_source}: {FUSED_LAUNCHES} launches of T="
            f"{FUSED_T} from tick {a.tick}, observers in the kernel against "
            f"fused_tick_plain + fused_observe over {list(snap)}"
            + (f", then one launch storing the trace's snapshots "
               f"{list(cuda_tick.FUSED_TRACE_FIELDS)}" if trace else "")
            + f": bit-equal (max_abs_err {r['max_abs_err']}), overflow 0; "
            + json.dumps({
                k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "bytes", "bytes_ms", "ops", "ops_ms")}))
        log(f"[observers a/b] headline {aux_source}: " + json.dumps(
            observers_ab(cfg, a, aux_source, rng, stat, snap)))

    # -- 5. main path ---------------------------------------------------------
    main_run = cuda_scan.make_cuda_scan(
        cfg, TICKS, fused_ticks=FUSED_T, aux_source="inkernel",
        telemetry=True, monitor=True, device=dev)
    (end, tel, mon), dt_main, launches, calls = counted(
        lambda: main_run(init_state(cfg, dev)))
    main_launches = launches["fused_tick_kernel"]
    expect("main path launches", launches,
           {"tick_kernel": 0, "fused_tick_kernel": TICKS // FUSED_T,
            "fused_tick_kernel[observers]": TICKS // FUSED_T})
    expect("main path host draws", calls, {"make_aux": 0,
                                           "materialize_el": 0})
    summary = telemetry_mod.summarize_monitor(mon)
    check_known_latch("headline", summary)
    leaders = int(((end.role == LEADER) & end.up).any(0).sum())
    max_commit = int(end.commit.max())
    if end.tick != TICKS or leaders <= 0 or max_commit <= 0 \
            or int(tel["commit_advances"]) <= 0:
        raise AssertionError(f"no progress: tick {end.tick}, {leaders} "
                             f"groups with a live leader, max commit "
                             f"{max_commit}")
    parity = observer_parity("headline", cfg, TICKS, dev, final=(tel, mon))
    off_run = cuda_scan.make_cuda_scan(cfg, TICKS, fused_ticks=FUSED_T,
                                       aux_source="inkernel", device=dev)
    _, dt_off, launches_off, _ = counted(
        lambda: off_run(init_state(cfg, dev)))
    expect("observers-off launches", launches_off,
           {"tick_kernel": 0, "fused_tick_kernel": TICKS // FUSED_T})
    # Where a launch's time goes, stage by stage on the continuing state,
    # each stage synchronised and timed by host clock (these launches come
    # after the counts were read).
    split = launch_split(cfg, end, stat)
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
        "groups_with_live_leader": leaders, "max_commit": max_commit,
        "commit_advances": int(tel["commit_advances"]),
        "per_launch_split": split,
        "snapshot_bytes": launches["snapshot_bytes"],
        "observers_equal_plain_route": parity["max_abs_err"] == 0}))

    # -- 6. cross-path identity over CROSS_TICKS ------------------------------
    legs = {}
    for name, aux_source, T in (("inkernel_T4", "inkernel", FUSED_T),
                                ("staged_T4", "staged", FUSED_T),
                                ("staged_T1", "staged", 1)):
        run = cuda_scan.make_cuda_scan(cfg, CROSS_TICKS, fused_ticks=T,
                                       aux_source=aux_source, telemetry=True,
                                       monitor=True, device=dev)
        if name == "staged_T4":
            # Its raw carry (per-group taints) for the plain route below.
            run = cuda_scan.scan_core(cfg, CROSS_TICKS, telemetry=True,
                                      monitor=True, fused_ticks=T,
                                      aux_source=aux_source, device=dev)
        legs[name] = counted(lambda: run(init_state(cfg, dev)))
    e, _, tl, raw = legs["staged_T4"][0]
    legs["staged_T4"] = ((e, tl, telemetry_mod.monitor_finalize(raw)),
                         *legs["staged_T4"][1:])
    rem = CROSS_TICKS % FUSED_T
    full = CROSS_TICKS // FUSED_T
    expect("inkernel_T4 launches", legs["inkernel_T4"][2],
           {"tick_kernel": 0, "fused_tick_kernel": full + rem,
            "fused_tick_kernel[observers]": full + rem})
    expect("inkernel_T4 host draws", legs["inkernel_T4"][3],
           {"make_aux": 0, "materialize_el": 0})
    expect("staged_T4 launches", legs["staged_T4"][2],
           {"tick_kernel": rem, "fused_tick_kernel": full,
            "fused_tick_kernel[observers]": full})
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
    # The staged aux form's observers against the plain route too (its
    # three-tick remainder replayed on both sides).
    observer_parity("headline staged (cross-path)", cfg, CROSS_TICKS, dev,
                    aux_source="staged", kernel_out=(e, tl, raw))
    del e, tl, raw
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
        kernels[f"fused_tick_kernel[{aux_source},mailbox]"] = fused_entry(
            r, "raft_kotlin_tpu/ops/pallas_tick.py:999")
        log(f"[mailbox fused=plain] {aux_source}: {FUSED_LAUNCHES} launches "
            f"of T={FUSED_T} from tick {a.tick}, observers in the kernel "
            f"against fused_tick_plain + fused_observe over {list(snap)}: "
            f"bit-equal (max_abs_err {r['max_abs_err']}), overflow 0; "
            + json.dumps({k: r[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "bytes",
                "bytes_ms", "ops", "ops_ms")}))
        if aux_source == "inkernel":  # the mailbox main path's form
            log(f"[observers a/b] mailbox {aux_source}: " + json.dumps(
                observers_ab(cfg, a, aux_source, rng, stat, snap)))
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
            "fused_tick_kernel[delay_draw]": TICKS // FUSED_T,
            "fused_tick_kernel[observers]": TICKS // FUSED_T})
    expect("mailbox main path host draws", calls,
           {"make_aux": 0, "materialize_el": 0})
    summary = telemetry_mod.summarize_monitor(mon)
    check_known_latch("mailbox", summary)
    observer_parity("mailbox", cfg, TICKS, dev, final=(tel, mon))
    rec = telemetry_mod.summarize_telemetry(tel)
    leaders = int(((end.role == LEADER) & end.up).any(0).sum())
    max_commit = int(end.commit.max())
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
            "fused_tick_kernel[delay_draw]": TICKS // FUSED_T})
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
        "groups_with_live_leader": leaders, "max_commit": max_commit,
        "recorder": rec,
        "per_launch_split": launch_split(cfg, end, stat),
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
           {"fused_tick_kernel": TICKS // FUSED_T,
            "fused_tick_kernel[observers]": TICKS // FUSED_T})
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
    # delay_draw runs inside the fused launches that draw the delays: its
    # row counts those (its ms is the stand-alone kernel's, 10a).
    kernels["delay_draw"].update(
        launches=launches["fused_tick_kernel[delay_draw]"],
        launches_of="fused_tick_kernel[delay_draw]")
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
# Step 13: kernel #7, the archival K-tick kernel, behind
# make_cuda_scan(k_per_launch=K), at the headline and at its mailbox.

def k_ops(cfg: RaftConfig, rng, s: dict, tick0: int, K: int,
          resets_bound=None) -> tuple:
    """A K-tick launch's staged operands from the flat state `s`: (the
    K-stacked channel slabs, el_table, b_table)."""
    base, tkeys, bkeys, scen = tick_mod.split_rng(rng)
    ops = cuda_tick.staged_operands(cfg, base, tkeys, bkeys, tick0, s, K,
                                    resets_bound, scen=scen)
    return ops, ops.pop("el_table"), ops.pop("b_table")


def check_k_tick(cfg: RaftConfig, warm, rng) -> dict:
    """K_CHECK launches of K_TICK ticks from `warm` through kernel #7 and
    through its plain version on the card: the state and the (N, G)
    overflow counts bit-equal, the counts all zero; device time, plain time
    and the bound from the launches' own data: the bytes as fused_bytes
    counts them, against the operations the launches cannot skip (one per
    live exchange and one per node a tick; body_ops' over-count would set
    this kernel's bound)."""
    a, b = warm.clone(), warm.clone()
    w = warm.clone()
    sw = tick_mod.flatten_state(cfg, w)
    cuda_tick.k_tick_kernel(cfg, sw, K_TICK, *k_ops(cfg, rng, sw, w.tick,
                                                    K_TICK))  # loads it
    del w, sw
    dt, t_plain = DeviceTimer(), Timer()
    worst, moved, ops_n = 0, 0, 0
    for i in range(K_CHECK):
        sa, sb = tick_mod.flatten_state(cfg, a), tick_mod.flatten_state(cfg, b)
        slabs, el, bt = k_ops(cfg, rng, sa, a.tick, K_TICK)
        probe_s, work = {k: v.clone() for k, v in sb.items()}, {}
        cuda_tick.k_tick_plain(cfg, probe_s, K_TICK, slabs, el, bt, work=work)
        moved += fused_bytes(cfg, sb, {**slabs, "el_table": el,
                                       "b_table": bt}, {}, work)
        ops_n += work["staged_reads"]["edge_iid"] \
            + K_TICK * cfg.n_nodes * GROUPS
        del probe_s
        ova = dt.run(lambda: cuda_tick.k_tick_kernel(cfg, sa, K_TICK, slabs,
                                                     el, bt))
        with t_plain:
            ovb = cuda_tick.k_tick_plain(cfg, sb, K_TICK, slabs, el, bt)
        err = max(max_abs_diff(sa, sb), field_err(ova, ovb))
        worst = max(worst, err)
        if err != 0 or int(ova.sum()) != 0:
            bad = [k for k in sa if not torch.equal(sa[k], sb[k])]
            raise AssertionError(f"K-tick kernel != plain or overflowed at "
                                 f"launch {i}: {bad or ['overflow']}")
        a.tick += K_TICK
        b.tick += K_TICK
    b_ms, b_by = bound(moved / K_CHECK, ops_n / K_CHECK)
    return {"source": "fused_tick_kernel.cu",
            "replaces": "raft_kotlin_tpu/ops/pallas_tick.py:1473",
            "max_abs_err": worst, "ms": dt.mean_ms(),
            "plain_ms": t_plain.mean_ms(), "bound_ms": b_ms, "bound_by": b_by,
            "bytes": moved / K_CHECK, "ops": ops_n / K_CHECK}


def k_sweep(cfg: RaftConfig, warm, rng, dev) -> dict:
    """Device ms of one launch from `warm` at each K of K_SWEEP: kernel #7,
    the one-tick kernel times K (one launch timed), and the fused kernel's
    staged form at T = K without snapshots — each on its own copy of the
    state, the three in turns, twice."""
    base, tkeys, bkeys, scen = tick_mod.split_rng(rng)
    flags = tick_mod.make_flags(cfg)
    aux, fl = tick_mod.make_aux(cfg, base, tkeys, bkeys, warm, scen=scen)
    out = {}
    for K in K_SWEEP:
        s0 = tick_mod.flatten_state(cfg, warm)
        slabs, el, bt = k_ops(cfg, rng, s0, warm.tick, K)
        fops = {**slabs, "el_table": el, "b_table": bt}
        timers = {"k_tick": DeviceTimer(), "one_tick_x_K": DeviceTimer(),
                  "fused_staged_nosnap": DeviceTimer()}
        runs = {
            "k_tick": lambda s: cuda_tick.k_tick_kernel(cfg, s, K, slabs, el,
                                                        bt),
            "one_tick_x_K": lambda s: cuda_tick.tick_kernel(cfg, s, aux, fl),
            "fused_staged_nosnap": lambda s: cuda_tick.fused_tick_kernel(
                cfg, s, K, flags, "staged", fops, ())}
        for _ in range(2):
            for name in list(runs) + list(runs)[::-1]:
                s = tick_mod.flatten_state(cfg, warm.clone())
                timers[name].run(lambda: runs[name](s))
        out[K] = {name: t.mean_ms() * (K if name == "one_tick_x_K" else 1)
                  for name, t in timers.items()}
    return out


def k_tick_steps(dev) -> dict:
    """Step 13 at headline_config() and mailbox_config(), from the tick-60
    state of the main path: (a) kernel #7 vs its plain version (kSync,
    kMail); (b) make_cuda_scan(k_per_launch=4) over 22 ticks — 5 K-tick
    launches, the 2-tick remainder through the one-tick kernel, no fused
    launch — equal to the staged T=1 runner, and with _resets_bound=1 it
    raises; (c) the device-time sweep over K (headline). Returns the
    kernels' entries."""
    kernels = {}
    for cname, cfg in (("headline", headline_config(GROUPS)),
                       ("mailbox", mailbox_config(GROUPS))):
        tag = "" if cname == "headline" else "[mailbox]"
        rng = tick_mod.make_rng(cfg, dev)
        warm = cuda_scan.make_cuda_scan(cfg, WARM, fused_ticks=FUSED_T,
                                        aux_source="inkernel", device=dev)(
            init_state(cfg, dev))
        r = check_k_tick(cfg, warm, rng)
        kernels[f"k_tick{tag}"] = r
        log(f"[k-tick=plain] {cname}: {K_CHECK} launches of K={K_TICK} from "
            f"tick {WARM}: bit-equal (max_abs_err {r['max_abs_err']}), "
            f"overflow 0; " + json.dumps({k: r[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "bytes", "ops")}))

        def k_run(**kw):
            st = warm.clone()
            cuda_scan.make_cuda_scan(cfg, K_RUN_TICKS, device=dev, **kw)(st)
            return st
        k_end, dt_k, l_k, calls_k = counted(lambda: k_run(
            k_per_launch=K_TICK))
        n_k, rem = divmod(K_RUN_TICKS, K_TICK)
        expect(f"{cname} k_per_launch={K_TICK} launches", l_k,
               {"k_tick": n_k, "tick_kernel": rem})
        t1_end, dt_1, l_1, _ = counted(lambda: k_run(fused_ticks=1,
                                                     aux_source="staged"))
        expect(f"{cname} staged T=1 launches", l_1,
               {"tick_kernel": K_RUN_TICKS})
        if states_differ(k_end, t1_end):
            raise AssertionError(f"{cname}: k_per_launch={K_TICK} != the "
                                 f"staged T=1 runner: "
                                 f"{states_differ(k_end, t1_end)}")
        kernels[f"k_tick{tag}"]["launches"] = l_k["k_tick"]
        rec = {"ticks": K_RUN_TICKS, "from_tick": WARM,
               "k_per_launch": K_TICK, "launches": l_k,
               "host_draw_calls": calls_k, "equal_to_staged_T1": True,
               "ms_per_tick": dt_k * 1e3 / K_RUN_TICKS,
               "staged_T1_ms_per_tick": dt_1 * 1e3 / K_RUN_TICKS}
        if cname == "headline":
            try:
                k_run(k_per_launch=K_TICK, _resets_bound=1)
            except RuntimeError as e:
                if "overflow" not in str(e):
                    raise
                rec["resets_bound_1_raises"] = True
            else:
                raise AssertionError("k_per_launch with _resets_bound=1 did "
                                     "not raise")
            rec["device_ms_by_K"] = k_sweep(cfg, warm, rng, dev)
        log(f"[k-tick] {cname}: " + json.dumps(rec))
        del warm, k_end, t1_end
    return kernels


# ---------------------------------------------------------------------------
# Step 12: the §14 packed layout and the §18 packed compute (kernel #4) at the
# headline and at its §10 mailbox.

def check_tick_packed(cfg: RaftConfig, warm, rng, compute: str) -> dict:
    """PACK_CHECK ticks from two packs of `warm` through the one-tick
    kernel's packed instantiation and through its plain version: the packed
    state (width latch included) and el_dirty bit-equal each tick; device
    time, plain time and the bound from the ticks' own data."""
    base, tkeys, bkeys, scen = tick_mod.split_rng(rng)

    def aux_at(sf, t):
        return tick_mod.make_aux(cfg, base, tkeys, bkeys,
                                 tick_mod.packed_shim(cfg, sf, t), scen=scen)
    kw = {"layout": "packed", "compute": compute}
    w = tick_mod.flatten_packed(cfg, pack_state(cfg, warm))
    cuda_tick.tick_kernel(cfg, w, *aux_at(w, warm.tick), **kw)  # loads it
    del w
    a, b = pack_state(cfg, warm), pack_state(cfg, warm)
    dt, t_plain = DeviceTimer(), Timer()
    worst, moved, t = 0, 0, warm.tick
    for _ in range(PACK_CHECK):
        sa = tick_mod.flatten_packed(cfg, a)
        sb = tick_mod.flatten_packed(cfg, b)
        aux, fl = aux_at(sa, t)
        da = dt.run(lambda: cuda_tick.tick_kernel(cfg, sa, aux, fl, **kw))
        probe, touched = tick_mod.unpack_flat(cfg, sb), {}
        tick_mod.phase_body(cfg, probe, aux, fl, touched=touched)
        moved += tick_bytes(cfg, sb, aux, fl, touched, "packed")
        del probe
        with t_plain:
            db = cuda_tick.tick_plain_packed(cfg, sb, aux, fl, compute)
        err = max(max_abs_diff(sa, sb), max_abs_diff({"d": da}, {"d": db}))
        worst = max(worst, err)
        if err != 0 or int(sa["ov"].sum()) != 0:
            bad = [k for k in sa if not torch.equal(sa[k], sb[k])]
            raise AssertionError(f"packed tick kernel ({compute}) != plain "
                                 f"or latched at tick {t}: "
                                 f"{bad or ['el_dirty']}")
        tick_mod.materialize_el(cfg, tkeys, sa, da)
        tick_mod.materialize_el(cfg, tkeys, sb, db)
        t += 1
    b1, by1 = bound(moved / PACK_CHECK, body_ops(cfg, GROUPS, 1))
    info = cuda_tick.tick_kernel_info(cfg, sa, aux, fl, **kw)
    return {"source": "tick_kernel.cu",
            "replaces": "raft_kotlin_tpu/ops/pallas_tick.py:724"
                        + (" (+ :135/:152)" if compute == "packed" else ""),
            "max_abs_err": worst, "ms": dt.mean_ms(),
            "plain_ms": t_plain.mean_ms(), "bound_ms": b1, "bound_by": by1,
            "bytes": moved / PACK_CHECK,
            "staged_ms": staged_ms(info, GROUPS)}


def packed_steps(dev) -> dict:
    """Step 12 at headline_config() and mailbox_config(): (a) each packed
    instantiation of the two tick kernels vs its plain version, (b) the
    packed main paths (make_cuda_scan, layout="packed", compute "packed"
    and "unpacked") vs the wide one of the same seed, and the packed
    staged and one-tick runners, (c) CPU prefix parity, (d) the rest-state
    bytes of each layout. Returns the kernels' entries."""
    kernels, paths = {}, {}
    for cname, cfg in (("headline", headline_config(GROUPS)),
                       ("mailbox", mailbox_config(GROUPS))):
        tag = ",mailbox" if cfg.uses_mailbox else ""
        drawn = {"fused_tick_kernel[delay_draw]": TICKS // FUSED_T} if cfg.uses_mailbox else {}
        rng = tick_mod.make_rng(cfg, dev)
        base, tkeys, bkeys = rng
        stat = cuda_tick.inkernel_aux_statics(cfg, base, tkeys, bkeys)
        snap = cuda_tick.fused_snapshot_fields(cfg, telemetry=True,
                                               monitor=True)

        # -- 12a. kernels vs plain, from tick WARM of the main path ---------
        warm = cuda_scan.make_cuda_scan(cfg, WARM, fused_ticks=FUSED_T,
                                        aux_source="inkernel", device=dev)(
            init_state(cfg, dev))
        for compute in tick_mod.COMPUTES:
            name = f"tick_kernel[packed,{compute}{tag}]"
            kernels[name] = check_tick_packed(cfg, warm, rng, compute)
            log(f"[packed kernel=plain] {name}, {PACK_CHECK} ticks from tick "
                f"{WARM}: bit-equal, latch 0; " + json.dumps({
                    k: kernels[name][k] for k in ("ms", "plain_ms",
                                                  "bound_ms", "bytes",
                                                  "staged_ms")}))
            for aux_source in ("staged", "inkernel"):
                r = check_fused(cfg, warm, aux_source, rng, stat, snap,
                                layout="packed", compute=compute, launches=1)
                name = f"fused_tick_kernel[{aux_source},packed,{compute}{tag}]"
                kernels[name] = fused_entry(
                    r, "raft_kotlin_tpu/ops/pallas_tick.py:999"
                    + (" (+ :135/:152)" if compute == "packed" else ""))
                log(f"[packed fused=plain] {name}: 1 launch of T={FUSED_T} "
                    f"from tick {WARM}, observers in the kernel against "
                    f"fused_tick_plain + fused_observe: bit-equal "
                    f"(max_abs_err {r['max_abs_err']}), latch 0; "
                    + json.dumps({k: r[k] for k in (
                        "ms", "plain_ms", "bound_ms", "bound_by", "bytes",
                        "ops")}))
                if (aux_source, compute) == ("inkernel", "packed"):
                    # The packed leg's A/B: its main path's form under
                    # §18's packed compute.
                    log(f"[observers a/b] {name}: " + json.dumps(
                        observers_ab(cfg, warm, aux_source, rng, stat, snap,
                                     layout="packed", compute=compute,
                                     reps=1)))
        del warm

        # -- 12b. the packed main paths vs the wide one ---------------------
        def scan(**kw):
            return cuda_scan.make_cuda_scan(cfg, TICKS, fused_ticks=FUSED_T,
                                            device=dev, **kw)
        (w_end, w_tel, w_mon), dt_wide, _, _ = counted(lambda: scan(
            aux_source="inkernel", telemetry=True, monitor=True)(
            init_state(cfg, dev)))
        check_known_latch(cname, telemetry_mod.summarize_monitor(w_mon))
        w_status = telemetry_mod.summarize_monitor(w_mon)["inv_status"]
        rec = {"wide_ms_per_tick": dt_wide * 1e3 / TICKS}
        # The wide reference of the staged and one-tick packed legs.
        cross_end = cuda_scan.make_cuda_scan(
            cfg, PACK_CROSS_TICKS, fused_ticks=FUSED_T, aux_source="inkernel",
            device=dev)(init_state(cfg, dev))
        for compute in tick_mod.COMPUTES:
            key = f"fused_tick_kernel[packed,{compute}]"
            (end, tel, mon), dt_on, launches, calls = counted(lambda: scan(
                aux_source="inkernel", telemetry=True, monitor=True,
                layout="packed", compute=compute)(init_state(cfg, dev)))
            expect(f"{cname} packed {compute} launches", launches,
                   {"fused_tick_kernel": TICKS // FUSED_T,
                    key: TICKS // FUSED_T,
                    "fused_tick_kernel[observers]": TICKS // FUSED_T,
                    **drawn})
            expect(f"{cname} packed {compute} host draws", calls,
                   {"make_aux": 0, "materialize_el": 0})
            bad = states_differ(end, w_end) + [
                f"recorder {k}" for k in tel if int(tel[k]) != int(w_tel[k])
            ] + [f"monitor {k}" for k in mon
                 if not torch.equal(mon[k], w_mon[k])]
            status = telemetry_mod.summarize_monitor(mon)["inv_status"]
            if bad or status != w_status:
                raise AssertionError(f"{cname} packed {compute} != wide: "
                                     f"{bad}, monitor {status}")
            end_off, dt_off, l_off, _ = counted(lambda: scan(
                aux_source="inkernel", layout="packed", compute=compute)(
                init_state(cfg, dev)))
            expect(f"{cname} packed {compute} observers-off launches", l_off,
                   {"fused_tick_kernel": TICKS // FUSED_T,
                    key: TICKS // FUSED_T, **drawn})
            # The staged packed launches and the one-tick packed kernel
            # (make_run), observers off, over PACK_CROSS_TICKS: end states.
            end_st, dt_st, l_st, _ = counted(lambda: cuda_scan.make_cuda_scan(
                cfg, PACK_CROSS_TICKS, fused_ticks=FUSED_T,
                aux_source="staged", layout="packed", compute=compute,
                device=dev)(init_state(cfg, dev)))
            expect(f"{cname} packed {compute} staged launches", l_st,
                   {"fused_tick_kernel": PACK_CROSS_TICKS // FUSED_T,
                    key: PACK_CROSS_TICKS // FUSED_T})
            mrun = tick_mod.make_run(cfg, PACK_CROSS_TICKS, trace=False,
                                     layout="packed", compute=compute,
                                     device=dev)
            (end_mr, _), dt_mr, l_mr, _ = counted(lambda: mrun(
                init_state(cfg, dev)))
            tkey = f"tick_kernel[packed,{compute}]"
            expect(f"{cname} packed {compute} make_run launches", l_mr,
                   {"tick_kernel": PACK_CROSS_TICKS, tkey: PACK_CROSS_TICKS})
            for leg, e, ref in (("observers off", end_off, w_end),
                                ("staged", end_st, cross_end),
                                ("make_run", end_mr, cross_end)):
                if states_differ(e, ref):
                    raise AssertionError(f"{cname} packed {compute} {leg} != "
                                         f"wide: {states_differ(e, ref)}")
            kernels[f"fused_tick_kernel[inkernel,packed,{compute}{tag}]"][
                "launches"] = launches[key]
            kernels[f"fused_tick_kernel[staged,packed,{compute}{tag}]"][
                "launches"] = l_st[key]
            kernels[f"tick_kernel[packed,{compute}{tag}]"]["launches"] = \
                l_mr[tkey]
            rec[compute] = {
                "ms_per_tick": dt_on * 1e3 / TICKS,
                "group_steps_per_sec": GROUPS * TICKS / dt_on,
                "observers_off_ms_per_tick": dt_off * 1e3 / TICKS,
                "staged_ms_per_tick": dt_st * 1e3 / PACK_CROSS_TICKS,
                "make_run_ms_per_tick": dt_mr * 1e3 / PACK_CROSS_TICKS,
                "fused_launches": launches[key], "host_draw_calls": calls,
                "width_latch": 0, "inv_status": status}
            del end, tel, mon, end_off, end_st, end_mr

        # The packed main legs' observers against the plain route.
        observer_parity(f"{cname} packed", cfg, TICKS, dev, layout="packed",
                        compute="packed")

        # -- 12c. CPU prefix parity -----------------------------------------
        t0 = time.perf_counter()
        pcfg = dataclasses.replace(cfg, n_groups=PREFIX)
        pend = cuda_scan.make_cuda_scan(
            pcfg, TICKS, fused_ticks=FUSED_T, aux_source="inkernel",
            layout="packed", compute="packed", device="cpu")(
            init_state(pcfg, "cpu"))
        bad = [k for k in pend.fields()
               if not torch.equal(getattr(pend, k),
                                  getattr(w_end, k)[..., :PREFIX].cpu())]
        if bad:
            raise AssertionError(f"{cname} packed: CPU prefix differs from "
                                 f"the card run: {bad}")
        rec["prefix_cpu_s"] = time.perf_counter() - t0

        # -- 12d. rest-state bytes ------------------------------------------
        packed = pack_state(cfg, w_end)
        wide_b = sum(getattr(w_end, k).nbytes for k in w_end.fields())
        packed_b = sum(getattr(packed, k).nbytes for k in packed.fields())
        rec["bytes"] = {"wide_per_group": wide_b / GROUPS,
                        "packed_per_group": packed_b / GROUPS,
                        "wide_total": wide_b, "packed_total": packed_b,
                        "ratio": wide_b / packed_b}
        paths[cname] = rec
        log(f"[packed main path] {cname}: " + json.dumps(rec))
        del w_end, w_tel, w_mon, packed, cross_end
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
        "fused_tick_kernel[observers]": n,
        **({"fused_tick_kernel[part_down]": n}
           if "part_kind" in rngmod.scen_layout(cfg) else {}),
        **({"fused_tick_kernel[delay_draw]": n} if cfg.uses_mailbox
           else {})})
    expect(f"{name} host draws", calls, {"make_aux": 0, "materialize_el": 0})
    summary = telemetry_mod.summarize_monitor(mon)
    check_known_latch(name.replace(" batch", ""), summary)
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


def check_farm_latch(summary: dict, farm: dict) -> dict:
    """The farm over the batch whose monitor is `summary`: one artifact
    exactly when the batch latched, and the farm's shrunk artifact (whose
    latch may have moved with its channels) confirmed by its replay on the
    card. (The batch's latch itself is the plain route's at full width:
    observer_parity.) Returns what was checked."""
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
    return {"artifact": art["status"], "horizon": art["horizon"],
            "shrink": art["shrink"], "replay_confirmed": True}


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
        r = check_fused(c, warm, "inkernel", r_, st_, sn, per_group=True)
        kernels[name] = fused_entry(r,
                                    "raft_kotlin_tpu/ops/pallas_tick.py:999")
        log(f"[farm fused=plain] {name}: {FUSED_LAUNCHES} launches of T="
            f"{FUSED_T} from tick {warm.tick}, bank rows "
            f"{list(rngmod.scen_layout(c))}, observers (per-group) in the "
            f"kernel against the plain route: bit-equal (max_abs_err "
            f"{r['max_abs_err']}), overflow 0; " + json.dumps({
                k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "bytes", "bytes_ms", "ops", "ops_ms")}))
        log(f"[observers a/b] {name}: " + json.dumps(observers_ab(
            c, warm, "inkernel", r_, st_, sn, per_group=True)))
    del mwarm
    # The bank's edge lattice alone (the drop draw and the partition
    # programs' cut masks), at the check's last tick, against its plain
    # version. The stand-alone kernel draws every edge through ScenAux's
    # drop draw (scen_drop_bits) with the threefry block inlined; the fused
    # launches, whose count the row takes, draw each live edge through the
    # same function on the out-of-line block, so they share its cut mask
    # and draw, not its speed.
    ktab = cuda_tick.inkernel_aux_operands(stat, a.tick)["ktab"]
    lead = (a.role == LEADER) & a.up
    cuda_tick.part_down(cfg, ktab, lead)  # loads the module, untimed
    dt_p, t_p = DeviceTimer(), Timer()
    for _ in range(3):
        got = dt_p.run(lambda: cuda_tick.part_down(cfg, ktab, lead))
        with t_p:
            want = cuda_tick.part_down_plain(cfg, ktab, lead)
    p_err = field_err(got, want)
    if p_err:
        raise AssertionError("part_down != its plain version")
    # One block a pair for the drop draw, two a group for the tick's key;
    # the key table and leader mask read, the (N*N, G) mask written.
    N = cfg.n_nodes
    p_bound, p_by = bound(ktab.nbytes + lead.nbytes + got.nbytes,
                          (N * N + 2) * GROUPS * THREEFRY_OPS)
    kernels["part_down"] = {
        "source": "fused_tick_kernel.cu",
        "replaces": "raft_kotlin_tpu/utils/rng.py:630",
        "max_abs_err": p_err, "ms": dt_p.mean_ms(), "plain_ms": t_p.mean_ms(),
        "bound_ms": p_bound, "bound_by": p_by}
    # The kernel's launch: blocks, threads, resident blocks an SM and the
    # registers ptxas gave it (cudaFuncGetAttributes); nothing launched.
    pi = cuda_tick.part_down_info(cfg, ktab, lead)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    log(f"[part_down=plain] tick {a.tick}, {N * N} x {GROUPS} edges through "
        f"the bank's drop rows and partition programs ({int((~got).sum())} "
        f"down): bit-equal; kernel {dt_p.mean_ms():.4f} ms, plain "
        f"{t_p.mean_ms():.3f} ms; bound {p_bound:.4f} ms ({p_by}); launch "
        f"{pi['blocks']} blocks x {pi['threads']} threads "
        f"({GROUPS / (pi['blocks'] * pi['threads']):.3f} groups a thread; "
        f"{pi['blocks'] / (sms * pi['blocks_per_sm']):.3f} waves of {sms} "
        f"SMs x {pi['blocks_per_sm']} resident blocks), "
        f"{pi['registers']} registers, {pi['local_bytes']} B local")
    del ktab, lead, got, want

    # -- 11b. the farm end to end --------------------------------------------
    runner = fuzz.make_batch_runner(cfg, TICKS, device=dev)
    (end, tel, mon), dt_main, launches, calls = counted(runner)
    g = farm_gates("farm batch", cfg, end, tel, mon, TICKS, launches, calls,
                   dev)
    observer_parity("farm", cfg, TICKS, dev, per_group=True,
                    kernel_out=(end, tel, mon))
    kernels["fused_tick_kernel[inkernel,farm]"]["launches"] = \
        launches["fused_tick_kernel"]
    # part_down runs inside the fused launches whose bank has a partition
    # program: its row counts those (its ms is the stand-alone kernel's).
    kernels["part_down"].update(
        launches=launches["fused_tick_kernel[part_down]"],
        launches_of="fused_tick_kernel[part_down]")
    t0 = time.perf_counter()
    farm = fuzz.fuzz_farm(cfg, TICKS, triage_confirm=False, device=dev)
    farm_s = time.perf_counter() - t0
    if farm["coverage"] != {k: v for k, v in g["coverage"].items()
                            if k != "partition_universes"}:
        raise AssertionError("fuzz_farm's batch != the counted batch")
    latch = check_farm_latch(g["summary"], farm)
    # Where a launch's time goes, on the continuing state: the key table,
    # the kernel call, the fold (per-group monitor).
    split = launch_split(cfg, end, stat, per_group=True)
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
        "per_launch_split": split,
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
    observer_parity("farm mailbox", mcfg, MAIL_TICKS, dev, per_group=True,
                    kernel_out=(m_end, m_tel, m_mon))
    kernels["fused_tick_kernel[inkernel,farm,mailbox]"]["launches"] = \
        launches_mb["fused_tick_kernel"]
    mfarm2 = fuzz.fuzz_farm(mcfg, MAIL_TICKS, triage_confirm=False,
                            device=dev)
    mlatch = check_farm_latch(gm["summary"], mfarm2)
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


def deep_path(module, source: str, *operands) -> str:
    """Which way a deep kernel's launch on `operands` (its launch_args)
    reads and writes, as its launcher decides: "16-byte" or
    "one-element"."""
    lib = build.load_deep_library(source)
    return ("16-byte" if module.vector_path(lib, *module.launch_args(
        *operands)) else "one-element")


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


def lanes_differing(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(G,) bool: the groups (last axis) where two same-shape tensors
    differ, swept in row chunks (a config-5 log is 14.3 GB)."""
    G = x.shape[-1]
    out = torch.zeros(G, dtype=torch.bool, device=x.device)
    for a, b in zip(x.reshape(-1, G).split(4096), y.reshape(-1, G).split(4096)):
        out |= (a != b).any(0)
    return out


def fcache_steps(cfg: RaftConfig, st, rng, ticks: int) -> list:
    """`ticks` cached ticks on `st` in place, as make_deep_scan's attempt
    runs them (refill_all once, then make_aux, phase_body(fcache=) with
    the deep scatter, finish_tick), with no rerun: each tick's (G,) OV
    flags, on the device."""
    base, tkeys, bkeys = rng
    fc = deep_cache.refill_all(cfg, st)
    flags = []
    for _ in range(ticks):
        aux, fl = tick_mod.make_aux(cfg, base, tkeys, bkeys, st)
        s = tick_mod.flatten_state(cfg, st)
        d = tick_mod.phase_body(cfg, s, aux, fl, scatter=deep_scatter.scatter,
                                fcache=fc)
        tick_mod.finish_tick(cfg, tkeys, st, s, d)
        flags.append(fc.pop("ov"))
    return flags


def fcache_full_width(cfg: RaftConfig, ref, ref_tel: dict, ref_s: float, rng,
                      dev) -> dict:
    """Step 9d at (b)'s config, ticks and rng, from boot on one second
    state (the entry rebuilt in place by init_state(out=), no clone kept).

    First the cached tick itself, stepped on that state with no OV rerun
    and timed by host clock around synchronised ends: every group that
    raised no OV flag on any tick equals (b)'s `ref` in every field (groups
    are independent, and the early top-window refill writes only stored
    values); the deep scatter launched once a tick, the deep gather never.
    Then ops/deep_cache.make_deep_scan(return_state=True, telemetry=True),
    the runner as a user calls it: its end state equals `ref` over every
    group and field and its recorder (b)'s, ov_fallbacks aside (on OV its
    published bits are the batched engine's rerun); the deep scatter once
    a tick of each pass, the deep gather once a tick of the rerun only.
    Returns the [deep fcache] line's fields."""
    ticks = ref.tick
    G = ref.term.shape[-1]
    fst = init_state(cfg, dev)
    flags, dt_c, launches_c, calls_c = counted(
        lambda: fcache_steps(cfg, fst, rng, ticks))
    expect("deep fcache cached-tick launches", launches_c,
           {"deep_scatter": ticks})
    expect("deep fcache cached-tick host calls", calls_c,
           {"make_aux": ticks, "materialize_el": ticks})
    ov_lanes = torch.stack(flags)
    ever = ov_lanes.any(0)
    hits = {}
    for t, g in ov_lanes.nonzero().tolist():
        hits.setdefault(t, []).append(g)
    differ = torch.zeros(G, dtype=torch.bool, device=dev)
    for k in STATE_FIELDS:
        differ |= lanes_differing(getattr(fst, k), getattr(ref, k))
    bad = (differ & ~ever).nonzero().flatten().tolist()
    if bad or fst.tick != ticks:
        raise AssertionError(f"the cached tick != make_run at config 5 on "
                             f"groups that raised no OV: {bad[:8]}")
    n_cmp = G - int(ever.sum())

    init_state(cfg, dev, out=fst)
    run = deep_cache.make_deep_scan(cfg, ticks, return_state=True,
                                    telemetry=True, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    (_, ov, tel), dt, launches, calls = counted(lambda: run(
        fst, rng, rebuild=lambda s: init_state(cfg, dev, out=s)))
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    runs = 2 if ov else 1
    if ov != bool(hits):
        raise AssertionError(f"make_deep_scan ov {ov}, the cached ticks' "
                             f"OV flags {hits}")
    expect("deep fcache launches", launches,
           {"deep_gather": ticks if ov else 0, "deep_scatter": runs * ticks})
    expect("deep fcache host calls", calls,
           {"make_aux": runs * ticks, "materialize_el": runs * ticks})
    errs = {k: field_err(getattr(fst, k), getattr(ref, k))
            for k in STATE_FIELDS}
    worst = max(errs.values())
    tel = telemetry_mod.summarize_telemetry(tel)
    off = [k for k in tel if k != "ov_fallbacks" and tel[k] != ref_tel[k]]
    if worst or fst.tick != ticks or off \
            or tel["ov_fallbacks"] != len(hits):
        raise AssertionError(f"make_deep_scan != make_run at config 5: "
                             f"{[k for k, v in errs.items() if v] or off}")
    del fst
    gc.collect()
    torch.cuda.empty_cache()
    return {
        "cached_tick": {
            "stepped": "refill_all, then make_aux, phase_body(fcache=), "
                       "finish_tick a tick; no rerun",
            "ms_per_tick": dt_c * 1e3 / ticks, "launches": launches_c,
            "ov_lanes_by_tick": hits,
            "groups_compared": n_cmp, "fields_compared": len(STATE_FIELDS),
            "ov_groups_differing": int((differ & ever).sum())},
        "runner": "ops/deep_cache.make_deep_scan(return_state=True, "
                  "telemetry=True)", "groups": G,
        "ticks": ticks, "ms_per_tick": dt * 1e3 / ticks,
        "make_run_ms_per_tick": ref_s * 1e3 / ticks,
        "group_steps_per_sec": G * ticks / dt,
        "ov": ov, "ov_fallbacks": tel["ov_fallbacks"],
        "launches": launches, "host_calls": calls,
        "peak_allocated_gb": peak_gb,
        "entry": "rebuilt in place on OV (init_state(out=)); a kept clone "
                 "would add the state's bytes again",
        "max_abs_err": worst, "fields_compared": len(errs),
        "recorder_equal_but_ov_fallbacks": True}


def deep_steps(dev) -> dict:
    """Step 9 at deep_config(): (b) the main deep run, (d) the
    frontier-cache runner against it, (b)'s stage split, (a) kernels vs
    plain, the kernels' times and bounds, (c) CPU prefix parity with (d)'s
    monitor leg, (e) the busy trace. Returns the two deep kernels'
    entries."""
    cfg = deep_config(GROUPS)
    N, C = cfg.n_nodes, cfg.phys_capacity
    rng = tick_mod.make_rng(cfg, dev)
    base, tkeys, bkeys = rng

    # -- 9b. the main deep run --------------------------------------------
    st = init_state(cfg, dev)
    log_gb = (st.log_term.nbytes + st.log_cmd.nbytes) / 1e9
    warm = [tick_mod.make_run(cfg, n, trace=False, telemetry=True,
                              device=dev)
            for n in (DEEP_MONITOR, DEEP_WARM - DEEP_MONITOR)]
    timed = tick_mod.make_run(cfg, DEEP_TICKS, trace=False, telemetry=True,
                              device=dev)
    torch.cuda.reset_peak_memory_stats(dev)

    def main_run():
        # (c)'s reference: the first DEEP_PREFIX columns after its
        # DEEP_MONITOR ticks, copied outside the timed spans.
        t0 = time.perf_counter()
        tel_w = [warm[0](st)[2]]
        sync()
        t1 = time.perf_counter()
        prefix = {k: getattr(st, k)[..., :DEEP_PREFIX].to("cpu", copy=True)
                  for k in STATE_FIELDS}
        t2 = time.perf_counter()
        tel_w.append(warm[1](st)[2])
        sync()
        t3 = time.perf_counter()
        tel_t = timed(st)[2]
        return tel_w, tel_t, prefix, t1 - t0 + t3 - t2, t2 - t1

    (tel_w, tel_t, prefix, dt_warm, dt_copy), dt_all, launches, calls = \
        counted(main_run)
    ticks = DEEP_WARM + DEEP_TICKS
    dt_all -= dt_copy
    dt_timed = dt_all - dt_warm
    expect("deep path launches", launches,
           {"deep_gather": ticks, "deep_scatter": ticks})
    expect("deep path host calls", calls,
           {"make_aux": ticks, "materialize_el": ticks})
    tel = sum_telemetry(*tel_w, tel_t)
    leaders = int(((st.role == LEADER) & st.up).any(0).sum())
    max_commit = int(st.commit.max())
    if st.tick != ticks or leaders <= 0 or max_commit <= 0 \
            or tel["commit_advances"] <= 0:
        raise AssertionError(f"deep path: no progress: tick {st.tick}, "
                             f"{leaders} groups with a live leader, max "
                             f"commit {max_commit}")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

    # -- 9d. the frontier-cache runner over the same ticks, before 9a and
    # the split move `st` on.
    fcache = fcache_full_width(cfg, st, tel, dt_all, rng, dev)

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
        cap["gather_path"] = deep_path(deep_gather, "deep_gather.cu",
                                       *args[:3], *cap["k_gather"], *args[3:])
        return cap["k_gather"]

    def p_gather(*args):
        with t_pg:
            cap["p_gather"] = deep_gather.gather_plain(*args)
        return cap["p_gather"]

    def k_scatter(*args):
        cap["scatter_args"] = args[2:5]
        cap["scatter_path"] = deep_path(deep_scatter, "deep_scatter.cu",
                                        *args)
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

    # -- 9c. CPU prefix parity, and 9d's monitor leg ------------------------
    # make_run and make_deep_scan with the recorder and the monitor over
    # the first DEEP_PREFIX groups over (b)'s first DEEP_MONITOR ticks, on
    # the CPU and on the card: make_run's end equals (b)'s columns after
    # them; every run's end state, recorder and monitor equal the others'
    # (bench.py:1792-1799 runs this leg at 256 groups on an accelerator).
    # The monitor sweeps each (C, G) log plane a tick: on the CPU that sets
    # this leg's depth.
    t0 = time.perf_counter()
    pcfg = deep_config(DEEP_PREFIX)
    ends, tels, mons, secs = {}, {}, {}, {}
    for where in ("cpu", dev):
        for runner in ("make_run", "make_deep_scan"):
            key = f"{runner}@{torch.device(where).type}"
            pst = init_state(pcfg, where)
            sync()
            t1 = time.perf_counter()
            if runner == "make_run":
                _, _, ptel, pmon = tick_mod.make_run(
                    pcfg, DEEP_MONITOR, trace=False, telemetry=True,
                    monitor=True,
                    device=where)(pst)
            else:
                _, pov, ptel, pmon = deep_cache.make_deep_scan(
                    pcfg, DEEP_MONITOR, return_state=True, telemetry=True,
                    monitor=True, device=where)(pst)
                key += "[ov]" if pov else ""
            sync()
            secs[key] = time.perf_counter() - t1
            ends[key] = pst
            tels[key] = telemetry_mod.summarize_telemetry(ptel)
            tels[key].pop("ov_fallbacks")
            mons[key] = telemetry_mod.summarize_monitor(pmon)
    first = next(iter(ends))
    bad = [k for k in STATE_FIELDS
           if not torch.equal(getattr(ends["make_run@cpu"], k), prefix[k])
           or any(not torch.equal(getattr(e, k).cpu(), prefix[k])
                  for e in ends.values())]
    if bad or any(tels[k] != tels[first] or mons[k] != mons[first]
                  for k in ends):
        raise AssertionError(f"deep path: the 256-group runs differ from "
                             f"the card or each other: {bad or 'observers'}")
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
                   "rows": [rows.shape[0], rows_c.shape[0]],
                   "path": cap["gather_path"]},
        "scatter": {"ms": dt_s.mean_ms(), "plain_ms": t_ps.mean_ms(),
                    "index_put_kept_ms": t_put.mean_ms(), "K": K,
                    "kept_writes": int(kept.sum()), "bytes": s_bytes,
                    "log_sectors": s_sectors, "value_sectors": v_sectors,
                    "bound_ms": s_bound, "path": cap["scatter_path"]}}))
    log(f"[deep prefix] plain CPU run and a card run of the first "
        f"{DEEP_PREFIX} groups over {DEEP_MONITOR} ticks equal the card's "
        f"columns and each other's recorder ({prefix_s:.1f} s)")
    mon = mons[first]
    log("[deep fcache monitor] " + json.dumps({
        "config": f"deep_config({DEEP_PREFIX})", "ticks": DEEP_MONITOR,
        "runs_equal": list(ends), "inv_status": mon["inv_status"],
        "violations": mon["violations"],
        "taint_restart_groups": mon["taint_restart_groups"],
        "taint_unsafe_groups": mon["taint_unsafe_groups"],
        "host_s": secs}))
    log("[deep fcache] " + json.dumps(fcache))
    # Each deep kernel's launches on the two main paths of this step: (b)
    # make_run and (d) make_deep_scan.
    of = {name: {"9b make_run": launches[name],
                 "9d make_deep_scan": fcache["launches"][name]}
          for name in ("deep_gather", "deep_scatter")}
    return {
        "deep_gather": {
            "source": "deep_gather.cu",
            "replaces": "raft_kotlin_tpu/ops/deep_gather.py:139",
            "launches": sum(of["deep_gather"].values()),
            "launches_of": of["deep_gather"], "max_abs_err": worst,
            "ms": dt_g.mean_ms(), "plain_ms": t_pg.mean_ms(),
            "bound_ms": g_bound, "bound_by": g_by,
            "library_ms": t_lib.mean_ms()},
        "deep_scatter": {
            "source": "deep_scatter.cu",
            "replaces": "raft_kotlin_tpu/ops/deep_scatter.py:263",
            "launches": sum(of["deep_scatter"].values()),
            "launches_of": of["deep_scatter"], "max_abs_err": worst,
            "ms": dt_s.mean_ms(), "plain_ms": t_ps.mean_ms(),
            "bound_ms": s_bound, "bound_by": s_by, "library_ms": None},
    }


# ---------------------------------------------------------------------------
# Step 15: the deep mailbox — BASELINE config 5 with 1-3-tick delays, the
# JAX package's mbdeep_cfg window (bench.py:1673), through both deep engines.

def sum_telemetry(*tels) -> dict:
    """Recorders of consecutive runs as one: counters add, high-waters
    take the larger."""
    return {k: max(int(t[k]) for t in tels) if k.endswith("_hw")
            else sum(int(t[k]) for t in tels) for k in tels[0]}


def deep_mailbox_steps(dev) -> dict:
    """Step 15 at deep_config() with delays [1, 3]: (b) the batched
    engine's main run, (c) the per-pair engine on a second state over the
    same ticks, (a) #6 at the mailbox batch against its plain version, (d)
    τ=0 through the per-pair engine, (e) CPU prefix parity, (f) the monitor
    leg at deep_config(DEEP_PREFIX). Returns the #6 entry at the mailbox
    batch and the deep kernels' launches on (b)."""
    cfg = dataclasses.replace(deep_config(GROUPS), delay_lo=1, delay_hi=3)
    N, C, G = cfg.n_nodes, cfg.phys_capacity, GROUPS
    ticks = MB_DEEP_WARM + MB_DEEP_TICKS
    rng = tick_mod.make_rng(cfg, dev)
    base, tkeys, bkeys = rng

    def engine_run(st, batched, what: str) -> tuple:
        """MB_DEEP_WARM then MB_DEEP_TICKS ticks of make_run(telemetry=
        True) on `st` in place, counted: (recorders, host s of the warm
        ticks, host s of all, launches, host calls, peak GB)."""
        runs = [tick_mod.make_run(cfg, n, trace=False, telemetry=True,
                                  batched=batched, device=dev)
                for n in (MB_DEEP_WARM, MB_DEEP_TICKS)]
        torch.cuda.reset_peak_memory_stats(dev)

        def go():
            t0 = time.perf_counter()
            tel_w = runs[0](st)[2]
            sync()
            dt_warm = time.perf_counter() - t0
            return tel_w, runs[1](st)[2], dt_warm

        (tel_w, tel_t, dt_warm), dt_all, launches, calls = counted(go)
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        tels = [telemetry_mod.summarize_telemetry(t) for t in (tel_w, tel_t)]
        expect(f"deep mailbox {what} host calls", calls,
               {"make_aux": ticks, "materialize_el": ticks})
        return tels, dt_warm, dt_all, launches, calls, peak

    # -- 15b. the batched engine (known-delivery batch) -------------------
    st = init_state(cfg, dev)
    state_gb = sum(getattr(st, k).nbytes for k in st.fields()) / 1e9
    slot_gb = sum(getattr(st, k).nbytes for k in MAILBOX_FIELDS) / 1e9
    if not tick_mod.make_flags(cfg).batched:
        raise AssertionError("config 5 at [1, 3] must take the batched "
                             "engine")
    tels_b, dtw_b, dt_b, launches_b, calls_b, peak_b = engine_run(
        st, None, "batched")
    expect("deep mailbox batched launches", launches_b,
           {"deep_gather": ticks, "deep_scatter": ticks})
    tel_b = sum_telemetry(*tels_b)
    leaders = int(((st.role == LEADER) & st.up).any(0).sum())
    max_commit = int(st.commit.max())
    if st.tick != ticks or leaders <= 0 or max_commit <= 0 \
            or tel_b["commit_advances"] <= 0 \
            or tel_b["mailbox_inflight_hw"] <= 0:
        raise AssertionError(f"deep mailbox: no progress: {leaders} groups "
                             f"with a live leader, max commit {max_commit}, "
                             f"recorder {tel_b}")
    prefix_b = {k: getattr(st, k)[..., :PREFIX].to("cpu", copy=True)
                for k in st.fields()}

    # -- 15c. the per-pair engine on a second state -----------------------
    st2 = init_state(cfg, dev)
    tels_p, dtw_p, dt_p, launches_p, calls_p, peak_p = engine_run(
        st2, False, "per-pair")
    expect("deep mailbox per-pair launches", launches_p, {})
    errs = {k: field_err(getattr(st2, k), getattr(st, k))
            for k in st.fields()}
    worst_c = max(errs.values())
    if worst_c or st2.tick != st.tick or tels_p != tels_b:
        raise AssertionError(
            f"deep mailbox: per-pair != batched at config 5: "
            f"{[k for k, v in errs.items() if v] or 'recorder'}")
    if peak_p > 2 * state_gb + 2:
        raise AssertionError(f"the per-pair engine peaked at {peak_p:.2f} "
                             f"GB beside two {state_gb:.2f} GB states")
    del st2
    gc.collect()
    torch.cuda.empty_cache()

    # -- 15a. #6 at the mailbox batch, on one tick of the main state -------
    t_k, t_p, t_lib, cap = DeviceTimer(), Timer(), DeviceTimer(), {}

    def k_gather(lt, lc, rows, N_, C_, Rc):
        for _ in range(3):
            vals = t_k.run(lambda: deep_gather.gather(lt, lc, rows, N_, C_,
                                                      Rc))
        with t_p:
            plain = deep_gather.gather_plain(lt, lc, rows, N_, C_, Rc)
        rows_c = deep_gather.cmd_rows(rows, N_, Rc)
        lt3, lc3 = lt.view(N_, C_, -1), lc.view(N_, C_, -1)
        it, ic = rows.view(N_, -1, G).long(), rows_c.view(N_, -1, G).long()
        for _ in range(3):
            lib = t_lib.run(lambda: (torch.gather(lt3, 1, it),
                                     torch.gather(lc3, 1, ic)))
        cap.update(
            rows=rows, rows_c=rows_c, Rc=Rc, vals=vals,
            err=max(field_err(vals[0], plain[0]), field_err(vals[1],
                                                            plain[1])),
            lib_err=max(field_err(lib[0].view_as(vals[0]), vals[0]),
                        field_err(lib[1].view_as(vals[1]), vals[1])),
            path=deep_path(deep_gather, "deep_gather.cu", lt, lc, rows,
                           *vals, N_, C_, Rc))
        return vals

    aux, fl = tick_mod.make_aux(cfg, base, tkeys, bkeys, st)
    s = tick_mod.flatten_state(cfg, st)
    d = tick_mod.phase_body(cfg, s, aux, fl, gather=k_gather,
                            scatter=deep_scatter.scatter)
    tick_mod.finish_tick(cfg, tkeys, st, s, d)
    if cap["err"] or cap["lib_err"] or cap["Rc"] != 3 * N \
            or cap["rows"].shape[0] != N * (6 * N + 1):
        raise AssertionError(f"deep gather at the mailbox batch != plain "
                             f"({cap['err']}) or torch.gather "
                             f"({cap['lib_err']}); rows "
                             f"{tuple(cap['rows'].shape)}, Rc {cap['Rc']}")
    elt = st.log_term.element_size()
    rows, rows_c = cap["rows"], cap["rows_c"]
    vt, vc = cap["vals"]
    g_sectors = (log_sectors(rows, N, C, G, elt)
                 + log_sectors(rows_c, N, C, G, elt))
    g_bytes = rows.nbytes + vt.nbytes + vc.nbytes + 32 * g_sectors
    g_bound, g_by = bound(g_bytes, DEEP_OPS_PER_ELEMENT
                          * (vt.numel() + vc.numel()))
    del cap["vals"], cap["rows"], cap["rows_c"], rows, rows_c, vt, vc

    # -- 15d. τ=0 through the per-pair engine, on the same memory ---------
    cfg0 = dataclasses.replace(cfg, delay_lo=0)
    if tick_mod.make_flags(cfg0, batched=True).batched:
        raise AssertionError("τ=0 must pin the per-pair engine")
    init_state(cfg0, dev, out=st)
    run0 = tick_mod.make_run(cfg0, MB_DEEP_TAU0, trace=False, telemetry=True,
                             device=dev)
    (_, _, tel0), dt_0, launches_0, calls_0 = counted(lambda: run0(st))
    expect("deep mailbox τ=0 launches", launches_0, {})
    expect("deep mailbox τ=0 host calls", calls_0,
           {"make_aux": MB_DEEP_TAU0, "materialize_el": MB_DEEP_TAU0})
    tel0 = telemetry_mod.summarize_telemetry(tel0)
    leaders0 = int(((st.role == LEADER) & st.up).any(0).sum())
    if leaders0 <= 0 or tel0["mailbox_inflight_hw"] <= 0:
        raise AssertionError(f"deep mailbox τ=0: no progress: {tel0}")
    prefix_0 = {k: getattr(st, k)[..., :PREFIX].to("cpu", copy=True)
                for k in st.fields()}
    del st, s, aux, d
    gc.collect()
    torch.cuda.empty_cache()

    # -- 15e. CPU prefix parity -------------------------------------------
    t0 = time.perf_counter()
    for c, n, want in ((cfg, ticks, prefix_b), (cfg0, MB_DEEP_TAU0,
                                                prefix_0)):
        pcfg = dataclasses.replace(c, n_groups=PREFIX)
        pst = init_state(pcfg, "cpu")
        tick_mod.make_run(pcfg, n, trace=False, device="cpu")(pst)
        bad = [k for k in pst.fields()
               if not torch.equal(getattr(pst, k), want[k])]
        if bad:
            raise AssertionError(f"deep mailbox (delay_lo {c.delay_lo}): "
                                 f"the CPU's first {PREFIX} groups differ "
                                 f"from the card's: {bad}")
    prefix_s = time.perf_counter() - t0

    # -- 15f. the monitor leg at deep_config(DEEP_PREFIX) ------------------
    mcfg = dataclasses.replace(cfg, n_groups=DEEP_PREFIX)
    ends, tels, mons, secs = {}, {}, {}, {}
    for where in ("cpu", dev):
        for engine, batched in (("batched", None), ("per-pair", False)):
            key = f"{engine}@{torch.device(where).type}"
            pst = init_state(mcfg, where)
            sync()
            t1 = time.perf_counter()
            _, _, ptel, pmon = tick_mod.make_run(
                mcfg, MB_DEEP_MONITOR, trace=False, telemetry=True,
                monitor=True, batched=batched, device=where)(pst)
            sync()
            secs[key] = time.perf_counter() - t1
            ends[key] = pst
            tels[key] = telemetry_mod.summarize_telemetry(ptel)
            mons[key] = telemetry_mod.summarize_monitor(pmon)
    first = next(iter(ends))
    bad = [k for k in ends[first].fields()
           if any(not torch.equal(getattr(e, k).cpu(),
                                  getattr(ends[first], k))
                  for e in ends.values())]
    if bad or any(tels[k] != tels[first] or mons[k] != mons[first]
                  for k in ends):
        raise AssertionError(f"deep mailbox monitor leg: the runs differ: "
                             f"{bad or 'observers'}")
    del ends
    gc.collect()
    torch.cuda.empty_cache()

    timed_b, timed_p = dt_b - dtw_b, dt_p - dtw_p
    log("[deep mailbox] " + json.dumps({
        "config": "dataclasses.replace(deep_config(), delay_lo=1, "
                  "delay_hi=3): BASELINE config 5 (bench.py:1441-1444) "
                  "with mbdeep_cfg's window (bench.py:1673)",
        "groups": G, "nodes": N, "log_capacity": C,
        "log_dtype": cfg.log_dtype, "state_gb": state_gb,
        "slot_planes_gb": slot_gb,
        "batched": {
            "runner": "ops/tick.make_run(telemetry=True)",
            "warm_ticks": MB_DEEP_WARM, "timed_ticks": MB_DEEP_TICKS,
            "ms_per_tick": timed_b * 1e3 / MB_DEEP_TICKS,
            "group_steps_per_sec": G * MB_DEEP_TICKS / timed_b,
            "warm_ms_per_tick": dtw_b * 1e3 / MB_DEEP_WARM,
            "peak_allocated_gb": peak_b, "launches": launches_b,
            "host_calls": calls_b, "groups_with_live_leader": leaders,
            "max_commit": max_commit, "recorder": tel_b},
        "per_pair": {
            "runner": "ops/tick.make_run(telemetry=True, batched=False)",
            "ms_per_tick": timed_p * 1e3 / MB_DEEP_TICKS,
            "group_steps_per_sec": G * MB_DEEP_TICKS / timed_p,
            "warm_ms_per_tick": dtw_p * 1e3 / MB_DEEP_WARM,
            "peak_allocated_gb": peak_p,
            "peak_over_two_states_gb": peak_p - 2 * state_gb,
            "launches": launches_p,
            "equal_to_batched": {"groups": G, "fields": len(errs),
                                 "max_abs_err": worst_c,
                                 "recorder_equal": True}},
        "tau0": {
            "config": "delay_lo=0, delay_hi=3 (per-pair engine)",
            "ticks": MB_DEEP_TAU0, "ms_per_tick": dt_0 * 1e3 / MB_DEEP_TAU0,
            "group_steps_per_sec": G * MB_DEEP_TAU0 / dt_0,
            "launches": launches_0, "groups_with_live_leader": leaders0,
            "recorder": tel0}}))
    log("[deep mailbox kernel=plain] " + json.dumps({
        "from_tick": ticks, "Rt": 6 * N + 1, "Rc": cap["Rc"],
        "max_abs_err": cap["err"], "ms": t_k.mean_ms(),
        "plain_ms": t_p.mean_ms(), "library_ms": t_lib.mean_ms(),
        "library_max_abs_err": cap["lib_err"], "bytes": g_bytes,
        "sectors": g_sectors, "bound_ms": g_bound, "path": cap["path"]}))
    log(f"[deep mailbox prefix] plain CPU runs of the first {PREFIX} groups "
        f"equal the card's columns after (b)'s {ticks} ticks and (d)'s "
        f"{MB_DEEP_TAU0} ({prefix_s:.1f} s)")
    mon = mons[first]
    log("[deep mailbox monitor] " + json.dumps({
        "config": f"deep_config({DEEP_PREFIX}) with delays [1, 3]",
        "ticks": MB_DEEP_MONITOR, "runs_equal": list(mons),
        "inv_status": mon["inv_status"], "violations": mon["violations"],
        "taint_restart_groups": mon["taint_restart_groups"],
        "taint_unsafe_groups": mon["taint_unsafe_groups"],
        "recorder": tels[first], "host_s": secs}))
    return {
        "launches": launches_b,
        "deep_gather[mailbox]": {
            "source": "deep_gather.cu",
            "replaces": "raft_kotlin_tpu/ops/deep_gather.py:139",
            "launches": launches_b["deep_gather"],
            "launches_of": {"15b make_run, deep mailbox":
                            launches_b["deep_gather"]},
            "max_abs_err": cap["err"], "ms": t_k.mean_ms(),
            "plain_ms": t_p.mean_ms(), "bound_ms": g_bound,
            "bound_by": g_by, "library_ms": t_lib.mean_ms()}}


# ---------------------------------------------------------------------------
# Step 14: kernel #8, the whole-log copy floor, and the write-floor probe at
# BASELINE config 5's full width.

def write_floor_steps(dev) -> dict:
    """Step 14, after the deep path has freed its logs: (a) the copy kernel
    vs its plain version at odd shapes (int16 from a 2-byte-misaligned
    start, int32), both leaving the logs bit-equal to themselves; (b) the
    probe's logs at config 5's full width (102,400 x 7 x 10,000 int16):
    their int64 sums and first and last rows unchanged by the copy floor's
    21 applications, its time at or above its byte bound; (c) the probe's
    lines (probe_write_floor: copy_floor with torch's copy_ beside it, the
    deep scatter on clustered and uniform rows, the K sweep). Returns the
    copy floor's entry."""
    worst = 0
    for (rows, G), dtype in zip(FLOOR_ODD, (torch.int16, torch.int32)):
        off = 1 if dtype == torch.int16 else 0
        gen = torch.Generator(device=dev).manual_seed(rows)
        buf = torch.randint(0, 90, (2, rows * G + off), dtype=dtype,
                            device=dev, generator=gen)
        lt, lc = (x[off:].view(rows, G) for x in buf)
        want_t, want_c = lt.clone(), lc.clone()
        copy_floor.copy_floor(lt, lc)
        pt, pc = lt.clone(), lc.clone()
        copy_floor.copy_floor_plain(pt, pc)
        sync()
        worst = max(worst, field_err(lt, pt), field_err(lc, pc),
                    field_err(lt, want_t), field_err(lc, want_c))
        if worst:
            raise AssertionError(f"copy_floor != plain at {dtype}{(rows, G)}")
        del buf, lt, lc, want_t, want_c, pt, pc
    log(f"[write floor=plain] copy_floor at {list(FLOOR_ODD)} (int16 from a "
        f"2-byte-misaligned start, int32): bit-equal to the plain version "
        f"and to the logs before (max_abs_err {worst})")

    cfg = deep_config(GROUPS)
    N, C = cfg.n_nodes, cfg.phys_capacity
    lt, lc = probe.make_logs(GROUPS, C, N, dev)

    def digest():
        # int64 sums over 1,000-row chunks (0.8 GB widened at a time): one
        # sum over a whole log would widen all 7.2e9 elements (57 GB).
        return [sum(int(x[r:r + 1000].sum(dtype=torch.int64))
                    for r in range(0, x.shape[0], 1000)) for x in (lt, lc)] + [
            x[i].clone() for x in (lt, lc) for i in (0, -1)]
    before = digest()
    lines, dt_p, launches, calls = counted(
        lambda: [probe.time_copy_floor(lt, lc)])
    after = digest()
    if before[:2] != after[:2] or not all(
            torch.equal(x, y) for x, y in zip(before[2:], after[2:])):
        raise AssertionError("copy_floor changed the full-size logs")
    floor = lines[0]
    if floor["ms"] < floor["bound_ms"]:
        raise AssertionError(f"copy_floor took {floor['ms']:.3f} ms, under "
                             f"its byte bound {floor['bound_ms']:.3f}: the "
                             f"stores did not all happen")
    expect("write floor launches", launches,
           {"copy_floor": probe.APPLICATIONS + 1})
    expect("write floor plain calls", calls, {})
    plain = Timer()
    with plain:
        copy_floor.copy_floor_plain(lt, lc)
    plain_ms = plain.mean_ms()
    smi = probe.card_name()
    for line in [floor, *probe.scatter_lines(lt, lc, N, C, 8)]:
        log("[write floor] " + json.dumps({**line, "device": smi}))
    del lt, lc
    return {"copy_floor": {
        "source": "copy_floor.cu",
        "replaces": "scripts/probe_write_floor.py:89",
        "launches": launches["copy_floor"], "max_abs_err": worst,
        "ms": floor["ms"], "plain_ms": plain_ms,
        "bound_ms": floor["bound_ms"], "bound_by": "bytes",
        "library_ms": floor["library_ms"]}}

if __name__ == "__main__":
    sys.exit(main())
