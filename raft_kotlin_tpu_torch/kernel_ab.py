"""Device time of the port's kernels built from several source trees, on
one card, in one process — the way to compare two versions of a kernel
(host-bound numbers and even device clocks drift from one machine to the
next, so versions are compared only within one run).

    python -m raft_kotlin_tpu_torch.kernel_ab NAME=CSRC [NAME=CSRC ...]

Each CSRC is a kernel source directory laid out as
raft_kotlin_tpu_torch/ops/csrc (for another commit:
`git archive <commit> raft_kotlin_tpu_torch/ops/csrc | tar -x -C DIR`,
then DIR/raft_kotlin_tpu_torch/ops/csrc). Every tree's tick_kernel.cu,
and its fused_tick_kernel.cu where it has one, is built with the port's
nvcc flags, all at once; ptxas's register and spill lines are printed, and for
trees whose one-tick or K-tick library describes its launch
(`raft_tick_info` / `raft_k_tick_info`) the form, shared memory a block,
resident blocks an SM, registers and local bytes.

At the headline shape (102,400 groups by default; `--config mailbox`:
bench.py's §10 mailbox stage, utils/config.mailbox_config — every tree
must then take the mailbox's operands; `--config farm`: the farm's
three-node universes, api/fuzz.smoke_config, its bank's masks staged
(a bank with leader programs cannot be staged ahead of its ticks, so its
fused launches are timed with in-kernel draws only); `--config
farm_mailbox`: the farm's mailbox regime, farm_mailbox_config),
from a state warmed 60 ticks; with `--layout
packed` every tree is built for the §14 packed layout (-DRAFT_PACKED=1)
and runs on a pack of that state, with `--compute` (§18) "unpacked" or
"packed":

- one-tick kernel: `--ticks` ticks, each launched once per tree on a copy
  of the same state with the same staged aux, in the order A B ... B A
  repeated `--reps` times; every tree's result must equal the port's own
  kernel (el_dirty and every state field);
- fused kernel (trees that have it): one launch per (aux source, T,
  snapshots on/off) on copies of the state warmed 60 ticks (the one-tick
  comparison's start, not its end, so that both layouts time the same
  state), in the same order, and every result equal to the first such
  tree's; and, for trees with the fused kernel's observer build, one
  launch of it per (aux source, T) as key "<aux>/T<T>/observers" (a fresh
  monitor carry, the launch's rows and carry compared too); under the wide layout, kernel #7 (the K-tick kernel, trees whose
  fused library has `raft_k_tick_launch`) at K = T on the same staged
  operands, as key "staged/T<T>/k_tick" — so one call times the one-tick,
  the K-tick and the no-snapshot fused kernels from one state.

With `--deep`, the deep-log kernels instead: every tree's deep_gather.cu
(#6) and deep_scatter.cu (#5), built at once, at BASELINE config 5
(utils/config.deep_config, 102,400 groups by default) on the operands of
one tick of ops/tick.make_run from a state warmed DEEP_WARM ticks, as
chip_smoke.py's step 9a captures them. Each tree's gather runs on the
tick's logs and rows and must equal the port's own kernel's values; each
tree's scatter runs on a copy of the tick's logs before its writes and must
leave both logs equal to the port's own kernel's. Then each tree's launch
is timed in turns A B ... B A, `--reps` times (the scatter on the logs
that already hold the writes: it stores the same values again). Then the
gather alone again at the known-delivery mailbox batch (Rt = 6N+1 term
rows, Rc = 3N cmd rows a node), on a tick of config 5 with 1-3-tick
delays captured the same way: every tree's term values must equal the
port's, and whether its cmd values do lands under "info" (Rc is the C
interface's last int, so a tree built before it took Rc runs, but reads N
cmd rows a node). Every tree's C interface takes the port's pointers and
ints (ops/deep_gather.launch_args, ops/deep_scatter.launch_args). The
16-byte path or the one-element one, as each tree's launcher reports it
(trees without `raft_deep_*_vector`: none), lands under "info".

With `--draws`, the two stand-alone draws of kernel #3 instead: every
tree's fused_tick_kernel.cu, built at three nodes (wide, no observers),
all at once. `part_down_kernel` (the §12 edge lattice: the drop draw and
the partition programs' cut masks) runs on one tick's key table and
live-leader mask at the farm's shape (api/fuzz.smoke_config, 102,400
universes by default), captured after DRAW_WARM ticks of the in-kernel
runner as chip_smoke.py's step 11(a) captures them; `delay_draw_kernel`
on a capture of the farm's mailbox regime (`farm_mailbox_config`:
1-4-tick delays, the bank's per-universe windows). Every tree's output
must equal the port's own kernel's (cuda_tick.part_down / delay_draw),
and every tree runs on the port's pointers and ints (cuda_tick.
part_down_args / delay_draw_args). Each is timed in turns A B ... B A,
`--reps` times with DeviceTimer. The part_down launch's geometry is
printed where the tree's library describes it (`raft_part_down_info`),
and ptxas's counts of every entry function in the [build] lines.

Device time by CUDA events around a launch queued behind a spinning card
(utils/timing.DeviceTimer). `--fused-t none` skips the fused and K-tick
comparisons. Prints one line per measurement and, last, a JSON object
{"device": ..., "tick": {tree: ms}, "fused": {key: {tree: ms}}, "info":
{kernel: {tree: {...}}}} (`--deep`: {"device": ..., "deep": {"gather":
{tree: ms}, "scatter": {tree: ms}, "gather_mailbox": {tree: ms}}, "info":
...}; `--draws`: {"device":
..., "draws": {"part_down": {tree: ms}, "delay_draw": {tree: ms}},
"info": ...}), also written to `--out` when given.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import dataclasses
import gc
import json
import pathlib
import subprocess
import sys
from typing import Optional

import torch

from raft_kotlin_tpu_torch.constants import LEADER
from raft_kotlin_tpu_torch.models.state import (
    init_state, pack_state, unpack_state)
from raft_kotlin_tpu_torch.ops import (
    build, cuda_tick, deep_gather, deep_scatter)
from raft_kotlin_tpu_torch.ops import tick as tick_mod
from raft_kotlin_tpu_torch.ops.cuda_scan import make_cuda_scan
from raft_kotlin_tpu_torch.utils import telemetry as telemetry_mod
from raft_kotlin_tpu_torch.api.fuzz import smoke_config
from raft_kotlin_tpu_torch.utils.config import (
    deep_config, headline_config, mailbox_config)
from raft_kotlin_tpu_torch.utils.timing import DeviceTimer


def farm_mailbox_config(groups: int):
    """The farm's mailbox regime (scripts/fuzz_farm.py --delay 1 4): the
    smoke config with 1-4-tick delays in the bank's per-universe windows,
    as chip_smoke.py's step 11 runs it."""
    cfg = smoke_config(groups)
    return dataclasses.replace(
        cfg, delay_lo=1, delay_hi=4,
        scenario=dataclasses.replace(cfg.scenario, delay_windows=True))


CONFIGS = {"headline": headline_config, "mailbox": mailbox_config,
           "farm": smoke_config, "farm_mailbox": farm_mailbox_config}

WARM = 60
# --deep: ticks of make_run before the captured tick (chip_smoke.py's step
# 9 warms 30), and the log rows a chunk of the scatter's log comparison.
DEEP_WARM = 30
DEEP_CHUNK = 2_000
# --draws: ticks of the in-kernel runner before the captured tick.
DRAW_WARM = 30


OBSERVE = "fused_tick_kernel.cu[observe]"


def _print_build(name: str, key: str, csrc, src: str, dfs: tuple) -> None:
    """The [build] line of one of a tree's libraries: nvcc's time and
    ptxas's entry, register and spill lines."""
    info = build.BUILD_INFO[(src if csrc == build.CSRC else str(csrc / src),
                             dfs)]
    lines = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln or "entry" in ln]
    print(f"[build] {name} {key}: nvcc {info['seconds']:.1f} s; "
          + " | ".join(lines), flush=True)


def _libs(trees: dict, n_nodes: int, packed: bool = False,
          observers: bool = True,
          sources: tuple = build.KERNEL_SOURCES) -> dict:
    """Build every tree's kernels in parallel; {tree: {source: CDLL}}, the
    fused kernel's observer build (trees whose source has one, unless
    `observers` is False) under OBSERVE. `sources`: which of
    KERNEL_SOURCES."""
    defines = build.tick_defines(n_nodes, packed)
    jobs = {}
    for name, csrc in trees.items():
        jobs[name] = [(s, defines) for s in sources if (csrc / s).exists()]
        fused = csrc / "fused_tick_kernel.cu"
        if observers and "fused_tick_kernel.cu" in sources \
                and fused.exists() \
                and "RAFT_OBSERVE" in fused.read_text():
            jobs[name].append(("fused_tick_kernel.cu", build.tick_defines(
                n_nodes, packed, observe=True)))
    firsts = {}  # one build per directory
    for nm, csrc in trees.items():
        firsts.setdefault(csrc, nm)
    with concurrent.futures.ThreadPoolExecutor(len(firsts)) as ex:
        built = dict(zip(firsts, ex.map(
            lambda d: build.build_many(jobs[firsts[d]], d), firsts)))
    paths = {nm: built[csrc] for nm, csrc in trees.items()}
    out = {}
    for name, csrc in trees.items():
        out[name] = {}
        for (src, dfs), path in zip(jobs[name], paths[name]):
            key = OBSERVE if "RAFT_OBSERVE=1" in dfs else src
            _print_build(name, key, csrc, src, dfs)
            out[name][key] = ctypes.CDLL(str(path))
            if key == "tick_kernel.cu":
                build.bind_tick_library(out[name][key])
            elif key == "fused_tick_kernel.cu" and hasattr(
                    out[name][key], "raft_k_tick_info"):
                fn = out[name][key].raft_k_tick_info
                fn.argtypes = [ctypes.c_void_p] * 3
                fn.restype = ctypes.c_int
    return out


def _flat_copy(s: dict) -> dict:
    return {k: v.clone() for k, v in s.items()}


def _differ(a: dict, b: dict) -> list:
    return [k for k in a if not torch.equal(a[k], b[k])]


def _run_trees(names: list, reps: int, timers: dict, warm: bool,
               launch) -> None:
    """launch(name) -> result dict, for each tree in the order A B .. B A,
    `reps` times, timed; with `warm`, each tree first once, untimed (a
    kernel's first launch loads it and waits for the card). Every result
    must equal the first one's."""
    first = None
    order = (names if warm else []) + (names + names[::-1]) * reps
    for i, nm in enumerate(order):
        if warm and i < len(names):
            got = launch(nm, None)
        else:
            got = launch(nm, timers[nm])
        if first is None:
            first = got
        elif _differ(got, first):
            raise AssertionError(f"tree {nm} differs from {order[0]}: "
                                 f"{_differ(got, first)}")


def _flat(cfg, state, layout: str) -> dict:
    """The flat dict the kernels of `layout` take of `state` (views; under
    the packed layout, of the PackedRaftState `state`)."""
    return (tick_mod.flatten_packed if layout == "packed"
            else tick_mod.flatten_state)(cfg, state)


def compare_tick(cfg, libs: dict, state, ticks: int, reps: int,
                 layout: str = "wide", compute: str = "unpacked",
                 info: Optional[dict] = None) -> dict:
    """Mean device ms of each tree's one-tick kernel over `ticks` ticks; the
    state (a PackedRaftState under the packed layout) advances through the
    port's own kernel, which every tree must equal. `info` collects each
    tree's launch description ({"tick": {tree: {...}}})."""
    info = {} if info is None else info
    dev = state.term.device
    base, tkeys, bkeys, scen = tick_mod.split_rng(
        tick_mod.make_rng(cfg, dev))
    names = list(libs)
    timers = {nm: DeviceTimer() for nm in names}
    kw = {"layout": layout, "compute": compute}
    for i in range(ticks):
        s = _flat(cfg, state, layout)
        shim = (tick_mod.packed_shim(cfg, s, state.tick)
                if layout == "packed" else state)
        aux, flags = tick_mod.make_aux(cfg, base, tkeys, bkeys, shim,
                                       scen=scen)
        if i == 0:
            ptrs, ints, _ = cuda_tick.tick_launch_args(cfg, s, aux, flags,
                                                       **kw)
            for nm in names:
                fn = getattr(libs[nm]["tick_kernel.cu"], "raft_tick_info",
                             None)
                if fn is not None:
                    info.setdefault("tick", {})[nm] = cuda_tick.launch_info(
                        fn, ptrs, ints, dev, f"{nm} tick kernel")
                    print(f"[info] tick {nm}: "
                          + json.dumps(info["tick"][nm]), flush=True)
        pre = _flat_copy(s)
        # Advances the state.
        dirty = cuda_tick.tick_kernel(cfg, s, aux, flags, **kw)

        def launch(nm, timer):
            sv = _flat_copy(pre)
            ptrs, ints, dv = cuda_tick.tick_launch_args(cfg, sv, aux, flags,
                                                        **kw)
            fn = libs[nm]["tick_kernel.cu"].raft_tick_launch
            call = lambda: cuda_tick.launch_library(  # noqa: E731
                fn, ptrs, ints, dev, f"{nm} tick kernel")
            if timer:
                timer.run(call)
            else:
                call()
            return {**sv, "el_dirty": dv}

        _run_trees(names, reps, timers, i == 0, launch)
        bad = _differ({**s, "el_dirty": dirty}, launch(names[0], None))
        if bad:
            raise AssertionError(f"tree {names[0]} differs from the port's "
                                 f"tick kernel: {bad}")
        tick_mod.materialize_el(cfg, tkeys, s, dirty)
        state.tick += 1
    return {nm: timers[nm].mean_ms() for nm in names}


def compare_fused(cfg, libs: dict, state, Ts: list, reps: int,
                  layout: str = "wide", compute: str = "unpacked",
                  info: Optional[dict] = None) -> dict:
    """Mean device ms of one fused launch per (aux source, T, snapshots)
    and tree, from `state` (packed under the packed layout); every tree's
    result (state, overflow, snapshots) equal to the first's."""
    names = [nm for nm in libs if "fused_tick_kernel.cu" in libs[nm]]
    dev = state.term.device
    base, tkeys, bkeys, scen = tick_mod.split_rng(
        tick_mod.make_rng(cfg, dev))
    stat = cuda_tick.inkernel_aux_statics(cfg, base, tkeys, bkeys, scen)
    flags = tick_mod.make_flags(cfg)
    headline_snaps = cuda_tick.fused_snapshot_fields(cfg, telemetry=True,
                                                     monitor=True)
    s = _flat(cfg, state, layout)
    out = {}
    staged_ok = cfg.scenario is None or not cfg.scenario.needs_state
    for aux_source in cuda_tick.AUX_SOURCES:
        if aux_source == "staged" and not staged_ok:
            continue
        for T in Ts:
            if aux_source == "inkernel":
                ops = cuda_tick.inkernel_aux_operands(stat, state.tick)
            else:
                ops = cuda_tick.staged_operands(cfg, base, tkeys, bkeys,
                                                state.tick, s, T, scen=scen)
            for snap_name, snap in (("snap", headline_snaps), ("nosnap", ())):
                key = f"{aux_source}/T{T}/{snap_name}"

                def launch(nm, timer):
                    sv = _flat_copy(s)
                    tensors, ints, ov, snaps = cuda_tick.fused_operands(
                        cfg, sv, T, flags, aux_source, ops, snap, layout,
                        compute)
                    ptrs = [None if x is None else x.data_ptr()
                            for x in tensors]
                    fn = libs[nm]["fused_tick_kernel.cu"].raft_fused_launch
                    call = lambda: cuda_tick.launch_library(  # noqa: E731
                        fn, ptrs, ints, dev, f"{nm} fused kernel")
                    if timer:
                        timer.run(call)
                    else:
                        call()
                    return {**sv, "overflow": ov,
                            **{f"snap:{k}": v for k, v in snaps.items()}}

                timers = {nm: DeviceTimer() for nm in names}
                _run_trees(names, reps, timers, True, launch)
                out[key] = {nm: timers[nm].mean_ms() for nm in names}
                print(f"[fused] {key}: " + json.dumps(out[key]), flush=True)
            o_names = [nm for nm in names if OBSERVE in libs[nm]]
            if o_names:
                key = f"{aux_source}/T{T}/observers"
                out[key] = compare_observers(cfg, libs, o_names, s, T,
                                             aux_source, ops, reps, layout,
                                             compute)
                print(f"[fused] {key}: " + json.dumps(out[key]), flush=True)
            k_names = [nm for nm in names if hasattr(
                libs[nm]["fused_tick_kernel.cu"], "raft_k_tick_launch")]
            if aux_source == "staged" and layout == "wide" and k_names:
                out[f"staged/T{T}/k_tick"] = compare_k_tick(
                    cfg, libs, k_names, s, T, ops, reps, info)
    return out


def compare_observers(cfg, libs: dict, names: list, s: dict, T: int,
                      aux_source: str, ops: dict, reps: int, layout: str,
                      compute: str) -> dict:
    """Mean device ms of one launch of the fused kernel's observer build
    (the recorder and the monitor in the launch, a fresh monitor carry) per
    tree from the flat state `s`; every result (state, overflow, the
    launch's rows and per-group carry) equal to the first tree's."""
    dev = s["term"].device
    G = s["term"].shape[-1]
    flags = tick_mod.make_flags(cfg)

    def launch(nm, timer):
        sv = _flat_copy(s)
        obs = cuda_tick.kernel_observers(telemetry_mod.monitor_zeros(
            G, device=dev))
        tensors, ints, ov, _ = cuda_tick.fused_operands(
            cfg, sv, T, flags, aux_source, ops, (), layout, compute, obs=obs)
        ptrs = [None if x is None else x.data_ptr() for x in tensors]
        fn = libs[nm][OBSERVE].raft_fused_launch
        call = lambda: cuda_tick.launch_library(  # noqa: E731
            fn, ptrs, ints, dev, f"{nm} fused kernel (observers)")
        if timer:
            timer.run(call)
        else:
            call()
        return {**sv, "overflow": ov, "rows": obs.rows,
                **{f"carry:{k}": v for k, v in obs.carry.items()}}

    timers = {nm: DeviceTimer() for nm in names}
    _run_trees(names, reps, timers, True, launch)
    return {nm: timers[nm].mean_ms() for nm in names}


def compare_k_tick(cfg, libs: dict, names: list, s: dict, K: int, ops: dict,
                   reps: int, info: Optional[dict] = None) -> dict:
    """Mean device ms of one launch of kernel #7 (K ticks, staged `ops`)
    per tree from the flat state `s`; every result equal to the first
    tree's. `info` collects each tree's launch description
    ({"k_tick/K<K>": {tree: {...}}})."""
    info = {} if info is None else info
    dev = s["term"].device
    flags = tick_mod.make_flags(cfg)
    tensors, ints, _, _ = cuda_tick.fused_operands(cfg, s, K, flags,
                                                   "staged", ops, ())
    for nm in names:
        fn = getattr(libs[nm]["fused_tick_kernel.cu"], "raft_k_tick_info",
                     None)
        if fn is not None:
            desc = cuda_tick.launch_info(
                fn, [None if x is None else x.data_ptr() for x in tensors],
                ints, dev, f"{nm} K-tick kernel")
            info.setdefault(f"k_tick/K{K}", {})[nm] = desc
            print(f"[info] k_tick/K{K} {nm}: " + json.dumps(desc),
                  flush=True)

    def launch(nm, timer):
        sv = _flat_copy(s)
        tensors, ints, ov, _ = cuda_tick.fused_operands(
            cfg, sv, K, flags, "staged", ops, ())
        ptrs = [None if x is None else x.data_ptr() for x in tensors]
        fn = libs[nm]["fused_tick_kernel.cu"].raft_k_tick_launch
        call = lambda: cuda_tick.launch_library(  # noqa: E731
            fn, ptrs, ints, dev, f"{nm} K-tick kernel")
        if timer:
            timer.run(call)
        else:
            call()
        return {**sv, "overflow": ov}

    timers = {nm: DeviceTimer() for nm in names}
    _run_trees(names, reps, timers, True, launch)
    res = {nm: timers[nm].mean_ms() for nm in names}
    print(f"[fused] staged/T{K}/k_tick: " + json.dumps(res), flush=True)
    return res


def deep_libs(trees: dict) -> dict:
    """Build every tree's deep gather and scatter at once; {tree: {source:
    CDLL}} with each launch function bound."""
    jobs = [(src, ()) for src in build.DEEP_SOURCES[:2]]
    dirs = list(dict.fromkeys(trees.values()))  # one build per directory
    with concurrent.futures.ThreadPoolExecutor(len(dirs)) as ex:
        built = dict(zip(dirs, ex.map(
            lambda d: build.build_many(jobs, d), dirs)))
    paths = {nm: built[csrc] for nm, csrc in trees.items()}
    out = {}
    for name, csrc in trees.items():
        out[name] = {}
        for (src, dfs), path in zip(jobs, paths[name]):
            _print_build(name, src, csrc, src, dfs)
            lib = ctypes.CDLL(str(path))
            fn = getattr(lib, f"raft_{pathlib.Path(src).stem}_launch")
            fn.argtypes = [ctypes.c_void_p] * 3
            fn.restype = ctypes.c_int
            out[name][src] = lib
    return out


def capture_deep(cfg, dev, warm: int = DEEP_WARM) -> dict:
    """One tick of the deep engine after `warm` ticks of make_run, with the
    port's kernels: its gather's operands and values, its scatter's
    operands, both logs before the scatter (`pre`, a copy: the gather read
    them too) and the state after the tick (`state`, its logs hold the
    writes)."""
    st = init_state(cfg, dev)
    tick_mod.make_run(cfg, warm, trace=False, device=dev)(st)
    base, tkeys, bkeys, scen = tick_mod.split_rng(
        tick_mod.make_rng(cfg, dev))
    cap = {}

    def gather(*args):
        cap["gather"] = args[2:]
        cap["vals"] = deep_gather.gather(*args)
        return cap["vals"]

    def scatter(lt, lc, *args):
        cap["pre"] = (lt.clone(), lc.clone())
        cap["scatter"] = args
        deep_scatter.scatter(lt, lc, *args)

    aux, fl = tick_mod.make_aux(cfg, base, tkeys, bkeys, st, scen=scen)
    s = tick_mod.flatten_state(cfg, st)
    d = tick_mod.phase_body(cfg, s, aux, fl, gather=gather, scatter=scatter)
    tick_mod.finish_tick(cfg, tkeys, st, s, d)
    cap["state"] = st
    return cap


def _launch_deep(libs: dict, nm: str, src: str, ptrs, ints, dev,
                 timer) -> None:
    fn = getattr(libs[nm][src], f"raft_{pathlib.Path(src).stem}_launch")
    call = lambda: build.launch_library(  # noqa: E731
        fn, ptrs, ints, dev, f"{nm} {src}")
    if timer:
        timer.run(call)
    else:
        call()


def _vector_info(lib, module, ptrs, ints):
    """module.vector_path, or None for a tree whose library cannot say."""
    try:
        return module.vector_path(lib, ptrs, ints)
    except AttributeError:
        return None


def compare_gather(cfg, libs: dict, cap: dict, reps: int, vec: dict,
                   cmd_equal: Optional[dict] = None) -> dict:
    """Mean device ms of each tree's deep gather on the captured tick's logs
    and rows ({tree: ms}); every tree's term values equal the port's
    kernel's. Its cmd values must too, unless `cmd_equal` is given: then it
    records, per tree, whether they do (a library built before the cmd
    window took Rc reads N cmd rows a node whatever the batch). `vec`
    collects each tree's path."""
    N, C = cfg.n_nodes, cfg.phys_capacity
    names = list(libs)
    pre_t, pre_c = cap["pre"]
    rows, _, _, Rc = cap["gather"]
    want_t, want_c = cap["vals"]

    def gather(nm, timer):
        vt, vc = torch.full_like(want_t, -7), torch.full_like(want_c, -7)
        ptrs, ints = deep_gather.launch_args(pre_t, pre_c, rows, vt, vc, N,
                                             C, Rc)
        vec[nm] = _vector_info(libs[nm]["deep_gather.cu"], deep_gather,
                               ptrs, ints)
        _launch_deep(libs, nm, "deep_gather.cu", ptrs, ints, pre_t.device,
                     timer)
        return {"vt": vt} if cmd_equal is not None else {"vt": vt, "vc": vc}

    timers = {nm: DeviceTimer() for nm in names}
    _run_trees(names, reps, timers, True, gather)
    for nm in names:
        got = gather(nm, None)
        if not torch.equal(got["vt"], want_t) or (
                cmd_equal is None and not torch.equal(got["vc"], want_c)):
            raise AssertionError(f"tree {nm}'s deep gather differs from "
                                 "the port's")
        if cmd_equal is not None:
            vt, vc = torch.full_like(want_t, -7), torch.full_like(want_c, -7)
            ptrs, ints = deep_gather.launch_args(pre_t, pre_c, rows, vt, vc,
                                                 N, C, Rc)
            _launch_deep(libs, nm, "deep_gather.cu", ptrs, ints,
                         pre_t.device, None)
            cmd_equal[nm] = torch.equal(vc, want_c)
    return {nm: timers[nm].mean_ms() for nm in names}


def compare_deep(cfg, libs: dict, cap: dict, reps: int,
                 info: Optional[dict] = None) -> dict:
    """Mean device ms of each tree's deep gather and deep scatter on the
    captured tick's operands ({"gather": {tree: ms}, "scatter": {...}}),
    every tree's result equal to the port's kernel's. `info` collects
    each tree's path ({"vector": {"gather": {tree: bool}, ...}})."""
    info = {} if info is None else info
    N, C = cfg.n_nodes, cfg.phys_capacity
    names = list(libs)
    pre_t, pre_c = cap["pre"]
    dev = pre_t.device
    rows = cap["gather"][0]
    vec = info.setdefault("vector", {"gather": {}, "scatter": {}})
    out = {"gather": compare_gather(cfg, libs, cap, reps, vec["gather"])}
    print("[deep] gather: " + json.dumps(out["gather"]), flush=True)

    # The scatter, in place: each tree from the logs before the writes,
    # checked against the port's result at the kept writes' places and
    # against the logs before them everywhere else.
    st = cap["state"]
    lt, lc = st.log_term.view(N * C, -1), st.log_cmd.view(N * C, -1)
    srows, svt, svc = cap["scatter"][:3]
    K = srows.shape[0] // N
    G = lt.shape[-1]
    kept = (srows >= 0) & (srows < C)
    nrow = torch.arange(N, device=dev).repeat_interleave(K)[:, None] * C
    flat = ((nrow + srows.long()) * G
            + torch.arange(G, device=dev)[None])[kept]
    want = [x.view(-1)[flat] for x in (lt, lc)]
    for nm in names:
        lt.copy_(pre_t)
        lc.copy_(pre_c)
        ptrs, ints = deep_scatter.launch_args(lt, lc, srows, svt, svc, N, C,
                                              K)
        vec["scatter"][nm] = _vector_info(libs[nm]["deep_scatter.cu"],
                                          deep_scatter, ptrs, ints)
        _launch_deep(libs, nm, "deep_scatter.cu", ptrs, ints, dev, None)
        for x, pre, w in zip((lt, lc), (pre_t, pre_c), want):
            ok = torch.equal(x.view(-1)[flat], w)
            x.view(-1)[flat] = pre.view(-1)[flat]
            ok = ok and all(torch.equal(x[i:i + DEEP_CHUNK],
                                        pre[i:i + DEEP_CHUNK])
                            for i in range(0, x.shape[0], DEEP_CHUNK))
            if not ok:
                raise AssertionError(f"tree {nm}'s deep scatter differs "
                                     "from the port's")
    for x, w in zip((lt, lc), want):
        x.view(-1)[flat] = w
    ptrs, ints = deep_scatter.launch_args(lt, lc, srows, svt, svc, N, C, K)
    timers = {nm: DeviceTimer() for nm in names}
    _run_trees(names, reps, timers, True, lambda nm, timer: _launch_deep(
        libs, nm, "deep_scatter.cu", ptrs, ints, dev, timer) or {})
    out["scatter"] = {nm: timers[nm].mean_ms() for nm in names}
    print("[deep] scatter: " + json.dumps(out["scatter"]), flush=True)
    info["deep"] = {"K": K, "kept_writes": int(kept.sum()),
                    "rows": [rows.shape[0], srows.shape[0]]}
    print("[info] deep: " + json.dumps(info), flush=True)
    return out


def deep_main(args, trees: dict, smi: str) -> int:
    cfg = deep_config(args.groups)
    libs = deep_libs(trees)
    dev = torch.device("cuda:0")
    cap = capture_deep(cfg, dev)
    info: dict = {}
    deep = compare_deep(cfg, libs, cap, args.reps, info)
    # The gather again at the known-delivery mailbox batch (Rt = 6N+1, Rc =
    # 3N) of config 5 with 1-3-tick delays, on a tick captured the same way.
    del cap
    gc.collect()
    torch.cuda.empty_cache()
    mcfg = dataclasses.replace(cfg, delay_lo=1, delay_hi=3)
    cap = capture_deep(mcfg, dev)
    cmd_equal: dict = {}
    vec = info["vector"].setdefault("gather_mailbox", {})
    deep["gather_mailbox"] = compare_gather(mcfg, libs, cap, args.reps, vec,
                                            cmd_equal)
    info["gather_mailbox"] = {"rows": list(cap["gather"][0].shape),
                              "Rc": cap["gather"][3],
                              "cmd_rows_equal": cmd_equal}
    print("[deep] gather at the mailbox batch: " + json.dumps(
        {"ms": deep["gather_mailbox"], **info["gather_mailbox"]}), flush=True)
    result = {"device": smi, "groups": args.groups, "config": "deep",
              "deep": deep, "info": info}
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


def capture_draws(cfg, dev, warm: int = DRAW_WARM) -> tuple:
    """One tick's in-kernel key table and (N, G) live-leader mask after
    `warm` ticks of the in-kernel runner from boot."""
    st = init_state(cfg, dev)
    make_cuda_scan(cfg, warm, aux_source="inkernel", device=dev)(st)
    base, tkeys, bkeys, scen = tick_mod.split_rng(
        tick_mod.make_rng(cfg, dev))
    stat = cuda_tick.inkernel_aux_statics(cfg, base, tkeys, bkeys, scen)
    return (cuda_tick.inkernel_aux_operands(stat, st.tick)["ktab"],
            (st.role == LEADER) & st.up)


def compare_draw(libs: dict, fn_name: str, args_of, want: torch.Tensor,
                 reps: int) -> tuple:
    """Mean device ms (DeviceTimer) of each tree's `fn_name` launch on
    the port's arguments (args_of(out) -> (pointers, ints)); every tree's
    output equal to `want`, the port's own kernel's."""
    src = "fused_tick_kernel.cu"
    names = list(libs)
    dev = want.device

    def launch(nm, timer):
        out = torch.empty_like(want)
        ptrs, ints = args_of(out)
        fn = getattr(libs[nm][src], fn_name)
        fn.argtypes = [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        call = lambda: build.launch_library(  # noqa: E731
            fn, ptrs, ints, dev, f"{nm} {fn_name}")
        if timer:
            timer.run(call)
        else:
            call()
        return {"out": out}

    timers = {nm: DeviceTimer() for nm in names}
    _run_trees(names, reps, timers, True, launch)
    if not torch.equal(launch(names[0], None)["out"], want):
        raise AssertionError(f"tree {names[0]}'s {fn_name} differs from the "
                             "port's")
    return {nm: timers[nm].mean_ms() for nm in names}


def draws_main(args, trees: dict, smi: str) -> int:
    dev = torch.device("cuda:0")
    libs = _libs(trees, 3, observers=False,
                 sources=("fused_tick_kernel.cu",))
    info: dict = {"part_down": {}}
    draws = {}
    cfg = smoke_config(args.groups)
    ktab, lead = capture_draws(cfg, dev)
    want = cuda_tick.part_down(cfg, ktab, lead)
    for nm in trees:
        fn = getattr(libs[nm]["fused_tick_kernel.cu"], "raft_part_down_info",
                     None)
        if fn is not None:
            ptrs, ints = cuda_tick.part_down_args(cfg, ktab, lead,
                                                  torch.empty_like(want))
            fn.argtypes = [ctypes.c_void_p] * 3
            fn.restype = ctypes.c_int
            info["part_down"][nm] = cuda_tick.launch_info(
                fn, ptrs, ints, dev, f"{nm} part_down")
            print(f"[info] part_down {nm}: "
                  + json.dumps(info["part_down"][nm]), flush=True)
    draws["part_down"] = compare_draw(
        libs, "raft_part_down_launch",
        lambda out: cuda_tick.part_down_args(cfg, ktab, lead, out), want,
        args.reps)
    info["part_down_edges_down"] = int((~want).sum())
    print("[draws] part_down: " + json.dumps(draws["part_down"]), flush=True)
    del ktab, lead, want
    mcfg = farm_mailbox_config(args.groups)
    ktab, _ = capture_draws(mcfg, dev)
    want = cuda_tick.delay_draw(mcfg, ktab)
    draws["delay_draw"] = compare_draw(
        libs, "raft_delay_draw_launch",
        lambda out: cuda_tick.delay_draw_args(mcfg, ktab, out), want,
        args.reps)
    print("[draws] delay_draw: " + json.dumps(draws["delay_draw"]),
          flush=True)
    result = {"device": smi, "groups": args.groups, "config": "farm",
              "draws": draws, "info": info}
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", metavar="NAME=CSRC")
    ap.add_argument("--groups", type=int, default=102_400)
    ap.add_argument("--ticks", type=int, default=10)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--fused-t", default="1,4,8",
                    help="the fused launches' T (comma list) or 'none'")
    ap.add_argument("--config", choices=sorted(CONFIGS), default="headline")
    ap.add_argument("--mailbox", action="store_true",
                    help="the same as --config mailbox")
    ap.add_argument("--no-observers", action="store_true",
                    help="skip the fused kernel's observer builds")
    ap.add_argument("--tick-only", action="store_true",
                    help="build and time the one-tick kernel alone")
    ap.add_argument("--layout", choices=tick_mod.LAYOUTS, default="wide")
    ap.add_argument("--compute", choices=tick_mod.COMPUTES,
                    default="unpacked")
    ap.add_argument("--deep", action="store_true",
                    help="the deep gather and scatter at config 5 instead")
    ap.add_argument("--draws", action="store_true",
                    help="kernel #3's stand-alone draws at the farm instead")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    trees = {}
    need = ("deep_gather.cu" if args.deep else "fused_tick_kernel.cu"
            if args.draws else "tick_kernel.cu")
    for spec in args.trees:
        name, _, path = spec.partition("=")
        csrc = pathlib.Path(path).resolve()
        if not name or not (csrc / need).exists():
            ap.error(f"{spec}: expected NAME=DIR with DIR/{need}")
        trees[name] = csrc
    if not torch.cuda.is_available():
        print("kernel_ab: needs an NVIDIA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[device] {smi}", flush=True)
    if args.deep:
        return deep_main(args, trees, smi)
    if args.draws:
        return draws_main(args, trees, smi)
    config = "mailbox" if args.mailbox else args.config
    cfg = CONFIGS[config](args.groups)
    dev = torch.device("cuda:0")
    packed = args.layout == "packed"
    libs = _libs(trees, cfg.n_nodes, packed,
                 observers=not args.no_observers,
                 sources=build.KERNEL_SOURCES[:1] if args.tick_only
                 else build.KERNEL_SOURCES)
    state = init_state(cfg, dev)
    step = cuda_tick.make_cuda_tick(cfg, dev)
    for _ in range(WARM):
        step(state)
    if packed:
        state = pack_state(cfg, state)
    kw = {"layout": args.layout, "compute": args.compute}
    fused_state = pack_state(cfg, unpack_state(cfg, state)) if packed \
        else state.clone()
    info: dict = {}
    tick_ms = compare_tick(cfg, libs, state, args.ticks, args.reps, **kw,
                           info=info)
    print(f"[tick] {args.ticks} ticks from tick {WARM}: "
          + json.dumps(tick_ms), flush=True)
    fused = {}
    if args.fused_t != "none" and not args.tick_only:
        fused = compare_fused(cfg, libs, fused_state,
                              [int(x) for x in args.fused_t.split(",")],
                              args.reps, **kw, info=info)
    result = {"device": smi, "groups": args.groups, "config": config,
              **kw, "tick": tick_ms, "fused": fused,
              "info": info}
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
