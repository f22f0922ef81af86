"""Device time of the port's kernels built from several source trees, on
one card, in one process — the way to compare two versions of a kernel
(host-bound numbers and even device clocks drift from one machine to the
next, so versions are compared only within one run).

    python -m raft_kotlin_tpu_torch.kernel_ab NAME=CSRC [NAME=CSRC ...]

Each CSRC is a kernel source directory laid out as
raft_kotlin_tpu_torch/ops/csrc (for another commit:
`git archive <commit> raft_kotlin_tpu_torch/ops/csrc | tar -x -C DIR`,
then DIR/raft_kotlin_tpu_torch/ops/csrc). Every tree's tick_kernel.cu, and
its fused_tick_kernel.cu where it has one, is built with the port's nvcc
flags, all at once; ptxas's register and spill lines are printed.

At the headline shape (102,400 groups by default; `--mailbox`: bench.py's
§10 mailbox stage, utils/config.mailbox_config — every tree must then take
the mailbox's operands), from a state warmed 60 ticks:

- one-tick kernel: `--ticks` ticks, each launched once per tree on a copy
  of the same state with the same staged aux, in the order A B ... B A
  repeated `--reps` times; every tree's result must equal the port's own
  kernel (el_dirty and every state field);
- fused kernel (trees that have it): one launch per (aux source, T,
  snapshots on/off) on copies of the same state, in the same order, and
  every result equal to the first such tree's.

Device time by CUDA events around a launch queued behind a spinning card
(utils/timing.DeviceTimer). Prints one line per measurement and, last, a
JSON object {"device": ..., "tick": {tree: ms}, "fused": {key: {tree:
ms}}}, also written to `--out` when given.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import pathlib
import subprocess
import sys

import torch

from raft_kotlin_tpu_torch.models.state import init_state
from raft_kotlin_tpu_torch.ops import build, cuda_tick
from raft_kotlin_tpu_torch.ops import tick as tick_mod
from raft_kotlin_tpu_torch.utils.config import headline_config, mailbox_config
from raft_kotlin_tpu_torch.utils.timing import DeviceTimer

WARM = 60


def _libs(trees: dict, n_nodes: int) -> dict:
    """Build every tree's kernels in parallel; {tree: {source: CDLL}}."""
    defines = (f"RAFT_N={n_nodes}",)
    jobs = {name: [s for s in build.KERNEL_SOURCES
                   if (csrc / s).exists()] for name, csrc in trees.items()}
    with concurrent.futures.ThreadPoolExecutor(len(trees)) as ex:
        paths = dict(zip(trees, ex.map(
            lambda nm: build.build_many([(s, defines) for s in jobs[nm]],
                                        trees[nm]), trees)))
    out = {}
    for name, csrc in trees.items():
        out[name] = {}
        for src, path in zip(jobs[name], paths[name]):
            info = build.BUILD_INFO[(src if csrc == build.CSRC
                                     else str(csrc / src), defines)]
            lines = [ln.strip() for ln in info["log"].splitlines()
                     if "registers" in ln or "spill" in ln]
            print(f"[build] {name} {src}: nvcc {info['seconds']:.1f} s; "
                  + " | ".join(lines), flush=True)
            out[name][src] = ctypes.CDLL(str(path))
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


def compare_tick(cfg, libs: dict, state, ticks: int, reps: int) -> dict:
    """Mean device ms of each tree's one-tick kernel over `ticks` ticks; the
    state advances through the port's own kernel, which every tree must
    equal."""
    dev = state.term.device
    base, tkeys, bkeys = tick_mod.make_rng(cfg, dev)
    names = list(libs)
    timers = {nm: DeviceTimer() for nm in names}
    for i in range(ticks):
        aux, flags = tick_mod.make_aux(cfg, base, tkeys, bkeys, state)
        s = tick_mod.flatten_state(cfg, state)
        pre = _flat_copy(s)
        dirty = cuda_tick.tick_kernel(cfg, s, aux, flags)  # advances state

        def launch(nm, timer):
            sv = _flat_copy(pre)
            ptrs, ints, dv = cuda_tick.tick_launch_args(cfg, sv, aux, flags)
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
        tick_mod.finish_tick(cfg, tkeys, state, s, dirty)
    return {nm: timers[nm].mean_ms() for nm in names}


def compare_fused(cfg, libs: dict, state, Ts: list, reps: int) -> dict:
    """Mean device ms of one fused launch per (aux source, T, snapshots)
    and tree, from `state`; every tree's result (state, overflow,
    snapshots) equal to the first's."""
    names = [nm for nm in libs if "fused_tick_kernel.cu" in libs[nm]]
    dev = state.term.device
    base, tkeys, bkeys = tick_mod.make_rng(cfg, dev)
    stat = cuda_tick.inkernel_aux_statics(cfg, base, tkeys, bkeys)
    flags = tick_mod.make_flags(cfg)
    headline_snaps = cuda_tick.fused_snapshot_fields(cfg, telemetry=True,
                                                     monitor=True)
    s = tick_mod.flatten_state(cfg, state)
    out = {}
    for aux_source in cuda_tick.AUX_SOURCES:
        for T in Ts:
            if aux_source == "inkernel":
                ops = cuda_tick.inkernel_aux_operands(stat, state.tick)
            else:
                ops = cuda_tick.staged_operands(cfg, base, tkeys, bkeys,
                                                state.tick, s, T)
            for snap_name, snap in (("snap", headline_snaps), ("nosnap", ())):
                key = f"{aux_source}/T{T}/{snap_name}"

                def launch(nm, timer):
                    sv = _flat_copy(s)
                    tensors, ints, ov, snaps = cuda_tick.fused_operands(
                        cfg, sv, T, flags, aux_source, ops, snap)
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
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", metavar="NAME=CSRC")
    ap.add_argument("--groups", type=int, default=102_400)
    ap.add_argument("--ticks", type=int, default=10)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--fused-t", default="1,4,8")
    ap.add_argument("--mailbox", action="store_true",
                    help="time at mailbox_config() instead of the headline")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    trees = {}
    for spec in args.trees:
        name, _, path = spec.partition("=")
        csrc = pathlib.Path(path).resolve()
        if not name or not (csrc / "tick_kernel.cu").exists():
            ap.error(f"{spec}: expected NAME=DIR with DIR/tick_kernel.cu")
        trees[name] = csrc
    if not torch.cuda.is_available():
        print("kernel_ab: needs an NVIDIA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[device] {smi}", flush=True)
    cfg = (mailbox_config if args.mailbox else headline_config)(args.groups)
    dev = torch.device("cuda:0")
    libs = _libs(trees, cfg.n_nodes)
    state = init_state(cfg, dev)
    step = cuda_tick.make_cuda_tick(cfg, dev)
    for _ in range(WARM):
        step(state)
    tick_ms = compare_tick(cfg, libs, state, args.ticks, args.reps)
    print(f"[tick] {args.ticks} ticks from tick {WARM}: "
          + json.dumps(tick_ms), flush=True)
    fused = compare_fused(cfg, libs, state,
                          [int(x) for x in args.fused_t.split(",")],
                          args.reps)
    result = {"device": smi, "groups": args.groups,
              "config": "mailbox" if args.mailbox else "headline",
              "tick": tick_ms,
              "fused": fused}
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
