"""CLI: step a simulation and print one JSON line of summary metrics.

    python -m raft_kotlin_tpu_torch run --groups 102400 --nodes 5 \\
        --log-capacity 32 --cmd-period 10 --p-drop 0.25 --p-crash 0.01 \\
        --p-restart 0.08 --p-link-fail 0.02 --p-link-heal 0.08 --stress 10 \\
        --ticks 200

runs on the CUDA card through the tick kernel (`--impl auto`); `--device cpu`
runs the plain PyTorch version on the CPU. A deep log (`--log-capacity` of
256 or more), as in BASELINE config 5,

    python -m raft_kotlin_tpu_torch run --groups 102400 --nodes 7 \
        --log-capacity 10000 --cmd-period 2 --p-drop 0.05 --seed 3 \
        --stress 10 --ticks 60

runs the batched deep-log engine with the deep gather and scatter kernels
(int32 logs: the JAX package's CLI has no log-dtype flag either).

    python -m raft_kotlin_tpu_torch fuzz --universes 102400 --ticks 200

runs the §12 fuzzing farm over universes of the smoke family
(api/fuzz.smoke_config; the batch-mode flags of scripts/fuzz_farm.py, with
`--delay 1 4` its mailbox regime with per-universe delay windows), shrinks
and replays any latched violation, and writes the JSONL corpus to `--out`.
Exit status: 0 clean, 1 a violation latched, 2 a usage error.

A CUDA request on a machine with no card fails; nothing falls back to the
CPU or to the plain version.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _add_cfg_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--groups", type=int, default=1)
    p.add_argument("--nodes", type=int, default=3)
    p.add_argument("--log-capacity", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--p-drop", type=float, default=0.0)
    p.add_argument("--p-crash", type=float, default=0.0)
    p.add_argument("--p-restart", type=float, default=0.0)
    p.add_argument("--p-link-fail", type=float, default=0.0)
    p.add_argument("--p-link-heal", type=float, default=0.0)
    p.add_argument("--cmd-period", type=int, default=0)
    p.add_argument("--stress", type=int, default=1,
                   help="divide all pacing constants by this factor")
    p.add_argument("--impl", choices=["auto", "kernel", "plain"],
                   default="auto",
                   help="tick backend: kernel = the CUDA tick kernel, plain "
                        "= the PyTorch phase lattice, auto = kernel on cuda")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")


def _cfg_from(args):
    from raft_kotlin_tpu_torch.utils.config import RaftConfig

    cfg = RaftConfig(
        n_groups=args.groups,
        n_nodes=args.nodes,
        log_capacity=args.log_capacity,
        seed=args.seed,
        p_drop=args.p_drop,
        p_crash=args.p_crash,
        p_restart=args.p_restart,
        p_link_fail=args.p_link_fail,
        p_link_heal=args.p_link_heal,
        cmd_period=args.cmd_period,
    )
    return cfg.stressed(args.stress) if args.stress > 1 else cfg


def _add_fuzz_args(p: argparse.ArgumentParser) -> None:
    # Defaults: the smoke family (api/fuzz.smoke_config / smoke_spec).
    p.add_argument("--universes", type=int, default=512,
                   help="total universes to explore")
    p.add_argument("--ticks", type=int, default=200,
                   help="ticks per universe")
    p.add_argument("--batch", type=int, default=0,
                   help="universes per batch (0 = all at once)")
    p.add_argument("--farm-seed", type=int, default=12,
                   help="the bank's counted-threefry seed")
    p.add_argument("--universe-base", type=int, default=0,
                   help="first universe id")
    p.add_argument("--seed", type=int, default=9,
                   help="run seed (per-tick draws, boot timers)")
    p.add_argument("--nodes", type=int, default=3)
    p.add_argument("--log-capacity", type=int, default=32)
    p.add_argument("--cmd-period", type=int, default=5)
    p.add_argument("--drop-max", type=float, default=0.25)
    p.add_argument("--crash-max", type=float, default=0.02)
    p.add_argument("--restart-max", type=float, default=0.2)
    p.add_argument("--link-fail-max", type=float, default=0.0)
    p.add_argument("--link-heal-max", type=float, default=0.0)
    p.add_argument("--partitions", default="split,asym,leader",
                   help="comma list of split/asym/leader ('' = none)")
    p.add_argument("--delay", type=int, nargs=2, default=None,
                   metavar=("LO", "HI"),
                   help="mailbox window; per-universe delay windows when "
                        "LO < HI")
    p.add_argument("--stress", type=int, default=10,
                   help="pacing compression factor (RaftConfig.stressed)")
    p.add_argument("--compact", type=int, nargs=2, default=None,
                   metavar=("WATERMARK", "CHUNK"),
                   help="enable §15 log compaction (snapshot fold + "
                        "InstallSnapshot: unbounded runs on the bounded "
                        "log window)")
    p.add_argument("--soak", type=int, default=0, metavar="TICKS",
                   help="standing-soak mode (§15): TICKS monitored ticks "
                        "under checkpoint rotation in place of the batch "
                        "campaign; needs --compact; exit 0 only on a clean "
                        "verdict with an empty capacity latch")
    p.add_argument("--soak-segment", type=int, default=0,
                   help="ticks per soak segment (0 = 2x log_capacity)")
    p.add_argument("--warmup", type=int, default=0, metavar="TICKS",
                   help="§15 warmup-down: hold every non-cmd node down for "
                        "t < TICKS and rejoin at t == TICKS, so cmd_node "
                        "wins every group's first election (the family a "
                        "standing --soak needs to stay capacity-clean)")
    p.add_argument("--out", default=None, help="JSONL corpus path")
    p.add_argument("--json", action="store_true",
                   help="print the full summary as JSON")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")


def fuzz_main(args) -> int:
    import dataclasses

    from raft_kotlin_tpu_torch.api import fuzz
    from raft_kotlin_tpu_torch.models.state import require_device
    from raft_kotlin_tpu_torch.utils.config import RaftConfig

    dev = require_device(args.device)
    parts = tuple(p for p in args.partitions.split(",") if p)
    delay_lo, delay_hi = args.delay if args.delay else (0, 0)
    batch = args.batch or args.universes
    try:
        spec = dataclasses.replace(
            fuzz.smoke_spec(args.farm_seed),
            universe_base=args.universe_base, drop_max=args.drop_max,
            crash_max=args.crash_max, restart_max=args.restart_max,
            link_fail_max=args.link_fail_max,
            link_heal_max=args.link_heal_max,
            delay_windows=delay_lo < delay_hi, partitions=parts,
            warmup_down=args.warmup)
        cw, cc = args.compact if args.compact else (0, 8)
        cfg = RaftConfig(
            n_groups=batch, n_nodes=args.nodes,
            log_capacity=args.log_capacity, cmd_period=args.cmd_period,
            delay_lo=delay_lo, delay_hi=delay_hi, seed=args.seed,
            compact_watermark=cw, compact_chunk=cc,
            scenario=spec).stressed(args.stress)
    except (ValueError, AssertionError) as e:
        print(f"fuzz: {e}", file=sys.stderr)
        return 2
    if args.soak:
        # §15 standing soak: without truncation every universe died at
        # log_capacity; with it a batch runs on under checkpoint rotation.
        if not cfg.uses_compaction:
            print("fuzz: --soak requires --compact (the soak outlives "
                  "log_capacity by design)", file=sys.stderr)
            return 2
        res = fuzz.soak_run(cfg, args.soak,
                            segment=args.soak_segment or None,
                            verbose=not args.json, device=dev)
        if args.json:
            print(json.dumps(res, sort_keys=True))
        else:
            print(f"soak {res['ticks']} ticks / {res['segments']} segments"
                  f" inv={res['inv_status']}"
                  f" window_hw={res['window_hw']}/{args.log_capacity}"
                  f" snap_index=[{res['snap_index_min']},"
                  f" {res['snap_index_max']}]"
                  f" cap_exhausted_groups={res['cap_exhausted_groups']}")
        return 0 if (res["inv_status"] == "clean"
                     and res["cap_exhausted_groups"] == 0) else 1
    res = fuzz.fuzz_farm(cfg, args.ticks, universes=args.universes,
                         batch_groups=batch, out_path=args.out,
                         triage_confirm=False, verbose=not args.json,
                         device=dev)
    if args.json:
        print(json.dumps(res, sort_keys=True))
    else:
        print(f"universes={res['universes']} x ticks="
              f"{res['ticks_per_universe']} -> "
              f"{res['universe_ticks']} universe-ticks")
        print(f"inv_status={res['inv_status']} "
              f"violations={res['violations']} "
              f"corpus_hash={res['corpus_hash']}")
        print("coverage:", json.dumps(res["coverage"], sort_keys=True))
        print("telemetry:", json.dumps(res["telemetry"], sort_keys=True))
        for r in res["records"]:
            print(f"  artifact: {r['status']} universe={r['universe_id']} "
                  f"horizon={r['horizon']} "
                  f"replay_confirmed={r['replay_confirmed']}")
    return 0 if res["inv_status"] == "clean" else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="raft_kotlin_tpu_torch")
    sub = ap.add_subparsers(dest="command", required=True)
    run = sub.add_parser("run", help="step N ticks, print summary metrics")
    _add_cfg_args(run)
    run.add_argument("--ticks", type=int, default=500)
    fz = sub.add_parser("fuzz", help="run the §12 fuzzing farm (exit 0 "
                        "clean, 1 latched, 2 usage)")
    _add_fuzz_args(fz)
    args = ap.parse_args(argv)
    if args.command == "fuzz":
        return fuzz_main(args)

    import torch

    from raft_kotlin_tpu_torch.constants import LEADER
    from raft_kotlin_tpu_torch.models.state import init_state, require_device
    from raft_kotlin_tpu_torch.ops import cuda_tick, deep_gather, deep_scatter
    from raft_kotlin_tpu_torch.ops.tick import make_run, resolve_impl

    cfg = _cfg_from(args)
    dev = require_device(args.device)
    impl = resolve_impl(args.impl, dev)
    runner = make_run(cfg, args.ticks, trace=False, impl=impl, device=dev)
    st0 = init_state(cfg, dev)
    cuda_tick.reset_launch_counts()
    deep_gather.reset_counts()
    deep_scatter.reset_counts()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    state, _ = runner(st0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    launches = (cuda_tick.LAUNCHES["tick_kernel"]
                + deep_gather.LAUNCHES["deep_gather"]
                + deep_scatter.LAUNCHES["deep_scatter"])
    print(json.dumps({
        "ticks": args.ticks,
        "groups": cfg.n_groups,
        "elapsed_s": round(dt, 3),
        "group_steps_per_sec": round(cfg.n_groups * args.ticks / dt, 1),
        "impl": impl,
        "groups_with_leader": int((state.role == LEADER).any(0).sum()),
        "elections_started": int(state.rounds.to(torch.int64).sum()),
        "max_commit": int(state.commit.max()),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "kernel_launches": launches,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
