"""CLI: step a simulation and print one JSON line of summary metrics.

    python -m raft_kotlin_tpu_torch run --groups 102400 --nodes 5 \\
        --log-capacity 32 --cmd-period 10 --p-drop 0.25 --p-crash 0.01 \\
        --p-restart 0.08 --p-link-fail 0.02 --p-link-heal 0.08 --stress 10 \\
        --ticks 200

runs on the CUDA card through the tick kernel (`--impl auto`); `--device cpu`
runs the plain PyTorch version on the CPU. A CUDA request on a machine with
no card fails; nothing falls back to the CPU or to the plain version.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="raft_kotlin_tpu_torch")
    sub = ap.add_subparsers(dest="command", required=True)
    run = sub.add_parser("run", help="step N ticks, print summary metrics")
    _add_cfg_args(run)
    run.add_argument("--ticks", type=int, default=500)
    args = ap.parse_args(argv)

    import torch

    from raft_kotlin_tpu_torch.constants import LEADER
    from raft_kotlin_tpu_torch.models.state import init_state, require_device
    from raft_kotlin_tpu_torch.ops import cuda_tick
    from raft_kotlin_tpu_torch.ops.tick import make_run, resolve_impl

    cfg = _cfg_from(args)
    dev = require_device(args.device)
    impl = resolve_impl(args.impl, dev)
    runner = make_run(cfg, args.ticks, trace=False, impl=impl, device=dev)
    st0 = init_state(cfg, dev)
    cuda_tick.reset_launch_counts()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    state, _ = runner(st0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    launches = cuda_tick.LAUNCHES["tick_kernel"]
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
