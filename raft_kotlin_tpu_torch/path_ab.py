"""Main-path A/B of the port across source trees, on one card:

    python -m raft_kotlin_tpu_torch.path_ab [--paths=P,...] [--runs=R]
        parent=DIR change=DIR

Each DIR is a checkout root holding a `raft_kotlin_tpu_torch/` (another
commit's via `git archive <rev> raft_kotlin_tpu_torch | tar -x -C DIR`).
Each tree runs in its own process (the trees share the package's name),
in turns — first, second, second, first — and times, host clock around a
synchronised run, 200 ticks of each path, R times (2 by default) after
one warm-up run. The paths (`--paths`, "headline,mailbox" by default):
"headline" and "mailbox" (the stage-4b mailbox) through
`make_cuda_scan(fused_ticks=4, aux_source="inkernel")` with the observers
on and off; "farm" (api/fuzz.smoke_config at the headline's 102,400
universes) and "farm_mailbox" (its 1-4-tick delay windows, as
scripts/fuzz_farm.py --delay 1 4) through the farm's engine,
`api/fuzz.make_batch_runner`, whose observers are always on. Each tree
builds its own tick kernels (into its `build/torch_ext/`). Prints one
JSON line a run, then the card's name and power limit. Needs a card.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

TICKS, RUNS = 200, 2
PATHS = ("headline", "mailbox", "farm", "farm_mailbox")

# Run in the tree's own process: argv[1] is the tree, put first on the path.
_CHILD = r"""
import dataclasses, json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import raft_kotlin_tpu_torch
from raft_kotlin_tpu_torch.api import fuzz
from raft_kotlin_tpu_torch.models.state import init_state
from raft_kotlin_tpu_torch.ops import build
from raft_kotlin_tpu_torch.ops.cuda_scan import make_cuda_scan
from raft_kotlin_tpu_torch.utils.config import headline_config, mailbox_config
ticks, runs = int(sys.argv[2]), int(sys.argv[3])
paths = sys.argv[4].split(",")
dev = torch.device("cuda:0")
cfgs = {}
if "headline" in paths:
    cfgs["headline"] = headline_config()
if "mailbox" in paths:
    cfgs["mailbox"] = mailbox_config()
if "farm" in paths or "farm_mailbox" in paths:
    farm = fuzz.smoke_config(102_400)
    if "farm" in paths:
        cfgs["farm"] = farm
    if "farm_mailbox" in paths:
        cfgs["farm_mailbox"] = dataclasses.replace(
            farm, delay_lo=1, delay_hi=4, scenario=dataclasses.replace(
                farm.scenario, delay_windows=True))
build.build_many(sorted({j for n in {c.n_nodes for c in cfgs.values()}
                         for j in build.build_jobs(n, packed=False)
                         if "tick" in j[0]}))
out = {"package": raft_kotlin_tpu_torch.__file__}
for name, cfg in cfgs.items():
    farm_path = name.startswith("farm")
    for obs in (True,) if farm_path else (True, False):
        if farm_path:
            run = fuzz.make_batch_runner(cfg, ticks, device=dev)
        else:
            run = make_cuda_scan(cfg, ticks, fused_ticks=4,
                                 aux_source="inkernel", telemetry=obs,
                                 monitor=obs, device=dev)
        run(init_state(cfg, dev))
        ms = []
        for _ in range(runs):
            st = init_state(cfg, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(st)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3 / ticks)
        out[f"{name}_{'observers' if obs else 'off'}_ms_per_tick"] = ms
print(json.dumps(out))
"""


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    opts = dict(a[2:].split("=", 1) for a in args
                if a.startswith("--") and "=" in a)
    trees = [a.split("=", 1) for a in args if not a.startswith("--")]
    paths = opts.get("paths", "headline,mailbox")
    if len(trees) != 2 or any(len(t) != 2 for t in trees) \
            or set(opts) - {"paths", "runs"} \
            or set(paths.split(",")) - set(PATHS) \
            or not opts.get("runs", "1").isdigit():
        print("usage: python -m raft_kotlin_tpu_torch.path_ab "
              "[--paths=P,...] [--runs=R] A=DIR B=DIR", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("path_ab: torch.cuda.is_available() is False — the A/B "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    (a, da), (b, db) = trees
    for name, tree in ((a, da), (b, db), (b, db), (a, da)):
        r = subprocess.run(
            [sys.executable, "-c", _CHILD, tree, str(TICKS),
             opts.get("runs", str(RUNS)), paths],
            capture_output=True, text=True, check=True)
        row = json.loads(r.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": name, **row}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
