"""Main-path A/B of the port across source trees, on one card:

    python -m raft_kotlin_tpu_torch.path_ab parent=DIR change=DIR

Each DIR is a checkout root holding a `raft_kotlin_tpu_torch/` (another
commit's via `git archive <rev> raft_kotlin_tpu_torch | tar -x -C DIR`).
Each tree runs in its own process (the trees share the package's name),
in turns — first, second, second, first — and times, host clock around a
synchronised run, 200 ticks of the headline and of the stage-4b mailbox
through `make_cuda_scan(fused_ticks=4, aux_source="inkernel")`, with the
observers on and off, twice each after one warm-up run. Each tree builds
its own tick kernels (into its `build/torch_ext/`). Prints one JSON line a
run, then the card's name and power limit. Needs a card.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

TICKS, RUNS = 200, 2

# Run in the tree's own process: argv[1] is the tree, put first on the path.
_CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import raft_kotlin_tpu_torch
from raft_kotlin_tpu_torch.models.state import init_state
from raft_kotlin_tpu_torch.ops import build
from raft_kotlin_tpu_torch.ops.cuda_scan import make_cuda_scan
from raft_kotlin_tpu_torch.utils.config import headline_config, mailbox_config
ticks, runs = int(sys.argv[2]), int(sys.argv[3])
dev = torch.device("cuda:0")
build.build_many([j for j in build.build_jobs(5) if "tick" in j[0]])
out = {"package": raft_kotlin_tpu_torch.__file__}
for name, cfg in (("headline", headline_config()),
                  ("mailbox", mailbox_config())):
    for obs in (True, False):
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
    trees = [a.split("=", 1) for a in args]
    if len(trees) != 2 or any(len(t) != 2 for t in trees):
        print("usage: python -m raft_kotlin_tpu_torch.path_ab A=DIR B=DIR",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("path_ab: torch.cuda.is_available() is False — the A/B "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    (a, da), (b, db) = trees
    for name, tree in ((a, da), (b, db), (b, db), (a, da)):
        r = subprocess.run(
            [sys.executable, "-c", _CHILD, tree, str(TICKS), str(RUNS)],
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
