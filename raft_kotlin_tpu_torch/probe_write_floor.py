"""Which floor binds the deep-log write pass on the card: the JAX package's
write-floor probe (scripts/probe_write_floor.py) on the port's kernels.

    python -m raft_kotlin_tpu_torch.probe_write_floor [G] [C] [N] [K] [--device cpu]

Three measurements, one JSON line each, every one over 20 applications
with carry-dependent rows (the JAX probe's scan20: application c writes
row (r + c + off) % C where r < C, and drops it otherwise):

1. `copy_floor` — both (N*C, G) logs read and written back whole, in place
   (ops/copy_floor, kernel #8): the whole-log round trip a write pass
   could at worst cost; beside it `library_ms`, torch's `copy_` of one log
   into a second buffer of the same size, one log after the other;
2. `scatter_clustered` / `scatter_uniform` — the deep scatter
   (ops/deep_scatter, kernel #5; the port has one form where the TPU had a
   grid form and a DMA form) on rows in one K-band per lane (the steady
   state's frontier) and rows uniform over [0, C) (the adversarial case);
3. `k_sweep` — the scatter at K in {1, 8, 16} on uniform rows: flat in K
   means the launch's fixed cost binds, linear means the writes do.

Reading them (the JAX probe's decision tree): scatter far under
copy_floor — the whole-log floor does not bind the write pass; scatter
near copy_floor — the pass is bound by the whole log; scatter far over
copy_floor and flat in K — per-launch latency binds.

Each line has `ms` (CUDA events around the 20 applications, per
application), `bound_ms` (the bytes the application needs at the H100's
3.35 TB/s: each log byte read and written for the copy; for the scatter
the rows, the value planes and each distinct 32-byte log sector written,
read and written, in both logs) and the card's name and power limit as
nvidia-smi prints them. Defaults: BASELINE config 5's full width,
G=102,400, C=10,000, N=7, K=8, int16 logs (28.7 GB). With `--device cpu`
the probe runs the plain versions at the smoke scale G=8, C=1024, N=3 and
prints host-clock `host_ms` and `bytes` in place of `ms` and `bound_ms`
(no device time, no device bound).

The data come from a seeded torch.Generator: lt uniform on [0, 90), lc =
lt + 3, values on [1, 50). They are not the JAX probe's jax.random bits:
the probe compares times, not values.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from raft_kotlin_tpu_torch.ops import copy_floor as copy_floor_mod
from raft_kotlin_tpu_torch.ops import deep_scatter
from raft_kotlin_tpu_torch.utils.timing import Timer, sync

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
APPLICATIONS = 20
K_SWEEP = (1, 8, 16)
SMOKE = (8, 1024, 3)  # G, C, N on the CPU, as the JAX probe's CPU run


def scan_rows(rows: torch.Tensor, c: int, off: int, C: int) -> torch.Tensor:
    """Application c's rows: the JAX probe's scan20 rule, (rows + c + off)
    % C where rows < C, else C (a dropped write)."""
    return torch.where(rows < C, (rows + c + off) % C,
                       torch.full_like(rows, C))


def make_logs(G: int, C: int, N: int, dev, seed: int = 0) -> tuple:
    """The probe's (N*C, G) int16 logs: lt on [0, 90), lc = lt + 3."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lt = torch.randint(0, 90, (N * C, G), dtype=torch.int16, device=dev,
                       generator=gen)
    return lt, lt + 3


def make_rows(G: int, C: int, N: int, K: int, dev, seed: int = 1) -> dict:
    """(N*K, G) int32 rows, uniform over [0, C) and clustered in one K-band
    per (node, lane), and (N*K, G) int16 values on [1, 50)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    uniform = torch.randint(0, C, (N * K, G), dtype=torch.int32, device=dev,
                            generator=gen)
    base = torch.randint(0, max(C - K, 1), (N, 1, G), dtype=torch.int32,
                         device=dev, generator=gen)
    band = torch.arange(K, dtype=torch.int32, device=dev)[None, :, None]
    clustered = (base + band).clamp(0, C - 1).reshape(N * K, G)
    vals = torch.randint(1, 50, (N * K, G), dtype=torch.int16, device=dev,
                         generator=gen)
    return {"uniform": uniform, "clustered": clustered, "vals": vals}


def scatter_bytes(rows: torch.Tensor, vals: torch.Tensor, N: int, C: int,
                  elt: int) -> int:
    """The bytes one scatter application needs: the rows and both value
    planes read, and each distinct 32-byte log sector its kept writes land
    in read and written, in both logs."""
    G = rows.shape[-1]
    K = rows.shape[0] // N
    node = torch.arange(N, device=rows.device).repeat_interleave(K)[:, None]
    keep = (rows >= 0) & (rows < C)
    flat = ((node * C + rows.long()) * G
            + torch.arange(G, device=rows.device)[None])[keep]
    sectors = int(torch.unique(flat * elt // 32).numel())
    return rows.nbytes + 2 * vals.nbytes + 2 * 2 * 32 * sectors


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


class Clock:
    """Per-application ms of a region: CUDA events on the card, the host
    clock on the CPU."""

    def __init__(self, dev):
        self.card = torch.device(dev).type == "cuda"
        self.timer, self.host = Timer(), 0.0

    def __enter__(self):
        if self.card:
            self.timer.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.card:
            self.timer.__exit__(*exc)
        self.host = time.perf_counter() - self.t0

    def fields(self, n: int) -> dict:
        if self.card:
            return {"ms": self.timer.mean_ms() / n}
        return {"host_ms": self.host * 1e3 / n}


def time_copy_floor(lt: torch.Tensor, lc: torch.Tensor) -> dict:
    """copy_floor over 20 applications (one untimed first) and the library
    call's (copy_ of each log into a second buffer, one after the other)."""
    copy_floor_mod.copy_floor(lt, lc)
    clock = Clock(lt.device)
    with clock:
        for _ in range(APPLICATIONS):
            copy_floor_mod.copy_floor(lt, lc)
    out = {"probe": "copy_floor", **clock.fields(APPLICATIONS),
           "bytes": 2 * (lt.nbytes + lc.nbytes)}
    out["bound_ms"] = bound_ms(out["bytes"])
    spare = torch.empty_like(lt)
    lib = Clock(lt.device)
    with lib:
        for _ in range(APPLICATIONS):
            spare.copy_(lt)
            spare.copy_(lc)
    del spare
    out["library"] = "torch.Tensor.copy_, one log at a time into a spare"
    out.update({f"library_{k}": v for k, v in
                lib.fields(APPLICATIONS).items()})
    return out


def time_scatter(lt, lc, rows, vals, N: int, C: int, name: str) -> dict:
    """The deep scatter over 20 applications of scan_rows(rows, c, off)."""
    K = rows.shape[0] // N
    per = [scan_rows(rows, c, 0, C) for c in range(APPLICATIONS)]
    deep_scatter.scatter(lt, lc, per[0], vals, vals, N, C, K)
    clock = Clock(lt.device)
    with clock:
        for r in per:
            deep_scatter.scatter(lt, lc, r, vals, vals, N, C, K)
    nbytes = scatter_bytes(per[0], vals, N, C, lt.element_size())
    return {"probe": name, "K": K, **clock.fields(APPLICATIONS),
            "bytes": nbytes, "bound_ms": bound_ms(nbytes)}


def probe_lines(lt, lc, N: int, C: int, K: int, seed: int = 1):
    """Yield the probe's measurements on the logs (both modified in place:
    the copy leaves them as they were, the scatters write values)."""
    yield time_copy_floor(lt, lc)
    yield from scatter_lines(lt, lc, N, C, K, seed)


def scatter_lines(lt, lc, N: int, C: int, K: int, seed: int = 1):
    """Yield the scatter's measurements: clustered and uniform rows at K,
    then uniform rows at each K of K_SWEEP."""
    G, dev = lt.shape[-1], lt.device
    r = make_rows(G, C, N, K, dev, seed)
    for dist in ("clustered", "uniform"):
        yield time_scatter(lt, lc, r[dist], r["vals"], N, C,
                           f"scatter_{dist}")
    del r
    for Ks in K_SWEEP:
        rs = make_rows(G, C, N, Ks, dev, seed)
        yield time_scatter(lt, lc, rs["uniform"], rs["vals"], N, C,
                           "k_sweep")


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("shape", nargs="*", type=int, metavar="G C N K")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    G, C, N, K = (args.shape + [102_400, 10_000, 7, 8][len(args.shape):])[:4]
    dev = torch.device(args.device)
    if dev.type == "cpu":
        G, C, N = SMOKE
        where = {"device": "cpu"}
    elif not torch.cuda.is_available():
        print("probe_write_floor: needs an NVIDIA card (or --device cpu)",
              file=sys.stderr)
        return 2
    else:
        where = {"device": card_name()}
    print(json.dumps({**where, "G": G, "C": C, "N": N, "K": K,
                      "log_dtype": "int16"}), flush=True)
    lt, lc = make_logs(G, C, N, dev)
    for line in probe_lines(lt, lc, N, C, K):
        if dev.type == "cuda":
            sync()
        else:  # an H100 bound beside a host time would read as the card's
            line.pop("bound_ms")
        print(json.dumps({**line, **where}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
