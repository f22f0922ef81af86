"""The deep-log engine's deferred log writes — the counterpart of the JAX
package's `ops/deep_scatter.py::build_scatter` (its two `pallas_call`
forms, `_build_scatter_grid` at :136 and `_build_scatter_dma` at :263).

For every (node n, lane g) and k < K, in place on both (N*C, G) logs:

    log_x[n*C + rows[n*K + k, g], g] = vals_x[n*K + k, g]

where rows (N*K, G) int32 are LOCAL slots and row == C means "dropped" (a
masked write); a row outside [0, C) writes nothing, so no write can reach
another node's slots. The caller's contract (the engine's chronological
resolution pass, ops/tick.phase_body): duplicate rows within one lane
already carry identical values, so the order in which the K writes land
does not matter.

- `scatter_plain` is the plain PyTorch version: K rounds of a masked
  read-modify-write of one row per (node, lane).
- `scatter` launches the hand-written kernel `csrc/deep_scatter.cu` for
  CUDA tensors and counts the launch; for CPU tensors it calls the plain
  version. Nothing on a CUDA tensor falls back to the plain version.
"""

from __future__ import annotations

import torch

from raft_kotlin_tpu_torch.ops import build

LAUNCHES = {"deep_scatter": 0}
PLAIN_ON_CUDA = {"deep_scatter": 0}

THREADS_PER_BLOCK = 256


def reset_counts() -> None:
    LAUNCHES["deep_scatter"] = 0
    PLAIN_ON_CUDA["deep_scatter"] = 0


def scatter_plain(lt: torch.Tensor, lc: torch.Tensor, rows: torch.Tensor,
                  vals_t: torch.Tensor, vals_c: torch.Tensor, N: int, C: int,
                  K: int) -> None:
    """Apply the writes in place (values in the logs' dtype)."""
    if lt.device.type == "cuda":
        PLAIN_ON_CUDA["deep_scatter"] += 1
    G = lt.shape[-1]
    base = (torch.arange(N, dtype=torch.int64, device=lt.device) * C)[:, None]
    r3 = rows.view(N, K, G)
    for k in range(K):
        r = r3[:, k]
        keep = (r >= 0) & (r < C)
        idx = base + r.clamp(0, C - 1).to(torch.int64)
        for log, vals in ((lt, vals_t), (lc, vals_c)):
            cur = torch.gather(log, 0, idx)
            log.scatter_(0, idx, torch.where(keep, vals.view(N, K, G)[:, k],
                                             cur))


def scatter(lt: torch.Tensor, lc: torch.Tensor, rows: torch.Tensor,
            vals_t: torch.Tensor, vals_c: torch.Tensor, N: int, C: int,
            K: int) -> None:
    """The deferred writes, in place: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    dev = lt.device
    if dev.type == "cpu":
        return scatter_plain(lt, lc, rows, vals_t, vals_c, N, C, K)
    if dev.type != "cuda":
        raise ValueError(f"scatter runs on cuda (or cpu), not {dev}")
    if lt.dtype not in (torch.int16, torch.int32):
        raise ValueError(f"log dtype {lt.dtype}: the kernel takes int16 or "
                         "int32 logs")
    G = lt.shape[-1]
    for name, t, dtype, rows_n in (
            ("log_term", lt, lt.dtype, N * C),
            ("log_cmd", lc, lt.dtype, N * C),
            ("rows", rows, torch.int32, N * K),
            ("vals_t", vals_t, lt.dtype, N * K),
            ("vals_c", vals_c, lt.dtype, N * K)):
        build.check_operand(name, t, dtype, (rows_n, G), dev)
    lib = build.load_deep_library("deep_scatter.cu")
    ints = (G, N, C, K, int(lt.dtype == torch.int16), THREADS_PER_BLOCK,
            dev.index if dev.index is not None
            else torch.cuda.current_device())
    build.launch_library(
        lib.raft_deep_scatter_launch,
        [lt.data_ptr(), lc.data_ptr(), rows.data_ptr(), vals_t.data_ptr(),
         vals_c.data_ptr()], ints, dev, "deep scatter")
    LAUNCHES["deep_scatter"] += 1
