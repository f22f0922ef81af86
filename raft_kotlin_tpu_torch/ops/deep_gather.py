"""The deep-log engine's batched log-row read — the counterpart of the JAX
package's `ops/deep_gather.py::build_gather` (its `pallas_call` at :139).

    vals_t[n*Rt + r, g] = log_term[n*C + rows[n*Rt + r, g], g]
    vals_c[n*N + r, g] = log_cmd[n*C + rows[n*Rt + N + r, g], g]

with one row tensor for both logs: node n's cmd rows are its term rows
[N, 2N), the engine's entry rows (the JAX kernel takes them as a second
operand). Logs (N*C, G) in their storage dtype, rows (N*Rt, G) int32
LOCAL slots, values returned in the log dtype (the caller widens). The
engine clips every row to [0, C) before the call (ops/tick.phase_body's
batch builder); a row outside [0, C) reads 0 here, in both versions, so no
row can reach another node's slots.

- `gather_plain` is the plain PyTorch version (torch.gather on the flat
  logs with each node's row offset).
- `gather` launches the hand-written kernel `csrc/deep_gather.cu` for CUDA
  tensors and counts the launch; for CPU tensors it calls the plain
  version. Nothing on a CUDA tensor falls back to the plain version: a
  tensor the kernel does not take, a failed build or a failed launch
  raises.
"""

from __future__ import annotations

import torch

from raft_kotlin_tpu_torch.ops import build

# Kernel launches since the last reset_counts(); plain calls on CUDA
# tensors, so a run can show that no deep config took the plain read on a
# card unasked.
LAUNCHES = {"deep_gather": 0}
PLAIN_ON_CUDA = {"deep_gather": 0}

THREADS_PER_BLOCK = 256


def reset_counts() -> None:
    LAUNCHES["deep_gather"] = 0
    PLAIN_ON_CUDA["deep_gather"] = 0


def _read(log: torch.Tensor, rows: torch.Tensor, N: int, C: int):
    R = rows.shape[0] // N
    base = (torch.arange(N, dtype=torch.int64, device=rows.device) * C
            ).repeat_interleave(R)[:, None]
    ok = (rows >= 0) & (rows < C)
    vals = torch.gather(log, 0, base + rows.clamp(0, C - 1).to(torch.int64))
    return torch.where(ok, vals, torch.zeros((), dtype=log.dtype,
                                             device=log.device))


def cmd_rows(rows: torch.Tensor, N: int) -> torch.Tensor:
    """Node n's cmd rows, its term rows [N, 2N): (N*N, G)."""
    G = rows.shape[-1]
    return rows.view(N, -1, G)[:, N:2 * N].reshape(N * N, G)


def gather_plain(lt: torch.Tensor, lc: torch.Tensor, rows: torch.Tensor,
                 N: int, C: int) -> tuple:
    """(vals_t (N*Rt, G), vals_c (N*N, G)) in the logs' dtype."""
    if lt.device.type == "cuda":
        PLAIN_ON_CUDA["deep_gather"] += 1
    return _read(lt, rows, N, C), _read(lc, cmd_rows(rows, N), N, C)


def gather(lt: torch.Tensor, lc: torch.Tensor, rows: torch.Tensor, N: int,
           C: int) -> tuple:
    """The batched read: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. Returns new (vals_t, vals_c) in the logs' dtype."""
    dev = lt.device
    if dev.type == "cpu":
        return gather_plain(lt, lc, rows, N, C)
    if dev.type != "cuda":
        raise ValueError(f"gather runs on cuda (or cpu), not {dev}")
    if lt.dtype not in (torch.int16, torch.int32):
        raise ValueError(f"log dtype {lt.dtype}: the kernel takes int16 or "
                         "int32 logs")
    G = lt.shape[-1]
    Rt = rows.shape[0] // N
    if rows.shape[0] % N or Rt < 2 * N:
        raise ValueError("rows must hold Rt >= 2N rows per node (the cmd "
                         "rows are [N, 2N))")
    build.check_operand("log_term", lt, lt.dtype, (N * C, G), dev)
    build.check_operand("log_cmd", lc, lt.dtype, (N * C, G), dev)
    build.check_operand("rows", rows, torch.int32, (N * Rt, G), dev)
    vt = torch.empty((N * Rt, G), dtype=lt.dtype, device=dev)
    vc = torch.empty((N * N, G), dtype=lt.dtype, device=dev)
    lib = build.load_deep_library("deep_gather.cu")
    ints = (G, N, C, Rt, int(lt.dtype == torch.int16), THREADS_PER_BLOCK,
            dev.index if dev.index is not None
            else torch.cuda.current_device())
    build.launch_library(
        lib.raft_deep_gather_launch,
        [lt.data_ptr(), lc.data_ptr(), rows.data_ptr(), vt.data_ptr(),
         vc.data_ptr()], ints, dev, "deep gather")
    LAUNCHES["deep_gather"] += 1
    return vt, vc
