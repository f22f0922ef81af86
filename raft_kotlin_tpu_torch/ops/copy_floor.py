"""The whole-log copy floor — the counterpart of the JAX package's probe
kernel `scripts/probe_write_floor.py::copy_floor_kernel` (`pallas_call` at
:89): both (N*C, G) deep logs read and written back whole, in place, with
no compute. The function is the identity; its time is the floor under a
whole-log write pass, the yardstick the deep scatter
(`ops/deep_scatter.py`) is measured against
(`raft_kotlin_tpu_torch/probe_write_floor.py`).

- `copy_floor_plain` is the plain PyTorch version: each log read whole and
  written back whole.
- `copy_floor` launches the hand-written kernel `csrc/copy_floor.cu` for
  CUDA tensors and counts the launch; for CPU tensors it calls the plain
  version. Nothing on a CUDA tensor falls back to the plain version.

The kernel moves the bytes through a Hopper bulk-copy ring (TMA).
"""

from __future__ import annotations

import torch

from raft_kotlin_tpu_torch.ops import build

LAUNCHES = {"copy_floor": 0}
PLAIN_ON_CUDA = {"copy_floor": 0}

THREADS_PER_BLOCK = 32  # the kernel's __launch_bounds__


def reset_counts() -> None:
    LAUNCHES["copy_floor"] = 0
    PLAIN_ON_CUDA["copy_floor"] = 0


def copy_floor_plain(lt: torch.Tensor, lc: torch.Tensor) -> None:
    """Read each log whole and write it back whole, in place."""
    if lt.device.type == "cuda":
        PLAIN_ON_CUDA["copy_floor"] += 1
    for log in (lt, lc):
        log.copy_(log.clone())


def copy_floor(lt: torch.Tensor, lc: torch.Tensor) -> None:
    """Both logs through the card's memory once each way, in place: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    dev = lt.device
    if dev.type == "cpu":
        return copy_floor_plain(lt, lc)
    if dev.type != "cuda":
        raise ValueError(f"copy_floor runs on cuda (or cpu), not {dev}")
    if lt.dtype not in (torch.int16, torch.int32):
        raise ValueError(f"log dtype {lt.dtype}: the kernel takes int16 or "
                         "int32 logs")
    build.check_operand("log_term", lt, lt.dtype, lt.shape, dev)
    build.check_operand("log_cmd", lc, lt.dtype, lt.shape, dev)
    lib = build.load_deep_library("copy_floor.cu")
    build.launch_library(
        lib.raft_copy_floor_launch, [lt.data_ptr(), lc.data_ptr()],
        (lt.nbytes, THREADS_PER_BLOCK,
         dev.index if dev.index is not None else torch.cuda.current_device()),
        dev, "copy floor")
    LAUNCHES["copy_floor"] += 1
