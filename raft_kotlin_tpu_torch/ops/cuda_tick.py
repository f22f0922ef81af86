"""The tick kernel's wrapper — the counterpart of the JAX package's
`ops/pallas_tick.py` (make_pallas_tick at T=1 with staged aux).

`tick_kernel(cfg, s, aux, flags)` computes what `ops/tick.phase_body`
computes. For CUDA tensors it launches the hand-written CUDA kernel
(`csrc/tick_kernel.cu`, built at first use by `ops/build.py`) on the current
stream, in place, and counts the launch; for CPU tensors it calls the plain
phase_body. Nothing on a CUDA tensor falls back to the plain version: a
tensor the kernel does not take, a failed build or a failed launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from raft_kotlin_tpu_torch.models.state import (
    LOG_FIELDS, PAIR_FIELDS, STATE_FIELDS, field_dtype)
from raft_kotlin_tpu_torch.ops import tick as tick_mod
from raft_kotlin_tpu_torch.utils.config import RaftConfig

# Launches per kernel since the last reset_launch_counts(); a wrapper adds
# one exactly where it launches its kernel.
LAUNCHES = {"tick_kernel": 0}

THREADS_PER_BLOCK = 128  # the kernel's __launch_bounds__

# Aux operands in the kernel's Params order, with their dtypes and rows.
_AUX = (("edge_iid", torch.int16, "pairs"), ("crash_m", torch.bool, "nodes"),
        ("restart_m", torch.bool, "nodes"), ("link_fail", torch.int16, "pairs"),
        ("link_heal", torch.int16, "pairs"),
        ("el_draw_f", torch.int16, "nodes"), ("bdraw", torch.int16, "nodes"),
        ("periodic", torch.int32, "one"), ("inject", torch.int32, "nodes"))
_FLAG_BITS = {"faults": 1, "links": 2, "periodic": 4, "inject": 8}
_NEEDS = {"faults": ("crash_m", "restart_m", "el_draw_f"),
          "links": ("link_fail", "link_heal"), "periodic": ("periodic",),
          "inject": ("inject",)}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(name, t, dtype, shape, dev):
    if t.device != dev:
        raise ValueError(f"{name}: on {t.device}, the kernel runs on {dev}")
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name}: got {t.dtype}{tuple(t.shape)}, the kernel "
                         f"takes {dtype}{shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous tensors")


def kernel_operands(cfg: RaftConfig, s: dict, aux: dict,
                    flags: tick_mod.BodyFlags) -> tuple:
    """Check every operand the kernel takes (device, dtype, shape,
    contiguity) and return (tensors in Params order with None for disabled
    aux channels, flag bits). Raises on anything the kernel does not take."""
    dev = s["term"].device
    tick_mod.check_flags(flags)
    N, C, G = cfg.n_nodes, cfg.phys_capacity, s["term"].shape[-1]
    if G < 1:
        raise ValueError("tick_kernel needs at least one group")
    rows = {"nodes": N, "pairs": N * N, "one": 1}
    ops = []
    for k in STATE_FIELDS:
        r = N * N if k in PAIR_FIELDS else N * C if k in LOG_FIELDS else N
        _check(k, s[k], field_dtype(k, cfg), (r, G), dev)
        ops.append(s[k])
    bits = 0
    for name, bit in _FLAG_BITS.items():
        if getattr(flags, name):
            bits |= bit
    enabled = {"edge_iid", "bdraw"}.union(
        *(_NEEDS[f] for f in _NEEDS if getattr(flags, f)))
    for name, dtype, kind in _AUX:
        if name in enabled:
            _check(name, aux[name], dtype, (rows[kind], G), dev)
            ops.append(aux[name])
        else:
            ops.append(None)
    return ops, bits


def tick_kernel(cfg: RaftConfig, s: dict, aux: dict,
                flags: tick_mod.BodyFlags) -> torch.Tensor:
    """One tick of the phase lattice on the flat state dict `s` (views from
    ops/tick.flatten_state), in place; returns el_dirty (N, G) bool."""
    dev = s["term"].device
    if dev.type == "cpu":
        return tick_mod.phase_body(cfg, s, aux, flags)
    if dev.type != "cuda":
        raise ValueError(f"tick_kernel runs on cuda (or cpu), not {dev}")
    ops, bits = kernel_operands(cfg, s, aux, flags)
    N, C, G = cfg.n_nodes, cfg.phys_capacity, s["term"].shape[-1]
    el_dirty = torch.empty((N, G), dtype=torch.bool, device=dev)
    ptrs = [None if t is None else t.data_ptr() for t in ops]
    ptrs.append(el_dirty.data_ptr())

    from raft_kotlin_tpu_torch.ops.build import load_tick_library

    lib = load_tick_library(N)
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    # The library links its own CUDA runtime, so it is told the device too.
    ints = (ctypes.c_longlong * 11)(
        G, C, cfg.majority, cfg.hb_ticks, cfg.round_ticks, cfg.retry_ticks,
        cfg.cmd_node, bits, int(cfg.log_dtype == "int16"), THREADS_PER_BLOCK,
        dev.index if dev.index is not None else torch.cuda.current_device())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.raft_tick_launch(c_ptrs, ints, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"tick kernel launch failed: cudaError_t {err}")
    LAUNCHES["tick_kernel"] += 1
    return el_dirty


def make_cuda_tick(cfg: RaftConfig, device="cuda"):
    """tick(state, inject=None, fault_cmd=None) -> state: the contract of the
    JAX package's make_pallas_tick(cfg) at T=1 with staged aux — make_aux,
    then the tick kernel (the plain phase_body for a CPU state), then the
    §7 deferred election draws — updating `state` in place."""
    return tick_mod.make_stepper(cfg, device, tick_kernel)
