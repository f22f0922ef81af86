"""Build the port's CUDA kernels from the sources in the checkout, at first use.

Each kernel source is compiled by `nvcc` for Hopper (`sm_90a`) into a shared
library with a plain C interface and loaded with ctypes. The sources include
no PyTorch header, so a build takes seconds where a `torch/extension.h`
binding built through `torch.utils.cpp_extension.load` takes minutes on the
same machine — and every fresh checkout builds anew. The libraries land in
`build/torch_ext/` at the repository root (listed in .gitignore), named by
a hash of the source, the shared headers and the flags, so an edited
source or header rebuilds and an unchanged one is reused. `build_many`
starts one nvcc per source, all at once, and waits for them together.

The tick kernels (KERNEL_SOURCES) take the node count as a compile-time
constant (`-DRAFT_N=`), and each is built twice: for the wide state layout
and, with `-DRAFT_PACKED=1`, for the §14 packed layout (its §18 packed-
compute instantiations included) — two libraries, two nvcc processes, so
the two sets of instantiations compile side by side. The fused kernel is
built once more for each node count and layout with `-DRAFT_OBSERVE=1`:
its observer build, which computes the flight recorder and the safety
monitor inside the launch (csrc/fused_tick_kernel.cu) — its own library
and nvcc process, so that the launches without observers keep their
instantiations as they were and the build does not double any one
process's work. Each fused library is split once more in two halves,
`-DRAFT_MAIL=0` (the synchronous instantiations) and `=1` (the §10
mailbox's): a config loads the half it runs, and the halves compile side
by side. The §15 compaction forms of both tick kernels (and of
kernel #7) are built apart again, with `-DRAFT_COMPACT=1`, one library
for each layout and observer choice: a compaction config loads those, any
other config the rest, and the new instantiations add their own nvcc
processes instead of lengthening the existing ones. The deep-log kernels
and the whole-log copy floor (DEEP_SOURCES) take every shape at run time
and are built once.

Only the functions that launch a kernel call into here; importing this
module needs neither a card nor a compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Optional

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
REPO = pathlib.Path(__file__).resolve().parents[2]
ARCH_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a",)
NVCC_FLAGS = ("-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v") + ARCH_FLAGS

_LOADED: dict = {}
# (source, defines) -> {"seconds": nvcc time (0 if reused), "log": output}
BUILD_INFO: dict = {}


def build_dir() -> pathlib.Path:
    d = REPO / "build" / "torch_ext"
    d.mkdir(parents=True, exist_ok=True)
    return d


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels are built from source at first use")


def _lib_path(source: str, defines: tuple,
              csrc: pathlib.Path = CSRC) -> pathlib.Path:
    src = (csrc / source).read_bytes()
    for h in sorted(csrc.glob("*.cuh")):
        src += h.name.encode() + h.read_bytes()
    h = hashlib.sha256(src + repr((NVCC_FLAGS, defines)).encode()).hexdigest()
    stem = pathlib.Path(source).stem + "".join(
        "_" + d.replace("=", "") for d in defines)
    return build_dir() / f"lib{stem}_{h[:16]}.so"


def start_builds(jobs, csrc: pathlib.Path = CSRC, niceness: int = 0) -> list:
    """Start one nvcc process for each (source, defines) of `jobs` — sources
    in `csrc`, the port's own by default — that has no up-to-date build,
    all at once, each at `niceness` (a process priority: 19 lets builds
    needed later take only what the processes at the normal priority leave
    of the CPU). Returns the started builds, for finish_builds."""
    started = []
    for source, defines in jobs:
        out = _lib_path(source, defines, csrc)
        key = (source if csrc == CSRC else str(csrc / source),
               tuple(defines))
        if out.exists():
            BUILD_INFO.setdefault(key, {"seconds": 0.0, "log": ""})
            started.append((key, out, None, None, None, 0.0))
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *(f"-D{d}" for d in defines),
               "-o", str(tmp), str(csrc / source)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            preexec_fn=(lambda: os.nice(niceness)) if niceness else None)
        started.append((key, out, tmp, cmd, proc, time.perf_counter()))
    return started


def finish_builds(started: list) -> list:
    """Wait for start_builds' processes; returns the library paths. Raises
    with nvcc's output if any build failed. BUILD_INFO is keyed by
    (source, defines), the source as a path when it is another tree's."""
    failed = []
    for key, out, tmp, cmd, proc, t0 in started:
        if proc is None:
            continue
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, out)
        BUILD_INFO[key] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return [out for _, out, *_ in started]


def cancel_builds(started: list) -> None:
    """Stop start_builds' processes that are still running (a caller that
    fails before finish_builds)."""
    for _, _, tmp, _, proc, _ in started:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.communicate()
            if tmp is not None and tmp.exists():
                tmp.unlink()


def build_many(jobs, csrc: pathlib.Path = CSRC) -> list:
    """Compile each (source, defines) of `jobs` unless an up-to-date build
    exists, one nvcc process per source, all started together
    (start_builds, finish_builds); returns the library paths."""
    return finish_builds(start_builds(jobs, csrc))


def build(source: str, defines: tuple = ()) -> pathlib.Path:
    """Compile csrc/`source` with `-D` `defines` unless an up-to-date build
    exists; returns the library path. Raises with nvcc's output on failure."""
    return build_many([(source, tuple(defines))])[0]


def tick_defines(n_nodes: int, packed: bool = False,
                 observe: bool = False, compact: bool = False,
                 mail: Optional[bool] = None) -> tuple:
    """The -D defines of a tick kernel library (`observe`: the fused
    kernel's observer build; `compact`: the §15 compaction forms; `mail`:
    a fused library's §10 mailbox half, or its synchronous half where
    False — None builds both)."""
    return (f"RAFT_N={n_nodes}",) + (("RAFT_PACKED=1",) if packed else ()) \
        + (("RAFT_OBSERVE=1",) if observe else ()) \
        + (("RAFT_COMPACT=1",) if compact else ()) \
        + ((f"RAFT_MAIL={int(mail)}",) if mail is not None else ())


def _load(source: str, n_nodes: int, launch: str, nodes: str,
          packed: bool = False, observe: bool = False,
          compact: bool = False, mail: Optional[bool] = None):
    key = (source, n_nodes, packed, observe, compact, mail)
    if key in _LOADED:
        return _LOADED[key]
    lib = ctypes.CDLL(str(build(source, tick_defines(n_nodes, packed,
                                                      observe, compact,
                                                      mail))))
    fn = getattr(lib, launch)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    getattr(lib, nodes).restype = ctypes.c_int
    layout = getattr(lib, nodes.replace("_nodes", "_packed"))
    layout.restype = ctypes.c_int
    forms = getattr(lib, nodes.replace("_nodes", "_compact"))
    forms.restype = ctypes.c_int
    half = getattr(lib, nodes.replace("_nodes", "_mail"), None)
    if half is not None:
        half.restype = ctypes.c_int
    if getattr(lib, nodes)() != n_nodes or layout() != int(packed) \
            or forms() != int(compact) or (half is not None and half() != (
                -1 if mail is None else int(mail))):
        raise RuntimeError(f"{source}: library built for the wrong node "
                           "count, layout or forms")
    if observe:
        lib.raft_fused_observe.restype = ctypes.c_int
        if lib.raft_fused_observe() != 1:
            raise RuntimeError(f"{source}: not the observer build")
    _LOADED[key] = lib
    return lib


KERNEL_SOURCES = ("tick_kernel.cu", "fused_tick_kernel.cu")
DEEP_SOURCES = ("deep_gather.cu", "deep_scatter.cu", "copy_floor.cu")


def _tick_jobs(n_nodes: int, packed: bool, compact: bool,
               mail: tuple) -> list:
    layouts = (False, True) if packed else (False,)
    return [("tick_kernel.cu", tick_defines(n_nodes, p, compact=compact))
            for p in layouts] + [
        ("fused_tick_kernel.cu", tick_defines(n_nodes, p, o, compact, m))
        for o in (False, True) for p in layouts for m in mail]


def build_jobs(n_nodes: int, packed: bool = True,
               mail: tuple = (False, True)) -> list:
    """(source, defines) of every kernel of the port but the §15 builds
    (compact_jobs): the tick kernels for groups of `n_nodes` (with their
    packed-layout builds unless `packed` is False), each fused library and
    its observer build in the halves `mail` names (False: synchronous,
    True: the §10 mailbox's), and the deep kernels."""
    return _tick_jobs(n_nodes, packed, False, mail) + [
        (src, ()) for src in DEEP_SOURCES]


def compact_jobs(n_nodes: int, packed: bool = True,
                 mail: tuple = (False, True)) -> list:
    """(source, defines) of the tick kernels' §15 builds for groups of
    `n_nodes`: the one-tick kernel, the fused kernel and its observer build
    (their halves `mail` names), wide and (unless `packed` is False)
    packed."""
    return _tick_jobs(n_nodes, packed, True, mail)


def build_all(n_nodes: int) -> list:
    """Build every kernel of the port for groups of `n_nodes`, the §15
    builds included, in parallel."""
    return build_many(build_jobs(n_nodes) + compact_jobs(n_nodes))


def load_deep_library(source: str) -> ctypes.CDLL:
    """A deep-log kernel's or the copy floor's library (one of
    DEEP_SOURCES), built on first
    use; its launch function is `raft_<stem>_launch(pointers, ints,
    stream)`."""
    key = (source, None)
    if key not in _LOADED:
        lib = ctypes.CDLL(str(build(source)))
        fn = getattr(lib, f"raft_{pathlib.Path(source).stem}_launch")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LOADED[key] = lib
    return _LOADED[key]


def check_operand(name: str, t: torch.Tensor, dtype, shape: tuple,
                  dev) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on `dev`:
    what a kernel's wrapper checks of each operand before it passes a
    pointer."""
    if t.device != dev:
        raise ValueError(f"{name}: on {t.device}, the kernel runs on {dev}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: got {t.dtype}{tuple(t.shape)}, the kernel "
                         f"takes {dtype}{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous tensors")


# A launch grid's y and z extents on the card, and the group counts a
# kernel with a 32-bit group index takes.
MAX_GRID_YZ = 65_535
MAX_GROUPS = 2 ** 31 - 1


def check_grid(what: str, y: int, z: int, groups: int) -> None:
    """Raise unless a (groups / ..., y, z) grid fits the card's limits."""
    if max(y, z) > MAX_GRID_YZ or groups > MAX_GROUPS:
        raise ValueError(f"{what}: grid y={y}, z={z} over G={groups} passes "
                         f"the launch's limits ({MAX_GRID_YZ}, {MAX_GROUPS})")


def check_offsets(what: str, rows: int, groups: int) -> None:
    """Raise unless every offset of a (rows, groups) operand fits the
    kernel's 32-bit indexing."""
    if rows * groups > MAX_GROUPS:
        raise ValueError(f"{what}: {rows} rows of G={groups} pass the "
                         f"kernel's 32-bit offsets ({MAX_GROUPS})")


def query_library(fn, ptrs: list, ints: tuple) -> int:
    """Call a kernel library's `fn(pointers, ints)`, which describes a
    launch without making it, and return its int."""
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn((ctypes.c_void_p * len(ptrs))(*ptrs),
              (ctypes.c_longlong * len(ints))(*ints))


def launch_library(fn, ptrs: list, ints: tuple, dev, what: str) -> None:
    """Call a kernel library's launch function `fn(pointers, ints, stream)`
    on the current stream of `dev`, without synchronising; raises on the
    CUDA error it returns."""
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_ints = (ctypes.c_longlong * len(ints))(*ints)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(c_ptrs, c_ints, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {err}")


def bind_tick_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a one-tick kernel library's entries (any
    tree's: kernel_ab.py loads several); `raft_tick_info`, where the
    library has it, describes a launch without making it."""
    for name in ("raft_tick_launch", "raft_tick_info"):
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def load_tick_library(n_nodes: int, packed: bool = False,
                      compact: bool = False) -> ctypes.CDLL:
    """The one-tick kernel's library for groups of `n_nodes` (N is a
    compile-time constant of the kernel), the wide or `packed` layout and
    the §15 forms (`compact`) or the others, built on first use."""
    return bind_tick_library(_load("tick_kernel.cu", n_nodes,
                                   "raft_tick_launch", "raft_tick_nodes",
                                   packed, compact=compact))


def load_fused_library(n_nodes: int, packed: bool = False,
                       observe: bool = False, compact: bool = False,
                       mail: Optional[bool] = None) -> ctypes.CDLL:
    """The fused-T kernel's library for groups of `n_nodes`, the wide or
    `packed` layout, the §15 forms (`compact`) or the others and the §10
    mailbox's instantiations (`mail`) or the synchronous ones (`observe`:
    its observer build, which holds `raft_fused_launch` alone), built on
    first use. In the wide layout the build without observers also holds
    kernel #7, `raft_k_tick_launch` (in the `compact` build its §15 form),
    and the build without observers or §15 forms the stand-alone §10 delay
    draw, `raft_delay_draw_launch` (the mailbox's half), and in the wide
    layout the §12 edge lattice alone, `raft_part_down_launch` (the
    synchronous half; described by `raft_part_down_info`)."""
    lib = _load("fused_tick_kernel.cu", n_nodes, "raft_fused_launch",
                "raft_fused_nodes", packed, observe, compact, mail)
    names = [] if observe or packed else ["raft_k_tick_launch",
                                          "raft_k_tick_info"]
    if not observe and not compact:
        names += ([] if mail is False else ["raft_delay_draw_launch"]) + (
            [] if packed or mail else ["raft_part_down_launch",
                                       "raft_part_down_info"])
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
