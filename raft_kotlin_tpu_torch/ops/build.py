"""Build the port's CUDA kernels from the sources in the checkout, at first use.

Each kernel source is compiled by `nvcc` for Hopper (`sm_90a`) into a shared
library with a plain C interface and loaded with ctypes. The sources include
no PyTorch header, so a build takes seconds where a `torch/extension.h`
binding built through `torch.utils.cpp_extension.load` takes minutes on the
same machine — and every fresh checkout builds anew. The libraries land in
`build/torch_ext/` at the repository root (listed in .gitignore), named by
a hash of the source and the flags, so an edited source rebuilds and an
unchanged one is reused.

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


def _lib_path(source: str, defines: tuple) -> pathlib.Path:
    src = (CSRC / source).read_bytes()
    h = hashlib.sha256(src + repr((NVCC_FLAGS, defines)).encode()).hexdigest()
    stem = pathlib.Path(source).stem + "".join(
        "_" + d.replace("=", "") for d in defines)
    return build_dir() / f"lib{stem}_{h[:16]}.so"


def build(source: str, defines: tuple = ()) -> pathlib.Path:
    """Compile csrc/`source` with `-D` `defines` unless an up-to-date build
    exists; returns the library path. Raises with nvcc's output on failure."""
    out = _lib_path(source, defines)
    key = (source, defines)
    if out.exists():
        BUILD_INFO.setdefault(key, {"seconds": 0.0, "log": ""})
        return out
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *(f"-D{d}" for d in defines),
           "-o", str(tmp), str(CSRC / source)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    dt = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    BUILD_INFO[key] = {"seconds": dt, "log": res.stdout + res.stderr}
    return out


def load_tick_library(n_nodes: int) -> ctypes.CDLL:
    """The tick kernel's library for groups of `n_nodes` (N is a
    compile-time constant of the kernel), built on first use."""
    if n_nodes in _LOADED:
        return _LOADED[n_nodes]
    lib = ctypes.CDLL(str(build("tick_kernel.cu", (f"RAFT_N={n_nodes}",))))
    lib.raft_tick_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p]
    lib.raft_tick_launch.restype = ctypes.c_int
    lib.raft_tick_nodes.restype = ctypes.c_int
    if lib.raft_tick_nodes() != n_nodes:
        raise RuntimeError("tick library built for the wrong node count")
    _LOADED[n_nodes] = lib
    return lib
