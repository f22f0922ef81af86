"""Build a kernel source of the port for the CPU, with g++ against a host
stand-in for the CUDA runtime (csrc/host/cuda_runtime.h), so that a
kernel's logic — its arithmetic, its shared-memory tiles, its barriers —
runs on CPU tensors through the same C interface as on the card.

Each `kern<<<blocks, threads, smem, stream>>>(args)` launch becomes a call
of the stand-in's `host_launch`, which runs the blocks in turn, each as
`threads` host threads; `extern __shared__` arrays become the launch's
dynamic shared-memory buffer; -DRAFT_HOST_STUB turns tile.cuh's bulk
copies into memcpy. Nothing here runs on or measures a card: it is for
tests and rehearsals on a machine without one. Libraries land in
build/host_ext/ (ignored by git), named by a hash of the sources and the
defines.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess

from raft_kotlin_tpu_torch.ops.build import CSRC, REPO

HOST_INCLUDE = CSRC / "host"
_LAUNCH = re.compile(r"(\w+(?:<[^<>;]*>)?)<<<(.+?)>>>\((.*?)\);", re.S)
_EXTERN_SHARED = re.compile(
    r"extern __shared__ (?:__align__\(\d+\) )?([\w ]+?) (\w+)\[\];")


def compiler() -> str | None:
    """The host C++ compiler, or None where the machine has none."""
    return shutil.which("g++")


def host_source(text: str) -> str:
    """A kernel source rewritten for the host stand-in."""
    text = _EXTERN_SHARED.sub(
        lambda m: f"{m.group(1)}* {m.group(2)} = "
                  f"reinterpret_cast<{m.group(1)}*>(host_shared_memory());",
        text)
    return _LAUNCH.sub(lambda m: f"host_launch({m.group(1)}, {m.group(2)}, "
                                 f"{m.group(3)});", text)


def build_host(source: str, defines: tuple = ()) -> ctypes.CDLL:
    """Compile csrc/`source` with -D `defines` for the host (once per
    content) and load it. Raises with the compiler's output on failure."""
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no host C++ compiler (g++) on PATH")
    out_dir = REPO / "build" / "host_ext"
    work = out_dir / "src"
    work.mkdir(parents=True, exist_ok=True)
    texts = {p.name: p.read_text() for p in sorted(CSRC.glob("*.cuh"))}
    texts[source] = host_source((CSRC / source).read_text())
    key = hashlib.sha256(repr((sorted(texts.items()), defines,
                               (HOST_INCLUDE / "cuda_runtime.h")
                               .read_text())).encode()).hexdigest()[:16]
    lib = out_dir / f"lib{source.split('.')[0]}_{key}.so"
    if not lib.exists():
        src_dir = work / key
        src_dir.mkdir(exist_ok=True)
        for name, text in texts.items():
            (src_dir / name).write_text(text)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, "-std=c++20", "-O1", "-shared", "-fPIC",
               "-DRAFT_HOST_STUB", f"-I{HOST_INCLUDE}", f"-I{src_dir}",
               "-x", "c++", *(f"-D{d}" for d in defines), "-o", str(tmp),
               str(src_dir / source), "-lpthread"]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"host build failed:\n{' '.join(cmd)}\n"
                               f"{proc.stderr[-4000:]}")
        tmp.replace(lib)
    return ctypes.CDLL(str(lib))
