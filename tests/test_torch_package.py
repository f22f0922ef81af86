"""Package boundaries of the PyTorch port: it imports nothing of JAX or of
the JAX package, and a CUDA request on a machine without a card fails
instead of falling back to the CPU. (The CLI's CPU run is held against the
JAX run in test_torch_tick.py, which already holds that JAX run.)"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "raft_kotlin_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]
CLI_ARGS = ["--groups", "8", "--nodes", "3", "--ticks", "60"]


def env():
    e = dict(os.environ)
    e["PYTHONPATH"] = str(REPO) + os.pathsep + e.get("PYTHONPATH", "")
    return e


def imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for mod in imported_modules(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "flax", "raft_kotlin_tpu"), (
            f"{path.relative_to(REPO)} imports {mod}")


def test_importing_the_port_loads_no_jax():
    code = ("import sys, raft_kotlin_tpu_torch, raft_kotlin_tpu_torch.__main__"
            ", raft_kotlin_tpu_torch.ops.cuda_tick, raft_kotlin_tpu_torch.ops"
            ".build; bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'raft_kotlin_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env(),
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


def test_cli_without_a_card_fails_instead_of_falling_back():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid")
    r = subprocess.run([sys.executable, "-m", "raft_kotlin_tpu_torch", "run",
                        *CLI_ARGS], cwd=REPO, env=env(), capture_output=True,
                       text=True)
    assert r.returncode != 0
    assert "cuda" in r.stderr and not r.stdout.strip()


def test_chip_smoke_refuses_without_a_card_or_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: chip_smoke.py would run")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env(),
                       capture_output=True, text=True)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    bare = dict(os.environ, PYTHONPATH="")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=bare, capture_output=True, text=True)
    assert r.returncode != 0 and '"ok"' not in r.stdout
