"""Kernel #8's path on the CPU: the whole-log copy floor's plain version
(raft_kotlin_tpu_torch/ops/copy_floor.py) and the port's write-floor probe
(raft_kotlin_tpu_torch/probe_write_floor.py), the counterpart of the JAX
package's scripts/probe_write_floor.py:

- copy_floor_plain, and copy_floor on CPU tensors, leave both logs as they
  were (the function is the identity), at odd shapes and from a view that
  does not start at its buffer's start;
- the probe's rows follow the JAX probe's scan20 rule, (r + c + off) % C
  where r < C and C (a dropped write) elsewhere, computed here with jnp;
- the scatter bound's byte count on a hand-counted case;
- `python -m raft_kotlin_tpu_torch.probe_write_floor --device cpu` prints
  its JSON lines at the smoke scale (G=8, C=1024, N=3), host times only,
  and without a card and without --device cpu it fails.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_kotlin_tpu_torch import probe_write_floor as probe
from raft_kotlin_tpu_torch.ops import copy_floor

REPO = pathlib.Path(__file__).resolve().parents[1]


def env():
    e = dict(os.environ)
    e["PYTHONPATH"] = str(REPO) + os.pathsep + e.get("PYTHONPATH", "")
    return e


@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
@pytest.mark.parametrize("shape,offset", [((3 * 1001, 37), 0),
                                          ((7 * 13, 11), 3)])
def test_copy_floor_is_the_identity(dtype, shape, offset):
    rng = np.random.default_rng(shape[0] + offset)
    buf = torch.from_numpy(rng.integers(-30_000, 30_000,
                                        (2, shape[0] * shape[1] + offset))
                           ).to(dtype)
    want = buf.clone()
    lt, lc = (x[offset:].view(shape) for x in buf)
    copy_floor.copy_floor_plain(lt, lc)
    assert torch.equal(buf, want)
    copy_floor.copy_floor(lt, lc)  # a CPU tensor: the plain version
    assert torch.equal(buf, want)
    assert copy_floor.LAUNCHES["copy_floor"] == 0
    assert copy_floor.PLAIN_ON_CUDA["copy_floor"] == 0


def test_probe_rows_follow_scan20():
    C = 1024
    rng = np.random.default_rng(7)
    rows = rng.integers(0, C + 1, (3 * 8, 8)).astype(np.int32)
    rows[0, :3] = C  # dropped writes stay dropped
    jrows = jnp.asarray(rows)
    for c in (0, 1, 19):
        for off in (0, 5, C - 1):
            # scripts/probe_write_floor.py::scan20's body.
            want = jnp.where(jrows < C, (jrows + c + off) % C, C)
            got = probe.scan_rows(torch.from_numpy(rows), c, off, C)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scatter_bytes_count_distinct_sectors():
    # N=1, C=4, G=32, int16: rows 0 and 1 in lanes 0-15 fall in two 32-byte
    # sectors of the first row band; lanes 16-31 drop (row C).
    N, C, G = 1, 4, 32
    rows = torch.full((2, G), C, dtype=torch.int32)
    rows[0, :16], rows[1, :16] = 0, 1
    vals = torch.ones((2, G), dtype=torch.int16)
    want = rows.nbytes + 2 * vals.nbytes + 2 * 2 * 32 * 2
    assert probe.scatter_bytes(rows, vals, N, C, 2) == want


def test_probe_runs_at_smoke_scale_on_the_cpu():
    r = subprocess.run([sys.executable, "-m",
                        "raft_kotlin_tpu_torch.probe_write_floor",
                        "--device", "cpu"], cwd=REPO, env=env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    lines = [json.loads(x) for x in r.stdout.splitlines()]
    head, body = lines[0], lines[1:]
    assert (head["G"], head["C"], head["N"], head["device"]) == (
        8, 1024, 3, "cpu")
    assert [x["probe"] for x in body] == [
        "copy_floor", "scatter_clustered", "scatter_uniform", "k_sweep",
        "k_sweep", "k_sweep"]
    assert [x["K"] for x in body[3:]] == list(probe.K_SWEEP)
    for x in body:
        assert "ms" not in x and "bound_ms" not in x
        assert x["host_ms"] > 0 and x["bytes"] > 0
    assert body[0]["bytes"] == 4 * 3 * 1024 * 8 * 2


def test_probe_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid")
    r = subprocess.run([sys.executable, "-m",
                        "raft_kotlin_tpu_torch.probe_write_floor"], cwd=REPO,
                       env=env(), capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout == ""
