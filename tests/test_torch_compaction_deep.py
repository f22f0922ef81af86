"""§15 compaction on deep logs (phys_capacity >= 256) in the PyTorch port,
against the JAX package on the CPU at tolerance zero: the int16 deep config
of the JAX package's test_identity_int16_deep, 30 ticks, on the port's two
deep engines — the batched one (the deep gather #6 and scatter #5 reading
and writing ring slots, the tick-end ghost overlay keyed by positions) and
the per-pair one — each ≡ one JAX per-pair make_run (the JAX package's own
suite holds its batched engine ≡ its per-pair one); and the same config on
a 256-row ring (§16), whose runs ≡ that JAX run in every non-log field and
in the log rows the positions reached.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from raft_kotlin_tpu.models.state import init_state as j_init_state
from raft_kotlin_tpu.ops import tick as jtick
from raft_kotlin_tpu.utils import telemetry as jtel
from raft_kotlin_tpu.utils.config import RaftConfig as JConfig
from raft_kotlin_tpu_torch.models.state import (
    LOG_FIELDS, init_state, state_to_numpy)
from raft_kotlin_tpu_torch.ops import tick as ttick
from raft_kotlin_tpu_torch.utils import telemetry as ttel
from raft_kotlin_tpu_torch.utils.config import RaftConfig

DEEP = dict(n_groups=8, n_nodes=3, log_capacity=512, log_dtype="int16",
            cmd_period=2, p_drop=0.1, seed=5, compact_watermark=3,
            compact_chunk=2)
TICKS = 30


@pytest.fixture(scope="module")
def jax_run():
    jc = JConfig(**DEEP).stressed(10)
    end, tr, tel, mon = jtick.make_run(jc, TICKS, trace=True, telemetry=True,
                                       monitor=True, batched=False)(
        j_init_state(jc))
    return (jax.device_get(end), {k: np.asarray(v) for k, v in tr.items()},
            jtel.summarize_telemetry(tel), jtel.summarize_monitor(mon))


@pytest.mark.parametrize("ring", [None, 256])
@pytest.mark.parametrize("batched", [True, False])
def test_deep_engines_equal_jax(jax_run, ring, batched):
    jend, jtr, jtel_s, jmon_s = jax_run
    tc = RaftConfig(**DEEP).stressed(10)
    if ring is not None:
        tc = dataclasses.replace(tc, ring_capacity=ring)
    flags = ttick.make_flags(tc, batched=batched)
    assert flags.dyn_log and flags.compact and flags.batched == batched
    end, tr, tel, mon = ttick.make_run(
        tc, TICKS, trace=True, telemetry=True, monitor=True, impl="kernel",
        batched=batched, device="cpu")(init_state(tc, "cpu"))
    got = state_to_numpy(end)
    C = tc.phys_capacity
    for k in end.fields():
        want = np.asarray(getattr(jend, k))
        if k in LOG_FIELDS:
            # The positions stay below the ring: its rows are the full
            # window's first C rows, the rest of which were never written.
            assert not want[:, C:].any()
            want = want[:, :C]
        assert got[k].dtype == want.dtype, k
        np.testing.assert_array_equal(got[k], want, err_msg=k)
    for k in jtr:
        np.testing.assert_array_equal(tr[k].numpy(), jtr[k], err_msg=k)
    assert ttel.summarize_telemetry(tel) == {
        k: v for k, v in jtel_s.items() if k in ttel.TELEMETRY_FIELDS}
    assert ttel.summarize_monitor(mon) == jmon_s
    assert jtel_s["snapshots_taken"] > 0
    assert int(torch.as_tensor(end.snap_index).max()) > 0
