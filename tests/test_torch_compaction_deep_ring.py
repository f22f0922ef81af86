"""The §16 deep ring past its wrap, in the PyTorch port, against the JAX
package on the CPU at tolerance zero: a dyn-log compaction config on the
smallest ring that keeps the deep engines (256 rows of 512), run for 640
ticks, until the positions pass 256 and the ring's slots hold a second
position each. Both of the port's deep engines — the batched one (the deep
gather #6 and scatter #5 at ring slots, the window test on recycled slots)
and the per-pair one — ≡ one JAX per-pair make_run on the same ring in
every field, the ring's rows included, in the trace, the recorder and the
monitor. Some groups latch the capacity flag (a follower-local window
outgrows the ring); others wrap with no latch, which the test asserts.
The tick-end ghost overlay keys on positions, not slots; the two differ
only where two nodes' positions lie a multiple of 256 apart in one tick,
which this run does not reach.
"""

import jax
import numpy as np
import pytest
import torch

from raft_kotlin_tpu.models.state import init_state as j_init_state
from raft_kotlin_tpu.ops import tick as jtick
from raft_kotlin_tpu.utils import telemetry as jtel
from raft_kotlin_tpu.utils.config import RaftConfig as JConfig
from raft_kotlin_tpu_torch.models.state import init_state, state_to_numpy
from raft_kotlin_tpu_torch.ops import tick as ttick
from raft_kotlin_tpu_torch.utils import telemetry as ttel
from raft_kotlin_tpu_torch.utils.config import RaftConfig

# chip_smoke.py's step 16e runs this config at the card's width; its first
# 16 groups are this run.
RING = dict(n_groups=16, n_nodes=3, log_capacity=512, log_dtype="int16",
            cmd_period=2, p_drop=0.1, seed=5, compact_watermark=3,
            compact_chunk=2, ring_capacity=256)
TICKS = 640


@pytest.fixture(scope="module")
def jax_run():
    jc = JConfig(**RING).stressed(10)
    end, tr, tel, mon = jtick.make_run(jc, TICKS, trace=True, telemetry=True,
                                       monitor=True, batched=False)(
        j_init_state(jc))
    return (jax.device_get(end), {k: np.asarray(v) for k, v in tr.items()},
            jtel.summarize_telemetry(tel), jtel.summarize_monitor(mon))


@pytest.mark.parametrize("batched", [True, False])
def test_deep_engines_past_the_wrap_equal_jax(jax_run, batched):
    jend, jtr, jtel_s, jmon_s = jax_run
    tc = RaftConfig(**RING).stressed(10)
    flags = ttick.make_flags(tc, batched=batched)
    assert flags.dyn_log and flags.compact and flags.batched == batched
    end, tr, tel, mon = ttick.make_run(
        tc, TICKS, trace=True, telemetry=True, monitor=True, impl="kernel",
        batched=batched, device="cpu")(init_state(tc, "cpu"))
    got = state_to_numpy(end)
    assert got["log_term"].shape[1] == tc.phys_capacity == 256
    for k in end.fields():
        want = np.asarray(getattr(jend, k))
        assert got[k].dtype == want.dtype, k
        np.testing.assert_array_equal(got[k], want, err_msg=k)
    for k in jtr:
        np.testing.assert_array_equal(tr[k].numpy(), jtr[k], err_msg=k)
    assert ttel.summarize_telemetry(tel) == {
        k: v for k, v in jtel_s.items() if k in ttel.TELEMETRY_FIELDS}
    assert ttel.summarize_monitor(mon) == jmon_s
    # The wrap: groups whose positions passed the ring with no latch, and
    # whose snapshots passed it too (every slot below recycled).
    last = torch.as_tensor(got["last_index"]).amax(0)
    snap = torch.as_tensor(got["snap_index"]).amax(0)
    clean = (torch.as_tensor(got["cap_ov"]) == 0).all(0)
    assert int((clean & (last > 256)).sum()) >= 4
    assert int(snap[clean].max()) > 256
    assert jtel_s["snapshots_taken"] > 0
    assert jtel_s["installsnap_deliveries"] > 0
