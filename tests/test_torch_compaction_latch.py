"""The latch that chip_smoke.py's step 16c accepts, held to the JAX package:
the synchronous compaction family at the card's width latches invariant 6
(`snapshot_consistency`) at tick 45 in group 52,750. Per-tick draws are
keyed by a group's index, so the first 52,751 groups of that run are a run
of their own: the JAX package's make_run and the port's, with the monitor,
over those groups and ticks 0-45 agree in end state (snapshot planes
included) and monitor, and both latch the same violation. (On the card,
16c's runner ≡ the port's plain route with the same latch.) Tens of
minutes of XLA:CPU and torch on a CPU, hence slow.
"""

import jax
import numpy as np
import pytest

from raft_kotlin_tpu.models.state import init_state as j_init_state
from raft_kotlin_tpu.ops import tick as jtick
from raft_kotlin_tpu.utils import telemetry as jtel
from raft_kotlin_tpu.utils.config import RaftConfig as JConfig
from raft_kotlin_tpu_torch.models.state import (
    SNAPSHOT_FIELDS, STATE_FIELDS, init_state, state_to_numpy)
from raft_kotlin_tpu_torch.ops import tick as ttick
from raft_kotlin_tpu_torch.utils import telemetry as ttel
from raft_kotlin_tpu_torch.utils.config import RaftConfig

# chip_smoke.py's 16c family, and its KNOWN_LATCH entry: (status, groups up
# to the latched one, ticks up to the latched one).
SYNC = dict(n_nodes=3, log_capacity=64, cmd_period=3, p_drop=0.15, seed=11,
            compact_watermark=3, compact_chunk=1)
SYNC_LATCH = ("snapshot_consistency@t45/g52750", 52_751, 46)


@pytest.mark.slow
def test_sync_family_latch_matches_jax():
    status, groups, ticks = SYNC_LATCH
    jc = JConfig(n_groups=groups, **SYNC).stressed(10)
    tc = RaftConfig(n_groups=groups, **SYNC).stressed(10)
    jend, _, jmon = jax.device_get(jtick.make_run(
        jc, ticks, trace=False, monitor=True)(j_init_state(jc)))
    jm = jtel.summarize_monitor(jmon)
    assert jm["inv_status"] == status
    end, _, mon = ttick.make_run(tc, ticks, trace=False, monitor=True,
                                 device="cpu")(init_state(tc, "cpu"))
    got = state_to_numpy(end)
    for k in STATE_FIELDS + SNAPSHOT_FIELDS:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jend, k)),
                                      err_msg=k)
    assert ttel.summarize_monitor(mon) == jm
