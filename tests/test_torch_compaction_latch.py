"""The latches that chip_smoke.py's steps 16c and 17 accept, held to the
JAX package: at the card's width the synchronous compaction family latches
invariant 6 (`snapshot_consistency`) at tick 45 in group 52,750, the
MAILBOX family `commit_monotonic` at tick 34 in group 15,836 and the
mailbox install bank `log_matching` at tick 40 in group 64,306. Per-tick
draws are keyed by a group's index (a bank's rows by its universe id), so
the first groups of such a run, up to the latched one, are a run of their
own: the JAX package's make_run and the port's, with the monitor, over
those groups and ticks agree in end state (snapshot planes and slots
included) and monitor, and both latch the same violation. (On the card,
each leg's runner ≡ the port's plain route with the same latch.) Minutes
to tens of minutes of XLA:CPU and torch on a CPU, hence slow.
"""

import jax
import numpy as np
import pytest

from raft_kotlin_tpu.models.state import init_state as j_init_state
from raft_kotlin_tpu.ops import tick as jtick
from raft_kotlin_tpu.utils import telemetry as jtel
from raft_kotlin_tpu.utils.config import RaftConfig as JConfig
from raft_kotlin_tpu.utils.config import ScenarioSpec as JSpec
from raft_kotlin_tpu_torch.models.state import (
    SNAPSHOT_FIELDS, STATE_FIELDS, init_state, state_to_numpy)
from raft_kotlin_tpu_torch.ops import tick as ttick
from raft_kotlin_tpu_torch.utils import telemetry as ttel
from raft_kotlin_tpu_torch.utils.config import RaftConfig, ScenarioSpec

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


# chip_smoke.py's step-17 families (chip_smoke.compact_family) and their
# KNOWN_LATCH entries: (config, status, groups up to the latched one, ticks
# up to the latched one).
MAILBOX = dict(n_nodes=3, log_capacity=64, cmd_period=3, p_drop=0.2,
               delay_lo=1, delay_hi=3, seed=7, compact_watermark=4,
               compact_chunk=2)
INSTALL = dict(n_nodes=3, log_capacity=32, cmd_period=5, seed=9,
               delay_lo=1, delay_hi=3, compact_watermark=4, compact_chunk=4)
INSTALL_BANK = dict(farm_seed=21, drop_max=0.1, crash_max=0.05,
                    restart_max=0.3)
FORMS_LATCHES = {
    "mailbox": (MAILBOX, None, "commit_monotonic@t34/g15836", 15_837, 35),
    "install": (INSTALL, INSTALL_BANK, "log_matching@t40/g64306", 64_307,
                41)}


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(FORMS_LATCHES))
def test_forms_family_latch_matches_jax(name):
    kw, bank, status, groups, ticks = FORMS_LATCHES[name]
    jc = JConfig(n_groups=groups, scenario=None if bank is None
                 else JSpec(**bank), **kw).stressed(10)
    tc = RaftConfig(n_groups=groups, scenario=None if bank is None
                    else ScenarioSpec(**bank), **kw).stressed(10)
    jend, _, jmon = jax.device_get(jtick.make_run(
        jc, ticks, trace=False, monitor=True)(j_init_state(jc)))
    jm = jtel.summarize_monitor(jmon)
    assert jm["inv_status"] == status
    end, _, mon = ttick.make_run(tc, ticks, trace=False, monitor=True,
                                 device="cpu")(init_state(tc, "cpu"))
    got = state_to_numpy(end)
    for k in end.fields():
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jend, k)),
                                      err_msg=k)
    assert ttel.summarize_monitor(mon) == jm
