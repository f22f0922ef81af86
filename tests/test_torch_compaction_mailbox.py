"""§15 compaction under the §10 mailbox in the PyTorch port, against the JAX
package on the CPU at tolerance zero (integers): the JAX package's `MAILBOX`
([1, 3] delays) and `TAU0` (τ=0) compaction families
(tests/test_compaction.py), where an InstallSnapshot rides the append slot
(aq_hase == 2) and the mailbox keeps the per-pair engine. The port's
make_run ≡ the JAX package's make_run in the trace, the recorder, the
monitor and every field of the end state (the slots and the snapshot
planes included), and so do the tick kernels' plain versions
(make_cuda_scan on the CPU: the fused kernel in-kernel with its observers'
plain form, and staged with the one-tick kernel's remainder). One JAX run
per config, in a module-scoped fixture,
stepped tick by tick (jitting the JAX package's τ=0 mailbox scan costs
minutes of XLA:CPU compile; its tick, stepped, ~25 s).
"""

import jax
import numpy as np
import pytest

from raft_kotlin_tpu.models.state import init_state as j_init_state
from raft_kotlin_tpu.ops import tick as jtick
from raft_kotlin_tpu.utils import telemetry as jtel
from raft_kotlin_tpu.utils.config import RaftConfig as JConfig
from raft_kotlin_tpu_torch.models.state import init_state, state_to_numpy
from raft_kotlin_tpu_torch.ops import cuda_tick
from raft_kotlin_tpu_torch.ops import tick as ttick
from raft_kotlin_tpu_torch.ops.cuda_scan import make_cuda_scan
from raft_kotlin_tpu_torch.utils import telemetry as ttel
from raft_kotlin_tpu_torch.utils.config import RaftConfig

CONFIGS = {
    "mailbox": (dict(n_groups=8, n_nodes=3, log_capacity=64, cmd_period=3,
                     p_drop=0.2, delay_lo=1, delay_hi=3, seed=7,
                     compact_watermark=4, compact_chunk=2), 60),
    "tau0": (dict(n_groups=8, n_nodes=3, log_capacity=64, cmd_period=3,
                  p_drop=0.2, mailbox=True, seed=7, compact_watermark=2,
                  compact_chunk=2), 25),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request):
    kw, T = CONFIGS[request.param]
    jc = JConfig(**kw).stressed(10)
    tick = jtick.make_tick(jc)
    mstep = jax.jit(jtel.monitor_step)
    st = j_init_state(jc)
    tel = jtel.telemetry_zeros()
    mon = jtel.monitor_init(jc.n_groups, T)
    ys = []
    for _ in range(T):
        nxt = tick(st)
        tel = jtel.telemetry_step(st, nxt, tel)
        mon = mstep(st, nxt, mon)
        ys.append({k: np.asarray(getattr(nxt, k)) for k in ttick.TRACE_FIELDS})
        st = nxt
    return (RaftConfig(**kw).stressed(10), T, jax.device_get(st),
            {k: np.stack([y[k] for y in ys]) for k in ys[0]},
            jtel.summarize_telemetry(tel), jtel.summarize_monitor(mon))


def test_make_run_equals_jax(case):
    tc, T, jend, jtr, jtel_s, jmon_s = case
    assert tc.uses_mailbox and not ttick.make_flags(tc, batched=True).batched
    end, tr, tel, mon = ttick.make_run(tc, T, trace=True, telemetry=True,
                                       monitor=True, device="cpu")(
        init_state(tc, "cpu"))
    got = state_to_numpy(end)
    for k in end.fields():
        want = np.asarray(getattr(jend, k))
        assert got[k].dtype == want.dtype, k
        np.testing.assert_array_equal(got[k], want, err_msg=k)
    for k in jtr:
        np.testing.assert_array_equal(tr[k].numpy(), jtr[k], err_msg=k)
    assert ttel.summarize_telemetry(tel) == {
        k: v for k, v in jtel_s.items() if k in ttel.TELEMETRY_FIELDS}
    assert ttel.summarize_monitor(mon) == jmon_s
    assert jtel_s["snapshots_taken"] > 0 and end.vq_due is not None


@pytest.mark.parametrize("aux_source,T", [("inkernel", 4), ("staged", 7)])
def test_kernel_plain_versions_equal_jax(case, aux_source, T):
    """make_cuda_scan on the CPU runs the kMail §15 forms' plain versions:
    the fused kernel (T ticks a launch, in-kernel with its observers' plain
    form, or staged) and, for the staged remainder (60 and 25 ticks leave
    4), the one-tick kernel. The trace from the launches' snapshots, the
    recorder, the monitor and every field of the end state ≡ JAX's."""
    tc, ticks, jend, jtr, jtel_s, jmon_s = case
    end, tr, tel, mon = make_cuda_scan(
        tc, ticks, telemetry=True, monitor=True, trace=True, fused_ticks=T,
        aux_source=aux_source, device="cpu")(init_state(tc, "cpu"))
    assert set(tr) == set(cuda_tick.FUSED_TRACE_FIELDS)
    assert aux_source == "inkernel" or ticks % T  # a staged remainder
    got = state_to_numpy(end)
    for k in end.fields():
        want = np.asarray(getattr(jend, k))
        assert got[k].dtype == want.dtype, k
        np.testing.assert_array_equal(got[k], want, err_msg=k)
    for k in tr:
        np.testing.assert_array_equal(tr[k].numpy(), jtr[k], err_msg=k)
    assert ttel.summarize_telemetry(tel) == {
        k: v for k, v in jtel_s.items() if k in ttel.TELEMETRY_FIELDS}
    assert ttel.summarize_monitor(mon) == jmon_s
