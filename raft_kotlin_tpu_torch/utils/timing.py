"""Device timing on an NVIDIA card: CUDA-event pairs around a region, and a
kernel's device time with its launch queued behind a spinning card.

Used by chip_smoke.py and the kernel A/B script (raft_kotlin_tpu_torch/
kernel_ab.py); importing this module needs no card.
"""

from __future__ import annotations

import gc
import time

import torch

# Clock cycles the card spins, at the least, before a timed kernel launch,
# so the launch is queued behind the start event and the event pair times
# the device only (~50 ms at the H100's clocks). A wrapper's host work takes
# ~1 ms on an idle host, and has taken 11.7 ms on the H100 machine's 8 cores
# while the kernel libraries compiled beside it.
PRIME_CYCLES = 100_000_000

# What every DeviceTimer of this process has seen: the worst host time to
# queue a timed launch, and the card's clock cycles per ms of spin (the
# H100's 1.98 GHz until a prime has been timed). Each prime spins four times
# that worst queue time, within [PRIME_CYCLES, 4 * PRIME_CYCLES].
HOST = {"queue_ms": 0.0, "cycles_per_ms": 1_980_000.0}


def sync() -> None:
    torch.cuda.synchronize()


class Timer:
    """CUDA-event timing of one region; mean over its calls."""

    def __init__(self):
        self._pairs = []

    def __enter__(self):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        self._pairs.append((a, b))
        return self

    def __exit__(self, *exc):
        self._pairs[-1][1].record()

    def mean_ms(self) -> float:
        sync()
        ts = [a.elapsed_time(b) for a, b in self._pairs]
        return sum(ts) / len(ts)


class DeviceTimer:
    """A kernel's device time: the card spins while the host records the
    start event and runs the wrapper, so the start event and the launch
    reach the card back to back. The spin is sized from the worst queue time
    seen so far, and Python's garbage collector is held off while the host
    queues. Fails if, in any run, the host took so long to queue the launch
    that the card could have idled."""

    def __init__(self):
        self.kernel, self.prime = Timer(), Timer()
        self.queue_ms, self.cycles = [], []

    def run(self, fn):
        sync()
        if self.cycles:  # the last prime has ended: the card's clock
            a, b = self.prime._pairs[-1]
            HOST["cycles_per_ms"] = self.cycles[-1] / a.elapsed_time(b)
        cycles = min(4 * PRIME_CYCLES, max(
            PRIME_CYCLES, int(4 * HOST["queue_ms"] * HOST["cycles_per_ms"])))
        collecting = gc.isenabled()
        gc.disable()
        try:
            h0 = time.perf_counter()
            with self.prime:
                torch.cuda._sleep(cycles)
            with self.kernel:
                out = fn()
            queue_ms = (time.perf_counter() - h0) * 1e3
        finally:
            if collecting:
                gc.enable()
        self.queue_ms.append(queue_ms)
        self.cycles.append(cycles)
        HOST["queue_ms"] = max(HOST["queue_ms"], queue_ms)
        return out

    def mean_ms(self) -> float:
        sync()
        for queue_ms, (a, b) in zip(self.queue_ms, self.prime._pairs):
            prime_ms = a.elapsed_time(b)
            if queue_ms >= 0.5 * prime_ms:
                raise AssertionError(f"the host took {queue_ms:.3f} ms to "
                                     f"queue a timed launch, the card spun "
                                     f"{prime_ms:.3f} ms")
        return self.kernel.mean_ms()
