"""Device timing on an NVIDIA card: CUDA-event pairs around a region, and a
kernel's device time with its launch queued behind a spinning card.

Used by chip_smoke.py and the kernel A/B script (raft_kotlin_tpu_torch/
kernel_ab.py); importing this module needs no card.
"""

from __future__ import annotations

import time

import torch

# Clock cycles the card spins before a timed kernel launch, so the launch
# is queued behind the start event and the event pair times the device only
# (~20 ms at the H100's clocks; a wrapper's host work takes ~1 ms).
PRIME_CYCLES = 40_000_000


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
    reach the card back to back. Fails if the host took so long to queue
    the launch that the card could have idled."""

    def __init__(self):
        self.kernel, self.prime, self.queue_ms = Timer(), Timer(), 0.0

    def run(self, fn):
        sync()
        h0 = time.perf_counter()
        with self.prime:
            torch.cuda._sleep(PRIME_CYCLES)
        with self.kernel:
            out = fn()
        self.queue_ms = max(self.queue_ms, (time.perf_counter() - h0) * 1e3)
        return out

    def mean_ms(self) -> float:
        ms, prime_ms = self.kernel.mean_ms(), self.prime.mean_ms()
        if self.queue_ms >= 0.5 * prime_ms:
            raise AssertionError(f"the host took {self.queue_ms:.3f} ms to "
                                 f"queue a timed launch, the card spun "
                                 f"{prime_ms:.3f} ms")
        return ms
