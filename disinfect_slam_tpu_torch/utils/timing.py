"""Per-stage latency counters and the clocks (counterpart of
disinfect_slam_tpu/utils/timing.py; reference offline.cc:168-198,
utils/time.hpp).

Work on a CUDA device is asynchronous, so a span that covers device work
synchronises that device before it reads the clock at each end: the span
then measures the work itself, not its enqueueing.  Each span is also a
`torch.profiler.record_function` range, so profiler traces carry the
stage names (the JAX package annotates its spans for jax.profiler).

cuda_time_ms and card_name_and_power are the measurement helpers that
chip_smoke.py and the benchmark (apps/bench.py) share.
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import time
from collections import defaultdict
from typing import Dict

import torch


def get_timestamp_ms() -> int:
    """Steady-clock milliseconds (GetTimestamp<std::chrono::milliseconds>,
    time.hpp:10-14)."""
    return time.monotonic_ns() // 1_000_000


def get_system_timestamp_ms() -> int:
    """System-clock milliseconds (GetSystemTimestamp, time.hpp:18-22)."""
    return time.time_ns() // 1_000_000


class LocalClock:
    """Offset converter between an external clock and the steady clock
    (time.hpp:24-33)."""

    def __init__(self, external_now_ms: int):
        self.offset = get_timestamp_ms() - external_now_ms

    def convert(self, external_ms: int) -> int:
        return external_ms + self.offset


class StageTimer:
    """Collects per-stage latencies (seconds, one sample per span)."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self.samples: Dict[str, list] = defaultdict(list)

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        with torch.profiler.record_function(name):
            self._sync()
            t0 = time.perf_counter()
            yield
            self._sync()
            dt = time.perf_counter() - t0
        self.samples[name].append(dt)

    def mean_ms(self, name: str) -> float:
        s = self.samples.get(name)
        return 1e3 * sum(s) / len(s) if s else 0.0

    def summary(self) -> Dict[str, float]:
        """Mean ms of every stage timed so far."""
        return {k: self.mean_ms(k) for k in self.samples}


def cuda_time_ms(fn, reps: int = 10) -> float:
    """Median device time of fn() over reps runs, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card_name_and_power() -> str:
    """The first card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them: a
    card may be set below its maximum power, and then runs slower under
    load, so every time taken on it is reported beside this line."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
