"""Per-stage latency counters (counterpart of StageTimer in
disinfect_slam_tpu/utils/timing.py; reference offline.cc:168-198).

Work on a CUDA device is asynchronous, so a span that covers device work
synchronises that device before it reads the clock at each end: the span
then measures the work itself, not its enqueueing.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import torch


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
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.samples[name].append(time.perf_counter() - t0)

    def mean_ms(self, name: str) -> float:
        s = self.samples.get(name)
        return 1e3 * sum(s) / len(s) if s else 0.0
