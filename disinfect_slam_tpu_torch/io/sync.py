"""Timestamped stream synchronization (counterpart of
disinfect_slam_tpu/io/sync.py, restated line for line so that the port
loads nothing of the JAX package; tests/test_torch_host_lib.py pins the
two together).

The reference pairs sensor streams by timestamp in its ROS threads:
stereo L/R within +/-10 ms (ros_offline.cc slamTh, :151-255), rgb/depth
within +/-50 ms (reconstTh, :101-149), and the simulation example uses
message_filters ApproximateTime (syncSubscriber.cpp:16-45).  This module
provides the same behavior as plain data structures.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable, List


class ApproximateTimeSynchronizer:
    """Pairs items from N streams whose timestamps agree within `slop_ms`.

    push(stream_idx, timestamp_ms, item); when one item per stream exists
    within the window, `callback(ts, items...)` fires with the earliest
    timestamp and the matched items are consumed.  Unmatched items older
    than `horizon_ms` are discarded (streams never back up).
    """

    def __init__(
        self,
        n_streams: int,
        callback: Callable,
        slop_ms: float = 10.0,
        horizon_ms: float = 1000.0,
        queue_size: int = 64,
    ):
        self.n = n_streams
        self.callback = callback
        self.slop = slop_ms
        self.horizon = horizon_ms
        self.queues: List[collections.deque] = [
            collections.deque(maxlen=queue_size) for _ in range(n_streams)
        ]
        self._lock = threading.Lock()
        self.matched = 0
        self.dropped = 0

    def push(self, stream: int, timestamp_ms: float, item: Any) -> None:
        fires = []
        with self._lock:
            self.queues[stream].append((float(timestamp_ms), item))
            while True:
                fire = self._try_match()
                if fire is None:
                    break
                if fire is not True:
                    fires.append(fire)
            self._expire(timestamp_ms)
        for fire in fires:
            self.callback(*fire)

    def _try_match(self):
        """Returns a match tuple, True when a stale head was dropped (so
        the caller should retry), or None when no progress is possible."""
        if any(not q for q in self.queues):
            return None
        # greedy: take the earliest head, find closest partner in each
        # other stream
        heads = [q[0][0] for q in self.queues]
        pivot = min(range(self.n), key=lambda i: heads[i])
        t0 = heads[pivot]
        picks = []
        for i, q in enumerate(self.queues):
            best = min(range(len(q)), key=lambda j: abs(q[j][0] - t0))
            if abs(q[best][0] - t0) > self.slop:
                # heads can't match; drop the pivot head and retry
                self.queues[pivot].popleft()
                self.dropped += 1
                return True
            picks.append(best)
        items = []
        ts = min(self.queues[i][picks[i]][0] for i in range(self.n))
        for i in range(self.n):
            t, item = self.queues[i][picks[i]]
            items.append(item)
            # consume picked and everything older
            for _ in range(picks[i] + 1):
                self.queues[i].popleft()
        self.matched += 1
        return (ts, *items)

    def _expire(self, now_ms: float) -> None:
        for q in self.queues:
            while q and now_ms - q[0][0] > self.horizon:
                q.popleft()
                self.dropped += 1


class StereoPairer(ApproximateTimeSynchronizer):
    """L/R pairing within +/-10 ms (ros_offline.cc slamTh default)."""

    def __init__(self, callback, slop_ms: float = 10.0, **kw):
        super().__init__(2, callback, slop_ms=slop_ms, **kw)


class RGBDPairer(ApproximateTimeSynchronizer):
    """rgb/depth pairing within +/-50 ms (ros_offline.cc reconstTh)."""

    def __init__(self, callback, slop_ms: float = 50.0, **kw):
        super().__init__(2, callback, slop_ms=slop_ms, **kw)
