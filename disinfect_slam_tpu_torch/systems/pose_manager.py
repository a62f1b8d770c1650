"""Timestamped pose buffer bridging asynchronous sensor streams
(counterpart of disinfect_slam_tpu/systems/pose_manager.py; API of
utils/rotation_math/pose_manager.{h,cc}).

The SLAM thread registers (timestamp_ms, pose) pairs; the depth thread
queries the pose nearest to its own timestamp (binary search +
nearest-neighbour pick, pose_manager.cc:16-43), or with `interpolate`
(the default) the SLERP between its two neighbours, which the reference
leaves as a TODO (pose_manager.cc:34).

The JAX package's module is plain numpy; it is restated here, line for
line (tests/test_torch_online.py pins the two together), so that the
port and the GPU smoke run load nothing of the JAX package.
"""

from __future__ import annotations

import bisect
import threading
from typing import List

import numpy as np


def _slerp(q0: np.ndarray, q1: np.ndarray, alpha: float) -> np.ndarray:
    dot = float(np.dot(q0, q1))
    if dot < 0:
        q1 = -q1
        dot = -dot
    if dot > 0.9995:
        q = q0 + alpha * (q1 - q0)
        return q / np.linalg.norm(q)
    theta = np.arccos(np.clip(dot, -1, 1))
    s = np.sin(theta)
    return (np.sin((1 - alpha) * theta) * q0 + np.sin(alpha * theta) * q1) / s


def _mat_to_quat(m: np.ndarray) -> np.ndarray:
    w = np.sqrt(max(1 + m[0, 0] + m[1, 1] + m[2, 2], 0)) / 2
    if w > 1e-6:
        return np.array(
            [
                w,
                (m[2, 1] - m[1, 2]) / (4 * w),
                (m[0, 2] - m[2, 0]) / (4 * w),
                (m[1, 0] - m[0, 1]) / (4 * w),
            ]
        )
    # fallback for w ~ 0
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1, 1e-12)) * 2
    q = np.zeros(4)
    q[i + 1] = s / 4
    q[0] = (m[k, j] - m[j, k]) / s
    q[j + 1] = (m[j, i] + m[i, j]) / s
    q[k + 1] = (m[k, i] + m[i, k]) / s
    return q


def _quat_to_mat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


class PoseManager:
    """Append-only (timestamp_ms -> SE3 4x4) buffer with nearest /
    interpolated queries."""

    def __init__(self, interpolate: bool = True):
        self._times: List[int] = []
        self._poses: List[np.ndarray] = []
        self._lock = threading.Lock()
        self.interpolate = interpolate

    def register_valid_pose(self, timestamp_ms: int, pose: np.ndarray) -> None:
        with self._lock:
            self._times.append(int(timestamp_ms))
            self._poses.append(np.asarray(pose, np.float64))

    def __len__(self) -> int:
        with self._lock:
            return len(self._times)

    def query_pose(self, timestamp_ms: int) -> np.ndarray:
        """Pose at timestamp; identity when empty (pose_manager.cc:18-21)."""
        with self._lock:
            if not self._times:
                return np.eye(4, dtype=np.float32)
            idx = bisect.bisect_right(self._times, timestamp_ms) - 1
            if idx < 0:
                return self._poses[0].astype(np.float32)
            if idx >= len(self._times) - 1:
                return self._poses[-1].astype(np.float32)
            t0, t1 = self._times[idx], self._times[idx + 1]
            p0, p1 = self._poses[idx], self._poses[idx + 1]
        if not self.interpolate:
            # reference nearest-neighbor pick (pose_manager.cc:36-43)
            return (p0 if timestamp_ms - t0 < t1 - timestamp_ms else p1).astype(
                np.float32
            )
        alpha = (timestamp_ms - t0) / max(t1 - t0, 1)
        q = _slerp(_mat_to_quat(p0[:3, :3]), _mat_to_quat(p1[:3, :3]), alpha)
        out = np.eye(4)
        out[:3, :3] = _quat_to_mat(q)
        out[:3, 3] = (1 - alpha) * p0[:3, 3] + alpha * p1[:3, 3]
        return out.astype(np.float32)
