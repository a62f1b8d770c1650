"""Pose sources: the SLAM-facing interface layer (counterpart of
disinfect_slam_tpu/systems/slam.py).

The reference wraps external SLAM libraries (OpenVSLAM subclass in
modules/slam_module.{h,cc}, ORB_SLAM3 in disinfect_slam.cc) — the SLAM
math itself is not first-party code.  This module keeps that boundary:

  - PoseSource: the interface DISINFSystem consumes
  - TrajectorySource: deterministic replay (the offline path's pose feed,
    examples/tsdf/offline.cc:45-62)
  - ICPSource: the built-in ICP tracker (systems/odometry.py)
  - ExternalSLAMBridge: adapter for an out-of-process SLAM publishing
    poses through a callable (the ROS-topic analogue)
  - save_matched_trajectory: SLAMSystem::SaveMatchedTrajectory parity
    (slam_module.cc:20-66): "id r00 r01 r02 t0 ... t2" rows for frames
    whose ids were logged, skipping lost frames

The JAX module is host code apart from ICPSource, which here drives the
port's tracker; the rest is restated line for line
(tests/test_torch_slam_host.py pins the two together).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np


class PoseSource:
    """Interface: feed sensor data, get (cam_T_world, tracking_ok)."""

    def feed_stereo(self, img_left, img_right, timestamp_ms, imu=None):
        raise NotImplementedError

    def feed_rgbd(self, rgb, depth, timestamp_ms):
        raise NotImplementedError


class TrajectorySource(PoseSource):
    """Replays a known trajectory keyed by timestamp (nearest entry)."""

    def __init__(self, timestamps_ms: Iterable[int], poses: Iterable[np.ndarray]):
        self.ts = np.asarray(list(timestamps_ms), np.int64)
        self.poses = [np.asarray(p, np.float32) for p in poses]
        order = np.argsort(self.ts)
        self.ts = self.ts[order]
        self.poses = [self.poses[i] for i in order]

    def _at(self, timestamp_ms):
        if len(self.ts) == 0:
            return np.eye(4, dtype=np.float32), False
        i = int(np.argmin(np.abs(self.ts - timestamp_ms)))
        return self.poses[i], True

    def feed_stereo(self, img_left, img_right, timestamp_ms, imu=None):
        return self._at(timestamp_ms)[0]

    def feed_rgbd(self, rgb, depth, timestamp_ms):
        return self._at(timestamp_ms)


class ICPSource(PoseSource):
    """Built-in dense tracker as a pose source (depth frames)."""

    def __init__(self, intrinsics, img_h, img_w, **kwargs):
        from .odometry import ICPOdometry

        self.odo = ICPOdometry(intrinsics, img_h, img_w, **kwargs)

    def feed_rgbd(self, rgb, depth, timestamp_ms):
        return self.odo.feed(depth, timestamp_ms)

    def feed_stereo(self, img_left, img_right, timestamp_ms, imu=None):
        raise NotImplementedError("ICPSource consumes depth frames")


class ExternalSLAMBridge(PoseSource):
    """Adapter over an external tracker callable returning
    (pose_4x4 | None).  Mirrors feed_stereo_images_w_feedback semantics
    (slam_module.cc:100-120): None -> tracking lost -> pose not
    registered."""

    def __init__(self, track_fn: Callable[..., Optional[np.ndarray]]):
        self.track_fn = track_fn
        self.frame_id = 0
        self.log: Dict[int, Tuple[int, np.ndarray, bool]] = {}

    def feed_stereo(self, img_left, img_right, timestamp_ms, imu=None):
        pose = self.track_fn(img_left, img_right, timestamp_ms, imu)
        ok = pose is not None
        self.log[self.frame_id] = (timestamp_ms, pose if ok else None, ok)
        self.frame_id += 1
        return (pose if ok else None)

    def feed_rgbd(self, rgb, depth, timestamp_ms):
        pose = self.track_fn(rgb, depth, timestamp_ms)
        ok = pose is not None
        self.log[self.frame_id] = (timestamp_ms, pose if ok else None, ok)
        self.frame_id += 1
        return (pose if ok else np.eye(4, dtype=np.float32)), ok


def save_matched_trajectory(
    path: str,
    frame_poses: Dict[int, Optional[np.ndarray]],
    frame_ids: Iterable[int],
) -> int:
    """Write "id r00 r01 r02 t0 r10 ... t2" rows for the requested frame
    ids, skipping frames whose pose is missing (tracking lost) — the
    SaveMatchedTrajectory contract (slam_module.cc:20-66).

    Returns the number of rows written.  The output is directly readable
    by io.dataset.LoggedReplay (trajectory.txt format).
    """
    n = 0
    with open(path, "w") as f:
        for fid in frame_ids:
            pose = frame_poses.get(fid)
            if pose is None:
                continue
            row = " ".join(f"{v:.9f}" for v in np.asarray(pose)[:3, :4].reshape(-1))
            f.write(f"{fid} {row}\n")
            n += 1
    return n
