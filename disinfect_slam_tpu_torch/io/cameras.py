"""Sensor interfaces (cameras/ layer parity; counterpart of
disinfect_slam_tpu/io/cameras.py, restated so that the port loads nothing
of the JAX package).

The reference wraps vendor SDKs (ZED, librealsense) behind tiny frame-
grabber classes: ZEDNative::GetStereoFrame (zed_native.h:30),
ZED::GetStereoFrame/GetStereoAndRGBDFrame/GetIMU (zed.h:20-51),
L515::GetRGBDFrame/DepthScale (l515.h:8-45), SR300::get_rgbd_frame
(sr300.h:6-28).  No camera is attached to the accelerator host, so
this module defines the same interfaces and ships replay-backed
implementations (fed from logged datasets or synthetic generators) so
every consumer of the reference camera layer has a drop-in source.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from ..utils.timing import get_system_timestamp_ms


@dataclass
class IMUSample:
    """ZED simuData analogue (zed.h: simuData)."""

    timestamp_ms: int
    accel: np.ndarray  # [3] m/s^2
    gyro: np.ndarray  # [3] rad/s


class StereoCamera:
    """Interface: get_stereo_frame() -> (left, right, timestamp_ms)."""

    def get_stereo_frame(self):
        raise NotImplementedError


class RGBDCamera:
    """Interface: get_rgbd_frame() -> (rgb, depth_raw, timestamp_ms);
    depth_scale() converts raw units to metres (l515.h:17-20)."""

    def get_rgbd_frame(self):
        raise NotImplementedError

    def depth_scale(self) -> float:
        raise NotImplementedError


class ReplayRGBDCamera(RGBDCamera):
    """L515/SR300 stand-in replaying a logged dataset at a paced rate."""

    def __init__(self, replay, fps: float = 30.0, depth_factor: float = 1000.0):
        self._iter: Iterator = iter(replay)
        self.period = 1.0 / fps
        self._factor = depth_factor
        self._next_t = time.monotonic()

    def get_rgbd_frame(self):
        frame = next(self._iter)  # raises StopIteration at end like a closed stream
        now = time.monotonic()
        if now < self._next_t:
            time.sleep(self._next_t - now)
        self._next_t += self.period
        depth_raw = (frame.depth * self._factor).astype(np.uint16)
        return frame.rgb, depth_raw, get_system_timestamp_ms()

    def depth_scale(self) -> float:
        return 1.0 / self._factor


class SyntheticRGBDCamera(RGBDCamera):
    """Procedural scene camera for tests/benchmarks (no dataset needed)."""

    def __init__(self, render_fn, poses, fps: float = 30.0):
        self.render_fn = render_fn  # pose -> (rgb, depth_m)
        self.poses = list(poses)
        self.period = 1.0 / fps
        self._i = 0

    def get_rgbd_frame(self):
        if self._i >= len(self.poses):
            raise StopIteration
        pose = self.poses[self._i]
        self._i += 1
        rgb, depth = self.render_fn(pose)
        return rgb, (depth * 1000).astype(np.uint16), int(self._i * self.period * 1000)

    def depth_scale(self) -> float:
        return 1e-3

    def current_pose(self) -> Optional[np.ndarray]:
        idx = max(self._i - 1, 0)
        return self.poses[idx]


class ReplayStereoCamera(StereoCamera):
    """ZEDNative stand-in: side-by-side stereo from logged pairs with
    optional rectification (zed_native.cc:24-33).  `rectifier` is any
    object with rectify(left, right) -> (left, right), such as the port's
    ops/image_ops.StereoRectifier (io/zed_calib.rectifier_from_factory_conf
    builds one from a ZED factory calibration)."""

    def __init__(self, pairs, rectifier=None, fps: float = 30.0):
        self._iter = iter(pairs)  # iterable of (left, right)
        self.rectifier = rectifier
        self.period = 1.0 / fps
        self._next_t = time.monotonic()

    def get_stereo_frame(self):
        left, right = next(self._iter)
        now = time.monotonic()
        if now < self._next_t:
            time.sleep(self._next_t - now)
        self._next_t += self.period
        if self.rectifier is not None:
            left, right = self.rectifier.rectify(left, right)
        return left, right, get_system_timestamp_ms()
