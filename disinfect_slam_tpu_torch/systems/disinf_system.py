"""DISINFSystem: the top-level facade composing pose source + TSDF +
segmentation (counterpart of disinfect_slam_tpu/systems/disinf_system.py;
API of disinfect_slam/disinfect_slam.{h,cc}).

The reference composes ORB_SLAM3 + TSDFSystem + pose_manager with TSDF
parameters voxel 0.05 m / trunc 0.2 m / max depth 4 m
(disinfect_slam.cc:13-17).  The pose source is pluggable (trajectory
replay or an external SLAM bridge); poses are kept by PoseManager.  With
`auto_recenter` the dense window follows the camera (TSDFGrid.
maybe_recenter before each frame is queued).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from ..config import TSDFConfig
from ..ops.gather import BoundingCube, SpatialTSDF
from ..ops.image_ops import half_scale, scale_depth
from .pose_manager import PoseManager
from .tsdf_system import TSDFSystem

# disinfect_slam.cc:13-17
DEFAULT_VOXEL_SIZE = 0.05
DEFAULT_TRUNCATION = 0.2
DEFAULT_MAX_DEPTH = 4.0


class DISINFSystem:
    def __init__(
        self,
        intrinsics: Tuple[float, float, float, float],
        depth_factor: float = 1.0,
        voxel_size: float = DEFAULT_VOXEL_SIZE,
        truncation: float = DEFAULT_TRUNCATION,
        max_depth: float = DEFAULT_MAX_DEPTH,
        extrinsics: Optional[np.ndarray] = None,
        segmenter: Optional[Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]]] = None,
        pose_source=None,
        cfg: Optional[TSDFConfig] = None,
        half_scale: bool = True,
        auto_recenter: bool = False,
        host_spill: bool = False,
        device="cuda",
    ):
        self.depth_factor = float(depth_factor)
        self.half_scale = half_scale
        self.segmenter = segmenter
        self.pose_source = pose_source  # object with feed_stereo(...)
        self.camera_pose_manager = PoseManager()
        self.auto_recenter = auto_recenter
        self.max_depth = float(max_depth)
        self.tsdf = TSDFSystem(
            voxel_size, truncation, max_depth, intrinsics, extrinsics,
            cfg=cfg, host_spill=host_spill, device=device,
        )

    # ------------------------------------------------------------------
    def feed_rgbd_frame(
        self,
        img_rgb: np.ndarray,
        img_depth: np.ndarray,
        timestamp_ms: int,
        mask: Optional[np.ndarray] = None,
    ) -> None:
        """disinfect_slam.cc:31-67: (optionally) half-scale, apply the
        depth factor, zero masked depth, segment, borrow a pose by
        timestamp, enqueue.  Without a segmenter the fusion takes ones
        for ht / lt."""
        if self.half_scale:
            img_rgb, img_depth = half_scale(img_rgb), half_scale(img_depth)
            if mask is not None:
                mask = half_scale(mask)
        depth = scale_depth(np.asarray(img_depth), self.depth_factor)
        if mask is not None:
            depth = np.where(mask > 0, 0.0, depth)
        ht = lt = None
        if self.segmenter is not None:
            ht, lt = self.segmenter(img_rgb)
        pose = self.camera_pose_manager.query_pose(timestamp_ms)
        if self.auto_recenter:
            # follow the robot past the dense window's edge (a no-op on the
            # hash backend and away from the edge); frames queued across a
            # move drop their out-of-window fringe again
            cam_pos = np.linalg.inv(np.asarray(pose, np.float64))[:3, 3]
            self.tsdf.tsdf.maybe_recenter(cam_pos, max_depth=self.max_depth)
        self.tsdf.integrate(pose, np.asarray(img_rgb, np.float32), depth, ht, lt)

    def feed_stereo_imu(
        self,
        img_left: np.ndarray,
        img_right: np.ndarray,
        timestamp_ms: int,
        imu_measurements=None,
    ) -> None:
        """disinfect_slam.cc:83-98: track stereo(+IMU), register the pose."""
        if self.pose_source is None:
            return
        pose = self.pose_source.feed_stereo(
            img_left, img_right, timestamp_ms, imu_measurements
        )
        if pose is not None:
            self.camera_pose_manager.register_valid_pose(timestamp_ms, pose)

    def feed_pose(self, timestamp_ms: int, cam_T_world: np.ndarray) -> None:
        """Direct pose registration (trajectory replay path)."""
        self.camera_pose_manager.register_valid_pose(timestamp_ms, cam_T_world)

    def query_tsdf(self, volume: BoundingCube) -> SpatialTSDF:
        """disinfect_slam.cc:106-109."""
        return self.tsdf.query(volume)

    def query_camera_pose(self, timestamp_ms: int) -> np.ndarray:
        """disinfect_slam.cc:111-114."""
        return self.camera_pose_manager.query_pose(timestamp_ms)

    def render(self, virtual_cam, cam_T_world: np.ndarray):
        return self.tsdf.render(virtual_cam, cam_T_world)

    def terminate(self) -> None:
        self.tsdf.terminate()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.terminate()
        return False
