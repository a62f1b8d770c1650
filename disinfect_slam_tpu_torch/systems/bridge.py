"""Reconstruction bridge, the ROS-node analogue (counterpart of
disinfect_slam_tpu/systems/bridge.py).

The reference's live ROS target (ros_offline.cc) connects the pipeline to
the outside world through periodic channels:

  - reconstTimer at 5 Hz: bbox query -> marching cubes -> mesh publish
    (ros_offline.cc:258-350)
  - poseTimer at 20 Hz: TF broadcast of the inverted SLAM pose (:352-390)

Without ROS, the bridge runs the same timers on host threads over plain
callables.  The mesh is the port's marching tetrahedra (ops/mesh.py) over
a snapshot of the volume, kept to the triangles whose centroid lies in the
box.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

import numpy as np

from ..ops.gather import BoundingCube
from ..ops.mesh import extract_mesh_chunked, merge_vertices
from .disinf_system import DISINFSystem

logger = logging.getLogger(__name__)


class ReconstructionBridge:
    def __init__(
        self,
        system: DISINFSystem,
        bbox: BoundingCube,
        mesh_callback: Optional[Callable] = None,
        pose_callback: Optional[Callable] = None,
        mesh_period: float = 0.2,  # 5 Hz (ros_offline.cc:44)
        pose_period: float = 0.05,  # 20 Hz (:45)
        robot_centered: bool = False,
    ):
        self.system = system
        self.bbox = bbox
        self.mesh_callback = mesh_callback
        self.pose_callback = pose_callback
        self.mesh_period = mesh_period
        self.pose_period = pose_period
        self.robot_centered = robot_centered
        self._stop = threading.Event()
        self._threads = []
        self._last_ts = 0

    def start(self) -> None:
        for target in (self._mesh_loop, self._pose_loop):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=10)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *a):
        self.stop()
        return False

    def notify_frame(self, timestamp_ms: int) -> None:
        self._last_ts = timestamp_ms

    def query_mesh(self):
        """One bbox query -> (verts, faces): the reconstTimerCallback body
        (ros_offline.cc:258-318) with the port's extractor, over a
        consistent snapshot while integration keeps running."""
        bbox = self.bbox
        if self.robot_centered:
            center = np.linalg.inv(self.system.query_camera_pose(self._last_ts))[:3, 3]
            half = (bbox.xmax - bbox.xmin) / 2
            bbox = BoundingCube(center[0] - half, center[0] + half, bbox.ymin, bbox.ymax,
                                center[2] - half, center[2] + half)
        tris = extract_mesh_chunked(self.system.tsdf.tsdf.snapshot())
        if len(tris):
            c = tris.mean(axis=1)
            keep = ((c[:, 0] >= bbox.xmin) & (c[:, 0] <= bbox.xmax)
                    & (c[:, 1] >= bbox.ymin) & (c[:, 1] <= bbox.ymax)
                    & (c[:, 2] >= bbox.zmin) & (c[:, 2] <= bbox.zmax))
            tris = tris[keep]
        return merge_vertices(tris)

    def _mesh_loop(self) -> None:
        over_budget = 0
        while not self._stop.is_set():
            t0 = time.perf_counter()
            if self.mesh_callback is not None:
                try:
                    verts, faces = self.query_mesh()
                    self.mesh_callback(verts, faces)
                except Exception:  # keep publishing; the failure is logged
                    logger.exception("mesh query failed")
            took = time.perf_counter() - t0
            # a query slower than the period means the 5 Hz publish is
            # degrading (the ros_offline.cc:293-294 timing log): warn, with
            # exponential backoff so a persistently slow box does not flood
            if took > self.mesh_period and self.mesh_callback is not None:
                over_budget += 1
                if over_budget & (over_budget - 1) == 0:  # 1, 2, 4, 8...
                    logger.warning(
                        "[bridge] mesh query took %.0f ms > %.0f ms budget "
                        "(%d over-budget cycles): publishing at %.1f Hz, "
                        "not %.1f Hz — shrink the bbox or lower the rate",
                        took * 1e3, self.mesh_period * 1e3, over_budget,
                        1.0 / took, 1.0 / self.mesh_period,
                    )
            dt = self.mesh_period - took
            if dt > 0:
                self._stop.wait(dt)

    def _pose_loop(self) -> None:
        while not self._stop.is_set():
            if self.pose_callback is not None:
                # TF broadcasts world_T_cam, the inverted SLAM pose
                # (ros_offline.cc:352-390)
                self.pose_callback(np.linalg.inv(self.system.query_camera_pose(self._last_ts)))
            self._stop.wait(self.pose_period)
