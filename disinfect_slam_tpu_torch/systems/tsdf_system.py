"""TSDFSystem: asynchronous integration service (counterpart of
disinfect_slam_tpu/systems/tsdf_system.py; API of
modules/tsdf_module.{h,cc}).

Producers enqueue frames (pose composed with static extrinsics, missing
ht/lt defaulting to ones, tsdf_module.cc:26-38); a dedicated integration
thread drains the queue and fuses (tsdf_module.cc:51-75), warning when
the queue backs up past depth 10 (tsdf_module.cc:62-63).  Query and
render serialise against integration through TSDFGrid's lock, like the
reference's mtx_read_.

A frame whose integration raises is dropped and the service keeps
running, as in the reference; the drop is logged with its traceback and
counted in `dropped_frames`, so that a caller can fail on it.
"""

from __future__ import annotations

import logging
import queue
import threading
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..config import TSDFConfig
from ..ops.gather import BoundingCube, SpatialTSDF
from .tsdf_grid import TSDFGrid

logger = logging.getLogger("disinfect_slam_tpu_torch.tsdf_system")

QUEUE_WARN_DEPTH = 10  # tsdf_module.cc:62


@dataclass
class TSDFSystemInput:
    """modules/tsdf_module.h:16-30."""

    cam_T_world: np.ndarray
    img_rgb: np.ndarray
    img_depth: np.ndarray
    img_ht: np.ndarray
    img_lt: np.ndarray


class TSDFSystem:
    def __init__(
        self,
        voxel_size: float,
        truncation: float,
        max_depth: float,
        intrinsics: Tuple[float, float, float, float],
        extrinsics: Optional[np.ndarray] = None,
        cfg: Optional[TSDFConfig] = None,
        host_spill: bool = False,
        device="cpu",
    ):
        if host_spill:
            raise NotImplementedError(
                "host_spill: the port's TSDFGrid has no host spill store yet "
                "(ROADMAP Queue 1 item 11, systems/block_streaming.py)")
        self.tsdf = TSDFGrid(voxel_size, truncation, cfg=cfg, device=device)
        self.max_depth = float(max_depth)
        self.intrinsics = tuple(float(x) for x in intrinsics)
        self.cam_T_posecam = (
            np.eye(4, dtype=np.float32) if extrinsics is None else
            np.asarray(extrinsics, np.float32)
        )
        self.dropped_frames = 0
        self._inputs: "queue.Queue[TSDFSystemInput]" = queue.Queue()
        self._terminate = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    def integrate(
        self,
        posecam_T_world: np.ndarray,
        img_rgb: np.ndarray,
        img_depth: np.ndarray,
        img_ht: Optional[np.ndarray] = None,
        img_lt: Optional[np.ndarray] = None,
    ) -> None:
        """Enqueue a frame (TSDFSystem::Integrate, tsdf_module.cc:26-38)."""
        h, w = img_depth.shape[:2]
        if img_ht is None or img_lt is None:
            img_ht = np.ones((h, w), img_depth.dtype)
            img_lt = np.ones((h, w), img_depth.dtype)
        pose = self.cam_T_posecam @ np.asarray(posecam_T_world, np.float32)
        self._inputs.put(TSDFSystemInput(pose, img_rgb, img_depth, img_ht, img_lt))

    def query(self, volume: BoundingCube) -> SpatialTSDF:
        """TSDFSystem::Query (tsdf_module.cc:40-43)."""
        return self.tsdf.gather_voxels(volume)

    def render(self, virtual_cam, cam_T_world: np.ndarray, renderer: str = "auto"):
        """TSDFSystem::Render (tsdf_module.cc:45-49): the interactive
        viewer's path, so "auto" (the splat kernels on a CUDA device);
        renderer="raycast" gives the parity raycaster."""
        return self.tsdf.ray_cast(self.max_depth, virtual_cam, cam_T_world,
                                  renderer=renderer)

    def queue_depth(self) -> int:
        return self._inputs.qsize()

    def flush(self) -> None:
        """Block until the queue is drained (deterministic replay aid;
        the reference has no equivalent: it relies on sleep loops)."""
        self._inputs.join()
        self.tsdf.block_until_ready()

    def terminate(self) -> None:
        """~TSDFSystem (tsdf_module.cc:18-24)."""
        self._terminate.set()
        self._thread.join(timeout=30.0)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.terminate()
        return False

    # ------------------------------------------------------------------
    def _run(self) -> None:
        """Integration thread (TSDFSystem::Run, tsdf_module.cc:51-75)."""
        while not self._terminate.is_set():
            depth = self._inputs.qsize()
            if depth > QUEUE_WARN_DEPTH:
                logger.warning(
                    "[TSDF System] Processing cannot catch up (input size: %d)", depth
                )
            try:
                inp = self._inputs.get(timeout=0.01)
            except queue.Empty:
                continue
            try:
                self.tsdf.integrate(
                    inp.img_rgb, inp.img_depth, inp.img_ht, inp.img_lt,
                    self.max_depth, self.intrinsics, inp.cam_T_world,
                )
            except Exception:  # keep the service alive; drop the frame
                self.dropped_frames += 1
                logger.exception("[TSDF System] integration failed; frame dropped")
            finally:
                self._inputs.task_done()
