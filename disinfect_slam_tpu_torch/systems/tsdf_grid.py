"""TSDFGrid: the host-facing engine object (counterpart of
disinfect_slam_tpu/systems/tsdf_grid.py; API of
utils/tsdf/voxel_tsdf.cuh:32-124).

Owns a TSDFVolume on one device; integrate takes numpy frames, uploads
them and updates the volume in place; ray_cast renders a virtual view
with the parity raycaster or the splat renderer (on a CUDA device, the
splat_zbuf_rows / splat_payload_rows kernels).  Not ported yet: the
dense-window recenter and the host spill store.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import TSDFConfig
from ..core.geometry import SE3, CameraIntrinsics, CameraParams
from ..core.state import TSDFVolume
from ..ops import gather as gather_ops
from ..ops.cuda.splat_kernel import splat_render_cuda
from ..ops.gather import BoundingCube, SpatialTSDF
from ..ops.integrate import FrameInput, integrate
from ..ops.raycast import RaycastResult, raycast
from ..utils.device import resolve_device

RENDERERS = ("auto", "raycast", "splat", "splat_pallas")

logger = logging.getLogger("disinfect_slam_tpu_torch.tsdf_grid")


class TSDFGrid:
    def __init__(
        self,
        voxel_size: float = 0.01,
        truncation: float = 0.06,
        cfg: Optional[TSDFConfig] = None,
        device="cpu",
    ):
        cfg = cfg or TSDFConfig()
        self.cfg = dataclasses.replace(
            cfg, voxel_size=voxel_size, truncation=truncation
        )
        self.device = resolve_device(device)
        self.volume = TSDFVolume.create(self.cfg, self.device)
        # frames integrated so far: drives the alloc_every cadence and the
        # out-of-coverage watchdog
        self._tick = 0
        self._warned_oob = False
        self._lock = threading.Lock()

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)

    def integrate(
        self,
        img_rgb: np.ndarray,
        img_depth: np.ndarray,
        img_ht: Optional[np.ndarray],
        img_lt: Optional[np.ndarray],
        max_depth: float,
        intrinsics: Tuple[float, float, float, float],
        cam_T_world: np.ndarray,
    ) -> None:
        """TSDFGrid::Integrate (voxel_tsdf.cu:347-375)."""
        h, w = img_depth.shape
        if img_ht is None:
            img_ht = np.ones((h, w), np.float32)
        if img_lt is None:
            img_lt = np.ones((h, w), np.float32)
        frame = FrameInput(
            rgb=self._upload(img_rgb), depth=self._upload(img_depth),
            ht=self._upload(img_ht), lt=self._upload(img_lt),
        )
        cam = CameraParams.create(CameraIntrinsics.create(*intrinsics), h, w)
        pose = SE3.from_matrix(cam_T_world)
        with self._lock:
            # cfg.alloc_every: allocation runs on every N-th frame (frame 0
            # always allocates); fusion runs every frame
            self.volume = integrate(
                self.volume, frame, cam, pose, float(max_depth),
                allocate=self._tick % self.cfg.alloc_every == 0,
            )
            self._tick += 1
            # the dense grid bounds the scene (the reference's hash does
            # not, voxel_hash.cuh:13-25), so dropped candidates must be
            # loud; the read syncs, so it runs every 30 frames until it
            # fires
            if not self._warned_oob and self._tick % 30 == 0:
                oob = int(self.volume.oob_count)
                if oob:
                    cfg = self.cfg
                    extent = cfg.grid_side * cfg.block_len * cfg.voxel_size
                    logger.warning(
                        "[TSDF] %d allocation candidates fell OUTSIDE the "
                        "mapped extent (%.1f m per axis) and were dropped; "
                        "the map is truncated. Raise grid_log2 or move "
                        "grid_origin.", oob, extent,
                    )
                    self._warned_oob = True

    def ray_cast(
        self,
        max_depth: float,
        virtual_cam: Tuple[Tuple[float, float, float, float], int, int],
        cam_T_world: np.ndarray,
        renderer: str = "raycast",
    ) -> RaycastResult:
        """TSDFGrid::RayCast (voxel_tsdf.cu:490-506); virtual_cam =
        ((fx, fy, cx, cy), img_h, img_w).

        "raycast" is the parity ray marcher (the reference's trilinear
        refinement and shading).  "splat" and "splat_pallas" are the
        splat renderer, geometry within about a voxel of the raycaster
        (ops/render_fast.py); both launch the two splat kernels on a
        CUDA device and run their plain versions on the CPU.  "auto" is
        the kernels on a CUDA device and the raycaster elsewhere."""
        if renderer not in RENDERERS:
            raise ValueError(f"renderer must be one of {RENDERERS}, got {renderer!r}")
        if renderer == "auto":
            renderer = "splat" if self.device.type == "cuda" else "raycast"
        intr, img_h, img_w = virtual_cam
        cam = CameraParams.create(CameraIntrinsics.create(*intr), img_h, img_w)
        pose = SE3.from_matrix(cam_T_world)
        # integrate updates the volume in place: hold the lock across the
        # render (the reference serialises with mtx_read_,
        # tsdf_module.cc:40-49)
        with self._lock:
            if renderer == "raycast":
                res = raycast(self.volume, cam, pose, float(max_depth))
            else:
                res = splat_render_cuda(self.volume, cam, pose, float(max_depth))
        # dropped surface blocks must be observable; the read syncs, so it
        # runs only with DEBUG logging on
        if logger.isEnabledFor(logging.DEBUG) and res.surf_overflow is not None:
            ov = int(res.surf_overflow)
            if ov:
                logger.debug("[TSDF] splat surf_cap exceeded: %d surface blocks "
                             "dropped from this render", ov)
        return res

    def gather_valid(self) -> SpatialTSDF:
        """TSDFGrid::GatherValid (voxel_tsdf.cu:399-425)."""
        with self._lock:
            return gather_ops.gather_valid(self.volume)

    def gather_voxels(self, volume: BoundingCube) -> SpatialTSDF:
        """TSDFGrid::GatherVoxels (voxel_tsdf.cu:427-454)."""
        with self._lock:
            return gather_ops.gather_voxels(self.volume, volume)

    def snapshot(self) -> TSDFVolume:
        """Consistent copy of the volume for readers that must not hold
        the integration lock (integrate updates the tensors in place)."""
        with self._lock:
            return self.volume.clone()

    def num_active_blocks(self) -> int:
        with self._lock:
            return int(self.volume.num_active_blocks)

    def block_until_ready(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
