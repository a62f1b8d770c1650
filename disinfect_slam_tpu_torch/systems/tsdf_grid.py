"""TSDFGrid: the host-facing engine object (counterpart of
disinfect_slam_tpu/systems/tsdf_grid.py; API of
utils/tsdf/voxel_tsdf.cuh:32-124).

Owns a TSDFVolume on one device; integrate takes numpy frames, uploads
them and updates the volume in place; ray_cast renders a virtual view
with the parity raycaster or the splat renderer (on a CUDA device, the
raycast kernel or the splat_zbuf_blocks / splat_payload_blocks kernels).
On a CUDA device integrate and both renders run as captured steps, the
counterparts of the JAX object's jitted `_integrate` / `_integrate_stats`
(donated), `_raycast` and `_splat` (ops/integrate.IntegrateStep,
raycast_kernel.RaycastStep, splat_kernel.SplatStep, one memory pool for
the grid's graphs): the frame goes through static pinned buffers, the
pose into device memory, and after its first call each key replays a
CUDA graph; capture=False runs them eagerly instead (the path they are
held against: one kernel launch a raycast).  recenter and
maybe_recenter move the dense window after the camera.  With host_spill
the blocks a recenter releases go to a host store (systems/
block_streaming.py) and come back when the window returns, and
maybe_page evicts and restores blocks under pool pressure.
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
from ..ops.cuda.raycast_kernel import RaycastStep
from ..ops.cuda.splat_kernel import SplatStep, splat_render_cuda
from ..ops.gather import BoundingCube, SpatialTSDF
from ..ops.hash import needs_recenter, recenter_origin_for, window_origin
from ..ops.integrate import FrameInput, IntegrateStep
from ..ops.raycast import RaycastResult, raycast
from ..utils.device import resolve_device
from ..utils.graphs import StepGraphs
from .block_streaming import HostBlockStore, recenter_through

RENDERERS = ("auto", "raycast", "splat", "splat_pallas")

logger = logging.getLogger("disinfect_slam_tpu_torch.tsdf_grid")


class TSDFGrid:
    def __init__(
        self,
        voxel_size: float = 0.01,
        truncation: float = 0.06,
        cfg: Optional[TSDFConfig] = None,
        device="cuda",
        host_spill: bool = False,
        capture: bool = True,
        graphs: Optional[StepGraphs] = None,
    ):
        """capture: integrate and both renders as captured steps (the
        default); graphs: their cache (utils/graphs.StepGraphs), one on
        the grid's device unless given."""
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
        # oob_count is cumulative: the watchdog warns about growth past
        # this baseline, which a recenter advances
        self._oob_base = 0
        self._lock = threading.Lock()
        # host-RAM store of the blocks a recenter or paging evicts (the
        # reference's reserved, unbuilt CPU streaming mode,
        # voxel_mem.cuh:76-77)
        self.spill_store = HostBlockStore() if host_spill else None
        # the captured steps (capture=False: eager); one pool for their graphs
        self.graphs = graphs if graphs is not None else StepGraphs(self.device)
        self._integrate_step = IntegrateStep(self.device, capture=capture, graphs=self.graphs)
        self._splat_step = SplatStep(self.device, graphs=self.graphs)
        self._raycast_step = RaycastStep(self.device, graphs=self.graphs)

    @property
    def capture(self) -> bool:
        """Whether integrate and the renders run as captured steps."""
        return self._integrate_step.capture

    @capture.setter
    def capture(self, on: bool) -> None:
        self._integrate_step.capture = bool(on)

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
        """TSDFGrid::Integrate (voxel_tsdf.cu:347-375); ht / lt None read
        as ones."""
        h, w = img_depth.shape
        frame = FrameInput(rgb=img_rgb, depth=img_depth, ht=img_ht, lt=img_lt)
        cam = CameraParams.create(CameraIntrinsics.create(*intrinsics), h, w)
        pose = SE3.from_matrix(cam_T_world)
        # under DEBUG the block counts and the visible count are logged; each
        # read waits for the device, so none is made without DEBUG
        debug = logger.isEnabledFor(logging.DEBUG)
        with self._lock:
            if debug:
                logger.debug("[TSDF] pre integrate: %d active blocks",
                             int(self.volume.num_active_blocks))
            # cfg.alloc_every: allocation runs on every N-th frame (frame 0
            # always allocates); fusion runs every frame.  The DEBUG stats
            # are a graph of their own, read after it
            out = self._integrate_step(
                self.volume, frame, cam, pose, float(max_depth),
                allocate=self._tick % self.cfg.alloc_every == 0, return_stats=debug,
            )
            if debug:
                self.volume, stats = out
                logger.debug("[TSDF] visible blocks: %d", int(stats.visible_count))
                logger.debug("[TSDF] post integrate: %d active blocks",
                             int(self.volume.num_active_blocks))
            else:
                self.volume = out
            self._tick += 1
            # the dense grid bounds the scene (the reference's hash does
            # not, voxel_hash.cuh:13-25), so dropped candidates must be
            # loud; the read syncs, so it runs every 30 frames until it
            # fires
            if not self._warned_oob and self._tick % 30 == 0:
                oob = int(self.volume.oob_count) - self._oob_base
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

        "raycast" is the parity ray marcher (the reference's
        refinement and shading): the raycast kernel on a CUDA device, as
        a captured step (RaycastStep; fresh images each call), its plain
        version on the CPU.  "splat" and "splat_pallas" are the splat
        renderer, geometry within about a voxel of the raycaster
        (ops/render_fast.py); both launch the two splat kernels on a
        CUDA device, as a captured step (SplatStep; fresh images each
        call), and run their plain versions on the CPU.  "auto" is the
        splat kernels on a CUDA device and the raycaster elsewhere.
        With capture off each render runs eagerly."""
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
                step = self._raycast_step if self.capture else raycast
                res = step(self.volume, cam, pose, float(max_depth))
            elif self.capture:
                res = self._splat_step(self.volume, cam, pose, float(max_depth))
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

    def recenter(self, center_world_m) -> bool:
        """Move the dense window so that `center_world_m` (metres, e.g. the
        robot's position) sits at its centre (ops/hash.py recenter_dense;
        the hash backend has no window and never moves).  Payloads and
        absolute coordinates stay; blocks leaving the window are released,
        or with host_spill moved to the host store, which then gives back
        the stored blocks the new window covers.  Returns True if the
        window moved."""
        if self.cfg.backend != "dense":
            return False
        org = recenter_origin_for(self.cfg, center_world_m)
        with self._lock:
            if org == window_origin(self.cfg):
                return False
            self.volume = recenter_through(self.spill_store, self.volume, org)
            self.cfg = self.volume.cfg
            # the window moved: the watchdog may warn again, about drops
            # after the move only
            self._warned_oob = False
            self._oob_base = int(self.volume.oob_count)
            logger.info("[TSDF] recentered dense window to origin %s blocks", org)
            return True

    def maybe_recenter(self, cam_pos_world_m, margin_blocks: Optional[int] = None,
                       max_depth: Optional[float] = None) -> bool:
        """Recenter when the camera is within the margin of the window's
        edge (ops/hash.py needs_recenter: host arithmetic, so safe to call
        every frame).  Pass max_depth for a margin as deep as the frustum,
        so that the window moves before observations fall past its edge."""
        if not needs_recenter(self.cfg, cam_pos_world_m, margin_blocks, max_depth):
            return False
        return self.recenter(cam_pos_world_m)

    def maybe_page(self, cam_pos_world_m, radius_m: float, min_free_frac: float = 0.05,
                   target_free_frac: float = 0.15) -> Tuple[int, int]:
        """Pool-pressure paging against the host store (host_spill=True):
        when free blocks fall below min_free_frac of the pool, evict the
        live blocks farthest from the camera (beyond radius_m) until
        target_free_frac is free; then restore the stored blocks within
        radius_m while the pool has room.  A bounded pool then maps an
        unbounded drive, where the reference's pool simply stops
        allocating (voxel_mem.cu AquireBlock).  Reads num_free (a sync):
        call at waypoint cadence.  Returns (restored, evicted)."""
        if self.spill_store is None:
            return (0, 0)
        with self._lock:
            b = self.cfg.num_blocks
            free = int(self.volume.num_free)
            restored = evicted = 0
            # evict first: after a long drive the pool is full of far
            # blocks, and the near restores need their rows
            if free < min_free_frac * b:
                self.volume, evicted = self.spill_store.spill_cold(
                    self.volume, cam_pos_world_m, int(target_free_frac * b) - free,
                    keep_radius_m=radius_m)
                free = int(self.volume.num_free)
            room = free - int(min_free_frac * b)
            if room > 0 and len(self.spill_store):
                self.volume, restored = self.spill_store.restore_into_window(
                    self.volume, center_m=cam_pos_world_m, radius_m=radius_m,
                    max_restore=room)
            return (restored, evicted)

    def num_active_blocks(self) -> int:
        with self._lock:
            return int(self.volume.num_active_blocks)

    def block_until_ready(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
