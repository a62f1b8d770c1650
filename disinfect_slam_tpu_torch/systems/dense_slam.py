"""DenseSLAM: self-contained tracking + fusion, KinectFusion-style
(counterpart of disinfect_slam_tpu/systems/dense_slam.py).

  track:   projective point-to-plane ICP (systems/odometry.py) against a
           model render: the TSDF splatted to a depth map from the
           previous pose by the z-buffer kernel alone
           (ops/cuda/splat_kernel.splat_depth: K4, never K5), smoothed,
           at the tracking resolution (track_res_scale)
  fuse:    the standard integrate step (fuse_rows, K2) with the tracked
           pose
  render:  the updated model view feeds the next track

The JAX package runs a tracked frame as one jitted program with the
accept gate on the device.  Here a pose is a host object (core/geometry
SE3 holds a numpy quaternion, and the kernels take the pose by value),
so a tracked frame is one pass of eager ops with ONE device-to-host read:
the packed [world_T_cam | rmse | inliers] of odometry.read_result.  The
gate, the pose's inverse (numpy's float32 LU, as jnp.linalg.inv) and
SE3.from_matrix then run on the host, and fusion is queued with that
pose.  Frame 0 reads nothing; with loop closure, keyframes read the
matcher's score at the kf_every cadence.  Frames reach the device
through pinned staging buffers without a stream sync.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import TSDFConfig
from ..core.geometry import SE3, CameraIntrinsics, CameraParams
from ..core.state import TSDFVolume
from ..ops.cuda import splat_kernel
from ..ops.hash import needs_recenter, recenter_origin_for, window_origin
from ..ops.integrate import FrameInput, integrate
from ..utils.device import resolve_device, upload
from .block_streaming import HostBlockStore, recenter_through
from .odometry import ICPOdometry, read_result

SPLAT_IMPLS = ("auto", "xla", "pallas")


def box3_sum(x: torch.Tensor) -> torch.Tensor:
    """3x3 box sum of a float32 image [H, W] with zeros outside
    (convolve2d(x, ones((3, 3)), mode="same")), as nine shifted adds:
    a cuDNN convolution would run in TF32 by default, and its 10-bit
    mantissa moves a 2-4 m depth by millimetres."""
    h, w = x.shape
    p = F.pad(x, (1, 1, 1, 1))
    out = p[0:h, 0:w]
    for dy in range(3):
        for dx in range(3):
            if dy or dx:
                out = out + p[dy:dy + h, dx:dx + w]
    return out


def smooth_model_depth(d: torch.Tensor) -> torch.Tensor:
    """Validity-aware 3x3 smoothing of a splat depth map: the splat depth
    is quantized to voxel centers, and the box filter removes the
    stair-step bias that would otherwise pull ICP along the view axis."""
    valid = (d > 0).to(torch.float32)
    num = box3_sum(d * valid)
    den = box3_sum(valid)
    sm = torch.where(den > 0, num / torch.clamp(den, min=1.0), 0.0)
    return torch.where(valid > 0, sm, 0.0)


class DenseSLAM:
    def __init__(
        self,
        intrinsics: Tuple[float, float, float, float],
        img_h: int,
        img_w: int,
        voxel_size: float = 0.01,
        truncation: float = 0.06,
        max_depth: float = 4.0,
        cfg: Optional[TSDFConfig] = None,
        max_rmse: float = 0.08,
        splat_impl: str = "auto",
        host_spill: bool = False,
        loop_closure: bool = False,
        kf_every: int = 10,
        lc_kwargs: Optional[dict] = None,
        track_res_scale: int = 1,
        device="cuda",
    ):
        # splat_impl: the model depth's z-buffer. "pallas" and "auto":
        # the splat_zbuf_blocks kernel (on CPU tensors its wrapper runs
        # the plain version); "xla": the plain torch scatter on any device.
        # Both give the same bits.
        #
        # track_res_scale: run the whole tracking path (model render + ICP
        # pyramid) at 1/scale resolution while fusion stays full res.
        if splat_impl not in SPLAT_IMPLS:
            raise ValueError(f"splat_impl must be one of {SPLAT_IMPLS}, got {splat_impl!r}")
        self.device = resolve_device(device)
        if cfg is None:
            cfg = TSDFConfig(voxel_size=voxel_size, truncation=truncation)
        else:
            cfg = dataclasses.replace(cfg, voxel_size=voxel_size, truncation=truncation)
        self.cfg = cfg
        self.max_depth = float(max_depth)
        self.intrinsics = intrinsics
        self.cam = CameraParams.create(CameraIntrinsics.create(*intrinsics), img_h, img_w)
        self.volume = TSDFVolume.create(cfg, self.device)
        # host-RAM store of the blocks a recenter releases
        # (systems/block_streaming.py)
        self.spill_store = HostBlockStore() if host_spill else None
        ts = int(track_res_scale)
        if ts < 1 or img_h % ts or img_w % ts:
            raise ValueError(f"track_res_scale {ts} must divide the image dims "
                             f"{img_h}x{img_w}")
        self.track_scale = ts
        fx, fy, cx, cy = intrinsics
        track_intr = (fx / ts, fy / ts, cx / ts, cy / ts)
        self.track_cam = CameraParams.create(
            CameraIntrinsics.create(*track_intr), img_h // ts, img_w // ts)
        self.tracker = ICPOdometry(track_intr, img_h // ts, img_w // ts, max_rmse=max_rmse,
                                   device=self.device)
        # the gate compares in float32, as the JAX package's weak-typed
        # Python float against its float32 rmse
        self.max_rmse = np.float32(max_rmse)
        self.plain_splat = splat_impl == "xla"
        self.world_T_cam = np.eye(4, dtype=np.float32)
        self.frame_count = 0
        self._lost = 0
        # loop closure / relocalization (systems/loop_closure.py); keyframe
        # work runs at the kf_every cadence only
        self.lc = None
        self._kf_every = int(kf_every)
        if loop_closure:
            from .loop_closure import LoopClosureManager

            self.lc = LoopClosureManager(intrinsics, img_h, img_w, kf_every=kf_every,
                                         device=self.device, **(lc_kwargs or {}))

    # ------------------------------------------------------------------
    def _model_depth(self, prev_cam_T_world: SE3) -> torch.Tensor:
        """The model's depth [h, w] at the tracking camera from the
        previous pose: the surface set, the z-buffer (K4 or its plain
        version), then the validity-aware smoothing."""
        d, _hit = splat_kernel.splat_depth(self.volume, self.track_cam, prev_cam_T_world,
                                           self.max_depth, plain=self.plain_splat)
        return smooth_model_depth(d)

    def _track_fuse(self, frame: FrameInput, gyro_RT: np.ndarray, dp_w: np.ndarray,
                    mark: Optional[Callable[[str], None]] = None):
        """THE steady-state step: model depth, pyramids, multi-level ICP,
        the one pose read, the accept gate, fusion.  On loss the volume
        fuses with the last-known pose (the reference's keep-last-pose
        behavior, online.cc:46) and the estimate is discarded.  mark(name),
        when given, is called after each stage (upload, model_depth,
        pyramids, icp, pose_read, fusion): chip_smoke.py's split records
        CUDA events there.  Returns (cam_T_world float32 [4, 4] numpy, ok)."""
        mark = mark or (lambda _name: None)
        mark("upload")
        prev = self.world_T_cam
        prev_cam_T_world = np.linalg.inv(prev)
        seed = prev.copy()
        seed[:3, :3] = prev[:3, :3] @ gyro_RT
        # optional world-frame translation prior (IMU preintegration,
        # systems/imu.py relative_motion) on top of the rotation seed
        seed[:3, 3] += dp_w
        poses = upload(np.stack([seed, prev_cam_T_world]), self.device)
        md_img = self._model_depth(SE3.from_matrix(prev_cam_T_world))
        mark("model_depth")
        tracker = self.tracker
        pyr_ref = tracker._prep(md_img)
        ts = self.track_scale
        pyr_cur = tracker._prep(frame.depth[::ts, ::ts] if ts > 1 else frame.depth)
        mark("pyramids")
        track = tracker._track(poses[0], pyr_cur, pyr_ref, poses[1])
        mark("icp")
        T, rmse, inl = read_result(*track)
        mark("pose_read")
        ok = bool(np.isfinite(rmse) and rmse < self.max_rmse and inl > 100)
        if ok:
            self.world_T_cam = T
        cam_T_world = np.linalg.inv(self.world_T_cam)
        self.volume = integrate(self.volume, frame, self.cam, SE3.from_matrix(cam_T_world),
                                self.max_depth)
        mark("fusion")
        return cam_T_world, ok

    # ------------------------------------------------------------------
    def set_initial_pose(self, world_T_cam0: np.ndarray) -> None:
        """Anchor the world frame before the first frame, e.g. the
        gravity-aligned pose from ImuPreintegrator.gravity_aligned_pose
        (systems/imu.py), so maps come out level.  Only valid before
        process_frame has run."""
        if self.frame_count:
            raise RuntimeError("the initial pose must precede frame 0")
        self.world_T_cam = np.asarray(world_T_cam0, np.float32)

    def process_frame(
        self,
        rgb: np.ndarray,
        depth: np.ndarray,
        ht: Optional[np.ndarray] = None,
        lt: Optional[np.ndarray] = None,
        gyro_prior: Optional[np.ndarray] = None,
        trans_prior: Optional[np.ndarray] = None,
        mark: Optional[Callable[[str], None]] = None,
    ):
        """Track + fuse one frame; returns (cam_T_world float32 [4, 4],
        tracking ok bool []) as tensors on the device.  A tracked frame
        reads the device once (odometry.read_result); frame 0 never.

        gyro_prior: optional cam1_R_cam0 from IMU preintegration
        (systems/imu.py) seeding the ICP initial pose through fast
        rotations.  trans_prior: optional world-frame camera translation
        [3] over the frame interval (ImuPreintegrator.relative_motion's
        delta_p).  mark: see _track_fuse."""
        h, w = depth.shape
        ones = lambda: torch.ones((h, w), dtype=torch.float32, device=self.device)  # noqa: E731
        frame = FrameInput(
            rgb=upload(rgb, self.device), depth=upload(depth, self.device),
            ht=ones() if ht is None else upload(ht, self.device),
            lt=ones() if lt is None else upload(lt, self.device),
        )
        if self.frame_count == 0:
            # world frame anchored at the first camera pose, optionally
            # gravity-aligned via set_initial_pose
            cam_T_world = np.linalg.inv(self.world_T_cam).astype(np.float32)
            self.volume = integrate(self.volume, frame, self.cam,
                                    SE3.from_matrix(cam_T_world), self.max_depth)
            ok = True
        else:
            gyro_RT = (np.asarray(gyro_prior, np.float32).T if gyro_prior is not None
                       else np.eye(3, dtype=np.float32))
            dp_w = (np.asarray(trans_prior, np.float32) if trans_prior is not None
                    else np.zeros(3, np.float32))
            cam_T_world, ok = self._track_fuse(frame, gyro_RT, dp_w, mark)
            self._lost += not ok
        if self.lc is not None and self.frame_count % self._kf_every == 0:
            inten = np.asarray(rgb, np.float32)
            if inten.ndim == 3:
                inten = inten.mean(axis=-1)
            if ok:
                corr = self.lc.add_keyframe(np.asarray(depth, np.float32), self.world_T_cam,
                                            self.frame_count, intensity=inten)
                if corr is not None:
                    # continue tracking/fusing in the loop-consistent
                    # frame (already-fused drift stays; the trajectory is
                    # corrected retroactively)
                    self.world_T_cam = corr @ self.world_T_cam
                    cam_T_world = np.linalg.inv(self.world_T_cam)
            else:
                reloc = self.lc.relocalize(np.asarray(depth, np.float32), intensity=inten)
                if reloc is not None:
                    self.world_T_cam = reloc
                    cam_T_world = np.linalg.inv(reloc)
        self.frame_count += 1
        out = upload(np.stack([np.asarray(cam_T_world, np.float32).reshape(16),
                               np.full(16, float(ok), np.float32)]), self.device)
        return out[0].reshape(4, 4), out[1, 0] > 0

    # ------------------------------------------------------------------
    def maybe_recenter(self, margin_blocks: Optional[int] = None) -> bool:
        """Dense backend: move the coverage window to follow the tracked
        camera when it nears the edge (ops/hash.py recenter_dense; no-op
        on the hash backend or far from the edge).  Call at waypoint
        cadence, not per frame."""
        cfg = self.volume.cfg
        cam_pos = np.asarray(self.world_T_cam, np.float64)[:3, 3]
        if not needs_recenter(cfg, cam_pos, margin_blocks, self.max_depth):
            return False
        org = recenter_origin_for(cfg, cam_pos)
        if org == window_origin(cfg):
            return False
        self.volume = recenter_through(self.spill_store, self.volume, org)
        return True

    @property
    def lost_count(self) -> int:
        """Number of tracking-lost frames so far (the gate already runs
        on the host: no read)."""
        return self._lost

    def correct_trajectory(self, frame_ids: np.ndarray,
                           poses_cam_T_world: np.ndarray) -> np.ndarray:
        """Retro-apply loop-closure corrections to a recorded trajectory
        (no-op without loop_closure=True)."""
        if self.lc is None:
            return poses_cam_T_world
        return self.lc.correct_trajectory(frame_ids, poses_cam_T_world)

    def save_map(self, path: str) -> None:
        """Keyframe/map database save, the save_map_database analogue
        (run_zed_native.cc:88).  Requires loop_closure=True."""
        if self.lc is None:
            raise RuntimeError("save_map needs loop_closure=True")
        self.lc.save(path)

    def load_map(self, path: str) -> None:
        if self.lc is None:
            raise RuntimeError("load_map needs loop_closure=True")
        self.lc.load(path)

    def render(self, cam_T_world: Optional[np.ndarray] = None):
        """Splat render of the volume (both splat kernels on the card) at
        the full-resolution camera; the tracked pose by default."""
        if cam_T_world is None:
            cam_T_world = np.linalg.inv(self.world_T_cam)
        return splat_kernel.splat_render_cuda(
            self.volume, self.cam, SE3.from_matrix(np.asarray(cam_T_world)), self.max_depth)
