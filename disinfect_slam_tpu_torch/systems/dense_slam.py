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

As in the JAX package, a tracked frame is one step with the accept gate
on the device (the JAX `_track_fuse`, jitted with the volume donated):
`TrackFuseStep` runs the previous pose's inverse, the seed, the model
depth, both pyramids, the multi-level ICP, the gate, the keep-last-pose
choice, the new pose's inverse and the integrate, reading the pose from
a [4, 4] float32 device buffer and writing it back in place.  On a CUDA
device the step replays a CUDA graph after its first call of a key
(utils/graphs.py); capture=False runs the same body eagerly.  A tracked
frame reads nothing from the device: process_frame returns device
tensors, the ok flags resolve lazily (lost_count), and only a keyframe
(with loop closure, every kf_every frames) reads, once: the gate, the
pose and the keyframe's match scores in one copy.  Frame 0 fuses at the
host's inverse of the initial pose.  Frames reach the device through
pinned staging buffers without a stream sync.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import TSDFConfig
from ..core.exact import mm
from ..core.geometry import (
    SE3, CameraIntrinsics, CameraParams, DevicePose, inverse4, pose_floats_of_matrix,
)
from ..core.state import TSDFVolume
from ..ops.cuda import splat_kernel
from ..ops.hash import needs_recenter, recenter_origin_for, window_origin
from ..ops.integrate import FrameInput, IntegrateStep, integrate
from ..utils.device import resolve_device, upload
from ..utils.graphs import StaticInputs, StepGraphs
from .block_streaming import HostBlockStore, recenter_through
from .odometry import ICPOdometry

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


def model_depth(vol: TSDFVolume, track_cam: CameraParams, prev_cam_T_world, max_depth: float,
                plain: bool = False) -> torch.Tensor:
    """The model's depth [h, w] at the tracking camera from the previous
    pose (an SE3 or a DevicePose): the surface set, the z-buffer (K4, or
    its plain version with plain=True), then the validity-aware
    smoothing."""
    d, _hit = splat_kernel.splat_depth(vol, track_cam, prev_cam_T_world, max_depth, plain=plain)
    return smooth_model_depth(d)


def smooth_model_depth(d: torch.Tensor) -> torch.Tensor:
    """Validity-aware 3x3 smoothing of a splat depth map: the splat depth
    is quantized to voxel centers, and the box filter removes the
    stair-step bias that would otherwise pull ICP along the view axis."""
    valid = (d > 0).to(torch.float32)
    num = box3_sum(d * valid)
    den = box3_sum(valid)
    sm = torch.where(den > 0, num / torch.clamp(den, min=1.0), 0.0)
    return torch.where(valid > 0, sm, 0.0)


_F32 = torch.float32
# the step's inputs: the frame's four channels, then the IMU priors
_INPUTS = ("rgb", "depth", "ht", "lt", "gyro_RT", "dp_w")
# the stages mark() sees, in order (capture=False only)
STAGES = ("upload", "model_depth", "pyramids", "icp", "gate", "fusion")


class TrackFuseStep:
    """DenseSLAM's tracked frame as one step: the counterpart of the JAX
    `jax.jit(_track_fuse, donate_argnums=0)`.  The frame and the IMU priors
    go through pinned staging (two slots, used in turn) into static device
    buffers; the body uploads them, inverts the previous pose (the
    DenseSLAM's [4, 4] device buffer), seeds ICP with the gyro rotation and
    the translation prior, renders the model depth (K4 and the box
    smoothing), builds both pyramids, runs the three ICP levels, gates the
    result (finite rmse below max_rmse and more than 100 inliers), keeps the
    previous pose on loss, inverts the kept pose into a DevicePose and
    integrates the frame with it (K2), in place; the pose buffer is
    written in place, and cam_T_world and ok go into static outputs.  On a
    CUDA device the body is captured under a key (image size, tracking
    scale, intrinsics, max depth, allocate, staging slot, the volume's
    storage_key) and replayed after; capture=False runs it eagerly, and
    only then may a mark(name) callback see each of STAGES, and `probe`,
    when set to a callable, get probe(name, tensors) for each stage's
    outputs (utils/parting.py compares two devices with it).

    cam / track_cam: the fusion and the tracking cameras; tracker: the
    ICPOdometry at track_cam; pose: the world_T_cam buffer, f32 [4, 4] on
    the device, read and written in place."""

    def __init__(self, cam: CameraParams, track_cam: CameraParams, tracker: ICPOdometry,
                 pose: torch.Tensor, max_rmse: float, max_depth: float,
                 plain_splat: bool = False, capture: bool = True,
                 graphs: Optional[StepGraphs] = None):
        self.cam, self.track_cam, self.tracker, self.pose = cam, track_cam, tracker, pose
        self.track_scale = cam.img_h // track_cam.img_h
        self.max_rmse, self.max_depth, self.plain_splat = max_rmse, max_depth, plain_splat
        self.capture = capture
        dev = pose.device
        self.graphs = graphs if graphs is not None else StepGraphs(dev)
        h, w = cam.img_h, cam.img_w
        shapes = ((h, w, 3), (h, w), (h, w), (h, w), (3, 3), (3,))
        self.inputs = StaticInputs({n: (shape, _F32) for n, shape in zip(_INPUTS, shapes)}, dev)
        self._model_pose = DevicePose.empty(dev)  # the previous cam_T_world
        self._fuse_pose = DevicePose.empty(dev)  # the kept pose's cam_T_world
        self.cam_T_world = torch.zeros((4, 4), dtype=_F32, device=dev)
        self.ok = torch.zeros((), dtype=torch.bool, device=dev)
        self._tick = 0
        self.probe: Optional[Callable[[str, object], None]] = None

    def __call__(self, vol: TSDFVolume, rgb, depth, ht, lt, gyro_RT, dp_w,
                 allocate: bool = True, mark: Optional[Callable[[str], None]] = None):
        """One tracked frame (host arrays; ht / lt None read as ones) into
        `vol`, in place; returns (cam_T_world f32 [4, 4], ok bool []) as
        fresh device tensors."""
        if (mark is not None or self.probe is not None) and self.capture:
            raise ValueError("mark() and probe see the stages of the eager step only "
                             "(capture=False)")
        slot = self._tick % 2
        self._tick += 1
        self.inputs.fill(slot, rgb=rgb, depth=depth, ht=1.0 if ht is None else ht,
                         lt=1.0 if lt is None else lt, gyro_RT=gyro_RT, dp_w=dp_w)

        def body():
            self._body(vol, slot, allocate, mark or (lambda _name: None))

        if self.capture:
            key = ("track_fuse", self.cam.img_h, self.cam.img_w, self.track_scale,
                   self.cam.intrinsics, self.max_depth, bool(allocate), slot) + vol.storage_key()
            self.graphs.run(key, body)
        else:
            body()
        self.inputs.done(slot)
        return self.cam_T_world.clone(), self.ok.clone()

    def _body(self, vol, slot, allocate, mark) -> None:
        inputs = self.inputs
        inputs.upload(slot)
        rgb, depth, ht, lt, gyro_rt, dp_w = (inputs.dev[n] for n in _INPUTS)
        mark("upload")
        probe = self.probe or (lambda _name, _value: None)
        prev = self.pose
        prev_cam_T_world = inverse4(prev)
        seed_r = mm(prev[:3, :3], gyro_rt)
        # optional world-frame translation prior (IMU preintegration,
        # systems/imu.py relative_motion) on top of the rotation seed
        seed = torch.cat([torch.cat([seed_r, (prev[:3, 3] + dp_w)[:, None]], 1), prev[3:]], 0)
        self._model_pose.buf.copy_(pose_floats_of_matrix(prev_cam_T_world))
        probe("seed", (prev.clone(), prev_cam_T_world, seed, self._model_pose.buf))
        md_img = model_depth(vol, self.track_cam, self._model_pose, self.max_depth,
                             self.plain_splat)
        mark("model_depth")
        probe("model_depth", md_img)
        tracker = self.tracker
        ts = self.track_scale
        pyr_ref = tracker._prep(md_img)
        track_depth = depth[::ts, ::ts] if ts > 1 else depth
        pyr_cur = tracker._prep(track_depth)
        mark("pyramids")
        probe("inputs", track_depth)
        probe("pyramid_ref", pyr_ref)
        probe("pyramid_cur", pyr_cur)
        trace = [] if self.probe is not None else None
        T, rmse, inl = tracker._track(seed, pyr_cur, pyr_ref, prev_cam_T_world, trace)
        mark("icp")
        probe("icp", trace)
        ok = torch.isfinite(rmse) & (rmse < self.max_rmse) & (inl > 100)
        world_T_cam = torch.where(ok, T, prev)
        cam_T_world = inverse4(world_T_cam)
        self._fuse_pose.buf.copy_(pose_floats_of_matrix(cam_T_world))
        prev.copy_(world_T_cam)
        self.cam_T_world.copy_(cam_T_world)
        self.ok.copy_(ok)
        mark("gate")
        probe("gate", (ok, world_T_cam, cam_T_world, self._fuse_pose.buf))
        integrate(vol, FrameInput(rgb, depth, ht, lt), self.cam, self._fuse_pose,
                  self.max_depth, allocate=allocate)
        mark("fusion")


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
        capture: bool = True,
        graphs: Optional[StepGraphs] = None,
    ):
        # splat_impl: the model depth's z-buffer. "pallas" and "auto":
        # the splat_zbuf_blocks kernel (on CPU tensors its wrapper runs
        # the plain version); "xla": the plain torch scatter on any device.
        # Both give the same bits.
        #
        # track_res_scale: run the whole tracking path (model render + ICP
        # pyramid) at 1/scale resolution while fusion stays full res.
        #
        # capture: the tracked step, frame 0's integrate and the loop
        # closure's query, verification ICP and pose graph as captured
        # steps (the default; capture=False runs them eagerly); graphs:
        # their one cache (by default room for the pose graph's sizes too).
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
        self.graphs = graphs if graphs is not None else StepGraphs(
            self.device, max_graphs=32 if loop_closure else 8)
        fx, fy, cx, cy = intrinsics
        track_intr = (fx / ts, fy / ts, cx / ts, cy / ts)
        self.track_cam = CameraParams.create(
            CameraIntrinsics.create(*track_intr), img_h // ts, img_w // ts)
        self.tracker = ICPOdometry(track_intr, img_h // ts, img_w // ts, max_rmse=max_rmse,
                                   device=self.device, capture=capture, graphs=self.graphs)
        # the gate compares in float32, as the JAX package's weak-typed
        # Python float against its float32 rmse
        self.max_rmse = float(np.float32(max_rmse))
        self.plain_splat = splat_impl == "xla"
        # the tracked pose, world_T_cam, in device memory: every change is
        # written into it in place, so a captured step keeps reading it.
        # _host_pose mirrors it while only the host has written it (frame
        # 0 fuses at its inverse, as the JAX package's numpy inverse)
        self._pose = torch.eye(4, dtype=_F32, device=self.device)
        self._host_pose = np.eye(4, dtype=np.float32)
        self.frame_count = 0
        # per-frame device ok flags; lost_count resolves them lazily so the
        # steady-state loop never waits on the gate.  Resolved flags fold
        # into _lost_resolved and the list drains (bounded memory for
        # long-running services)
        self._ok_flags: list = []
        self._lost_resolved = 0
        self._step = TrackFuseStep(self.cam, self.track_cam, self.tracker, self._pose,
                                   self.max_rmse, self.max_depth, self.plain_splat,
                                   capture=capture, graphs=self.graphs)
        self._first = IntegrateStep(self.device, capture=capture, graphs=self.graphs)
        # loop closure / relocalization (systems/loop_closure.py); keyframe
        # work runs at the kf_every cadence only
        self.lc = None
        self._kf_every = int(kf_every)
        if loop_closure:
            from .loop_closure import LoopClosureManager

            self.lc = LoopClosureManager(intrinsics, img_h, img_w, kf_every=kf_every,
                                         device=self.device, capture=capture,
                                         graphs=self.graphs,
                                         **(lc_kwargs or {}))

    # ------------------------------------------------------------------
    @property
    def world_T_cam(self) -> np.ndarray:
        """The tracked pose, float32 [4, 4], as a host copy: reading it
        waits for the device (np.asarray(slam.world_T_cam) in the JAX
        package syncs the same way)."""
        return np.array(self._pose.cpu().numpy(), np.float32)

    @world_T_cam.setter
    def world_T_cam(self, m: np.ndarray) -> None:
        m = np.asarray(m, np.float32)
        self._pose.copy_(upload(m, self.device))
        self._host_pose = m.copy()

    def _model_depth(self, prev_cam_T_world) -> torch.Tensor:
        """model_depth of this SLAM's volume from the previous pose (an SE3
        or a DevicePose)."""
        return model_depth(self.volume, self.track_cam, prev_cam_T_world, self.max_depth,
                           self.plain_splat)

    # ------------------------------------------------------------------
    def set_initial_pose(self, world_T_cam0: np.ndarray) -> None:
        """Anchor the world frame before the first frame, e.g. the
        gravity-aligned pose from ImuPreintegrator.gravity_aligned_pose
        (systems/imu.py), so maps come out level.  Only valid before
        process_frame has run."""
        if self.frame_count:
            raise RuntimeError("the initial pose must precede frame 0")
        self.world_T_cam = world_T_cam0

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
        reads nothing from the device (the gate runs there); with loop
        closure a keyframe reads once.

        gyro_prior: optional cam1_R_cam0 from IMU preintegration
        (systems/imu.py) seeding the ICP initial pose through fast
        rotations.  trans_prior: optional world-frame camera translation
        [3] over the frame interval (ImuPreintegrator.relative_motion's
        delta_p).  mark: the eager step's stage callback (TrackFuseStep,
        capture=False)."""
        allocate = self.frame_count % self.cfg.alloc_every == 0
        if self.frame_count == 0:
            # world frame anchored at the first camera pose, optionally
            # gravity-aligned via set_initial_pose
            cam0 = np.linalg.inv(self._host_pose).astype(np.float32)
            self.volume = self._first(
                self.volume, FrameInput(rgb=rgb, depth=depth, ht=ht, lt=lt), self.cam,
                DevicePose.from_matrix(cam0, self.device), self.max_depth, allocate=allocate)
            cam_T_world = upload(cam0, self.device)
            ok = torch.ones((), dtype=torch.bool, device=self.device)
        else:
            gyro_RT = (np.asarray(gyro_prior, np.float32).T if gyro_prior is not None
                       else np.eye(3, dtype=np.float32))
            dp_w = (np.asarray(trans_prior, np.float32) if trans_prior is not None
                    else np.zeros(3, np.float32))
            cam_T_world, ok = self._step(self.volume, rgb, depth, ht, lt, gyro_RT, dp_w,
                                         allocate=allocate, mark=mark)
            self._ok_flags.append(ok)
            # bound the pending flags: by 1024 frames the early flags are
            # long computed, so the drain's wait is free
            if len(self._ok_flags) >= 1024:
                self._drain_ok_flags()
        if self.lc is not None and self.frame_count % self._kf_every == 0:
            cam_T_world = self._keyframe(rgb, depth, ok, cam_T_world)
        self.frame_count += 1
        return cam_T_world, ok

    def _keyframe(self, rgb, depth, ok: torch.Tensor, cam_T_world: torch.Tensor):
        """Keyframe work at the kf_every cadence, with ONE read: the gate,
        the tracked pose and the keyframe's match scores in one copy.
        Returns the frame's cam_T_world (corrected after a closure or a
        relocalization)."""
        inten = np.asarray(rgb, np.float32)
        if inten.ndim == 3:
            inten = inten.mean(axis=-1)
        depth = np.asarray(depth, np.float32)
        query = self.lc.query(depth, inten)
        packed = np.asarray(torch.cat([ok.to(_F32).reshape(1), self._pose.reshape(16),
                                       query.scores]).tolist(), np.float32)
        query = query._replace(scores=packed[17:])
        if packed[0] > 0:
            pose = packed[1:17].reshape(4, 4)
            corr = self.lc.add_keyframe(depth, pose, self.frame_count, intensity=inten,
                                        query=query)
            if corr is None:
                return cam_T_world
            # continue tracking/fusing in the loop-consistent frame
            # (already-fused drift stays; the trajectory is corrected
            # retroactively)
            new = corr @ pose
        else:
            new = self.lc.relocalize(depth, intensity=inten, query=query)
            if new is None:
                return cam_T_world
        self.world_T_cam = new
        return upload(np.linalg.inv(np.asarray(new, np.float32)), self.device)

    # ------------------------------------------------------------------
    def maybe_recenter(self, margin_blocks: Optional[int] = None) -> bool:
        """Dense backend: move the coverage window to follow the tracked
        camera when it nears the edge (ops/hash.py recenter_dense; no-op
        on the hash backend or far from the edge).  Reading the tracked
        pose waits for the device, and a move captures the step anew: call
        at waypoint cadence, not per frame."""
        cfg = self.volume.cfg
        cam_pos = np.asarray(self.world_T_cam, np.float64)[:3, 3]
        if not needs_recenter(cfg, cam_pos, margin_blocks, self.max_depth):
            return False
        org = recenter_origin_for(cfg, cam_pos)
        if org == window_origin(cfg):
            return False
        self.volume = recenter_through(self.spill_store, self.volume, org)
        return True

    def _drain_ok_flags(self) -> None:
        if self._ok_flags:
            self._lost_resolved += int((~torch.stack(self._ok_flags)).sum().cpu())
            self._ok_flags.clear()

    @property
    def lost_count(self) -> int:
        """Number of tracking-lost frames so far (reads the pending flags:
        cheap, call it for reporting, not per frame)."""
        self._drain_ok_flags()
        return self._lost_resolved

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
