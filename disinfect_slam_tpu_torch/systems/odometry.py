"""Projective ICP visual odometry (counterpart of
disinfect_slam_tpu/systems/odometry.py).

The reference delegates pose tracking to external SLAM libraries
(OpenVSLAM via modules/slam_module.*, ORB_SLAM3 via disinfect_slam.cc);
the framework keeps that external-bridge interface (systems/slam.py) but
also ships this self-contained KinectFusion-style tracker.

Method: frame-to-frame (or frame-to-model) point-to-plane ICP over an
image pyramid, coarse to fine:

  residual r_i = n_i . (T v_i - p_i)
  J_i = [p x n | n]  (se3 generators),  solve (J^T J) dx = -J^T r,
  T <- exp(dx) T

The JAX package has no Pallas kernel here: every level is XLA ops inside
one jitted program.  The port runs the same ops eagerly on one device.
Each level's iterations are a Python loop with no host read inside it:
the 6x6 solve is `linalg.solve_ex` and the reference pose's inverse
`linalg.inv_ex`, both without their error check (which reads the LU
status on the host), so a whole `_track` is queued without a sync.  The
pose comes to the host once, through `read_result`, when the caller
needs it.  Matmuls and the normal equations run with TF32 off
(`exact_fp32`): a 10-bit mantissa in `J^T J` would move the pose.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core.geometry import CameraIntrinsics, CameraParams
from ..utils.device import exact_fp32, resolve_device, upload

_F32 = torch.float32


def vertex_map(depth: torch.Tensor, cam: CameraParams) -> torch.Tensor:
    """Depth [H, W] -> camera-space points [H, W, 3] (0-depth -> 0)."""
    dev = depth.device
    u = torch.arange(cam.img_w, dtype=_F32, device=dev)
    v = torch.arange(cam.img_h, dtype=_F32, device=dev)
    uu, vv = torch.meshgrid(u, v, indexing="xy")
    dirs = cam.intrinsics_inv.project(torch.stack([uu, vv, torch.ones_like(uu)], -1))
    return dirs * depth[..., None]


def normal_map(verts: torch.Tensor) -> torch.Tensor:
    """Screen-space normals from a vertex map (cross of finite diffs;
    torch.roll wraps around, as jnp.roll does)."""
    dx = torch.roll(verts, -1, 1) - verts
    dy = torch.roll(verts, -1, 0) - verts
    n = torch.linalg.cross(dx, dy)
    nn = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    return n / torch.where(nn == 0, 1.0, nn)


def skew(k: torch.Tensor) -> torch.Tensor:
    """[3] -> the 3x3 cross-product matrix, built by stacking (no write
    into a fresh tensor, so it traces under torch.func)."""
    z = torch.zeros((), dtype=k.dtype, device=k.device)
    return torch.stack([
        torch.stack([z, -k[2], k[1]]),
        torch.stack([k[2], z, -k[0]]),
        torch.stack([-k[1], k[0], z]),
    ])


def _exp_se3(xi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """se3 exp map: xi = (omega[3], v[3]) -> (R [3,3], t [3])."""
    omega = xi[:3]
    v = xi[3:]
    theta = torch.linalg.vector_norm(omega) + 1e-12
    k = omega / theta
    kx = skew(k)
    s, c = torch.sin(theta), torch.cos(theta)
    eye = torch.eye(3, dtype=_F32, device=xi.device)
    kx2 = kx @ kx
    r = eye + s * kx + (1 - c) * kx2
    vmat = eye + (1 - c) / theta * kx + (theta - s) / theta * kx2
    return r, vmat @ v


def _downsample(depth: torch.Tensor) -> torch.Tensor:
    """2x decimation keeping invalid zeros invalid."""
    return depth[::2, ::2]


def rigid_4x4(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[3, 3] rotation + [3] translation -> 4x4, by concatenation."""
    bottom = torch.eye(4, dtype=r.dtype, device=r.device)[3:]
    return torch.cat([torch.cat([r, t[:, None]], 1), bottom], 0)


class ICPResult(NamedTuple):
    cam_T_world: torch.Tensor  # 4x4
    rmse: torch.Tensor  # final inlier residual RMS
    inliers: torch.Tensor  # inlier count at the finest level


def _icp_level(
    T0: torch.Tensor,
    src_verts: torch.Tensor,  # [H, W, 3] current frame, camera space
    ref_verts_w: torch.Tensor,  # [H, W, 3] reference surface, world space
    ref_normals_w: torch.Tensor,  # [H, W, 3] world space
    ref_valid: torch.Tensor,  # [H, W]
    cam: CameraParams,
    ref_cam_T_world: torch.Tensor,  # 4x4 of the reference view
    iters: int,
    dist_thresh: float,
    huber_delta: float,
):
    """Iterate point-to-plane ICP at one pyramid level.

    T0: initial world_T_cam estimate for the current frame (4x4).
    Returns (refined world_T_cam, rmse, inlier count) as device tensors;
    nothing in the loop reads the device."""
    dev = src_verts.device
    h, w = src_verts.shape[:2]
    src = src_verts.reshape(-1, 3)
    src_valid = src[:, 2] > 0
    # vertex + normal + validity in ONE [N, 8] row array: the
    # per-iteration correspondence lookup is a single row gather
    ref_pack = torch.cat([
        ref_verts_w.reshape(-1, 3),
        ref_normals_w.reshape(-1, 3),
        ref_valid.reshape(-1, 1).to(_F32),
        torch.zeros((h * w, 1), dtype=_F32, device=dev),
    ], 1)

    fx, fy = cam.intrinsics.fx, cam.intrinsics.fy
    cx, cy = cam.intrinsics.cx, cam.intrinsics.cy
    ref_R = ref_cam_T_world[:3, :3]
    ref_t = ref_cam_T_world[:3, 3]
    # a device-tensor numerator: torch divides a Python scalar by a
    # tensor through the reciprocal, not the correctly rounded quotient
    delta = torch.full((), huber_delta, dtype=_F32, device=dev)
    damp = 1e-6 * torch.eye(6, dtype=_F32, device=dev)

    T = T0
    rmse = torch.zeros((), dtype=_F32, device=dev)
    inl = torch.zeros((), dtype=_F32, device=dev)
    for _ in range(iters):
        r_mat = T[:3, :3]
        t_vec = T[:3, 3]
        p_w = src @ r_mat.T + t_vec  # current points in world

        # project into the reference view to find correspondences
        p_ref = p_w @ ref_R.T + ref_t
        z = p_ref[:, 2]
        u = fx * p_ref[:, 0] / z + cx
        v = fy * p_ref[:, 1] / z + cy
        # torch.round is half-to-even, as jnp.round.  A non-finite u casts
        # to INT_MIN on the CPU and saturates (NaN to 0) on the card; the
        # clip keeps the index in range and in_img drops those points
        ui = torch.clamp(torch.round(u).to(torch.int32), 0, w - 1)
        vi = torch.clamp(torch.round(v).to(torch.int32), 0, h - 1)
        idx = vi * w + ui
        in_img = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1) & (z > 0)

        g = torch.index_select(ref_pack, 0, idx)  # one row gather
        q = g[:, 0:3]
        n = g[:, 3:6]
        diff = p_w - q
        dist_ok = torch.sum(diff * diff, -1) < dist_thresh * dist_thresh
        valid = src_valid & in_img & (g[:, 6] > 0) & dist_ok
        r_res = torch.sum(n * diff, -1)

        # Huber IRLS weights: quadratic near zero, linear in the tails
        r_abs = torch.abs(r_res)
        huber = torch.clamp(delta / torch.clamp(r_abs, min=1e-12), max=1.0)
        wgt = valid.to(_F32) * huber
        jac = torch.cat([torch.linalg.cross(p_w, n), n], -1)  # [N, 6]
        jw = jac * wgt[:, None]
        jtj = jw.T @ jac
        jtr = jw.T @ r_res
        dx = torch.linalg.solve_ex(jtj + damp, -jtr, check_errors=False).result
        r_up, t_up = _exp_se3(dx)
        T = rigid_4x4(r_up @ r_mat, r_up @ t_vec + t_up)
        inliers = valid.to(_F32)
        rmse = torch.sqrt(torch.sum(r_res * r_res * inliers)
                          / torch.clamp(torch.sum(inliers), min=1.0))
        inl = torch.sum(inliers)
    return T, rmse, inl


def read_result(T: torch.Tensor, rmse: torch.Tensor, inl: torch.Tensor):
    """The one device-to-host read of a tracked pose: the 4x4, the rmse
    and the inlier count packed into one [18] float32 copy.  Returns
    (T float32 [4, 4], rmse float32, inliers float32) as numpy.
    `read_result.reads` counts the calls (tests pin one per tracked
    frame)."""
    read_result.reads += 1
    packed = torch.cat([T.reshape(16), rmse.reshape(1), inl.reshape(1)]).cpu().numpy()
    return packed[:16].reshape(4, 4), packed[16], packed[17]


read_result.reads = 0


class ICPOdometry:
    """Frame-to-frame projective ICP tracker with a pyramid schedule.

    feed(depth, timestamp) -> (cam_T_world 4x4, tracking_ok), mirroring
    the feed_*_w_feedback contract of the reference SLAM wrapper
    (slam_module.cc:100-142).  Runs on `device` (CUDA unless the caller
    asks for the CPU).
    """

    def __init__(
        self,
        intrinsics: Tuple[float, float, float, float],
        img_h: int,
        img_w: int,
        levels: int = 3,
        iters: Tuple[int, ...] = (4, 5, 10),
        dist_thresh: float = 0.25,
        max_rmse: float = 0.06,
        huber_delta: float = 0.05,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.levels = levels
        self.iters = iters
        self.dist_thresh = dist_thresh
        self.max_rmse = max_rmse
        self.huber_delta = huber_delta
        self.cams = []
        fx, fy, cx, cy = intrinsics
        h, w = img_h, img_w
        for lv in range(levels):
            scale = 2**lv
            self.cams.append(CameraParams.create(
                CameraIntrinsics.create(fx / scale, fy / scale, cx / scale, cy / scale),
                h // scale, w // scale))
        self._prev = None  # (pyramid, cam_T_world of the reference view)
        self.world_T_cam = np.eye(4, dtype=np.float32)

    def _prep(self, depth: torch.Tensor):
        """Depth [H, W] -> per level (vertices, normals, valid)."""
        out = []
        d = depth
        for lv in range(self.levels):
            verts = vertex_map(d, self.cams[lv])
            out.append((verts, normal_map(verts), d > 0))
            if lv + 1 < self.levels:
                d = _downsample(d)
        return out

    def _track(self, T0: torch.Tensor, pyr_cur, pyr_ref, ref_pose: torch.Tensor):
        """Multi-level ICP of pyr_cur against pyr_ref (seen from
        ref_pose, its cam_T_world) from the seed T0 (world_T_cam).
        Returns (world_T_cam, rmse, inliers) as device tensors, queued
        without a host read.  The reference view's world_T_cam is
        inv_ex's LU inverse, as the JAX package's jnp.linalg.inv."""
        with exact_fp32():
            ref_world_T_cam = torch.linalg.inv_ex(ref_pose, check_errors=False).inverse
            r_t = ref_world_T_cam[:3, :3].T
            t_r = ref_world_T_cam[:3, 3]
            T = T0
            rmse = inl = None
            for lv in reversed(range(self.levels)):  # coarse to fine
                verts_c, _, _ = pyr_cur[lv]
                verts_r, normals_r, valid_r = pyr_ref[lv]
                # reference maps to world coordinates
                rw = verts_r @ r_t + t_r
                nw = normals_r @ r_t
                T, rmse, inl = _icp_level(
                    T, verts_c, rw, nw, valid_r, self.cams[lv], ref_pose,
                    self.iters[min(lv, len(self.iters) - 1)], self.dist_thresh,
                    self.huber_delta)
        return T, rmse, inl

    def feed(self, depth: np.ndarray, timestamp_ms: int = 0):
        """Track one depth frame; returns (cam_T_world, ok) on the host."""
        pyr = self._prep(upload(depth, self.device))
        if self._prev is None:
            self._prev = (pyr, upload(np.linalg.inv(self.world_T_cam), self.device))
            return np.linalg.inv(self.world_T_cam), True
        prev_pyr, prev_pose = self._prev
        T, rmse, inl = read_result(*self._track(
            upload(self.world_T_cam, self.device), pyr, prev_pyr, prev_pose))
        ok = bool(np.isfinite(float(rmse))) and float(rmse) < self.max_rmse and float(inl) > 100
        if ok:
            self.world_T_cam = T
        cam_T_world = np.linalg.inv(self.world_T_cam).astype(np.float32)
        self._prev = (pyr, upload(cam_T_world, self.device))
        return cam_T_world, ok

    def feed_stereo(self, img_left, img_right, timestamp_ms, imu=None):
        raise NotImplementedError("ICPOdometry tracks depth frames; use feed()")
