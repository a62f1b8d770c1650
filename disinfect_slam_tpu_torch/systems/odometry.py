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
one jitted program (`_prep` and `_track` are each jitted there).  The
port runs one iteration of a level as one hand-written kernel of two
launches (ops/cuda/icp_kernel.icp_step, csrc/icp_step.cu): the
correspondences, the normal equations summed in float32 in a fixed order
(XLA:CPU's 8 interleaved accumulators), the 6x6 solve, the se3 exp and the
pose update in float64, rounded once.  Its plain version does the same
arithmetic in the same order, and everything around it is elementwise
(the reference maps' transform in SE3.apply_xyz's order, the pyramids
with the jitted JAX contractions restated, roots in float64), so the
tracker gives the same bits on the card as on the CPU.  Nothing in a level reads the host, so a
whole `_track` is queued without a sync, and can be captured.  `prep`
and `track` are `_prep` and `_track` as captured steps (utils/graphs.py,
keyed by image size; eager on the CPU and with capture=False), the
counterparts of the two jitted functions: `feed` and the loop closure's
verification run them.  DenseSLAM runs `_prep` and `_track` inside its
own captured step.  The pose comes to the host once, through
`read_result`, when the caller needs it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.geometry import CameraIntrinsics, CameraParams, inverse4
from ..ops.cuda import icp_kernel
from ..ops.image_ops import fma32
from ..utils.device import resolve_device, upload
from ..utils.graphs import StaticInputs, StepGraphs

_F32 = torch.float32
# the narrowest image whose x rays the jitted JAX `_prep` takes through one
# fused multiply-add (XLA:CPU's choice; narrower ones round twice)
XLA_FUSED_X_MIN_WIDTH = 72


def vertex_map(depth: torch.Tensor, cam: CameraParams, fused=(False, False)) -> torch.Tensor:
    """Depth [H, W] -> camera-space points [H, W, 3] (0-depth -> 0).
    fused: whether the x and the y rays fx_inv * u + cx_inv take one
    rounding (image_ops.fma32, as XLA:CPU contracts them) or two."""
    dev = depth.device
    u = torch.arange(cam.img_w, dtype=_F32, device=dev)
    v = torch.arange(cam.img_h, dtype=_F32, device=dev)
    uu, vv = torch.meshgrid(u, v, indexing="xy")
    ki = cam.intrinsics_inv
    rays = [fma32(torch.full_like(g, f), g, torch.full_like(g, c)) if fuse else f * g + c * 1.0
            for g, f, c, fuse in zip((uu, vv), (ki.fx, ki.fy), (ki.cx, ki.cy), fused)]
    dirs = torch.stack([rays[0], rays[1], torch.ones_like(uu)], -1)
    return dirs * depth[..., None]


def normal_map(verts: torch.Tensor) -> torch.Tensor:
    """Screen-space normals from a vertex map (cross of finite diffs;
    torch.roll wraps around, as jnp.roll does).  Restates torch's CPU
    arithmetic so that every device gives its bits: linalg.cross there
    fuses each component's first product and the difference into one
    multiply-add, fma(a1, b2, -(a2 b1)), and vector_norm takes the correctly
    rounded root of fma(z, z, fma(y, y, x x)); here through image_ops.fma32
    and a float64 root rounded once."""
    dx = torch.roll(verts, -1, 1) - verts
    dy = torch.roll(verts, -1, 0) - verts
    a0, a1, a2 = dx.unbind(-1)
    b0, b1, b2 = dy.unbind(-1)
    x = fma32(a1, b2, -(a2 * b1))
    y = fma32(a2, b0, -(a0 * b2))
    z = fma32(a0, b1, -(a1 * b0))
    nn = torch.sqrt(fma32(z, z, fma32(y, y, x * x)).double()).float()[..., None]
    return torch.stack([x, y, z], -1) / torch.where(nn == 0, 1.0, nn)


def transform_points(m: torch.Tensor, p: torch.Tensor, translate: bool = True) -> torch.Tensor:
    """m [4, 4] applied to points p [..., 3] in SE3.apply_xyz's order,
    ((r0 x + r1 y) + r2 z) + t, elementwise (no matmul, whose sum order
    differs between devices); translate=False rotates only."""
    x, y, z = p.unbind(-1)
    out = []
    for i in range(3):
        q = (m[i, 0] * x + m[i, 1] * y) + m[i, 2] * z
        out.append(q + m[i, 3] if translate else q)
    return torch.stack(out, -1)


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
    """se3 exp map: xi = (omega[3], v[3]) -> (R [3,3], t [3]), in float64
    as ICP's update takes it (ops/cuda/icp_kernel.exp_se3_64), rounded once
    to float32."""
    r, t = icp_kernel.exp_se3_64(xi.tolist())
    return (torch.tensor(r, dtype=torch.float64).to(_F32).to(xi.device),
            torch.tensor(t, dtype=torch.float64).to(_F32).to(xi.device))


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
    trace: Optional[list] = None,
):
    """Iterate point-to-plane ICP at one pyramid level.

    T0: initial world_T_cam estimate for the current frame (4x4).
    Returns (refined world_T_cam, rmse, inlier count) as device tensors;
    nothing in the loop reads the device.  trace: a list that gets
    (T, rmse, inliers) after each iteration."""
    dev = src_verts.device
    h, w = src_verts.shape[:2]
    src = src_verts.reshape(-1, 3).contiguous()
    # vertex + normal + validity in ONE [N, 8] row array: the
    # per-iteration correspondence lookup is a single row gather
    ref_pack = torch.cat([
        ref_verts_w.reshape(-1, 3),
        ref_normals_w.reshape(-1, 3),
        ref_valid.reshape(-1, 1).to(_F32),
        torch.zeros((h * w, 1), dtype=_F32, device=dev),
    ], 1)

    intr = (cam.intrinsics.fx, cam.intrinsics.fy, cam.intrinsics.cx, cam.intrinsics.cy)
    # a device-tensor numerator: torch divides a Python scalar by a
    # tensor through the reciprocal, not the correctly rounded quotient
    delta = torch.full((), huber_delta, dtype=_F32, device=dev)
    dist2 = float(np.float32(dist_thresh * dist_thresh))
    ref_pose = ref_cam_T_world.contiguous()
    T = T0.contiguous()
    rmse = torch.zeros((), dtype=_F32, device=dev)
    inl = torch.zeros((), dtype=_F32, device=dev)
    for _ in range(iters):
        T, rmse, inl = icp_kernel.icp_step(T, src, ref_pack, ref_pose, delta, intr, w, h, dist2)
        if trace is not None:
            trace.append((T, rmse, inl))
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
        capture: bool = True,
        graphs: Optional[StepGraphs] = None,
    ):
        """capture: prep and track as captured steps (the default; eager
        with False); graphs: their cache, one on `device` unless given."""
        self.device = resolve_device(device)
        self.capture = capture
        self.graphs = graphs if graphs is not None else StepGraphs(self.device)
        self._static = {}
        self._tick = 0
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
        """Depth [H, W] -> per level (vertices, normals, valid), as the
        jitted JAX `_prep` computes them: XLA:CPU fuses the y rays into one
        multiply-add at every width and the x rays at widths of
        XLA_FUSED_X_MIN_WIDTH and up (vertex_map's `fused`), and its cross
        product and norm contract as normal_map restates them.  An ulp
        here decides the normal at the pixels whose right and lower
        neighbours are invalid (ROADMAP's watch list: 0/0 normals)."""
        out = []
        d = depth
        for lv in range(self.levels):
            cam = self.cams[lv]
            verts = vertex_map(d, cam, (cam.img_w >= XLA_FUSED_X_MIN_WIDTH, True))
            out.append((verts, normal_map(verts), d > 0))
            if lv + 1 < self.levels:
                d = _downsample(d)
        return out

    def _track(self, T0: torch.Tensor, pyr_cur, pyr_ref, ref_pose: torch.Tensor,
               trace: Optional[list] = None):
        """Multi-level ICP of pyr_cur against pyr_ref (seen from
        ref_pose, its cam_T_world) from the seed T0 (world_T_cam).
        Returns (world_T_cam, rmse, inliers) as device tensors, queued
        without a host read; trace, a list, gets each iteration's
        (T, rmse, inliers), coarse level first.  The reference view's
        world_T_cam is core/geometry.inverse4's (a float64 inverse rounded
        once), the JAX package's jnp.linalg.inv to a few ulps."""
        ref_world_T_cam = inverse4(ref_pose)
        T = T0
        rmse = inl = None
        for lv in reversed(range(self.levels)):  # coarse to fine
            verts_c, _, _ = pyr_cur[lv]
            verts_r, normals_r, valid_r = pyr_ref[lv]
            # reference maps to world coordinates
            rw = transform_points(ref_world_T_cam, verts_r)
            nw = transform_points(ref_world_T_cam, normals_r, translate=False)
            T, rmse, inl = _icp_level(
                T, verts_c, rw, nw, valid_r, self.cams[lv], ref_pose,
                self.iters[min(lv, len(self.iters) - 1)], self.dist_thresh,
                self.huber_delta, trace)
        return T, rmse, inl

    # ------------------------------------------------------------------
    # the captured steps (jax.jit of _prep and of _track)
    # ------------------------------------------------------------------
    def _pyramid_buffers(self, h: int, w: int) -> list:
        """Static tensors shaped as _prep's pyramid of an h x w depth,
        flat: (vertices, normals, valid) per level."""
        out = []
        for _ in range(self.levels):
            out += [torch.zeros((h, w, 3), dtype=_F32, device=self.device),
                    torch.zeros((h, w, 3), dtype=_F32, device=self.device),
                    torch.zeros((h, w), dtype=torch.bool, device=self.device)]
            h, w = (h + 1) // 2, (w + 1) // 2
        return out

    def _statics(self, kind: str, h: int, w: int) -> dict:
        key = (kind, h, w)
        if key not in self._static:
            if kind == "prep":
                st = {"in": StaticInputs({"depth": ((h, w), _F32)}, self.device),
                      "out": self._pyramid_buffers(h, w)}
            else:
                st = {"in": [torch.zeros((4, 4), dtype=_F32, device=self.device)
                             for _ in range(2)]
                      + self._pyramid_buffers(h, w) + self._pyramid_buffers(h, w),
                      "out": [torch.zeros((4, 4), dtype=_F32, device=self.device),
                              torch.zeros((), dtype=_F32, device=self.device),
                              torch.zeros((), dtype=_F32, device=self.device)]}
            self._static[key] = st
        return self._static[key]

    def prep(self, depth):
        """_prep as a captured step: depth a host array or a float32
        tensor on the device [H, W] -> the pyramid, fresh tensors."""
        if not self.capture:
            if not isinstance(depth, torch.Tensor):
                depth = upload(depth, self.device)
            return self._prep(depth)
        h, w = depth.shape
        st = self._statics("prep", h, w)
        inputs, out = st["in"], st["out"]
        staged = not isinstance(depth, torch.Tensor)
        slot = None
        if staged:
            slot = self._tick % 2
            self._tick += 1
            inputs.fill(slot, depth=depth)
        else:
            inputs.dev["depth"].copy_(depth)

        def body():
            if staged:
                inputs.upload(slot)
            for dst, src in zip(out, _flat(self._prep(inputs.dev["depth"]))):
                dst.copy_(src)

        self.graphs.run(("icp_prep", h, w, staged, slot), body)
        if staged:
            inputs.done(slot)
        return _unflat([t.clone() for t in out])

    def track(self, T0: torch.Tensor, pyr_cur, pyr_ref, ref_pose: torch.Tensor):
        """_track as a captured step (the inputs are copied into its static
        buffers); returns (world_T_cam, rmse, inliers) as fresh device
        tensors, without a host read."""
        if not self.capture:
            return self._track(T0, pyr_cur, pyr_ref, ref_pose)
        h, w = pyr_cur[0][0].shape[:2]
        st = self._statics("track", h, w)
        inputs, out = st["in"], st["out"]
        for dst, src in zip(inputs, [T0, ref_pose, *_flat(pyr_cur), *_flat(pyr_ref)]):
            dst.copy_(src)
        n = 3 * self.levels

        def body():
            res = self._track(inputs[0], _unflat(inputs[2:2 + n]), _unflat(inputs[2 + n:]),
                              inputs[1])
            for dst, src in zip(out, res):
                dst.copy_(src)

        self.graphs.run(("icp_track", h, w), body)
        return tuple(t.clone() for t in out)

    def feed(self, depth: np.ndarray, timestamp_ms: int = 0):
        """Track one depth frame; returns (cam_T_world, ok) on the host
        (one read, the rmse's and the pose's, as the JAX feed)."""
        pyr = self.prep(depth)
        if self._prev is None:
            self._prev = (pyr, upload(np.linalg.inv(self.world_T_cam), self.device))
            return np.linalg.inv(self.world_T_cam), True
        prev_pyr, prev_pose = self._prev
        T, rmse, inl = read_result(*self.track(
            upload(self.world_T_cam, self.device), pyr, prev_pyr, prev_pose))
        ok = bool(np.isfinite(float(rmse))) and float(rmse) < self.max_rmse and float(inl) > 100
        if ok:
            self.world_T_cam = T
        cam_T_world = np.linalg.inv(self.world_T_cam).astype(np.float32)
        self._prev = (pyr, upload(cam_T_world, self.device))
        return cam_T_world, ok

    def feed_stereo(self, img_left, img_right, timestamp_ms, imu=None):
        raise NotImplementedError("ICPOdometry tracks depth frames; use feed()")


def _flat(pyr) -> list:
    return [t for level in pyr for t in level]


def _unflat(tensors) -> list:
    return [tuple(tensors[i:i + 3]) for i in range(0, len(tensors), 3)]
