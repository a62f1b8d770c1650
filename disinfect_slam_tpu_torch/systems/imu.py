"""IMU handling: gyro preintegration for tracker motion priors
(counterpart of disinfect_slam_tpu/systems/imu.py).

The reference forwards raw IMU samples to ORB_SLAM3 (zed.cc:33-74 queues
simuData at ~405 Hz; disinfect_slam.cc:83-98 passes them to TrackStereo)
and never integrates them itself.  Here the IMU earns its keep inside
the framework: gyro samples preintegrate into a relative rotation that
seeds the ICP tracker's initial pose, which is what keeps projective ICP
converging through fast rotations.

The JAX package's module is plain numpy; it is restated here, line for
line (tests/test_torch_slam_host.py pins the two together), so that the
port and the GPU smoke run load nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class IMUSample:
    timestamp_ms: float
    accel: np.ndarray  # [3] m/s^2 (camera frame)
    gyro: np.ndarray  # [3] rad/s (camera frame)


def _exp_so3(w: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(w)
    if theta < 1e-12:
        return np.eye(3)
    k = w / theta
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * (kx @ kx)


class GyroPreintegrator:
    """Accumulates gyro samples between camera frames.

    relative_rotation(t0, t1) integrates all samples in (t0, t1] into
    cam1_R_cam0 (midpoint rule); used as the rotation prior when seeding
    frame-to-model ICP.
    """

    def __init__(self, bias: np.ndarray | None = None, max_samples: int = 100000):
        self.samples: List[IMUSample] = []
        self.bias = np.zeros(3) if bias is None else np.asarray(bias, np.float64)
        self.max_samples = max_samples

    def add(self, sample: IMUSample) -> None:
        self.samples.append(sample)
        if len(self.samples) > self.max_samples:
            del self.samples[: len(self.samples) - self.max_samples]

    def add_raw(self, timestamp_ms, gyro, accel=(0.0, 0.0, 0.0)) -> None:
        self.add(
            IMUSample(
                float(timestamp_ms),
                np.asarray(accel, np.float64),
                np.asarray(gyro, np.float64),
            )
        )

    def estimate_bias(self, window_ms: float = 500.0) -> None:
        """Estimate gyro bias from the earliest (assumed static) window."""
        if not self.samples:
            return
        t0 = self.samples[0].timestamp_ms
        sel = [s.gyro for s in self.samples if s.timestamp_ms - t0 <= window_ms]
        if sel:
            self.bias = np.mean(sel, axis=0)

    def relative_rotation(self, t0_ms: float, t1_ms: float) -> np.ndarray:
        """cam(t1)_R_cam(t0) from gyro integration over (t0, t1].

        Body rates compose on the RIGHT: R(t+dt) = R(t) exp(w dt), so
        the accumulated delta is exp(w_0 dt) ... exp(w_N dt) in
        chronological order (left-multiplying reversed the chain — a
        second-order commutator error on tumbling motion; same
        convention as relative_motion's r_wc update).
        """
        r = np.eye(3)
        prev_t = t0_ms
        prev_w = None
        for s in self.samples:
            if s.timestamp_ms <= t0_ms:
                prev_w = s.gyro - self.bias
                continue
            if s.timestamp_ms > t1_ms:
                break
            w = s.gyro - self.bias
            dt = (s.timestamp_ms - prev_t) * 1e-3
            w_mid = w if prev_w is None else 0.5 * (w + prev_w)
            r = r @ _exp_so3(w_mid * dt)
            prev_t = s.timestamp_ms
            prev_w = w
        if prev_t < t1_ms and prev_w is not None:
            r = r @ _exp_so3(prev_w * (t1_ms - prev_t) * 1e-3)
        # rotation of the WORLD seen from the camera advances opposite to
        # the camera's own rotation
        return r.T


class ImuPreintegrator(GyroPreintegrator):
    """GyroPreintegrator + accelerometer gravity estimation.

    The reference forwards accel to ORB_SLAM3's IMU_STEREO mode, whose
    initializer gravity-aligns the world frame (disinfect_slam.cc:83-98);
    stand-alone tracking here starts at identity instead.  This class
    closes that gap: a static window of accel samples estimates the
    gravity direction in the camera frame, and gravity_aligned_pose()
    returns a world_T_cam0 whose world +z axis is up — so maps, bbox
    queries, and meshes come out level regardless of how the camera was
    tilted at start.
    """

    GRAVITY = 9.80665  # m/s^2

    def estimate_gravity(self, window_ms: float = 500.0) -> np.ndarray | None:
        """Mean specific force over the earliest (assumed static) window
        = the UP direction in the camera frame (an accelerometer at rest
        measures the support reaction, opposite gravity).  Returns a
        unit [3] vector, or None without plausible samples (norm must be
        within 40% of g: a device in free fall or heavy motion cannot
        vote on gravity)."""
        if not self.samples:
            return None
        t0 = self.samples[0].timestamp_ms
        sel = [
            s.accel for s in self.samples if s.timestamp_ms - t0 <= window_ms
        ]
        if not sel:
            return None
        mean = np.mean(sel, axis=0)
        norm = float(np.linalg.norm(mean))
        if not (0.6 * self.GRAVITY <= norm <= 1.4 * self.GRAVITY):
            return None
        return mean / norm

    def gravity_aligned_pose(self, window_ms: float = 500.0) -> np.ndarray:
        """world_T_cam0 [4, 4] rotating the measured up direction onto
        world +z by the minimal rotation (yaw is unobservable from
        gravity and left at zero).  Identity when gravity can't be
        estimated (fail-open: same behavior as before this feature)."""
        up_c = self.estimate_gravity(window_ms)
        out = np.eye(4)
        if up_c is None:
            return out
        z_w = np.array([0.0, 0.0, 1.0])
        # minimal rotation taking up_c -> z_w (Rodrigues about their
        # common normal); degenerate antiparallel case: flip about x
        c = float(np.dot(up_c, z_w))
        axis = np.cross(up_c, z_w)
        s = float(np.linalg.norm(axis))
        if s < 1e-12:
            r = np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
        else:
            r = _exp_so3(axis / s * np.arctan2(s, c))
        out[:3, :3] = r
        return out


    def estimate_accel_bias(self, window_ms: float = 500.0) -> None:
        """Accelerometer bias from the earliest (assumed static) window:
        the residual after removing the measured gravity reaction.  A
        no-op when gravity can't be estimated (the bias would then
        absorb a real force).

        Observability note: a static window cannot separate the
        transverse bias components from the gravity *direction* — they
        tilt the estimated up vector and are absorbed into it; only the
        along-gravity magnitude residual lands in the bias.  That split
        is self-consistent: as long as gravity_aligned_pose() (the same
        window's up estimate) anchors the world frame, static intervals
        preintegrate to exactly zero translation, and real forces leak
        gravity only at second order (tilt <= |b_xy|/G radians)."""
        up = self.estimate_gravity(window_ms)
        if up is None:
            return
        t0 = self.samples[0].timestamp_ms
        sel = [
            s.accel for s in self.samples if s.timestamp_ms - t0 <= window_ms
        ]
        self.accel_bias = np.mean(sel, axis=0) - up * self.GRAVITY

    def relative_motion(
        self,
        t0_ms: float,
        t1_ms: float,
        world_R_cam0: np.ndarray,
        v0_world: np.ndarray | tuple = (0.0, 0.0, 0.0),
    ):
        """Full inertial preintegration over (t0, t1] — the translation
        companion to relative_rotation.

        The reference forwards accel+gyro to ORB_SLAM3's stereo-inertial
        mode and never integrates them itself (disinfect_slam.cc:83-98,
        zed.cc:33-74); here the same samples yield a full SE3 motion
        prior for the ICP tracker.  Midpoint integration in a
        gravity-aligned world frame (+z up):

            R_wc <- R_wc exp(w dt)
            a_w   = R_wc (f - b_a) + g_w          (g_w = -G z)
            p    += v dt + a_w dt^2 / 2;  v += a_w dt

        Args: world_R_cam0 — camera attitude at t0 in a gravity-aligned
        world (e.g. from the tracked pose); v0_world — camera velocity
        at t0 (e.g. finite-differenced from recent tracked poses).

        Returns (cam1_R_cam0, delta_p_world, v1_world): the rotation in
        the same convention as relative_rotation, the world-frame
        translation of the camera over the interval, and the predicted
        end velocity.
        """
        g_w = np.array([0.0, 0.0, -self.GRAVITY])
        b_a = getattr(self, "accel_bias", np.zeros(3))
        r_wc = np.asarray(world_R_cam0, np.float64).copy()
        v = np.asarray(v0_world, np.float64).copy()
        p = np.zeros(3)
        prev_t = t0_ms
        prev_w = None
        prev_f = None

        def _advance(w_mid, f_mid, dt):
            nonlocal r_wc, v, p
            # attitude at the midpoint for rotating the specific force
            r_half = r_wc @ _exp_so3(w_mid * (0.5 * dt))
            a_w = r_half @ (f_mid - b_a) + g_w
            p += v * dt + 0.5 * a_w * dt * dt
            v += a_w * dt
            r_wc = r_wc @ _exp_so3(w_mid * dt)

        for s in self.samples:
            if s.timestamp_ms <= t0_ms:
                prev_w = s.gyro - self.bias
                prev_f = s.accel
                continue
            if s.timestamp_ms > t1_ms:
                break
            w = s.gyro - self.bias
            f = s.accel
            dt = (s.timestamp_ms - prev_t) * 1e-3
            w_mid = w if prev_w is None else 0.5 * (w + prev_w)
            f_mid = f if prev_f is None else 0.5 * (f + prev_f)
            _advance(w_mid, f_mid, dt)
            prev_t = s.timestamp_ms
            prev_w, prev_f = w, f
        if prev_t < t1_ms and prev_w is not None:
            _advance(prev_w, prev_f, (t1_ms - prev_t) * 1e-3)

        r_rel = (np.asarray(world_R_cam0).T @ r_wc).T  # cam1_R_cam0 conv.
        return r_rel, p, v


def seed_pose_with_imu(
    world_T_cam_prev: np.ndarray,
    preint: "ImuPreintegrator",
    t0_ms: float,
    t1_ms: float,
    v0_world: np.ndarray | tuple = (0.0, 0.0, 0.0),
):
    """Full SE3 ICP seed from inertial preintegration: rotation AND
    translation priors applied to the previous tracked pose.  Returns
    (world_T_cam_seed [4, 4], v1_world) — feed v1 back as the next
    frame's v0 (or re-derive it from tracked poses, which self-corrects
    accel bias drift)."""
    r_rel, dp, v1 = preint.relative_motion(
        t0_ms, t1_ms, world_T_cam_prev[:3, :3], v0_world
    )
    out = world_T_cam_prev.copy()
    out[:3, :3] = world_T_cam_prev[:3, :3] @ r_rel.T
    out[:3, 3] = world_T_cam_prev[:3, 3] + dp
    return out, v1


def seed_pose_with_gyro(
    world_T_cam_prev: np.ndarray,
    preint: GyroPreintegrator,
    t0_ms: float,
    t1_ms: float,
) -> np.ndarray:
    """Apply the gyro rotation prior to the previous pose estimate."""
    rel = np.eye(4)
    rel[:3, :3] = preint.relative_rotation(t0_ms, t1_ms)
    out = world_T_cam_prev.copy()
    out[:3, :3] = world_T_cam_prev[:3, :3] @ rel[:3, :3].T
    return out
