"""Rigid transforms and pinhole cameras (counterpart of
disinfect_slam_tpu/core/geometry.py; reference lie_group.cuh:8-45 and
camera.cuh:13-68).

A pose is tiny and arrives from the host, so its quaternion and rotation
entries are computed once per frame in float32 on the CPU, exactly as the
JAX package computes them (matrix -> quaternion -> rotation entries).
Going through the quaternion matters: the JAX path never uses the 4x4
matrix directly, and taking the matrix instead moves poses by an ulp and
with them the allocated blocks.  The entries then enter the per-voxel
tensor ops as Python floats holding float32 values, so every op runs in
float32 on whatever device the voxel tensors live on.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_F = np.float32


def _mat_to_quat(m: np.ndarray) -> np.ndarray:
    """Rotation matrix [3, 3] -> quaternion (w, x, y, z) in float32,
    Shepperd's method with the JAX package's branch order."""
    m = np.asarray(m, _F)
    m00, m01, m02 = m[0, 0], m[0, 1], m[0, 2]
    m10, m11, m12 = m[1, 0], m[1, 1], m[1, 2]
    m20, m21, m22 = m[2, 0], m[2, 1], m[2, 2]
    t = m00 + m11 + m22
    one, two, quarter, tiny = _F(1.0), _F(2.0), _F(0.25), _F(1e-12)
    if t > 0:
        s = np.sqrt(max(t + one, tiny)) * two
        q = [quarter * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s]
    else:
        # the first maximum of [trace, m00, m11, m22] picks the branch;
        # with t <= 0 it is one of the diagonal entries
        idx = max(int(np.argmax(np.asarray([t, m00, m11, m22], _F))), 1)
        if idx == 1:
            s = np.sqrt(max(one + m00 - m11 - m22, tiny)) * two
            q = [(m21 - m12) / s, quarter * s, (m01 + m10) / s, (m02 + m20) / s]
        elif idx == 2:
            s = np.sqrt(max(one + m11 - m00 - m22, tiny)) * two
            q = [(m02 - m20) / s, (m01 + m10) / s, quarter * s, (m12 + m21) / s]
        else:
            s = np.sqrt(max(one + m22 - m00 - m11, tiny)) * two
            q = [(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, quarter * s]
    return np.asarray(q, _F)


def _cross(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.asarray(
        [a[1] * b[2] - a[2] * b[1],
         a[2] * b[0] - a[0] * b[2],
         a[0] * b[1] - a[1] * b[0]],
        _F,
    )


def _quat_mul(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    """Hamilton product of float32 quaternions (w, x, y, z)."""
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.asarray(
        [w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
         w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
         w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
         w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2],
        _F,
    )


def _quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """v' = v + 2w(u x v) + 2(u x (u x v)) for q = (w, u)."""
    u = q[1:4]
    uv = _cross(u, v)
    uuv = _cross(u, uv)
    return (v + _F(2.0) * (q[0] * uv + uuv)).astype(_F)


@dataclasses.dataclass(frozen=True)
class SE3:
    """Rigid transform x' = R x + t, rotation held as a unit quaternion."""

    q: np.ndarray  # f32 [4] (w, x, y, z)
    t: np.ndarray  # f32 [3]

    @classmethod
    def identity(cls) -> "SE3":
        return cls(q=np.asarray([1, 0, 0, 0], _F), t=np.zeros(3, _F))

    @classmethod
    def from_matrix(cls, m) -> "SE3":
        """From a 3x4 or 4x4 row-major transform matrix."""
        m = np.asarray(m, _F)
        return cls(q=_mat_to_quat(m[:3, :3]), t=m[:3, 3].copy())

    @classmethod
    def from_numpy(cls, m: np.ndarray) -> "SE3":
        return cls.from_matrix(np.asarray(m, _F))

    def matrix(self) -> np.ndarray:
        """As a float32 4x4 matrix (the rotation from the quaternion)."""
        m = np.eye(4, dtype=_F)
        m[:3, :3] = np.asarray(self.rotation_entries(), _F).reshape(3, 3)
        m[:3, 3] = self.t
        return m

    def apply(self, pts: torch.Tensor) -> torch.Tensor:
        """Transform float32 points [..., 3] (a tensor): rotate(pts) + t."""
        return self.rotate(pts) + torch.as_tensor(self.t, device=pts.device)

    def compose(self, other: "SE3") -> "SE3":
        """self * other (apply `other` first)."""
        return SE3(q=_quat_mul(self.q, other.q),
                   t=(_quat_rotate(self.q, other.t) + self.t).astype(_F))

    def __matmul__(self, other: "SE3") -> "SE3":
        return self.compose(other)

    def inverse(self) -> "SE3":
        q_inv = (self.q * np.asarray([1, -1, -1, -1], _F)).astype(_F)
        return SE3(q=q_inv, t=_quat_rotate(q_inv, -self.t))

    def rotation_entries(self) -> tuple:
        """The 9 rotation-matrix scalars (r00..r22) from the quaternion,
        as Python floats holding float32 values."""
        w, x, y, z = self.q
        one, two = _F(1.0), _F(2.0)
        r = (
            one - two * (y * y + z * z), two * (x * y - w * z), two * (x * z + w * y),
            two * (x * y + w * z), one - two * (x * x + z * z), two * (y * z - w * x),
            two * (x * z - w * y), two * (y * z + w * x), one - two * (x * x + y * y),
        )
        return tuple(float(_F(v)) for v in r)

    def apply_xyz(self, px, py, pz):
        """Transform component tensors (float32) -> component tensors."""
        r00, r01, r02, r10, r11, r12, r20, r21, r22 = self.rotation_entries()
        t0, t1, t2 = (float(v) for v in self.t)
        return (
            r00 * px + r01 * py + r02 * pz + t0,
            r10 * px + r11 * py + r12 * pz + t1,
            r20 * px + r21 * py + r22 * pz + t2,
        )

    def rotate_xyz(self, vx, vy, vz):
        """Rotate component tensors (no translation)."""
        r00, r01, r02, r10, r11, r12, r20, r21, r22 = self.rotation_entries()
        return (
            r00 * vx + r01 * vy + r02 * vz,
            r10 * vx + r11 * vy + r12 * vz,
            r20 * vx + r21 * vy + r22 * vz,
        )

    def rotate(self, vecs):
        """Rotate float32 vectors [..., 3] (a tensor) by the quaternion,
        v + 2w(u x v) + 2(u x (u x v)), the JAX package's formula."""
        w, ux, uy, uz = (float(c) for c in self.q)
        vx, vy, vz = vecs.unbind(-1)
        cx, cy, cz = uy * vz - uz * vy, uz * vx - ux * vz, ux * vy - uy * vx
        ccx, ccy, ccz = uy * cz - uz * cy, uz * cx - ux * cz, ux * cy - uy * cx
        return vecs + 2.0 * (w * torch.stack([cx, cy, cz], -1)
                             + torch.stack([ccx, ccy, ccz], -1))


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    """Pinhole intrinsics as Python floats holding float32 values
    (camera.cuh:13-52)."""

    fx: float
    fy: float
    cx: float
    cy: float

    @classmethod
    def create(cls, fx, fy, cx, cy) -> "CameraIntrinsics":
        return cls(*(float(_F(v)) for v in (fx, fy, cx, cy)))

    def inverse(self) -> "CameraIntrinsics":
        """Closed-form inverse (camera.cuh:35-39), in float32."""
        fx_inv = _F(1.0) / _F(self.fx)
        fy_inv = _F(1.0) / _F(self.fy)
        return CameraIntrinsics(
            float(fx_inv), float(fy_inv),
            float(-_F(self.cx) * fx_inv), float(-_F(self.cy) * fy_inv),
        )

    def project(self, pts):
        """Camera points [..., 3] (a float32 tensor) -> homogeneous image
        coords (u z, v z, z); on `.inverse()` it back-projects pixels."""
        x, y, z = pts.unbind(-1)
        return torch.stack(
            [self.fx * x + self.cx * z, self.fy * y + self.cy * z, z], -1
        )

    def unproject(self, uv1):
        """Apply as a linear map to homogeneous pixels [..., 3] (use on
        .inverse() to back-project, as intrinsics_inv * (u, v, 1))."""
        return self.project(uv1)

    def matrix(self) -> np.ndarray:
        """The float32 3x3 matrix [[fx, 0, cx], [0, fy, cy], [0, 0, 1]]."""
        return np.asarray([[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]], _F)


@dataclasses.dataclass(frozen=True)
class CameraParams:
    """Intrinsics + inverse + image size (camera.cuh:54-68)."""

    intrinsics: CameraIntrinsics
    intrinsics_inv: CameraIntrinsics
    img_h: int
    img_w: int

    @classmethod
    def create(cls, intrinsics: CameraIntrinsics, img_h: int, img_w: int):
        return cls(intrinsics, intrinsics.inverse(), int(img_h), int(img_w))
