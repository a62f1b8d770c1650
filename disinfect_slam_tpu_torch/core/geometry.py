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

`DevicePose` is the same pose in device memory (the counterpart of the
traced pose array of the JAX package's jitted steps): one float32 buffer
of 32 slots that the host fills with SE3's own float32 arithmetic, read
by the tensor ops as 0-d views and by the kernels through a pointer, so
that a captured step (utils/graphs.py) reads each frame's pose where a
Python float would be frozen into the graph.  A float32 0-d tensor times
a float32 tensor rounds as the Python float holding the same float32
value does, so the two poses give the same bits.  A pose computed on the
device (DenseSLAM's tracked one) is turned into those slots there, with
the host's arithmetic (`pose_floats_of_matrix`), and inverted there with
numpy's bits (`inverse4`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import upload

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


class _PoseOps:
    """The per-voxel pose ops, shared by the host pose (SE3: Python floats
    holding float32 values) and the device pose (DevicePose: 0-d float32
    views of its buffer).  Each op keeps the JAX package's order,
    ((r0 x + r1 y) + r2 z) + t, one rounding per op."""

    def rotation_entries(self) -> tuple:
        raise NotImplementedError

    def _translation(self) -> tuple:
        raise NotImplementedError

    def _quaternion(self) -> tuple:
        raise NotImplementedError

    def translation_tensor(self, device) -> torch.Tensor:
        """The translation as a float32 [3] tensor on `device`."""
        raise NotImplementedError

    def apply(self, pts: torch.Tensor) -> torch.Tensor:
        """Transform float32 points [..., 3] (a tensor): rotate(pts) + t."""
        return self.rotate(pts) + self.translation_tensor(pts.device)

    def apply_xyz(self, px, py, pz):
        """Transform component tensors (float32) -> component tensors."""
        r00, r01, r02, r10, r11, r12, r20, r21, r22 = self.rotation_entries()
        t0, t1, t2 = self._translation()
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
        w, ux, uy, uz = self._quaternion()
        vx, vy, vz = vecs.unbind(-1)
        cx, cy, cz = uy * vz - uz * vy, uz * vx - ux * vz, ux * vy - uy * vx
        ccx, ccy, ccz = uy * cz - uz * cy, uz * cx - ux * cz, ux * cy - uy * cx
        return vecs + 2.0 * (w * torch.stack([cx, cy, cz], -1)
                             + torch.stack([ccx, ccy, ccz], -1))


@dataclasses.dataclass(frozen=True)
class SE3(_PoseOps):
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

    def _translation(self) -> tuple:
        return tuple(float(v) for v in self.t)

    def _quaternion(self) -> tuple:
        return tuple(float(c) for c in self.q)

    def translation_tensor(self, device) -> torch.Tensor:
        return torch.as_tensor(self.t, device=device)


# The device pose's buffer: the pose's 9 rotation entries (r00..r22), its
# translation and its quaternion (w, x, y, z), then the same 16 slots of
# its inverse.  Slots 0-11 and 16-27 are the kernels' pose12 (r00..r22,
# t0..t2) of the pose and of its inverse.
POSE_FLOATS = 32
_HALF = 16


def pose_floats(pose: SE3) -> np.ndarray:
    """The 32 float32 slots of a device pose for `pose`: SE3's own host
    arithmetic (rotation_entries, inverse), so every slot holds the bits
    the host pose hands the tensor ops."""
    out = np.empty(POSE_FLOATS, _F)
    for half, p in enumerate((pose, pose.inverse())):
        o = half * _HALF
        out[o:o + 9] = p.rotation_entries()
        out[o + 9:o + 12] = p.t
        out[o + 12:o + 16] = p.q
    return out


class DevicePose(_PoseOps):
    """An SE3 in device memory: `buf`, a float32 [32] tensor laid out as
    pose_floats writes it, read in place (the host fills it, and a
    captured step replays with whatever it holds).  The tensor ops read
    0-d views of it; the kernels take `kernel_ptr()`, the address of the
    12 floats r00..r22, t0..t2.  inverse() is the view of the inverse's
    slots (and the inverse of that view is the pose itself)."""

    def __init__(self, buf: torch.Tensor, half: int = 0):
        if buf.dtype != torch.float32 or tuple(buf.shape) != (POSE_FLOATS,):
            raise ValueError(f"a device pose is f32 [{POSE_FLOATS}], got {buf.dtype} "
                             f"{tuple(buf.shape)}")
        if not buf.is_contiguous():
            raise ValueError("a device pose's buffer must be contiguous")
        self.buf = buf
        self._half = half
        o = half * _HALF
        self._r = tuple(buf[o + i] for i in range(9))
        self._t = tuple(buf[o + 9 + i] for i in range(3))
        self._q = tuple(buf[o + 12 + i] for i in range(4))

    @classmethod
    def empty(cls, device) -> "DevicePose":
        """A buffer for a captured step's pose (the identity until filled)."""
        return cls.from_se3(SE3.identity(), device)

    @classmethod
    def from_se3(cls, pose: SE3, device) -> "DevicePose":
        """The pose uploaded into a new buffer on `device` (to a CUDA device
        through pinned memory, without waiting for the stream)."""
        return cls(upload(pose_floats(pose), torch.device(device)))

    @classmethod
    def from_matrix(cls, m, device) -> "DevicePose":
        return cls.from_se3(SE3.from_matrix(m), device)

    @property
    def device(self) -> torch.device:
        return self.buf.device

    @property
    def t(self) -> torch.Tensor:
        """The translation, f32 [3] (a view)."""
        o = self._half * _HALF
        return self.buf[o + 9:o + 12]

    @property
    def q(self) -> torch.Tensor:
        """The quaternion (w, x, y, z), f32 [4] (a view)."""
        o = self._half * _HALF
        return self.buf[o + 12:o + 16]

    def slots(self) -> torch.Tensor:
        """The 32 slots with this pose's first, as pose_floats lays them
        out (the buffer itself, or its halves swapped for an inverse
        view)."""
        return self.buf if self._half == 0 else self.buf.roll(_HALF)

    def kernel_ptr(self) -> int:
        """Device address of the kernels' pose12 (r00..r22, t0..t2)."""
        return self.buf.data_ptr() + 4 * self._half * _HALF

    def inverse(self) -> "DevicePose":
        return DevicePose(self.buf, 1 - self._half)

    def rotation_entries(self) -> tuple:
        return self._r

    def _translation(self) -> tuple:
        return self._t

    def _quaternion(self) -> tuple:
        return self._q

    def translation_tensor(self, device) -> torch.Tensor:
        return self.t


# the quaternion's numerators (Shepperd's method): row b holds branch b's
# (w, x, y, z) as indices into [m21-m12, m02-m20, m10-m01, m01+m10,
# m02+m20, m12+m21]; the diagonal is the branch's own 0.25 s
_QUAT_NUM = ((0, 0, 1, 2), (0, 0, 3, 4), (1, 3, 0, 5), (2, 4, 5, 0))
# rotation_entries: r_i = 2 (A_i + sign_i B_i) over the quaternion's outer
# product (flat index 4 a + b holds q_a q_b), then 1 - r_i on the diagonal
_ROT_A = (10, 6, 7, 6, 5, 11, 7, 11, 5)
_ROT_B = (15, 3, 2, 3, 15, 1, 2, 1, 10)
_ROT_SIGN = (1.0, -1.0, 1.0, 1.0, 1.0, -1.0, -1.0, 1.0, 1.0)
_ROT_DIAG = (True, False, False, False, True, False, False, False, True)
_POSE_CONSTS: dict = {}


def _pose_consts(dev: torch.device) -> tuple:
    """The index and sign tables above on `dev`, made once a device (the
    first call uploads them, through pinned memory without a stream sync;
    a captured step makes its first call eagerly)."""
    if dev not in _POSE_CONSTS:
        tables = (torch.tensor(_QUAT_NUM), torch.tensor(_ROT_A), torch.tensor(_ROT_B),
                  torch.tensor(_ROT_SIGN, dtype=torch.float32), torch.tensor(_ROT_DIAG),
                  torch.tensor((1.0, -1.0, -1.0, -1.0), dtype=torch.float32),
                  torch.eye(4, dtype=torch.bool))
        if dev.type == "cuda":
            tables = tuple(t.pin_memory().to(dev, non_blocking=True) for t in tables)
        _POSE_CONSTS[dev] = tables
    return _POSE_CONSTS[dev]


def _cross_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """_cross on [3] tensors: two products and a difference a component
    (separate ops, so never a fused multiply-add)."""
    return a.roll(-1) * b.roll(1) - a.roll(1) * b.roll(-1)


def _pose_half_t(q: torch.Tensor, t: torch.Tensor, consts: tuple) -> torch.Tensor:
    """One half of a device pose's slots: rotation entries, t, q."""
    _, rot_a, rot_b, rot_sign, rot_diag, _, _ = consts
    p = (q[:, None] * q[None, :]).reshape(16)
    r = 2.0 * (p[rot_a] + rot_sign * p[rot_b])
    return torch.cat([torch.where(rot_diag, 1.0 - r, r), t, q])


def pose_floats_of_matrix(m: torch.Tensor) -> torch.Tensor:
    """pose_floats(SE3.from_matrix(m)) computed on m's device: the 32
    float32 slots of a device pose for a float32 4x4 (or 3x4) matrix
    tensor, with the host's numpy float32 ops in the host's order (the
    quaternion by Shepperd's method in the JAX package's branch order,
    the rotation entries from it, the inverse's quaternion and
    translation), so each slot holds the host's bits.  Branch-free and
    without a host read: a captured step turns a tracked pose into the
    pose the kernels read."""
    consts = _pose_consts(m.device)
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = m[:3, :3].reshape(9).unbind()
    tr = m00 + m11 + m22
    diag = torch.stack([tr, m00, m11, m22])
    zero = torch.zeros_like(tr)
    # 1 + t, then 1 + m_ii - m_jj - m_kk, each in the host's order
    u = ((1.0 + diag) - torch.stack([zero, m11, m00, m00])) - torch.stack([zero, m22, m22, m11])
    # the root in float64, rounded once to float32: numpy's correctly
    # rounded float32 root (torch's float32 root on the CPU is not, by an
    # ulp at some inputs)
    s = torch.sqrt(torch.clamp(u, min=1e-12).double()).float() * 2.0
    pair = torch.stack([m21 - m12, m02 - m20, m10 - m01, m01 + m10, m02 + m20, m12 + m21])
    quat = pair[consts[0]] / s[:, None]
    quat = torch.where(consts[6], 0.25 * s[:, None], quat)
    # t > 0: branch 0; else the first maximum of [t, m00, m11, m22], at least 1
    branch = torch.where(tr > 0, 0, torch.clamp(torch.argmax(diag), min=1))
    q = quat.index_select(0, branch.reshape(1))[0]
    t = m[:3, 3]
    q_inv = q * consts[5]
    u_inv = q_inv[1:4]
    uv = _cross_t(u_inv, -t)
    t_inv = -t + 2.0 * (q_inv[0] * uv + _cross_t(u_inv, uv))
    return torch.cat([_pose_half_t(q, t, consts), _pose_half_t(q_inv, t_inv, consts)])


def inverse4(m: torch.Tensor) -> torch.Tensor:
    """The float32 inverse of a 4x4 on its device with numpy's bits:
    numpy.linalg inverts a float32 matrix in float64 (LAPACK's LU) and
    rounds the result once; here linalg.inv_ex in float64, without the
    error check (which would read the LU status on the host), rounded
    once.  The two float64 inverses may differ in their last bits, which
    the rounding to float32 absorbs: equal on 20000 poses, near-singular
    and far ones included."""
    return torch.linalg.inv_ex(m.double(), check_errors=False).inverse.float()


def device_pose(pose, device) -> DevicePose:
    """`pose` as a DevicePose on `device`: a DevicePose there as it is, an
    SE3 uploaded into a new buffer (eager callers; a captured step holds
    its pose in a static buffer)."""
    if isinstance(pose, DevicePose):
        if pose.device != torch.device(device):
            raise ValueError(f"the pose lives on {pose.device}, the tensors on {device}")
        return pose
    return DevicePose.from_se3(pose, device)


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
