"""Image preprocessing on the device (counterpart of
disinfect_slam_tpu/ops/image_ops.py), in place of the reference's OpenCV
calls:

  - the rectification remap (StereoRectifier::rectify, two cv::remap
    INTER_LINEAR calls over precomputed maps, stereo_rectifier.cc:72-76):
    torch gathers and elementwise ops, on whatever device the image is;
  - the rectification maps from a raw stereo calibration
    (cv::stereoRectify + cv::initUndistortRectifyMap,
    stereo_rectifier.cc:10-48): computed once on the host in numpy, as
    OpenCV computes them (cvStereoRectify with CALIB_ZERO_DISPARITY and
    alpha=0), with no cv2 needed;
  - depth scaling and the half-resolution decimation
    (disinfect_slam.cc:37-43).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to float32, as XLA:CPU contracts a product
    feeding an add into a fused multiply-add in a jitted JAX function: the
    float32 product is exact in float64, so the sum is rounded to float64
    and then to float32 (the same unless the sum needs more than 53 bits
    and lands on a float32 tie).  Eager float64 ops, so every device gives
    the same bits."""
    return (a.double() * b.double() + c.double()).float()


def bilinear_remap(img: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor) -> torch.Tensor:
    """cv::remap(..., INTER_LINEAR) equivalent.

    img [H, W] or [H, W, C] float32; map_x/map_y [Ho, Wo] give source
    pixel coords.  Out-of-range samples clamp to the border (the valid
    region of a rectified image is that of OpenCV's constant border).
    Op for op as the jitted JAX function, whose two interpolations XLA
    contracts into top = fma(v00, 1 - fx, v01 * fx) and the like."""
    h, w = img.shape[:2]
    x0 = torch.floor(map_x)
    y0 = torch.floor(map_y)
    fx = map_x - x0
    fy = map_y - y0
    x0i = torch.clamp(x0.to(torch.int64), 0, w - 1)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    v00 = img[y0i, x0i]
    v01 = img[y0i, x1i]
    v10 = img[y1i, x0i]
    v11 = img[y1i, x1i]
    if img.ndim == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    top = fma32(v00, 1 - fx, v01 * fx)
    bot = fma32(v10, 1 - fx, v11 * fx)
    return fma32(top, 1 - fy, bot * fy)


def half_scale(img):
    """2x nearest downsample (disinfect_slam.cc:37-41 decimates); numpy
    arrays and tensors alike."""
    return img[::2, ::2]


def scale_depth(depth_raw, depth_factor: float):
    """u16 depth counts -> metres (convertTo 1/depthmap_factor): a float32
    division by the factor.  A numpy array stays on the host; a tensor's
    divisor is a tensor on the depth's device (a Python-scalar divisor
    becomes a multiply by its reciprocal on CUDA)."""
    if isinstance(depth_raw, np.ndarray):
        return depth_raw.astype(np.float32) / np.float32(depth_factor)
    factor = torch.tensor(depth_factor, dtype=torch.float32, device=depth_raw.device)
    return depth_raw.to(torch.float32) / factor


class RectifyMaps(NamedTuple):
    """Precomputed undistort-rectify maps for a stereo pair."""

    left_x: np.ndarray
    left_y: np.ndarray
    right_x: np.ndarray
    right_y: np.ndarray
    rectified_intrinsics: Tuple[float, float, float, float]


def _undistort_rectify_map(K, dist, R, P, size):
    """numpy initUndistortRectifyMap: for each rectified pixel, apply
    P^-1, rotate by R^-1, distort, project through K."""
    w, h = size
    fx_p, fy_p, cx_p, cy_p = P[0, 0], P[1, 1], P[0, 2], P[1, 2]
    uu, vv = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    x = (uu - cx_p) / fx_p
    y = (vv - cy_p) / fy_p
    pts = np.stack([x, y, np.ones_like(x)], axis=-1) @ np.linalg.inv(R).T
    x = pts[..., 0] / pts[..., 2]
    y = pts[..., 1] / pts[..., 2]
    k1, k2, p1, p2, k3 = (list(dist) + [0.0] * 5)[:5]
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2**2 + k3 * r2**3
    x_d = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    y_d = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    map_x = K[0, 0] * x_d + K[0, 2]
    map_y = K[1, 1] * y_d + K[1, 2]
    return map_x.astype(np.float32), map_y.astype(np.float32)


# ----------------------------------------------------------------------
# OpenCV's stereo rectification in numpy (stereoRectify and the helpers
# it calls, as OpenCV 5.0 computes them), float64 where OpenCV computes in
# double and float32 where it stores points as CV_32FC2
# ----------------------------------------------------------------------
def rodrigues_to_matrix(rvec) -> np.ndarray:
    """cvRodrigues2, rotation vector -> matrix, in OpenCV's form (c I +
    (1 - c) k k^T + s [k]x), so the maps equal cv2's; io/zed_calib.py
    keeps the JAX package's own form for its parse."""
    r = np.asarray(rvec, np.float64).reshape(3)
    theta = float(np.sqrt(r @ r))
    if theta < np.finfo(np.float64).eps:
        return np.eye(3)
    c, s = np.cos(theta), np.sin(theta)
    k = r / theta
    kx = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    return c * np.eye(3) + (1 - c) * np.outer(k, k) + s * kx


def rodrigues_to_vector(mat) -> np.ndarray:
    """cvRodrigues2, rotation matrix -> vector (through the nearest
    orthonormal matrix, as OpenCV takes it by SVD)."""
    u, _, vt = np.linalg.svd(np.asarray(mat, np.float64))
    R = u @ vt
    r = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s = np.sqrt((r @ r) * 0.25)
    c = np.clip((R[0, 0] + R[1, 1] + R[2, 2] - 1) * 0.5, -1.0, 1.0)
    theta = np.arccos(c)
    if s < 1e-5:
        if c > 0:
            return np.zeros(3)
        rx = np.sqrt(max((R[0, 0] + 1) * 0.5, 0.0))
        ry = np.sqrt(max((R[1, 1] + 1) * 0.5, 0.0)) * (-1.0 if R[0, 1] < 0 else 1.0)
        rz = np.sqrt(max((R[2, 2] + 1) * 0.5, 0.0)) * (-1.0 if R[0, 2] < 0 else 1.0)
        if abs(rx) < abs(ry) and abs(rx) < abs(rz) and (R[1, 2] > 0) != (ry * rz > 0):
            rz = -rz
        r = np.array([rx, ry, rz])
        return r * (theta / np.sqrt(r @ r))
    return r * (theta / (2 * s))


def undistort_points(pts, K, dist, R=None, P=None) -> np.ndarray:
    """cv::undistortPoints with its default criteria (5 fixed iterations):
    float32 [N, 2] pixels -> float32 [N, 2], normalized coordinates or,
    with P, pixels of P after the rotation R."""
    dtype = np.float64 if np.asarray(pts).dtype == np.float64 else np.float32
    pts = np.asarray(pts, dtype).astype(np.float64)
    k = np.zeros(14)
    d = np.asarray(dist, np.float64).reshape(-1)
    k[:d.size] = d
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    ifx, ify = 1.0 / fx, 1.0 / fy
    RR = np.eye(3) if R is None else np.asarray(R, np.float64)
    if P is not None:
        RR = np.asarray(P, np.float64)[:3, :3] @ RR
    out = np.empty(pts.shape, dtype)
    for i, (u, v) in enumerate(pts):
        x = x0 = (u - cx) * ifx
        y = y0 = (v - cy) * ify
        for _ in range(5):
            r2 = x * x + y * y
            icdist = (1 + ((k[7] * r2 + k[6]) * r2 + k[5]) * r2) / (
                1 + ((k[4] * r2 + k[1]) * r2 + k[0]) * r2)
            if icdist < 0:
                x, y = (u - cx) * ifx, (v - cy) * ify
                break
            dx = 2 * k[2] * x * y + k[3] * (r2 + 2 * x * x) + k[8] * r2 + k[9] * r2 * r2
            dy = k[2] * (r2 + 2 * y * y) + 2 * k[3] * x * y + k[10] * r2 + k[11] * r2 * r2
            x = (x0 - dx) * icdist
            y = (y0 - dy) * icdist
        xx = RR[0, 0] * x + RR[0, 1] * y + RR[0, 2]
        yy = RR[1, 0] * x + RR[1, 1] * y + RR[1, 2]
        ww = 1.0 / (RR[2, 0] * x + RR[2, 1] * y + RR[2, 2])
        out[i] = (xx * ww, yy * ww)
    return out


def _inner_rectangle(K, dist, R, P, size):
    """getUndistortRectangles' inner rectangle (x, y, width, height): the
    largest box inside a 9x9 grid over the image's pixel centres, corner
    to corner, undistorted into the rectified image of P (alpha=0 needs
    no outer one)."""
    n = 9
    w, h = size
    grid = [(x * (w - 1) / (n - 1), y * (h - 1) / (n - 1)) for y in range(n) for x in range(n)]
    pts = undistort_points(np.array(grid), K, dist, R, P).reshape(n, n, 2)
    ix0, ix1 = pts[:, 0, 0].max(), pts[:, n - 1, 0].min()
    iy0, iy1 = pts[0, :, 1].max(), pts[n - 1, :, 1].min()
    return ix0, iy0, ix1 - ix0, iy1 - iy0


def stereo_rectify(K_l, D_l, K_r, D_r, size, R_rl, t_rl):
    """cv::stereoRectify(..., flags=CALIB_ZERO_DISPARITY, alpha=0) with
    the new image size equal to `size` (width, height): (R_l, R_r, P_l,
    P_r), float64."""
    nx, ny = float(size[0]), float(size[1])
    K_l, K_r = np.asarray(K_l, np.float64), np.asarray(K_r, np.float64)
    t_rl = np.asarray(t_rl, np.float64).reshape(3)
    # rotate both cameras halfway to a common orientation
    r_r = rodrigues_to_matrix(rodrigues_to_vector(R_rl) * -0.5)
    t = r_r @ t_rl
    idx = 0 if abs(t[0]) > abs(t[1]) else 1  # horizontal or vertical pair
    c, nt = t[idx], np.sqrt(t @ t)
    if not nt > 0.0:
        raise ValueError("stereo baseline must be non-zero")
    uu = np.zeros(3)
    uu[idx] = 1.0 if c > 0 else -1.0
    # the global rotation that takes t onto the axis, keeping its sign
    ww = np.cross(t, uu)
    nw = np.sqrt(ww @ ww)
    if nw > 0.0:
        ww = ww * (np.arccos(abs(c) / nt) / nw)
    wR = rodrigues_to_matrix(ww)
    R_l = wR @ r_r.T
    R_r = wR @ r_r
    t = R_r @ t_rl
    # the focal length along the axis across the baseline, averaged
    fc_new = (K_l[idx ^ 1, idx ^ 1] + K_r[idx ^ 1, idx ^ 1]) * 0.5
    cc_new = []
    corners = np.array([[(i % 2) * (nx - 1), (i // 2) * (ny - 1)] for i in range(4)],
                       np.float32)
    for K, D, R in ((K_l, D_l, R_l), (K_r, D_r, R_r)):
        # the undistorted image corners projected by R at fc_new about 0
        n = undistort_points(corners, K, D).astype(np.float64)
        m = np.concatenate([n, np.ones((4, 1))], 1) @ R.T
        proj = (fc_new * m[:, :2] / m[:, 2:3]).astype(np.float32).astype(np.float64)
        avg = proj.sum(0) / 4
        cc_new.append([(nx - 1) / 2 - avg[0], (ny - 1) / 2 - avg[1]])
    # CALIB_ZERO_DISPARITY: one principal point for both views
    cc = [(cc_new[0][0] + cc_new[1][0]) * 0.5, (cc_new[0][1] + cc_new[1][1]) * 0.5]
    P_l = np.zeros((3, 4))
    P_l[0, 0] = P_l[1, 1] = fc_new
    P_l[0, 2], P_l[1, 2], P_l[2, 2] = cc[0], cc[1], 1.0
    P_r = P_l.copy()
    P_r[idx, 3] = t[idx] * fc_new
    # alpha=0: scale so that only valid pixels remain in either view
    inner_l = _inner_rectangle(K_l, D_l, R_l, P_l, size)
    inner_r = _inner_rectangle(K_r, D_r, R_r, P_r, size)
    w, h = int(size[0]), int(size[1])
    cx, cy = w * cc[0] / w, h * cc[1] / h
    s = -np.inf
    for ix, iy, iw, ih in (inner_l, inner_r):
        s = max(s, cx / (cc[0] - ix), cy / (cc[1] - iy),
                (w - 1 - cx) / (ix + iw - cc[0]), (h - 1 - cy) / (iy + ih - cc[1]))
    fc_new *= s
    for P in (P_l, P_r):
        P[0, 0] = P[1, 1] = fc_new
        P[0, 2], P[1, 2] = cx, cy
    P_r[idx, 3] *= s
    return R_l, R_r, P_l, P_r


def build_rectify_maps(
    K_l: np.ndarray,
    D_l: np.ndarray,
    K_r: np.ndarray,
    D_r: np.ndarray,
    R_rl: np.ndarray,
    t_rl: np.ndarray,
    size: Tuple[int, int],
) -> RectifyMaps:
    """StereoRectifier construction (stereo_rectifier.cc:10-48).

    size = (width, height); R_rl/t_rl: right_R_left / right_t_left.  The
    rectification is OpenCV's (stereo_rectify above) for either sign of
    the baseline and for vertical pairs."""
    w, h = size
    R_l, R_r, P_l, P_r = stereo_rectify(K_l, D_l, K_r, D_r, (w, h), R_rl, t_rl)
    lx, ly = _undistort_rectify_map(K_l, D_l, R_l, P_l, (w, h))
    rx, ry = _undistort_rectify_map(K_r, D_r, R_r, P_r, (w, h))
    return RectifyMaps(
        left_x=lx,
        left_y=ly,
        right_x=rx,
        right_y=ry,
        rectified_intrinsics=(
            float(P_r[0, 0]),
            float(P_r[1, 1]),
            float(P_r[0, 2]),
            float(P_r[1, 2]),
        ),
    )


class StereoRectifier:
    """API parity with utils/stereo_rectifier.h: rectify(left, right) via
    the precomputed maps, rectified intrinsics exposure.  The maps go to
    `device` once and the remap runs there; it is the CUDA device unless
    the caller asks for another."""

    def __init__(self, maps: RectifyMaps, device="cuda"):
        self.maps = maps
        self.device = resolve_device(device)
        self.maps_device = tuple(
            torch.from_numpy(np.ascontiguousarray(m, np.float32)).to(self.device)
            for m in maps[:4])

    @classmethod
    def from_yaml(cls, config: dict, device="cuda") -> "StereoRectifier":
        """YAML layout of configs/zed_native_stereo.yaml
        (stereo_rectifier.cc:50-68): Calibration.left/right fx..distortion
        + rotation (Rodrigues vector) + translation."""

        def mono(side):
            return (
                np.array(
                    [
                        [config[f"Calibration.{side}.fx"], 0, config[f"Calibration.{side}.cx"]],
                        [0, config[f"Calibration.{side}.fy"], config[f"Calibration.{side}.cy"]],
                        [0, 0, 1],
                    ],
                    np.float64,
                ),
                np.asarray(config[f"Calibration.{side}.distortion"], np.float64),
            )

        K_l, D_l = mono("left")
        K_r, D_r = mono("right")
        R_rl = rodrigues_to_matrix(np.asarray(config["Calibration.rotation"], np.float64))
        t_rl = np.asarray(config["Calibration.translation"], np.float64)
        size = (int(config["Camera.cols"]), int(config["Camera.rows"]))
        return cls(build_rectify_maps(K_l, D_l, K_r, D_r, R_rl, t_rl, size), device=device)

    def rectify_device(self, img_l: torch.Tensor, img_r: torch.Tensor):
        """Rectify a pair of float32 tensors on the rectifier's device."""
        lx, ly, rx, ry = self.maps_device
        return bilinear_remap(img_l, lx, ly), bilinear_remap(img_r, rx, ry)

    def rectify(self, img_l: np.ndarray, img_r: np.ndarray):
        """Host images in, rectified float32 host images out."""
        up = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)
              for a in (img_l, img_r)]
        left, right = self.rectify_device(*up)
        return left.cpu().numpy(), right.cpu().numpy()

    def rectified_intrinsics(self) -> Tuple[float, float, float, float]:
        return self.maps.rectified_intrinsics
