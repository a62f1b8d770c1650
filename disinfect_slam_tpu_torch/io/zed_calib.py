"""Stereolabs ZED factory calibration (.conf) parsing (counterpart of
disinfect_slam_tpu/io/zed_calib.py, restated so that the port loads
nothing of the JAX package; tests/test_torch_device.py pins the two).

Behavior parity with utils/zed/calib.py:parse_calibration_factory
(reference :43-98): the factory file is an INI with per-resolution
[LEFT_CAM_*]/[RIGHT_CAM_*] pinhole+distortion sections and a [STEREO]
section holding the baseline (mm) and a per-resolution Rodrigues
rotation vector.  Quirks preserved from the reference:

- every missing key silently reads as 0;
- the baseline sign is flipped and converted mm -> m;
- the rotation vector components come from keys RX_<res>, CV_<res>,
  RZ_<res> (the pitch really is stored under "CV_" in factory files);
- distortion is packed (k1, k2, p1, p2, k3) -- OpenCV order.
"""

from __future__ import annotations

import configparser
from typing import NamedTuple, Tuple

import numpy as np

RESOLUTIONS = {
    "2K": (2208, 1242),
    "FHD": (1920, 1080),
    "HD": (1280, 720),
    "VGA": (672, 376),
}


class FactoryCalib(NamedTuple):
    K_l: np.ndarray  # [3, 3]
    K_r: np.ndarray  # [3, 3]
    D_l: np.ndarray  # [5] (k1, k2, p1, p2, k3)
    D_r: np.ndarray  # [5]
    R: np.ndarray  # [3, 3] right_R_left
    T: np.ndarray  # [3] right_t_left, metres
    size: Tuple[int, int]  # (width, height)


def _rodrigues(rvec: np.ndarray) -> np.ndarray:
    theta = float(np.linalg.norm(rvec))
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    kx = np.array(
        [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]], np.float64
    )
    return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * (kx @ kx)


def parse_factory_conf(path: str, resolution: str) -> FactoryCalib:
    """Parse a ZED factory .conf for one resolution key (2K/FHD/HD/VGA)."""
    if resolution not in RESOLUTIONS:
        raise ValueError(
            f"unknown resolution {resolution!r}; choose from {sorted(RESOLUTIONS)}"
        )
    ini = configparser.ConfigParser()
    if not ini.read(path):
        raise FileNotFoundError(path)

    def num(section: str, key: str) -> float:
        return float(ini[section].get(key, 0) or 0) if section in ini else 0.0

    def pinhole(section: str) -> Tuple[np.ndarray, np.ndarray]:
        K = np.array(
            [
                [num(section, "fx"), 0.0, num(section, "cx")],
                [0.0, num(section, "fy"), num(section, "cy")],
                [0.0, 0.0, 1.0],
            ]
        )
        D = np.array([num(section, k) for k in ("k1", "k2", "p1", "p2", "k3")])
        return K, D

    K_l, D_l = pinhole(f"LEFT_CAM_{resolution}")
    K_r, D_r = pinhole(f"RIGHT_CAM_{resolution}")
    rvec = np.array(
        [
            num("STEREO", f"RX_{resolution}"),
            num("STEREO", f"CV_{resolution}"),
            num("STEREO", f"RZ_{resolution}"),
        ]
    )
    t = np.array(
        [-num("STEREO", "Baseline"), num("STEREO", "TY"), num("STEREO", "TZ")]
    )
    return FactoryCalib(
        K_l=K_l,
        K_r=K_r,
        D_l=D_l,
        D_r=D_r,
        R=_rodrigues(rvec),
        T=t / 1e3,
        size=RESOLUTIONS[resolution],
    )


def rectifier_from_factory_conf(path: str, resolution: str, device="cuda"):
    """Factory .conf -> ready StereoRectifier (doRectify, zed.cc:139-187),
    its maps on `device` (resolved before the file is read)."""
    from ..ops.image_ops import StereoRectifier, build_rectify_maps
    from ..utils.device import resolve_device

    device = resolve_device(device)
    c = parse_factory_conf(path, resolution)
    maps = build_rectify_maps(c.K_l, c.D_l, c.K_r, c.D_r, c.R, c.T, c.size)
    return StereoRectifier(maps, device=device)
