"""Logged RGB-D + ht/lt replay (counterpart of LoggedReplay in
disinfect_slam_tpu/io/dataset.py; reference offline.cc:45-83).

`<logdir>/trajectory.txt` rows are `id r00 r01 r02 tx r10 ... tz` (3x4
row-major cam_T_world); frames are `<id>_rgb.png`, `<id>_depth.png`
(16-bit, divided by depthmap_factor) and optional `<id>_ht.png` /
`<id>_no_ht.png` (16-bit, divided by 65535; ht=0, lt=1 when absent).
PNGs are decoded by this package's own reader (io/png_io.py), so no
image library is needed.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .png_io import read_image


@dataclasses.dataclass
class ReplayFrame:
    frame_id: int
    cam_T_world: np.ndarray  # 4x4 f32
    rgb: np.ndarray  # f32 [H, W, 3] in [0, 255]
    depth: np.ndarray  # f32 [H, W] metres
    ht: np.ndarray  # f32 [H, W]
    lt: np.ndarray  # f32 [H, W]


class LoggedReplay:
    """Replays a logged directory (offline.cc:45-83)."""

    def __init__(
        self,
        logdir: str,
        depth_factor: float,
        extrinsics: Optional[np.ndarray] = None,
    ):
        self.logdir = logdir
        self.depth_factor = depth_factor
        self.extrinsics = (
            np.eye(4, dtype=np.float32) if extrinsics is None else extrinsics
        )
        self.entries: List[Tuple[int, np.ndarray]] = []
        with open(os.path.join(logdir, "trajectory.txt")) as f:
            for line in f:
                parts = line.split()
                if len(parts) != 13:
                    continue
                pose = np.eye(4, dtype=np.float32)
                pose[:3, :4] = np.asarray([float(x) for x in parts[1:]],
                                          np.float32).reshape(3, 4)
                # extrinsics * pose (offline.cc:58)
                self.entries.append((int(parts[0]), self.extrinsics @ pose))

    def __len__(self) -> int:
        return len(self.entries)

    def __iter__(self) -> Iterator[ReplayFrame]:
        for fid, pose in self.entries:
            yield self.load_frame(fid, pose)

    def load_frame(self, fid: int, pose: np.ndarray) -> ReplayFrame:
        base = os.path.join(self.logdir, str(fid))
        rgb = read_image(base + "_rgb.png").astype(np.float32)
        depth = read_image(base + "_depth.png", unchanged=True).astype(
            np.float32) / self.depth_factor
        ht_path = base + "_ht.png"
        if os.path.exists(ht_path):
            ht = read_image(ht_path, unchanged=True).astype(np.float32) / 65535.0
            lt = read_image(base + "_no_ht.png", unchanged=True).astype(
                np.float32) / 65535.0
        else:
            ht = np.zeros_like(depth)
            lt = np.ones_like(depth)
        return ReplayFrame(fid, pose, rgb, depth, ht, lt)
