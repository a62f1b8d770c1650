"""Dataset replays (counterparts of LoggedReplay, TUMReplay and
PrefetchReplay in disinfect_slam_tpu/io/dataset.py).

Two formats:

1. The reference's logged replay (offline.cc:45-83):
   `<logdir>/trajectory.txt` rows are `id r00 r01 r02 tx r10 ... tz` (3x4
   row-major cam_T_world); frames are `<id>_rgb.png`, `<id>_depth.png`
   (16-bit, divided by depthmap_factor) and optional `<id>_ht.png` /
   `<id>_no_ht.png` (16-bit, divided by 65535; ht=0, lt=1 when absent).
   A stereo logdir (io/logger.StereoFrameLogger) holds `<id>_left.png` /
   `<id>_right.png` pairs instead, and trajectory rows only where a pose
   was known (LoggedStereoReplay).
2. TUM RGB-D (rgb.txt / depth.txt / groundtruth.txt with timestamps;
   configs/TUM_RGBD_rgbd_1.yaml: 640x480, depthmap_factor 5000).

PrefetchReplay decodes either ahead of the device.  PNGs are decoded by
this package's own reader (io/png_io.py), so no image library is needed.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
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
                pose = _pose_from_row([float(x) for x in parts[1:]])
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


@dataclasses.dataclass
class StereoReplayFrame:
    frame_id: int
    cam_T_world: Optional[np.ndarray]  # 4x4 f32, None if no trajectory row
    left: np.ndarray  # f32 [H, W, 3] in [0, 255]
    right: np.ndarray


def _pose_from_row(vals) -> np.ndarray:
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :4] = np.asarray(vals, np.float32).reshape(3, 4)
    return pose


class LoggedStereoReplay:
    """Replays a StereoFrameLogger logdir: {id}_left/_right.png pairs,
    with poses when trajectory.txt has rows (stereo-only captures may
    omit them: the pose then comes from SLAM, as on the reference's live
    path zed_native.cc:24-33 -> slam_module.cc:100-120)."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        poses = {}
        traj = os.path.join(logdir, "trajectory.txt")
        if os.path.exists(traj):
            with open(traj) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) == 13:
                        poses[int(parts[0])] = _pose_from_row([float(x) for x in parts[1:]])
        ids = sorted(int(f.split("_")[0]) for f in os.listdir(logdir) if f.endswith("_left.png"))
        self.entries: List[Tuple[int, Optional[np.ndarray]]] = [
            (fid, poses.get(fid)) for fid in ids]

    def __len__(self) -> int:
        return len(self.entries)

    def __iter__(self) -> Iterator[StereoReplayFrame]:
        for fid, pose in self.entries:
            base = os.path.join(self.logdir, str(fid))
            left = read_image(base + "_left.png").astype(np.float32)
            right = read_image(base + "_right.png").astype(np.float32)
            yield StereoReplayFrame(fid, pose, left, right)


def _quat_to_mat(qx, qy, qz, qw) -> np.ndarray:
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    return np.array(
        [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
            [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
            [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
        ]
    )


class TUMReplay:
    """TUM RGB-D sequence replay with nearest-timestamp association.

    Ground-truth rows are `t tx ty tz qx qy qz qw` giving world_T_cam;
    depth PNGs are 16-bit with factor 5000 (configs/TUM_RGBD_rgbd_1.yaml).
    Frames with no depth or ground truth within max_dt seconds drop."""

    def __init__(self, seqdir: str, depth_factor: float = 5000.0, max_dt: float = 0.02):
        self.seqdir = seqdir
        self.depth_factor = depth_factor

        def read_list(name):
            out = []
            with open(os.path.join(seqdir, name)) as f:
                for line in f:
                    if line.startswith("#"):
                        continue
                    parts = line.split()
                    if len(parts) >= 2:
                        out.append((float(parts[0]), parts[1:]))
            return out

        rgb = read_list("rgb.txt")
        depth = read_list("depth.txt")
        gt = read_list("groundtruth.txt")
        gt_t = np.array([t for t, _ in gt])
        d_t = np.array([t for t, _ in depth])

        self.frames = []
        for i, (t, rgb_p) in enumerate(rgb):
            j = int(np.argmin(np.abs(d_t - t)))
            k = int(np.argmin(np.abs(gt_t - t)))
            if abs(d_t[j] - t) > max_dt or abs(gt_t[k] - t) > max_dt:
                continue
            vals = [float(x) for x in gt[k][1]]
            world_T_cam = np.eye(4, dtype=np.float32)
            world_T_cam[:3, :3] = _quat_to_mat(*vals[3:7])
            world_T_cam[:3, 3] = vals[:3]
            cam_T_world = np.linalg.inv(world_T_cam).astype(np.float32)
            self.frames.append((i, rgb_p[0], depth[j][1][0], cam_T_world))

    def __len__(self) -> int:
        return len(self.frames)

    def __iter__(self) -> Iterator[ReplayFrame]:
        for fid, rgb_p, depth_p, pose in self.frames:
            rgb = read_image(os.path.join(self.seqdir, rgb_p)).astype(np.float32)
            depth_raw = read_image(os.path.join(self.seqdir, depth_p), unchanged=True)
            depth = depth_raw.astype(np.float32) / self.depth_factor
            yield ReplayFrame(fid, pose, rgb, depth, np.zeros_like(depth),
                              np.ones_like(depth))


class PrefetchReplay:
    """Decode-ahead wrapper for any replay iterable.

    The reference reads every frame inside its render loop
    (offline.cc:157-160), serialising the PNG decode with fusion.  One
    daemon worker decodes up to `depth` frames ahead into a bounded queue
    (blocking backpressure: the replay loses no frame), so the decode
    overlaps the device's work and the frame order stays exact.  A
    worker's exception is raised in the consumer at the frame where it
    occurred; leaving the loop early releases the worker."""

    def __init__(self, replay, depth: int = 4):
        self.replay = replay
        self.depth = int(depth)
        assert self.depth >= 1

    def __len__(self) -> int:
        return len(self.replay)

    def __iter__(self) -> Iterator[ReplayFrame]:
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        sentinel = object()
        stop = threading.Event()

        def _put(item) -> bool:
            # a bounded put that notices the consumer leaving (an early
            # break from the generator) instead of blocking forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for frame in self.replay:
                    if not _put(frame):
                        return
            except BaseException as e:  # hand decode errors on, in order
                _put(e)
                return
            _put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # early exit or error: release the worker and drop the frames
            # it already decoded
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5.0)
