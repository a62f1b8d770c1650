"""Asynchronous data logger (utils/data_logger.hpp equivalent;
counterpart of disinfect_slam_tpu/io/logger.py, restated so that the port
loads nothing of the JAX package).  Images go through the port's own PNG
writer (io/png_io.py); a FrameLogger directory replays through either
package's LoggedReplay.

A background writer thread drains a bounded queue; when the producer
outruns the writer the oldest pending item is dropped with a warning
(data_logger.hpp:37-44 semantics, except the reference's 2-slot double
buffer generalizes to an N-deep queue).  Subclass and implement
`save_data(item)` like the reference's SaveData override.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from typing import Any

import numpy as np

from .png_io import write_image

logger = logging.getLogger("disinfect_slam_tpu_torch.logger")


class DataLogger:
    def __init__(self, depth: int = 2):
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def log_data(self, item: Any) -> None:
        """Enqueue; drops the oldest pending item when the writer lags
        (drop-with-warning, data_logger.hpp:39-41)."""
        try:
            self._q.put_nowait(item)
        except queue.Full:
            logger.warning("[DataLogger] writer cannot keep up, dropping data")
            try:
                self._q.get_nowait()
                self._q.task_done()
            except queue.Empty:
                pass
            self._q.put_nowait(item)

    def save_data(self, item: Any) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def flush(self) -> None:
        self._q.join()

    def close(self) -> None:
        self._q.join()
        self._stop.set()
        self._thread.join(timeout=10)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                item = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                self.save_data(item)
            except Exception:  # pragma: no cover
                logger.exception("[DataLogger] save_data failed")
            finally:
                self._q.task_done()


class StereoFrameLogger(DataLogger):
    """Logs stereo pairs as {id}_left.png / {id}_right.png plus an
    optional matched trajectory — the run_zed_native capture layout
    (run_zed_native.cc:63-91) for stereo-driven replays."""

    def __init__(self, logdir: str, queue_depth: int = 32):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self._traj = open(f"{logdir}/trajectory.txt", "w")
        super().__init__(depth=queue_depth)

    def save_data(self, item) -> None:
        fid, left, right, pose = item
        write_image(f"{self.logdir}/{fid}_left.png", np.asarray(left, np.uint8))
        write_image(f"{self.logdir}/{fid}_right.png", np.asarray(right, np.uint8))
        if pose is not None:
            row = " ".join(f"{v:.9f}" for v in np.asarray(pose)[:3, :4].reshape(-1))
            self._traj.write(f"{fid} {row}\n")
            self._traj.flush()

    def close(self) -> None:
        super().close()
        self._traj.close()


class FrameLogger(DataLogger):
    """Dataset producer: logs synced frames as {id}_rgb/_depth PNGs plus a
    matched trajectory.txt — the pseudo_online_capture replacement
    (pseudo_online_capture.cc:52-65) producing offline-replayable logs."""

    def __init__(self, logdir: str, depth_factor: float = 1000.0, queue_depth: int = 32):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self.depth_factor = depth_factor
        self._traj = open(f"{logdir}/trajectory.txt", "w")
        super().__init__(depth=queue_depth)

    def save_data(self, item) -> None:
        fid, rgb, depth_m, pose = item
        write_image(f"{self.logdir}/{fid}_rgb.png", np.asarray(rgb, np.uint8))
        d16 = np.clip(np.asarray(depth_m) * self.depth_factor, 0, 65535).astype(
            np.uint16
        )
        write_image(f"{self.logdir}/{fid}_depth.png", d16)
        row = " ".join(f"{v:.9f}" for v in np.asarray(pose)[:3, :4].reshape(-1))
        self._traj.write(f"{fid} {row}\n")
        self._traj.flush()

    def close(self) -> None:
        super().close()
        self._traj.close()
