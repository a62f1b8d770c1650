"""ctypes bindings for the port's native host runtime (runtime.cpp;
counterpart of disinfect_slam_tpu/native/runtime.py).

runtime.cpp is compiled with the system C++ compiler ($CXX, else c++ or
g++) at first use into disinfect_slam_tpu_torch/_build/, under a name
keyed by the source and the flags; the source tree is never written.
`available()` says whether the library could be built and loaded; the
classes raise when it cannot, and `monotonic_ms` then reads Python's
steady clock.  The pose buffer has the semantics of
systems/pose_manager.py:PoseManager, the frame queue those of a bounded
drop-oldest queue.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Optional

import numpy as np

_SRC = pathlib.Path(__file__).resolve().with_name("runtime.cpp")
BUILD_DIR = _SRC.parents[1] / "_build"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")
_lib: Optional[ctypes.CDLL] = None
_tried = False
_build_lock = threading.Lock()


def compiler() -> Optional[str]:
    """The C++ compiler the runtime builds with, or None."""
    for name in (os.environ.get("CXX"), "c++", "g++"):
        path = shutil.which(name) if name else None
        if path:
            return path
    return None


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + _SRC.read_bytes())
    return BUILD_DIR / f"libdstpu_runtime_{digest.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile runtime.cpp unless its library exists; returns its path.
    Raises when there is no compiler or the compile fails."""
    path = library_path()
    if path.exists():
        return path
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler found (set CXX)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a temporary name, renamed when done: a concurrent or interrupted
    # build never leaves a partial library under the final name
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(_SRC), "-pthread"],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"runtime.cpp: {cxx} exited with code {proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    sigs = {
        "dstpu_monotonic_ms": (c.c_int64, []),
        "dstpu_system_ms": (c.c_int64, []),
        "dstpu_pose_buffer_new": (c.c_void_p, [c.c_int]),
        "dstpu_pose_buffer_free": (None, [c.c_void_p]),
        "dstpu_pose_buffer_register": (None, [c.c_void_p, c.c_int64, c.POINTER(c.c_double)]),
        "dstpu_pose_buffer_size": (c.c_int64, [c.c_void_p]),
        "dstpu_pose_buffer_query": (None, [c.c_void_p, c.c_int64, c.POINTER(c.c_double)]),
        "dstpu_frame_queue_new": (c.c_void_p, [c.c_int64]),
        "dstpu_frame_queue_free": (None, [c.c_void_p]),
        "dstpu_frame_queue_push": (c.c_int, [c.c_void_p, c.c_int64, c.POINTER(c.c_uint8),
                                             c.c_int64]),
        "dstpu_frame_queue_depth": (c.c_int64, [c.c_void_p]),
        "dstpu_frame_queue_dropped": (c.c_uint64, [c.c_void_p]),
        "dstpu_frame_queue_close": (None, [c.c_void_p]),
        "dstpu_frame_queue_pop": (c.c_int64, [c.c_void_p, c.c_int64, c.POINTER(c.c_int64),
                                              c.POINTER(c.c_uint8), c.c_int64]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The bound library, built on first use; None when it cannot be."""
    global _lib, _tried
    with _build_lock:
        if not _tried:
            _tried = True
            try:
                _lib = _bind(ctypes.CDLL(str(build())))
            except (RuntimeError, OSError, subprocess.SubprocessError):
                _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable (no C++ compiler, or runtime.cpp "
                           "did not build)")
    return lib


class NativePoseBuffer:
    """C++ pose buffer; the semantics of systems.pose_manager.PoseManager."""

    def __init__(self, interpolate: bool = True):
        self._lib = _require()
        self._h = self._lib.dstpu_pose_buffer_new(1 if interpolate else 0)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.dstpu_pose_buffer_free(self._h)
            self._h = None

    def register_valid_pose(self, timestamp_ms: int, pose: np.ndarray) -> None:
        m = np.ascontiguousarray(pose, np.float64)
        self._lib.dstpu_pose_buffer_register(
            self._h, int(timestamp_ms), m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))

    def __len__(self) -> int:
        return int(self._lib.dstpu_pose_buffer_size(self._h))

    def query_pose(self, timestamp_ms: int) -> np.ndarray:
        out = np.empty((4, 4), np.float64)
        self._lib.dstpu_pose_buffer_query(
            self._h, int(timestamp_ms), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return out.astype(np.float32)


class NativeFrameQueue:
    """Bounded MPSC byte-blob queue with drop-oldest backpressure."""

    def __init__(self, capacity: int = 16):
        self._lib = _require()
        self._h = self._lib.dstpu_frame_queue_new(capacity)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.dstpu_frame_queue_free(self._h)
            self._h = None

    def push(self, timestamp_ms: int, blob: bytes) -> bool:
        """Enqueue a copy of blob; True when the oldest entry was dropped."""
        buf = (ctypes.c_uint8 * len(blob)).from_buffer_copy(blob)
        return bool(self._lib.dstpu_frame_queue_push(self._h, int(timestamp_ms), buf,
                                                     len(blob)))

    def pop(self, timeout_ms: int = 100, max_size: int = 1 << 24):
        """(timestamp_ms, bytes) of the oldest entry, or None on a timeout
        or when closed and empty."""
        out = (ctypes.c_uint8 * max_size)()
        ts = ctypes.c_int64()
        n = self._lib.dstpu_frame_queue_pop(self._h, int(timeout_ms), ctypes.byref(ts), out,
                                            max_size)
        if n <= 0:
            return None
        return int(ts.value), bytes(out[:n])

    def depth(self) -> int:
        return int(self._lib.dstpu_frame_queue_depth(self._h))

    def dropped(self) -> int:
        return int(self._lib.dstpu_frame_queue_dropped(self._h))

    def close(self) -> None:
        self._lib.dstpu_frame_queue_close(self._h)


def monotonic_ms() -> int:
    """Steady-clock milliseconds, from the native library when it loads."""
    lib = _load()
    if lib is None:
        return time.monotonic_ns() // 1_000_000
    return int(lib.dstpu_monotonic_ms())
