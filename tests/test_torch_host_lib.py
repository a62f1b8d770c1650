"""PyTorch port, the host library: the stream synchronizers against the
JAX package's on the same event streams; the loggers (a FrameLogger
directory read back through both packages' LoggedReplay, the stereo
layout, the drop-oldest queue); the camera replay sources against the
JAX ones; the system clock; and the native runtime (built from the
port's own runtime.cpp) against the port's PoseManager.  Everything here
is exact: the same pairs, the same pixels, poses within float32
rounding of the numpy buffer's."""

import threading
import time

import numpy as np
import pytest

from disinfect_slam_tpu.io import cameras as jcam
from disinfect_slam_tpu.io import logger as jlog
from disinfect_slam_tpu.io import sync as jsync
from disinfect_slam_tpu.io.dataset import LoggedReplay as JReplay
from disinfect_slam_tpu.io.dataset import LoggedStereoReplay as JStereoReplay
from disinfect_slam_tpu.utils.timing import get_system_timestamp_ms as j_system_ms
from disinfect_slam_tpu_torch.io import cameras, logger, sync
from disinfect_slam_tpu_torch.io.dataset import LoggedReplay
from disinfect_slam_tpu_torch.io.png_io import read_image
from disinfect_slam_tpu_torch.native import runtime
from disinfect_slam_tpu_torch.systems.pose_manager import PoseManager
from disinfect_slam_tpu_torch.utils.timing import get_system_timestamp_ms

from .scenes import checker_rgb, look_at, render_wall

K = (52.7, 53.3, 31.71, 23.43)
W, H = 64, 48


# ----------------------------------------------------------------------
# synchronizers
# ----------------------------------------------------------------------
def _events(seed: int, n_streams: int, n: int = 300):
    """Interleaved (stream, timestamp, item) with jitter, gaps, bursts
    and out-of-order arrivals."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(n_streams):
        t = rng.uniform(0, 30)
        for i in range(n):
            t += rng.choice([33.3, 33.3, 33.3, 5.0, 120.0, 400.0]) + rng.normal(0, 6)
            out.append((float(t + rng.normal(0, 15)), s, f"s{s}-{i}"))
    out.sort()
    # a few swapped neighbours: late deliveries
    for i in rng.integers(0, len(out) - 1, 40):
        out[i], out[i + 1] = out[i + 1], out[i]
    return [(s, t, item) for t, s, item in out]


def _run(cls, events, *args, **kw):
    got = []
    obj = cls(*args, callback=lambda *a: got.append(a), **kw)
    for s, t, item in events:
        obj.push(s, t, item)
    return got, obj.matched, obj.dropped


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["approx2", "approx3", "stereo", "rgbd"])
def test_synchronizers_pair_as_jax(kind, seed):
    n, kw = {"approx2": (2, dict(n_streams=2, slop_ms=10.0, horizon_ms=500.0, queue_size=8)),
             "approx3": (3, dict(n_streams=3, slop_ms=25.0)),
             "stereo": (2, {}), "rgbd": (2, dict(horizon_ms=300.0))}[kind]
    events = _events(seed, n)
    name = {"approx2": "ApproximateTimeSynchronizer", "approx3": "ApproximateTimeSynchronizer",
            "stereo": "StereoPairer", "rgbd": "RGBDPairer"}[kind]
    ours = _run(getattr(sync, name), events, **kw)
    ref = _run(getattr(jsync, name), events, **kw)
    assert ours == ref
    assert ours[1] > 10 and ours[2] > 0


# ----------------------------------------------------------------------
# loggers and replays
# ----------------------------------------------------------------------
def _frames(n: int = 4):
    rng = np.random.default_rng(3)
    out = []
    for i in range(n):
        pose = look_at((0.021 * i + 0.013, -0.011 * i, 0.009), (0.11, 0.07, 1.8131))
        depth = render_wall(W, H, K, pose, wall_z=1.8131)
        depth[rng.random(depth.shape) < 0.05] = 0.0
        rgb = checker_rgb(W, H).astype(np.uint8)
        rgb[..., 1] = rng.integers(0, 256, (H, W))
        out.append((i * 3 + 1, rgb, depth, pose.astype(np.float32)))
    return out


def test_frame_logger_directory_reads_back_through_both_replays(tmp_path):
    frames = _frames()
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    for mod, d in ((logger, ours), (jlog, theirs)):
        log = mod.FrameLogger(str(d), depth_factor=5000.0)
        for item in frames:
            log.log_data(item)
        log.close()
    assert (ours / "trajectory.txt").read_text() == (theirs / "trajectory.txt").read_text()
    for fid, rgb, depth, pose in frames:
        for suffix in ("rgb", "depth"):
            np.testing.assert_array_equal(read_image(str(ours / f"{fid}_{suffix}.png"), True),
                                          read_image(str(theirs / f"{fid}_{suffix}.png"), True))
    a = list(LoggedReplay(str(ours), 5000.0))
    b = list(JReplay(str(ours), 5000.0))
    assert [f.frame_id for f in a] == [f.frame_id for f in b] == [f[0] for f in frames]
    for fa, fb, (_, rgb, depth, pose) in zip(a, b, frames):
        for k in ("cam_T_world", "rgb", "depth", "ht", "lt"):
            np.testing.assert_array_equal(getattr(fa, k), getattr(fb, k))
        np.testing.assert_array_equal(fa.rgb, rgb.astype(np.float32))
        # 16-bit depth at 1/5000 m
        np.testing.assert_allclose(fa.depth, depth, atol=1.01 / 5000.0)
        np.testing.assert_allclose(fa.cam_T_world, pose, atol=1e-6)


def test_stereo_frame_logger_layout(tmp_path):
    rng = np.random.default_rng(4)
    pairs = [(i, rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
              rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
              None if i == 2 else np.eye(4, dtype=np.float32) * (i + 1)) for i in range(3)]
    for mod, d in ((logger, tmp_path / "port"), (jlog, tmp_path / "jax")):
        log = mod.StereoFrameLogger(str(d))
        for item in pairs:
            log.log_data(item)
        log.close()
    assert ((tmp_path / "port" / "trajectory.txt").read_text()
            == (tmp_path / "jax" / "trajectory.txt").read_text())
    replay = list(JStereoReplay(str(tmp_path / "port")))
    assert len(replay) == 3
    for fr, (i, left, right, _) in zip(replay, pairs):
        np.testing.assert_array_equal(fr.left, left.astype(np.float32))
        np.testing.assert_array_equal(fr.right, right.astype(np.float32))


def test_data_logger_drops_the_oldest_when_the_writer_lags():
    gate = threading.Event()
    seen = []

    class Slow(logger.DataLogger):
        def save_data(self, item):
            gate.wait(5)
            seen.append(item)

    log = Slow(depth=2)
    log.log_data(0)
    time.sleep(0.2)  # the writer holds item 0
    for i in range(1, 6):
        log.log_data(i)
    gate.set()
    log.close()
    assert seen == [0, 4, 5]


# ----------------------------------------------------------------------
# cameras
# ----------------------------------------------------------------------
class _Replay:
    def __init__(self, frames):
        self.frames = frames

    def __iter__(self):
        for fid, rgb, depth, pose in self.frames:
            yield type("F", (), {"rgb": rgb, "depth": depth, "cam_T_world": pose})


def test_replay_rgbd_camera_matches_jax():
    frames = _frames(3)
    ours = cameras.ReplayRGBDCamera(_Replay(frames), fps=1000.0, depth_factor=5000.0)
    ref = jcam.ReplayRGBDCamera(_Replay(frames), fps=1000.0, depth_factor=5000.0)
    for _ in frames:
        a, b = ours.get_rgbd_frame(), ref.get_rgbd_frame()
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1].dtype == b[1].dtype == np.uint16
        np.testing.assert_array_equal(a[1], b[1])
        assert abs(a[2] - b[2]) < 5000
    assert ours.depth_scale() == ref.depth_scale() == 1 / 5000.0
    with pytest.raises(StopIteration):
        ours.get_rgbd_frame()


def test_synthetic_rgbd_camera_matches_jax():
    poses = [look_at((0.01 * i, 0.0, 0.0), (0.0, 0.0, 2.0)) for i in range(3)]

    def render(pose):
        return checker_rgb(W, H), render_wall(W, H, K, pose, wall_z=2.0)

    ours = cameras.SyntheticRGBDCamera(render, poses, fps=30.0)
    ref = jcam.SyntheticRGBDCamera(render, poses, fps=30.0)
    for _ in poses:
        a, b = ours.get_rgbd_frame(), ref.get_rgbd_frame()
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2] == b[2]
        np.testing.assert_array_equal(ours.current_pose(), ref.current_pose())
    assert ours.depth_scale() == ref.depth_scale()
    with pytest.raises(StopIteration):
        ours.get_rgbd_frame()


def test_replay_stereo_camera_takes_any_rectifier():
    rng = np.random.default_rng(5)
    pairs = [(rng.random((H, W)), rng.random((H, W))) for _ in range(2)]

    class Flip:
        def rectify(self, left, right):
            return left[:, ::-1], right[::-1]

    for rect in (None, Flip()):
        ours = cameras.ReplayStereoCamera(pairs, rectifier=rect, fps=1000.0)
        ref = jcam.ReplayStereoCamera(pairs, rectifier=rect, fps=1000.0)
        for _ in pairs:
            a, b = ours.get_stereo_frame(), ref.get_stereo_frame()
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
    assert issubclass(cameras.ReplayStereoCamera, cameras.StereoCamera)
    imu = cameras.IMUSample(5, np.zeros(3), np.ones(3))
    assert imu.timestamp_ms == 5


def test_system_clock_matches_jax():
    a, b = get_system_timestamp_ms(), j_system_ms()
    assert isinstance(a, int) and abs(a - b) < 1000


# ----------------------------------------------------------------------
# native runtime
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def native():
    if runtime.compiler() is None:
        pytest.skip("no C++ compiler found")
    assert runtime.available(), "runtime.cpp did not build"
    return runtime


def _random_pose(rng) -> np.ndarray:
    q = rng.standard_normal(4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    m = np.eye(4)
    m[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                 [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                 [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
    m[:3, 3] = rng.uniform(-3, 3, 3)
    return m


@pytest.mark.parametrize("interpolate", [True, False])
def test_native_pose_buffer_matches_pose_manager(native, interpolate):
    rng = np.random.default_rng(6)
    buf, ref = native.NativePoseBuffer(interpolate), PoseManager(interpolate)
    np.testing.assert_array_equal(buf.query_pose(10), ref.query_pose(10))  # empty: identity
    for t in range(0, 600, 33):
        pose = _random_pose(rng)
        buf.register_valid_pose(t, pose)
        ref.register_valid_pose(t, pose)
    assert len(buf) == len(ref) == 19
    for t in [-50, 0, 1, 16, 17, 32, 33, 250, 593, 594, 1000, *rng.integers(-10, 620, 50)]:
        np.testing.assert_allclose(buf.query_pose(int(t)), ref.query_pose(int(t)), atol=2e-6)


def test_native_frame_queue_drops_the_oldest(native):
    q = native.NativeFrameQueue(capacity=2)
    assert [q.push(t, bytes([t]) * 3) for t in (1, 2, 3)] == [False, False, True]
    assert q.depth() == 2 and q.dropped() == 1
    assert q.pop() == (2, b"\x02\x02\x02")
    assert q.pop() == (3, b"\x03\x03\x03")
    assert q.pop(timeout_ms=10) is None
    q.close()
    assert q.pop(timeout_ms=10) is None
    assert abs(native.monotonic_ms() - time.monotonic_ns() // 1_000_000) < 1000


def test_native_library_builds_outside_the_source_tree(native):
    path = native.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "disinfect_slam_tpu_torch"
