"""PyTorch port, the host side of the tracking slice: the restated numpy
modules (systems/imu.py, systems/slam.py, utils/trajectory_eval.py)
pinned to the JAX package's on seeded inputs (equal bit for bit: the
same numpy code), the port's ICPSource on its own tracker, and the two
apps: apps.dense_slam with --device cpu on a tiny logged dataset
against the JAX DenseSLAM over the same frames, and apps.evaluate
against apps/evaluate.py."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from disinfect_slam_tpu.io.checkpoint import load_volume as j_load_volume
from disinfect_slam_tpu.systems import imu as jimu
from disinfect_slam_tpu.systems import slam as jslam
from disinfect_slam_tpu.systems.dense_slam import DenseSLAM as JSLAM
from disinfect_slam_tpu.utils import trajectory_eval as jte
from disinfect_slam_tpu_torch.apps import dense_slam as app
from disinfect_slam_tpu_torch.apps import evaluate as t_evaluate
from disinfect_slam_tpu_torch.systems import imu as timu
from disinfect_slam_tpu_torch.systems import slam as tslam
from disinfect_slam_tpu_torch.utils import trajectory_eval as tte

from .scenes import checker_rgb, look_at, render_sphere, render_wall
from .test_traj_eval import _orbit_poses

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")


# ----------------------------------------------------------------------
# imu.py
# ----------------------------------------------------------------------
def _imu_stream(rng, n=600, dt=2.5):
    """A static second at a tilted attitude, then a rotating, accelerating
    camera: biased, noisy gyro and accel samples (ms, rad/s, m/s^2)."""
    att = Rotation.from_euler("xz", [20.0, -8.0], degrees=True)
    g_cam = att.inv().apply([0.0, 0.0, 9.80665])
    bias_g = np.array([0.004, -0.002, 0.003])
    rows = []
    for i in range(n):
        moving = i >= 400
        w = np.array([0.3, -0.5, 0.2]) if moving else np.zeros(3)
        a = np.array([0.6, 0.1, -0.2]) if moving else np.zeros(3)
        rows.append((i * dt, w + bias_g + rng.normal(0, 1e-3, 3),
                     g_cam + a + rng.normal(0, 1e-2, 3)))
    return rows


def test_imu_matches_jax_on_a_seeded_stream():
    """Bias, gravity, the gravity-aligned pose, relative rotation and
    motion, and both seeding helpers: equal to the JAX copy's."""
    rows = _imu_stream(np.random.default_rng(11))
    pre = {}
    for name, mod in (("jax", jimu), ("port", timu)):
        p = mod.ImuPreintegrator()
        for t, w, a in rows:
            p.add_raw(t, gyro=w, accel=a)
        p.estimate_bias()
        p.estimate_accel_bias()
        pre[name] = p
    j, t = pre["jax"], pre["port"]
    np.testing.assert_array_equal(t.bias, j.bias)
    np.testing.assert_array_equal(t.estimate_gravity(), j.estimate_gravity())
    np.testing.assert_array_equal(t.gravity_aligned_pose(), j.gravity_aligned_pose())
    w0 = j.gravity_aligned_pose()[:3, :3]
    for t0, t1 in ((1000.0, 1100.0), (1050.0, 1400.0), (0.0, 1497.5)):
        np.testing.assert_array_equal(t.relative_rotation(t0, t1), j.relative_rotation(t0, t1))
        for a, b in zip(t.relative_motion(t0, t1, w0, (0.1, 0.0, -0.2)),
                        j.relative_motion(t0, t1, w0, (0.1, 0.0, -0.2))):
            np.testing.assert_array_equal(a, b)
    prev = np.linalg.inv(look_at((0.2, 0.1, -1.0), (0.0, 0.0, 1.5)))
    for a, b in zip(timu.seed_pose_with_imu(prev, t, 1000.0, 1200.0),
                    jimu.seed_pose_with_imu(prev, j, 1000.0, 1200.0)):
        np.testing.assert_array_equal(a, b)
    gp = {}
    for name, mod in (("jax", jimu), ("port", timu)):
        g = mod.GyroPreintegrator()
        for ts, w, _a in rows:
            g.add_raw(ts, gyro=w)
        gp[name] = mod.seed_pose_with_gyro(prev, g, 1000.0, 1300.0)
    np.testing.assert_array_equal(gp["port"], gp["jax"])


# ----------------------------------------------------------------------
# trajectory_eval.py
# ----------------------------------------------------------------------
def test_trajectory_eval_matches_jax(tmp_path):
    """load_trajectory (both row formats), associate, umeyama, ate and
    rpe on a seeded noisy orbit: equal to the JAX copy's."""
    rng = np.random.default_rng(5)
    gt = _orbit_poses(n=30)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.01, (30, 3))
    est[:, :3, :3] = Rotation.from_rotvec(rng.normal(0, 0.01, (30, 3))).as_matrix() @ est[
        :, :3, :3]
    mat_path = str(tmp_path / "est.txt")
    tslam.save_matched_trajectory(mat_path, {i: np.linalg.inv(p) for i, p in enumerate(est)},
                                  range(30))
    tum_path = tmp_path / "gt_tum.txt"
    q = Rotation.from_matrix(gt[:, :3, :3]).as_quat()
    tum_path.write_text("# ts tx ty tz qx qy qz qw\n" + "".join(
        f"{0.1 * i + 0.003:.4f} " + " ".join(f"{v:.9f}" for v in (*gt[i, :3, 3], *q[i]))
        + "\n" for i in range(30)))
    for path in (mat_path, str(tum_path)):
        for a, b in zip(tte.load_trajectory(path), jte.load_trajectory(path)):
            np.testing.assert_array_equal(a, b)
    ts_gt, g = tte.load_trajectory(str(tum_path))
    ts_est, e = tte.load_trajectory(mat_path)
    pairs = tte.associate(ts_gt * 10, ts_est, max_dt=0.5)
    assert pairs == jte.associate(ts_gt * 10, ts_est, max_dt=0.5) and len(pairs) == 30
    for scale in (False, True):
        np.testing.assert_equal(tte.ate(g, e, with_scale=scale),
                                jte.ate(g, e, with_scale=scale))
    np.testing.assert_equal(tte.rpe(g, e, delta=3), jte.rpe(g, e, delta=3))
    for a, b in zip(tte.umeyama_alignment(e[:, :3, 3], g[:, :3, 3], True),
                    jte.umeyama_alignment(e[:, :3, 3], g[:, :3, 3], True)):
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------------
# slam.py
# ----------------------------------------------------------------------
def test_pose_sources_match_jax(tmp_path):
    """TrajectorySource, ExternalSLAMBridge and save_matched_trajectory:
    the same answers and the same file bytes."""
    rng = np.random.default_rng(2)
    poses = [np.linalg.inv(look_at(rng.uniform(-1, 1, 3), (0.0, 0.0, 2.0))) for _ in range(6)]
    stamps = [300, 0, 100, 500, 200, 400]
    srcs = [m.TrajectorySource(stamps, poses) for m in (tslam, jslam)]
    for ts in (-20, 0, 149, 151, 460, 900):
        (pa, oka), (pb, okb) = (s.feed_rgbd(None, None, ts) for s in srcs)
        np.testing.assert_array_equal(pa, pb)
        assert oka == okb
    track = lambda rgb, depth, ts: poses[ts // 100] if ts % 200 else None  # noqa: E731
    bridges = [m.ExternalSLAMBridge(track) for m in (tslam, jslam)]
    for ts in range(0, 600, 100):
        (pa, oka), (pb, okb) = (b.feed_rgbd(None, None, ts) for b in bridges)
        np.testing.assert_array_equal(pa, pb)
        assert oka == okb
    paths = [str(tmp_path / f"{n}.txt") for n in ("port", "jax")]
    frame_poses = {i: (p if i % 3 else None) for i, p in enumerate(poses)}
    counts = [m.save_matched_trajectory(p, frame_poses, range(8))
              for m, p in zip((tslam, jslam), paths)]
    assert counts[0] == counts[1] == 4
    assert open(paths[0]).read() == open(paths[1]).read()


def test_icp_source_runs_the_port_tracker():
    """ICPSource wraps the port's ICPOdometry: frame 0 at the identity,
    then a tracked pose on the host."""
    from .test_odometry import H, K, W, scene_depth

    src = tslam.ICPSource(K, H, W, device="cpu")
    p0 = look_at((0.0, 0.0, -0.5), (0.0, 0.0, 1.6))
    p1 = look_at((0.02, 0.01, -0.49), (0.0, 0.0, 1.6))
    c0, ok0 = src.feed_rgbd(None, scene_depth(p0), 0)
    c1, ok1 = src.feed_rgbd(None, scene_depth(p1), 33)
    assert ok0 and ok1
    np.testing.assert_allclose(c0, np.eye(4), atol=0)
    rel = c1 @ np.linalg.inv(c0)
    assert np.linalg.norm(rel[:3, 3] - (p1 @ np.linalg.inv(p0))[:3, 3]) < 0.005
    with pytest.raises(NotImplementedError):
        src.feed_stereo(None, None, 0)


# ----------------------------------------------------------------------
# the apps
# ----------------------------------------------------------------------
SW, SH = 160, 120
SK = (131.7, 132.3, 79.7, 59.4)
SCENE_CENTER = np.array([0.1, 0.0, 1.5])
N_FRAMES = 5


def _slam_depth(pose):
    d1 = render_sphere(SW, SH, SK, pose, center=SCENE_CENTER, radius=0.45)
    d2 = render_wall(SW, SH, SK, pose, wall_z=2.4131)
    d = np.where(d1 > 0, d1, d2)
    # quantize to the 16-bit PNG's millimetre/5 steps, as a logged frame
    return (np.round(d * 5000.0) / 5000.0).astype(np.float32)


@pytest.fixture(scope="module")
def slam_dataset(tmp_path_factory):
    """A pose-free 160x120 log of the orbit of tests/test_dense_slam.py:
    {id}_rgb.png, {id}_depth.png (u16, factor 5000), cam.yaml, and the
    true trajectory.txt for --evaluate auto."""
    from disinfect_slam_tpu_torch.io.png_io import write_image

    d = tmp_path_factory.mktemp("slam_log")
    rows = []
    for i, ang in enumerate(np.linspace(0, 0.1, N_FRAMES)):
        pose = look_at((np.sin(ang) * 1.8, 0.01 * ang, -1.8 * np.cos(ang) + 0.3),
                       SCENE_CENTER)
        write_image(str(d / f"{i}_rgb.png"), checker_rgb(SW, SH).astype(np.uint8))
        write_image(str(d / f"{i}_depth.png"),
                    np.round(_slam_depth(pose) * 5000.0).astype(np.uint16))
        rows.append(f"{i} " + " ".join(f"{v:.9f}" for v in pose[:3, :4].reshape(-1)))
    (d / "trajectory.txt").write_text("\n".join(rows) + "\n")
    (d / "cam.yaml").write_text(
        "Camera.fx: 131.7\nCamera.fy: 132.3\nCamera.cx: 79.7\nCamera.cy: 59.4\n"
        "Camera.rows: 120\nCamera.cols: 160\ndepthmap_factor: 5000.0\n")
    return str(d)


def _jax_slam_over(ds):
    """apps/dense_slam.py's loop for --preset small --loop-closure
    --kf-every 2, in process, with the exact sampler."""
    from disinfect_slam_tpu.config import TSDFConfig
    from disinfect_slam_tpu.io.png_io import read_image

    cfg = TSDFConfig(num_blocks_log2=12, max_candidates=8192, max_visible=4096,
                     max_new_per_round=2048, grid_log2=7, sampler="gather")
    slam = JSLAM(SK, SH, SW, voxel_size=0.02, truncation=0.06, max_depth=4.0, cfg=cfg,
                 splat_impl="xla", loop_closure=True, kf_every=2,
                 lc_kwargs=dict(min_gap_frames=60))
    poses, oks = [], []
    for i in range(N_FRAMES):
        depth = read_image(os.path.join(ds, f"{i}_depth.png"),
                           unchanged=True).astype(np.float32) / 5000.0
        rgb = read_image(os.path.join(ds, f"{i}_rgb.png")).astype(np.float32)
        p, ok = slam.process_frame(rgb, depth)
        poses.append(np.asarray(p))
        oks.append(bool(ok))
    return slam, np.stack(poses), oks


def test_dense_slam_app_matches_jax(slam_dataset, tmp_path):
    """apps.dense_slam --device cpu --preset small (2 cm voxels, the app's
    default) with --evaluate auto, --out-traj, --loop-closure, --save,
    --save-map and --mesh: the same ok flags, poses within 1e-3 of the JAX
    DenseSLAM's over the same frames (measured 2.3e-4 by frame 4: XLA:CPU
    contracts the projection's multiply-adds into FMAs, which moves a few
    sampled pixels at the sphere's silhouette, and ICP carries that
    forward), the trajectory file readable by the JAX evaluator, the
    volume checkpoint loading into the JAX package with the same live
    blocks, and ATE under 2 cm."""
    out = {k: str(tmp_path / n) for k, n in (
        ("traj", "traj.txt"), ("save", "vol.npz"), ("mesh", "mesh.obj"), ("map", "map.npz"))}
    res = app.main([
        "--logdir", slam_dataset, "--config", os.path.join(slam_dataset, "cam.yaml"),
        "--preset", "small", "--device", "cpu",
        "--loop-closure", "--kf-every", "2", "--evaluate", "auto",
        "--out-traj", out["traj"], "--save", out["save"], "--mesh", out["mesh"],
        "--save-map", out["map"]])
    jslam_obj, jposes, joks = _jax_slam_over(slam_dataset)
    assert res["frames"] == N_FRAMES
    assert [res["ok"][i] for i in range(N_FRAMES)] == joks == [True] * N_FRAMES
    ours = np.stack([res["poses"][i] for i in range(N_FRAMES)])
    np.testing.assert_allclose(ours, jposes, rtol=0, atol=1e-3)
    assert res["slam"].lc.count == jslam_obj.lc.count == 3
    ev = res["evaluation"]
    assert ev["pairs"] == N_FRAMES and ev["ate"]["rmse"] < 0.02
    ts, est = jte.load_trajectory(out["traj"])
    np.testing.assert_array_equal(ts, np.arange(N_FRAMES))
    np.testing.assert_allclose(np.linalg.inv(est), jposes, rtol=0, atol=1e-3)
    vol = j_load_volume(out["save"])
    live_t = np.asarray(vol.entry_block) >= 0
    live_j = np.asarray(jslam_obj.volume.entry_block) >= 0
    assert live_t.sum() == live_j.sum() > 50
    assert res["mesh"]["vertices"] > 1000
    assert os.path.getsize(out["mesh"]) > 0 and os.path.exists(out["map"])


def test_evaluate_app_matches_jax_cli(tmp_path):
    """apps.evaluate in process against apps/evaluate.py as a process on
    the same pair of files: the same JSON report."""
    rng = np.random.default_rng(9)
    gt = _orbit_poses(n=20)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.004, (20, 3))
    paths = [str(tmp_path / n) for n in ("gt.txt", "est.txt")]
    for path, poses in zip(paths, (gt, est)):
        tslam.save_matched_trajectory(path, {i: np.linalg.inv(p) for i, p in enumerate(poses)},
                                      range(20))
    ref = subprocess.run([sys.executable, os.path.join(ROOT, "apps", "evaluate.py"), *paths,
                          "--max-dt", "0.5", "--scale"],
                         capture_output=True, text=True, timeout=120)
    assert ref.returncode == 0, ref.stderr
    from contextlib import redirect_stdout
    from io import StringIO

    buf = StringIO()
    with redirect_stdout(buf):
        code = t_evaluate.main([*paths, "--max-dt", "0.5", "--scale"])
    assert code == 0
    assert json.loads(buf.getvalue()) == json.loads(ref.stdout)
    assert json.loads(buf.getvalue())["ate"]["rmse"] > 1e-3
    with redirect_stdout(StringIO()):
        assert t_evaluate.main([*paths, "--max-dt", "0.5", "--no-align"]) == 0
