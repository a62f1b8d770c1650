"""PyTorch port, DenseSLAM (systems/dense_slam.py) against the JAX
package's DenseSLAM(splat_impl="xla") on the CPU, on the scenes of
tests/test_dense_slam.py at 160x120 with its SLAM_CFG: the 6-frame orbit
(per-frame poses, ok flags, the fused volume, ATE), the translation
prior, the initial-pose anchor, track_res_scale=2; the validity-aware
box smoothing against jax.scipy.signal.convolve2d; one counted pose read
per tracked frame and none on frame 0, with tensors returned; the
model depth through the z-buffer wrapper only; recentering and the
host-spill refusal.  JAX runs are shared through module fixtures."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disinfect_slam_tpu.systems.dense_slam import DenseSLAM as JSLAM
from disinfect_slam_tpu.systems.imu import ImuPreintegrator
from disinfect_slam_tpu.utils.trajectory_eval import ate
from disinfect_slam_tpu_torch.config import TSDFConfig
from disinfect_slam_tpu_torch.ops.cuda import splat_kernel
from disinfect_slam_tpu_torch.ops.gather import volume_fingerprint
from disinfect_slam_tpu_torch.systems import dense_slam as tds
from disinfect_slam_tpu_torch.systems import odometry

from .scenes import checker_rgb, look_at
from .test_dense_slam import CENTER, SLAM_CFG, H, K, W, scene_depth
from .test_torch_hash import jax_arrays, port_arrays

torch.set_num_threads(1)

RGB = checker_rgb(W, H)
ORBIT = [look_at((np.sin(a) * 1.8, 0.01 * a, -1.8 * np.cos(a) + 0.3), CENTER)
         for a in np.linspace(0, 0.12, 6)]
# per-frame cam_T_world against the JAX tracker's, after 6 frames: the
# two fuse the same voxels to within 1e-5 (XLA:CPU's FMA contraction),
# so the model depths, and with them ICP's correspondences, drift apart
# by ulps; measured 4.2e-5 at frame 5
POSE_TOL = 2e-4


def port_slam(**kw):
    return tds.DenseSLAM(K, H, W, voxel_size=0.02, truncation=0.06,
                         cfg=TSDFConfig(**dataclasses.asdict(SLAM_CFG)), device="cpu", **kw)


def jax_slam(**kw):
    return JSLAM(K, H, W, voxel_size=0.02, truncation=0.06, cfg=SLAM_CFG, splat_impl="xla",
                 **kw)


def run(slam, poses, priors=None):
    est, oks = [], []
    for i, pose in enumerate(poses):
        p, ok = slam.process_frame(RGB, scene_depth(pose),
                                   trans_prior=None if priors is None else priors[i])
        est.append(np.asarray(p.numpy() if isinstance(p, torch.Tensor) else p))
        oks.append(bool(ok))
    return np.stack(est), oks


@pytest.fixture(scope="module")
def orbit_runs():
    out = {}
    for scale in (1, 2):
        j, t = jax_slam(track_res_scale=scale), port_slam(track_res_scale=scale)
        out[scale] = (j, run(j, ORBIT), t, run(t, ORBIT))
    return out


@pytest.mark.parametrize("scale", [1, 2])
def test_orbit_matches_jax(orbit_runs, scale):
    """The 6-frame orbit, at full and at half tracking resolution: the
    same ok flags, poses within POSE_TOL, the same live blocks in the
    same pool rows, fused sums within 1e-3 relative, and ATE under 2 cm
    (3 cm at half resolution, test_dense_slam's limits)."""
    j, (jp, jok), t, (tp, tok) = orbit_runs[scale]
    assert tok == jok == [True] * 6
    np.testing.assert_allclose(tp, jp, rtol=0, atol=POSE_TOL)
    a, b = port_arrays(t.volume), jax_arrays(j.volume)
    np.testing.assert_array_equal(a["entry_block"], b["entry_block"])
    fa, fb = volume_fingerprint(a), volume_fingerprint(b)
    assert fa["active_blocks"] == fb["active_blocks"] > 500
    for k in ("sum_abs_tsdf", "sum_weight", "sum_prob"):
        assert abs(fa[k] - fb[k]) <= 1e-3 * fb[k], (k, fa[k], fb[k])
    gt_wc = np.stack([np.linalg.inv(p) for p in ORBIT])
    assert ate(gt_wc, np.linalg.inv(tp), align=True)["rmse"] < (0.02 if scale == 1 else 0.03)
    rel_true = ORBIT[-1] @ np.linalg.inv(ORBIT[0])
    rel_est = tp[-1] @ np.linalg.inv(tp[0])
    assert np.linalg.norm(rel_true[:3, 3] - rel_est[:3, 3]) < (0.02 if scale == 1 else 0.03)
    assert t.lost_count == j.lost_count == 0


def test_render_after_the_orbit_matches_jax(orbit_runs):
    """DenseSLAM.render at the tracked pose: the fused model renders
    (hit share above 0.4, test_dense_slam's) and its depth equals the JAX
    render's where both hit, within a z-buffer quantum (1/4096 m) on all
    but 1% of those pixels and within a voxel on all but 0.2% (measured
    0.24% and 0.028%: the poses differ by ulps, which moves which voxel
    wins at a few silhouette pixels)."""
    j, _, t, _ = orbit_runs[1]
    rt, rj = t.render(), j.render()
    hit_t, hit_j = rt.hit.numpy(), np.asarray(rj.hit)
    assert hit_t.mean() > 0.4 and abs(hit_t.mean() - hit_j.mean()) < 0.01
    both = hit_t & hit_j
    err = np.abs(rt.depth.numpy()[both] - np.asarray(rj.depth)[both])
    assert (err > 1 / 4096).mean() < 0.01
    assert (err > 0.02).mean() < 0.002


def test_trans_prior_matches_jax():
    """A 0.3 m lateral jump seeded by the IMU translation prior: every
    frame tracks in both, poses within POSE_TOL, and the travel matches
    2 steps within 3 cm (test_dense_slam's)."""
    step = 0.3
    pose0 = look_at((0.0, 0.0, -1.5), (0.0, 0.0, CENTER[2]))
    true_step_sw = (pose0[:3, :3] @ np.array([step, 0.0, 0.0])).astype(np.float32)
    poses = [look_at((x, 0.0, -1.5), (x, 0.0, CENTER[2])) for x in (0.0, 0.0, step, 2 * step)]
    priors = [None, None, true_step_sw, true_step_sw]
    jp, jok = run(jax_slam(), poses, priors)
    tp, tok = run(port_slam(), poses, priors)
    assert tok == jok == [True] * 4
    np.testing.assert_allclose(tp, jp, rtol=0, atol=POSE_TOL)
    moved = np.linalg.inv(tp[3])[:3, 3] - np.linalg.inv(tp[1])[:3, 3]
    assert np.linalg.norm(moved - 2 * true_step_sw) < 0.03


def test_initial_pose_anchor_matches_jax():
    """set_initial_pose with a gravity-aligned pose (25 degrees of pitch
    from a static accel window): frame 0 fuses at inv(world_T_cam0), the
    JAX package's float32 inverse bit for bit, the second frame tracks within POSE_TOL of JAX, and after
    frame 0 the anchor is frozen."""
    from scipy.spatial.transform import Rotation

    up_cam = Rotation.from_euler("x", 25.0, degrees=True).apply([0.0, 0.0, 1.0])
    pre = ImuPreintegrator()
    for i in range(100):
        pre.add_raw(i * 2.5, gyro=(0, 0, 0), accel=9.80665 * up_cam)
    w0 = pre.gravity_aligned_pose()
    pose = look_at((0.0, 0.0, -1.6), CENTER)
    out = []
    for slam in (jax_slam(), port_slam()):
        slam.set_initial_pose(w0)
        out.append(run(slam, [pose, pose]))
    (jp, jok), (tp, tok) = out
    np.testing.assert_array_equal(tp[0], jp[0])
    np.testing.assert_allclose(tp[0], np.linalg.inv(w0), rtol=0, atol=1e-6)
    assert tok == jok == [True, True]
    np.testing.assert_allclose(tp, jp, rtol=0, atol=POSE_TOL)
    with pytest.raises(RuntimeError):
        slam.set_initial_pose(np.eye(4))


def test_box_smoothing_matches_convolve2d():
    """The validity-aware 3x3 smoothing as nine shifted adds against
    jax.scipy.signal.convolve2d's: within 2 float32 ulps of a 4 m depth
    (the nine-term sums are added in other orders), zeros kept zero."""
    rng = np.random.default_rng(4)
    d = rng.uniform(0.5, 4.0, (H, W)).astype(np.float32)
    d[rng.random((H, W)) < 0.3] = 0.0
    valid = jnp.asarray((d > 0).astype(np.float32))
    k = jnp.ones((3, 3), jnp.float32)
    num = jax.scipy.signal.convolve2d(jnp.asarray(d) * valid, k, mode="same")
    den = jax.scipy.signal.convolve2d(valid, k, mode="same")
    ref = np.asarray(jnp.where(valid > 0, jnp.where(den > 0, num / jnp.maximum(den, 1.0), 0.0),
                               0.0))
    ours = tds.smooth_model_depth(torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(ours == 0, d == 0)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2 * np.spacing(np.float32(4.0)))


def test_one_pose_read_per_tracked_frame(monkeypatch):
    """Frame 0 reads nothing; each tracked frame reads exactly once
    (odometry.read_result), launches the z-buffer wrapper once at the
    tracking camera and never the payload wrapper; process_frame returns
    tensors."""
    zbuf_calls, payload_calls = [], []
    real_zbuf = splat_kernel.splat_zbuf_blocks

    def count_zbuf(*a, cam, **kw):
        zbuf_calls.append((cam.img_h, cam.img_w))
        return real_zbuf(*a, cam=cam, **kw)

    monkeypatch.setattr(splat_kernel, "splat_zbuf_blocks", count_zbuf)
    monkeypatch.setattr(splat_kernel, "splat_payload_blocks",
                        lambda *a, **k: payload_calls.append(1))
    slam = port_slam(track_res_scale=2)
    reads = []
    for i, pose in enumerate(ORBIT[:4]):
        before = odometry.read_result.reads
        p, ok = slam.process_frame(RGB, scene_depth(pose))
        reads.append(odometry.read_result.reads - before)
        assert isinstance(p, torch.Tensor) and p.shape == (4, 4) and p.dtype == torch.float32
        assert isinstance(ok, torch.Tensor) and ok.dtype == torch.bool and bool(ok)
    assert reads == [0, 1, 1, 1]
    assert zbuf_calls == [(H // 2, W // 2)] * 3 and not payload_calls


def test_plain_splat_equals_the_kernel_wrapper_path():
    """splat_impl="xla" (the plain z-buffer) tracks to the same bits as
    the default path (the z-buffer wrapper, whose CPU branch is the plain
    version)."""
    a, b = port_slam(), port_slam(splat_impl="xla")
    np.testing.assert_array_equal(run(a, ORBIT[:3])[0], run(b, ORBIT[:3])[0])


def test_maybe_recenter_follows_the_tracked_camera():
    """The dense window moves when the tracked camera nears its edge: a
    64-block window, an anchor 1 m past its centre, and the live blocks
    survive the move (every live entry's cell points back at it)."""
    cfg = TSDFConfig(**dataclasses.asdict(dataclasses.replace(SLAM_CFG, grid_log2=5)))
    slam = tds.DenseSLAM(K, H, W, voxel_size=0.02, truncation=0.06, cfg=cfg, device="cpu")
    assert not slam.maybe_recenter()
    anchor = np.eye(4, dtype=np.float32)
    anchor[:3, 3] = (1.0, 0.0, 0.0)
    slam.set_initial_pose(anchor)
    slam.process_frame(RGB, scene_depth(ORBIT[0]))
    assert slam.maybe_recenter()
    assert slam.volume.cfg.grid_origin != (-16, -16, -16)
    assert not slam.maybe_recenter()


def test_rejects_what_it_cannot_do():
    # host_spill is ported (tests/test_torch_block_streaming.py): a store,
    # empty until a recenter spills
    assert len(port_slam(host_spill=True).spill_store) == 0
    with pytest.raises(ValueError, match="track_res_scale"):
        port_slam(track_res_scale=7)
    with pytest.raises(ValueError, match="splat_impl"):
        port_slam(splat_impl="raycast")
    with pytest.raises(RuntimeError, match="loop_closure"):
        port_slam().save_map("unused.npz")
