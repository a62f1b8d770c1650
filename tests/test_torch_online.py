"""PyTorch port, the online step: FusedOnlineStep against the JAX
package's (sampler="gather", the exact path) on the golden scenes of
tests/test_online_step.py with no seg, a float32 and a bfloat16 narrow
UNet; the u8/u16 sensor formats; TSDFSystem and DISINFSystem (ports of
tests/test_systems.py's system tests); PoseManager against the JAX one;
the online app in both paths, on RGB-D and on stereo logdirs; the JAX-free
import guarantee and the device checks."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from disinfect_slam_tpu.io.dataset import LoggedReplay as JReplay
from disinfect_slam_tpu.systems.online_step import FusedOnlineStep as JStep
from disinfect_slam_tpu.systems.pose_manager import PoseManager as JPoseManager
from disinfect_slam_tpu_torch.apps import online
from disinfect_slam_tpu_torch.io.png_io import read_png
from disinfect_slam_tpu_torch.models.segmentation import load_model
from disinfect_slam_tpu_torch.ops.gather import BoundingCube
from disinfect_slam_tpu_torch.systems.disinf_system import DISINFSystem
from disinfect_slam_tpu_torch.systems.online_step import FusedOnlineStep
from disinfect_slam_tpu_torch.systems.pose_manager import PoseManager
from disinfect_slam_tpu_torch.systems.tsdf_grid import TSDFGrid
from disinfect_slam_tpu_torch.systems.tsdf_system import TSDFSystem

from .scenes import look_at, render_wall
from .test_integrate import CFG_DENSE_FILTER, H, K, MAX_DEPTH, W
from .test_online_step import DEPTH_FACTOR, _frames
from .test_torch_hash import jax_arrays, port_arrays, port_cfg
from .test_torch_integrate import assert_matches_jax
from .test_torch_offline import K as TINY_K
from .test_torch_offline import tiny_dataset  # noqa: F401  (fixture)
from .test_torch_seg import carried_pair
from .torch_cases import ORBIT_VGA_K, STEREO_BASELINE, write_stereo_logdir

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CFG = dataclasses.replace(CFG_DENSE_FILTER, alloc_every=2, sampler="gather")
# prob with a net: its maps reach fusion only through the log-odds update
# of prob, so every other field stays as close as without a net.  float32:
# XLA:CPU sums each GroupNorm's 225,280-pixel group (352x640) in float32
# with a drift of up to 1e-3 of the variance against a float64 sum, where
# the port's pairwise sum stays within 1e-6 of it; on the checker frames
# that moves the logits by up to 0.01 and prob by up to 1.8e-4 (measured).
# bfloat16: the bf16 roundings of test_torch_seg.py besides; measured
# max |dprob| 0.017, on 0.7% of the voxels above 0.01.
PROB_TOL = {"float32": 1e-3, "bfloat16": 0.05}


def _nets(seg):
    if seg == "none":
        return None, None, None
    import jax.numpy as jnp

    jdt, tdt = (jnp.float32, torch.float32) if seg == "float32" else (
        jnp.bfloat16, torch.bfloat16)
    return carried_pair("unet", jdt, tdt, 64, 128)


@pytest.mark.parametrize("seg", ["none", "float32", "bfloat16"])
def test_online_step_matches_jax(seg):
    """4 frames of u8 rgb + u16 depth, allocation every 2nd frame: the
    same live blocks and rgbw words as the JAX step, tsdf within 1e-5
    (test_torch_integrate.py's tolerances); prob within 1e-5 without a
    net, within PROB_TOL with one."""
    jm, params, tm = _nets(seg)
    ref = JStep(CFG, K, H, W, MAX_DEPTH, seg_model=jm, seg_params=params,
                depth_factor=DEPTH_FACTOR)
    ours = FusedOnlineStep(port_cfg(CFG), K, H, W, MAX_DEPTH, seg_model=tm,
                           depth_factor=DEPTH_FACTOR, device="cpu")
    for rgb, depth, pose in _frames(4):
        ref.step(rgb, depth, pose)
        ours.step(rgb, depth, pose)
    a, b = port_arrays(ours.volume), jax_arrays(ref.volume)
    rows = b["entry_block"][b["entry_block"] >= 0]
    live_prob = b["prob"][rows][(b["rgbw"][rows] >> 24) > 0]
    if seg == "none":
        np.testing.assert_allclose(live_prob, 0.5, atol=1e-6)
    else:  # the net's maps moved prob
        assert np.abs(live_prob - 0.5).max() > 0.01
    if seg == "none":
        assert_matches_jax(ours.volume, ref.volume)
        return
    for f in ("entry_key", "entry_block", "block_table", "heap", "num_free",
              "oob_count", "rgbw"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    np.testing.assert_allclose(a["tsdf"][rows], b["tsdf"][rows], rtol=0, atol=1e-5)
    np.testing.assert_allclose(a["prob"][rows], b["prob"][rows], rtol=0, atol=PROB_TOL[seg])


def test_sensor_format_matches_f32():
    """u8 rgb and u16 depth counts, converted on the device, give the
    volume of pre-converted float32 inputs bit for bit (the same float32
    division by depth_factor)."""
    cfg = port_cfg(CFG)
    a = FusedOnlineStep(cfg, K, H, W, MAX_DEPTH, depth_factor=DEPTH_FACTOR, device="cpu")
    b = FusedOnlineStep(cfg, K, H, W, MAX_DEPTH, depth_factor=DEPTH_FACTOR, device="cpu")
    for rgb, depth, pose in _frames():
        a.step(rgb, depth, pose)
        b.step(rgb.astype(np.float32),
               depth.astype(np.float32) / np.float32(DEPTH_FACTOR), pose)
    assert a.num_active_blocks() > 10
    va, vb = port_arrays(a.volume), port_arrays(b.volume)
    for f in va:
        np.testing.assert_array_equal(va[f], vb[f], err_msg=f)


def test_no_seg_step_equals_grid_integrate():
    """Without a net the step is TSDFGrid.integrate with ht = lt = 1 on the
    alloc_every cadence."""
    cfg = port_cfg(CFG)
    step = FusedOnlineStep(cfg, K, H, W, MAX_DEPTH, depth_factor=DEPTH_FACTOR, device="cpu")
    grid = TSDFGrid(cfg.voxel_size, cfg.truncation, cfg=cfg, device="cpu")
    for rgb, depth, pose in _frames(4):
        step.step(rgb, depth, pose)
        grid.integrate(rgb.astype(np.float32),
                       depth.astype(np.float32) / np.float32(DEPTH_FACTOR),
                       None, None, MAX_DEPTH, K, pose)
    va, vb = port_arrays(step.volume), port_arrays(grid.volume)
    for f in va:
        np.testing.assert_array_equal(va[f], vb[f], err_msg=f)


# ----------------------------------------------------------------------
# systems (tests/test_systems.py:99-171 on the port's dense backend)
# ----------------------------------------------------------------------
SYS_CFG = port_cfg(CFG_DENSE_FILTER)


def _wall(w=W, h=H, k=K):
    pose = look_at((0.01, 0.02, -0.01), (0.04, -0.03, 2.0))
    return pose, render_wall(w, h, k, pose, wall_z=2.0131)


def test_tsdf_system_async_integration_and_query():
    sys_ = TSDFSystem(0.05, 0.15, 4.0, K, cfg=SYS_CFG, device="cpu")
    pose, depth = _wall()
    rgb = np.full((H, W, 3), 128, np.float32)
    for _ in range(2):
        sys_.integrate(pose, rgb, depth)
    sys_.flush()
    assert sys_.tsdf.num_active_blocks() > 10 and sys_.dropped_frames == 0
    st = sys_.query(BoundingCube(-2, 2, -2, 2, 0, 3))
    assert int(st.count) > 0
    sys_.terminate()
    assert not sys_._thread.is_alive()


def test_tsdf_system_missing_masks_default_to_ones():
    sys_ = TSDFSystem(0.05, 0.15, 4.0, K, cfg=SYS_CFG, device="cpu")
    pose, depth = _wall()
    sys_.integrate(pose, np.full((H, W, 3), 128, np.float32), depth)  # no ht/lt
    sys_.flush()
    vol = port_arrays(sys_.tsdf.volume)
    pool = vol["entry_block"][vol["entry_block"] >= 0]
    w = vol["rgbw"][pool] >> 24
    np.testing.assert_allclose(vol["prob"][pool][w > 0], 0.5, atol=1e-5)
    sys_.terminate()


def test_tsdf_system_counts_a_dropped_frame():
    """A frame that fails to integrate is counted and dropped; the
    integration thread goes on with the next one."""
    sys_ = TSDFSystem(0.05, 0.15, 4.0, K, cfg=SYS_CFG, device="cpu")
    pose, depth = _wall()
    sys_.integrate(pose, np.zeros((H, W), np.float32), depth)  # rgb of the wrong shape
    sys_.integrate(pose, np.full((H, W, 3), 128, np.float32), depth)
    sys_.flush()
    assert sys_.dropped_frames == 1 and sys_.tsdf.num_active_blocks() > 10
    sys_.terminate()


@pytest.mark.parametrize("with_segmenter", [False, True])
def test_disinf_facade_pipeline(with_segmenter):
    """Full-resolution frames half-scaled by the facade
    (disinfect_slam.cc:37-43), depth scaled by depth_factor, the pose
    borrowed by timestamp; a segmenter's maps reach prob: a first
    observation with ht 0.8, lt 0.3 fuses to 0.8 / (0.8 + 0.3)."""
    k2 = tuple(2 * k for k in K)
    pose, depth = _wall(W * 2, H * 2, k2)
    rgb = np.full((H * 2, W * 2, 3), 100, np.float32)
    seen = []

    def segmenter(img):
        seen.append(img.shape)
        return np.full((H, W), 0.8, np.float32), np.full((H, W), 0.3, np.float32)

    with DISINFSystem(K, depth_factor=1000.0, voxel_size=0.05, truncation=0.15,
                      cfg=SYS_CFG, segmenter=segmenter if with_segmenter else None,
                      device="cpu") as s:
        s.feed_pose(100, pose)
        s.feed_rgbd_frame(rgb, depth * 1000.0, 100)
        s.tsdf.flush()
        assert s.tsdf.tsdf.num_active_blocks() > 10
        assert int(s.query_tsdf(BoundingCube(-2, 2, -2, 2, 0, 3)).count) > 0
        np.testing.assert_allclose(s.query_camera_pose(100), pose, atol=1e-5)
        vol = port_arrays(s.tsdf.tsdf.volume)
    pool = vol["entry_block"][vol["entry_block"] >= 0]
    p = vol["prob"][pool][(vol["rgbw"][pool] >> 24) > 0]
    np.testing.assert_allclose(p, 0.8 / 1.1 if with_segmenter else 0.5, atol=1e-5)
    assert seen == ([(H, W, 3)] if with_segmenter else [])


def test_unported_options_raise():
    # host_spill, auto_recenter and the occlusion cull are ported
    # (tests/test_torch_{block_streaming,hash_backend,cull}.py), and so is
    # --stereo (test_online_app_stereo_matches_jax below)
    with TSDFSystem(0.05, 0.15, 4.0, K, cfg=SYS_CFG, host_spill=True, device="cpu") as s:
        assert len(s.tsdf.spill_store) == 0
    grid = TSDFGrid(0.05, 0.15, cfg=dataclasses.replace(SYS_CFG, cull_occluded=True),
                    device="cpu")
    grid.integrate(np.zeros((8, 8, 3), np.float32), np.ones((8, 8), np.float32), None, None,
                   4.0, (8.0, 8.0, 3.5, 3.5), np.eye(4, dtype=np.float32))
    assert grid.num_active_blocks() > 0
    with pytest.raises(SystemExit) as exc:  # the fused loop has no window follow
        online.parse_args(["--logdir", ".", "--fused", "--auto-recenter"])
    assert exc.value.code != 0


@pytest.mark.parametrize("interpolate", [False, True])
def test_pose_manager_matches_jax(interpolate):
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(7)
    ours, ref = PoseManager(interpolate), JPoseManager(interpolate)
    for pm in (ours, ref):
        np.testing.assert_array_equal(pm.query_pose(5), np.eye(4, dtype=np.float32))
    for i in range(12):
        m = np.eye(4)
        m[:3, :3] = Rotation.from_rotvec(rng.normal(0, 0.7, 3)).as_matrix()
        m[:3, 3] = rng.uniform(-1, 1, 3)
        ours.register_valid_pose(i * 100, m)
        ref.register_valid_pose(i * 100, m)
    for t in [-50, 0, 37, 149, 151, 640, 1100, 1500]:
        np.testing.assert_array_equal(ours.query_pose(t), ref.query_pose(t))


# ----------------------------------------------------------------------
# the online app
# ----------------------------------------------------------------------
def _app_args(ds, *extra):
    return ["--logdir", ds, "--config", os.path.join(ds, "cam.yaml"), "--preset", "small",
            "--voxel", "0.05", "--trunc", "0.15", "--max-depth", "4.0", "--device", "cpu",
            *extra]


def test_online_app_fused_matches_jax_step(tiny_dataset):  # noqa: F811
    """--fused without seg: the JAX package's FusedOnlineStep over the same
    replay, at the small preset with the exact sampler."""
    res = online.main(_app_args(tiny_dataset, "--fused"))
    assert res["frames"] == 4 and res["active_blocks"] > 10
    from disinfect_slam_tpu.config import TSDFConfig as JConfig

    cfg = JConfig(voxel_size=0.05, truncation=0.15, num_blocks_log2=12,
                  max_candidates=8192, max_visible=4096, max_new_per_round=2048,
                  grid_log2=7, sampler="gather")
    ref = JStep(cfg, TINY_K, 120, 160, 4.0)
    for fr in JReplay(tiny_dataset, 5000.0):
        ref.step(fr.rgb, fr.depth, fr.cam_T_world)
    assert_matches_jax(res["step"].volume, ref.volume)


def test_online_app_segments_in_both_paths(tiny_dataset, tmp_path):  # noqa: F811
    """--segment with the shipped UNet: the fused path renders two 640x360
    RGBA PNGs; the asynchronous path integrates all frames, drops none,
    and allocates the same blocks; in both the maps moved prob."""
    fused = online.main(_app_args(tiny_dataset, "--segment", "--fused",
                                  "--render-dir", str(tmp_path)))
    paths = fused["render_paths"]
    assert [os.path.basename(p) for p in paths] == ["view_rgba.png", "view_normal.png"]
    for p in paths:
        img = read_png(p)
        assert img.shape == (360, 640, 4) and img.dtype == np.uint8
    asy = online.main(_app_args(tiny_dataset, "--segment", "--fps", "200"))
    assert fused["frames"] == asy["frames"] == 4
    assert asy["system"].tsdf.dropped_frames == 0
    assert asy["active_blocks"] == fused["active_blocks"] > 10
    for vol in (fused["step"].volume, asy["system"].tsdf.tsdf.volume):
        a = port_arrays(vol)
        pool = a["entry_block"][a["entry_block"] >= 0]
        prob = a["prob"][pool][(a["rgbw"][pool] >> 24) > 0]
        assert np.abs(prob - 0.5).max() > 0.01


# the stereo app: tests/torch_cases.py's orbit pairs at 160x120 (K / 4),
# 16 disparities, the small preset
STEREO_W, STEREO_H, STEREO_N, STEREO_DISP = 160, 120, 4, 16
STEREO_K = tuple(k / 4 for k in ORBIT_VGA_K)


@pytest.fixture(scope="module")
def stereo_logdir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("stereo"))
    write_stereo_logdir(d, os.path.join(ROOT, "datasets", "orbit_vga"), STEREO_N, STEREO_W,
                        STEREO_H, STEREO_K)
    return d


def _jax_stereo_step(logdir, identity_poses=False, method="flat"):
    """The JAX app's --stereo --fused loop (apps/online.py:132-169 and
    :186-215) with the exact sampler: depth from its estimator (`method`
    its --stereo-method), rgb the left view, the logged pose or the
    identity."""
    from disinfect_slam_tpu.config import TSDFConfig as JConfig
    from disinfect_slam_tpu.io.dataset import LoggedStereoReplay as JStereo
    from disinfect_slam_tpu.ops.stereo import StereoDepthEstimator as JEst

    cfg = JConfig(voxel_size=0.05, truncation=0.15, num_blocks_log2=12,
                  max_candidates=8192, max_visible=4096, max_new_per_round=2048,
                  grid_log2=7, sampler="gather")
    est = JEst(fx=STEREO_K[0], baseline_m=STEREO_BASELINE, max_disp=STEREO_DISP,
               max_depth=4.0, method=method)
    ref = JStep(cfg, STEREO_K, STEREO_H, STEREO_W, 4.0)
    for fr in JStereo(logdir):
        pose = np.eye(4, dtype=np.float32) if identity_poses else fr.cam_T_world
        ref.step(fr.left, est(fr.left, fr.right), pose)
    return ref


def _stereo_args(logdir, *extra):
    return _app_args(logdir, "--stereo", "--max-disp", str(STEREO_DISP),
                     "--baseline", str(STEREO_BASELINE), *extra)


def test_online_app_stereo_matches_jax(stereo_logdir):
    """--stereo --fused with either matcher: the volume of the JAX app's
    loop over the same pairs with the same matcher, with
    test_torch_integrate.py's tolerances (the same blocks and rgbw words,
    tsdf within 1e-5: the depth maps are equal bit for bit,
    tests/test_torch_stereo.py).  The asynchronous path fuses every frame
    into the JAX flat loop's blocks, in the same pool rows; its tsdf is
    not held to the loop's, because its poses come through PoseManager's
    quaternion form and differ from the logged ones in their last bits."""
    res = online.main(_stereo_args(stereo_logdir, "--fused"))
    assert res["frames"] == STEREO_N and res["active_blocks"] > 10
    ref = _jax_stereo_step(stereo_logdir).volume
    assert_matches_jax(res["step"].volume, ref)
    pyr = online.main(_stereo_args(stereo_logdir, "--fused", "--stereo-method", "pyramid"))
    assert pyr["frames"] == STEREO_N and pyr["active_blocks"] > 10
    assert_matches_jax(pyr["step"].volume, _jax_stereo_step(stereo_logdir, method="pyramid").volume)
    asy = online.main(_stereo_args(stereo_logdir, "--fps", "200"))
    assert asy["frames"] == STEREO_N and asy["system"].tsdf.dropped_frames == 0
    a, b = port_arrays(asy["system"].tsdf.tsdf.volume), jax_arrays(ref)
    for f in ("entry_key", "entry_block", "block_table", "heap", "num_free", "oob_count"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert asy["active_blocks"] == int((b["entry_block"] >= 0).sum())


def test_online_app_stereo_without_poses(stereo_logdir, tmp_path):
    """A stereo capture without trajectory rows: the fused path takes the
    identity pose for every frame (as the JAX app) and renders from it;
    the asynchronous path feeds no pose and still fuses every frame."""
    import shutil

    d = tmp_path / "nopose"
    shutil.copytree(stereo_logdir, d)
    (d / "trajectory.txt").write_text("")
    res = online.main(_stereo_args(str(d), "--fused", "--render-dir", str(tmp_path / "r")))
    assert res["frames"] == STEREO_N and len(res["render_paths"]) == 2
    assert_matches_jax(res["step"].volume,
                       _jax_stereo_step(str(d), identity_poses=True).volume)
    asy = online.main(_stereo_args(str(d), "--fps", "200"))
    assert asy["frames"] == STEREO_N and asy["system"].tsdf.dropped_frames == 0


# ----------------------------------------------------------------------
# import guarantee and devices
# ----------------------------------------------------------------------
def test_online_modules_import_without_jax():
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'disinfect_slam_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        "import disinfect_slam_tpu_torch.apps.online\n"
        "import disinfect_slam_tpu_torch.systems.disinf_system\n"
        "import dataclasses\n"
        "from disinfect_slam_tpu_torch.config import TINY_DENSE\n"
        "from disinfect_slam_tpu_torch.models import segmentation as s\n"
        "from disinfect_slam_tpu_torch.systems.online_step import FusedOnlineStep\n"
        "from tests.scenes import checker_rgb, look_at, render_wall\n"
        "assert len(s.load_default_params('fast')) == 29\n"
        "K = (52.7, 53.3, 31.71, 23.43)\n"
        "pose = look_at((0.03, -0.04, 0.02), (0.11, 0.07, 2.0131))\n"
        "net = s.create_model((8, 8, 8, 8), dtype=torch.float32)\n"
        "cfg = dataclasses.replace(TINY_DENSE, voxel_size=0.05, truncation=0.15)\n"
        "st = FusedOnlineStep(cfg, K, 48, 64, 4.0, seg_model=net, depth_factor=5000.0,\n"
        "                     device='cpu')\n"
        "depth = (render_wall(64, 48, K, pose, 2.0131) * 5000).astype(np.uint16)\n"
        "st.step(checker_rgb(64, 48).astype(np.uint8), depth, pose)\n"
        "assert st.num_active_blocks() > 0\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_cuda_requests_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = port_cfg(CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_model("fast", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        FusedOnlineStep(cfg, K, H, W, MAX_DEPTH, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        TSDFSystem(0.05, 0.15, 4.0, K, cfg=cfg, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        online.main(["--logdir", ".", "--device", "cuda"])
