"""PyTorch port, host I/O and the debug pass: TUMReplay and _quat_to_mat
against the JAX package's on a TUM directory the test writes;
PrefetchReplay's order, its error hand-off and its early exit;
validate_volume's messages on healthy and corrupted volumes against the
JAX package's; the offline app's --tum --prefetch --debug --spill
--page-radius on a small TUM sequence; the ZED factory calibration
(io/zed_calib.py) and its rectifier, and LoggedStereoReplay, each against
the JAX package's."""

import dataclasses
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disinfect_slam_tpu.core.state import TSDFVolume as JVolume
from disinfect_slam_tpu.io import dataset as jds
from disinfect_slam_tpu.utils import validate as jval
from disinfect_slam_tpu_torch.apps import offline
from disinfect_slam_tpu_torch.io import dataset as tds
from disinfect_slam_tpu_torch.io.checkpoint import volume_from_numpy
from disinfect_slam_tpu_torch.io.png_io import write_image
from disinfect_slam_tpu_torch.ops.gather import load_spatial_tsdf
from disinfect_slam_tpu_torch.utils import validate as tval

from .scenes import checker_rgb, look_at, render_wall
from .test_torch_hash import jax_arrays, port_cfg
from .test_tum import make_tum_fixture
from .test_validate import CFG_DENSE, CFG_HASH, _fused_volume
from .torch_cases import ZED_FACTORY_CONF

torch.set_num_threads(1)


def test_tum_replay_matches_jax(tmp_path):
    """The same TUM directory through both loaders (an orphan rgb frame
    dropped): the same frame ids, poses, images and semantics."""
    make_tum_fixture(str(tmp_path), n=5)
    with open(tmp_path / "rgb.txt", "a") as f:
        f.write("2000.0 rgb/none.png\n")
    ours, ref = tds.TUMReplay(str(tmp_path)), jds.TUMReplay(str(tmp_path))
    assert len(ours) == len(ref) == 5
    for a, b in zip(ours, ref):
        assert a.frame_id == b.frame_id
        for f in ("cam_T_world", "rgb", "depth", "ht", "lt"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


def test_quat_to_mat_matches_jax():
    rng = np.random.default_rng(2)
    for q in rng.normal(size=(20, 4)):
        np.testing.assert_array_equal(tds._quat_to_mat(*q), jds._quat_to_mat(*q))


class _Frames:
    """A replay of n integers that raises at index `fail` (if any) and
    records how far it was read."""

    def __init__(self, n, fail=None):
        self.n, self.fail, self.read = n, fail, 0

    def __len__(self):
        return self.n

    def __iter__(self):
        for i in range(self.n):
            if i == self.fail:
                raise ValueError(f"bad frame {i}")
            self.read = i + 1
            yield i


def test_prefetch_keeps_order_and_length():
    src = _Frames(50)
    pre = tds.PrefetchReplay(src, depth=2)
    assert len(pre) == 50 and list(pre) == list(range(50))


def test_prefetch_reraises_the_worker_error_in_order():
    got = []
    with pytest.raises(ValueError, match="bad frame 3"):
        for i in tds.PrefetchReplay(_Frames(10, fail=3), depth=2):
            got.append(i)
    assert got == [0, 1, 2]


def test_prefetch_early_exit_releases_the_worker():
    before = threading.active_count()
    src = _Frames(1000)
    for i in tds.PrefetchReplay(src, depth=2):
        if i == 1:
            break
    assert threading.active_count() == before
    assert src.read < 10  # the bounded queue held the worker back


def _corrupt(arrays, what):
    a = {k: np.array(v, copy=True) for k, v in arrays.items()}
    occ = np.flatnonzero(a["entry_block"] >= 0)
    blk = int(a["entry_block"][occ[0]])
    if what == "free_counter":
        a["num_free"] = np.asarray(-3, np.int32)
    elif what == "heap_duplicate":
        a["heap"][1] = a["heap"][0]
    elif what == "double_allocation":
        a["entry_block"][occ[1]] = a["entry_block"][occ[0]]
    elif what == "free_list_overlap":
        a["heap"][0] = blk
    elif what == "duplicate_coordinate":
        a["entry_key"][occ[1]] = a["entry_key"][occ[0]]
    elif what == "table":
        a["block_table"][np.flatnonzero(a["block_table"] >= 0)[0]] = -1
    elif what == "tsdf_nan":
        a["tsdf"][blk, 7] = np.nan
    elif what == "tsdf_range":
        a["tsdf"][blk, 7] = 1.5
    elif what == "weight":
        a["rgbw"][blk, 2] = np.uint32(41 << 24)
    elif what == "prob":
        a["prob"][blk, 3] = 1.5
    return a


@pytest.fixture(scope="module")
def fused_dense():
    """test_validate.py's fused dense volume, as numpy arrays."""
    return jax_arrays(_fused_volume(CFG_DENSE))


@pytest.mark.parametrize("what", [
    "healthy", "free_counter", "heap_duplicate", "double_allocation", "free_list_overlap",
    "duplicate_coordinate", "table", "tsdf_nan", "tsdf_range", "weight", "prob"])
def test_validate_messages_match_jax(fused_dense, what):
    """The same (corrupted) volume in both packages: the same list of
    violations, word for word, and the same raise."""
    arrays = _corrupt(fused_dense, what)
    ref = jval.validate_volume(
        JVolume(cfg=CFG_DENSE, **{k: jnp.asarray(v) for k, v in arrays.items()}), strict=False)
    vol_t = volume_from_numpy(arrays, port_cfg(CFG_DENSE), device="cpu")
    assert tval.validate_volume(vol_t, strict=False) == ref
    assert bool(ref) == (what != "healthy")
    if ref:
        with pytest.raises(tval.VolumeCorruptionError, match=ref[0].split(":")[0]):
            tval.validate_volume(vol_t)


def test_validate_healthy_hash_volume():
    vol_j = _fused_volume(CFG_HASH)
    vol_t = volume_from_numpy(jax_arrays(vol_j), port_cfg(CFG_HASH), device="cpu")
    assert tval.validate_volume(vol_t) == jval.validate_volume(vol_j) == []


W, H = 64, 48
K = (52.7, 53.3, 31.71, 23.43)


@pytest.fixture(scope="module")
def tum_drive(tmp_path_factory):
    """A TUM sequence of a camera sliding 4.5 m along a wall 2 m ahead,
    and its camera YAML."""
    d = tmp_path_factory.mktemp("tum_drive")
    os.makedirs(d / "rgb")
    os.makedirs(d / "depth")
    lines = {"rgb.txt": [], "depth.txt": [], "groundtruth.txt": []}
    for i, x in enumerate(np.arange(0.0, 4.6, 0.3)):
        t = 100.0 + 0.033 * i
        pose = look_at((x, 0.0, 0.0), (x, 0.0, 2.0))
        write_image(str(d / "rgb" / f"{t:.4f}.png"), checker_rgb(W, H).astype(np.uint8))
        depth = render_wall(W, H, K, pose, wall_z=2.0131)
        write_image(str(d / "depth" / f"{t:.4f}.png"), (depth * 5000).astype(np.uint16))
        lines["rgb.txt"].append(f"{t:.4f} rgb/{t:.4f}.png")
        lines["depth.txt"].append(f"{t:.4f} depth/{t:.4f}.png")
        # world_T_cam: the camera at (x, 0, 0), turned 180 degrees about z
        lines["groundtruth.txt"].append(f"{t:.4f} {x:.4f} 0 0 0 0 1 0")
    for name, rows in lines.items():
        (d / name).write_text("# header\n" + "\n".join(rows) + "\n")
    (d / "cam.yaml").write_text(
        "Camera.fx: 52.7\nCamera.fy: 53.3\nCamera.cx: 31.71\nCamera.cy: 23.43\n"
        "Camera.rows: 48\nCamera.cols: 64\ndepthmap_factor: 5000.0\n")
    return str(d)


def test_offline_app_tum_prefetch_debug_spill_page(tum_drive, tmp_path):
    """The offline app's host flags together on a TUM drive: every frame
    fused and validated, the window moved, blocks spilled, and the dump
    with the store's records appended covers every block the volume and
    the store hold."""
    save = str(tmp_path / "data.bin")
    res = offline.main([
        "--logdir", tum_drive, "--config", os.path.join(tum_drive, "cam.yaml"), "--tum",
        "--prefetch", "2", "--debug", "--spill", "--page-radius", "1.0", "--auto-recenter",
        "--preset", "small", "--grid-log2", "4", "--voxel", "0.05", "--trunc", "0.15",
        "--max-depth", "4.0", "--device", "cpu", "--save", save,
    ])
    grid = res["grid"]
    assert res["frames"] == res["validated"] == 16
    assert res["recenter_frames"] and len(grid.spill_store) > 0
    assert res["spilled_records"] == len(grid.spill_store) * grid.cfg.block_volume
    rec = load_spatial_tsdf(save)
    assert rec.shape[0] == res["records"] + res["spilled_records"]
    vsz = grid.cfg.voxel_size
    blocks = {tuple(b) for b in np.floor(np.round(rec[:, :3] / vsz) / 8).astype(int)}
    vol = grid.volume
    live = (vol.entry_block >= 0).numpy()
    on_card = {tuple(int(c) for c in p) for p in vol.entry_pos.numpy()[live]}
    stored = set(grid.spill_store._store)
    assert on_card and on_card.isdisjoint(stored)
    assert blocks == on_card | stored


# ----------------------------------------------------------------------
# stereo capture: the ZED factory calibration and the stereo replay
# ----------------------------------------------------------------------
def test_zed_factory_conf_matches_jax(tmp_path):
    """Both packages parse the same K/D/R/T/size, with the reference's
    quirks (baseline negated mm->m, the pitch under CV_, missing keys 0),
    and both refuse an unknown resolution."""
    from disinfect_slam_tpu.io import zed_calib as jzc
    from disinfect_slam_tpu_torch.io import zed_calib as tzc

    conf = tmp_path / "SN12345.conf"
    conf.write_text(ZED_FACTORY_CONF)
    ours, ref = tzc.parse_factory_conf(str(conf), "VGA"), jzc.parse_factory_conf(str(conf), "VGA")
    for f in ref._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ours, f)), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    np.testing.assert_allclose(ours.T, [-0.119887, 0.05e-3, -0.21e-3])
    assert ours.D_l[4] == 0.0 and ours.D_r[2] == 0.0002 and ours.size == (672, 376)
    for mod in (tzc, jzc):
        with pytest.raises(ValueError):
            mod.parse_factory_conf(str(conf), "8K")


def test_rectifier_from_factory_conf_matches_jax(tmp_path):
    """The rectifier of the factory calibration (t_x < 0): maps within
    1e-2 px of the JAX package's (its cv2 branch here), rectified
    intrinsics within 1e-6 relative, and a rectified pair of the image
    size."""
    pytest.importorskip("cv2")
    from disinfect_slam_tpu.io import zed_calib as jzc
    from disinfect_slam_tpu_torch.io import zed_calib as tzc

    conf = tmp_path / "SN12345.conf"
    conf.write_text(ZED_FACTORY_CONF)
    ours = tzc.rectifier_from_factory_conf(str(conf), "VGA", device="cpu")
    ref = jzc.rectifier_from_factory_conf(str(conf), "VGA")
    for a, b in zip(ours.maps[:4], ref.maps[:4]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-2)
    np.testing.assert_allclose(ours.rectified_intrinsics(), ref.rectified_intrinsics(),
                               rtol=1e-6)
    img = np.random.default_rng(0).integers(0, 255, (376, 672), np.uint8)
    left, right = ours.rectify(img.astype(np.float32), img.astype(np.float32))
    assert left.shape == right.shape == (376, 672)


@pytest.mark.parametrize("with_poses", [True, False])
def test_logged_stereo_replay_matches_jax(tmp_path, with_poses):
    """A StereoFrameLogger logdir (u8 RGB and gray pairs; poses for some
    frames, or none) read by both packages: the same ids, poses (None
    where the trajectory has no row) and float32 images."""
    from disinfect_slam_tpu_torch.io.logger import StereoFrameLogger

    rng = np.random.default_rng(4)
    log = StereoFrameLogger(str(tmp_path))
    for fid in (0, 3, 7, 12):
        shape = (24, 32, 3) if fid % 2 == 0 else (24, 32)
        left, right = (rng.integers(0, 255, shape).astype(np.uint8) for _ in range(2))
        pose = look_at((0.1 * fid, 0.0, -1.0), (0.0, 0.0, 1.0)) if with_poses and fid != 7 else None
        log.log_data((fid, left, right, pose))
        log.flush()
    log.close()
    ours, ref = tds.LoggedStereoReplay(str(tmp_path)), jds.LoggedStereoReplay(str(tmp_path))
    assert len(ours) == len(ref) == 4
    for (fa, pa), (fb, pb) in zip(ours.entries, ref.entries):
        assert fa == fb and (pa is None) == (pb is None) == (not with_poses or fa == 7)
        if pa is not None:
            np.testing.assert_array_equal(pa, pb)
    for a, b in zip(ours, ref):
        assert a.frame_id == b.frame_id
        for f in ("left", "right"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype == np.float32 and x.shape == (24, 32, 3), f
            np.testing.assert_array_equal(x, y, err_msg=f)
