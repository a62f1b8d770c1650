"""PyTorch port, export: the dump loader (volume_from_spatial_records,
infer_voxel_size) against the JAX package bit for bit, the bridge's bbox
mesh query (tests/test_bridge.py on the port), the offline CLI's --mesh,
--mesh-q16, --grid-log2 and --auto-recenter, the tsdf2mesh CLI, the
checkpoint layouts of older versions, and TSDFGrid.integrate's DEBUG
lines."""

import dataclasses
import logging
import os
import time

import numpy as np
import pytest
import torch

from disinfect_slam_tpu.io.logger import FrameLogger
from disinfect_slam_tpu.ops import gather as jgather
from disinfect_slam_tpu.ops import mesh as jmesh
from disinfect_slam_tpu_torch.apps import offline, tsdf2mesh
from disinfect_slam_tpu_torch.config import TSDFConfig
from disinfect_slam_tpu_torch.io.checkpoint import load_volume
from disinfect_slam_tpu_torch.ops import gather as tgather
from disinfect_slam_tpu_torch.ops import mesh as tmesh
from disinfect_slam_tpu_torch.ops.gather import BoundingCube
from disinfect_slam_tpu_torch.systems.bridge import ReconstructionBridge
from disinfect_slam_tpu_torch.systems.disinf_system import DISINFSystem
from disinfect_slam_tpu_torch.systems.tsdf_grid import TSDFGrid

from . import test_extent as ext
from .scenes import look_at, render_wall
from .test_integrate import CFG_DENSE, H, K, W
from .test_torch_hash import FIELDS, jax_arrays, port_arrays, port_cfg
from .test_torch_integrate import _run_jax, _scene
from .test_torch_offline import tiny_dataset  # noqa: F401  (fixture)

torch.set_num_threads(1)

CLI = ["--preset", "small", "--voxel", "0.05", "--trunc", "0.15", "--max-depth", "4.0",
       "--device", "cpu"]


@pytest.fixture(scope="module")
def records():
    """Dump records of the wall scene fused by the JAX package (dense),
    shuffled: the loader must not rely on the dump's order."""
    vol = _run_jax(_scene("wall", 3), dataclasses.replace(CFG_DENSE, sampler="gather"))
    rec = jgather.to_numpy_records(jgather.gather_valid(vol))
    return rec[np.random.default_rng(0).permutation(len(rec))]


def test_infer_voxel_size_matches_jax(records):
    for rec in (records, records * np.float32(0.08)):
        assert tgather.infer_voxel_size(rec) == jgather.infer_voxel_size(rec)
    with pytest.raises(ValueError):
        tgather.infer_voxel_size(records[:1])


@pytest.mark.parametrize("reach", [600, 1 << 22], ids=["packed", "row_unique"])
def test_unique_rows_is_np_unique_by_rows(reach):
    rng = np.random.default_rng(1)
    blocks = rng.integers(-reach, reach, (5000, 3)).astype(np.int32)
    blocks[2500:] = blocks[:2500][rng.permutation(2500)]
    rows, inv = tgather.unique_rows(blocks)
    ref, ref_inv = np.unique(blocks, axis=0, return_inverse=True)
    assert rows.dtype == np.int32
    np.testing.assert_array_equal(rows, ref)
    np.testing.assert_array_equal(inv, ref_inv.reshape(-1))


@pytest.mark.parametrize("voxel", [None, 0.05])
def test_volume_from_records_matches_jax(records, voxel):
    """Config, index, heap and every payload field bit for bit; a
    gather_valid of the rebuilt volume gives the records back as a set."""
    ours = tgather.volume_from_spatial_records(records, voxel_size=voxel, device="cpu")
    ref = jgather.volume_from_spatial_records(records, voxel_size=voxel)
    assert dataclasses.asdict(ours.cfg) == dataclasses.asdict(ref.cfg)
    a, b = port_arrays(ours), jax_arrays(ref)
    for f in FIELDS:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    back = tgather.to_numpy_records(tgather.gather_valid(ours))
    assert back.shape == records.shape
    if voxel is not None:
        assert set(map(bytes, back)) == set(map(bytes, records))
    # the inferred voxel size is 1e-6 relative off 5 cm, which moves the
    # positions by as much (< 1e-5 m here): the same voxels, taken in
    # voxel-grid order, with the same tsdf
    a, b = (r[np.lexsort(np.rint(r[:, :3] / 0.05).T)] for r in (back, records))
    np.testing.assert_array_equal(a[:, 3], b[:, 3])
    np.testing.assert_allclose(a[:, :3], b[:, :3], rtol=0, atol=1e-5)


# ----------------------------------------------------------------------
# the bridge: tests/test_bridge.py on the port
# ----------------------------------------------------------------------
def _bridge_system():
    return DISINFSystem(K, depth_factor=1.0, voxel_size=0.05, truncation=0.15,
                        cfg=port_cfg(CFG_DENSE), half_scale=False, device="cpu")


def test_bridge_callbacks():
    pose = look_at((0.01, 0.02, -0.01), (0.04, -0.03, 2.0))
    depth = render_wall(W, H, K, pose, wall_z=2.0131)
    rgb = np.full((H, W, 3), 120, np.float32)
    meshes, poses = [], []
    with _bridge_system() as system:
        system.feed_pose(0, pose)
        for i in range(3):
            system.feed_rgbd_frame(rgb, depth, i * 33)
        system.tsdf.flush()
        bridge = ReconstructionBridge(
            system, BoundingCube(-3, 3, -3, 3, 0, 4),
            mesh_callback=lambda v, f: meshes.append((v, f)),
            pose_callback=poses.append, mesh_period=0.3, pose_period=0.05)
        with bridge:
            bridge.notify_frame(66)
            deadline = time.time() + 60
            while time.time() < deadline and (len(meshes) < 1 or len(poses) < 3):
                time.sleep(0.1)
        # the query filters by triangle centroid: a box around half the
        # wall keeps fewer faces, all of them inside it
        half = ReconstructionBridge(system, BoundingCube(-3, 0.0, -3, 3, 0, 4)).query_mesh()
    assert len(poses) >= 3
    np.testing.assert_allclose(poses[-1], np.linalg.inv(pose), atol=1e-5)
    assert len(meshes) >= 1
    verts, faces = meshes[-1]
    assert len(verts) > 50 and len(faces) > 50
    assert abs(np.median(verts[:, 2]) - 2.0131) < 0.1
    assert 0 < len(half[1]) < len(faces)
    assert (half[0][half[1]].mean(axis=1)[:, 0] <= 0.0).all()


def test_bridge_budget_warning(caplog):
    pose = look_at((0.01, 0.02, -0.01), (0.04, -0.03, 2.0))
    depth = render_wall(W, H, K, pose, wall_z=2.0131)
    rgb = np.full((H, W, 3), 120, np.float32)
    with _bridge_system() as system:
        system.feed_pose(0, pose)
        system.feed_rgbd_frame(rgb, depth, 0)
        system.tsdf.flush()
        bridge = ReconstructionBridge(
            system, BoundingCube(-3, 3, -3, 3, 0, 4),
            mesh_callback=lambda v, f: time.sleep(0.05),
            mesh_period=0.01, pose_period=0.5)  # every cycle overruns
        with caplog.at_level(logging.WARNING,
                             logger="disinfect_slam_tpu_torch.systems.bridge"):
            with bridge:
                deadline = time.time() + 60
                while time.time() < deadline and not any(
                        "budget" in r.message for r in caplog.records):
                    time.sleep(0.05)
    assert any("budget" in r.message for r in caplog.records)


# ----------------------------------------------------------------------
# the CLIs
# ----------------------------------------------------------------------
def test_offline_mesh_flags(tiny_dataset, tmp_path):  # noqa: F811
    """--mesh writes the OBJ of the fused volume's mesh (f32 and q16),
    with --grid-log2 setting the window."""
    paths = {q: str(tmp_path / f"{q}.obj") for q in ("f32", "q16")}
    res = offline.main(["--logdir", tiny_dataset, "--config",
                        os.path.join(tiny_dataset, "cam.yaml"), *CLI, "--mesh", paths["f32"],
                        "--grid-log2", "6", "--save", str(tmp_path / "data.bin")])
    assert res["grid"].cfg.grid_log2 == 6 and res["mesh"]["ms"] > 0
    verts, faces = tmesh.merge_vertices(tmesh.extract_mesh_chunked(res["grid"].volume))
    assert (res["mesh"]["vertices"], res["mesh"]["faces"]) == (len(verts), len(faces)) != (0, 0)
    lines = open(paths["f32"]).read().splitlines()
    assert sum(ln.startswith("v ") for ln in lines) == len(verts)
    res_q = offline.main(["--logdir", tiny_dataset, "--config",
                          os.path.join(tiny_dataset, "cam.yaml"), *CLI, "--mesh", paths["q16"],
                          "--mesh-q16"])
    assert abs(res_q["mesh"]["faces"] - len(faces)) <= 0.01 * len(faces)


def test_tsdf2mesh_cli_matches_jax(tiny_dataset, tmp_path):  # noqa: F811
    """data.bin from the offline CLI through tsdf2mesh: PLY (with rgb and
    ht probability) and OBJ; the mesh within 0.1% of the JAX package's
    pipeline on the same dump (XLA contracts its jitted interpolation)."""
    dump = str(tmp_path / "data.bin")
    offline.main(["--logdir", tiny_dataset, "--config", os.path.join(tiny_dataset, "cam.yaml"),
                  *CLI, "--save", dump])
    ply, obj = str(tmp_path / "out.ply"), str(tmp_path / "out.obj")
    res = tsdf2mesh.main([dump, ply, "--device", "cpu"])
    res_obj = tsdf2mesh.main([dump, obj, "--device", "cpu", "--q16", "--voxel", "0.05"])
    rec = jgather.load_spatial_tsdf(dump)
    vol_j = jgather.volume_from_spatial_records(rec)
    verts_j, faces_j = jmesh.merge_vertices(jmesh.extract_mesh_chunked(vol_j))
    assert res["records"] == rec.shape[0] and res["blocks"] == int(vol_j.num_active_blocks)
    assert abs(res["vertices"] - len(verts_j)) <= 1e-3 * len(verts_j)
    assert abs(res["faces"] - len(faces_j)) <= 1e-3 * len(faces_j)
    head = open(ply, "rb").read(400).split(b"end_header")[0].decode()
    assert f"element vertex {res['vertices']}" in head and "ht_probability" in head
    assert "property uchar red" in head
    assert abs(res_obj["faces"] - res["faces"]) <= 0.01 * res["faces"]


@pytest.fixture(scope="module")
def corridor_dataset(tmp_path_factory):
    """tests/test_extent.py's corridor (12 frames marching +z before a
    wall) as a logged replay."""
    d = tmp_path_factory.mktemp("corridor")
    log = FrameLogger(str(d), depth_factor=5000.0)
    for i, (pose, rgb, depth) in enumerate(ext._corridor_frames(12, spacing=0.5)):
        log.log_data((i, rgb, depth, pose))
    log.close()
    fx, fy, cx, cy = ext.K
    (d / "cam.yaml").write_text(
        f"Camera.fx: {fx}\nCamera.fy: {fy}\nCamera.cx: {cx}\nCamera.cy: {cy}\n"
        f"Camera.rows: {ext.H}\nCamera.cols: {ext.W}\ndepthmap_factor: 5000.0\n")
    return str(d)


def test_offline_auto_recenter_maps_the_corridor(corridor_dataset):
    """A 16-block window (6.4 m) centred at the start truncates the
    corridor; with --auto-recenter it moves and maps the far walls."""
    argv = ["--logdir", corridor_dataset, "--config",
            os.path.join(corridor_dataset, "cam.yaml"), "--preset", "small", "--voxel",
            str(ext.VOXEL), "--trunc", str(ext.TRUNC), "--max-depth", "4.0",
            "--grid-log2", "4", "--device", "cpu"]
    fixed = offline.main(argv)
    moved = offline.main(argv + ["--auto-recenter"])
    assert fixed["recenter_frames"] == [] and int(fixed["grid"].volume.oob_count) > 0
    assert len(moved["recenter_frames"]) >= 1
    z = [tgather.to_numpy_records(r["grid"].gather_valid())[:, 2].max() for r in (fixed, moved)]
    assert z[1] > z[0] + 1.0 and z[1] > 6.5


# ----------------------------------------------------------------------
# checkpoints of older layouts, and DEBUG observability
# ----------------------------------------------------------------------
@pytest.mark.parametrize("layout", ["entry_pos", "no_oob_count", "weight_rgb"])
def test_older_checkpoint_layouts_load_in_both_packages(tmp_path, layout):
    from disinfect_slam_tpu.io.checkpoint import load_volume as j_load

    vol = _run_jax(_scene("sphere", 2), dataclasses.replace(CFG_DENSE, sampler="gather"))
    arrays = jax_arrays(vol)
    arrays["oob_count"] = np.asarray(7, np.int32)
    if layout == "entry_pos":
        arrays["entry_pos"] = np.asarray(vol.entry_pos)
        del arrays["entry_key"]
    elif layout == "no_oob_count":
        del arrays["oob_count"]
    else:
        rgbw = arrays.pop("rgbw")
        arrays["weight"] = (rgbw >> 24).astype(np.float32)
        arrays["rgb"] = np.stack([(rgbw >> s) & 0xFF for s in (0, 8, 16)], -1).astype(np.uint8)
    import json

    arrays["__config__"] = np.frombuffer(json.dumps(dataclasses.asdict(vol.cfg)).encode(),
                                         np.uint8)
    path = str(tmp_path / "old.npz")
    np.savez_compressed(path, **arrays)
    ours, ref = port_arrays(load_volume(path, device="cpu")), jax_arrays(j_load(path))
    for f in FIELDS:
        np.testing.assert_array_equal(ours[f], ref[f], err_msg=f)


def test_debug_logs_counts_and_leaves_the_volume_bit_equal(caplog):
    cfg = TSDFConfig(num_blocks_log2=10, max_candidates=2048, max_visible=1024,
                     max_new_per_round=512, grid_log2=6, alloc_every=2)
    frames = _scene("sphere", 3)
    grids = [TSDFGrid(0.05, 0.15, cfg=cfg, device="cpu") for _ in range(2)]
    name = "disinfect_slam_tpu_torch.tsdf_grid"
    for g, level in zip(grids, (logging.INFO, logging.DEBUG)):
        with caplog.at_level(level, name):
            for rgb, depth, ht, lt, pose in frames:
                g.integrate(rgb, depth, ht, lt, 4.0, K, pose)
    msgs = [r.getMessage() for r in caplog.records if r.name == name]
    for what in ("pre integrate", "visible blocks", "post integrate"):
        assert sum(what in m for m in msgs) == len(frames), what
    assert int(msgs[1].split(": ")[1]) > 0  # the first frame's visible count
    a, b = (port_arrays(g.volume) for g in grids)
    for f in FIELDS:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
