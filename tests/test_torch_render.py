"""PyTorch port, rendering: payload packing and image assembly, the splat
renderer against the JAX package's XLA and Pallas (interpret mode)
splats, the parity raycaster against the JAX raycaster, the port's
splat-versus-raycast divergence, TSDFGrid.ray_cast's renderers and the
offline CLI's --render-dir.

The JAX volumes are carried into the port with
io/checkpoint.volume_from_numpy, so both renderers see the same volume
and the comparisons isolate rendering from fusion.  The JAX renderers run
op by op (not under jit), as the port does, so where no fused
multiply-add can intervene the results are asserted equal."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from disinfect_slam_tpu.core.geometry import SE3 as JSE3
from disinfect_slam_tpu.core.geometry import CameraIntrinsics as JIntr
from disinfect_slam_tpu.core.geometry import CameraParams as JCam
from disinfect_slam_tpu.core.state import TSDFVolume as JVolume
from disinfect_slam_tpu.io.png_io import _encode_png_stdlib
from disinfect_slam_tpu.ops import render_fast as jrf
from disinfect_slam_tpu.ops.pallas.splat_kernel import splat_render_pallas
from disinfect_slam_tpu.ops.raycast import raycast as j_raycast
from disinfect_slam_tpu_torch.apps import offline
from disinfect_slam_tpu_torch.config import TSDFConfig
from disinfect_slam_tpu_torch.core.geometry import SE3, CameraIntrinsics, CameraParams
from disinfect_slam_tpu_torch.io.dataset import LoggedReplay
from disinfect_slam_tpu_torch.io.png_io import encode_png, read_png, write_image
from disinfect_slam_tpu_torch.ops import render_fast as rf
from disinfect_slam_tpu_torch.ops.cuda import splat_kernel as sk
from disinfect_slam_tpu_torch.ops.raycast import raycast
from disinfect_slam_tpu_torch.systems.tsdf_grid import TSDFGrid

from . import test_render_divergence as div
from .scenes import checker_rgb, look_at, render_sphere, render_wall
from .test_integrate import CFG_DENSE, H, K, MAX_DEPTH, W
from .test_splat_kernel import _fused_scene
from .test_torch_hash import port_from_jax
from .test_torch_offline import tiny_dataset  # noqa: F401  (fixture)

torch.set_num_threads(1)

EYES = {"normal": (0.21, -0.33, -0.27), "close": (0.05, 0.1, 0.55)}
CAM = CameraParams.create(CameraIntrinsics.create(*K), H, W)
JCAM = JCam.create(JIntr.create(*K), H, W)


@pytest.fixture(scope="module")
def scenes():
    """test_splat_kernel's sphere-and-wall scene, fused by the JAX
    package, for both eyes: (JAX volume, port volume, pose)."""
    out = {}
    for name, eye in EYES.items():
        vol_j, _, pose = _fused_scene(eye)
        out[name] = (vol_j, port_from_jax(vol_j), pose)
    return out


def _assert_images_equal(ours, ref, fields=("hit", "depth", "rgba", "normal")):
    for f in fields:
        np.testing.assert_array_equal(getattr(ours, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)


def test_payload_packing_matches_jax():
    rng = np.random.default_rng(0)
    n = 4096
    rgbw = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    prob = rng.uniform(0, 1, n).astype(np.float32)
    prob[:64], prob[64:128], prob[128:192] = 0.0, 1.0, 0.5
    ours = rf.pack_payload_rgbw(torch.from_numpy(rgbw.view(np.int32)),
                                torch.from_numpy(prob)).numpy()
    ref = np.asarray(jrf.pack_payload_rgbw(jnp.asarray(rgbw), jnp.asarray(prob)))
    np.testing.assert_array_equal(ours, ref.astype(np.int64))
    assert (ours >= 1 << 31).any()  # words with the top bit set stay positive
    rgb = rng.uniform(-20, 280, (n, 3)).astype(np.float32)
    prob2 = rng.uniform(-0.1, 1.1, n).astype(np.float32)
    np.testing.assert_array_equal(
        rf.pack_payload(torch.from_numpy(rgb), torch.from_numpy(prob2)).numpy(),
        np.asarray(jrf.pack_payload(jnp.asarray(rgb), jnp.asarray(prob2))).astype(np.int64))


def test_images_from_buffers_matches_jax():
    """Random buffers: empty pixels, probability bytes of 0, 255 and with
    the top bit set.  hit, depth and rgba are the same float32 operations:
    equal.  The normal shading within 2 u8, the bound JAX's own
    test_splat_kernel allows between two of its programs."""
    rng = np.random.default_rng(1)
    zbuf = rng.integers(int(0.3 * 4096), 4 * 4096, H * W).astype(np.int32)
    zbuf[rng.uniform(size=H * W) < 0.2] = rf.BIG
    p8 = rng.integers(0, 256, H * W).astype(np.uint32)
    p8[:100], p8[100:200] = 0, 255
    pbuf = (p8 << 24) | rng.integers(0, 1 << 24, H * W).astype(np.uint32)
    pbuf[zbuf == rf.BIG] = 0
    ours = rf.images_from_buffers(torch.from_numpy(zbuf),
                                  torch.from_numpy(pbuf.view(np.int32)), CAM)
    ref = jrf.images_from_buffers(jnp.asarray(zbuf), jnp.asarray(pbuf), JCAM)
    _assert_images_equal(ours, ref, ("hit", "depth", "rgba"))
    nd = np.abs(ours.normal.numpy().astype(int) - np.asarray(ref.normal).astype(int))
    assert nd.max() <= 2, nd.max()
    assert ours.hit.any() and not ours.hit.all()


@pytest.mark.parametrize("eye", list(EYES))
def test_splat_render_matches_jax_xla_and_pallas(scenes, eye):
    """The plain port splat, and the kernels' path (their plain versions
    on the CPU), against JAX's XLA splat and its Pallas splat in
    interpret mode with the default and the narrow (16x16) patch; `close`
    overflows the TPU patch into its fallback scatter.  All four images
    equal (the two JAX programs agree bit for bit on these scenes)."""
    vol_j, vol_t, pose = scenes[eye]
    pj, pt = JSE3.from_matrix(pose), SE3.from_matrix(pose)
    ours = rf.splat_render(vol_t, CAM, pt, MAX_DEPTH)
    assert int(ours.surf_overflow) == 0
    _assert_images_equal(ours, jrf.splat_render(vol_j, JCAM, pj, MAX_DEPTH))
    _assert_images_equal(ours, splat_render_pallas(vol_j, JCAM, pj, MAX_DEPTH,
                                                   interpret=True))
    _assert_images_equal(ours, splat_render_pallas(vol_j, JCAM, pj, MAX_DEPTH,
                                                   interpret=True, cw=16, ch=16))
    # the kernels' path: the TPU layout knobs are accepted and ignored
    _assert_images_equal(ours, sk.splat_render_cuda(vol_t, CAM, pt, MAX_DEPTH,
                                                    cw=16, ch=16))
    depth, hit = sk.splat_depth(vol_t, CAM, pt, MAX_DEPTH)
    assert torch.equal(depth, ours.depth) and torch.equal(hit, ours.hit)
    assert ours.hit.float().mean() > 0.05


def test_empty_volume_renders_nothing():
    vol = port_from_jax(JVolume.create(CFG_DENSE))
    for res in (rf.splat_render(vol, CAM, SE3.identity(), MAX_DEPTH),
                sk.splat_render_cuda(vol, CAM, SE3.identity(), MAX_DEPTH),
                raycast(vol, CAM, SE3.identity(), MAX_DEPTH)):
        assert not res.hit.any()
        assert res.depth.sum() == 0 and res.rgba.sum() == 0 and res.normal.sum() == 0


def test_surf_cap_overflow_matches_jax(scenes):
    """With a cap below the scene's surface-block count, the same blocks
    are dropped (entry order), surf_overflow agrees and so do the images."""
    vol_j, vol_t, pose = scenes["normal"]
    pj, pt = JSE3.from_matrix(pose), SE3.from_matrix(pose)
    _, n_kept = rf.splat_buffers(vol_t, CAM, pt, MAX_DEPTH)[2:]
    cap = int(n_kept) // 2
    ref = jrf.splat_render(vol_j, JCAM, pj, MAX_DEPTH, surf_cap=cap)
    for ours in (rf.splat_render(vol_t, CAM, pt, MAX_DEPTH, surf_cap=cap),
                 sk.splat_render_cuda(vol_t, CAM, pt, MAX_DEPTH, surf_cap=cap)):
        assert int(ours.surf_overflow) == int(ref.surf_overflow) == int(n_kept) - cap
        _assert_images_equal(ours, ref)
    # no filter at all (surf_cap=None) renders what the default cap does
    _assert_images_equal(rf.splat_render(vol_t, CAM, pt, MAX_DEPTH, surf_cap=None),
                         jrf.splat_render(vol_j, JCAM, pj, MAX_DEPTH))


@pytest.mark.parametrize("skip", [True, False], ids=["skip", "no_skip"])
def test_raycast_matches_jax(scenes, skip):
    """Hit mask and rgba equal; depth within 1e-6 relative and normal
    shading equal on all but 0.5% of pixels (measured: 1 of 3072).  XLA
    contracts the JAX raycaster's cross products and norms into fused
    multiply-adds, so ray directions differ by an ulp, which can move a
    refined crossing into a neighbouring voxel."""
    vol_j, vol_t, pose = scenes["normal"]
    vol_j = dataclasses.replace(vol_j, cfg=dataclasses.replace(vol_j.cfg, raycast_skip=skip))
    vol_t = dataclasses.replace(vol_t, cfg=dataclasses.replace(vol_t.cfg, raycast_skip=skip))
    ours = raycast(vol_t, CAM, SE3.from_matrix(pose), MAX_DEPTH)
    ref = j_raycast(vol_j, JCAM, JSE3.from_matrix(pose), MAX_DEPTH)
    _assert_images_equal(ours, ref, ("hit", "rgba"))
    np.testing.assert_allclose(ours.depth.numpy(), np.asarray(ref.depth), rtol=1e-6, atol=0)
    nd = (ours.normal.numpy() != np.asarray(ref.normal)).any(-1)
    assert nd.mean() <= 0.005, nd.mean()
    assert ours.hit.float().mean() > 0.5
    assert ours.surf_overflow is None


@pytest.fixture(scope="module")
def port_grid():
    """test_render_divergence's scene (sphere before a wall, 8 frames of a
    partial orbit) fused by the port itself on the CPU."""
    cfg = TSDFConfig(voxel_size=div.VOXEL, truncation=div.TRUNC, num_blocks_log2=12,
                     max_candidates=8192, max_visible=4096, max_new_per_round=2048,
                     backend="dense", grid_log2=6)
    grid = TSDFGrid(div.VOXEL, div.TRUNC, cfg=cfg, device="cpu")
    rgb = checker_rgb(div.W, div.H)
    poses = []
    for i in range(8):
        ang = 2 * np.pi * i / 8 * 0.15
        pose = look_at((np.sin(ang) * 1.8, 0.0, 1.0 - 1.8 * np.cos(ang)),
                       (0.0, 0.0, 1.0)).astype(np.float32)
        d_s = render_sphere(div.W, div.H, div.K, pose, center=(0.0, 0.0, 1.0), radius=0.4)
        d_w = render_wall(div.W, div.H, div.K, pose, wall_z=2.2)
        grid.integrate(rgb, np.where(d_s > 0, d_s, d_w).astype(np.float32),
                       None, None, 4.0, div.K, pose)
        poses.append(pose)
    return grid, poses


def test_port_splat_within_bounds_of_port_raycast(port_grid):
    """test_render_divergence.py's limits, held by the port's splat
    against the port's raycaster: holes < 0.5% of raycast hits, p95 depth
    error < 1 voxel, > 2 voxel disagreement on < 3% of pixels with at
    least 85% of it on silhouettes, median semantic difference <= 16."""
    grid, poses = port_grid
    cam = (div.K, div.H, div.W)
    for i, pose in enumerate(poses[:3]):
        ray = grid.ray_cast(4.0, cam, pose, renderer="raycast")
        spl = grid.ray_cast(4.0, cam, pose, renderer="splat")
        d = rf.render_divergence(ray, spl, div.K, div.VOXEL)
        assert d["holes"] < 0.005, d
        assert np.percentile(d["depth_err"], 95) < 1.0 * div.VOXEL, d
        assert d["bad"] < 0.03 and d["on_edge"] > 0.85, d
        if i == 0:
            assert (d["rgba_median"] <= 16).all(), d
            assert ray.hit.float().mean() > 0.3


@pytest.mark.parametrize("renderer", ["raycast", "splat", "splat_pallas", "auto"])
def test_ray_cast_renderers_on_the_cpu(port_grid, renderer):
    """Every renderer name works on the CPU without launching a kernel:
    the splat names run the kernels' plain versions (equal to the plain
    splat), and auto is the raycaster there."""
    grid, poses = port_grid
    before = (sk.splat_zbuf_blocks.launches, sk.splat_payload_blocks.launches)
    res = grid.ray_cast(4.0, (div.K, div.H, div.W), poses[1], renderer=renderer)
    assert (sk.splat_zbuf_blocks.launches, sk.splat_payload_blocks.launches) == before
    vol, pose = grid.volume, SE3.from_matrix(poses[1])
    cam = CameraParams.create(CameraIntrinsics.create(*div.K), div.H, div.W)
    if renderer in ("raycast", "auto"):
        ref = raycast(vol, cam, pose, 4.0)
    else:
        ref = rf.splat_render(vol, cam, pose, 4.0)
    for f in ("hit", "depth", "rgba", "normal"):
        assert torch.equal(getattr(res, f), getattr(ref, f)), f
    assert res.hit.any()


def test_ray_cast_rejects_an_unknown_renderer(port_grid):
    grid, poses = port_grid
    with pytest.raises(ValueError, match="renderer"):
        grid.ray_cast(4.0, (div.K, div.H, div.W), poses[0], renderer="fast")


@pytest.mark.parametrize("renderer", ["auto", "splat"])
def test_offline_cli_renders_the_final_view(tiny_dataset, tmp_path, renderer):  # noqa: F811
    res = offline.main([
        "--logdir", tiny_dataset, "--config", os.path.join(tiny_dataset, "cam.yaml"),
        "--preset", "small", "--voxel", "0.05", "--trunc", "0.15",
        "--max-depth", "4.0", "--device", "cpu",
        "--render-dir", str(tmp_path / "render"), "--renderer", renderer,
    ])
    assert res["render_ms"] > 0
    rgba_path, normal_path = res["render_paths"]
    assert os.path.basename(rgba_path) == "final_rgba.png"
    for path in (rgba_path, normal_path):
        img = read_png(path)
        assert img.shape == (360, 640, 4) and img.dtype == np.uint8
    # the PNGs hold the render of the last pose at the run's max depth
    # (the 160x120 camera's intrinsics put the wall in the top-left part
    # of the 640x360 view)
    pose = list(LoggedReplay(tiny_dataset, 5000.0))[-1].cam_T_world
    ref = res["grid"].ray_cast(4.0, ((121.3, 119.7, 79.21, 59.63), 360, 640),
                               pose, renderer=renderer)
    np.testing.assert_array_equal(read_png(rgba_path), ref.rgba.numpy())
    np.testing.assert_array_equal(read_png(normal_path), ref.normal.numpy())
    assert ref.hit.float().mean() > 0.01


@pytest.mark.parametrize("shape", [(9, 13), (9, 13, 3), (9, 13, 4)])
def test_encode_png_matches_the_jax_stdlib_encoder(shape, tmp_path):
    img = np.random.default_rng(5).integers(0, 256, shape).astype(np.uint8)
    assert encode_png(img) == _encode_png_stdlib(img)
    write_image(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(read_png(str(tmp_path / "a.png")), img)


def test_write_image_16bit_gray_reads_back_in_pillow(tmp_path):
    img = np.random.default_rng(6).integers(0, 1 << 16, (11, 7)).astype(np.uint16)
    path = str(tmp_path / "d.png")
    write_image(path, img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(read_png(path), img)
    with pytest.raises(ValueError):
        encode_png(img.astype(np.float32))
