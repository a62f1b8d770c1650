"""PyTorch port, the offline slice around the kernels: PNG decoding,
camera YAML, the offline CLI against the JAX engine on a tiny logged
dataset, the JAX-free import guarantee and the device check."""

import dataclasses
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from disinfect_slam_tpu.config import TSDFConfig as JConfig
from disinfect_slam_tpu.io import config_reader as j_yaml
from disinfect_slam_tpu.io.dataset import LoggedReplay as JReplay
from disinfect_slam_tpu.io.logger import FrameLogger
from disinfect_slam_tpu.io.png_io import read_image as j_read_image
from disinfect_slam_tpu.ops.gather import dump_spatial_tsdf as j_dump
from disinfect_slam_tpu.systems.tsdf_grid import TSDFGrid as JGrid
from disinfect_slam_tpu_torch.apps import offline
from disinfect_slam_tpu_torch.io import config_reader as t_yaml
from disinfect_slam_tpu_torch.io.png_io import read_image, read_png
from disinfect_slam_tpu_torch.ops.gather import load_spatial_tsdf
from disinfect_slam_tpu_torch.systems.tsdf_grid import TSDFGrid

from .scenes import checker_rgb, look_at, render_wall

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
ORBIT = os.path.join(ROOT, "datasets", "orbit_vga")


@pytest.mark.parametrize("name,unchanged", [
    ("0_rgb.png", False), ("0_depth.png", True), ("0_ht.png", True),
    ("0_no_ht.png", True),
])
def test_png_reader_matches_jax_reader_on_orbit_vga(name, unchanged):
    path = os.path.join(ORBIT, name)
    ours = read_image(path, unchanged=unchanged)
    ref = j_read_image(path, unchanged=unchanged)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _png_with_every_filter(img: np.ndarray) -> bytes:
    """Encode with row filters cycling None, Sub, Up, Average, Paeth."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    depth = img.dtype.itemsize * 8
    raw = img.astype(">u2" if depth == 16 else np.uint8).tobytes()
    rows = np.frombuffer(raw, np.uint8).reshape(h, -1).astype(np.int32)
    bpp = ch * depth // 8
    out = []
    for y in range(h):
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        f = y % 5
        pred = [0, left, up, (left + up) // 2, _paeth(left, up, ul)][f]
        out.append(bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes())

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, 0 if ch == 1 else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["rgb8", "gray8", "gray16"])
def test_png_reader_handles_all_five_filters(tmp_path, kind):
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[:37, :29]
    smooth = xx * 5 + yy * 3
    if kind == "rgb8":
        img = (np.stack([smooth, smooth * 2, rng.integers(0, 256, smooth.shape)],
                        -1) % 256).astype(np.uint8)
    elif kind == "gray8":
        img = (smooth % 256).astype(np.uint8)
    else:
        img = (smooth * 211 + rng.integers(0, 64, smooth.shape)).astype(np.uint16)
    # our encoder, forcing every filter; Pillow decodes it as the reference
    forced = tmp_path / "forced.png"
    forced.write_bytes(_png_with_every_filter(img))
    np.testing.assert_array_equal(read_png(str(forced)), np.asarray(Image.open(forced)))
    np.testing.assert_array_equal(read_png(str(forced)), img)
    # Pillow's own adaptive filtering
    written = tmp_path / "pillow.png"
    Image.fromarray(img).save(written)
    np.testing.assert_array_equal(read_png(str(written)), img)


def test_png_reader_rejects_interlaced(tmp_path):
    path = tmp_path / "i.png"
    data = bytearray(_png_with_every_filter(np.zeros((4, 4), np.uint8)))
    data[28] = 1  # IHDR interlace byte (CRC is not checked by the reader)
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="interlaced"):
        read_png(str(path))


@pytest.mark.parametrize("path", [
    os.path.join(ROOT, "configs", "l515_zed.yaml"), os.path.join(ORBIT, "cam.yaml"),
])
def test_yaml_reader_matches_pyyaml(path):
    ours, ref = t_yaml.load_yaml(path), j_yaml.load_yaml(path)
    assert t_yaml.get_intrinsics(ours) == j_yaml.get_intrinsics(ref)
    assert t_yaml.get_depth_factor(ours) == j_yaml.get_depth_factor(ref)
    np.testing.assert_array_equal(t_yaml.get_extrinsics(ours), j_yaml.get_extrinsics(ref))


# off-centre, non-round intrinsics keep voxel projections off exact
# half-pixel boundaries (as tests/test_integrate.py does), where an ulp
# of FMA contraction in the jitted JAX step would pick another pixel
K = (121.3, 119.7, 79.21, 59.63)
W, H = 160, 120


@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    """A 160x120 logged replay of a wall (FrameLogger) + its camera YAML."""
    d = tmp_path_factory.mktemp("tiny_log")
    logger = FrameLogger(str(d), depth_factor=5000.0)
    for i in range(4):
        pose = look_at((0.021 * i + 0.013, -0.011 * i - 0.027, 0.009),
                       (0.11, 0.07, 1.8131)).astype(np.float32)
        depth = render_wall(W, H, K, pose, wall_z=1.8131)
        logger.log_data((i, checker_rgb(W, H), depth, pose))
    logger.close()
    (d / "cam.yaml").write_text(
        "Camera.fx: 121.3\nCamera.fy: 119.7\nCamera.cx: 79.21\nCamera.cy: 59.63\n"
        "Camera.rows: 120\nCamera.cols: 160\ndepthmap_factor: 5000.0\n"
    )
    return str(d)


def test_offline_cli_writes_the_jax_data_bin(tiny_dataset, tmp_path):
    ours = str(tmp_path / "port.bin")
    res = offline.main([
        "--logdir", tiny_dataset, "--config", os.path.join(tiny_dataset, "cam.yaml"),
        "--preset", "small", "--voxel", "0.05", "--trunc", "0.15",
        "--max-depth", "4.0", "--device", "cpu", "--save", ours,
    ])
    assert res["frames"] == 4 and res["records"] > 1000

    # apps/offline.py's logic for the same flags, in process
    cfg = JConfig(num_blocks_log2=12, max_candidates=8192, max_visible=4096,
                  max_new_per_round=2048, grid_log2=7, sampler="gather")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        dataclasses.replace(res["grid"].cfg, voxel_size=0.01, truncation=0.06,
                            sampler="gather"))
    grid = JGrid(0.05, 0.15, cfg=cfg)
    for fr in JReplay(tiny_dataset, 5000.0):
        grid.integrate(fr.rgb, fr.depth, fr.ht, fr.lt, 4.0, K, fr.cam_T_world)
    ref = str(tmp_path / "jax.bin")
    j_dump(grid.gather_valid(), ref)

    a, b = load_spatial_tsdf(ours), load_spatial_tsdf(ref)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a[:, :3], b[:, :3])
    # tsdf within 1e-5: XLA:CPU contracts multiply-adds into FMAs inside
    # the jitted JAX step, the port does not
    np.testing.assert_allclose(a[:, 3], b[:, 3], rtol=0, atol=1e-5)


def test_port_runs_without_loading_jax():
    code = (
        "import sys\n"
        "from disinfect_slam_tpu_torch.config import TINY_DENSE\n"
        "from disinfect_slam_tpu_torch.systems.tsdf_grid import TSDFGrid\n"
        "from tests.scenes import checker_rgb, look_at, render_wall\n"
        "K = (52.7, 53.3, 31.71, 23.43)\n"
        "pose = look_at((0.03, -0.04, 0.02), (0.11, 0.07, 2.0131))\n"
        "g = TSDFGrid(0.05, 0.15, cfg=TINY_DENSE, device='cpu')\n"
        "g.integrate(checker_rgb(64, 48), render_wall(64, 48, K, pose, 2.0131),\n"
        "            None, None, 4.0, K, pose)\n"
        "assert g.num_active_blocks() > 0\n"
        "import disinfect_slam_tpu_torch.ops.render_fast\n"
        "import disinfect_slam_tpu_torch.ops.raycast\n"
        "import disinfect_slam_tpu_torch.ops.cuda.splat_kernel\n"
        "import disinfect_slam_tpu_torch.viz.headless\n"
        "for r in ('raycast', 'splat'):\n"
        "    assert g.ray_cast(4.0, (K, 48, 64), pose, renderer=r).hit.any()\n"
        "bad = [m for m in sys.modules if m in ('jax', 'disinfect_slam_tpu')\n"
        "       or m.startswith(('jax.', 'disinfect_slam_tpu.'))]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_grid_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TSDFGrid(0.05, 0.15, device="cuda")
