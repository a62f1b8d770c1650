"""PyTorch port, image ops (ops/image_ops.py): the remap against the
jitted JAX one, the rectification maps against OpenCV's and the JAX
package's, the rectifier, half_scale and scale_depth.

Tolerances: the remap equals the jitted JAX remap bit for bit (XLA:CPU's
fused multiply-adds restated, image_ops.fma32).  The rectification is
OpenCV's stereoRectify(CALIB_ZERO_DISPARITY, alpha=0) restated in numpy:
its rectified intrinsics are held within 1e-6 relative of cv2's and its
maps within 1e-2 px of cv2's initUndistortRectifyMap (tests/test_io.py's
bound; on these cases they agree to 0 px), for baselines of either sign
and a vertical pair.  The JAX package's numpy fallback, the branch it
takes without cv2, rotates the rectified image by 180 degrees for a
negative t_x; a test pins that difference."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from disinfect_slam_tpu.io.config_reader import load_yaml as j_load_yaml
from disinfect_slam_tpu.ops import image_ops as J
from disinfect_slam_tpu_torch.io.config_reader import load_yaml
from disinfect_slam_tpu_torch.ops import image_ops as T

torch.set_num_threads(1)

# tests/test_io.py:95-101's calibration, at the 640x480 its K is made for
K_L = np.array([[458.0, 0, 320.0], [0, 457.0, 240.0], [0, 0, 1]])
K_R = np.array([[459.0, 0, 321.0], [0, 458.0, 241.0], [0, 0, 1]])
D = np.array([-0.28, 0.07, 0.0002, 0.00002, 0.0])
R_RL = Rotation.from_rotvec([0.002, -0.001, 0.0015]).as_matrix()
SIZE = (640, 480)
TRANSLATIONS = {"tx<0": [-0.11, 0.0002, 0.0003], "tx>0": [0.11, 0.0002, 0.0003],
                "vertical": [0.001, -0.12, 0.002]}


def _cv2_maps(cv2, t_rl, size=SIZE):
    R1, R2, P1, P2, *_ = cv2.stereoRectify(K_L, D, K_R, D, size, R_RL,
                                           np.asarray(t_rl).reshape(3, 1),
                                           flags=cv2.CALIB_ZERO_DISPARITY, alpha=0)
    lx, ly = cv2.initUndistortRectifyMap(K_L, D, R1, P1, size, cv2.CV_32FC1)
    rx, ry = cv2.initUndistortRectifyMap(K_R, D, R2, P2, size, cv2.CV_32FC1)
    return (lx, ly, rx, ry), (P2[0, 0], P2[1, 1], P2[0, 2], P2[1, 2])


@pytest.mark.parametrize("channels", [1, 3])
def test_bilinear_remap_matches_jitted_jax(channels):
    rng = np.random.default_rng(channels)
    shape = (96, 128) if channels == 1 else (96, 128, 3)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    # sources inside and up to 3 px outside the image (border clamp)
    mx = rng.uniform(-3, 131, (80, 100)).astype(np.float32)
    my = rng.uniform(-3, 99, (80, 100)).astype(np.float32)
    ref = np.asarray(jax.jit(J.bilinear_remap)(jnp.asarray(img), mx, my))
    ours = T.bilinear_remap(torch.from_numpy(img), torch.from_numpy(mx), torch.from_numpy(my))
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_bilinear_remap_half_pixel_shift():
    img = np.arange(16, dtype=np.float32).reshape(4, 4)
    yy, xx = np.mgrid[0:4, 0:4].astype(np.float32)
    out = T.bilinear_remap(torch.from_numpy(img), torch.from_numpy(xx + 0.5),
                           torch.from_numpy(yy)).numpy()
    np.testing.assert_allclose(out[:, :3], (img[:, :3] + img[:, 1:]) / 2, atol=1e-4)


@pytest.mark.parametrize("case", sorted(TRANSLATIONS))
def test_rectify_maps_match_opencv(case):
    cv2 = pytest.importorskip("cv2")
    t_rl = np.array(TRANSLATIONS[case])
    maps = T.build_rectify_maps(K_L, D, K_R, D, R_RL, t_rl, SIZE)
    ref_maps, ref_intr = _cv2_maps(cv2, t_rl)
    for ours, ref in zip(maps[:4], ref_maps):
        assert ours.dtype == np.float32 and ours.shape == (480, 640)
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-2)
    np.testing.assert_allclose(maps.rectified_intrinsics, ref_intr, rtol=1e-6)


@pytest.mark.parametrize("case", ["tx<0", "tx>0"])
def test_rectify_maps_match_jax_with_cv2(case):
    """The JAX package takes its cv2 branch here: the same maps."""
    pytest.importorskip("cv2")
    t_rl = np.array(TRANSLATIONS[case])
    ours = T.build_rectify_maps(K_L, D, K_R, D, R_RL, t_rl, SIZE)
    ref = J.build_rectify_maps(K_L, D, K_R, D, R_RL, t_rl, SIZE)
    for a, b in zip(ours[:4], ref[:4]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-2)
    np.testing.assert_allclose(ours.rectified_intrinsics, ref.rectified_intrinsics, rtol=1e-6)


def test_jax_fallback_rotates_a_negative_baseline(monkeypatch):
    """Pixel (0, 0) of the left map: the port's lies within 1e-2 px of
    cv2's; the JAX fallback's (cv2 hidden) lands on the far corner."""
    cv2 = pytest.importorskip("cv2")
    t_rl = np.array(TRANSLATIONS["tx<0"])
    (lx, ly, _, _), _ = _cv2_maps(cv2, t_rl)
    ours = T.build_rectify_maps(K_L, D, K_R, D, R_RL, t_rl, SIZE)
    monkeypatch.setitem(sys.modules, "cv2", None)
    fallback = J.build_rectify_maps(K_L, D, K_R, D, R_RL, t_rl, SIZE)
    ref = np.array([lx[0, 0], ly[0, 0]])
    assert np.abs(np.array([ours.left_x[0, 0], ours.left_y[0, 0]]) - ref).max() < 1e-2
    gap = np.abs(np.array([fallback.left_x[0, 0], fallback.left_y[0, 0]]) - ref)
    assert gap.min() > 100, gap  # (38, 31) under cv2, near (586, 437) in the fallback


def test_rectifier_from_yaml_and_rectify():
    """configs/zed_native_stereo.yaml (t_x = -0.12, no rotation) through
    both packages' from_yaml: the same maps (cv2 here) and the same
    rectified pair; the maps live on the rectifier's device."""
    pytest.importorskip("cv2")
    path = "configs/zed_native_stereo.yaml"
    ours = T.StereoRectifier.from_yaml(load_yaml(path), device="cpu")
    ref = J.StereoRectifier.from_yaml(j_load_yaml(path))
    for a, b in zip(ours.maps[:4], ref.maps[:4]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-2)
    np.testing.assert_allclose(ours.rectified_intrinsics(), ref.rectified_intrinsics(),
                               rtol=1e-6)
    assert all(m.device.type == "cpu" for m in ours.maps_device)
    rng = np.random.default_rng(3)
    left = rng.uniform(0, 255, (376, 672, 3)).astype(np.float32)
    right = rng.uniform(0, 255, (376, 672)).astype(np.float32)
    l, r = ours.rectify(left, right)
    assert l.shape == left.shape and r.shape == right.shape and l.dtype == np.float32
    # with the port's own maps in the JAX remap: the same bits
    lx, ly, rx, ry = (jnp.asarray(m) for m in ours.maps[:4])
    remap = jax.jit(J.bilinear_remap)
    np.testing.assert_array_equal(l, np.asarray(remap(jnp.asarray(left), lx, ly)))
    np.testing.assert_array_equal(r, np.asarray(remap(jnp.asarray(right), rx, ry)))


def test_half_scale_and_scale_depth_match_jax():
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 65535, (31, 47)).astype(np.uint16)
    rgb = rng.integers(0, 255, (31, 47, 3)).astype(np.uint8)
    for img in (raw, rgb):
        np.testing.assert_array_equal(T.half_scale(torch.from_numpy(img.astype(np.int32))).numpy(),
                                      np.asarray(J.half_scale(jnp.asarray(img))))
        np.testing.assert_array_equal(T.half_scale(img), np.asarray(J.half_scale(img)))
    for factor in (5000.0, 1000.0, 3.7):
        ours = T.scale_depth(torch.from_numpy(raw.astype(np.int32)), factor)
        assert ours.dtype == torch.float32
        np.testing.assert_array_equal(ours.numpy(),
                                      np.asarray(J.scale_depth(jnp.asarray(raw), factor)))
        # a numpy depth (DISINFSystem's host frames) stays on the host, same
        # bits, as the host division DISINFSystem made before
        host = T.scale_depth(raw, factor)
        assert isinstance(host, np.ndarray) and host.dtype == np.float32
        np.testing.assert_array_equal(host, ours.numpy())
        np.testing.assert_array_equal(host, raw.astype(np.float32) / factor)
