"""PyTorch port, stereo block matching (ops/stereo.py) against the JAX
package's on tests/test_stereo.py's seven cases (make_pair: textured
fronto-parallel planes at 96x160, 40 disparities), and the seven
accuracy assertions of tests/test_stereo.py restated on the port.

Tolerance: none.  Disparity, depth and the valid mask equal the jitted
JAX functions' bit for bit, for gray and for 3-channel inputs: the port
restates XLA:CPU's sum orders (the box's window left to right, the 2x2
mean) and its rewrites (the float32 reciprocal of the patch area, the
fused multiply-adds of the gray conversion and of the zero-mean
subtraction; ops/image_ops.fma32)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disinfect_slam_tpu.ops import stereo as J
from disinfect_slam_tpu_torch.ops import stereo as T

from .test_stereo import BASELINE, FX, interior_mask, make_pair

torch.set_num_threads(1)

MAX_DISP = 40


def _pair(rgb=False):
    left, right, true_disp = make_pair()
    if rgb:  # three channels that differ, in [0, 255]
        left, right = (np.stack([x, np.roll(x, 3, 0), x * x], -1) * 255 for x in (left, right))
    return left.astype(np.float32), right.astype(np.float32), true_disp


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_same(ours, ref):
    for a, b in zip(ours, ref):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_cost_volume_matches_jitted_jax():
    left, right, _ = _pair()
    ref = jax.jit(partial(J.cost_volume, max_disp=MAX_DISP))(left, right)
    _assert_same([T.cost_volume(_t(left), _t(right), MAX_DISP)], [ref])


@pytest.mark.parametrize("rgb", [False, True])
def test_block_match_matches_jax(rgb):
    left, right, _ = _pair(rgb)
    disp, valid = T.block_match(_t(left), _t(right), max_disp=MAX_DISP)
    assert valid.float().mean() > 0.5
    _assert_same([disp, valid], J.block_match(left, right, max_disp=MAX_DISP))


@pytest.mark.parametrize("levels", [1, 2])
def test_block_match_pyramid_matches_jax(levels):
    left, right, _ = _pair()
    ours = T.block_match_pyramid(_t(left), _t(right), max_disp=MAX_DISP, levels=levels, band=2)
    ref = J.block_match_pyramid(left, right, max_disp=MAX_DISP, levels=levels, band=2)
    assert ours[1].float().mean() > 0.5
    _assert_same(ours, ref)


@pytest.mark.parametrize("method", ["flat", "pyramid"])
def test_stereo_depth_matches_jax(method):
    left, right, _ = _pair()
    kw = dict(fx=FX, baseline_m=BASELINE, max_disp=MAX_DISP, method=method)
    ours = T.stereo_depth(_t(left), _t(right), **kw)
    ref = J.stereo_depth(left, right, **kw)
    _assert_same(ours, ref)


def test_odd_sizes_and_pyramid_edge_padding_match_jax():
    """A 95x157 crop: the pyramid's edge padding to even sizes and the
    crop of the nearest upsample."""
    left, right, _ = _pair()
    left, right = left[:95, :157], right[:95, :157]
    ours = T.block_match_pyramid(_t(left), _t(right), max_disp=MAX_DISP, levels=2)
    _assert_same(ours, J.block_match_pyramid(left, right, max_disp=MAX_DISP, levels=2))


def test_estimator_uint8_matches_jax():
    left, right, _ = _pair()
    l8, r8 = ((x * 255).astype(np.uint8) for x in (left, right))
    ours = T.StereoDepthEstimator(FX, BASELINE, max_disp=MAX_DISP, device="cpu")
    ref = J.StereoDepthEstimator(FX, BASELINE, max_disp=MAX_DISP)
    depth = ours(l8, r8)
    assert depth.dtype == np.float32 and (depth > 0).mean() > 0.3
    np.testing.assert_array_equal(depth, ref(l8, r8))
    dev = ours.depth_device(l8, r8)
    assert isinstance(dev, torch.Tensor) and dev.device.type == "cpu"
    np.testing.assert_array_equal(dev.numpy(), depth)


def test_bad_method_raises():
    with pytest.raises(ValueError, match="flat"):
        T.StereoDepthEstimator(FX, BASELINE, method="sgm", device="cpu")
    left, right, _ = _pair()
    with pytest.raises(ValueError, match="pyramid"):
        T.stereo_depth(_t(left), _t(right), FX, BASELINE, method="sgm")


# ----------------------------------------------------------------------
# tests/test_stereo.py's accuracy assertions, on the port
# ----------------------------------------------------------------------
def _np(*ts):
    return [t.numpy() for t in ts]


def test_block_match_recovers_disparity_within_one():
    left, right, true_disp = make_pair()
    disp, valid = _np(*T.block_match(_t(left), _t(right), max_disp=MAX_DISP))
    m = interior_mask(true_disp) & valid
    assert m.mean() > 0.4, f"too few valid interior pixels ({m.mean():.2f})"
    err = np.abs(disp[m] - true_disp[m])
    assert np.quantile(err, 0.95) <= 1.0
    assert err.mean() < 0.5


@pytest.mark.parametrize("method", ["flat", "pyramid"])
def test_stereo_depth_metric_conversion(method):
    left, right, true_disp = make_pair()
    res = T.stereo_depth(_t(left), _t(right), fx=FX, baseline_m=BASELINE,
                         max_disp=MAX_DISP, method=method)
    depth, valid = _np(res.depth, res.valid)
    m = interior_mask(true_disp) & valid
    true_depth = FX * BASELINE / true_disp
    rel = np.abs(depth[m] - true_depth[m]) / true_depth[m]
    assert np.quantile(rel, 0.95) < 0.2
    assert (depth[~valid] == 0).all()


def test_lr_check_kills_occluded_and_textureless():
    """A textureless band is marked invalid, not hallucinated."""
    left, right, _ = make_pair()
    left[:, 40:70] = 0.5
    right[:, 40 - 16:70] = 0.5
    _, valid = _np(*T.block_match(_t(left), _t(right), max_disp=MAX_DISP))
    assert valid[:, 48:62].mean() < 0.5


def test_estimator_wrapper_uint8():
    left, right, true_disp = make_pair()
    est = T.StereoDepthEstimator(fx=FX, baseline_m=BASELINE, max_disp=MAX_DISP, device="cpu")
    depth = est((left * 255).astype(np.uint8), (right * 255).astype(np.uint8))
    m = interior_mask(true_disp) & (depth > 0)
    assert m.mean() > 0.3
    true_depth = FX * BASELINE / true_disp
    rel = np.abs(depth[m] - true_depth[m]) / true_depth[m]
    assert np.quantile(rel, 0.9) < 0.25


def test_pyramid_recovers_disparity_in_smooth_regions():
    left, right, true_disp = make_pair()
    disp, valid = _np(*T.block_match_pyramid(_t(left), _t(right), max_disp=MAX_DISP,
                                             levels=2, band=2))
    m = interior_mask(true_disp) & valid
    assert m.mean() > 0.3
    err = np.abs(disp[m] - true_disp[m])
    assert np.quantile(err, 0.95) <= 0.5
    assert err.mean() < 0.3
    m12 = interior_mask(true_disp, margin=12) & valid
    assert np.quantile(np.abs(disp[m12] - true_disp[m12]), 0.95) <= 0.15


def test_pyramid_single_level_matches_flat_closely():
    left, right, true_disp = make_pair()
    d_flat, v_flat = _np(*T.block_match(_t(left), _t(right), max_disp=MAX_DISP))
    d_pyr, v_pyr = _np(*T.block_match_pyramid(_t(left), _t(right), max_disp=MAX_DISP,
                                              levels=1, band=2))
    m = interior_mask(true_disp) & v_flat & v_pyr
    assert np.quantile(np.abs(d_flat[m] - d_pyr[m]), 0.95) <= 1.0


def test_jnp_round_and_torch_round_agree_on_halves():
    """The pyramid rounds the upsampled seed half to even in both."""
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5], np.float32)
    np.testing.assert_array_equal(torch.round(_t(x)).numpy(), np.asarray(jnp.round(x)))
