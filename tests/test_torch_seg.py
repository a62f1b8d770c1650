"""PyTorch port, segmentation: the linear resize, UNetSeg and FastSeg
carried over from the JAX package's flax modules (random narrow nets in
float32 and bfloat16, the shipped weights at full width), flax's SAME
padding, InferenceEngine, the shipped UNet's held-out IoU, and the npz
loader's errors.

Inputs come from numpy seeds; both packages run on the CPU (JAX in
float32 through XLA:CPU, the port through torch's CPU ops)."""

import os

import cv2
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from disinfect_slam_tpu.io.png_io import read_image as j_read_image
from disinfect_slam_tpu.models import segmentation as js
from disinfect_slam_tpu.models.synth_data import make_batch
from disinfect_slam_tpu_torch.models import segmentation as ts

torch.set_num_threads(1)

ORBIT_RGB = os.path.join(os.path.dirname(__file__), "..", "datasets", "orbit_vga",
                         "0_rgb.png")


def _flat(params) -> dict:
    return {k: np.asarray(v, np.float32)
            for k, v in traverse_util.flatten_dict(params, sep="/").items()}


@pytest.mark.parametrize("n_in,n_out", [(480, 352), (352, 480), (360, 480), (640, 640)])
def test_resize_linear_matches_jax(n_in, n_out):
    """The resize matrices equal the JAX package's; the resize of a
    [0, 1] image agrees within 1e-6 (float32 matmuls, summed in another
    order than XLA's dot)."""
    np.testing.assert_allclose(ts._linear_resize_matrix_np(n_in, n_out),
                               np.asarray(js._linear_resize_matrix(n_in, n_out)),
                               rtol=0, atol=1e-7)
    img = np.random.default_rng(n_in + n_out).uniform(0, 1, (n_in, 96, 3)).astype(np.float32)
    ours = ts.resize_linear(torch.from_numpy(img), n_out, 80).numpy()
    ref = np.asarray(js.resize_linear(jnp.asarray(img), n_out, 80))
    assert ours.shape == (n_out, 80, 3)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def test_resize_linear_upsampling_matches_cv2():
    """Upsampling with half-pixel centres and edge clamping is what
    cv2.resize(INTER_LINEAR) does, the JAX online app's resize of the
    640x360 maps to the frame: within 1e-5 on [0, 1] maps (cv2 keeps its
    own float32 coefficients)."""
    maps = np.random.default_rng(1).uniform(0, 1, (360, 640, 2)).astype(np.float32)
    ours = ts.resize_linear(torch.from_numpy(maps), 480, 640).numpy()
    ref = cv2.resize(maps, (640, 480), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def _narrow(arch, jdtype, tdtype):
    if arch == "unet":
        return js.UNetSeg(widths=(8, 16, 32, 32), dtype=jdtype), ts.UNetSeg(
            widths=(8, 16, 32, 32), dtype=tdtype)
    return js.FastSeg(width=64, depth=3, dtype=jdtype), ts.FastSeg(
        width=64, depth=3, dtype=tdtype)


def carried_pair(arch, jdtype, tdtype, h, w, seed=1):
    """A random JAX net (GroupNorm scales and biases perturbed too) and
    the port's net carrying its parameters."""
    jm, tm = _narrow(arch, jdtype, tdtype)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.zeros((1, h, w, 3), jnp.float32))
    rng = np.random.default_rng(seed)
    flat = {k: v + rng.normal(0, 0.2, v.shape).astype(np.float32)
            if k.endswith(("scale", "bias")) else v for k, v in _flat(params).items()}
    tm.load_state_dict(ts.state_dict_from_flax(flat, tm))
    return jm, traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()},
                                            sep="/"), tm


# bfloat16: both sides round every conv output and activation to bf16,
# but XLA:CPU and oneDNN accumulate each conv in another order, so single
# bf16 ulps (0.4%) differ and propagate; measured on these nets: max
# |dlogit| 0.218 (UNet) / 0.028 (FastSeg) at logit scales 6.0 / 1.6, mean
# 0.012 / 0.004.  Limits (max, mean):
BF16_TOL = {"unet": (0.4, 0.03), "fast": (0.08, 0.01)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["unet", "fast"])
def test_random_narrow_net_matches_jax(arch, dtype):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (
        jnp.bfloat16, torch.bfloat16)
    jm, params, tm = carried_pair(arch, jdt, tdt, 64, 128)
    x = np.random.default_rng(2).uniform(0, 1, (1, 64, 128, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)), np.float32)
    with torch.no_grad():
        ours = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert ours.shape == ref.shape == (1, 64, 128, 2) and ours.dtype == np.float32
    err = np.abs(ours - ref)
    if dtype == "float32":
        # measured max 1.0e-5 (UNet) / 4.8e-6 (FastSeg)
        assert err.max() <= 1e-4, err.max()
    else:
        max_tol, mean_tol = BF16_TOL[arch]
        assert err.max() <= max_tol and err.mean() <= mean_tol, (err.max(), err.mean())


def test_stride2_same_padding_is_high_side_only():
    """flax's SAME on a stride-2 3x3 conv over an even side pads (0, 1);
    torch's padding=1 pads (1, 1) and shifts every tap by one pixel."""
    x = np.random.default_rng(3).normal(size=(1, 10, 12, 4)).astype(np.float32)
    conv = fnn.Conv(5, (3, 3), strides=(2, 2), padding="SAME", use_bias=False)
    params = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(conv.apply(params, jnp.asarray(x)))
    port = ts.Conv(4, 5, 3, stride=2, dtype=torch.float32)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.array(params["params"]["kernel"]))
                          .permute(3, 2, 0, 1))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        ours = port(xt).permute(0, 2, 3, 1).numpy()
        sym = torch.nn.functional.conv2d(xt, port.weight, stride=2, padding=1)
    assert ours.shape == ref.shape == (1, 5, 6, 5)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    assert np.abs(sym.permute(0, 2, 3, 1).numpy() - ref).max() > 0.1


def test_shipped_weights_load_every_array():
    for arch, n in (("unet", 56), ("fast", 29)):
        flat = ts.load_default_params(arch)
        assert len(flat) == n and all(v.dtype == np.float32 for v in flat.values())
        model = ts.create_model(arch=arch)
        sd = ts.state_dict_from_flax(flat, model)
        assert set(sd) == set(model.state_dict()) and len(sd) == n


def test_loader_names_missing_extra_and_misshapen_keys():
    model = ts.create_model(arch="fast")
    flat = ts.load_default_params("fast")
    missing = dict(flat)
    del missing["params/GroupNorm_3/scale"]
    with pytest.raises(KeyError, match="norms.3.weight"):
        ts.state_dict_from_flax(missing, model)
    with pytest.raises(KeyError, match="params/Conv_9/kernel"):
        ts.state_dict_from_flax({**flat, "params/Conv_9/kernel": flat["params/Conv_0/kernel"]},
                                model)
    with pytest.raises(KeyError, match="params/Dense_0/kernel"):
        ts.state_dict_from_flax({**flat, "params/Dense_0/kernel": np.zeros(3)}, model)
    bad = {**flat, "params/ConvBlock_1/Conv_0/kernel": np.zeros((3, 3, 64, 256), np.float32)}
    with pytest.raises(ValueError, match="params/ConvBlock_1/Conv_0/kernel"):
        ts.state_dict_from_flax(bad, model)


# The shipped nets at full width, JAX's InferenceEngine against the
# port's on frame 0 of datasets/orbit_vga (480x640 u8), both in bfloat16 on
# the CPU.  Measured: UNet max |dp| 0.027 (ht) / 0.057 (lt), mean 6.3e-4 /
# 1.9e-3, labels differing on 0.007% / 0.19% of pixels; FastSeg max
# 0.003 / 0.012, mean 8.3e-5 / 4.1e-4, labels 0% / 0.008%.
SHIPPED_TOL = {"unet": (0.1, 5e-3), "fast": (0.05, 2e-3)}


@pytest.mark.parametrize("arch", ["unet", "fast"])
def test_shipped_inference_engine_matches_jax(arch):
    rgb = j_read_image(ORBIT_RGB)
    assert rgb.shape == (480, 640, 3) and rgb.dtype == np.uint8
    ref = js.InferenceEngine(js.create_model(arch=arch), js.load_default_params(arch))
    ours = ts.InferenceEngine(ts.load_model(arch))
    for a, b in zip(ref.infer_one(rgb), ours.infer_one(rgb)):
        assert b.shape == (360, 640) and b.dtype == np.float32
        err = np.abs(a - b)
        max_tol, mean_tol = SHIPPED_TOL[arch]
        assert err.max() <= max_tol and err.mean() <= mean_tol, (err.max(), err.mean())
        assert ((a > 0.5) != (b > 0.5)).mean() <= 0.005
    ht8, lt8 = ours.infer_one(rgb, ret_uint8=True)
    assert ht8.dtype == np.uint8 and ht8.shape == (360, 640)
    ht, _ = ours.infer_one(rgb.astype(np.float32))  # f32 input: same maps
    np.testing.assert_array_equal(ht, ours.infer_one(rgb)[0])


def test_shipped_unet_holdout_iou():
    """The port's UNet with the shipped weights on held-out synthetic
    scenes (the seed tests/test_seg_weights.py holds out): IoU > 0.7 on
    both channels."""
    imgs, labels = make_batch(np.random.default_rng(987654), 2, 352, 640)
    model = ts.load_model("unet")
    with torch.no_grad():
        logits = model(torch.from_numpy(np.asarray(imgs, np.float32)).permute(0, 3, 1, 2))
    pred = (torch.sigmoid(logits).permute(0, 2, 3, 1).numpy() > 0.5)
    lab = np.asarray(labels) > 0.5
    iou = (pred & lab).sum((0, 1, 2)) / (pred | lab).sum((0, 1, 2))
    assert iou[0] > 0.7 and iou[1] > 0.7, iou
